"""The port's training step, loop and CLI against the JAX package on the
CPU, at a small size: 32^2 slices, 2 residual blocks, base 8 (a 32-channel
trunk, R = 2), SOFT_TISSUE (3 input channels: image + 2 masks), fp32.

One JAX step (``make_train_step(..., gen_forward="module", remat=False)``)
and the port's step with ``trunk="tail"`` start from the same JAX
``create_state`` init (converted) and take the same batch of 2. Held:
every metric at rtol 1e-4; every gradient tensor at relative L2 error
<= 1e-3, except the biases of convs that feed an InstanceNorm, whose exact
gradient is 0 (the norm cancels them) and which both sides return as
rounding noise, held to an absolute bound; every updated parameter within
1e-6 wherever |JAX gradient| > 1e-6 (Adam's first step is ~lr * sign(g),
so a gradient at the noise floor may flip its update by 2 lr).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig, SOFT_TISSUE, TrainConfig, replace
from ducosy_tpu.data.dataset import SlicePairDataset as JaxSlicePairDataset
from ducosy_tpu.losses.suite import discriminator_loss as jax_d_loss
from ducosy_tpu.losses.suite import generator_loss as jax_g_loss
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu.train import make_val_step as jax_make_val_step
from ducosy_tpu.train.schedule import lr_for_epoch as jax_lr_for_epoch
from ducosy_tpu.train.step import _forward_all as jax_forward_all
from ducosy_tpu_torch.cli import train as tcli
from ducosy_tpu_torch.data.dataset import SlicePairDataset
from ducosy_tpu_torch.models.convert import (
    cyclegan_state_dicts_from_jax,
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from ducosy_tpu_torch.models.generator import Generator
from ducosy_tpu_torch.train import checkpoint as ckpt
from ducosy_tpu_torch.train import loop as tloop
from ducosy_tpu_torch.train.schedule import lr_for_epoch
from ducosy_tpu_torch.train.state import NETS, create_state
from ducosy_tpu_torch.train.step import make_train_step, val_step

sys.path.insert(0, os.path.dirname(__file__))
from synth import write_dataset, write_patient  # noqa: E402

IMG, BATCH = 32, 2
CFG = replace(TrainConfig(), img_size=IMG, batch_size=BATCH,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8)
NOISE_BOUND = 1e-5   # |grad| of a bias that feeds an InstanceNorm


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"a": rng.uniform(-1, 1, (n, IMG, IMG, 1)).astype(np.float32),
            "b": rng.uniform(-1, 1, (n, IMG, IMG, 1)).astype(np.float32),
            "masks": rng.integers(0, 2, (n, IMG, IMG, 2)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _feeds_instance_norm(net, name):
    """Biases of convs followed by an InstanceNorm: every generator conv
    but the head, every discriminator conv but the first and the head."""
    if not name.endswith(".bias"):
        return False
    idx = int(name.split(".")[1])
    if net.startswith("g"):
        return idx != 19 + MODEL.num_residual_blocks
    return idx not in (0, 12)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX train step, its gradients, and the port's state dicts of the
    same init."""
    state, gen, disc = jax_create_state(jax.random.PRNGKey(0), CFG,
                                        SOFT_TISSUE, MODEL, img_size=IMG)
    batch = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_make_train_step(gen, disc, CFG, donate=False, remat=False,
                               gen_forward="module")
    new_state, metrics = step(state, jb)

    def g_loss(g_params):
        fwd = jax_forward_all(lambda p, x: gen.apply({"params": p}, x),
                              g_params["a2b"], g_params["b2a"], jb)
        fake_a, fake_b, id_a, id_b, rec_a, rec_b = fwd
        terms = jax_g_loss(
            real_a=jb["a"], real_b=jb["b"], fake_a=fake_a, fake_b=fake_b,
            rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
            d_a_fake_logits=disc.apply({"params": state.params_d_a}, fake_a),
            d_b_fake_logits=disc.apply({"params": state.params_d_b}, fake_b),
            cfg=CFG)
        return terms.total, (fake_a, fake_b)

    (_, (fake_a, fake_b)), g_grads = jax.jit(jax.value_and_grad(
        g_loss, has_aux=True))({"a2b": state.params_g_a2b,
                                "b2a": state.params_g_b2a})
    d_grad = jax.jit(jax.grad(lambda p, real, fake: jax_d_loss(
        disc.apply({"params": p}, real), disc.apply({"params": p}, fake))))
    grads = {"g_a2b": generator_state_dict_from_jax(_np_tree(g_grads["a2b"])),
             "g_b2a": generator_state_dict_from_jax(_np_tree(g_grads["b2a"])),
             "d_a": discriminator_state_dict_from_jax(_np_tree(
                 d_grad(state.params_d_a, jb["a"], fake_a))),
             "d_b": discriminator_state_dict_from_jax(_np_tree(
                 d_grad(state.params_d_b, jb["b"], fake_b)))}
    return dict(init=cyclegan_state_dicts_from_jax(_np_tree(state)),
                new=cyclegan_state_dicts_from_jax(_np_tree(new_state)),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, batch=batch, jax_state=state, gen=gen, disc=disc)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's step (trunk="tail", no remat) on the same init and batch."""
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu", trunk="tail",
                         state_dicts=jax_run["init"])
    metrics = make_train_step(CFG, remat=False)(
        state, _torch_batch(jax_run["batch"]))
    return state, {k: float(v) for k, v in metrics.items()}


METRICS = ["loss_G", "loss_D", "loss_GAN", "loss_cycle", "loss_id",
           "loss_ssim", "contrast"]


@pytest.mark.parametrize("name", METRICS)
def test_step_metric_matches_jax(jax_run, port_run, name):
    np.testing.assert_allclose(port_run[1][name], jax_run["metrics"][name],
                               rtol=1e-4)


@pytest.mark.parametrize("net", NETS)
def test_step_gradients_match_jax(jax_run, port_run, net):
    for name, p in getattr(port_run[0], net).named_parameters():
        ref, got = jax_run["grads"][net][name], p.grad.numpy()
        if _feeds_instance_norm(net, name):
            assert np.abs(ref).max() < NOISE_BOUND, name
            assert np.abs(got).max() < NOISE_BOUND, name
            continue
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 1e-3, f"{net} {name}: relative L2 {rel:.2e}"


@pytest.mark.parametrize("net", NETS)
def test_step_updated_params_match_jax(jax_run, port_run, net):
    for name, p in getattr(port_run[0], net).named_parameters():
        keep = np.abs(jax_run["grads"][net][name]) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[keep],
                                   jax_run["new"][net][name][keep],
                                   rtol=0, atol=1e-6, err_msg=f"{net} {name}")


def test_tail_and_plain_trunks_agree(jax_run, port_run):
    """The kernel trunk's plain path and the plain trunk take the same step
    (metrics rtol 1e-5, parameters atol 1e-6 where the gradient is above
    the noise floor, which the biases that feed a norm never are)."""
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu", trunk="plain",
                         state_dicts=jax_run["init"])
    metrics = make_train_step(CFG, remat=False)(
        state, _torch_batch(jax_run["batch"]))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), port_run[1][k], rtol=1e-5)
    for net in NETS:
        tail = dict(getattr(port_run[0], net).named_parameters())
        for name, p in getattr(state, net).named_parameters():
            if _feeds_instance_norm(net, name):
                continue
            keep = p.grad.abs() > 1e-6
            torch.testing.assert_close(p.detach()[keep],
                                       tail[name].detach()[keep], rtol=0,
                                       atol=1e-6)


def test_remat_step_matches_plain_step(jax_run):
    """torch.utils.checkpoint around the generator forwards and the loss
    terms recomputes the same step."""
    runs = []
    for remat in (False, True):
        state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                             state_dicts=jax_run["init"])
        m = make_train_step(CFG, remat=remat)(state,
                                              _torch_batch(jax_run["batch"]))
        runs.append((state, m))
    for k in METRICS:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=1e-6,
                                   atol=0)
    for a, b in zip(runs[0][0].g_a2b.parameters(),
                    runs[1][0].g_a2b.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-8)


def test_weighted_step_equals_ragged_batch(jax_run):
    """A batch wrap-padded with a duplicate and weighted [1, 1, 0], built
    with n_real = 2, takes exactly the step of the ragged 2-sample batch."""
    ragged = jax_run["batch"]
    padded = {k: np.concatenate([v, v[:1]]) for k, v in ragged.items()}
    padded["weight"] = np.array([1, 1, 0], np.float32)
    runs = []
    for batch, n_real in ((ragged, None), (padded, 2)):
        state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                             state_dicts=jax_run["init"])
        m = make_train_step(CFG, remat=False, n_real=n_real)(
            state, _torch_batch(batch))
        runs.append((state, m))
    for k in METRICS:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=1e-5,
                                   atol=0)
    for a, b in zip(runs[0][0].d_a.parameters(), runs[1][0].d_a.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-7)


def test_batched_forwards_take_the_same_step(jax_run):
    """batched_forwards folds the fake and identity forwards of each
    direction into one 2N-batch call: the same step, since the norms and
    gates are per sample."""
    runs = []
    for batched in (False, True):
        state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                             state_dicts=jax_run["init"])
        m = make_train_step(CFG, remat=False, batched_forwards=batched)(
            state, _torch_batch(jax_run["batch"]))
        runs.append((state, m))
    for k in METRICS:
        torch.testing.assert_close(runs[0][1][k], runs[1][1][k], rtol=1e-5,
                                   atol=0)
    for net in NETS:
        for a, b in zip(getattr(runs[0][0], net).parameters(),
                        getattr(runs[1][0], net).parameters()):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-7)


def test_val_step_matches_jax(jax_run):
    """GAN + cycle + identity on the init, and fake_b, against
    make_val_step."""
    jb = {k: jnp.asarray(v) for k, v in jax_run["batch"].items()}
    ref_loss, ref_fake = jax_make_val_step(jax_run["gen"], jax_run["disc"],
                                           CFG)(jax_run["jax_state"], jb)
    state = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                         state_dicts=jax_run["init"])
    loss, fake_b = val_step(state, _torch_batch(jax_run["batch"]), CFG)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(fake_b.numpy(), np.asarray(ref_fake),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("trunk", ["tail", "plain"])
def test_generator_training_trunks_match_jax(trunk):
    """The 3-channel generator forward in fp32, trunks "tail" and "plain",
    against Generator.apply, with non-zero biases: rtol 1e-4."""
    gen = JaxGenerator(3, 2, 8)
    params = _np_tree(jax.jit(gen.init)(jax.random.PRNGKey(1),
                                        jnp.zeros((1, IMG, IMG, 3)))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    x = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    ref = gen.apply({"params": params}, jnp.asarray(x))
    net = Generator.from_state_dict(generator_state_dict_from_jax(params),
                                    trunk=trunk,
                                    compute_dtype=torch.float32)
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_bf16_compute_keeps_fp32_params():
    """compute_dtype=bf16: fp32 parameters, a bf16 trunk, an fp32 output,
    fp32 gradients."""
    net = Generator(3, 1, 8, trunk="tail", compute_dtype=torch.bfloat16)
    x = torch.rand(1, IMG, IMG, 3) * 2 - 1
    out = net(x)
    out.sum().backward()
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in net.parameters())


def test_chain_trunk_refuses_training():
    net = Generator(3, 1, 8, trunk="chain")
    with pytest.raises(RuntimeError, match="no backward"):
        net(torch.zeros(1, IMG, IMG, 3))


def test_lr_schedule_matches_jax():
    for epoch in (0, 50, 99, 100, 150, 9999):
        assert lr_for_epoch(2e-4, epoch, 10000, 100) == \
            jax_lr_for_epoch(2e-4, epoch, 10000, 100)


def test_dataset_matches_jax_dataset(tmp_path):
    """The port's SlicePairDataset (torch resize) against the JAX one
    (jax.image.resize): 48^2 slices resized to 32^2, masks generated."""
    pdir = write_patient(str(tmp_path / "p0"), n_slices=2, size=48)
    ours = SlicePairDataset([pdir], SOFT_TISSUE, img_size=IMG)
    ref = JaxSlicePairDataset([pdir], SOFT_TISSUE, img_size=IMG)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        got, want = ours[i], ref[i]
        assert set(got) == set(want) == {"a", "b", "masks"}
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def _cli_args(root, **extra):
    args = {"--data_root": str(root / "data"), "--dataset_names": "SynthSet",
            "--training_dir": str(root / "td"), "--img_size": str(IMG),
            "--batch_size": "2", "--num_residual_blocks": "2",
            "--base_channels": "8", "--disc_base_channels": "8",
            "--compute_dtype": "float32", "--device": "cpu",
            "--epochs": "3", "--max_epochs": "1",
            "--max_steps_per_epoch": "2", "--num_workers": "2",
            "--val_split": "0.34", **extra}
    return [a for kv in args.items() for a in kv]


def test_cli_trains_snapshots_and_resumes(tmp_path):
    """One epoch of 2 steps on 3 synthetic patients writes the full
    checkpoint and .pth snapshots; --resume continues from its epoch; a
    snapshot loads into Generator.from_state_dict."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    first = tcli.main(_cli_args(tmp_path))["soft_tissue"]
    saved = tmp_path / "td" / "soft_tissue" / "saved_models"
    assert first["epochs_run"] == 1 and len(first["step_seconds"]) == 2
    assert first["remat"] == "off" and not first["oom_fallback"]
    assert np.isfinite(first["val_loss"]) and np.isfinite(first["loss_G"])
    assert {"checkpoint.pt", "G_A2B_last.pth", "G_B2A_epoch_1.pth",
            "G_A2B_best_epoch_1.pth"} <= set(os.listdir(saved))
    assert (tmp_path / "td" / "soft_tissue" / "images" / "epoch_1.jpg") \
        .exists()
    sd = torch.load(saved / "G_A2B_last.pth", weights_only=True)
    gen = Generator.from_state_dict(sd, trunk="tail")
    assert gen.num_residual_blocks == 2
    assert gen(torch.zeros(1, IMG, IMG, 3)).shape == (1, IMG, IMG, 1)

    second = tcli.main(_cli_args(tmp_path))["soft_tissue"]
    assert second["epochs_run"] == 1
    assert "G_A2B_epoch_2.pth" in os.listdir(saved)
    resumed = torch.load(saved / ckpt.CHECKPOINT, weights_only=True)
    assert resumed["epoch"] == 1


def test_remat_auto_falls_back_on_oom(tmp_path, monkeypatch, capsys):
    """remat="auto": a step that runs out of device memory before its
    optimizers start is retried, and the run continues, with remat."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    real = tloop.make_train_step
    built = []

    def flaky(cfg, loss_cfg, *, remat, n_real=None):
        built.append(remat)
        step = real(cfg, loss_cfg, remat=remat, n_real=n_real)
        if remat:
            return step

        def oom(state, batch):
            raise torch.cuda.OutOfMemoryError("out of memory")
        oom.updating = False
        return oom

    monkeypatch.setattr(tloop, "make_train_step", flaky)
    out = tcli.main(_cli_args(tmp_path))["soft_tissue"]
    assert out["remat"] == "on" and out["oom_fallback"]
    assert built == [False, True] and len(out["step_seconds"]) == 2
    assert tloop.OOM_MESSAGE in capsys.readouterr().out


def test_non_finite_loss_stops_the_run(tmp_path, monkeypatch):
    """A non-finite logged loss saves checkpoint_nan.pt and raises."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    real = tloop.make_train_step

    def nan_step(*args, **kw):
        step = real(*args, **kw)

        def wrapped(state, batch):
            metrics = step(state, batch)
            metrics["loss_G"] = torch.tensor(float("nan"))
            return metrics
        wrapped.updating = False
        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tcli.main(_cli_args(tmp_path))
    assert (tmp_path / "td" / "soft_tissue" / "saved_models" /
            "checkpoint_nan.pt").exists()


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir traces steps [profile_start, profile_stop) of the first
    epoch with torch.profiler."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    cfg = replace(CFG, data_root=str(tmp_path / "data"),
                  dataset_names="SynthSet", training_dir=str(tmp_path / "td"),
                  resume="", val_split=0.34, num_workers=2, epochs=1,
                  profile_dir=str(tmp_path / "prof"), profile_start=0,
                  profile_stop=1)
    out = tloop.train_cycle_gan(cfg, "soft_tissue", MODEL, device="cpu",
                                max_steps_per_epoch=2)
    assert len(out["step_seconds"]) == 2
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_profile_dir_writes_a_trace_when_the_epoch_ends_early(tmp_path):
    """An epoch shorter than profile_stop still leaves a trace: the loop
    stops and exports at the end of the first epoch if the profiler is
    running; a window that never starts writes nothing."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    cfg = replace(CFG, data_root=str(tmp_path / "data"),
                  dataset_names="SynthSet", training_dir=str(tmp_path / "td"),
                  resume="", val_split=0.34, num_workers=2, epochs=1,
                  profile_dir=str(tmp_path / "prof"), profile_start=1,
                  profile_stop=8)
    out = tloop.train_cycle_gan(cfg, "soft_tissue", MODEL, device="cpu",
                                max_steps_per_epoch=2)
    assert len(out["step_seconds"]) == 2
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    late = replace(cfg, profile_dir=str(tmp_path / "late"), profile_start=5,
                   training_dir=str(tmp_path / "td2"))
    tloop.train_cycle_gan(late, "soft_tissue", MODEL, device="cpu",
                          max_steps_per_epoch=2)
    assert not (tmp_path / "late").exists()


def test_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--dataset_names", "none"])


def test_cli_refuses_multi_card(monkeypatch):
    """More cards asked for than are visible raises: no fallback to
    fewer (multi-card training itself: tests/test_torch_parallel.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 CUDA cards asked for, 1 visible"):
        tcli.main(["--num_devices", "2", "--dataset_names", "none"])


def test_checkpoint_round_trip(tmp_path, jax_run):
    """save_checkpoint / restore_checkpoint carry the networks, the Adam
    states and the bookkeeping."""
    src = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu",
                       state_dicts=jax_run["init"])
    make_train_step(CFG, remat=False)(src, _torch_batch(jax_run["batch"]))
    src.epoch, src.best_val_loss, src.best_epoch = 4, 1.5, 3
    path = str(tmp_path / "c.pt")
    ckpt.save_checkpoint(path, src)
    dst = create_state(CFG, SOFT_TISSUE, MODEL, device="cpu")
    assert ckpt.restore_checkpoint(path, dst)
    assert (dst.epoch, dst.best_val_loss, dst.best_epoch) == (4, 1.5, 3)
    for net in NETS:
        for a, b in zip(getattr(src, net).parameters(),
                        getattr(dst, net).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa = src.opt_g.state_dict()["state"][0]
    sb = dst.opt_g.state_dict()["state"][0]
    torch.testing.assert_close(sa["exp_avg_sq"], sb["exp_avg_sq"], rtol=0,
                               atol=0)
    assert not ckpt.restore_checkpoint(str(tmp_path / "missing.pt"), dst)
