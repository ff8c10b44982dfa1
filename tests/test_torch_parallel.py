"""The port's data-parallel mesh (ducosy_tpu_torch/parallel) against the JAX
package's on the CPU, at a small size: 32^2 slices, 2 residual blocks,
base 8, SOFT_TISSUE (image + 2 masks), fp32.

Training ranks are spawned processes joined by gloo on the CPU; each spawn
has its own deadline (``timeout``) and process-group timeout. Held:
  (a) ``process_row_slice`` against the JAX function on a 1-D mesh of one
      device a process, errors included; ``data_mesh``'s refusals;
  (b) one step of 2 ranks against the port's one-process step at the same
      global batch of 4 (contrast and edge terms on), without and with a
      wrap-padded final batch: every metric at rtol 1e-5, every gradient at
      relative L2 <= 1e-4 (a bias that feeds an InstanceNorm: both sides'
      rounding noise, under an absolute bound), every updated parameter
      within 1e-6 wherever |gradient| > 1e-6 (Adam's first step is ~lr *
      sign(g), so a gradient at the noise floor may flip its update by
      2 lr), and the two ranks' parameters equal;
  (c) the same step against JAX's ``make_train_step`` on ``data_mesh(2)`` +
      ``shard_batch``: metrics rtol 1e-4, parameters as in (b);
  (d) the loss per half batch, averaged, is not the whole batch's: the
      gather is load-bearing;
  (e) the engine on a two-replica CPU mesh against the one-device engine
      and against the JAX engine on ``data_mesh(2)``;
  (f) both CLIs with ``--num_devices 2 --device cpu``, and the training
      CLI as two torchrun workers;
  (g) a rank that raises ends the training CLI within its deadline; ranks
      that all run out of memory retry under remat together.
"""
import datetime
import multiprocessing
import os
import re
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import ModelConfig as JaxModelConfig
from ducosy_tpu.config import SOFT_TISSUE as JAX_SOFT_TISSUE
from ducosy_tpu.config import TrainConfig as JaxTrainConfig
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.parallel import mesh as jmesh
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu_torch.cli import generate as tgen
from ducosy_tpu_torch.cli import train as tcli
from ducosy_tpu_torch.config import ModelConfig, SOFT_TISSUE, TrainConfig, \
    replace
from ducosy_tpu_torch.data.pairing import list_patient_dirs, train_val_split
from ducosy_tpu_torch.dicom import dcmread
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.losses.suite import generator_loss
from ducosy_tpu_torch.models.convert import (
    cyclegan_state_dicts_from_jax,
    generator_state_dict_from_jax,
)
from ducosy_tpu_torch.parallel import launch
from ducosy_tpu_torch.parallel.mesh import data_mesh, process_row_slice
from ducosy_tpu_torch.train.loop import run_steps

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu, write_dataset  # noqa: E402
from torch_rank_faults import train_oom_once  # noqa: E402

IMG, BATCH, BLOCKS, BASE = 32, 4, 2, 8
CFG = replace(TrainConfig(), img_size=IMG, batch_size=BATCH,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=BLOCKS, base_channels=BASE,
                    disc_base_channels=BASE)
JAX_CFG = replace(JaxTrainConfig(), img_size=IMG, batch_size=BATCH,
                  compute_dtype="float32")
JAX_MODEL = JaxModelConfig(num_residual_blocks=BLOCKS, base_channels=BASE,
                           disc_base_channels=BASE)
CPU2 = ["cpu", "cpu"]
DEADLINE_S = 240            # each spawn's join deadline
PG_TIMEOUT = datetime.timedelta(seconds=120)
NOISE_BOUND = 1e-5          # |grad| of a bias that feeds an InstanceNorm


def _batch(seed, n_real=None):
    rng = np.random.default_rng(seed)
    b = {"a": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
         "b": rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32),
         "masks": rng.integers(0, 2, (BATCH, IMG, IMG, 2)).astype(
             np.float32)}
    if n_real is not None:   # wrap-padded: the last rows copy the first
        b = {k: np.concatenate([v[:n_real], v[:BATCH - n_real]])
             for k, v in b.items()}
        b["weight"] = (np.arange(BATCH) < n_real).astype(np.float32)
    return b


def _feeds_instance_norm(net, name):
    """Biases of convs followed by an InstanceNorm: every generator conv
    but the head, every discriminator conv but the first and the head."""
    if not name.endswith(".bias"):
        return False
    idx = int(name.split(".")[1])
    if net.startswith("g"):
        return idx != 19 + BLOCKS
    return idx not in (0, 12)


def _spawn_steps(init, batches, n_real, devices=CPU2):
    return launch.spawn(run_steps, (init, batches, CFG, SOFT_TISSUE, MODEL),
                        devices, kwargs=dict(n_real=n_real),
                        timeout=DEADLINE_S, pg_timeout=PG_TIMEOUT)


# ------------------------------------------------------------------- (a)
ROW_CASES = [(8, 1, 0), (8, 2, 0), (8, 2, 1), (8, 4, 3), (16, 8, 5),
             (6, 3, 2), (8, 3, 0), (4, 2, 2), (4, 2, -1)]


@pytest.mark.parametrize("batch,world,rank", ROW_CASES)
def test_process_row_slice_matches_jax(monkeypatch, batch, world, rank):
    """The JAX function on a 1-D mesh of ``world`` devices, one a process,
    seen from process ``rank``: the same rows or the same error."""
    fake = types.SimpleNamespace(
        devices=np.array([types.SimpleNamespace(process_index=i)
                          for i in range(world)], dtype=object),
        shape={"data": world})
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    try:
        want = jmesh.process_row_slice(fake, batch)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            process_row_slice(world, rank, batch)
        return
    assert process_row_slice(world, rank, batch) == want


@pytest.mark.parametrize("kw,want", [
    (dict(devices=CPU2), 2),
    (dict(n_devices=1, devices=CPU2), 1),
    (dict(n_devices=3, devices=CPU2), ValueError),
    (dict(devices=[CPU2, CPU2]), NotImplementedError),
    (dict(n_devices=2), ValueError)],
    ids=["listed", "first", "too-many", "sp", "no-card"])
def test_data_mesh(monkeypatch, kw, want):
    """The listed devices (repeats allowed, as JAX's virtual devices), the
    first n of them as JAX's ``data_mesh(n)`` takes; more than exist raises
    where JAX silently takes fewer; a 2-D grid (an 'sp' axis) raises; two
    cards asked for where one is visible raise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if isinstance(want, int):
        got = data_mesh(**kw)
        assert got == (torch.device("cpu"),) * want
        assert jmesh.data_mesh(want).devices.size == want
        return
    with pytest.raises(want):
        data_mesh(**kw)


# -------------------------------------------------------------- (b), (c)
@pytest.fixture(scope="module")
def jax_init():
    state, gen, disc = jax_create_state(jax.random.PRNGKey(0), JAX_CFG,
                                        JAX_SOFT_TISSUE, JAX_MODEL,
                                        img_size=IMG)
    init = cyclegan_state_dicts_from_jax(
        jax.tree_util.tree_map(np.asarray, state))
    return state, gen, disc, init


@pytest.fixture(scope="module")
def dp_runs(jax_init):
    """n_real -> one global batch through the port's one-process step and
    through 2 gloo ranks, from the JAX init (computed once per n_real).
    n_real 1 leaves rank 1 nothing but padding."""
    init, cache = jax_init[3], {}

    def get(n_real):
        if n_real not in cache:
            batch = _batch(7, n_real)
            one = run_steps("cpu", init, [batch], CFG, SOFT_TISSUE, MODEL,
                            n_real=n_real)
            cache[n_real] = dict(one=one, two=_spawn_steps(init, [batch],
                                                           n_real))
        return cache[n_real]
    return get


N_REAL = pytest.mark.parametrize("n_real", [None, 3, 1],
                                 ids=["full", "padded3", "padded1"])


@N_REAL
def test_dp_ranks_stay_equal(dp_runs, n_real):
    two = dp_runs(n_real)["two"]
    assert [r["spread"] for r in two] == [[0.0], [0.0]]
    assert two[1]["params"] is None   # rank 0 reports


@N_REAL
def test_dp_step_metrics_match_one_process(dp_runs, n_real):
    run = dp_runs(n_real)
    ref = run["one"]["metrics"][0]
    for r in run["two"]:
        for k, v in ref.items():
            np.testing.assert_allclose(r["metrics"][0][k], v, rtol=1e-5,
                                       err_msg=k)


@N_REAL
def test_dp_step_gradients_and_params_match_one_process(dp_runs, n_real):
    one, two = dp_runs(n_real)["one"], dp_runs(n_real)["two"][0]
    for net, grads in one["grads"].items():
        for name, ref in grads.items():
            got = two["grads"][net][name]
            if _feeds_instance_norm(net, name):
                assert np.abs(ref).max() < NOISE_BOUND, name
                assert np.abs(got).max() < NOISE_BOUND, name
                continue
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-4, f"{net} {name}: relative L2 {rel:.2e}"
            keep = np.abs(ref) > 1e-6
            np.testing.assert_allclose(two["params"][net][name][keep],
                                       one["params"][net][name][keep],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{net} {name}")


@pytest.mark.parametrize("n_real", [None, 3], ids=["full", "padded3"])
def test_dp_step_matches_jax_data_mesh(dp_runs, jax_init, n_real):
    """JAX's step on data_mesh(2) + shard_batch from the same init and
    batch (tests/test_train_step.py:100-130)."""
    state, gen, disc, _ = jax_init
    mesh = jmesh.data_mesh(2)
    step = jax_make_train_step(gen, disc, JAX_CFG, donate=False, remat=False,
                               gen_forward="module", n_real=n_real)
    batch = {k: jnp.asarray(v) for k, v in _batch(7, n_real).items()}
    new, metrics = step(jmesh.replicate(mesh, state),
                        jmesh.shard_batch(mesh, batch))
    new = cyclegan_state_dicts_from_jax(
        jax.tree_util.tree_map(np.asarray, new))
    two = dp_runs(n_real)["two"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(two["metrics"][0][k], float(v), rtol=1e-4,
                                   err_msg=k)
    for net, params in new.items():
        for name, ref in params.items():
            keep = np.abs(two["grads"][net][name]) > 1e-6
            np.testing.assert_allclose(two["params"][net][name][keep],
                                       ref[keep], rtol=0, atol=1e-6,
                                       err_msg=f"{net} {name}")


# ------------------------------------------------------------------- (d)
def test_loss_per_half_batch_differs_from_global():
    """The port's generator loss on each half of the batch, averaged, is
    not the loss of the whole batch: the Bessel std of the region term and
    the top-k of the edge term are batch-wide. Each rank must see the
    global batch's loss inputs."""
    rng = np.random.default_rng(3)
    img = lambda: torch.from_numpy(
        rng.uniform(-1, 1, (BATCH, IMG, IMG, 1)).astype(np.float32))
    names = ("real_a", "real_b", "fake_a", "fake_b", "rec_a", "rec_b",
             "id_a", "id_b")
    inputs = {k: img() for k in names}
    logits = {k: torch.from_numpy(rng.normal(0.5, 0.3, (BATCH, 4, 4, 1))
                                  .astype(np.float32))
              for k in ("d_a_fake_logits", "d_b_fake_logits")}

    def loss(rows):
        return generator_loss(**{k: v[rows] for k, v in inputs.items()},
                              **{k: v[rows] for k, v in logits.items()},
                              cfg=CFG)

    whole = loss(slice(None))
    halves = [loss(slice(0, 2)), loss(slice(2, 4))]
    for term in ("contrast_region", "contrast_edge", "total"):
        mean = float(sum(getattr(h, term) for h in halves)) / 2
        ref = float(getattr(whole, term))
        assert abs(mean - ref) > 1e-3 * abs(ref), term
    # the per-sample means do average exactly
    mean = float(sum(h.cycle for h in halves)) / 2
    np.testing.assert_allclose(mean, float(whole.cycle), rtol=1e-6)


# ------------------------------------------------------------------- (e)
@pytest.fixture(scope="module")
def gen_params():
    init = jax.jit(JaxGenerator(1, BLOCKS, BASE).init)
    return [jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 1)))["params"])
        for seed in (2, 3)]


def _volume(z):
    hu = np.stack([chest_hu(IMG, IMG, z=i) for i in range(z)])
    return (hu + 1024.0).astype(np.int16)


def _engine(params, **kw):
    sds = [generator_state_dict_from_jax(p) for p in params]
    return DualGeneratorEngine(*sds, img_size=IMG,
                               compute_dtype=torch.float32, **kw)


def test_engine_mesh_matches_one_device_and_jax(gen_params):
    """run_patient on two CPU replicas (each chunk of 4 in parts of 2; 6
    slices, so the last chunk is padded) against the one-device engine
    and the JAX engine on data_mesh(2): |d| <= 1 stored unit on >= 99.9%
    of voxels (fp32 summation order can flip a truncation)."""
    vol = _volume(6)
    eng = _engine(gen_params, mesh=data_mesh(devices=CPU2))
    assert len(eng.replicas) == 2 and eng.device == torch.device("cpu")
    assert eng.replicas[0][0] is not eng.replicas[1][0]
    got = eng.run_patient(vol, 1.0, -1024.0, chunk=4)
    one = _engine(gen_params, device="cpu").run_patient(vol, 1.0, -1024.0,
                                                        chunk=4)
    jeng = JaxEngine(*gen_params, model_cfg=JaxModelConfig(
        num_residual_blocks=BLOCKS, base_channels=BASE), img_size=IMG,
        compute_dtype=jnp.float32, mesh=jmesh.data_mesh(2),
        forward="module")
    ref = jeng.run_patient(vol, 1.0, -1024.0, chunk=4)
    assert got.shape == vol.shape and got.dtype == np.int16
    for other in (one, ref):
        d = np.abs(got.astype(np.int32) - other.astype(np.int32))
        assert np.mean(d <= 1) >= 0.999


def test_engine_mesh_generate_batch_on_first_device(gen_params):
    """generate_batch runs whole on the first replica, as the JAX engine's
    does not shard either: equal to the one-device engine's."""
    stored = _volume(3).astype(np.float32)
    got = _engine(gen_params, mesh=data_mesh(devices=CPU2)).generate_batch(
        stored, 1.0, -1024.0)
    want = _engine(gen_params, device="cpu").generate_batch(
        stored, 1.0, -1024.0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["chunk", "device", "sp"])
def test_engine_mesh_refusals(gen_params, case):
    """A chunk that does not split into the mesh's parts raises, as the JAX
    engine's; a device that disagrees with the mesh's first raises; a 2-D
    mesh (an 'sp' axis of rows) raises and names ROADMAP."""
    if case == "chunk":
        eng = _engine(gen_params, mesh=data_mesh(devices=CPU2))
        with pytest.raises(ValueError, match="not divisible"):
            eng.run_patient(_volume(4), 1.0, -1024.0, chunk=3)
    elif case == "device":
        with pytest.raises(ValueError, match="disagrees"):
            _engine(gen_params, device="cuda", mesh=data_mesh(devices=CPU2))
    else:
        with pytest.raises(NotImplementedError, match="'sp'.*ROADMAP"):
            _engine(gen_params, mesh=[CPU2, CPU2])


# ------------------------------------------------------------------- (f)
TRAIN_FLAGS = ["--device", "cpu", "--compute_dtype", "float32",
               "--img_size", str(IMG), "--batch_size", "2",
               "--num_residual_blocks", str(BLOCKS), "--base_channels",
               str(BASE), "--disc_base_channels", str(BASE), "--max_epochs",
               "1", "--max_steps_per_epoch", "2", "--num_workers", "1",
               "--val_split", "0.34", "--resume", ""]


def test_train_cli_two_cpu_ranks(tmp_path):
    """One epoch of 2 steps on 2 gloo ranks: rank 0's summary; one set of
    files, written by rank 0 (a metrics line per logged step and one for
    the epoch, no rank's duplicate)."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    t0 = time.monotonic()
    out = tcli.main(["--data_root", str(tmp_path / "data"),
                     "--dataset_names", "SynthSet",
                     "--training_dir", str(tmp_path / "td"),
                     "--num_devices", "2", *TRAIN_FLAGS])["soft_tissue"]
    assert time.monotonic() - t0 < DEADLINE_S
    assert len(out["step_seconds"]) == 2 and out["epochs_run"] == 1
    assert all(np.isfinite(out[k]) for k in ("loss_G", "loss_D",
                                             "val_loss"))
    run = tmp_path / "td" / "soft_tissue"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2, lines   # step 0 (log_every 10) + the epoch
    saved = {p.name for p in (run / "saved_models").iterdir()}
    assert {"checkpoint.pt", "G_A2B_last.pth", "G_B2A_epoch_1.pth"} <= saved
    assert not any(n.endswith(".tmp") for n in saved)
    assert [p.name for p in (run / "images").iterdir()] == ["epoch_1.jpg"]


def test_generate_cli_two_cpu_replicas(tmp_path):
    """--num_devices 2 --device cpu writes the series of one device."""
    write_dataset(str(tmp_path / "input"), n_patients=1, n_slices=4,
                  size=IMG)
    paths = []
    for seed in (4, 5):
        paths.append(str(tmp_path / f"g{seed}.pth"))
        init = jax.jit(JaxGenerator(1, BLOCKS, BASE).init)
        p = jax.tree_util.tree_map(np.asarray, init(
            jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 1)))["params"])
        torch.save({k: torch.from_numpy(v) for k, v in
                    generator_state_dict_from_jax(p).items()}, paths[-1])
    series = []
    for n in ("2", "1"):
        out = tmp_path / f"out{n}"
        assert tgen.main([
            "--input_dir_root", str(tmp_path / "input"),
            "--output_dir_root", str(out), "--dataset_names", "SynthSet",
            "--img_size", str(IMG), "--slice_batch", "2",
            "--soft_tissue_model", paths[0], "--lung_model", paths[1],
            "--compute_dtype", "float32", "--device", "cpu",
            "--num_devices", n]) == 1
        files = sorted((out / "SynthSet" / "patient00").glob("*.dcm"))
        series.append(np.stack([dcmread(str(f)).pixel_array for f in files]))
    assert series[0].shape == (4, IMG, IMG)
    np.testing.assert_array_equal(series[0], series[1])


# ------------------------------------------------------------------- (g)
def test_failing_rank_fails_the_train_cli(tmp_path):
    """A training slice whose pixel data is cut short raises in the one rank
    that loads it while the other waits in the step's gather: the CLI
    raises that rank's exception well before the process group's timeout,
    and no rank is left running."""
    root = tmp_path / "data"
    write_dataset(str(root), n_patients=3, n_slices=2, size=IMG)
    train, _ = train_val_split(list_patient_dirs(str(root), "SynthSet"),
                               0.34, TrainConfig().split_seed)
    victim = sorted((root / "SynthSet" / os.path.basename(train[0])
                     / "POST STD").glob("*.dcm"))[0]
    data = victim.read_bytes()
    victim.write_bytes(data[:len(data) - IMG * IMG])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="HostLoader worker failed"):
        tcli.main(["--data_root", str(root), "--dataset_names", "SynthSet",
                   "--training_dir", str(tmp_path / "td"),
                   "--num_devices", "2", *TRAIN_FLAGS])
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_ranks_agree_to_retry_under_remat(tmp_path):
    """remat="auto" on 2 ranks whose un-remat'd steps all run out of memory
    before their optimizers start: the ranks agree, retry that step and
    run the rest under remat, as one process does."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    args = tcli.parse_args(["--data_root", str(tmp_path / "data"),
                            "--dataset_names", "SynthSet",
                            "--training_dir", str(tmp_path / "td"),
                            *TRAIN_FLAGS, "--remat", "auto"])
    ranks = launch.spawn(train_oom_once, (args,), CPU2, timeout=DEADLINE_S,
                         pg_timeout=PG_TIMEOUT)
    for out in ranks:
        out = out["soft_tissue"]
        assert out["remat"] == "on" and out["oom_fallback"]
        assert len(out["step_seconds"]) == 2


def test_train_cli_under_torchrun(tmp_path):
    """Two torchrun workers on the CPU, each one rank of the training CLI
    (``WORLD_SIZE`` set: ``init_distributed`` joins torchrun's group): one
    set of files, written by rank 0."""
    write_dataset(str(tmp_path / "data"), n_patients=3, n_slices=2,
                  size=IMG)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ducosy_tpu_torch.cli.train",
         "--data_root", str(tmp_path / "data"), "--dataset_names",
         "SynthSet", "--training_dir", str(tmp_path / "td"), *TRAIN_FLAGS],
        cwd=root, capture_output=True, text=True, timeout=DEADLINE_S,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "td" / "soft_tissue"
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 2
    assert (run / "saved_models" / "checkpoint.pt").is_file()
    assert proc.stdout.count("=== soft_tissue done") == 1
