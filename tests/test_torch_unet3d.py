"""The aux model (3-D U-Net "nmodel") of the port against the JAX package,
on the CPU at small sizes: ``models/unet3d.py``, ``models/nmodel_data.py``
and ``train/nmodel_loop.py``.

Tolerances (fp32 throughout), fixed from what the two packages' roundings
allow:
  - forward: rtol 1e-4 with atol 1e-5 in eval mode and 5e-5 in train mode
    (the deepest BatchNorm normalizes 24 values a channel with batch
    statistics, which flax takes as E[x^2] - E[x]^2);
  - three training steps at the default learning rate: losses rtol 1e-5;
    running means and variances rtol 2e-4, atol 1e-6 (an unbiased
    running-variance update reads 1.8e-3 apart here); every parameter
    within 0.1 lr of the JAX's, and the three steps' update within 1e-3
    relative L2 of the JAX's. At a learning rate of 1e-3 the two runs part
    chaotically from the second step on (Adam normalizes gradients that are
    rounding noise on both sides), so the test stays at 5e-5;
  - the dataset's samples and splits: equal.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ducosy_tpu.models import nmodel_data as jdata
from ducosy_tpu.models import unet3d as junet
from ducosy_tpu.train import nmodel_loop as jloop
from ducosy_tpu_torch.models import nmodel_data as tdata
from ducosy_tpu_torch.models import unet3d as tunet
from ducosy_tpu_torch.train import nmodel_loop as tloop

# H = 44, W = 36 pool to 22/18, 11/9, 5/4, 2/2: the upsampled maps are a
# pixel short of their skips at two levels, so the centre pad is not zero
SHAPE = (2, 3, 44, 36)          # B, D, H, W
BASE = 4


def _variables(light: bool, seed: int = 0):
    """The JAX module and its variables: the layout of a seeded torch init
    (through the JAX package's ``unet3d_params_from_torch``; ``model.init``
    runs op by op and costs half a minute), with seeded, non-trivial
    BatchNorm parameters and running statistics (init gives scale 1,
    bias 0, mean 0, var 1)."""
    model = (junet.UNet3DLight if light else junet.UNet3D)(base_channels=BASE)
    torch.manual_seed(seed)
    init = (tunet.UNet3DLight if light else tunet.UNet3D)(base_channels=BASE)
    params, stats = junet.unet3d_params_from_torch(init.state_dict())
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for k, val in tree.items():
            if isinstance(val, dict):
                out[k] = perturb(val)
                continue
            a = np.asarray(val, np.float32)
            if k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                a = rng.normal(0, 0.2, a.shape).astype(np.float32)
            out[k] = a
        return out

    return model, perturb(params), perturb(stats)


def _port(light: bool, params, stats):
    cls = tunet.UNet3DLight if light else tunet.UNet3D
    m = cls(base_channels=BASE)
    m.load_state_dict(tunet.unet3d_state_dict_from_variables(params, stats),
                      strict=True)
    return m


def _input(seed=1, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_normalization_matches_jax():
    vol = np.array([-2000.0, -1024.0, 0.5, 1023.5, 3071.0, 5000.0],
                   np.float32)
    diff = np.array([-5.0, 0.0, 1234.5, 4000.0, 6000.0], np.float32)
    for name, x in (("normalize_hu", vol), ("denormalize_hu", vol / 3000),
                    ("normalize_diff", diff), ("denormalize_diff", diff / 4000)):
        want = np.asarray(getattr(junet, name)(jnp.asarray(x)))
        np.testing.assert_allclose(getattr(tunet, name)(x), want,
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(
            getattr(tunet, name)(torch.from_numpy(x)).numpy(), want,
            rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("light", [True, False], ids=["light", "standard"])
def test_forward_matches_jax(light):
    """Eval mode (running statistics) and train mode (batch statistics),
    with the running statistics each updates."""
    model, params, stats = _variables(light)
    m = _port(light, params, stats)
    x = _input()
    xj = jnp.asarray(x[..., None])                   # NDHWC
    xt = torch.from_numpy(x[:, None])                # NCDHW
    apply = jax.jit(model.apply, static_argnames=("train", "mutable"))
    want = np.asarray(apply({"params": params, "batch_stats": stats},
                            xj, train=False))[..., 0]
    with torch.no_grad():
        got = m.eval()(xt)[:, 0].numpy()
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    want, mutated = apply({"params": params, "batch_stats": stats},
                          xj, train=True, mutable=("batch_stats",))
    with torch.no_grad():
        got = m.train()(xt)[:, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(want)[..., 0], rtol=1e-4,
                               atol=5e-5)
    _, new_stats = junet.unet3d_params_from_torch(m.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(new_stats),
                    jax.tree_util.tree_leaves(mutated["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    assert int(m.inc.double_conv[1].num_batches_tracked) == 1


@pytest.mark.parametrize("light", [True, False], ids=["light", "standard"])
def test_state_dict_round_trip(light):
    """``unet3d_params_from_torch`` on the port's state dict gives back the
    JAX variables it was made from, bit for bit."""
    _, params, stats = _variables(light, seed=3)
    p2, s2 = junet.unet3d_params_from_torch(
        tunet.unet3d_state_dict_from_variables(params, stats))
    for want, got in ((params, p2), (stats, s2)):
        assert jax.tree_util.tree_structure(want) == \
            jax.tree_util.tree_structure(got)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrapped"])
def test_load_model_reads_reference_layout(tmp_path, wrap):
    """A reference-layout ``.pth`` with ``num_batches_tracked`` (under
    ``model_state_dict`` or not) loads strictly, with the class and width
    read from it, and predicts what the JAX package's ``load_model`` +
    ``predict_volume`` predict from the same file."""
    _, params, stats = _variables(light=False, seed=5)
    sd = tunet.unet3d_state_dict_from_variables(params, stats)
    sd = {k: (torch.tensor(7) if k.endswith("num_batches_tracked") else v)
          for k, v in sd.items()}
    path = str(tmp_path / "nmodel.pth")
    torch.save({"model_state_dict": sd, "epoch": 3} if wrap else sd, path)
    m = tunet.load_model(path, device="cpu")
    assert isinstance(m, tunet.UNet3D) and not m.training
    assert m.inc.double_conv[0].weight.shape == (BASE, 1, 3, 3, 3)
    assert int(m.up4.conv.double_conv[4].num_batches_tracked) == 7
    jm, jv = junet.load_model(path)
    vol = np.random.default_rng(2).uniform(-1000, 2000, (5, 44, 36)).astype(
        np.float32)
    want = junet.predict_volume(jm, jv, vol, slice_batch=2)
    got = tunet.predict_volume(m, vol, slice_batch=2, device="cpu")
    assert got.shape == (5, 44, 36)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-2)  # HU
    if not torch.cuda.is_available():          # the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            tunet.predict_volume(m, vol)


def test_three_steps_match_jax():
    """Three steps of ``make_nmodel_step`` against the JAX step from the
    same variables on the same batches: losses, parameters and running
    statistics. At 16^2 the deepest BatchNorm of the light net sees
    2 x 1 x 2 x 2 = 8 values a channel, where an unbiased running variance
    is 8/7 of the biased one; clip 0.05 engages the global-norm clipping."""
    cfg = tdata.NModelConfig(model_type="light", base_channels=BASE,
                             gradient_clip_value=0.05, l1_weight=1.5)
    jcfg = jdata.NModelConfig(**{k: getattr(cfg, k) for k in (
        "model_type", "base_channels", "learning_rate",
        "gradient_clip_value", "l1_weight")})
    lr = cfg.learning_rate

    def flat(tree):
        return np.concatenate([np.ravel(np.asarray(a))
                               for a in jax.tree_util.tree_leaves(tree)])

    model, params, stats = _variables(light=True, seed=7)
    start = flat(params)
    m = _port(True, params, stats)
    _, step, _ = tloop.make_nmodel_step(m, cfg)
    tx, jstep, _ = jloop.make_nmodel_step(model, jcfg)
    opt_state = tx.init(params)
    rng = np.random.default_rng(11)
    clipped = []
    for _ in range(3):
        batch = {k: rng.uniform(-1, 1, (2, 1, 16, 16, 1)).astype(np.float32)
                 for k in ("vue", "diff")}
        params, stats, opt_state, jl = jstep(params, stats, opt_state,
                                             {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        loss = step(batch)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        clipped.append(float(torch.sqrt(sum(
            (p.grad ** 2).sum() for p in m.parameters()))))
        p2, s2 = junet.unet3d_params_from_torch(m.state_dict())
        np.testing.assert_allclose(flat(s2), flat(stats), rtol=2e-4,
                                   atol=1e-6)
        got, want = flat(p2), flat(params)
        assert np.abs(got - want).max() <= 0.1 * lr
        assert np.linalg.norm(got - want) <= \
            1e-3 * np.linalg.norm(want - start)
    # the clipped gradients' global norm is the clip value
    np.testing.assert_allclose(clipped, 0.05, rtol=1e-5)


@pytest.fixture
def nmodel_data(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("vue", "diff_map"):
        os.makedirs(tmp_path / sub)
    for pid in ("p1", "p2", "p3", "p4", "p5"):
        vue = rng.uniform(-1500, 3500, (3, 20, 28)).astype(np.float32)
        diff = rng.uniform(-100, 4500, (3, 20, 28)).astype(np.float32)
        np.save(tmp_path / "vue" / f"{pid}_vue.npy", vue)
        np.save(tmp_path / "diff_map" / f"{pid}_diff.npy", diff)
    return str(tmp_path)


@pytest.mark.parametrize("sklearn", [True, False],
                         ids=["sklearn", "no-sklearn"])
def test_dataset_matches_jax(nmodel_data, monkeypatch, sklearn):
    """The splits, with sklearn and with it blocked (the seeded shuffle),
    and every sample of a train and a val pass, patches larger than the
    volumes (zero padding) and smaller (random crops), depth 1 and 2."""
    if sklearn:
        pytest.importorskip("sklearn")
    else:
        monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    ids = [f"p{i}" for i in range(1, 6)]
    assert tdata._train_val_split(ids, 0.3, 42) == \
        jdata._train_val_split(ids, 0.3, 42)
    for mode in ("train", "val"):
        for patch, ppv in (((1, 16, 32), 4), ((2, 24, 12), 2)):
            kw = dict(val_size=0.3, patch_size=patch, patches_per_volume=ppv,
                      seed=3)
            a = tdata.CTDiffDataset(nmodel_data, mode, **kw)
            b = jdata.CTDiffDataset(nmodel_data, mode, **kw)
            assert a.patient_ids == b.patient_ids and len(a) == len(b)
            for i in range(len(a)):
                sa, sb = a[i], b[i]
                assert sa["vue"].shape == (*patch, 1)
                for k in ("vue", "diff"):
                    assert sa[k].dtype == np.float32
                    np.testing.assert_array_equal(sa[k], sb[k])
    with pytest.raises(ValueError):
        tdata.CTDiffDataset(nmodel_data, "test")


def test_config_round_trip_matches_jax(tmp_path):
    cfg = tdata.NModelConfig(base_channels=8, patch_size=(1, 64, 64))
    p = str(tmp_path / "cfg.json")
    cfg.save(p)
    assert tdata.NModelConfig.load(p) == cfg
    assert json.load(open(p)) == json.loads(json.dumps(
        __import__("dataclasses").asdict(jdata.NModelConfig(
            base_channels=8, patch_size=(1, 64, 64)))))


def test_train_nmodel_end_to_end(nmodel_data, tmp_path, monkeypatch):
    """The loop on the CPU beside the JAX loop: the same metrics keys and
    epochs, finite losses, the running statistics moved, and checkpoints
    that both packages' ``load_model`` read (the latest predicting the
    same through both). The JAX loop's ``model.init`` is jitted here (the
    same values; op by op it costs half a minute)."""
    init = junet.UNet3DLight.init
    monkeypatch.setattr(
        junet.UNet3DLight, "init",
        lambda self, key, x, train: jax.jit(
            lambda k, v: init(self, k, v, train=train))(key, x))
    def cfg(pkg, out):
        return pkg.NModelConfig(
            data_dir=nmodel_data, output_dir=str(tmp_path / out),
            model_type="light", base_channels=BASE, patch_size=(1, 16, 16),
            patches_per_volume=2, batch_size=2, num_epochs=2)

    tc, jc = cfg(tdata, "torch"), cfg(jdata, "jax")
    got = tloop.train_nmodel(tc, max_steps=3, device="cpu")
    want = jloop.train_nmodel(jc, max_steps=3)
    assert set(got) == set(want) and got["epochs_run"] == \
        want["epochs_run"] == 2
    assert np.isfinite(got["val_l1"]) and np.isfinite(got["best_val_l1"])

    def records(c):
        with open(os.path.join(c.output_dir, "nmodel_metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    mine, theirs = records(tc), records(jc)
    assert [sorted(r) for r in mine] == [sorted(r) for r in theirs]
    assert [r["epoch"] for r in mine] == [1, 2]
    assert all(np.isfinite(r["train_l1"]) and np.isfinite(r["val_l1"])
               for r in mine)
    assert os.path.exists(os.path.join(tc.output_dir, "nmodel_config.json"))
    latest = os.path.join(tc.checkpoint_dir, "nmodel_latest.pth")
    assert os.path.exists(os.path.join(tc.checkpoint_dir, "nmodel_best.pth"))
    m = tunet.load_model(latest, device="cpu")
    assert int(m.inc.double_conv[1].num_batches_tracked) == 6
    assert float(m.inc.double_conv[1].running_var.sub(1).abs().max()) > 0
    jm, jv = junet.load_model(latest)
    vol = np.random.default_rng(4).uniform(-1000, 2000, (3, 16, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        tunet.predict_volume(m, vol, slice_batch=2, device="cpu"),
        junet.predict_volume(jm, jv, vol, slice_batch=2), rtol=1e-4,
        atol=2e-2)


def test_save_results_matches_jax(tmp_path):
    """The host helpers: the same .npy volumes and the same slice PNGs as
    the JAX package's ``save_results``, flat volumes at 128."""
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.default_rng(0)
    diff = rng.uniform(0, 400, (3, 16, 16)).astype(np.float32)
    orig = rng.uniform(-1000, 1000, (3, 16, 16)).astype(np.float32)
    out = {name: pkg.save_results(diff, str(tmp_path / name), "p01",
                                  original_volume=orig)
           for name, pkg in (("jax", junet), ("torch", tunet))}
    assert set(out["torch"]) == set(out["jax"]) == {
        "diff_volume", "diff_slices", "combined_volume", "combined_slices"}
    for key in ("diff_volume", "combined_volume"):
        np.testing.assert_array_equal(np.load(out["torch"][key]),
                                      np.load(out["jax"][key]))
    for key in ("diff_slices", "combined_slices"):
        names = sorted(os.listdir(out["torch"][key]))
        assert names == sorted(os.listdir(out["jax"][key])) and \
            len(names) == 3
        for n in names:
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(out["torch"][key], n))),
                np.asarray(Image.open(os.path.join(out["jax"][key], n))))
    flat = np.full((2, 4, 4), 7.0, np.float32)
    np.testing.assert_array_equal(tunet.normalize_volume_to_uint8(flat),
                                  junet.normalize_volume_to_uint8(flat))
    assert (tunet.normalize_volume_to_uint8(flat) == 128).all()
