"""The port's generator, engine and generate CLI against the JAX package,
on the CPU (device="cpu" passed explicitly; the kernel wrappers then run
their plain versions).

Sizes are small (base 8 -> 32 trunk channels, 3-4 residual blocks, 32^2
slices). Tolerances: generator output rtol 1e-4; int16 volumes |d| <= 1
stored unit on >= 99.9% of voxels (the profile the JAX package's own
serving checks use: fp32 summation order can flip a truncation).
"""
import functools
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import LUNG, SOFT_TISSUE
from ducosy_tpu.dicom import codec, dcmread
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.models.torch_import import (
    generator_params_from_torch,
    generator_params_to_torch,
    load_torch_state_dict,
)
from ducosy_tpu_torch.cli import generate as tgen
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import (
    generator_state_dict_from_jax,
    init_generator_state_dict,
)
from ducosy_tpu_torch.models.generator import Generator

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu, write_dataset  # noqa: E402

BASE, BLOCKS, SIZE = 8, 3, 32


def _within_one(got, ref, share=0.999):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    return float(np.mean(d <= 1)) >= share


@functools.lru_cache(maxsize=None)
def _jax_init(blocks):
    return jax.jit(JaxGenerator(1, blocks, BASE).init)


def _jax_params(seed, blocks=BLOCKS):
    p = _jax_init(blocks)(jax.random.PRNGKey(seed),
                          jnp.zeros((1, SIZE, SIZE, 1)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _volume(z=6, size=SIZE):
    hu = np.stack([chest_hu(size, size, z=i) for i in range(z)])
    return (hu + 1024.0).astype(np.int16)


def _engine(st, lung, **kw):
    kw = {"img_size": SIZE, "compute_dtype": torch.float32, "device": "cpu",
          **kw}
    return DualGeneratorEngine(st, lung, **kw)


@pytest.mark.parametrize("blocks,in_ch", [(3, 1), (4, 1), (3, 3), (3, 2)],
                         ids=["3", "4", "3-stem3ch", "3-stem2ch"])
@pytest.mark.parametrize("trunk", ["chain", "plain"])
def test_generator_matches_jax(blocks, in_ch, trunk):
    """Port forward vs Generator.apply at fp32, with non-zero biases. At 3
    blocks the chain trunk is one group of 3; at 4 a group of 3 plus a
    remainder group of 1. The chain trunk drops the trunk conv biases,
    which the following InstanceNorms cancel. The 3- and 2-channel stems are
    the image + masks inputs of the SOFT_TISSUE and LUNG checkpoints the
    training CLI writes; the state dict is cut from 9 blocks to 3 as
    models/convert.py carries it."""
    rng = np.random.default_rng(blocks)
    sd = init_generator_state_dict(blocks, in_ch, BASE, blocks)
    for k in sd:
        if k.endswith(".bias"):
            sd[k] = rng.normal(0, 0.1, sd[k].shape).astype(np.float32)
    params = generator_params_from_torch(sd, blocks)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, in_ch)).astype(np.float32)
    ref = JaxGenerator(in_ch, blocks, BASE).apply({"params": params},
                                                  jnp.asarray(x))
    gen = Generator.from_state_dict(sd, trunk=trunk).eval()
    with torch.inference_mode():
        got = gen(torch.from_numpy(x))
    assert got.shape == (2, SIZE, SIZE, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_state_dict_layout_matches_reference_mapping():
    """generator_state_dict_from_jax reproduces torch_import's mapping, and
    the result (and the seeded numpy init) loads strictly."""
    params = _jax_params(0, blocks=2)
    ours = generator_state_dict_from_jax(params)
    ref = generator_params_to_torch(params, 2)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert set(Generator(1, 2, BASE).state_dict()) == set(ours)
    Generator.from_state_dict(ours)
    init = init_generator_state_dict(0, 1, BASE, 2)
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in ours.items()}
    w = init["model.10.block.1.weight"]
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert not any(init[k].any() for k in init if k.endswith(".bias"))


@pytest.fixture(scope="module")
def pth_pair(tmp_path_factory):
    """Two JAX-initialized generators written as .pth (torch.save of
    generator_params_to_torch output, values made tensors), and the JAX
    engine's run_patient on them: fp32, forward='module', 6 slices,
    chunk 4 (so the last chunk is z-padded)."""
    d = tmp_path_factory.mktemp("pth")
    params = [_jax_params(0), _jax_params(1)]
    paths = []
    for name, p in zip(("st", "lung"), params):
        path = str(d / f"{name}.pth")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    generator_params_to_torch(p, BLOCKS).items()}, path)
        paths.append(path)
    # the JAX engine's from_torch_checkpoints assumes 9 blocks; load the
    # same files through its loader with the depth given
    jeng = JaxEngine(*(generator_params_from_torch(load_torch_state_dict(p),
                                                   BLOCKS) for p in paths),
                     img_size=SIZE, compute_dtype=jnp.float32,
                     forward="module")
    ref = jeng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    return params, paths, ref


def test_run_patient_matches_jax_engine(pth_pair):
    params, _, ref = pth_pair
    eng = _engine(*(generator_state_dict_from_jax(p) for p in params))
    got = eng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert _within_one(got, ref)


def test_pth_checkpoints_load_in_both_engines(pth_pair):
    params, paths, ref = pth_pair
    eng = DualGeneratorEngine.from_torch_checkpoints(
        *paths, img_size=SIZE, compute_dtype=torch.float32, device="cpu")
    got = eng.run_patient(_volume(), 1.0, -1024.0, chunk=4)
    assert _within_one(got, ref)
    mem = _engine(*(generator_state_dict_from_jax(p) for p in params))
    np.testing.assert_array_equal(
        got, mem.run_patient(_volume(), 1.0, -1024.0, chunk=4))


def test_generate_batch_with_resize_matches_jax():
    """48^2 slices through a 32^2 model: resize in, both generators, resize
    back, decode to stored floats (no rounding)."""
    params = [_jax_params(2, blocks=1), _jax_params(3, blocks=1)]
    stored = _volume(z=3, size=48).astype(np.float32)
    jeng = JaxEngine(*params, img_size=SIZE, compute_dtype=jnp.float32,
                     forward="module")
    ref = jeng.generate_batch(stored, 1.0, -1024.0)
    got = _engine(*(generator_state_dict_from_jax(p) for p in params)) \
        .generate_batch(stored, 1.0, -1024.0)
    for k in ("st_stored", "lung_stored", "raw_hu"):
        assert got[k].shape == (3, 48, 48)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=2e-3,
                                   err_msg=k)


def test_engine_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = init_generator_state_dict(0, 1, BASE, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DualGeneratorEngine(sd, sd)


@pytest.mark.parametrize("kw,match", [
    ({"trunk": "chain3"}, "requires the packed forward"),
    ({"mesh": [["cpu", "cpu"], ["cpu", "cpu"]], "quant": "trunk"},
     "spatial \\('sp'\\) sharding"),
    ({"masks": True}, "mask"),
    ({"no_cbam": True, "trunk": "chain"}, "needs CBAM checkpoints")],
    ids=["kw1-jax-trunk", "kw2-multi-device", "kw3-mask", "kw4-no-cbam"])
def test_engine_refuses_unported_modes(kw, match):
    """What the engine refuses: a JAX packed-trunk name under the module
    forward and a trunk with the CBAM gates on a checkpoint without them,
    as the JAX engine refuses them (ducosy_tpu/infer/engine.py:207-219); a
    quantized mode on a mesh with an 'sp' axis (a 2-D device grid), as the
    JAX engine refuses it (engine.py:69-75; the sp mesh is served,
    tests/test_torch_spatial_mesh.py). Mask-conditioned checkpoints
    are served; what is refused is a checkpoint whose input channels do not
    fit its range's masks (3 channels on LUNG's one mask)."""
    sd = init_generator_state_dict(0, 1, BASE, 1)
    st, exc = sd, ValueError
    if kw.pop("masks", False):
        st = init_generator_state_dict(0, 3, BASE, 1)
        kw["st_range"] = LUNG
    if kw.pop("no_cbam", False):
        st = init_generator_state_dict(0, 1, BASE, 1, use_cbam=False)
    with pytest.raises(exc, match=match):
        _engine(st, sd, **kw)


def test_generate_cli_matches_engine(tmp_path):
    """The port's generate CLI on a 2-patient synthetic dataset: every
    slice written, tags set, pixels equal to a direct run_patient."""
    write_dataset(str(tmp_path / "input"), n_patients=2, n_slices=4,
                  size=SIZE)
    sds = [init_generator_state_dict(s, 1, BASE, BLOCKS) for s in (5, 6)]
    paths = []
    for name, sd in zip(("st", "lung"), sds):
        paths.append(str(tmp_path / f"{name}.pth"))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[-1])
    done = tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "SynthSet", "--img_size", str(SIZE),
        "--slice_batch", "2", "--soft_tissue_model", paths[0],
        "--lung_model", paths[1], "--compute_dtype", "float32",
        "--device", "cpu"])
    assert done == 2
    eng = _engine(*sds)
    for pid in ("patient00", "patient01"):
        src = tmp_path / "input" / "SynthSet" / pid / "POST VUE"
        vol = np.stack([dcmread(str(f)).pixel_array
                        for f in sorted(src.glob("*.dcm"))])
        want = eng.run_patient(vol, 1.0, -1024.0, chunk=2).astype(vol.dtype)
        out = tmp_path / "output" / "SynthSet" / pid
        files = sorted(os.listdir(out))
        assert files == [f"{i:04d}.dcm" for i in range(4)]
        for i, f in enumerate(files):
            ds = dcmread(str(out / f))
            assert ds.SeriesDescription == "DuCoSyGAN sCECT v2"
            np.testing.assert_array_equal(ds.pixel_array, want[i])


def test_generate_cli_rewrites_compressed_series(tmp_path):
    """An RLE-compressed input series is written back as readable Explicit
    VR LE (the writer resets the transfer syntax before the swap)."""
    d = tmp_path / "input" / "DS" / "p0" / "POST VUE"
    d.mkdir(parents=True)
    for i, hu in enumerate(_volume(z=2)):
        ds = codec.new_ct_dataset(SIZE, SIZE, instance_number=i + 1)
        ds.set_pixel_array(hu.astype(np.uint16))
        codec.dcmwrite(str(d / f"{i:04d}.dcm"), ds,
                       transfer_syntax=codec.RLE_LOSSLESS)
    sd = init_generator_state_dict(7, 1, BASE, 1)
    path = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tgen.main(["--input_dir_root", str(tmp_path / "input"),
               "--output_dir_root", str(tmp_path / "output"),
               "--dataset_names", "DS", "--img_size", str(SIZE),
               "--soft_tissue_model", path, "--lung_model", path,
               "--compute_dtype", "float32", "--device", "cpu"])
    for f in sorted((tmp_path / "output" / "DS" / "p0").glob("*.dcm")):
        ds = dcmread(str(f))
        assert ds.transfer_syntax_uid == codec.EXPLICIT_VR_LE
        assert ds.pixel_array.shape == (SIZE, SIZE)


@pytest.mark.parametrize("kw,want", [
    ({"quant": "int4"}, None), ({"quant": "trunk"}, "trunk"),
    ({"quant": "full"}, "full"), ({"trunk_int8": True}, "trunk")])
def test_engine_quant_modes(kw, want):
    """quant None/"trunk"/"full" with the trunk_int8 alias, as the JAX
    engine takes them; another mode raises ValueError naming quant."""
    sd = init_generator_state_dict(0, 1, BASE, 1)
    if want is None:
        with pytest.raises(ValueError, match="quant"):
            _engine(sd, sd, **kw)
        return
    eng = _engine(sd, sd, **kw)
    assert eng.quant == want and eng.st_generator.quant == want
    assert eng.quant_calibration == "static-12sigma"
    assert eng.st_generator.qweights["conv2"][0].dtype == torch.int8


@pytest.mark.parametrize("flags,quant", [(["--quant", "trunk"], "trunk"),
                                         (["--trunk_int8"], "trunk"),
                                         (["--quant", "full"], "full")])
def test_generate_cli_writes_quantized_series(tmp_path, flags, quant):
    """--quant trunk|full and --trunk_int8 on the CPU plain path: the CLI
    writes the series of a direct quantized run_patient."""
    write_dataset(str(tmp_path / "input"), n_patients=1, n_slices=3,
                  size=SIZE)
    sds = [init_generator_state_dict(s, 1, BASE, BLOCKS) for s in (8, 9)]
    paths = []
    for name, sd in zip(("st", "lung"), sds):
        paths.append(str(tmp_path / f"{name}.pth"))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[-1])
    done = tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "SynthSet", "--img_size", str(SIZE),
        "--slice_batch", "2", "--soft_tissue_model", paths[0],
        "--lung_model", paths[1], "--compute_dtype", "float32",
        "--device", "cpu", *flags])
    assert done == 1
    src = tmp_path / "input" / "SynthSet" / "patient00" / "POST VUE"
    vol = np.stack([dcmread(str(f)).pixel_array
                    for f in sorted(src.glob("*.dcm"))])
    want = _engine(*sds, quant=quant).run_patient(vol, 1.0, -1024.0,
                                                  chunk=2).astype(vol.dtype)
    plain = _engine(*sds).run_patient(vol, 1.0, -1024.0, chunk=2)
    assert not np.array_equal(want, plain)   # the int8 path really ran
    out = tmp_path / "output" / "SynthSet" / "patient00"
    for i, f in enumerate(sorted(out.glob("*.dcm"))):
        np.testing.assert_array_equal(dcmread(str(f)).pixel_array, want[i])


@pytest.mark.parametrize("flags,desc", [
    (["--write_working"], "DuCoSyGAN sCECT v2"),
    (["--num_devices", "2", "--device", "cuda"], None),
    (["--synthesis_mode", "additive"], "DuCoSyGAN sCECT v2"),
    (["--soft_squeeze", "--write_working"], "DuCoSyGAN sCECT v2")],
    ids=["flags0", "flags3", "flags4", "flags5"])
def test_generate_cli_refuses_unported_flags(tmp_path, monkeypatch, flags,
                                            desc):
    """--num_devices asking for more cards than are visible raises (no
    fallback to fewer; serving on a data mesh: tests/test_torch_parallel.py).
    --write_working (also with --soft_squeeze) runs the working path and
    writes the working series; --synthesis_mode additive without it serves
    the fast path, as the JAX CLI does (tests/test_torch_synthesis.py holds
    both paths' numbers)."""
    if desc is None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 CUDA cards asked for, 1 "
                                             "visible"):
            tgen.main(["--dataset_names", "none", "--device", "cpu", *flags])
        return
    write_dataset(str(tmp_path / "input"), n_patients=1, n_slices=2,
                  size=SIZE)
    path = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                init_generator_state_dict(3, 1, BASE, 1).items()}, path)
    assert tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--working_dir_root", str(tmp_path / "working"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "SynthSet", "--img_size", str(SIZE),
        "--soft_tissue_model", path, "--lung_model", path,
        "--compute_dtype", "float32", "--device", "cpu", *flags]) == 1
    out = sorted((tmp_path / "output" / "SynthSet" / "patient00")
                 .glob("*.dcm"))
    assert len(out) == 2
    assert all(dcmread(str(f)).SeriesDescription == desc for f in out)
    working = tmp_path / "working" / "SynthSet" / "patient00"
    assert working.is_dir() == ("--write_working" in flags)


def test_generate_cli_loads_npz_params(tmp_path):
    from ducosy_tpu.train.checkpoint import save_params_npz

    params = _jax_params(4, blocks=2)
    path = str(tmp_path / "g.npz")
    save_params_npz(path, params)
    got = tgen._load_generator(path)
    want = generator_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_package_imports_without_jax():
    """Every module of ducosy_tpu_torch imports in a fresh interpreter
    without pulling in JAX or flax (the card machine has neither)."""
    import ducosy_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        ducosy_tpu_torch.__path__, "ducosy_tpu_torch.")]
    for mod in ("ops.kernels.residual_chain", "ops.kernels.block_tail",
                "models.discriminator", "losses.suite", "train.loop",
                "data.dataset", "cli.train"):
        assert f"ducosy_tpu_torch.{mod}" in names, mod
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)


# --------------------------------------------------------- trunk="mega"
def test_run_patient_mega_matches_jax_engine(pth_pair):
    """run_patient(trunk="mega") against the JAX engine's run_patient (fp32,
    forward='module'): |d| <= 1 stored unit on >= 99.9% of voxels; and the
    mega, chain and plain trunks agree on the port side the same way."""
    params, _, ref = pth_pair
    sds = [generator_state_dict_from_jax(p) for p in params]
    got = _engine(*sds, trunk="mega").run_patient(_volume(), 1.0, -1024.0,
                                                  chunk=4)
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert _within_one(got, ref)
    for trunk in ("chain", "plain"):
        other = _engine(*sds, trunk=trunk).run_patient(_volume(), 1.0,
                                                       -1024.0, chunk=4)
        assert _within_one(got, other), trunk


# ------------------------------------------- mask-conditioned checkpoints
MSIZE = 96   # the mask detectors zero a 32-px border: 32^2 has no lungs


def _mask_pair():
    """A 3-channel SOFT_TISSUE (image + bone + mediastinum) and a 2-channel
    LUNG (image + lung) generator, seeded, with non-zero biases."""
    rng = np.random.default_rng(21)
    sds = [init_generator_state_dict(11, 3, BASE, 2),
           init_generator_state_dict(12, 2, BASE, 2)]
    for sd in sds:
        for k in sd:
            if k.endswith(".bias"):
                sd[k] = rng.normal(0, 0.1, sd[k].shape).astype(np.float32)
    return sds


def _mask_volume(z=5, size=MSIZE):
    return _volume(z=z, size=size)


@functools.lru_cache(maxsize=None)
def _jax_masked_ref(img_size, soft_squeeze, size=MSIZE):
    sds = _mask_pair()
    jeng = JaxEngine(*(generator_params_from_torch(sd, 2) for sd in sds),
                     img_size=img_size, compute_dtype=jnp.float32,
                     forward="module", soft_squeeze=soft_squeeze)
    return jeng.run_patient(_mask_volume(size=size), 1.0, -1024.0, chunk=4)


@pytest.mark.parametrize("soft_squeeze", [False, True],
                         ids=["linear", "soft_squeeze"])
@pytest.mark.parametrize("trunk", ["chain", "mega"])
def test_masked_run_patient_matches_jax_engine(trunk, soft_squeeze):
    """A 3-channel SOFT_TISSUE + 2-channel LUNG pair through run_patient
    (5 slices, chunk 4: the z pad copies the last mask) against the JAX
    engine at fp32: |d| <= 1 stored unit on >= 99.9% of voxels. With
    soft_squeeze the SOFT_TISSUE input takes the squeeze (its range trains
    with it), LUNG stays linear, and the result differs from the linear
    one."""
    ref = _jax_masked_ref(MSIZE, soft_squeeze)
    eng = _engine(*_mask_pair(), img_size=MSIZE, trunk=trunk,
                  soft_squeeze=soft_squeeze)
    assert eng.use_masks and (eng.st_channels, eng.lung_channels) == (3, 2)
    got = eng.run_patient(_mask_volume(), 1.0, -1024.0, chunk=4)
    assert got.dtype == np.int16 and got.shape == ref.shape
    assert _within_one(got, ref)
    if soft_squeeze:
        assert not _within_one(got, _jax_masked_ref(MSIZE, False))


def test_masked_host_masks_match_jax_engine():
    """The mask channels the engine feeds: equal to the JAX engine's
    ``_host_masks`` arrays, non-empty, at model resolution with nearest
    resize (96^2 slices into a 64^2 model), threaded or serial."""
    sds = _mask_pair()
    vol = _mask_volume(z=20)       # long enough for the threaded split
    eng = _engine(*sds, img_size=64)
    jeng = JaxEngine(*(generator_params_from_torch(sd, 2) for sd in sds),
                     img_size=64, compute_dtype=jnp.float32, forward="module")
    got, ref = eng._host_masks(vol, 1.0, -1024.0), \
        jeng._host_masks(vol, 1.0, -1024.0)
    assert set(got) == set(ref) == {"st", "lung"}
    assert got["st"].shape == (20, 64, 64, 2)
    assert got["lung"].shape == (20, 64, 64, 1)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].any() and set(np.unique(got[k])) <= {0.0, 1.0}
    hu_vol = vol.astype(np.float32) - 1024.0
    serial = eng._masks_threaded(hu_vol, ("lung",), n_workers=1)
    split = eng._masks_threaded(hu_vol, ("lung",), n_workers=4)
    np.testing.assert_array_equal(serial["lung"], split["lung"])


def test_masked_run_patient_prefetch_and_resize():
    """img_size 64 on 96^2 slices (antialiased image resize, nearest mask
    resize) against the JAX engine; a prefetch_masks future, its result and
    no masks argument give the same volume."""
    ref = _jax_masked_ref(64, False)
    eng = _engine(*_mask_pair(), img_size=64)
    vol = _mask_volume()
    fut = eng.prefetch_masks(vol, 1.0, -1024.0)
    assert hasattr(fut, "result")
    got = eng.run_patient(vol, 1.0, -1024.0, chunk=4, masks=fut)
    assert _within_one(got, ref)
    np.testing.assert_array_equal(
        got, eng.run_patient(vol, 1.0, -1024.0, chunk=4, masks=fut.result()))
    np.testing.assert_array_equal(
        got, eng.run_patient(vol, 1.0, -1024.0, chunk=4))
    plain = init_generator_state_dict(0, 1, BASE, 1)
    assert _engine(plain, plain).prefetch_masks(vol, 1.0, -1024.0) is None


def test_one_masked_model_with_a_released_one():
    """A 3-channel soft-tissue checkpoint beside a 1-channel lung one: only
    the soft-tissue model gets masks (ducosy_tpu/infer/engine.py:288-296)."""
    st = _mask_pair()[0]
    lung = init_generator_state_dict(13, 1, BASE, 2)
    jeng = JaxEngine(generator_params_from_torch(st, 2),
                     generator_params_from_torch(lung, 2), img_size=MSIZE,
                     compute_dtype=jnp.float32, forward="module")
    vol = _mask_volume(z=3)
    ref = jeng.generate_batch(vol, 1.0, -1024.0)
    eng = _engine(st, lung, img_size=MSIZE)
    assert set(eng._host_masks(vol, 1.0, -1024.0)) == {"st"}
    got = eng.generate_batch(vol, 1.0, -1024.0)
    for k in ("st_stored", "lung_stored", "raw_hu"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("flags", [[], ["--soft_squeeze"]],
                         ids=["linear", "soft_squeeze"])
def test_generate_cli_serves_trained_snapshots(tmp_path, flags):
    """The generate CLI on .pth snapshots written by the port's training
    checkpoint code (3-channel SOFT_TISSUE, 2-channel LUNG): masks are
    prefetched per patient, and every slice equals a direct run_patient."""
    from ducosy_tpu_torch.train.checkpoint import save_generator_pth

    write_dataset(str(tmp_path / "input"), n_patients=2, n_slices=3,
                  size=MSIZE)
    sds = _mask_pair()
    paths = []
    for name, sd in zip(("st", "lung"), sds):
        gen = Generator.from_state_dict(sd, trunk="plain")
        paths.append(str(tmp_path / f"G_{name}_A2B.pth"))
        save_generator_pth(paths[-1], gen)
    done = tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "SynthSet", "--img_size", str(MSIZE),
        "--slice_batch", "2", "--soft_tissue_model", paths[0],
        "--lung_model", paths[1], "--compute_dtype", "float32",
        "--device", "cpu", *flags])
    assert done == 2
    eng = _engine(*sds, img_size=MSIZE, soft_squeeze=bool(flags))
    for pid in ("patient00", "patient01"):
        src = tmp_path / "input" / "SynthSet" / pid / "POST VUE"
        vol = np.stack([dcmread(str(f)).pixel_array
                        for f in sorted(src.glob("*.dcm"))])
        want = eng.run_patient(vol, 1.0, -1024.0, chunk=2).astype(vol.dtype)
        out = tmp_path / "output" / "SynthSet" / pid
        for i, f in enumerate(sorted(out.glob("*.dcm"))):
            np.testing.assert_array_equal(dcmread(str(f)).pixel_array,
                                          want[i])
