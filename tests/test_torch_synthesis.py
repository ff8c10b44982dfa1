"""The port's synthesis, postprocess methods and the generate CLI's working
path against the JAX package, on the CPU (device="cpu").

Same seeded numpy inputs through both sides. Tolerances: compositing and
the additive composite equal (the same fp32 elementwise operations);
postprocess and synthesis volumes |d| <= 1 stored unit on >= 99.9% of
voxels (the convention of tests/test_torch_engine.py: fp32 summation
order can flip a truncation); the generate CLI at the engine tests' size
(32^2, 3 blocks, base 8), its working and final series held the same way
against the JAX synthesis functions on JaxEngine.generate_batch outputs of
the same weights.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.config import LUNG, SOFT_TISSUE
from ducosy_tpu.dicom import dcmread
from ducosy_tpu.infer import postprocess as jpost
from ducosy_tpu.infer import synthesis as jsyn
from ducosy_tpu.infer.engine import DualGeneratorEngine as JaxEngine
from ducosy_tpu.models.generator import Generator as JaxGenerator
from ducosy_tpu.models.torch_import import (generator_params_from_torch,
                                            generator_params_to_torch)
from ducosy_tpu_torch.cli import generate as tgen
from ducosy_tpu_torch.infer import postprocess as tpost
from ducosy_tpu_torch.infer import synthesis as tsyn
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import init_generator_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu, write_dataset  # noqa: E402

BASE, BLOCKS, SIZE = 8, 3, 32


def _within_one(got, ref, share=0.999):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(ref).astype(np.int64))
    return float(np.mean(d <= 1)) >= share


def _stored_volume(z=6, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    hu = np.stack([chest_hu(size, size, z=i) for i in range(z)])
    hu += rng.normal(0, 15, hu.shape).astype(np.float32)
    return np.clip(hu + 1024.0, 0, 4095).astype(np.int16)


def _model_outputs(raw, seed=1):
    """Seeded float32 'model' stored outputs around the raw values."""
    rng = np.random.default_rng(seed)
    st = raw.astype(np.float32) + rng.normal(20, 30, raw.shape)
    lung = raw.astype(np.float32) + rng.normal(-10, 40, raw.shape)
    return st.astype(np.float32), lung.astype(np.float32)


# ------------------------------------------------------------ compositing
@pytest.mark.parametrize("which", ["volume", "slice"])
def test_composite_matches_jax(which):
    """Overwrite compositing of an int16 raw volume with float outputs:
    equal to the JAX functions, float result (no truncating store)."""
    raw = _stored_volume()
    raw_hu = raw.astype(np.float32) - 1024.0
    st, lung = _model_outputs(raw)
    if which == "slice":
        raw, raw_hu, st, lung = raw[2], raw_hu[2], st[2], lung[2]
    ref = getattr(jsyn, f"composite_{which}")(raw, raw_hu, st, lung)
    got = getattr(tsyn, f"composite_{which}")(
        torch.from_numpy(raw), torch.from_numpy(raw_hu),
        torch.from_numpy(st), torch.from_numpy(lung))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_composite_lung_wins_shared_boundary():
    """At -150 HU (in both windows) the lung output wins; outside both the
    raw value stays."""
    assert SOFT_TISSUE.hu_min <= -150 <= SOFT_TISSUE.hu_max
    assert LUNG.hu_min <= -150 <= LUNG.hu_max
    raw_hu = np.array([[-150.0, 0.0, -800.0, 2000.0]], np.float32)
    raw = raw_hu + 1024.0
    st = np.full_like(raw, 1.0)
    lung = np.full_like(raw, 2.0)
    got = tsyn.composite_volume(raw, raw_hu, st, lung).numpy()
    np.testing.assert_array_equal(got, [[2.0, 1.0, 2.0, 3024.0]])
    np.testing.assert_array_equal(
        got, jsyn.composite_volume(raw, raw_hu, st, lung))


@pytest.mark.parametrize("slope", [1.0, 0.5])
def test_additive_composite_matches_jax(slope):
    """The v3 additive path: enhancement / slope added where it is above
    5 HU and the raw HU above -400; equal to the JAX function."""
    raw = _stored_volume(seed=3)
    raw_hu = raw.astype(np.float32) * slope - 1024.0
    st, lung = _model_outputs(raw, seed=4)
    st_hu, lung_hu = st * slope - 1024.0, lung * slope - 1024.0
    ref = jsyn.additive_composite(raw.astype(np.float32), raw_hu, st_hu,
                                  lung_hu, slope)
    got = tsyn.additive_composite(torch.from_numpy(raw.astype(np.float32)),
                                  torch.from_numpy(raw_hu),
                                  torch.from_numpy(st_hu),
                                  torch.from_numpy(lung_hu), slope)
    np.testing.assert_array_equal(got.numpy(), ref)
    changed = ref != raw
    assert changed.any() and not changed.all()
    assert np.all(raw_hu[changed] > -400)


def test_synthesize_volume_matches_jax():
    raw = _stored_volume(z=8, seed=5)
    st, lung = _model_outputs(raw, seed=6)
    raw_hu = raw.astype(np.float32) - 1024.0
    merged = jsyn.composite_volume(raw.astype(np.float32), raw_hu, st, lung)
    ref = jsyn.synthesize_volume(merged)
    got = tsyn.synthesize_volume(torch.from_numpy(merged))
    assert got.dtype == torch.int16 and got.shape == ref.shape
    assert _within_one(got.numpy(), ref)


# ------------------------------------------------------------ postprocess
@pytest.mark.parametrize("sharpen", [True, False], ids=["sharpen", "plain"])
@pytest.mark.parametrize("method", tpost.METHODS)
def test_postprocess_method_matches_jax(method, sharpen):
    """Each method with the JAX defaults, with and without unsharp masking,
    on a volume with voxels above the 750 restore threshold."""
    rng = np.random.default_rng(9)
    vol = rng.uniform(0, 1600, (7, 24, 20)).astype(np.float32)
    ref = jpost.postprocess_ct_volume(vol, method=method,
                                      enhance_sharpness=sharpen)
    got = tpost.postprocess_ct_volume(torch.from_numpy(vol), method=method,
                                      enhance_sharpness=sharpen)
    assert got.dtype == torch.int16 and got.shape == vol.shape
    got = got.numpy()
    assert _within_one(got, ref)
    keep = vol >= 750
    np.testing.assert_array_equal(got[keep], vol[keep].astype(np.int16))


@pytest.mark.parametrize("kw", [{"kernel_size": 4}, {"kernel_size": 5},
                                {"sigma": 2.5}],
                         ids=["median4", "median5", "gaussian2.5"])
def test_postprocess_keywords_match_jax(kw):
    """An even and a wider median window, and a gaussian wider than the
    z axis (scipy's repeated reflection)."""
    method = "median" if "kernel_size" in kw else "gaussian"
    rng = np.random.default_rng(10)
    vol = rng.uniform(-200, 900, (4, 16, 16)).astype(np.float32)
    ref = jpost.postprocess_ct_volume(vol, method=method, **kw)
    got = tpost.postprocess_ct_volume(vol, method=method, **kw).numpy()
    assert _within_one(got, ref)


def test_postprocess_refuses_unknown_method_and_keyword():
    with pytest.raises(ValueError, match="Unknown method"):
        tpost.postprocess_ct_volume(np.zeros((2, 4, 4)), method="box")
    with pytest.raises(TypeError, match="sigmaz"):
        tpost.postprocess_ct_volume(np.zeros((2, 4, 4)), sigmaz=1.0)


@pytest.mark.parametrize("threshold", [8.0, 30.0])
def test_apply_diffmap_matches_jax(threshold):
    """Deltas below the threshold dropped, the rest added through the
    uint8 cast, which wraps (300 -> 44) and truncates."""
    rng = np.random.default_rng(11)
    vol = rng.integers(0, 2000, (3, 8, 8)).astype(np.int16)
    diff = rng.uniform(-20, 320, vol.shape).astype(np.float32)
    ref = jpost.apply_diffmap(vol, diff, threshold)
    got = tpost.apply_diffmap(vol, diff, threshold)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    one = tpost.apply_diffmap(np.zeros(1, np.int16), np.array([300.7]))
    assert int(one[0]) == 44


# ------------------------------------------------------- generate_batch
def test_generate_batch_chunks_equal_one_call():
    sds = [init_generator_state_dict(s, 1, BASE, BLOCKS) for s in (2, 3)]
    eng = DualGeneratorEngine(*sds, img_size=SIZE, device="cpu",
                              compute_dtype=torch.float32)
    vol = _stored_volume(z=5)
    whole = eng.generate_batch(vol, 1.0, -1024.0)
    parts = eng.generate_batch(vol, 1.0, -1024.0, chunk=2)
    assert set(whole) == {"st_stored", "lung_stored", "raw_hu"}
    for k in whole:
        assert parts[k].shape == (5, SIZE, SIZE)
        np.testing.assert_allclose(parts[k], whole[k], rtol=1e-6, atol=1e-3)


# ---------------------------------------------------- the generate CLI
def _jax_params(seed, in_ch=1, blocks=BLOCKS):
    p = jax.jit(JaxGenerator(in_ch, blocks, BASE).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, in_ch)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _save_pth(path, sd):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    return path


def _read(folder):
    files = sorted(os.listdir(folder))
    return files, [dcmread(os.path.join(folder, f)) for f in files]


def _run_cli(tmp_path, paths, size, flags):
    return tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--working_dir_root", str(tmp_path / "working"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "SynthSet", "--img_size", str(size),
        "--slice_batch", "2", "--soft_tissue_model", paths[0],
        "--lung_model", paths[1], "--compute_dtype", "float32",
        "--device", "cpu", "--write_working", *flags])


def _check_series(tmp_path, jeng, mode):
    """Every patient's working series and final series against the JAX
    synthesis functions on JaxEngine.generate_batch outputs."""
    pdirs = sorted((tmp_path / "input" / "SynthSet").iterdir())
    for pdir in pdirs:
        src_files, src = _read(pdir / "POST VUE")
        vol = np.stack([d.pixel_array for d in src])
        out = jeng.generate_batch(vol, 1.0, -1024.0)
        wdir = tmp_path / "working" / "SynthSet" / pdir.name
        raw_files, raw = _read(wdir / "raw")
        assert raw_files == src_files
        for a, b in zip(src_files, raw_files):
            assert open(pdir / "POST VUE" / a, "rb").read() == \
                open(wdir / "raw" / b, "rb").read()
        for sub, key in (("soft_tissue", "st_stored"),
                         ("lung", "lung_stored")):
            files, dss = _read(wdir / sub)
            assert files == src_files
            got = np.stack([d.pixel_array for d in dss])
            assert got.dtype == vol.dtype
            assert _within_one(got, out[key].astype(vol.dtype)), sub
            for d in dss:
                assert d.SeriesDescription == "Synthetic CECT (from POST VUE)"
                px = d.pixel_array
                assert d.SmallestImagePixelValue == int(px.min())
                assert d.LargestImagePixelValue == int(px.max())
        raw32 = vol.astype(np.float32)
        if mode == "additive":
            merged = jsyn.additive_composite(
                raw32, out["raw_hu"], out["st_stored"] - 1024.0,
                out["lung_stored"] - 1024.0, 1.0)
            desc = "DuCoSyGAN sCECT v3"
        else:
            merged = jsyn.composite_volume(raw32, out["raw_hu"],
                                           out["st_stored"],
                                           out["lung_stored"])
            desc = "DuCoSyGAN sCECT v2"
        want = jsyn.synthesize_volume(merged).astype(vol.dtype)
        files, dss = _read(tmp_path / "output" / "SynthSet" / pdir.name)
        assert files == [f"{i:04d}.dcm" for i in range(len(vol))]
        assert all(d.SeriesDescription == desc for d in dss)
        assert _within_one(np.stack([d.pixel_array for d in dss]), want)


@pytest.mark.parametrize("mode", ["overwrite", "additive"])
def test_generate_cli_write_working_matches_jax(tmp_path, mode):
    """--write_working in both synthesis modes, two patients of 5 slices
    with --slice_batch 2 (a ragged last chunk)."""
    write_dataset(str(tmp_path / "input"), n_patients=2, n_slices=5,
                  size=SIZE)
    params = [_jax_params(0), _jax_params(1)]
    paths = [_save_pth(str(tmp_path / f"{n}.pth"),
                       generator_params_to_torch(p, BLOCKS))
             for n, p in zip(("st", "lung"), params)]
    assert _run_cli(tmp_path, paths, SIZE,
                    ["--synthesis_mode", mode]) == 2
    jeng = JaxEngine(*params, img_size=SIZE, compute_dtype=jnp.float32,
                     forward="module")
    _check_series(tmp_path, jeng, mode)


MSIZE = 96   # the mask detectors zero a 32-px border: 32^2 has no lungs


def test_generate_cli_write_working_soft_squeeze(tmp_path):
    """A mask-conditioned pair (3-channel SOFT_TISSUE, 2-channel LUNG)
    with --soft_squeeze on the working path: the masks are generated for
    each chunk's slices, the squeeze is applied, the series match the JAX
    engine's soft_squeeze outputs."""
    write_dataset(str(tmp_path / "input"), n_patients=1, n_slices=3,
                  size=MSIZE)
    rng = np.random.default_rng(21)
    sds = [init_generator_state_dict(11, 3, BASE, 2),
           init_generator_state_dict(12, 2, BASE, 2)]
    for sd in sds:
        for k in sd:
            if k.endswith(".bias"):
                sd[k] = rng.normal(0, 0.1, sd[k].shape).astype(np.float32)
    paths = [_save_pth(str(tmp_path / f"{n}.pth"), sd)
             for n, sd in zip(("st", "lung"), sds)]
    assert _run_cli(tmp_path, paths, MSIZE, ["--soft_squeeze"]) == 1
    jeng = JaxEngine(*(generator_params_from_torch(sd, 2) for sd in sds),
                     img_size=MSIZE, compute_dtype=jnp.float32,
                     forward="module", soft_squeeze=True)
    _check_series(tmp_path, jeng, "overwrite")
    linear = JaxEngine(*(generator_params_from_torch(sd, 2) for sd in sds),
                       img_size=MSIZE, compute_dtype=jnp.float32,
                       forward="module")
    src = tmp_path / "input" / "SynthSet" / "patient00" / "POST VUE"
    vol = np.stack([d.pixel_array for d in _read(src)[1]])
    _, dss = _read(tmp_path / "working" / "SynthSet" / "patient00"
                   / "soft_tissue")
    got = np.stack([d.pixel_array for d in dss])
    lin = linear.generate_batch(vol, 1.0, -1024.0)["st_stored"]
    assert not _within_one(got, lin.astype(vol.dtype))


def test_write_working_from_a_compressed_series(tmp_path):
    """An RLE-compressed source: raw/ keeps the source files as they are,
    and soft_tissue/, lung/ and the final series are written as readable
    Explicit VR LE (the JAX CLI keeps the encapsulated syntax there and
    writes the swapped pixels unframed under it)."""
    from ducosy_tpu_torch.dicom import codec as tcodec
    from ducosy_tpu_torch.dicom import dcmread as tread

    src = tmp_path / "input" / "DS" / "p0" / "POST VUE"
    src.mkdir(parents=True)
    for i, sl in enumerate(_stored_volume(z=2)):
        ds = tcodec.new_ct_dataset(SIZE, SIZE, instance_number=i + 1)
        ds.set_pixel_array(sl.astype(np.uint16))
        tcodec.dcmwrite(str(src / f"{i:04d}.dcm"), ds,
                        transfer_syntax=tcodec.RLE_LOSSLESS)
    path = _save_pth(str(tmp_path / "g.pth"),
                     init_generator_state_dict(4, 1, BASE, 1))
    assert tgen.main([
        "--input_dir_root", str(tmp_path / "input"),
        "--working_dir_root", str(tmp_path / "working"),
        "--output_dir_root", str(tmp_path / "output"),
        "--dataset_names", "DS", "--img_size", str(SIZE),
        "--soft_tissue_model", path, "--lung_model", path,
        "--compute_dtype", "float32", "--device", "cpu",
        "--write_working"]) == 1
    work = tmp_path / "working" / "DS" / "p0"
    for f in sorted((work / "raw").glob("*.dcm")):
        assert tread(str(f)).transfer_syntax_uid == tcodec.RLE_LOSSLESS
    for folder in (work / "soft_tissue", work / "lung",
                   tmp_path / "output" / "DS" / "p0"):
        files = sorted(folder.glob("*.dcm"))
        assert len(files) == 2
        for f in files:
            ds = tread(str(f))
            assert ds.transfer_syntax_uid == tcodec.EXPLICIT_VR_LE
            assert ds.pixel_array.shape == (SIZE, SIZE)
