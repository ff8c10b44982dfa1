"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its own copies of the host modules (config, dicom, masks, data, utils)
agree with the originals.

(a) an ``ast`` walk over every ``.py`` of ``ducosy_tpu_torch/`` and over
    ``chip_smoke.py``;
(b) a fresh interpreter in which importing ``jax`` or ``ducosy_tpu`` raises
    imports every module of the port and builds and runs a CPU engine;
(c) the copies against their originals on the same inputs: config constants
    field by field, DICOM files byte for byte through both codecs, mask
    arrays, patient pairing and loader batches, the evaluation suite's host
    metrics (same source, same values), the NIfTI codec, the heart cleanup
    and the TotalSegmentator fleet (same source); and the two things the
    port's copies do differently (the native parser's build at first use,
    ``set_pixel_array`` resetting a compressed source's transfer syntax).
"""
import ast
import dataclasses
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import ducosy_tpu.config as jconfig
import ducosy_tpu.data.loader as jloader
import ducosy_tpu.data.pairing as jpairing
import ducosy_tpu.dicom.codec as jcodec
import ducosy_tpu.eval.metrics as jmetrics
import ducosy_tpu.masks as jmasks
import ducosy_tpu_torch
import ducosy_tpu_torch.config as tconfig
import ducosy_tpu_torch.data.loader as tloader
import ducosy_tpu_torch.data.pairing as tpairing
import ducosy_tpu_torch.dicom.codec as tcodec
import ducosy_tpu_torch.dicom.compressed as tcompressed
import ducosy_tpu_torch.dicom.native as tnative
import ducosy_tpu_torch.eval.metrics as tmetrics
import ducosy_tpu_torch.masks as tmasks
from ducosy_tpu.data.dataset import SlicePairDataset as JaxDataset
from ducosy_tpu_torch.data.dataset import SlicePairDataset

sys.path.insert(0, os.path.dirname(__file__))
from synth import chest_hu, write_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "ducosy_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ducosy_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_source_imports_jax_or_the_jax_package():
    """No ``import``/``from`` statement anywhere in the port (function
    bodies included) names jax, flax, optax or ducosy_tpu."""
    sources = _port_sources()
    assert len(sources) > 40
    bad = []
    for path in sources:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(os.path.relpath(path, ROOT), node.lineno, n)
                    for n in names if n.split(".")[0] in BANNED]
    assert not bad, bad


def test_port_runs_with_jax_and_the_jax_package_blocked():
    """A fresh interpreter whose ``sys.meta_path`` refuses jax, flax, optax
    and ducosy_tpu imports every module of the port, builds a CPU engine
    with a mask-conditioned checkpoint and runs a patient through it, the
    same on the packed forward (every trunk kind, the quant modes, a
    checkpoint without CBAM) and on a (2, 2) (data, sp) mesh, then builds an
    exclusion mask and predicts with the aux model."""
    names = [m.name for m in pkgutil.walk_packages(
        ducosy_tpu_torch.__path__, "ducosy_tpu_torch.")]
    for mod in ("config", "dicom.codec", "dicom.native", "masks.anatomy",
                "data.loader", "data.pairing", "utils.logging",
                "ops.kernels.conv_in", "ops.kernels.proto_conv_in",
                "eval.metrics", "eval.lpips", "eval.report", "cli.calculate",
                "infer.synthesis", "train.torch_resume", "parallel.mesh",
                "parallel.launch", "dicom.nifti", "masks.heart",
                "masks.totalseg", "models.unet3d", "models.nmodel_data",
                "train.nmodel_loop", "cli.masking", "cli.anonymize",
                "models.fused", "parallel.spatial", "models.banded"):
        assert f"ducosy_tpu_torch.{mod}" in names, mod
    code = f"""
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ImportError("blocked in this test: " + name)

sys.meta_path.insert(0, Refuse())
for n in {names!r}:
    importlib.import_module(n)
import chip_smoke
import numpy as np, torch
from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
from ducosy_tpu_torch.models.convert import init_generator_state_dict
eng = DualGeneratorEngine(init_generator_state_dict(0, 3, 8, 1),
                          init_generator_state_dict(1, 1, 8, 1),
                          device="cpu", compute_dtype=torch.float32,
                          img_size=32, trunk="mega")
vol = np.full((3, 48, 48), 1000, np.int16)
out = eng.run_patient(vol, 1.0, -1024.0, chunk=2)
assert out.shape == vol.shape and out.dtype == np.int16
for trunk, quant, cbam in (("xla", "trunk", True), ("pallas", None, True),
                           ("mega", "trunk", True), ("mono", "full", True),
                           ("chain2", None, True), ("auto", "full", False)):
    sds = [init_generator_state_dict(s, 1, 8, 2, use_cbam=cbam)
           for s in (0, 1)]
    eng = DualGeneratorEngine(*sds, device="cpu", img_size=32,
                              compute_dtype=torch.float32, forward="packed",
                              trunk=trunk, quant=quant)
    out = eng.run_patient(vol, 1.0, -1024.0, chunk=2)
    assert out.shape == vol.shape and out.dtype == np.int16
from ducosy_tpu_torch.parallel.mesh import data_sp_mesh
for forward in ("auto", "module"):
    eng = DualGeneratorEngine(*sds, img_size=32, compute_dtype=torch.float32,
                              mesh=data_sp_mesh(2, 2, ["cpu"] * 4),
                              forward=forward)
    out = eng.run_patient(vol, 1.0, -1024.0, chunk=2)
    assert out.shape == vol.shape and out.dtype == np.int16
from ducosy_tpu_torch.masks.totalseg import build_exclusion_mask
from ducosy_tpu_torch.models.unet3d import UNet3DLight, predict_volume
labels = np.zeros((2, 16, 16), np.uint8)
labels[:, 4:8, 4:8] = 51
assert build_exclusion_mask(labels).sum() > 32
diff = predict_volume(UNet3DLight(base_channels=4), vol[:, :16, :16],
                      slice_batch=2, device="cpu")
assert diff.shape == (3, 16, 16)
assert not [m for m in sys.modules if m.split(".")[0] in {BANNED!r}]
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=300)


def test_spawned_ranks_run_with_jax_and_the_jax_package_blocked(tmp_path):
    """Two gloo ranks spawned by ``parallel.launch`` take a data-parallel
    train step in interpreters whose ``sitecustomize`` refuses jax, flax,
    optax and ducosy_tpu from their first import on (the parent's too)."""
    (tmp_path / "sitecustomize.py").write_text(f"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ImportError("blocked in this test: " + name)

sys.meta_path.insert(0, Refuse())
""")
    code = f"""
import sys
import numpy as np
from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, TrainConfig, replace
from ducosy_tpu_torch.parallel.launch import spawn
from ducosy_tpu_torch.train.loop import run_steps
from ducosy_tpu_torch.train.state import init_state_dicts

if __name__ == "__main__":
    model = ModelConfig(num_residual_blocks=1, base_channels=8,
                        disc_base_channels=8)
    cfg = replace(TrainConfig(), img_size=16, batch_size=2,
                  compute_dtype="float32")
    rng = np.random.default_rng(0)
    batch = {{"a": rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32),
              "b": rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32),
              "masks": np.zeros((2, 16, 16, 2), np.float32)}}
    ranks = spawn(run_steps, (init_state_dicts(0, SOFT_TISSUE, model),
                              [batch], cfg, SOFT_TISSUE, model),
                  ["cpu", "cpu"], timeout=200)
    assert ranks[0]["spread"] == [0.0]
    assert np.isfinite(ranks[1]["metrics"][0]["loss_G"])
    assert not [m for m in sys.modules if m.split(".")[0] in {BANNED!r}]
"""
    (tmp_path / "drive.py").write_text(code)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    subprocess.run([sys.executable, str(tmp_path / "drive.py")], check=True,
                   cwd=ROOT, env=env, timeout=300)


# ------------------------------------------------------------ (c) config
@pytest.mark.parametrize("name", ["SOFT_TISSUE", "LUNG", "ModelConfig",
                                  "TrainConfig", "InferConfig", "LossConfig"])
def test_config_matches_original(name):
    """Every field of the presets and of the default configs, by value."""
    a, b = getattr(jconfig, name), getattr(tconfig, name)
    if isinstance(a, type):
        a, b = a(), b()
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert list(da) == list(db)
    for key in da:
        assert da[key] == db[key], key
    assert set(jconfig.RANGES) == set(tconfig.RANGES)
    assert a.input_channels == b.input_channels if name in ("SOFT_TISSUE",
                                                            "LUNG") else True


# ------------------------------------------------------------- (c) DICOM
def _slice(seed=0, size=64):
    return (chest_hu(size, size, z=seed) + 1024.0).astype(np.uint16)


@pytest.mark.parametrize("syntax", [None, "JPEG_LOSSLESS_SV1",
                                    "RLE_LOSSLESS"],
                         ids=["uncompressed", "jpeg-lossless", "rle"])
def test_dicom_round_trip_is_byte_equal(tmp_path, syntax):
    """One source file (written by the original codec, uncompressed or
    encapsulated) read by both codecs: equal tags and pixels; written back
    by both (decompressing, and passing the codestream through under its
    own syntax): equal bytes."""
    ds = jcodec.new_ct_dataset(64, 64, instance_number=3,
                               series_description="POST VUE")
    ds.set_pixel_array(_slice())
    src = str(tmp_path / "src.dcm")
    jcodec.dcmwrite(src, ds, transfer_syntax=syntax and getattr(jcodec,
                                                                syntax))
    a, b = jcodec.dcmread(src), tcodec.dcmread(src)
    assert a.transfer_syntax_uid == b.transfer_syntax_uid
    np.testing.assert_array_equal(a.pixel_array, b.pixel_array)
    np.testing.assert_array_equal(b.pixel_array, _slice())
    for key in ("Rows", "Columns", "RescaleSlope", "RescaleIntercept",
                "InstanceNumber", "SeriesDescription", "BitsAllocated"):
        assert a.get(key) == b.get(key), key
    targets = [None] + ([getattr(tcodec, syntax)] if syntax else [])
    for i, out_syntax in enumerate(targets):
        pa, pb = str(tmp_path / f"a{i}.dcm"), str(tmp_path / f"b{i}.dcm")
        jcodec.dcmwrite(pa, jcodec.dcmread(src), transfer_syntax=out_syntax)
        tcodec.dcmwrite(pb, tcodec.dcmread(src), transfer_syntax=out_syntax)
        assert open(pa, "rb").read() == open(pb, "rb").read(), out_syntax
    # a file written by the port's codec from scratch reads in the original
    ds2 = tcodec.new_ct_dataset(64, 64, instance_number=4)
    ds2.set_pixel_array(_slice(1))
    mine = str(tmp_path / "mine.dcm")
    tcodec.dcmwrite(mine, ds2, transfer_syntax=syntax and getattr(tcodec,
                                                                  syntax))
    np.testing.assert_array_equal(jcodec.dcmread(mine).pixel_array, _slice(1))


@pytest.mark.parametrize("syntax", ["RLE_LOSSLESS", "JPEG_LOSSLESS_SV1"])
def test_set_pixel_array_resets_compressed_syntax(tmp_path, syntax):
    """The port's ``set_pixel_array`` on a dataset read from a compressed
    file resets the transfer syntax to Explicit VR LE, so the swapped
    pixels are written framed as what they are and read back (the original
    keeps the encapsulated syntax and writes them unframed under it)."""
    ds = tcodec.new_ct_dataset(64, 64, instance_number=1)
    ds.set_pixel_array(_slice())
    src = str(tmp_path / "src.dcm")
    tcodec.dcmwrite(src, ds, transfer_syntax=getattr(tcodec, syntax))
    got = tcodec.dcmread(src)
    assert got.transfer_syntax_uid == getattr(tcodec, syntax)
    got.set_pixel_array(_slice(2))
    assert got.transfer_syntax_uid == tcodec.EXPLICIT_VR_LE
    out = str(tmp_path / "out.dcm")
    got.save_as(out)
    for codec in (tcodec, jcodec):
        back = codec.dcmread(out)
        assert back.transfer_syntax_uid == tcodec.EXPLICIT_VR_LE
        np.testing.assert_array_equal(back.pixel_array, _slice(2))
    kept = jcodec.dcmread(src)
    kept.set_pixel_array(_slice(2))
    assert kept.transfer_syntax_uid == getattr(jcodec, syntax)


# ------------------------------------------------- (c) the native parser
@pytest.fixture()
def native_state():
    """Restore the native module's load state after a test that changes it."""
    saved = (tnative._lib, tnative._tried)
    yield
    tnative._lib, tnative._tried = saved


def _write_slices(tmp_path):
    paths = []
    for name, syntax in (("plain", None), ("jpeg", tcodec.JPEG_LOSSLESS_SV1)):
        ds = tcodec.new_ct_dataset(64, 64, instance_number=7)
        ds.set_pixel_array(_slice(3))
        paths.append(str(tmp_path / f"{name}.dcm"))
        tcodec.dcmwrite(paths[-1], ds, transfer_syntax=syntax)
    return paths


def _slice_info(path):
    info = tnative.read_slice_any(path)
    return (np.array(info.pixels), info.rows, info.cols, info.rescale_slope,
            info.rescale_intercept, info.instance_number)


def test_native_parser_pure_python_path(tmp_path, native_state, monkeypatch):
    """Without a compiler (or the source) nothing is built and every caller
    runs the pure-Python codec."""
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cc")
    tnative._lib, tnative._tried = None, False
    assert tnative.build() is None and not tnative.available()
    assert tnative.jpeg_sv1_decode_native(b"") is None
    with pytest.raises(RuntimeError, match="not available"):
        tnative.read_slice(str(tmp_path / "x.dcm"))
    for path in _write_slices(tmp_path):
        px, rows, cols, slope, inter, inst = _slice_info(path)
        np.testing.assert_array_equal(px, _slice(3))
        assert (rows, cols, slope, inter, inst) == (64, 64, 1.0, -1024.0, 7)


def test_native_parser_builds_at_first_use(tmp_path, native_state,
                                           monkeypatch):
    """With the host compiler the library is built from
    native/dicom_codec.cc into the port's build directory (here a
    temporary one) at the first call, and gives the arrays of the
    pure-Python path, compressed slices included."""
    import shutil

    if not any(shutil.which(c) for c in ("c++", "g++")):
        pytest.skip("no host C++ compiler")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    tnative._lib, tnative._tried = None, False
    assert tnative.available()
    built = list((tmp_path / "_build").glob("libdicom_native-*.so"))
    assert len(built) == 1 and tnative.build() == built[0]
    paths = _write_slices(tmp_path)
    native = [_slice_info(p) for p in paths]
    assert tnative.read_slice(paths[0]).instance_number == 7
    frag = tcompressed.jpeg_sv1_encode(_slice(3))
    arr, precision = tnative.jpeg_sv1_decode_native(frag)
    np.testing.assert_array_equal(arr, _slice(3))
    tnative._lib, tnative._tried = None, True      # the pure-Python path
    assert not tnative.available()
    for got, path in zip(native, paths):
        want = _slice_info(path)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


# ------------------------------------------------------------- (c) masks
def test_masks_match_original():
    hu = np.stack([chest_hu(128, 128, z=i) for i in range(3)])
    types = ("lung", "lung_vessel", "mediastinum", "bone")
    a = jmasks.generate_anatomical_masks(hu, types)
    b = tmasks.generate_anatomical_masks(hu, types)
    assert set(a) == set(b) == set(types)
    for k in types:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["lung"].any() and b["bone"].any()


# -------------------------------------------------- (c) pairing and loader
def test_pairing_and_loader_batches_match_original(tmp_path):
    """The same patient tree through both packages: patient lists, the
    seeded split, slice pairs, and every batch of a shuffled, wrap-padded
    epoch of the loader over the LUNG dataset at the slices' own size (no
    resize, where the two datasets differ by design)."""
    root = str(tmp_path / "data")
    write_dataset(root, n_patients=3, n_slices=3, size=96)
    dirs = tpairing.list_patient_dirs(root, "SynthSet")
    assert dirs == jpairing.list_patient_dirs(root, "SynthSet") and dirs
    assert tpairing.train_val_split(dirs, 0.34, 42) == \
        jpairing.train_val_split(dirs, 0.34, 42)
    for d in dirs:
        assert tpairing.pair_patient_slices(d, "POST VUE", "POST STD") == \
            jpairing.pair_patient_slices(d, "POST VUE", "POST STD")
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=2)
    mine = tloader.HostLoader(
        SlicePairDataset(dirs, tconfig.LUNG, img_size=96), **kw)
    theirs = jloader.HostLoader(
        JaxDataset(dirs, jconfig.LUNG, img_size=96), **kw)
    assert len(mine) == len(theirs) == 3
    assert mine.final_n_real == theirs.final_n_real == 1
    for got, want in zip(mine, theirs):
        assert set(got) == set(want) and {"a", "b", "masks"} <= set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- (c) eval host metrics
@pytest.mark.parametrize("name", sorted(jmetrics.BASIC_METRICS))
def test_eval_host_metric_matches_original(name):
    """The numpy/scipy metrics are copies: the same source text and equal
    (value, per-slice) results, on volumes with a constant slice and an
    identical slice (the zero-range, zero-MSE and zero-norm branches)."""
    a, b = jmetrics.BASIC_METRICS[name], tmetrics.BASIC_METRICS[name]
    assert inspect.getsource(a) == inspect.getsource(b)
    rng = np.random.default_rng(3)
    v1 = rng.uniform(-1000, 1500, (4, 40, 36)).astype(np.float32)
    v2 = (v1 + rng.normal(0, 30, v1.shape)).astype(np.float32)
    v1[1] = v2[1] = 0.0
    v2[2] = v1[2]
    assert b(v1, v2) == a(v1, v2)


# ------------------------------------- (c) NIfTI, heart cleanup, the fleet
_SAME_SOURCE = [
    ("dicom.nifti", n) for n in ("read_nifti", "write_nifti", "dicom_affine",
                                 "_open")] + [
    ("masks.heart", n) for n in ("_z_gap_cut", "modify_heart_mask_volume",
                                 "modify_heart_mask_file")] + [
    ("masks.totalseg", n) for n in (
        "kill_process_tree", "_register_pid", "_unregister_pid",
        "cleanup_workers", "register_signal_handlers", "dicom_to_nifti",
        "run_totalsegmentator", "segment_patient")]


@pytest.mark.parametrize("module,name", _SAME_SOURCE,
                         ids=[f"{m}.{n}" for m, n in _SAME_SOURCE])
def test_host_copy_has_the_original_source(module, name):
    """The port's copy of each host function is the original's text, with
    the package's name the only change (its imports)."""
    import importlib

    a = getattr(importlib.import_module(f"ducosy_tpu.{module}"), name)
    b = getattr(importlib.import_module(f"ducosy_tpu_torch.{module}"), name)
    assert inspect.getsource(b).replace("ducosy_tpu_torch", "ducosy_tpu") \
        == inspect.getsource(a)


def test_host_copy_constants_match_original():
    import ducosy_tpu.dicom.nifti as jn
    import ducosy_tpu.masks.heart as jh
    import ducosy_tpu.masks.totalseg as jt
    import ducosy_tpu_torch.dicom.nifti as tn
    import ducosy_tpu_torch.masks.heart as th
    import ducosy_tpu_torch.masks.totalseg as tt

    for a, b, names in (
            (jn, tn, ("_HDR_SIZE", "_MAGIC", "_DTYPES", "_CODES")),
            (jh, th, ("HEART_LABEL", "GAP_THRESHOLD", "REGION_SIZE_THRESHOLD",
                      "OFFSET", "OFFSET_Y_BASE", "OFFSET_Z")),
            (jt, tt, ("MASK_TARGET_LABELS", "MASK_FILL_VALUE", "TIMEOUT_S"))):
        for n in names:
            assert getattr(a, n) == getattr(b, n), n
