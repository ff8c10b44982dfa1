"""The masking -> masked-evaluation workflow of the port against the JAX
package, on the CPU at small sizes: ``dicom/nifti.py``, ``masks/heart.py``,
``masks/totalseg.py``, the ``masking``, ``modify_heart_mask``,
``anonymize``, ``visualize`` and ``mask_preview`` CLIs, and ``calculate
--mask`` on the tree the port's masking CLI wrote.

Bounds, fixed before any run:
  - NIfTI, heart cleanup, ``apply_exclusion_mask`` on uncompressed
    sources, anonymize, visualize and mask_preview: equal (arrays, bytes,
    pixels, CSV text, printed statistics);
  - the exclusion mask (morphology here, cv2's contour drawing in the JAX
    package) on seeded smooth label volumes of 4 x 256^2: each label's
    filled interior exactly equal, at least 99.9% of pixels equal, every
    differing pixel within 2 px (chessboard) of the JAX mask's rim;
  - the masked tree of the masking CLIs: by the exclusion mask's rule on
    smooth labels, equal on labels where the two masks are equal (bands
    across the slice: a box's corners differ, see below);
  - the masked scores where the masks are equal: the host metrics equal,
    MS-SSIM and LPIPS within the evaluation suite's bounds (atol 1e-5,
    rtol 2e-4; tests/test_torch_eval.py).
"""
import csv
import gzip
import os
import pickle
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from scipy import ndimage

import ducosy_tpu.dicom.codec as jcodec
import ducosy_tpu.dicom.nifti as jnifti
import ducosy_tpu.masks.heart as jheart
import ducosy_tpu.masks.totalseg as jts
import ducosy_tpu_torch.dicom.codec as tcodec
import ducosy_tpu_torch.dicom.nifti as tnifti
import ducosy_tpu_torch.masks.heart as theart
import ducosy_tpu_torch.masks.totalseg as tts
from ducosy_tpu_torch.cli import anonymize as tanon
from ducosy_tpu_torch.cli import calculate as tcalc
from ducosy_tpu_torch.cli import mask_preview as tpreview
from ducosy_tpu_torch.cli import masking as tmasking
from ducosy_tpu_torch.cli import modify_heart_mask as theart_cli
from ducosy_tpu_torch.cli import visualize as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(ROOT, "cli"))
import anonymize as janon  # noqa: E402
import calculate as jcalc  # noqa: E402
import mask_preview as jpreview  # noqa: E402
import masking as jmasking  # noqa: E402
import modify_heart_mask as jheart_cli  # noqa: E402
import visualize as jvis  # noqa: E402
from lpips_golden import golden_state_dict  # noqa: E402
from synth import write_patient  # noqa: E402


# ------------------------------------------------------------------- NIfTI
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_nifti_each_package_reads_the_others(tmp_path, dtype, ext):
    """A file written by either package reads in the other with equal
    arrays and affines; both write the same bytes (decompressed: the gzip
    header carries an mtime)."""
    rng = np.random.default_rng(0)
    vol = (rng.uniform(-1000, 2000, (7, 9, 5)) if dtype != np.uint8 else
           rng.integers(0, 120, (7, 9, 5))).astype(dtype)
    aff = tnifti.dicom_affine([0.7, 0.8], 2.5, [-200.0, -180.5, 40.25])
    np.testing.assert_array_equal(
        aff, jnifti.dicom_affine([0.7, 0.8], 2.5, [-200.0, -180.5, 40.25]))
    paths = {}
    for name, pkg in (("j", jnifti), ("t", tnifti)):
        paths[name] = str(tmp_path / f"{name}{ext}")
        pkg.write_nifti(paths[name], vol, aff)
    for writer, reader in (("j", tnifti), ("t", jnifti)):
        data, affine = reader.read_nifti(paths[writer])
        assert data.dtype == vol.dtype
        np.testing.assert_array_equal(data, vol)
        np.testing.assert_allclose(affine, aff, rtol=1e-6)
        np.testing.assert_array_equal(
            affine, (jnifti if reader is tnifti else tnifti).read_nifti(
                paths[writer])[1])
    opener = gzip.open if ext.endswith(".gz") else open
    with opener(paths["j"], "rb") as a, opener(paths["t"], "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ heart cleanup
def _heart_volume(seed):
    """(x, y, z) labels: a heart blob with a lumpy surface, a tail beyond a
    z gap, a small satellite, and another label."""
    rng = np.random.default_rng(seed)
    xx, yy, zz = np.mgrid[:64, :64, :24]
    cx, cy = rng.uniform(26, 38, 2)
    r = ((xx - cx) ** 2 + (yy - cy) ** 2 + ((zz - 8) * 1.5) ** 2) ** 0.5
    lumps = ndimage.gaussian_filter(rng.normal(0, 1, r.shape), 2) * 10
    vol = np.zeros(r.shape, np.uint8)
    vol[r + lumps < 14] = 51
    vol[int(cx) - 2:int(cx) + 3, int(cy) - 2:int(cy) + 3, 20:24] = 51
    vol[56:58, 56:58, 1:3] = 51
    vol[0:5, 0:6, 0:4] = 7
    return vol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heart_cleanup_matches_jax(seed):
    vol = _heart_volume(seed)
    got = theart.modify_heart_mask_volume(vol)
    np.testing.assert_array_equal(got, jheart.modify_heart_mask_volume(vol))
    assert 0 < (got == 51).sum() < (vol == 51).sum()
    assert not (got[..., 20:] == 51).any()             # the tail is cut
    assert not (got[56:58, 56:58] == 51).any()         # the satellite
    assert ((got == 7) == (vol == 7)).all()
    heart = (vol == 51).astype(np.uint8)
    np.testing.assert_array_equal(theart._z_gap_cut(heart, 3),
                                  jheart._z_gap_cut(heart, 3))


def _smoke_heart_case():
    """tests/test_cli_smoke.py::test_modify_heart_mask_cli's volume."""
    vol = np.zeros((6, 16, 16), np.uint8)
    vol[0:2, 4:8, 4:8] = 51
    vol[4:6, 4:8, 4:8] = 51
    vol[3, 10:12, 10:12] = 30
    return vol


def test_modify_heart_mask_cli_matches_jax(tmp_path):
    """Both CLIs (one spawn worker) on the smoke test's case and a seeded
    volume: equal NIfTI arrays and affines under modified_mask/."""
    outs = {}
    for name, cli in (("jax", jheart_cli), ("torch", theart_cli)):
        root = tmp_path / name
        (root / "mask" / "DS").mkdir(parents=True)
        tnifti.write_nifti(str(root / "mask" / "DS" / "p1.nii"),
                           _smoke_heart_case())
        tnifti.write_nifti(str(root / "mask" / "DS" / "p2.nii.gz"),
                           _heart_volume(3), np.diag([0.7, 0.7, 2.0, 1.0]))
        cli.main(["--output_dir_root", str(root), "--dataset_names", "DS",
                  "--num_workers", "1"])
        outs[name] = {p: tnifti.read_nifti(
            str(root / "modified_mask" / "DS" / p))
            for p in ("p1.nii", "p2.nii.gz")}
    for p, (data, aff) in outs["torch"].items():
        np.testing.assert_array_equal(data, outs["jax"][p][0])
        np.testing.assert_array_equal(aff, outs["jax"][p][1])
    cleaned = outs["torch"]["p1.nii"][0]
    assert (cleaned == 30).sum() == 4 and (cleaned == 51).sum() <= 64


# ---------------------------------------------------------- exclusion mask
def _organs(seed, z=4, size=256, n=8):
    """(z, y, x) labels: n smooth organs of target labels that drift with
    z and overlap, and a box of a label outside the target list."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((z, size, size), np.int32)
    yy, xx = np.mgrid[:size, :size] / size
    for lab in rng.choice(tts.MASK_TARGET_LABELS, n, replace=False):
        cy, cx = rng.uniform(0.2, 0.8, 2)
        ry, rx = rng.uniform(0.04, 0.15, 2)
        noise = ndimage.gaussian_filter(rng.normal(0, 1, (z, size, size)),
                                        (0, 12, 12))
        noise /= np.abs(noise).max()
        for k in range(z):
            r = ((yy - cy - 0.01 * k) / ry) ** 2 + ((xx - cx) / rx) ** 2
            vol[k][r + 0.6 * noise[k] < 1] = lab
    vol[:, 10:30, 10:30] = 99
    return vol


def _within_two_of_rim(got, want):
    """Every pixel where ``got`` and ``want`` differ lies within 2 px
    (chessboard) of ``want``'s 8-connected inner boundary in its slice."""
    w = want.astype(bool)
    rim = w & ~ndimage.binary_erosion(w, np.ones((1, 3, 3)), border_value=0)
    near = ndimage.binary_dilation(rim, np.ones((1, 5, 5)))
    return not ((got != want) & ~near).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exclusion_mask_against_jax(seed):
    cv2 = pytest.importorskip("cv2")
    vol = _organs(seed)
    for label in np.intersect1d(np.unique(vol), tts.MASK_TARGET_LABELS):
        lm = (vol == label).astype(np.uint8)
        want = np.zeros_like(lm)
        for k in range(len(lm)):
            contours, _ = cv2.findContours(lm[k], cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            cv2.drawContours(want[k], contours, -1, 1, thickness=-1)
        np.testing.assert_array_equal(tts._filled(lm.astype(bool)), want)
    got, want = tts.build_exclusion_mask(vol), jts.build_exclusion_mask(vol)
    assert got.dtype == want.dtype == np.uint8 and got.shape == vol.shape
    assert (got == want).mean() >= 0.999
    assert _within_two_of_rim(got, want)
    assert not got[:, 12:28, 12:28].any()       # label 99 is not a target


def test_exclusion_mask_of_bands_equals_jax():
    """Labels that span the slice's width give cv2's mask exactly; a box's
    convex corners do not (cv2 draws thick contours with round joins)."""
    vol = np.zeros((3, 64, 64), np.int32)
    vol[:, 20:30] = 51
    vol[1:, 40:44] = 52
    vol[0, 50:54] = 7
    np.testing.assert_array_equal(tts.build_exclusion_mask(vol),
                                  jts.build_exclusion_mask(vol))
    assert not tts.build_exclusion_mask(np.zeros((2, 8, 8), np.int32)).any()


# ----------------------------------------------------- applying the mask
def _mask_for(shape):
    vol = np.zeros(shape, np.int32)
    vol[:, 10:18, 10:18] = 51
    vol[:, 24:28, 24:28] = 99
    return tts.build_exclusion_mask(vol)


def test_apply_exclusion_mask_matches_jax(tmp_path):
    write_patient(str(tmp_path / "p"), n_slices=3, size=32)
    files = sorted(str(f) for f in (tmp_path / "p" / "POST VUE").glob("*"))
    mask = _mask_for((3, 32, 32))
    jts.apply_exclusion_mask(files, mask, str(tmp_path / "jax"))
    tts.apply_exclusion_mask(files, mask, str(tmp_path / "torch"))
    for i, f in enumerate(files):
        name = os.path.basename(f)
        a = jcodec.dcmread(str(tmp_path / "jax" / name))
        b = tcodec.dcmread(str(tmp_path / "torch" / name))
        assert b.pixel_array.dtype == np.int16
        np.testing.assert_array_equal(a.pixel_array, b.pixel_array)
        np.testing.assert_array_equal(
            jcodec.dcmread(str(tmp_path / "torch" / name)).pixel_array,
            b.pixel_array)
        for key in ("BitsAllocated", "BitsStored", "HighBit",
                    "PixelRepresentation", "PhotometricInterpretation",
                    "RescaleIntercept", "InstanceNumber"):
            assert a.get(key) == b.get(key), key
        assert (b.pixel_array[mask[i] != 0] == tts.MASK_FILL_VALUE).all()


def test_apply_exclusion_mask_on_a_compressed_series(tmp_path):
    """An RLE-compressed source (written as test_torch_synthesis's
    compressed series is): the port writes readable Explicit VR LE with the
    9999 fill; the JAX function swaps the pixels under the encapsulated
    syntax and its save raises."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    stored = rng.integers(0, 2000, (2, 32, 32)).astype(np.uint16)
    for i, sl in enumerate(stored):
        ds = tcodec.new_ct_dataset(32, 32, instance_number=i + 1)
        ds.set_pixel_array(sl)
        tcodec.dcmwrite(str(src / f"{i:04d}.dcm"), ds,
                        transfer_syntax=tcodec.RLE_LOSSLESS)
    files = sorted(str(f) for f in src.glob("*.dcm"))
    assert tcodec.dcmread(files[0]).transfer_syntax_uid == \
        tcodec.RLE_LOSSLESS
    mask = _mask_for((2, 32, 32))
    tts.apply_exclusion_mask(files, mask, str(tmp_path / "torch"))
    for i, f in enumerate(files):
        want = stored[i].astype(np.int16)
        want[mask[i] != 0] = tts.MASK_FILL_VALUE
        for codec in (tcodec, jcodec):
            ds = codec.dcmread(str(tmp_path / "torch" / os.path.basename(f)))
            assert ds.transfer_syntax_uid == tcodec.EXPLICIT_VR_LE
            np.testing.assert_array_equal(ds.pixel_array, want)
    with pytest.raises(ValueError, match="encapsulated"):
        jts.apply_exclusion_mask(files, mask, str(tmp_path / "jax"))


# ------------------------------------------------------------- the fleet
STAND_IN = """#!{python}
# TotalSegmentator stand-in: -i <nifti> -o <out> --device D --ml writes
# <out>.nii, labels from the input HU; its arguments go to <out>.args
import sys
sys.path.insert(0, {root!r})
import numpy as np
from ducosy_tpu_torch.dicom.nifti import read_nifti, write_nifti
args = sys.argv[1:]
src, out = args[args.index("-i") + 1], args[args.index("-o") + 1]
hu, affine = read_nifti(src)
labels = np.zeros(hu.shape, np.uint8)
labels[hu > 150] = 51
labels[hu > 400] = 52
labels[(hu < -500) & (hu > -900)] = 10
write_nifti(out + ".nii", labels, affine)
open(out + ".args", "w").write(" ".join(args))
"""


def _stand_in(bin_dir):
    bin_dir.mkdir(parents=True, exist_ok=True)
    path = bin_dir / "TotalSegmentator"
    path.write_text(STAND_IN.format(python=sys.executable, root=ROOT))
    path.chmod(0o755)
    return str(bin_dir)


def _tree(root, n_patients=2, n_slices=2, size=64):
    """input/DS/<pid>/{POST VUE, POST STD} and the generated series
    output/DS/<pid>/*.dcm (STD plus a seeded offset)."""
    rng = np.random.default_rng(0)
    for k in range(n_patients):
        pid = f"p{k + 1}"
        write_patient(str(root / "input" / "DS" / pid), n_slices=n_slices,
                      size=size)
        out = root / "output" / "DS" / pid
        out.mkdir(parents=True)
        for f in sorted((root / "input" / "DS" / pid / "POST STD")
                        .glob("*.dcm")):
            d = tcodec.dcmread(str(f))
            noise = rng.integers(-30, 30, d.pixel_array.shape)
            px = np.clip(d.pixel_array.astype(np.int64) + 5 + noise, 0,
                         4095).astype(np.uint16)
            d.PixelData = px.tobytes()
            d.save_as(str(out / f.name))
    return str(root / "input"), str(root / "output")


def _masking_args(inp, out, stage):
    return ["--input_dir_root", inp, "--output_dir_root", out,
            "--dataset_names", "DS", "--batch_size", "1", "--stage", stage]


def test_generate_stage_without_the_binary(tmp_path, monkeypatch, capsys):
    """No TotalSegmentator on the PATH: each patient reports it and the
    stage returns, in both CLIs alike."""
    inp, out = _tree(tmp_path)
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    printed = {}
    for name, cli in (("jax", jmasking), ("torch", tmasking)):
        cli.main(_masking_args(inp, str(tmp_path / name), "generate"))
        printed[name] = sorted(capsys.readouterr().out.splitlines())
    assert printed["torch"] == printed["jax"]
    for pid in ("p1", "p2"):
        assert f"  {pid}: FAILED — TotalSegmentator command not found" in \
            printed["torch"]
    assert not list((tmp_path / "torch" / "mask" / "DS").iterdir())


def test_generate_stage_with_a_stand_in_binary(tmp_path, monkeypatch):
    """A stand-in binary first on the PATH: both CLIs convert each CECT
    series to the same NIfTI, call it with ``--device gpu --ml`` and leave
    the same label volumes; a second run skips the patients done."""
    inp, out = _tree(tmp_path)
    monkeypatch.setenv("PATH", _stand_in(tmp_path / "bin") + os.pathsep +
                       os.environ.get("PATH", ""))
    for name, cli in (("jax", jmasking), ("torch", tmasking)):
        cli.main(_masking_args(inp, str(tmp_path / name), "generate"))
    for pid in ("p1", "p2"):
        nii = [tmp_path / n / "working" / "DS" / pid / "input.nii.gz"
               for n in ("jax", "torch")]
        with gzip.open(nii[0], "rb") as a, gzip.open(nii[1], "rb") as b:
            assert a.read() == b.read()
        base = tmp_path / "torch" / "mask" / "DS" / pid
        assert (base.parent / f"{pid}.args").read_text().endswith(
            "--device gpu --ml")
        got, _ = tnifti.read_nifti(str(base) + ".nii")
        want, _ = tnifti.read_nifti(
            str(tmp_path / "jax" / "mask" / "DS" / f"{pid}.nii"))
        np.testing.assert_array_equal(got, want)
        assert (got == 51).any() and (got == 52).any()
    (tmp_path / "bin" / "TotalSegmentator").unlink()
    tmasking.main(_masking_args(inp, str(tmp_path / "torch"), "generate"))


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def test_fleet_interrupt_leaves_no_orphans(tmp_path):
    """SIGTERM on a worker that registered the port's signal handlers kills
    its registered external subprocess tree (masking.py:71-95)."""
    pidfile = tmp_path / "child.pid"
    script = textwrap.dedent(f"""
        import subprocess, sys, time
        sys.path.insert(0, {ROOT!r})
        from ducosy_tpu_torch.masks import totalseg
        totalseg.register_signal_handlers()
        child = subprocess.Popen(["sleep", "600"])
        totalseg._register_pid(child.pid)
        open({str(pidfile)!r}, "w").write(str(child.pid))
        time.sleep(600)
    """)
    worker = subprocess.Popen([sys.executable, "-c", script])
    try:
        for _ in range(100):
            if pidfile.exists() and pidfile.read_text().strip():
                break
            time.sleep(0.1)
        else:
            raise AssertionError("worker never spawned its subprocess")
        child_pid = int(pidfile.read_text())
        assert _alive(child_pid)
        worker.send_signal(signal.SIGTERM)
        worker.wait(timeout=10)
        deadline = time.time() + 5
        while time.time() < deadline and _alive(child_pid):
            time.sleep(0.1)
        assert not _alive(child_pid), "external subprocess leaked"
        assert worker.returncode == 128 + signal.SIGTERM
    finally:
        if worker.poll() is None:
            worker.kill()
        if pidfile.exists():
            try:
                os.kill(int(pidfile.read_text()), 9)
            except (OSError, ValueError):
                pass


# ------------------------------------------- masking, calculate, anonymize
SIZE = 176   # the smallest size MS-SSIM takes


def _bands(n_slices, size):
    """(z, y, x) labels whose exclusion masks the two packages draw alike:
    bands across the slice (heart, aorta) and a non-target band."""
    vol = np.zeros((n_slices, size, size), np.uint8)
    vol[:, size // 3:size // 2] = 51
    vol[1:, size // 2 + 10:size // 2 + 16] = 52
    vol[:, 10:14] = 7
    return vol


def _masked_tree(root, cli, labels_of):
    """The tree, labels written as <output>/modified_mask/DS/<pid>.nii, the
    masking stage of ``cli``; returns (input, output)."""
    inp, out = _tree(root, n_slices=2, size=SIZE if labels_of is _bands
                     else 256)
    mdir = root / "output" / "modified_mask" / "DS"
    mdir.mkdir(parents=True)
    for k, pid in enumerate(("p1", "p2")):
        labels = labels_of(2, SIZE) if labels_of is _bands else \
            _organs(k, z=2, size=256).astype(np.uint8)
        tnifti.write_nifti(str(mdir / f"{pid}.nii"),
                           np.transpose(labels, (2, 1, 0)))
    cli.main(_masking_args(inp, out, "masking"))
    return inp, out


def _series(folder):
    return np.stack([tcodec.dcmread(str(f)).pixel_array
                     for f in sorted(folder.glob("*.dcm"))])


@pytest.fixture(scope="module")
def masked_trees(tmp_path_factory):
    """The band-labelled tree through each package's masking CLI."""
    out = {}
    for name, cli in (("jax", jmasking), ("torch", tmasking)):
        root = tmp_path_factory.mktemp(f"masked_{name}")
        out[name] = (root, _masked_tree(root, cli, _bands))
    return out


@pytest.mark.parametrize("labels", ["bands", "organs"])
def test_masking_cli_matches_jax(tmp_path, masked_trees, labels):
    """The masked tree of both CLIs: three series a patient, int16, the
    9999 pixels where the exclusion mask is (equal to the JAX's on bands,
    by the exclusion mask's rule on smooth organs), the source elsewhere."""
    if labels == "bands":
        trees = {n: root for n, (root, _) in masked_trees.items()}
    else:
        trees = {}
        for name, cli in (("jax", jmasking), ("torch", tmasking)):
            trees[name] = tmp_path / name
            _masked_tree(trees[name], cli, _organs)
    for pid in ("p1", "p2"):
        for sub in ("POST VUE", "POST STD", "generated"):
            got, want = (_series(trees[n] / "output" / "masked" / "DS" / pid
                                 / sub) for n in ("torch", "jax"))
            assert got.dtype == np.int16 and got.shape == want.shape
            src = trees["torch"] / ("output" if sub == "generated" else
                                    "input") / "DS" / pid
            src = _series(src if sub == "generated" else src / sub)
            fill = got == tts.MASK_FILL_VALUE
            np.testing.assert_array_equal(got[~fill], src[~fill])
            if labels == "bands":
                np.testing.assert_array_equal(got, want)
            else:
                jfill = want == tts.MASK_FILL_VALUE
                assert (fill == jfill).mean() >= 0.999
                assert _within_two_of_rim(fill, jfill)
            assert fill.any()


def test_masked_calculate_matches_jax(masked_trees, tmp_path, monkeypatch):
    """``calculate --mask`` of the port on the port-masked tree against the
    JAX CLI on the JAX-masked tree (equal masks): the same tasks and
    scores; and the masked scores differ from the unmasked ones."""
    from ducosy_tpu_torch.eval import lpips as tlpips

    flat = dict(golden_state_dict())
    for i in range(5):
        flat[f"lin{i}"] = flat.pop(f"lin{i}.model.1.weight").reshape(-1)
    np.savez(tmp_path / "alex.npz", **flat)
    monkeypatch.setenv(tlpips.ENV_WEIGHTS, str(tmp_path / "alex.npz"))
    results = {}
    for name, cli, extra in (("jax", jcalc, []),
                             ("torch", tcalc, ["--device", "cpu"])):
        _, (inp, out) = masked_trees[name]
        cli.main(["--input_dir_root", inp, "--output_dir_root", out,
                  "--dataset_names", "DS", "--num_workers", "1", "--fast",
                  "--mask"] + extra)
        with open(os.path.join(out, "calculated_mask", "results.pkl"),
                  "rb") as f:
            results[name] = pickle.load(f)
    got, want = results["torch"], results["jax"]
    assert set(got) == set(want) == {"DS/p1", "DS/p2"}
    for key in want:
        for m, vals in want[key].items():
            if m in ("ms_ssim", "lpips"):
                np.testing.assert_allclose(got[key][m], vals, rtol=2e-4,
                                           atol=1e-5)
                assert np.all(np.isfinite(got[key][m])), m
            else:
                assert got[key][m] == vals, m
    _, (inp, out) = masked_trees["torch"]
    plain = tcalc.main(["--input_dir_root", inp, "--output_dir_root", out,
                        "--dataset_names", "DS", "--num_workers", "1",
                        "--fast", "--device", "cpu"])
    assert plain["DS/p1"]["mae"] != got["DS/p1"]["mae"]


class _Uuids:
    """uuid.uuid4 stand-in: the same ids, in order, for each run."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        import uuid

        self.n += 1
        return uuid.UUID(f"{self.n * 0x1234567:08x}" + "0" * 24)


@pytest.mark.parametrize("mask", [False, True], ids=["plain", "mask"])
def test_anonymize_cli_matches_jax(masked_trees, tmp_path, monkeypatch,
                                   mask):
    """Both CLIs on copies of the same tree, uuid4 patched alike: the same
    mapping CSV and the same .npy volumes."""
    import uuid

    _, (inp, out) = masked_trees["torch"]
    runs = {}
    for name, cli in (("jax", janon), ("torch", tanon)):
        root = tmp_path / name
        shutil.copytree(out, root, ignore=shutil.ignore_patterns(
            "calculated*", "anonym*"))
        monkeypatch.setattr(uuid, "uuid4", _Uuids())
        cli.main(["--input_dir_root", inp, "--output_dir_root", str(root),
                  "--dataset_names", "DS"] + (["--mask"] if mask else []))
        with open(root / "anonymization_mapping.csv") as f:
            rows = list(csv.reader(f))
        vols = {p.name: np.load(p)
                for p in sorted((root / "anonymized").glob("*.npy"))}
        runs[name] = (rows, vols)
    (rows, vols), (jrows, jvols) = runs["torch"], runs["jax"]
    assert rows == jrows and len(rows) == 5
    assert [r[:3] for r in rows[1:]] == [
        [c, "DS", p] for c in ("original", "generated") for p in ("p1", "p2")]
    assert list(vols) == list(jvols) and len(vols) == 4
    for k in vols:
        assert vols[k].dtype == np.int16
        np.testing.assert_array_equal(vols[k], jvols[k])
    if mask:
        assert any((v > 8000).any() for v in vols.values())


def test_anonymize_dataset_matches_jax(tmp_path):
    ds = tcodec.new_ct_dataset(8, 8)
    ds.PatientName = "DOE^JANE"
    ds.InstitutionName = "Some Hospital"
    tcodec.dcmwrite(str(tmp_path / "x.dcm"), ds)
    jds = jcodec.dcmread(str(tmp_path / "x.dcm"))
    tanon.anonymize_dataset(ds, "abc12345")
    janon.anonymize_dataset(jds, "abc12345")
    assert tanon.PHI_OVERRIDES == janon.PHI_OVERRIDES
    for key in ["PatientID"] + [k for k, _ in tanon.PHI_OVERRIDES]:
        assert ds.get(key) == jds.get(key), key


# ------------------------------------------------- visualize, mask_preview
def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_visualize_cli_matches_jax(masked_trees, tmp_path, capsys):
    pytest.importorskip("PIL")
    _, (inp, out) = masked_trees["torch"]
    printed = {}
    for name, cli in (("jax", jvis), ("torch", tvis)):
        root = tmp_path / name
        shutil.copytree(os.path.join(out, "DS"), root / "DS")
        cli.main(["--input_dir_root", inp, "--output_dir_root", str(root),
                  "--dataset_names", "DS", "--num_workers", "1"])
        printed[name] = capsys.readouterr().out.replace(str(root), "ROOT")
    assert printed["torch"] == printed["jax"]
    pngs = sorted(p.relative_to(tmp_path / "torch")
                  for p in (tmp_path / "torch").rglob("*.png"))
    assert len(pngs) == 5             # 2 patients x 2 slices, the grid
    for rel in pngs:
        np.testing.assert_array_equal(_png(tmp_path / "torch" / rel),
                                      _png(tmp_path / "jax" / rel))


def test_mask_preview_cli_matches_jax(tmp_path, capsys):
    pytest.importorskip("PIL")
    write_patient(str(tmp_path / "p1"), n_slices=1, size=128)
    slice_path = str(sorted((tmp_path / "p1" / "POST VUE").glob("*.dcm"))[0])
    printed = {}
    for name, cli in (("jax", jpreview), ("torch", tpreview)):
        png = str(tmp_path / f"{name}.png")
        assert cli.main([slice_path, "--output", png]) == 0
        printed[name] = capsys.readouterr().out.replace(png, "PNG")
    assert printed["torch"] == printed["jax"]
    for name in ("lung", "mediastinum", "bone", "lung_vessel"):
        assert name in printed["torch"]
    np.testing.assert_array_equal(_png(tmp_path / "torch.png"),
                                  _png(tmp_path / "jax.png"))
