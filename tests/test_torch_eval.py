"""The port's evaluation suite (losses/ssim.ms_ssim, eval/metrics, eval/lpips,
eval/report, cli/calculate) against the JAX package, on the CPU
(device="cpu").

Same seeded numpy inputs through both sides. Tolerances: MS-SSIM value and
per-sample values within 1e-5 (fp32 filters as matmuls on both sides, in
another summation order); the host metrics (mae, psnr, ssim, emd, ts, cs,
ed) equal, as the port's are copies of the same numpy/scipy code; LPIPS
within rtol 2e-4, atol 1e-7 of the committed golden fixture
(tests/lpips_golden.py: the lpips package's module graph in float64) and
of the JAX LPIPSAlex on the same weights file.
"""
import contextlib
import csv
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.eval import lpips as jlpips
from ducosy_tpu.eval import metrics as jmetrics
from ducosy_tpu.eval import report as jreport
from ducosy_tpu.losses import ssim as jssim
from ducosy_tpu_torch.cli import calculate as tcalc
from ducosy_tpu_torch.eval import lpips as tlpips
from ducosy_tpu_torch.eval import metrics as tmetrics
from ducosy_tpu_torch.eval import report as treport
from ducosy_tpu_torch.losses import ssim as tssim

sys.path.insert(0, os.path.dirname(__file__))
from lpips_golden import (FIXTURE, golden_state_dict,  # noqa: E402
                          golden_volumes)
from synth import write_patient  # noqa: E402

CPU = {"device": "cpu"}


def _golden_npz(path):
    """The golden weights as an .npz in the layout both loaders read."""
    flat = dict(golden_state_dict())
    for i in range(5):
        flat[f"lin{i}"] = flat.pop(f"lin{i}.model.1.weight").reshape(-1)
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    npz = _golden_npz(d / "alex.npz")
    pth = str(d / "alex.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                golden_state_dict().items()}, pth)
    return {"npz": npz, "pth": pth}


@pytest.fixture()
def lpips_env(weights, monkeypatch):
    monkeypatch.setenv(tlpips.ENV_WEIGHTS, weights["npz"])
    return weights["npz"]


# ---------------------------------------------------------------- MS-SSIM
@pytest.mark.parametrize("shape", [(2, 176, 176), (3, 181, 200),
                                   (2, 192, 177)])
def test_ms_ssim_matches_jax(shape):
    """Batch value and per-sample values, (N, H, W) and NHWC inputs; odd
    sizes take the floor-cropped pooling."""
    rng = np.random.default_rng(sum(shape))
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ref, ref_ps = jssim.ms_ssim(jnp.asarray(x[..., None]),
                               jnp.asarray(y[..., None]),
                               return_per_sample=True)
    got, got_ps = tssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(y),
                                return_per_sample=True)
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(ref_ps), rtol=0,
                               atol=1e-5)
    nhwc = tssim.ms_ssim(torch.from_numpy(x[..., None]),
                         torch.from_numpy(y[..., None]))
    np.testing.assert_allclose(float(nhwc), float(got), rtol=0, atol=1e-7)


# ----------------------------------------------------------------- metrics
@pytest.fixture(scope="module")
def volumes():
    rng = np.random.default_rng(5)
    a = rng.uniform(-500, 900, (3, 180, 180)).astype(np.float32)
    b = (a + rng.normal(0, 40, a.shape)).astype(np.float32)
    return a, b


@contextlib.contextmanager
def _weights_env(path):
    """$DUCOSY_LPIPS_WEIGHTS set to ``path`` inside the block (for module
    fixtures, which cannot take monkeypatch)."""
    saved = os.environ.get(tlpips.ENV_WEIGHTS)
    os.environ[tlpips.ENV_WEIGHTS] = path
    try:
        yield
    finally:
        if saved is None:
            del os.environ[tlpips.ENV_WEIGHTS]
        else:
            os.environ[tlpips.ENV_WEIGHTS] = saved


@pytest.fixture(scope="module")
def both_suites(volumes, weights):
    """compute_all on both sides with the golden LPIPS weights."""
    with _weights_env(weights["npz"]):
        return (jmetrics.compute_all(*volumes),
                tmetrics.compute_all(*volumes, **CPU))


@pytest.mark.parametrize("name", list(tmetrics.BASIC_METRICS)
                         + list(tmetrics.ADVANCED_METRICS))
def test_compute_all_matches_jax(both_suites, name):
    ref, got = (s[name] for s in both_suites)
    assert len(got[1]) == len(ref[1]) == 3
    if name in tmetrics.BASIC_METRICS:
        assert got == ref
    elif name == "ms_ssim":
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
        assert got[0] == pytest.approx(ref[0], abs=1e-5)
    else:
        np.testing.assert_allclose(got[1], ref[1], rtol=2e-4, atol=1e-7)
        assert got[0] == pytest.approx(ref[0], rel=2e-4)
    assert set(both_suites[1]) == set(both_suites[0])


def test_small_ms_ssim_is_nan_and_no_weights_lpips_is_nan(monkeypatch,
                                                          tmp_path):
    """Below 176 px MS-SSIM is NaN; without a weights file LPIPS is NaN
    (as the reference without its lpips package)."""
    monkeypatch.delenv(tlpips.ENV_WEIGHTS, raising=False)
    monkeypatch.chdir(tmp_path)
    small = np.zeros((2, 64, 64), np.float32)
    val, per = tmetrics.calculate_ms_ssim(small, small, **CPU)
    assert np.isnan(val) and per == []
    assert tlpips.default_weights_path() is None
    val, per = tmetrics.calculate_lpips(small, small, **CPU)
    assert np.isnan(val) and per == []


def test_device_metrics_default_to_cuda():
    """MS-SSIM and LPIPS run on the card unless the caller names the CPU;
    without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    vol = np.zeros((1, 176, 176), np.float32)
    for fn in (tmetrics.calculate_ms_ssim, tmetrics.calculate_lpips):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(vol, vol)


# ------------------------------------------------------------------ LPIPS
def test_lpips_golden_fixture(weights):
    """The committed per-slice distances (float64 lpips module graph) on
    the golden weights and volumes."""
    with np.load(FIXTURE) as data:
        expected = data["per_slice"]
    model = tlpips.LPIPSAlex(weights["npz"])
    mean, per = model.distance(*golden_volumes())
    np.testing.assert_allclose(per, expected, rtol=2e-4, atol=1e-7)
    assert mean == pytest.approx(float(expected.mean()), rel=2e-4)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_lpips_matches_jax_on_the_same_file(weights, fmt):
    rng = np.random.default_rng(13)
    v1 = rng.uniform(-900, 1200, (3, 77, 93)).astype(np.float32)
    v2 = (v1 + rng.normal(0, 60, v1.shape)).astype(np.float32)
    ref = jlpips.LPIPSAlex(weights[fmt])(v1, v2)
    got = tlpips.LPIPSAlex(weights[fmt]).distance(v1, v2)
    np.testing.assert_allclose(got[1], ref[1], rtol=2e-4, atol=1e-7)
    assert got[0] == pytest.approx(ref[0], rel=2e-4)


def test_lpips_weights_round_trip_and_checks(weights, tmp_path):
    """save_lpips_weights_npz writes what both loaders read back; a file
    without a head or with a wrong conv shape is refused."""
    params = tlpips.load_lpips_weights(weights["pth"])
    path = str(tmp_path / "copy.npz")
    tlpips.save_lpips_weights_npz(params, path)
    again = tlpips.load_lpips_weights(path)
    assert set(again) == set(params)
    for k in params:
        np.testing.assert_array_equal(again[k], params[k])
    jax_side = jlpips.load_lpips_weights(path)
    np.testing.assert_array_equal(jax_side["conv1_w"],
                                  params["conv1_w"].transpose(2, 3, 1, 0))
    flat = dict(np.load(path))
    del flat["lin3"]
    np.savez(str(tmp_path / "nohead.npz"), **flat)
    with pytest.raises(ValueError, match="missing lin3"):
        tlpips.load_lpips_weights(str(tmp_path / "nohead.npz"))
    flat = dict(np.load(path))
    flat["features.3.weight"] = flat["features.3.weight"][:, :, :3, :3]
    np.savez(str(tmp_path / "shape.npz"), **flat)
    with pytest.raises(ValueError, match="features.3.weight"):
        tlpips.load_lpips_weights(str(tmp_path / "shape.npz"))


def test_lpips_leaves_the_tf32_setting_as_it_was(weights):
    model = tlpips.LPIPSAlex(weights["npz"])
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            x = torch.zeros(1, 1, 64, 64)
            model(x, x)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------ report and the CLI
SIZE = 176   # the smallest size MS-SSIM takes


def _eval_tree(root):
    """Two patients: input/DS/<pid>/{POST VUE, POST STD} and the generated
    series output/DS/<pid>/*.dcm (STD plus a seeded offset)."""
    from ducosy_tpu_torch.dicom import dcmread

    rng = np.random.default_rng(0)
    for pid in ("p1", "p2"):
        write_patient(str(root / "input" / "DS" / pid), n_slices=2,
                      size=SIZE)
        out = root / "output" / "DS" / pid
        out.mkdir(parents=True)
        for f in sorted((root / "input" / "DS" / pid / "POST STD")
                        .glob("*.dcm")):
            d = dcmread(str(f))
            noise = rng.integers(-30, 30, d.pixel_array.shape)
            px = np.clip(d.pixel_array.astype(np.int64) + 5 + noise, 0,
                         4095).astype(np.uint16)
            d.PixelData = px.tobytes()
            d.save_as(str(out / f.name))
    return str(root / "input"), str(root / "output")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _run_report(mod, root, **kw):
    inp, out = str(root / "input"), str(root / "output")
    calc_dir, data_dir, tasks = mod.convert(inp, out, ["DS"])
    results = mod.calculate(data_dir, calc_dir, tasks, **kw)
    return calc_dir, tasks, results, mod.summary_statistics(results,
                                                            calc_dir)


def _assert_rows_close(got, want):
    """CSV rows: header and labels equal, numbers within the LPIPS bound
    (the host metrics' cells are equal; MS-SSIM's within 1e-5)."""
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert fa == pytest.approx(fb, rel=2e-4, abs=1e-5) or \
                (np.isnan(fa) and np.isnan(fb))


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory, weights):
    root = tmp_path_factory.mktemp("jax_report")
    _eval_tree(root)
    with _weights_env(weights["npz"]):
        return root, _run_report(jreport, root, num_workers=1)


@pytest.mark.parametrize("workers", [1, 2])
def test_report_matches_jax(jax_report, lpips_env, tmp_path, workers):
    """convert + calculate + summary_statistics on a two-patient tree
    against the JAX report: the same tasks, cache files, pair order,
    per-slice CSVs and summary; with 2 workers through the spawn pool."""
    jroot, (jcalc, jtasks, jres, jsummary) = jax_report
    _eval_tree(tmp_path)
    calc, tasks, res, summary = _run_report(treport, tmp_path,
                                            num_workers=workers, **CPU)
    assert tasks == jtasks == [("DS", "p1"), ("DS", "p2")]
    assert sorted(os.listdir(os.path.join(calc, "data"))) == \
        sorted(os.listdir(os.path.join(jcalc, "data")))
    assert set(res) == set(jres) == {"DS/p1", "DS/p2"}
    for key in jres:
        for m in treport.ALL_METRICS:
            assert len(res[key][m]) == len(jres[key][m]), m
            if m in ("ms_ssim", "lpips"):
                np.testing.assert_allclose(res[key][m], jres[key][m],
                                           rtol=2e-4, atol=1e-5)
                assert np.all(np.isfinite(res[key][m])), m
            else:
                assert res[key][m] == jres[key][m], m
    for pid in ("p1", "p2"):
        name = f"DS_{pid}_metrics.csv"
        _assert_rows_close(_rows(os.path.join(calc, "detail", name)),
                           _rows(os.path.join(jcalc, "detail", name)))
    _assert_rows_close(_rows(summary), _rows(jsummary))


def test_calculate_cli_on_the_cpu(lpips_env, tmp_path, capsys):
    """``--device cpu --fast``: every metric of both patients, finite
    MS-SSIM and LPIPS, the summary written, no figures."""
    inp, out = _eval_tree(tmp_path)
    res = tcalc.main(["--input_dir_root", inp, "--output_dir_root", out,
                      "--dataset_names", "DS", "--num_workers", "1",
                      "--fast", "--device", "cpu"])
    assert set(res) == {"DS/p1", "DS/p2"}
    for r in res.values():
        assert len(r["mae"]) == 3
        assert np.isfinite(r["ms_ssim"][0]) and np.isfinite(r["lpips"][0])
    calc = os.path.join(out, "calculated")
    assert os.path.isfile(os.path.join(calc, "summary_statistics.csv"))
    assert not os.path.exists(os.path.join(calc, "figures"))
    assert "no LPIPS weights" not in capsys.readouterr().out


def test_calculate_cli_defaults_to_cuda(tmp_path, monkeypatch, capsys):
    """Without --device the CLI asks for the card and raises without one;
    with no weights file it prints the reference's LPIPS note."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcalc.main(["--dataset_names", "none", "--output_dir_root",
                    str(tmp_path)])
    monkeypatch.delenv(tlpips.ENV_WEIGHTS, raising=False)
    monkeypatch.chdir(tmp_path)
    tcalc.main(["--dataset_names", "none", "--output_dir_root",
                str(tmp_path), "--device", "cpu", "--fast"])
    assert "no LPIPS weights found" in capsys.readouterr().out


def test_save_figures_matches_jax(jax_report, lpips_env, tmp_path):
    """Without --fast: the same figure files as the JAX report's (one
    distribution plot a metric with values, the enhancement scatter)."""
    pytest.importorskip("matplotlib")
    jroot, (jcalc, _, jres, _) = jax_report
    _eval_tree(tmp_path)
    calc, _, res, _ = _run_report(treport, tmp_path, num_workers=1, **CPU)
    jdir = jreport.save_figures(jres, str(tmp_path / "jax_figures"))
    tdir = treport.save_figures(res, calc)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert "enhancement_correlation.png" in names
    assert "lpips_distribution.png" in names
