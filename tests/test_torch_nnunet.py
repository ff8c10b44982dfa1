"""nnU-Net's ``PlainConvUNet`` (``models/nnunet.py``), the sliding-window
segmenter (``infer/segment.py``), K2's 3-D route and the masking CLI's
in-process backend, on the CPU at small sizes, against the benchmark's
plain float32 reference (``portbench/reference/nnunet.py``, written apart
from the port).

Bounds, fixed before any run: the network's logits and the window's
accumulated logits within a relative L2 of 1e-5 (float32 on both sides;
the window's resampling is ``F.interpolate`` here and one-axis lerps
there), the window's labels equal on >= 99.9% of voxels (an argmax may
flip where two logits tie to that rounding); the sliding-window steps and
state-dict keys exact; the Gaussian map within 1e-6 relative of scipy's
filtered delta; K2 3-D's plain version within 1e-6 (fp32) or 1 bf16 ulp of
``F.instance_norm``'s composition, its kernel within 1 ulp of the plain
version on a card.
"""
import json
import math
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ducosy_tpu_torch.cli import masking as tmasking
from ducosy_tpu_torch.dicom.nifti import read_nifti
from ducosy_tpu_torch.infer import segment as seg
from ducosy_tpu_torch.models import nnunet
from ducosy_tpu_torch.ops.kernels import _build
from ducosy_tpu_torch.ops.kernels import instance_norm as k2

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import nnunet as ref  # noqa: E402

PLAN = {"input_channels": 1, "features": [32, 64, 96],
        "kernel_sizes": [[3, 3, 3]] * 3,
        "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
        "classes": 5, "patch_size": [16, 16, 16],
        "spacing": [1.5, 1.5, 1.5],
        "normalization": {"lower": -1000.0, "upper": 1500.0, "mean": 80.0,
                          "std": 300.0},
        "step": 0.5}


def _weights(plan, seed=0):
    """Seeded canonical parameters: He-normal convs, drawn biases and
    affines (so every term of the math is held)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in ref.param_shapes(plan).items():
        if k.endswith("norm.weight"):
            out[k] = 1 + 0.2 * torch.randn(shape, generator=g)
        elif k.endswith("bias"):
            out[k] = 0.1 * torch.randn(shape, generator=g)
        else:
            fan_in = shape[1] * math.prod(shape[2:])
            out[k] = torch.randn(shape, generator=g) * math.sqrt(
                2 / (1 + 0.01 ** 2) / fan_in)
    return out


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_plain_conv_unet_matches_the_reference():
    p = _weights(PLAN)
    net = nnunet.PlainConvUNet.from_canonical(PLAN, p).eval()
    x = torch.randn(2, 1, 16, 16, 16, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        got = net(x)
    want = ref.forward(p, x, PLAN)
    assert got.shape == (2, PLAN["classes"], 16, 16, 16)
    assert _rel(got, want) < 1e-5


def test_canonical_keys_are_the_references():
    sd = nnunet.PlainConvUNet(PLAN).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()
            if nnunet.canonical_key(k) == k} == ref.param_shapes(PLAN)


@pytest.mark.parametrize("size,tile,want", [
    (239, 128, [0, 56, 111]),          # 512 px at 0.7 mm -> 1.5 mm
    (277, 128, [0, 50, 99, 149]),      # 416 slices at 1.0 mm
    (165, 128, [0, 37]),               # 248 slices
    (128, 128, [0]),
    (256, 128, [0, 64, 128]),
    (27, 16, [0, 6, 11])])
def test_sliding_window_steps_are_nnunets(size, tile, want):
    """ceil((size - tile) / (tile / 2)) + 1 origins from 0 to size - tile,
    rounded half to even (111 / 2 = 55.5 -> 56)."""
    assert seg.sliding_window_steps([size], [tile], 0.5) == [want]
    assert ref.steps([size], [tile], 0.5) == [want]


def test_gaussian_map_sum_peak_and_floor():
    patch = (32, 24, 16)
    g = seg.gaussian_map(patch, "cpu")
    assert g.dtype == torch.float32 and g.shape == patch
    assert float(g.max()) == 10.0 and float(g[16, 12, 8]) == 10.0
    one = [np.exp(-0.5 * ((np.arange(p) - p // 2) / (p / 8)) ** 2)
           for p in patch]
    assert math.isclose(float(g.double().sum()),
                        10 * math.prod(v.sum() for v in one), rel_tol=1e-6)
    np.testing.assert_allclose(g.numpy(), ref.gaussian(patch, "cpu").numpy(),
                               rtol=1e-6, atol=0)
    tiny = seg.gaussian_map((12, 12, 12), "cpu", sigma_scale=0.01)
    nonzero = tiny[tiny > 0]
    assert float(tiny.min()) > 0 and float(tiny.min()) == float(nonzero.min())


def _hu_volume(shape, seed=3):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                          indexing="ij")
    body = (y ** 2 / 0.8 + x ** 2 / 0.9) < 0.8
    hu = np.where(body, 40.0, -1000.0) + 300 * np.sin(3 * z + 2 * x) * body
    return (hu + rng.normal(0, 20, shape)).astype(np.int16)


def test_segment_volume_matches_the_reference_window():
    """A 40 x 40 x 30 series at (1.0, 0.7, 0.7) mm is 27 x 19 x 14 at 1.5
    mm: three origins on z, two on y, x padded to the patch; six patches
    in batches of four (a ragged last batch)."""
    p = _weights(PLAN, seed=5)
    hu = _hu_volume((40, 40, 30))
    spacing = (1.0, 0.7, 0.7)
    net = nnunet.PlainConvUNet.from_canonical(PLAN, p)
    segm = seg.Segmenter(net, PLAN, device="cpu", dtype=torch.float32,
                         patch_batch=4)
    out = segm.segment_async(hu, spacing, logits=True)
    want_logits, want_labels = ref.segment(torch.from_numpy(hu), spacing, p,
                                           PLAN)
    assert out.logits.shape == want_logits.shape == (5, 27, 19, 14)
    assert _rel(out.logits, want_logits) < 1e-5
    assert out.labels.dtype == torch.uint8 and out.labels.shape == hu.shape
    agree = (out.labels.long() == want_labels).float().mean()
    assert float(agree) >= 0.999
    assert ref.patches(hu.shape, spacing, PLAN) == 6
    labels = seg.segment_volume(hu, spacing, net, PLAN, device="cpu",
                                dtype=torch.float32, patch_batch=4)
    np.testing.assert_array_equal(labels, out.labels.numpy())


def test_segment_counts_patches_and_voxels():
    from ducosy_tpu_torch import trace

    net = nnunet.PlainConvUNet.from_canonical(PLAN, _weights(PLAN))
    segm = seg.Segmenter(net, PLAN, device="cpu", dtype=torch.float32,
                         patch_batch=3)
    before = trace.counters()
    segm.segment_async(_hu_volume((40, 40, 30)), (1.0, 0.7, 0.7))
    got = {k: v - before.get(k, 0) for k, v in trace.counters().items()
           if k.startswith("seg.")}
    assert got == {"seg.patches": 6, "seg.patch_voxels": 6 * 16 ** 3,
                   "seg.volume_voxels": 27 * 19 * 14}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slope", [0.0, 0.01])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("c", [32, 96])
def test_k2_3d_plain_is_instance_norm_affine_leaky(c, affine, slope, dtype):
    """On a CPU tensor the route is its plain version, uncounted; it equals
    ``F.instance_norm`` (+ affine) + ``F.leaky_relu`` on the NCDHW view."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(2, 5, 6, 7, c, generator=g) * 3 + 1).to(dtype)
    w = 1 + 0.3 * torch.randn(c, generator=g) if affine else None
    b = 0.2 * torch.randn(c, generator=g) if affine else None
    before = k2.instance_norm3d.launches
    got = k2.instance_norm3d(x, w, b, negative_slope=slope)
    assert k2.instance_norm3d.launches == before
    assert got.dtype == dtype and got.shape == x.shape
    want = F.leaky_relu(F.instance_norm(
        x.float().permute(0, 4, 1, 2, 3), weight=w, bias=b, eps=1e-5),
        slope).permute(0, 2, 3, 4, 1)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


BAD3D = {"c48": ((1, 2, 4, 4, 48), torch.bfloat16, {}, "multiple of 32"),
         "c8192": ((1, 2, 4, 4, 8192), torch.bfloat16, {}, "above 4096"),
         "c4096-fp32": ((1, 2, 4, 4, 4096), torch.float32, {}, "above 2048"),
         "4d": ((2, 4, 4, 32), torch.bfloat16, {}, "NDHWC"),
         "fp16": ((1, 2, 4, 4, 32), torch.float16, {}, "float32 or"),
         "weight-shape": ((1, 2, 4, 4, 32), torch.bfloat16,
                          {"weight": (64,)}, "weight"),
         "bias-dtype": ((1, 2, 4, 4, 32), torch.bfloat16,
                        {"bias": (32, torch.bfloat16)}, "bias")}


@pytest.mark.parametrize("shape,dtype,kw,match", BAD3D.values(), ids=BAD3D)
def test_k2_3d_refuses_what_it_does_not_take(shape, dtype, kw, match,
                                             monkeypatch):
    """Shape, dtype and affine faults raise before any build, on a tensor
    off the CPU (meta); a good tensor off the card is refused for its
    device; nothing is counted."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = k2.instance_norm3d.launches
    vec = {k: torch.empty(v[0], dtype=v[1] if len(v) > 1 else torch.float32,
                          device="meta") for k, v in kw.items()}
    x = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(TypeError if dtype == torch.float16 else ValueError,
                       match=match):
        k2.instance_norm3d(x, **vec)
    x = torch.empty((1, 2, 4, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="NDHWC"):
        k2.instance_norm3d(x.transpose(1, 2))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k2.instance_norm3d(x)
    assert k2.instance_norm3d.launches == before


def _nnunet_dir(root, plan, seed=0, legacy=False):
    """A trained model folder as nnU-Net writes it: plans.json (the
    architecture's arch_kwargs, or the older plans' keys), dataset.json,
    fold_0/checkpoint_final.pth with the full state dict."""
    root.mkdir(parents=True)
    conf = {"patch_size": plan["patch_size"], "spacing": plan["spacing"]}
    if legacy:
        conf.update(UNet_base_num_features=plan["features"][0],
                    unet_max_num_features=plan["features"][-1],
                    conv_kernel_sizes=plan["kernel_sizes"],
                    pool_op_kernel_sizes=plan["strides"],
                    n_conv_per_stage_encoder=plan["n_conv_per_stage"],
                    n_conv_per_stage_decoder=plan["n_conv_per_stage_decoder"])
    else:
        conf["architecture"] = {
            "network_class_name": "dynamic_network_architectures."
                                  "architectures.unet.PlainConvUNet",
            "arch_kwargs": {
                "n_stages": len(plan["features"]),
                "features_per_stage": plan["features"],
                "kernel_sizes": plan["kernel_sizes"],
                "strides": plan["strides"],
                "n_conv_per_stage": plan["n_conv_per_stage"],
                "n_conv_per_stage_decoder": plan["n_conv_per_stage_decoder"],
                "conv_bias": True}}
    n = plan["normalization"]
    plans = {"configurations": {"3d_fullres": conf},
             "foreground_intensity_properties_per_channel": {"0": {
                 "percentile_00_5": n["lower"], "percentile_99_5": n["upper"],
                 "mean": n["mean"], "std": n["std"]}}}
    labels = {"background": 0, **{f"organ{i}": i
                                  for i in range(1, plan["classes"])}}
    (root / "plans.json").write_text(json.dumps(plans))
    (root / "dataset.json").write_text(json.dumps(
        {"channel_names": {"0": "CT"}, "labels": labels}))
    full = nnunet.PlainConvUNet.from_canonical(plan, _weights(plan, seed))
    (root / "fold_0").mkdir()
    torch.save({"network_weights": full.state_dict(), "trainer_name":
                "nnUNetTrainerNoMirroring"},
               root / "fold_0" / "checkpoint_final.pth")
    return str(root)


def test_state_dict_in_nnunets_layout_loads_strictly(tmp_path):
    keys = set(nnunet.PlainConvUNet(PLAN).state_dict())
    for k in ("encoder.stages.0.0.convs.0.conv.weight",
              "encoder.stages.0.0.convs.0.norm.bias",
              "encoder.stages.2.0.convs.1.all_modules.0.weight",
              "encoder.stages.1.0.convs.0.all_modules.1.weight",
              "decoder.encoder.stages.1.0.convs.1.conv.bias",
              "decoder.transpconvs.0.weight", "decoder.transpconvs.1.bias",
              "decoder.stages.0.convs.1.norm.weight",
              "decoder.stages.1.convs.0.all_modules.0.bias",
              "decoder.seg_layers.0.weight", "decoder.seg_layers.1.bias"):
        assert k in keys, k
    # per conv: conv and norm weight and bias, twice more under all_modules;
    # the encoder's again under decoder.encoder; 2 + 2 a transpconv and
    # seg layer
    assert len(keys) == 2 * 6 * 8 + 4 * 8 + 2 * 2 + 2 * 2
    for legacy in (False, True):
        d = _nnunet_dir(tmp_path / str(legacy), PLAN, seed=2, legacy=legacy)
        net, plan = nnunet.load_nnunet(d)
        assert plan == PLAN
        p = _weights(PLAN, seed=2)
        for k, v in net.state_dict().items():
            assert torch.equal(v, p[nnunet.canonical_key(k)]), k


def write_patient(patient_dir, n_slices, size):
    """A NCCT/CECT pair of series of the smooth volume ``_hu_volume``, the
    CECT brighter, through the port's codec (no JAX: the card runs this
    file)."""
    from ducosy_tpu_torch.dicom.codec import new_ct_dataset

    hu = _hu_volume((n_slices, size, size))
    for folder, shift in (("POST VUE", 0), ("POST STD", 80)):
        d = os.path.join(patient_dir, folder)
        os.makedirs(d)
        for i in range(n_slices):
            ds = new_ct_dataset(size, size, instance_number=i + 1,
                                series_description=folder)
            ds.set_pixel_array(np.clip(hu[i] + 1024 + shift, 0, 4095)
                               .astype(np.uint16))
            ds.save_as(os.path.join(d, f"{i:04d}.dcm"))


# the merged TotalSegmentator map's value range: labels 0-68 reach every
# ID that the masking stage selects (MASK_TARGET_LABELS' largest is 68)
MERGED_PLAN = {**PLAN, "classes": 69}


def _cli_args(tmp_path, plan, pids=("p1", "p2")):
    """A two-patient input tree (24-slice 64^2 NCCT/CECT pairs, the CECT
    copied to the output's patient folder) and the masking CLI's arguments
    for the native segmenter on a model folder of ``plan``."""
    nn_dir = _nnunet_dir(tmp_path / "model", plan, seed=4)
    inp, out = tmp_path / "input", tmp_path / "output"
    for pid in pids:
        write_patient(str(inp / "DS" / pid), n_slices=24, size=64)
        shutil.copytree(inp / "DS" / pid / "POST STD", out / "DS" / pid)
    return nn_dir, out, [
        "--input_dir_root", str(inp), "--output_dir_root", str(out),
        "--dataset_names", "DS", "--device", "cpu",
        "--segmenter", "native", "--nnunet_dir", nn_dir]


def test_masking_cli_native_segmenter_writes_what_masking_reads(tmp_path,
                                                                capsys):
    """``generate --segmenter native`` on two 24-slice 64^2 patients, with
    a network whose labels are the merged map's IDs, writes each
    ``mask/DS/<pid>.nii`` ((x, y, z) labels of the network's classes, the
    affine of the working NIfTI that ``dicom_to_nifti`` wrote); the
    masking stage reads it (from modified_mask/) and masks the three
    series."""
    nn_dir, out, args = _cli_args(tmp_path, MERGED_PLAN)
    tmasking.main(args + ["--stage", "generate"])
    printed = capsys.readouterr().out
    assert "p1: OK" in printed and "p2: OK" in printed
    net, plan = nnunet.load_nnunet(nn_dir)
    for pid in ("p1", "p2"):
        labels, affine = read_nifti(str(out / "mask" / "DS" / f"{pid}.nii"))
        # the series as the subprocess backend hands it to TotalSegmentator
        hu, want_affine = read_nifti(str(out / "working" / "DS" / pid /
                                         "input.nii"))
        assert labels.shape == (64, 64, 24) and labels.dtype == np.uint8
        assert labels.max() < MERGED_PLAN["classes"]
        np.testing.assert_allclose(affine, want_affine, atol=1e-6)
        spacing = [want_affine[i, i] for i in (2, 1, 0)]
        want = seg.segment_volume(np.transpose(hu, (2, 1, 0)).copy(),
                                  spacing, net, plan, device="cpu",
                                  dtype=torch.float32)
        np.testing.assert_array_equal(labels, np.transpose(want, (2, 1, 0)))
    shutil.copytree(out / "mask", out / "modified_mask")
    tmasking.main(args + ["--stage", "masking"])
    printed = capsys.readouterr().out
    assert "p1: masked 24 slices x 3 series" in printed
    assert len(os.listdir(out / "masked" / "DS" / "p1" / "generated")) == 24


def test_masking_cli_native_segmenter_refuses_a_part_network(tmp_path,
                                                             capsys):
    """A network of 5 labels (as a part network of the total task, whose
    labels stop short of the merged IDs 51-68) fails each patient with the
    reason and writes nothing."""
    _, out, args = _cli_args(tmp_path, PLAN, pids=("p1",))
    tmasking.main(args + ["--stage", "generate"])
    printed = capsys.readouterr().out
    assert "p1: FAILED" in printed
    assert "do not reach the merged TotalSegmentator IDs 5-68" in printed
    assert not (out / "mask" / "DS" / "p1.nii").exists()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 96, 320])
def test_k2_3d_kernel_matches_its_plain_version(card, c, dtype):
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(2, 9, 10, 11, c, generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.3 * torch.randn(c, generator=g)
    b = 0.2 * torch.randn(c, generator=g)
    for aff, slope in ((False, 0.0), (True, 0.01), (True, 0.0),
                       (False, 0.01)):
        kw = {"weight": w, "bias": b} if aff else {}
        before = k2.instance_norm3d.launches
        got = k2.instance_norm3d(x.to(card), **{k: v.to(card) for k, v in
                                                kw.items()},
                                 negative_slope=slope).cpu()
        assert k2.instance_norm3d.launches == before + 1
        want = k2.instance_norm3d_plain(x, **kw, negative_slope=slope)
        ulp = 1e-5 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=ulp,
                                   atol=ulp)


@pytest.mark.card
def test_every_norm_of_the_network_is_a_k2_3d_launch(card):
    p = _weights(PLAN)
    x = torch.randn(2, 1, 16, 16, 16, generator=torch.Generator()
                    .manual_seed(1))
    net = nnunet.for_inference(nnunet.PlainConvUNet.from_canonical(PLAN, p),
                               card, torch.bfloat16)
    before = k2.instance_norm3d.launches
    with torch.no_grad():
        got = net(x.to(card, torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)).float().cpu()
    assert k2.instance_norm3d.launches - before == 6 + 4
    assert _rel(got, ref.forward(p, x, PLAN)) < 0.05
