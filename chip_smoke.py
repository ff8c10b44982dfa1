#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ducosy_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ducosy_tpu_torch/csrc with nvcc and
drives the serving path the way a user does, at full model width:

  1. the card (nvidia-smi name, power limit), torch/CUDA versions, and the
     kernel build time with nvcc's register/spill report;
  2. K2 (instance_norm) against its plain PyTorch version at the serving
     shapes: down1 (16, 256, 256, 128) pad 0 and down2 (16, 128, 128, 256)
     pad 1, in fp32 and bf16, with max |diff| and CUDA-event times;
  3. K1 (residual_chain) against its plain version on a (16, 130, 130, 256)
     carry: k = 3 and k = 1, pad 1 and pad 0, fp32 and bf16;
  4. two seeded ResNet-9 + CBAM generators (1 channel, base 64) in
     DualGeneratorEngine.run_patient on a 32-slice 512^2 chest phantom
     with chunk 16: the launch counters must show every K1 and K2 call of
     the serving path; fp32 through the kernels must match the fp32 plain
     path to 1 stored unit on >= 99.9% of voxels; the bf16 kernel path's
     |dHU| to the fp32 plain path and both paths' slices/s are printed;
  5. the port's generate CLI on one synthetic 32-slice 512^2 DICOM patient
     with .pth checkpoints, read back from disk;
  6. the training kernels against their plain versions at the training
     shapes (N = 8): K3 (instance_norm_bwd) on x (8, 128, 128, 256), pad 1,
     ReLU; K4 (block_tail) and K5 (block_tail_bwd) on h (8, 128, 128, 256)
     with pad 1 / x_pad 1 and pad 0 / x_pad 1; fp32 and bf16, with max and
     mean |diff| and CUDA-event times;
  3q. quantized serving's kernels against their plain versions: K1q
     (residual_chain quant=True) on the (16, 130, 130, 256) carry, k = 3
     and 1, pad 1 and 0, bf16 and fp32, with the share of int8 t codes
     that agree (k = 1); K2's int8 write (16, 128, 128, 256) pad 1 bf16
     (code agreement) and its phase pooling (16, 128, 128, 512), 4 phases,
     bf16 and fp32; P3 (tap_probe), int8 exact, TOP/s of int8 and bf16 at
     (16384, 256) x (256, 256) with 9 and 36 taps;
  4q. the engine at quant="trunk" and quant="full" (bf16, chain trunk, the
     phase-4 generators and phantom): exact K1q and K2 launch counts,
     slices/s beside the bf16 chain path, and both fidelity taps against
     the bf16 engine (generate_batch stored outputs; run_patient); then
     trunk="tail" at quant="trunk" with exact K2-int8 and K4 counts;
  5q. the generate CLI with --quant trunk, read back from disk;
  7. the port's training CLI on a synthetic 512^2 chest-phantom patient
     tree with mask generation at SOFT_TISSUE (3 input channels): 9 blocks,
     base 64, batch 8, bf16, trunk="tail", a few steps. The launch counters
     must show exactly the K2, K3, K4 and K5 calls of those steps and of the
     validation pass, and every loss must be finite. The same steps then run
     with trunk="plain" from the same init and batches; both first-step
     losses, their difference, s/step, the peak memory and the remat mode
     are printed.

Any failure exits non-zero before the result lines. On success the last
three lines are the card, a JSON object with one record per kernel, and
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a CUDA device, and outside a checkout of the repo.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N = 16                 # slices per generator call on the serving path
SLICES, SIZE = 32, 512  # phantom patient
SEED = 0
K2_CASES = (("down1", (N, 256, 256, 128), 0), ("down2", (N, 128, 128, 256), 1))
K1_SHAPE = (N, 128, 128, 256)   # carry interior; R = C / 16

# Tolerances, set from the dtypes before any run:
#  K2 fp32: both versions use fp32 centred statistics; only the summation
#    order differs (~1e-6 relative).
#  K2 bf16: both normalize the same bf16 input in fp32 and round once, so
#    they differ by at most one bf16 ulp (2^-7 relative).
#  K1 fp32: exact-FMA kernel vs cuDNN fp32 (TF32 off) over three blocks;
#    summation order only.
#  K1 bf16: the plain version also rounds each conv output to bf16 before
#    its norm, the kernel normalizes the fp32 accumulator (as the TPU
#    kernel does): a few bf16 ulps per block, three blocks deep.
TOL = {("k2", "float32"): (1e-4, 1e-4), ("k2", "bfloat16"): (1e-2, 1e-2),
       ("k1", "float32"): (1e-3, 1e-3), ("k1", "bfloat16"): (0.125, 0.02)}
K1_BF16_MEAN_TOL = 0.01
STORED_UNIT_SHARE = 0.999   # fp32 kernel vs plain: |d| <= 1 on this share

# Quantized serving, tolerances set before any run:
#  K1q fp32, k = 1: where the kernel's and the plain version's fp32
#    statistics differ in the last ulp, a t code can sit one step apart;
#    that moves the conv2 input by S/255 at one pixel, ~1e-3 at the block
#    output: |d| <= 1e-2 + 1e-2 |ref| and mean |d| <= 1e-4.
#  K1q fp32, k = 3: the one-block bound failed in the first chip run (max
#    1.9e-2, mean 4.4e-4): each block's code steps perturb the next block's
#    conv1 input, which moves more codes there, so three blocks deep the
#    fp32 chain diverges as the bf16 one does; it is held to the bf16
#    tolerance.
#  K1q bf16: as K1 bf16 (the plain version rounds the dequantized conv2
#    output to bf16 before its norm; the kernel normalizes the int32
#    accumulator), plus those code steps.
#  t codes (k = 1, from the same carry; both quantize the fp32 normalized
#    value of an fp32 accumulator of the same io-dtype products), and K2's
#    int8 write (both quantize the bf16-rounded value): equal on >= 99.9%,
#    never more than one step apart.
#  K2 phases: the K2 tolerances above.
#  P3: int8 exact; bf16 |d| <= 1e-4 max|ref| (fp32 sums in another order).
#  Engine quant: the outputs must be finite int16 of the right shape, and
#    the final tap's mean |dHU| against bf16 <= 25: a wrong grid, zero
#    point or scale moves the output by hundreds of HU.
K1Q_TOL = {"float32": (1e-2, 1e-2), "bfloat16": TOL[("k1", "bfloat16")]}
K1Q_MEAN_TOL = {"float32": 1e-4, "bfloat16": K1_BF16_MEAN_TOL}
CODE_SHARE = 0.999
K2P_SHAPE = (N, 128, 128, 512)
PROBE_SHAPE = (16384, 256, 256)
PROBE_BF16_RTOL = 1e-4
QUANT_MEAN_DHU_MAX = 25.0

TRAIN_N = 8                      # training batch
TRAIN_SHAPE = (TRAIN_N, 128, 128, 256)   # trunk activation; R = C / 16
TAIL_CASES = ((1, 1), (0, 1))    # (pad, x_pad): blocks 1-8, block 9
# Training-kernel tolerances, set from the dtypes before any run:
#  K3 fp32: fp32 statistics and sums on both sides, summation order only:
#    |d| <= 1e-4 + 1e-4 |ref|. Where the pre-ReLU value |y| < 1e-5 the two
#    statistics (one ulp apart) may put an element on either side of the
#    ReLU mask; those elements are left out and counted.
#  K3 bf16: both compute in fp32 from the same bf16 inputs and round dx
#    once: one bf16 ulp, |d| <= 1e-2 + 1e-2 |ref|, the same ReLU exclusion.
#  K4 fp32: fp32 statistics, exact fp32 7x7 conv in the kernel vs cuDNN
#    fp32 (TF32 off): |d| <= 1e-4 + 1e-4 |ref|.
#  K4 bf16: the same rounding points on both sides (y, t, the gate, the
#    product, the sum), but fp32 statistics one ulp apart can round y to
#    the neighbouring bf16 value, which can carry to the output: two ulps,
#    |d| <= 0.0625 + 0.02 |ref|, and mean |d| <= 1e-3.
#  K5 fp32: every output (dh, dx, dw1, dw2, dwsa) within 1e-4 of the
#    reference's largest |value| and at relative L2 error <= 1e-4 (fp32
#    sums over 16384 pixels in another order; the kernel's zero avg-pool
#    path differs from the plain one's by ~1e-8).
#  K5 bf16: the plain version rounds dt, dy and each product to bf16 as the
#    reference does (about six roundings per element, 0.2% each) where the
#    kernel stays fp32, and a y one ulp apart can move a bf16 tie of a max
#    pool: relative L2 error <= 2e-2 for every output; dx (the folded
#    cotangent, fp32 sums in the kernel's wrapper, bf16 sums in the plain
#    version) |d| <= 1e-2 + 1e-2 |ref|.
TRAIN_TOL = {("k3", "float32"): (1e-4, 1e-4), ("k3", "bfloat16"): (1e-2, 1e-2),
             ("k4", "float32"): (1e-4, 1e-4),
             ("k4", "bfloat16"): (0.0625, 0.02)}
K4_BF16_MEAN_TOL = 1e-3
K5_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RELU_EDGE = 1e-5
TRAIN_PATIENTS, TRAIN_SLICES, TRAIN_STEPS = 5, 8, 4   # 4 train + 1 val
BLOCKS = 9


def pick(rec: dict) -> dict:
    """The kernels-line fields of a record."""
    return {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms")}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, ref, atol: float, rtol: float):
    import torch

    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail("non-finite kernel output")
    err = (g - r).abs()
    ok = bool((err <= atol + rtol * r.abs()).all())
    return ok, float(err.max()), float(err.mean())


def check_instance_norm(k2, dev, records):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []
    for name, shape, pad in K2_CASES:
        c = shape[-1]
        offset = torch.randn(c, generator=gen, device=dev) * 2.0
        scale = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
        base = torch.randn(shape, generator=gen, device=dev) * scale + offset
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            got = k2.instance_norm(x, relu=True, pad=pad)
            ref = k2.instance_norm_plain(x, relu=True, pad=pad)
            torch.cuda.synchronize()
            atol, rtol = TOL[("k2", str(dtype)[6:])]
            ok, emax, emean = compare(got, ref, atol, rtol)
            ms = cuda_ms(lambda: k2.instance_norm(x, relu=True, pad=pad), 20)
            plain_ms = cuda_ms(
                lambda: k2.instance_norm_plain(x, relu=True, pad=pad), 20)
            log(f"K2 {name} {tuple(shape)} pad={pad} {str(dtype)[6:]}: "
                f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol}, rtol "
                f"{rtol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"{'ok' if ok else 'FAIL'}")
            records[("k2", name, str(dtype)[6:])] = dict(
                max_abs_err=emax, ms=ms, plain_ms=plain_ms)
            if not ok:
                failures.append(f"K2 {name} {dtype}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def check_residual_chain(k1, dev, records):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, hw, _, c = K1_SHAPE
    r = c // 16
    x = torch.randn((n, c, hw, hw), generator=gen, device=dev)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1) \
        .contiguous()
    kmax = 3
    weights = (
        torch.randn((kmax, 3, 3, c, c), generator=gen, device=dev) * 0.02,
        torch.randn((kmax, 3, 3, c, c), generator=gen, device=dev) * 0.02,
        torch.randn((kmax, c, r), generator=gen, device=dev) * 0.1,
        torch.randn((kmax, r, c), generator=gen, device=dev) * 0.1,
        torch.randn((kmax, 7, 7, 2, 1), generator=gen, device=dev) * 0.1)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        carry = xp.to(dtype)
        for k in (3, 1):
            ws = [w[:k] for w in weights]
            for pad in (1, 0):
                got = k1.residual_chain(carry, *ws, pad=pad)
                ref = k1.residual_chain_plain(carry, *ws, pad=pad)
                torch.cuda.synchronize()
                dname = str(dtype)[6:]
                atol, rtol = TOL[("k1", dname)]
                ok, emax, emean = compare(got, ref, atol, rtol)
                if dtype == torch.bfloat16 and emean > K1_BF16_MEAN_TOL:
                    ok = False
                line = (f"K1 k={k} pad={pad} {tuple(carry.shape)} {dname}: "
                        f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol},"
                        f" rtol {rtol})")
                if pad == 1 or k == 3:
                    ms = cuda_ms(lambda: k1.residual_chain(carry, *ws,
                                                           pad=pad), 3)
                    plain_ms = cuda_ms(lambda: k1.residual_chain_plain(
                        carry, *ws, pad=pad), 3)
                    line += f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                    records[("k1", k, pad, dname)] = dict(
                        max_abs_err=emax, ms=ms, plain_ms=plain_ms)
                log(line + (" ok" if ok else " FAIL"))
                if not ok:
                    failures.append(f"K1 k={k} pad={pad} {dname}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def chest_phantom(z: int, size: int, seed: int,
                  contrast: bool = False) -> np.ndarray:
    """Stored int16 slices (HU + 1024): air, body, two lungs with vessels,
    an aorta (contrast-free, or enhanced with ``contrast``), spine;
    structure drifts with z; 12 HU noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
    vol = np.empty((z, size, size), np.int16)
    for i in range(z):
        f = i / max(z - 1, 1)
        hu = np.full((size, size), -1024.0, np.float32)
        body = ((yy - 0.5) / 0.42) ** 2 + ((xx - 0.5) / 0.46) ** 2 < 1
        hu[body] = 40.0
        for cx in (0.31, 0.69):
            lung = ((yy - 0.48) / (0.25 + 0.03 * f)) ** 2 + \
                   ((xx - cx) / 0.15) ** 2 < 1
            hu[lung] = -850.0
            for k in range(6):
                vy, vx = 0.35 + 0.05 * k, cx + 0.04 * np.sin(k + 3 * f)
                hu[(yy - vy) ** 2 + (xx - vx) ** 2 < 0.0001] = \
                    180.0 if contrast else 30.0
        hu[(yy - 0.45) ** 2 + (xx - 0.5) ** 2 < 0.003] = \
            300.0 if contrast else 45.0
        hu[(np.abs(xx - 0.5) < 0.05) & (yy > 0.76) & body] = 650.0
        hu += rng.normal(0.0, 12.0, hu.shape).astype(np.float32)
        vol[i] = np.clip(hu + 1024.0, 0, 4095).astype(np.int16)
    return vol


def run_engine_phase(k1, k2, dev, records):
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
    from ducosy_tpu_torch.models.convert import init_generator_state_dict

    st = init_generator_state_dict(SEED + 10)
    lung = init_generator_state_dict(SEED + 11)
    vol = chest_phantom(SLICES, SIZE, SEED)
    n_chunks = -(-SLICES // N)

    def engine(dtype, trunk):
        return DualGeneratorEngine(st, lung, img_size=SIZE,
                                   compute_dtype=dtype, device=dev,
                                   trunk=trunk)

    def run(eng):
        t0 = time.perf_counter()
        out = eng.run_patient(vol, 1.0, -1024.0, chunk=N)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fast = engine(torch.bfloat16, "chain")
    run(fast)                                 # warm-up: cuDNN autotune etc.
    k1.residual_chain.launches = 0
    k2.instance_norm.launches = 0
    out_fast, _ = run(fast)                   # the main path, counted
    launches = {"residual_chain": k1.residual_chain.launches,
                "instance_norm": k2.instance_norm.launches}
    want = {"residual_chain": 2 * 3 * n_chunks,
            "instance_norm": 2 * 2 * n_chunks}
    log(f"engine bf16 chain: launches {launches} (expected {want})")
    if launches != want:
        fail(f"serving path launch counts {launches} != {want}")
    if out_fast.dtype != np.int16 or out_fast.shape != vol.shape:
        fail(f"engine output {out_fast.dtype} {out_fast.shape}")
    records["launches"] = launches

    plain = engine(torch.bfloat16, "plain")
    run(plain)
    rounds = {"chain": [], "plain": []}
    for _ in range(3):                        # alternate the two paths
        for name, eng in (("chain", fast), ("plain", plain)):
            rounds[name].append(SLICES / run(eng)[1])
    for name, rates in rounds.items():
        log(f"engine bf16 {name}: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk {N},"
            f" incl. upload, postprocess, download)")
    records["slices_per_s"] = {k: statistics.median(v)
                               for k, v in rounds.items()}
    del plain

    out32, _ = run(engine(torch.float32, "chain"))
    ref32, t32 = run(engine(torch.float32, "plain"))
    d = np.abs(out32.astype(np.int32) - ref32.astype(np.int32))
    share = float(np.mean(d <= 1))
    log(f"engine fp32 chain vs fp32 plain: |d|<=1 on {share:.6f} of voxels, "
        f"max |d| {int(d.max())} stored units")
    if share < STORED_UNIT_SHARE:
        fail(f"fp32 kernel path vs plain: {share} < {STORED_UNIT_SHARE}")
    dhu = np.abs(out_fast.astype(np.float64) - ref32.astype(np.float64))
    log(f"engine bf16 chain vs fp32 plain: |dHU| mean {dhu.mean():.4f} p99 "
        f"{np.percentile(dhu, 99):.4f} max {dhu.max():.1f}")
    return st, lung


def code_agreement(got, ref):
    """(share equal, max |d|) of two int8 tensors of one shape."""
    import torch

    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"codes {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} "
             f"{ref.dtype}")
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    return float((d == 0).float().mean()), int(d.max())


def check_k1q(k1, dev, records):
    import torch
    import torch.nn.functional as F

    from ducosy_tpu_torch.ops.quant import quantize_weights_int8

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, hw, _, c = K1_SHAPE
    r = c // 16
    x = torch.randn((n, c, hw, hw), generator=gen, device=dev)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1) \
        .contiguous()
    was = torch.randn((3, 3, 3, c, c), generator=gen, device=dev) * 0.02
    wbs = torch.randn((3, 3, 3, c, c), generator=gen, device=dev) * 0.02
    rest = (torch.randn((3, c, r), generator=gen, device=dev) * 0.1,
            torch.randn((3, r, c), generator=gen, device=dev) * 0.1,
            torch.randn((3, 7, 7, 2, 1), generator=gen, device=dev) * 0.1)
    wq, ws = (torch.stack(t) for t in zip(*(quantize_weights_int8(w)
                                            for w in wbs)))
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        carry = xp.to(dtype)
        for k in (3, 1):
            args = (carry, was[:k], wq[:k], *(w[:k] for w in rest))
            for pad in (1, 0):
                kw = dict(pad=pad, quant=True, wb_scales=ws[:k])
                tp = torch.empty(carry.shape, dtype=torch.int8, device=dev)
                got = k1.residual_chain(*args, tp=tp, **kw)
                ref = k1.residual_chain_plain(*args, **kw)
                torch.cuda.synchronize()
                tname = dname if k == 1 else "bfloat16"
                atol, rtol = K1Q_TOL[tname]
                ok, emax, emean = compare(got, ref, atol, rtol)
                ok = ok and emean <= K1Q_MEAN_TOL[tname]
                line = (f"K1q k={k} pad={pad} {tuple(carry.shape)} {dname}: "
                        f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol},"
                        f" rtol {rtol}, mean {K1Q_MEAN_TOL[tname]})")
                rec = dict(max_abs_err=emax)
                if k == 1:
                    share, dmax = code_agreement(
                        tp, k1.quant_intermediate_plain(carry, was[0]))
                    line += f"; t codes equal {share:.6f}, max step {dmax}"
                    ok = ok and share >= CODE_SHARE and dmax <= 1
                    rec["code_share"] = share
                if pad == 1 or k == 3:
                    ms = cuda_ms(lambda: k1.residual_chain(*args, **kw), 3)
                    plain_ms = cuda_ms(
                        lambda: k1.residual_chain_plain(*args, **kw), 3)
                    bf_ms = cuda_ms(lambda: k1.residual_chain(
                        carry, was[:k], wbs[:k], *(w[:k] for w in rest),
                        pad=pad), 3)
                    line += (f" K1q {ms:.3f} ms, K1 (same dtype, no quant) "
                             f"{bf_ms:.3f} ms, plain {plain_ms:.3f} ms")
                    rec.update(ms=ms, plain_ms=plain_ms, k1_ms=bf_ms)
                records[("k1q", k, pad, dname)] = rec
                log(line + (" ok" if ok else " FAIL"))
                if not ok:
                    failures.append(f"K1q k={k} pad={pad} {dname}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def check_k2p(k2, dev, records):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    failures = []
    shape = K2_CASES[1][1]                   # down2 (N, 128, 128, 256)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev)
         * (torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5)
         + torch.randn(c, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
    got = k2.instance_norm_int8(x, pad=1)
    ref = k2.instance_norm_int8_plain(x, pad=1)
    torch.cuda.synchronize()
    share, dmax = code_agreement(got, ref)
    ok = share >= CODE_SHARE and dmax <= 1
    ms = cuda_ms(lambda: k2.instance_norm_int8(x, pad=1), 20)
    plain_ms = cuda_ms(lambda: k2.instance_norm_int8_plain(x, pad=1), 20)
    log(f"K2 int8 {tuple(shape)} pad=1 bfloat16: codes equal {share:.6f}, "
        f"max step {dmax} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"{'ok' if ok else 'FAIL'}")
    records["k2_int8"] = dict(max_abs_err=float(dmax), code_share=share,
                              ms=ms, plain_ms=plain_ms)
    if not ok:
        failures.append("K2 int8")
    c = K2P_SHAPE[-1]
    base = (torch.randn(K2P_SHAPE, generator=gen, device=dev)
            * (torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5)
            + torch.randn(c, generator=gen, device=dev) * 2.0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        x = base.to(dtype)
        kw = dict(relu=True, pad=0, phases=4)
        got = k2.instance_norm(x, **kw)
        ref = k2.instance_norm_plain(x, **kw)
        torch.cuda.synchronize()
        atol, rtol = TOL[("k2", dname)]
        ok, emax, emean = compare(got, ref, atol, rtol)
        ms = cuda_ms(lambda: k2.instance_norm(x, **kw), 20)
        plain_ms = cuda_ms(lambda: k2.instance_norm_plain(x, **kw), 20)
        log(f"K2 phases=4 {tuple(x.shape)} {dname}: max|d|={emax:.3e} "
            f"mean|d|={emean:.3e} (atol {atol}, rtol {rtol}) kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        records[("k2p", dname)] = dict(max_abs_err=emax, ms=ms,
                                       plain_ms=plain_ms)
        if not ok:
            failures.append(f"K2 phases {dname}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def check_tap_probe(tap, dev, records):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    m, k, n = PROBE_SHAPE
    a8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    b8 = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    a16 = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b16 = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    failures = []
    for taps in (9, 36):
        for name, a, b in (("int8", a8, b8), ("bf16", a16, b16)):
            got = tap.tap_matmul(a, b, taps)
            ref = tap.tap_matmul_plain(a, b, taps)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max())
            ok = bool(torch.equal(got, ref)) if name == "int8" else \
                err <= PROBE_BF16_RTOL * float(ref.abs().max())
            ms = cuda_ms(lambda: tap.tap_matmul(a, b, taps), 20)
            plain_ms = cuda_ms(lambda: tap.tap_matmul_plain(a, b, taps), 20)
            tops = 2.0 * m * k * n * taps / (ms * 1e-3) / 1e12
            log(f"P3 {name} ({m},{k})x({k},{n}) x{taps}: max|d|={err:.3e} "
                f"({'exact' if name == 'int8' else 'rel 1e-4 of max'}) "
                f"kernel {ms:.4f} ms = {tops:.1f} TOP/s, plain {plain_ms:.4f}"
                f" ms {'ok' if ok else 'FAIL'}")
            records[("p3", name, taps)] = dict(max_abs_err=err, ms=ms,
                                               plain_ms=plain_ms, tops=tops)
            if not ok:
                failures.append(f"P3 {name} x{taps}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def dhu_stats(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(np.percentile(d, 99)), float(d.max())


def run_quant_engine_phase(k1, k2, k4, dev, st, lung, records):
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_chunks = -(-SLICES // N)

    def engine(quant, trunk="chain"):
        return DualGeneratorEngine(st, lung, img_size=SIZE,
                                   compute_dtype=torch.bfloat16, device=dev,
                                   trunk=trunk, quant=quant)

    def run(eng):
        t0 = time.perf_counter()
        out = eng.run_patient(vol, 1.0, -1024.0, chunk=N)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    counters = {"residual_chain": k1.residual_chain,
                "instance_norm": k2.instance_norm,
                "instance_norm_int8": k2.instance_norm_int8,
                "block_tail": k4.block_tail}

    def counted(eng):
        run(eng)                              # warm-up: cuDNN autotune etc.
        for f in counters.values():
            f.launches = 0
        out, _ = run(eng)                     # the main path, counted
        got = {k: f.launches for k, f in counters.items()}
        if out.dtype != np.int16 or out.shape != vol.shape:
            fail(f"quant engine output {out.dtype} {out.shape}")
        return out, got

    ref = engine(None)
    ref_out, _ = run(ref)
    engines = {"bf16": ref}
    for quant in ("trunk", "full"):
        eng = engines[quant] = engine(quant)
        out, got = counted(eng)
        want = {"residual_chain": 2 * 3 * n_chunks,
                "instance_norm": 2 * (2 if quant == "trunk" else 1) * n_chunks,
                "instance_norm_int8": 0, "block_tail": 0}
        log(f"engine quant={quant} bf16 chain: launches {got} (expected "
            f"{want})")
        if got != want:
            fail(f"quant={quant} launch counts {got} != {want}")
        records[("launches", quant)] = got
        final = dhu_stats(out, run(ref)[0])
        sub = vol[:N]
        raw_ref = ref.generate_batch(sub, 1.0, -1024.0)
        raw_q = eng.generate_batch(sub, 1.0, -1024.0)
        raw = dhu_stats(
            np.concatenate([raw_q[k].ravel() for k in ("st_stored",
                                                        "lung_stored")]),
            np.concatenate([raw_ref[k].ravel() for k in ("st_stored",
                                                          "lung_stored")]))
        if not all(np.isfinite(raw_q[k]).all() for k in raw_q):
            fail(f"quant={quant}: non-finite generate_batch output")
        log(f"engine quant={quant} vs bf16 engine: raw tap (generate_batch "
            f"st/lung stored, {N} slices) |dHU| mean {raw[0]:.4f} p99 "
            f"{raw[1]:.4f} max {raw[2]:.1f}; final tap (run_patient) |dHU| "
            f"mean {final[0]:.4f} p99 {final[1]:.4f} max {final[2]:.1f}")
        records[("fidelity", quant)] = dict(raw=raw, final=final)
        if final[0] > QUANT_MEAN_DHU_MAX:
            fail(f"quant={quant}: final-tap mean |dHU| {final[0]} > "
                 f"{QUANT_MEAN_DHU_MAX}")
    rounds = {k: [] for k in engines}
    for _ in range(3):                        # alternate the three modes
        for name, eng in engines.items():
            rounds[name].append(SLICES / run(eng)[1])
    for name, rates in rounds.items():
        log(f"engine {name} chain: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk {N},"
            f" bf16 compute, incl. upload, postprocess, download)")
    records["quant_slices_per_s"] = {k: statistics.median(v)
                                     for k, v in rounds.items()}
    del engines, ref

    tail = engine("trunk", trunk="tail")
    out, got = counted(tail)
    want = {"residual_chain": 0, "instance_norm": 0,
            "instance_norm_int8": 2 * BLOCKS * n_chunks,
            "block_tail": 2 * BLOCKS * n_chunks}
    final = dhu_stats(out, ref_out)
    log(f"engine quant=trunk tail trunk: launches {got} (expected {want}); "
        f"final tap vs the bf16 chain engine |dHU| mean {final[0]:.4f} p99 "
        f"{final[1]:.4f} max {final[2]:.1f}")
    if got != want:
        fail(f"tail + quant launch counts {got} != {want}")
    if final[0] > QUANT_MEAN_DHU_MAX:
        fail(f"tail + quant: final-tap mean |dHU| {final[0]} > "
             f"{QUANT_MEAN_DHU_MAX}")
    del tail
    # the int8 convs' im2col blocks go back before the training phase
    torch.cuda.empty_cache()
    records[("launches", "tail")] = got


def run_cli_phase(k1, k2, st, lung, flags=()):
    import torch

    from ducosy_tpu.dicom import dcmread
    from ducosy_tpu.dicom.codec import new_ct_dataset
    from ducosy_tpu_torch.cli import generate

    vol = chest_phantom(SLICES, SIZE, SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        ncct = Path(tmp, "input", "Smoke", "patient00", "POST VUE")
        ncct.mkdir(parents=True)
        for i, sl in enumerate(vol):
            ds = new_ct_dataset(SIZE, SIZE, instance_number=i + 1,
                                series_description="POST VUE")
            ds.set_pixel_array(sl.astype(np.uint16))
            ds.save_as(str(ncct / f"{i:04d}.dcm"))
        paths = {}
        for name, sd in (("st", st), ("lung", lung)):
            paths[name] = str(Path(tmp, f"{name}.pth"))
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       paths[name])
        k1.residual_chain.launches = 0
        k2.instance_norm.launches = 0
        t0 = time.perf_counter()
        done = generate.main([
            "--input_dir_root", str(Path(tmp, "input")),
            "--output_dir_root", str(Path(tmp, "output")),
            "--dataset_names", "Smoke", "--img_size", str(SIZE),
            "--slice_batch", str(N), "--soft_tissue_model", paths["st"],
            "--lung_model", paths["lung"], *flags])
        secs = time.perf_counter() - t0
        n_chunks = -(-SLICES // N)
        got = (k1.residual_chain.launches, k2.instance_norm.launches)
        if done != 1 or got != (2 * 3 * n_chunks, 2 * 2 * n_chunks):
            fail(f"CLI: {done} patients, launches {got}")
        out_dir = Path(tmp, "output", "Smoke", "patient00")
        files = sorted(out_dir.glob("*.dcm"))
        if len(files) != SLICES:
            fail(f"CLI wrote {len(files)} slices, expected {SLICES}")
        for f in (files[0], files[-1]):
            ds = dcmread(str(f))
            if ds.pixel_array.shape != (SIZE, SIZE) or \
                    ds.SeriesDescription != "DuCoSyGAN sCECT v2":
                fail(f"CLI output {f.name}: {ds.pixel_array.shape} "
                     f"{ds.SeriesDescription!r}")
    log(f"CLI {' '.join(flags) or '(bf16)'}: 1 patient, {SLICES} slices "
        f"written and read back in {secs:.2f} s (incl. engine build), "
        f"launches K1 {got[0]} K2 {got[1]}")


def compare_stats(got, ref):
    """(max |d|, mean |d|, relative L2 error) of two tensors in fp32."""
    import torch

    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail("non-finite kernel output")
    d = (g - r).abs()
    return (float(d.max()), float(d.mean()),
            float(torch.linalg.vector_norm(g - r)
                  / torch.linalg.vector_norm(r).clamp_min(1e-30)))


def check_training_kernels(k2, k4, dev, records):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, hw, _, c = TRAIN_SHAPE
    r = c // 16
    rand = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std

    def act():
        return rand(*TRAIN_SHAPE) * (rand(c).abs() + 0.5) + rand(c) * 2.0

    failures = []
    # ---- K3: the backward of each block's first norm (ReLU, pad 1)
    x, g = act(), rand(n, hw + 2, hw + 2, c)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        xd, gd = x.to(dtype), g.to(dtype)
        got = k2.instance_norm_bwd(xd, gd, relu=True, pad=1)
        ref = k2.instance_norm_bwd_plain(xd, gd, relu=True, pad=1)
        torch.cuda.synchronize()
        x32 = xd.float()
        xc = x32 - x32.mean(dim=(1, 2), keepdim=True)
        y = xc * torch.rsqrt(xc.square().mean(dim=(1, 2), keepdim=True) + 1e-5)
        keep = y.abs() > RELU_EDGE
        atol, rtol = TRAIN_TOL[("k3", dname)]
        ok, emax, emean = compare(got[keep], ref[keep], atol, rtol)
        ms = cuda_ms(lambda: k2.instance_norm_bwd(xd, gd, relu=True, pad=1), 10)
        plain_ms = cuda_ms(lambda: k2.instance_norm_bwd_plain(
            xd, gd, relu=True, pad=1), 10)
        log(f"K3 {tuple(xd.shape)} pad=1 relu {dname}: max|d|={emax:.3e} "
            f"mean|d|={emean:.3e} (atol {atol}, rtol {rtol}; "
            f"{int((~keep).sum())} elements at the ReLU edge left out) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        records[("k3", dname)] = dict(max_abs_err=emax, ms=ms,
                                      plain_ms=plain_ms)
        if not ok:
            failures.append(f"K3 {dname}")
    del x, g, xd, gd, got, ref, x32, xc, y, keep

    # ---- K4 / K5: the block tail and its backward
    h, xp = act(), rand(n, hw + 2, hw + 2, c)
    w1, w2, wsa = rand(c, r, std=0.1), rand(r, c, std=0.1), \
        rand(7, 7, 2, 1, std=0.1)
    for pad, x_pad in TAIL_CASES:
        g = rand(n, hw + 2 * pad, hw + 2 * pad, c)
        x = xp if x_pad else xp[:, 1:-1, 1:-1].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            hd, xd, gd = h.to(dtype), x.to(dtype), g.to(dtype)
            kw = dict(pad=pad, x_pad=x_pad)
            got = k4.block_tail(hd, xd, w1, w2, wsa, **kw)
            ref = k4.block_tail_plain(hd, xd, w1, w2, wsa, **kw)
            torch.cuda.synchronize()
            atol, rtol = TRAIN_TOL[("k4", dname)]
            ok, emax, emean = compare(got, ref, atol, rtol)
            if dtype == torch.bfloat16 and emean > K4_BF16_MEAN_TOL:
                ok = False
            ms = cuda_ms(lambda: k4.block_tail(hd, xd, w1, w2, wsa, **kw), 10)
            plain_ms = cuda_ms(lambda: k4.block_tail_plain(
                hd, xd, w1, w2, wsa, **kw), 10)
            log(f"K4 pad={pad} x_pad={x_pad} {tuple(hd.shape)} {dname}: "
                f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol}, rtol "
                f"{rtol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"{'ok' if ok else 'FAIL'}")
            records[("k4", pad, dname)] = dict(max_abs_err=emax, ms=ms,
                                               plain_ms=plain_ms)
            if not ok:
                failures.append(f"K4 pad={pad} {dname}")

            got = k4.block_tail_bwd(hd, gd, w1, w2, wsa, **kw)
            ref = k4.block_tail_bwd_plain(hd, gd, w1, w2, wsa, **kw)
            torch.cuda.synchronize()
            tol, worst, parts = K5_TOL[dname], 0.0, []
            for name, a, b in zip(("dh", "dx", "dw1", "dw2", "dwsa"), got,
                                  ref):
                emax, emean, rel = compare_stats(a, b)
                scale = float(b.float().abs().max())
                if name == "dx" and dtype == torch.bfloat16:
                    good = compare(a, b, 1e-2, 1e-2)[0]
                elif dtype == torch.float32:
                    good = rel <= tol and emax <= tol * scale
                else:
                    good = rel <= tol
                if name == "dh":
                    worst = emax
                parts.append(f"{name} max|d|={emax:.3e} mean|d|={emean:.3e} "
                             f"relL2={rel:.2e}{'' if good else ' FAIL'}")
                if not good:
                    failures.append(f"K5 pad={pad} {dname} {name}")
            ms = cuda_ms(lambda: k4.block_tail_bwd(hd, gd, w1, w2, wsa, **kw),
                         5)
            plain_ms = cuda_ms(lambda: k4.block_tail_bwd_plain(
                hd, gd, w1, w2, wsa, **kw), 5)
            log(f"K5 pad={pad} x_pad={x_pad} {dname}: " + "; ".join(parts)
                + f" (tol {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            records[("k5", pad, dname)] = dict(max_abs_err=worst, ms=ms,
                                               plain_ms=plain_ms)
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def write_training_tree(root: Path) -> None:
    """TRAIN_PATIENTS synthetic patients of TRAIN_SLICES 512^2 slices: a
    NCCT series and a CECT series with an enhanced aorta and vessels."""
    from ducosy_tpu.dicom.codec import new_ct_dataset

    for p in range(TRAIN_PATIENTS):
        for series, contrast in (("POST VUE", False), ("POST STD", True)):
            vol = chest_phantom(TRAIN_SLICES, SIZE, SEED + 20 + p, contrast)
            d = root / "Smoke" / f"patient{p:02d}" / series
            d.mkdir(parents=True)
            for i, sl in enumerate(vol):
                ds = new_ct_dataset(SIZE, SIZE, instance_number=i + 1,
                                    series_description=series)
                ds.set_pixel_array(sl.astype(np.uint16))
                ds.save_as(str(d / f"{i:04d}.dcm"))


def run_training_phase(k2, k4, records):
    from ducosy_tpu_torch.cli import train

    counters = (k2.instance_norm, k2.instance_norm_bwd, k4.block_tail,
                k4.block_tail_bwd)
    names = ("instance_norm", "instance_norm_bwd", "block_tail",
             "block_tail_bwd")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_training_tree(Path(tmp, "data"))
        # the kernel trunk as a user runs it, the plain trunk from the same
        # init and batches, and the kernel trunk under remat, which the
        # plain trunk needs on this card (its step falls back to it)
        for trunk, remat in (("tail", "auto"), ("plain", "auto"),
                             ("tail", "on")):
            for f in counters:
                f.launches = 0
            t0 = time.perf_counter()
            out = train.main([
                "--data_root", str(Path(tmp, "data")),
                "--dataset_names", "Smoke",
                "--training_dir", str(Path(tmp, f"run_{trunk}_{remat}")),
                "--img_size", str(SIZE), "--batch_size", str(TRAIN_N),
                "--num_residual_blocks", str(BLOCKS), "--epochs", "1",
                "--max_steps_per_epoch", str(TRAIN_STEPS), "--resume", "",
                "--num_workers", "8", "--trunk", trunk, "--remat", remat])
            out = out["soft_tissue"]
            secs = time.perf_counter() - t0
            launches = dict(zip(names, (f.launches for f in counters)))
            losses = {k: v for k, v in out.items() if k.startswith("loss")
                      or k in ("contrast", "val_loss")}
            if not all(np.isfinite(v) for v in losses.values()):
                fail(f"training ({trunk}): non-finite losses {losses}")
            steps = out["step_seconds"]
            if len(steps) != TRAIN_STEPS:
                fail(f"training ({trunk}): {len(steps)} steps run")
            results[(trunk, remat)] = out
            log(f"training {trunk} remat={remat}: {TRAIN_STEPS} steps + "
                f"validation in {secs:.1f} s; step seconds "
                f"{[round(t, 3) for t in steps]}; ended in remat "
                f"{out['remat']} (fallback {out['oom_fallback']}); peak "
                f"memory {out['peak_memory_bytes'] / 2**30:.2f} GiB; "
                f"launches {launches}; losses {losses}")
            if trunk == "tail":
                # per generator forward: K2 and K4 once per block; K3, K5 in
                # each backward; remat recomputes every forward of the G
                # step; validation runs 2 x 6 forwards without gradients
                fwd = 6 * BLOCKS * TRAIN_STEPS
                rerun = 2 if out["remat"] == "on" else 1
                val = 2 * 6 * BLOCKS
                want = {"instance_norm": fwd * rerun + val,
                        "instance_norm_bwd": fwd,
                        "block_tail": fwd * rerun + val,
                        "block_tail_bwd": fwd}
                if out["oom_fallback"] or launches != want:
                    fail(f"training launch counts {launches} != {want} "
                         f"(remat fallback: {out['oom_fallback']})")
                if remat == "auto":
                    records["train_launches"] = launches
            elif any(launches.values()):
                fail(f"the plain trunk launched kernels: {launches}")
    first = {k: v["first_metrics"]["loss_G"] for k, v in results.items()}
    med = {k: statistics.median(v["step_seconds"][1:])
           for k, v in results.items()}
    tail, plain = first[("tail", "auto")], first[("plain", "auto")]
    log(f"training first-step loss_G: tail {tail:.6f} plain {plain:.6f} "
        f"diff {tail - plain:.3e} (same init and batch, bf16)")
    log("training s/step (median of steps 2-" + str(TRAIN_STEPS) + ", batch "
        f"{TRAIN_N} x {SIZE}^2, bf16, {BLOCKS} blocks, SOFT_TISSUE): "
        + ", ".join(f"{t} remat={results[(t, r)]['remat']} {m:.4f}"
                    for (t, r), m in med.items()))
    records["s_per_step"] = med

def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA card")
    if not (ROOT / "ducosy_tpu_torch" / "__init__.py").is_file():
        fail(f"ducosy_tpu_torch/ not found beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    # fp32 means fp32 in every comparison below (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    from ducosy_tpu_torch.ops.kernels import _build
    from ducosy_tpu_torch.ops.kernels import block_tail as k4
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2
    from ducosy_tpu_torch.ops.kernels import residual_chain as k1
    from ducosy_tpu_torch.ops.kernels import tap_probe

    sources = ("instance_norm", "residual_chain", "instance_norm_bwd",
               "block_tail", "block_tail_bwd", "tap_probe")
    t0 = time.perf_counter()
    _build.build_all(sources)          # one nvcc per source, all at once
    log(f"built {len(sources)} sources in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        _build.load_library(name)
        log(f"  {name}.cu -> {_build.library_path(name).name}")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or ("spill" in line and
                                       "0 bytes spill stores" not in line):
                log(f"  nvcc: {line.strip()}")

    records: dict = {}
    check_instance_norm(k2, dev, records)
    check_residual_chain(k1, dev, records)
    check_k1q(k1, dev, records)
    check_k2p(k2, dev, records)
    check_tap_probe(tap_probe, dev, records)
    st, lung = run_engine_phase(k1, k2, dev, records)
    run_quant_engine_phase(k1, k2, k4, dev, st, lung, records)
    run_cli_phase(k1, k2, st, lung)
    run_cli_phase(k1, k2, st, lung, flags=("--quant", "trunk"))
    check_training_kernels(k2, k4, dev, records)
    run_training_phase(k2, k4, records)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("JAX was imported")

    train = records["train_launches"]
    kernels = [
        dict(name="residual_chain", route="cuda",
             source="ducosy_tpu_torch/csrc/residual_chain.cu",
             replaces="ducosy_tpu/ops/pallas/conv_in.py:399",
             launches=records["launches"]["residual_chain"],
             **records[("k1", 3, 1, "bfloat16")]),
        dict(name="instance_norm", route="cuda",
             source="ducosy_tpu_torch/csrc/instance_norm.cu",
             replaces="ducosy_tpu/ops/pallas/instance_norm.py:206",
             launches=records["launches"]["instance_norm"],
             **records[("k2", "down2", "bfloat16")]),
        dict(name="instance_norm_bwd", route="cuda",
             source="ducosy_tpu_torch/csrc/instance_norm_bwd.cu",
             replaces="ducosy_tpu/ops/pallas/instance_norm.py:297",
             launches=train["instance_norm_bwd"],
             **records[("k3", "bfloat16")]),
        dict(name="block_tail", route="cuda",
             source="ducosy_tpu_torch/csrc/block_tail.cu",
             replaces="ducosy_tpu/ops/pallas/cbam_block.py:108",
             launches=train["block_tail"], **records[("k4", 1, "bfloat16")]),
        dict(name="block_tail_bwd", route="cuda",
             source="ducosy_tpu_torch/csrc/block_tail_bwd.cu",
             replaces="ducosy_tpu/ops/pallas/cbam_block.py:272",
             launches=train["block_tail_bwd"],
             **records[("k5", 1, "bfloat16")]),
    ]
    quant = records[("launches", "trunk")]
    kernels += [
        dict(name="residual_chain (K1q, quant=True)", route="cuda",
             source="ducosy_tpu_torch/csrc/residual_chain.cu",
             replaces="ducosy_tpu/ops/pallas/conv_in.py:399",
             launches=quant["residual_chain"],
             **pick(records[("k1q", 3, 1, "bfloat16")])),
        dict(name="instance_norm (K2 int8 write)", route="cuda",
             source="ducosy_tpu_torch/csrc/instance_norm.cu",
             replaces="ducosy_tpu/ops/pallas/instance_norm.py:206",
             launches=records[("launches", "tail")]["instance_norm_int8"],
             **pick(records["k2_int8"])),
        dict(name="instance_norm (K2 phases=4)", route="cuda",
             source="ducosy_tpu_torch/csrc/instance_norm.cu",
             replaces="ducosy_tpu/ops/pallas/instance_norm.py:206",
             launches=0, **pick(records[("k2p", "bfloat16")])),
        dict(name="tap_probe (P3, int8, 9 taps)", route="cuda",
             source="ducosy_tpu_torch/csrc/tap_probe.cu",
             replaces="scripts/probe_int8_mosaic.py:38",
             launches=0, **pick(records[("p3", "int8", 9)])),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
