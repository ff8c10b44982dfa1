#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ducosy_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ducosy_tpu_torch/csrc with nvcc and
drives the serving path the way a user does, at full model width:

  1. the card (nvidia-smi name, power limit), torch/CUDA versions, and the
     kernel build time with nvcc's register/spill report;
  2. K2 (instance_norm) against its plain PyTorch version at the serving
     shapes: down1 = up1 (16, 256, 256, 128) pad 0, down2 (16, 128, 128,
     256) pad 1, the stem = up2 (16, 512, 512, 64) pad 0, the training
     trunk's (8, 128, 128, 256) pad 1, a ragged (3, 75, 93, 64) pad 1 and
     C = 192, in fp32 and bf16, with max |diff|, CUDA-event times, the
     bound and one F.instance_norm + relu; then K2 by parts at down1, down2
     and the stem (bf16): the original three launches and the kernel with
     parts left out, without overlapping launches and in groups that fit
     the L2, in alternating rounds;
  3. K1 (residual_chain) against its plain version on a (16, 130, 130, 256)
     carry: k = 3 and k = 1, pad 1 and pad 0, fp32 and bf16;
  4. two seeded ResNet-9 + CBAM generators (1 channel, base 64) in
     DualGeneratorEngine.run_patient (forward="module", trunk "chain") on a
     32-slice 512^2 chest phantom with chunk 16: the launch counters must
     show every K1 and K2 call of the serving path; fp32 through the
     kernels must match the fp32 plain path to 1 stored unit on >= 99.9% of
     voxels; the bf16 kernel path's |dHU| to the fp32 plain path and both
     paths' slices/s are printed; every phase that measures the module
     forward names forward="module" (4, 4q, 4m, 4k's and 4kq's reference,
     8k's module engines, 10s, 10p's module reference) or a module trunk
     (7, 7r, 10t: --trunk tail|plain), or gen_forward="module" (10q);
  5. the port's generate CLI on one synthetic 32-slice 512^2 DICOM patient
     with .pth checkpoints, read back from disk: its engine, built with no
     forward (the CLI has no flag for it), serves packed chain3 on the
     card, as the JAX engine does on its accelerator: exact packed launch
     counts (K1 12, K2 20 of which 12 with phases > 1);
  6. the training kernels against their plain versions at the training
     shapes (N = 8): K3 (instance_norm_bwd: K2's statistics launch, the
     gradient sums, the apply, on K2's tile plan) on x (8, 128, 128, 256),
     pad 1, ReLU, and at (3, 75, 93, 64) pad 1 and (2, 50, 70, 192) pad 0
     without ReLU, fp32 and bf16, also held against the original five
     launches (probe_bwd design 0) and at the training shape timed beside
     them in alternating rounds with each time's share of the bound; then
     "6 parts K3": K3 by parts (the original launches, the kernel's three
     launches alone, the whole without programmatic dependent launch) and
     its parts against the batch size, by CUDA-graph replay;
     K4 (block_tail) and K5 (block_tail_bwd) on h (8, 128, 128, 256)
     with pad 1 / x_pad 1 and pad 0 / x_pad 1, and at (2, 50, 70, 128) and
     (2, 50, 70, 192); fp32 and bf16, with max and mean |diff|. Every K4/K5
     case prints and checks its route (resident: one cooperative launch;
     tiled: the original launches); at a resident case it is also held against
     the tiled route, and at the training shape timed beside it in
     alternating rounds; then "6 parts": K4 and K5 by parts on both routes
     at the training shape, bf16;
  3q. quantized serving's kernels against their plain versions: K1q
     (residual_chain quant=True) on the (16, 130, 130, 256) carry, k = 3
     and 1, pad 1 and 0, bf16 and fp32, with the share of int8 t codes
     that agree (k = 1); K2's int8 write (16, 128, 128, 256) pad 1 bf16
     (code agreement) and its phase pooling (16, 128, 128, 512), 4 phases,
     bf16 and fp32; P3 (tap_probe) at (16384, 256) x (256, 256) with 9 and
     36 taps, int8 exact and bf16 within PROBE_BF16_RTOL, the kernel and
     its original mma.sync / WMMA kernels against the plain version, with
     one library call held to the same reference (torch._int_mm; torch.mm
     for bf16), the three timed in alternating rounds by CUDA events and by
     CUDA-graph replay, and the int8 / bf16 rate on wgmma; "3q P3 parts":
     P3 by parts (loads, MMAs, store) by CUDA-graph replay;
  4q. the engine at quant="trunk" and quant="full" (bf16, chain trunk, the
     phase-4 generators and phantom): exact K1q and K2 launch counts,
     slices/s beside the bf16 chain path, and both fidelity taps against
     the bf16 engine (generate_batch stored outputs; run_patient); then
     trunk="tail" at quant="trunk" with exact K2-int8 and K4 counts and its
     slices/s with K4 on its route and on the tiled one (3% slack);
  5q. the generate CLI with --quant trunk (packed chain3 at quant
     "trunk", its exact launch counts), read back from disk;
  2k. K2 with phases at the packed forward's three phase-pooled norms: the
     stem (16, 256, 256, 256) and up1 (16, 128, 128, 512) with phases 4,
     up2 (16, 128, 128, 1024) with phases 16, bf16 and fp32, against the
     plain version, timed beside it and its bound;
  4k. the engine built with no forward and no trunk (the default; it must
     resolve to packed chain3) and forward="packed" at mega, mono, pallas
     and xla (bf16, the phase-4 generators and phantom): exact launch
     counts (chain3: K1 12, K2 20 of which 12 with phases > 1), each series
     against the module forward's (|dHU| mean / p99 / max, share within 1
     stored unit; a mean above 25 HU fails), the default's also against
     phase 4's bf16 module series, the fp32 default against fp32 module
     plain (1 stored unit on 99.9%), slices/s in rounds that alternate the
     module forward and the five trunks, one profiled patient of the
     default;
  4kq. forward="packed" at quant="trunk" and "full" under chain3 and under
     xla (the XLA trunk's per-sample dynamic requant): exact counts, raw
     and final taps against the bf16 module engine (phase 4q's bound),
     slices/s in alternating rounds;
  8k. a seeded generator pair without CBAM through the module forward
     (trunk "auto": plain), the module forward with fused_norm (the 18
     trunk norms on K2: 72 launches a patient) and the engine built with
     no forward (packed, nominal chain3, run on its XLA trunk): exact
     counts, fp32 series within 1 stored unit of the plain module forward
     on 99.9%, bf16 |dHU|, slices/s;
  7. the port's training CLI on a synthetic 512^2 chest-phantom patient
     tree with mask generation at SOFT_TISSUE (3 input channels): 9 blocks,
     base 64, batch 8, bf16, trunk="tail", 7 steps (s/step: the median of
     the 6 after the first). The launch counters
     must show exactly the K2, K3, K4 and K5 calls of those steps and of the
     validation pass (K3 54 a step: 6 generator backwards x 9 blocks), and
     every loss must be finite. The same steps then run
     with trunk="plain" from the same init and batches; both first-step
     losses, their difference, s/step, the peak memory and the remat mode
     are printed. A named trunk trains on the module forward (the loop's
     summary names the forward it ran).

  7k. phase 7's tree through the training CLI with no --gen_forward and no
     --trunk (CBAM, remat off, 7 steps): the loop resolved the packed step,
     finite losses, K2-K5 54 launches a step as the tail trunk's, s/step
     and peak memory beside phase 7's tail run; then a SOFT_TISSUE range
     without CBAM with fused_norm (the module forward, trunk "plain", 3
     steps): K2 108 and K3 108 launches a step, no K4/K5.

  3m. K7 (conv3x3_in) and K8 (conv_block_tail), the mega trunk's kernels,
     against their plain versions on (16, 130, 130, 256), fp32 and bf16: K7
     pad 1 with and without the int8 write (code agreement) and once on an
     int8 input; K8 pad 1 and 0, x_pad 1, with and without int8 taps. Every
     case prints the route it took (resident: one cooperative launch with
     the accumulator held in registers; tiled: the accumulator through
     device memory) and fails if that is not the route its shape gives; at
     this shape the bf16 and int8 cases must run resident on a card that
     holds a sample's 128 blocks, and are timed beside the tiled launches
     they replace in alternating rounds (phases 3 and 3q likewise for K1
     and K1q);
  3r. K7 and K8 once more at ragged shapes, interiors (2, 50, 70, 128),
     (2, 50, 70, 192), (1, 20, 24, 512) and (1, 142, 130, 256): the pixels
     do not fill the last tile, the widths take the conv loop's 128- and
     64-channel tiles, the int8 loop's 64-byte rows, and two 256-channel
     tiles side by side (K8 tiled beside K7 resident), and the last has
     more tiles than the card has SMs, so both kernels run tiled there;
  3c. the conv loop alone (conv3x3, the tiled launch K1, K6, K7 and K8
     share) on (16, 130, 130, 256): the bf16 loop's fp32 accumulator and
     per-tile partials against the fp32 conv of the same bf16 values, the
     int8 loop exact, TFLOP/s and TOP/s, beside one F.conv2d (bf16,
     channels_last); the loop and the resident K7 and K8 kernels by parts
     (the loop, the barriers and merges, the epilogue compiled out);
  3p. the P1/P2 prototypes (ops/kernels/proto_conv_in.py): each wrapper
     against its plain version at the shapes its bench runs, (8 and 32, 130,
     130, 256) bf16 and n = 8 fp32; then the script's parity and its A/B
     bench at n = 8 and 32;
  4m. the engine at trunk="mega" (bf16, the phase-4 generators and phantom):
     exact K7, K8 and K2 launch counts, fp32 mega against fp32 plain,
     slices/s in rounds that alternate mega, mega on the tiled route, chain
     and plain (a routed rate more than 3% below its tiled reading fails;
     phases 4 and 4q likewise), a profile of one patient that fails if a
     kernel of the tiled route's light passes or K2's original launches ran
     under a resident trunk or K2's two kernels ran other than once a call,
     then quant="trunk" and "full" under mega with counts, slices/s beside
     the chain trunk's and both fidelity taps against the bf16 engine;
  8. the generate CLI serves phase 7's trained 3-channel SOFT_TISSUE
     snapshot with a seeded 2-channel LUNG generator on one synthetic 512^2
     DICOM patient, masks generated and prefetched on the host, on its
     default engine (packed chain3, exact counts): read back from disk and
     equal to run_patient of an engine built as the CLI builds it;
  7r. phase 7's tail run saved as the reference's checkpoint.pth.tar
     (trainer.py:580-596, with scheduler states), imported into a fresh
     state on the card (networks and Adam states bit for bit), then the
     training CLI resumed from it for one step in phase 7's run directory:
     the epoch continues at saved + 1, every Adam step count at saved + 1,
     finite losses, and K2-K5 launches a step equal to phase 7's;
  9w. the generate CLI with --write_working on phase 5's patient (bf16,
     the phase-4 generators): packed chain3's exact launch counts,
     raw/ equal to the source series, soft_tissue/ and lung/ equal to the
     generate_batch outputs it downloaded cast to the series dtype, and
     the final series within 1 stored unit of phase 5's on >= 99.9% of
     voxels;
  9a. the same with --synthesis_mode additive: "sCECT v3", held against
     the port's additive_composite + synthesize_volume on the CPU from the
     same downloaded outputs (1 stored unit, 99.9%);
  9p. each of the six postprocess methods on 9w's merged volume on the
     card and on the CPU (1 stored unit, 99.9%), with its CUDA-event time;
  9e. the calculate CLI (--fast --num_workers 2) on the card and with
     --device cpu, on a tree of the phantom (POST VUE), the phantom with
     contrast (POST STD) and 9w's final series, with seeded LPIPS weights
     through $DUCOSY_LPIPS_WEIGHTS: host metrics equal, MS-SSIM within
     1e-5, LPIPS within rtol 2e-4, both wall times, and the card time of
     MS-SSIM and of LPIPS for the 32-slice patient.

  11. the masking workflow on 9e's tree, a TotalSegmentator stand-in
     (written into the run's directory, first on the PATH of the CLI's
     workers) deriving labels from the input HU, heart 51 with a blob
     beyond a z gap: masking --stage generate -> modify_heart_mask (the
     blob cut) -> masking --stage masking (each masked series has the
     exclusion mask's voxel count at 9999 and the source elsewhere) ->
     calculate --mask on the card and with --device cpu (9e's rule; the
     scores differ from 9e's unmasked ones) -> anonymize and anonymize
     --mask (the mapping rows, the volumes); the generate stage without the
     binary (each patient reports it, the stage returns); visualize and
     mask_preview where PIL imports; each step's wall time, the share of
     voxels masked;
  12. the aux model: train_nmodel (NModelConfig defaults: standard UNet3D,
     base 16, (1, 512, 512) patches, batch 1, lr 5e-5, clip 1.0, fp32) for
     20 steps over 2 epochs on a phantom diff tree (finite losses and
     validation L1, both checkpoints, the running statistics moved); 6
     timed steps (the median of the 5 after the first, peak memory);
     load_model on a checkpoint predicting what the saved module predicts,
     exactly; predict_volume on phase 4's phantom, card against CPU within
     NM_PREDICT_TOL_HU, slices/s; one step and one prediction of
     UNet3DLight.

  13. the masking CLI's in-process segmenter (infer/segment.py) at
     TotalSegmentator's 3d_fullres widths (6 stages of 32 to 320
     channels, 25 classes, 128^3 patches, 4 a forward, bf16): K2's 3-D
     route (instance_norm3d) against its plain version at (4, 128, 128,
     128, 32), (4, 8, 8, 8, 320) and (4, 4, 4, 4, 320), bf16, affine,
     LeakyReLU 0.01 (1 bf16 ulp), its CUDA-event time beside its bytes
     bound; then one 248-slice 512^2 phantom patient (0.7 mm pixels, 1 mm
     slices: 165 x 239 x 239 at 1.5 mm, 18 patches) after a warm-up, the
     launch counter reset just before it: 22 K2 3-D launches a forward (5
     forwards) and no 2-D K2 launch, uint8 labels at the series grid below
     25, and the patient's wall time;
  10t. the data-parallel training step: two ranks on this card over gloo
     (NCCL refuses two ranks on one device), spawned by
     ``parallel.launch`` and each taking 4 rows of phase 7's tree, against
     one rank of 8, from the same seeded init, 3 steps, full width, bf16,
     tail trunk, remat off: the ranks' parameters equal after every step,
     the first step's losses, the first step's gradient and the update's
     relative L2 over the weights, K2-K5 54 launches a step on each rank,
     seconds a step; the card's free memory is logged before spawning;
  10s. the engine with ``mesh=data_mesh(devices=[cuda:0, cuda:0])`` (two
     replicas on this card) on phase 4's patient, bf16 module chain, chunk
     16 in parts of 8: K1 24 and K2 40 launches, the series against one device
     called on the same parts and against phase 4's series, fp32 replicas
     against one fp32 device, slices/s;
  10p. the (data, sp) mesh serving: the engine on data_sp_mesh(1, 2) and
     (2, 2) of this card listed 2 and 4 times, phase 4's generators and
     patient: "auto" resolves to packed/xla; no kernel launches (the JAX
     package runs none under sp); fp32 within 1 stored unit of the
     single-device packed/xla engine on >= 99.9% of voxels; bf16 |dHU|
     against it; the module forward (plain trunk) once; slices/s beside
     packed/xla's and the peak memory of a patient;
  10q. the (data, sp) training step on (1, 2) of this card: one fp32 step,
     remat on, batch 8 of phase 7's tree, against the single-device plain
     step from the same init (losses within rtol 2e-4, every parameter
     within 4 lr), no kernel launches; bf16 s/step (steps 6-7 of 7) and
     peak memory, beside the single-device plain step;
  10n. with two cards or more: 10t and 10s on cuda:0 and cuda:1 over NCCL,
     10p and 10q on a (1, 2) mesh across them, and both CLIs with
     --num_devices 2; on one card it prints that it was not run.

Any failure exits non-zero before the result lines. On success the last
three lines are the card, a JSON object with one record per kernel, and
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a CUDA device, and outside a checkout of the repo.
Imports nothing of JAX and nothing of the JAX package (ducosy_tpu).
"""
from __future__ import annotations

import contextlib
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
# P3 by parts: (label, parts) of tap_probe.probe's design 1, the kernel
# with parts compiled out (1 the operands' loads, 2 the MMAs, 4 the store)
P3_PARTS = (("whole", 7), ("load", 1), ("MMAs", 2), ("store", 4),
            ("load + MMAs", 3))
QUANT_MEAN_DHU_MAX = 25.0

# K7 / K8 (the mega trunk's two kernels), tolerances set before any run:
#  K7 fp32: exact-FMA conv vs cuDNN fp32 (TF32 off), fp32 statistics on
#    both sides, one conv deep: |d| <= 1e-4 + 1e-4 |ref|.
#  K7 bf16: the plain version rounds the conv output to bf16 before its
#    norm, the kernel normalizes the fp32 accumulator and rounds once: two
#    bf16 ulps, |d| <= 0.0625 + 0.02 |ref|, mean |d| <= 0.01.
#  K7 int8 write (bf16 and fp32 input) and K7 on an int8 input with int8
#    weights (exact int32 taps on both sides): both quantize the fp32
#    normalized value of the same accumulator up to summation order: codes
#    equal on >= 99.9%, never more than one step apart.
#  K8 fp32: one block's second half, fp32 throughout: |d| <= 1e-3 + 1e-3
#    |ref| (the K1 fp32 bound). K8 bf16: the K1 bf16 bound (the plain
#    version rounds the conv output to bf16 before the tail's norm).
#  K8 in_int8: kernel and plain version read the same int8 tp; the plain
#    version dequantizes before the norm, the kernel normalizes the int32
#    accumulator: fp32 within the one-block K1q bound (1e-2, mean 1e-4),
#    bf16 within the K1 bf16 bound.
#  P1/P2 (K7 and K8 without the int8 modes) at their bench's shapes: the
#    K7 and K8 bounds above, bf16 means included.
#  P1/P2 parity (fp32, n=2, 32^2, C=128): max |d| < 1e-3, as the TPU script.
#  Engine, trunk="mega": exact launch counts; fp32 mega within 1 stored unit
#    of fp32 plain on >= 99.9% of voxels; quant final-tap mean |dHU| <= 25.
K7_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.0625, 0.02)}
K7_BF16_MEAN_TOL = 0.01
K8_TOL = {"float32": TOL[("k1", "float32")], "bfloat16": TOL[("k1", "bfloat16")]}
K8_BF16_MEAN_TOL = K1_BF16_MEAN_TOL

# The conv loop alone, tolerances set before any run:
#  bf16: kernel and reference sum the same exact products of bf16 values in
#    fp32, in another order (2304 terms): |d| <= 1e-3 + 1e-2 |ref|; the
#    per-tile partials of the accumulator: mean within 1e-4, max within
#    1e-3, M2 within 1e-3 relative of the tile's largest M2.
#  int8: the int32 sums are exact, and both sides convert them to fp32 the
#    same way: equal.
CONV_TOL = (1e-3, 1e-2)
RAGGED_SHAPES = ((2, 50, 70, 128), (2, 50, 70, 192), (1, 20, 24, 512),
                 (1, 142, 130, 256))     # the last: 140 tiles, more than SMs

# Published dense peaks of one H100 SXM (NVIDIA's data sheet): the bound of
# a kernel is the larger of its operations over the peak of their type and
# its bytes (each input read once, each output written once) over the
# memory rate.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def bound(nbytes: float, **ops) -> dict:
    """bound_ms / bound_by from the bytes moved and the operations by type
    (bf16= and int8= on the tensor cores, fp32= on the CUDA cores)."""
    t_ops = sum(v / PEAK_OPS[k] for k, v in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes")


def conv_flop(n: int, hw: int, c: int) -> float:
    """Operations of one 3x3 conv on (n, hw, hw, c -> c)."""
    return 2.0 * n * hw * hw * 9 * c * c


TRAIN_N = 8                      # training batch
TRAIN_SHAPE = (TRAIN_N, 128, 128, 256)   # trunk activation; R = C / 16
# K2 (name, shape, pad): the serving norms (down1 = up1; stem = up2), the
# training trunk's first norm of a block, a ragged H*W (6975 pixels in 28
# statistics tiles of 250: the last holds 225) at C = 64, and C = 192 (a
# block of 21 pixels x 24 lanes: 504 of its 512 threads own channels)
K2_CASES = (("down1", (N, 256, 256, 128), 0), ("down2", (N, 128, 128, 256), 1),
            ("stem", (N, 512, 512, 64), 0), ("train", TRAIN_SHAPE, 1),
            ("ragged", (3, 75, 93, 64), 1), ("c192", (2, 50, 70, 192), 0))
# K2 by parts (phase 2) at these shapes, bf16: (label, design, parts, plan)
# through k2.probe. Design 0 is the original three launches (bit 1 the tile
# statistics, 2 the serial finalize, 4 the per-pixel apply); design 1 the
# kernel (1 the tile statistics, 2 their merge, 4 the apply), design 2 the
# kernel without programmatic dependent launch. Plans: the kernel's own
# (None: the batch at once, x read twice) or "L2" (groups of samples within
# L2_SHARE of the L2, x read once if the L2 holds a group).
K2_PART_CASES = ("down1", "down2", "stem")
L2_SHARE = 0.7
K2_PROBES = (("original: whole", 0, 7, None), ("tile statistics", 0, 1, None),
             ("finalize", 0, 2, None), ("per-pixel apply", 0, 4, None),
             ("groups in L2: whole", 1, 7, "L2"),
             ("groups in L2 without PDL: whole", 2, 7, "L2"),
             ("whole", 1, 7, None), ("whole without PDL", 2, 7, None),
             ("tile statistics alone", 1, 1, None),
             ("statistics and their merge", 1, 3, None),
             ("apply alone", 1, 4, None))
# K2 calls of one generator call on the serving path: the stem, down1,
# down2 (with the pad), up1 and up2 norms; under quant="full" down2's alone
K2_PER_GEN = {None: 5, "trunk": 5, "full": 1}
TAIL_CASES = ((1, 1), (0, 1))    # (pad, x_pad): blocks 1-8, block 9
# K3 (shape, relu, pad): each training block's first norm, and ragged
# shapes on the same tile plan: 6975 pixels in 28 tiles of 250 that span
# rows, the last one part full, pad 1 and ReLU; C = 192 (21 pixel rows x 24
# lanes a block), relu off and pad 0
K3_CASES = ((TRAIN_SHAPE, True, 1), ((3, 75, 93, 64), True, 1),
            ((2, 50, 70, 192), False, 0))
K3_ROUNDS = 3
# K3 by parts ("6 parts") at TRAIN_SHAPE, bf16, pad 1, ReLU: (label, design,
# parts) through k2.probe_bwd. Design 0 is the original five launches (bit 1
# the 128 x 64 tile statistics and their serial finalize, 2 the tile
# gradient sums and their serial merge, 4 the per-pixel apply); design 1 the
# kernel (1 K2's statistics launch, 2 the gradient sums, each with its
# last-block merge, 4 the apply), design 2 the kernel without programmatic
# dependent launch.
K3_SWEEP = (2, 4, 8, 16, 32)     # batch sizes of the by-parts sweep
K3_PROBES = (("original: whole", 0, 7),
             ("original: statistics + finalize", 0, 1),
             ("original: sums + merge", 0, 2),
             ("original: per-pixel apply", 0, 4),
             ("whole", 1, 7), ("whole without PDL", 2, 7),
             ("statistics alone", 1, 1), ("sums alone", 1, 2),
             ("apply alone", 1, 4))
# K4/K5 at ragged shapes: resident (two samples side by side, 28 tiles, the
# last one part full) and tiled (C = 192)
TAIL_OTHER_SHAPES = ((2, 50, 70, 128), (2, 50, 70, 192))
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
# 8 train patients + 1 val: 8 batches of 8 slices, 7 steps (6 timed after
# the first: four steps could not show a 15% change)
TRAIN_PATIENTS, TRAIN_SLICES, TRAIN_STEPS = 9, 8, 7
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


def gpu_state() -> str:
    """SM clock and power draw now, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
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


@contextlib.contextmanager
def tiled_route(k1, k7):
    """For measurement only: inside, the card is taken to hold no
    co-resident block, so K7, K8, K1, K4 and K5 run the tiled launches that
    the resident kernels replace on this card."""
    from ducosy_tpu_torch.ops.kernels import block_tail as k4

    saved = k7.resident_blocks, k1.resident_blocks, k4.resident_blocks
    k7.resident_blocks = k1.resident_blocks = lambda device: 0
    k4.resident_blocks = lambda device, backward=False: 0
    try:
        yield
    finally:
        k7.resident_blocks, k1.resident_blocks, k4.resident_blocks = saved


def route_rounds(k1, k7, fn, iters: int, rounds: int = 3) -> dict:
    """Median ms of ``fn`` on the route its shape takes and on the tiled
    route, in rounds that alternate the two."""
    ms = {"routed": [], "tiled": []}
    for _ in range(rounds):
        ms["routed"].append(cuda_ms(fn, iters))
        with tiled_route(k1, k7):
            ms["tiled"].append(cuda_ms(fn, iters))
    return {k: statistics.median(v) for k, v in ms.items()}


def expect_route(k7, what: str, took: str, shape, dtype, dev, *,
                 tail: bool = False) -> str:
    """The route a call took must be the one its shape gives; returns it."""
    n, h, w, c = shape
    want = k7.conv_route(h, w, c, dtype, k7.resident_blocks(dev), tail=tail)
    if took != want:
        fail(f"{what}: took the {took} route, its shape gives {want}")
    return took


def expect_tail_route(k4, what: str, took: str, shape, dtype, dev, *,
                      backward: bool) -> str:
    """The route a K4 (K5) call took must be the one its shape gives."""
    n, h, w, c = shape
    want = k4.tail_route(h, w, c, dtype, k4.resident_blocks(dev, backward))
    if took != want:
        fail(f"{what}: took the {took} route, its shape gives {want}")
    return took


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


def k2_input(shape, gen, dev):
    """Per-channel offset and scale around unit noise, fp32."""
    import torch

    c = shape[-1]
    offset = torch.randn(c, generator=gen, device=dev) * 2.0
    scale = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
    return torch.randn(shape, generator=gen, device=dev) * scale + offset


def k2_bound(shape, pad: int, itemsize: int):
    """K2's bound: x read once, the padded output written once, 8 fp32
    operations an element."""
    n, h, w, c = shape
    inner = n * h * w * c
    out = n * (h + 2 * pad) * (w + 2 * pad) * c * itemsize
    return bound(inner * itemsize + out, fp32=8 * inner)


def k3_bound(shape, pad: int, itemsize: int):
    """K3's bound: x and the padded cotangent read once, dx written once,
    16 fp32 operations an element."""
    n, h, w, c = shape
    inner = n * h * w * c
    g = n * (h + 2 * pad) * (w + 2 * pad) * c
    return bound((2 * inner + g) * itemsize, fp32=16 * inner)


def check_instance_norm(k2, dev, records):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []
    for name, shape, pad in K2_CASES:
        base = k2_input(shape, gen, dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            x = base.to(dtype)
            got = k2.instance_norm(x, relu=True, pad=pad)
            ref = k2.instance_norm_plain(x, relu=True, pad=pad)
            torch.cuda.synchronize()
            atol, rtol = TOL[("k2", dname)]
            ok, emax, emean = compare(got, ref, atol, rtol)
            ms = cuda_ms(lambda: k2.instance_norm(x, relu=True, pad=pad), 20)
            plain_ms = cuda_ms(
                lambda: k2.instance_norm_plain(x, relu=True, pad=pad), 20)
            # the library's call for the same function without the pad:
            # timed here as a yardstick, used nowhere in the port
            xc = x.permute(0, 3, 1, 2)
            lib_ms = cuda_ms(lambda: F.relu(F.instance_norm(xc)), 20)
            bnd = k2_bound(shape, pad, x.element_size())
            pl = k2.device_plan(x)
            share = bnd["bound_ms"] / ms
            log(f"K2 {name} {tuple(shape)} pad={pad} {dname} [group "
                f"{pl.group}, {pl.tiles} tiles of {pl.tile} pixels, "
                f"{pl.blocks} blocks]: max|d|={emax:.3e} mean|d|={emean:.3e} "
                f"(atol {atol}, rtol {rtol}) kernel {ms:.4f} ms = {share:.0%}"
                f" of its bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                f"plain {plain_ms:.4f} ms, F.instance_norm + relu"
                f"{' (no pad)' if pad else ''} {lib_ms:.4f} ms "
                f"{'ok' if ok else 'FAIL'}")
            records[("k2", name, dname)] = dict(
                max_abs_err=emax, ms=ms, plain_ms=plain_ms,
                library_ms=None if pad else lib_ms, bound=bnd)
            if not ok:
                failures.append(f"K2 {name} {dtype}")
        del base, x, got, ref, xc
    torch.cuda.empty_cache()
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def k2_probe_plan(k2, x, variant):
    """The plan of a K2_PROBES row for x."""
    import torch

    pl = k2.device_plan(x)
    if variant != "L2":
        return pl
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    return k2.plan(*x.shape, x.element_size(), pl.blocks, int(L2_SHARE * l2))


def check_k2_parts(k2, dev, records, designs=(0, 1, 2)):
    """K2 by parts at K2_PART_CASES, bf16: the K2_PROBES rows of ``designs``,
    median of 3 rounds that alternate every row. A part alone that reads
    what another part writes reads stale scratch: its time is right, its
    output is not."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = [r for r in K2_PROBES if r[1] in designs]
    for name, shape, pad in K2_CASES:
        if name not in K2_PART_CASES:
            continue
        x = k2_input(shape, gen, dev).to(torch.bfloat16)
        plans = {v: k2_probe_plan(k2, x, v) for *_, v in rows}
        rounds = {r[0]: [] for r in rows}
        for _ in range(3):
            for label, d, parts, v in rows:
                rounds[label].append(cuda_ms(
                    lambda: k2.probe(x, d, parts, pad=pad, pl=plans[v]), 10))
        ms = {k: statistics.median(v) for k, v in rounds.items()}
        records[("k2parts", name)] = ms
        log(f"K2 {name} {tuple(shape)} pad={pad} bf16 by parts (median of 3 "
            "alternating rounds; the original launches, then the kernel): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        del x
        torch.cuda.empty_cache()


def check_residual_chain(k1, dev, records):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, hw, _, c = K1_SHAPE
    r = c // 16
    x = torch.randn((n, c, hw, hw), generator=gen, device=dev)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1) \
        .contiguous()
    from ducosy_tpu_torch.ops.kernels import conv_in as k7

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
                route = chain_route(k1, k7, f"K1 {dname}", K1_SHAPE, dtype,
                                    dev)
                line = (f"K1 k={k} pad={pad} {tuple(carry.shape)} {dname} "
                        f"[{route}]: max|d|={emax:.3e} mean|d|={emean:.3e} "
                        f"(atol {atol}, rtol {rtol})")
                if pad == 1 or k == 3:
                    ms = cuda_ms(lambda: k1.residual_chain(carry, *ws,
                                                           pad=pad), 3)
                    plain_ms = cuda_ms(lambda: k1.residual_chain_plain(
                        carry, *ws, pad=pad), 3)
                    line += f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                    rec = records[("k1", k, pad, dname)] = dict(
                        max_abs_err=emax, ms=ms, plain_ms=plain_ms)
                    if route == "resident" and pad == 1:
                        rec["rounds"] = rr = route_rounds(
                            k1, k7, lambda: k1.residual_chain(carry, *ws,
                                                              pad=pad), 3)
                        line += (f"; alternating rounds: resident "
                                 f"{rr['routed']:.3f} ms, tiled "
                                 f"{rr['tiled']:.3f} ms")
                log(line + (" ok" if ok else " FAIL"))
                if not ok:
                    failures.append(f"K1 k={k} pad={pad} {dname}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def chain_route(k1, k7, what: str, shape, dtype, dev) -> str:
    """The route the last K1 call took ("mixed": K7's half resident, K8's
    tiled), checked against what its shape gives each half."""
    n, h, w, c = shape
    blocks = k7.resident_blocks(dev)
    halves = {k7.conv_route(h, w, c, dtype, blocks, tail=t) for t in (False,
                                                                      True)}
    want = halves.pop() if len(halves) == 1 else "mixed"
    if k1.residual_chain.route != want:
        fail(f"{what}: took the {k1.residual_chain.route} route, its shape "
             f"gives {want}")
    return want


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


def run_engine_phase(k1, k2, dev, st, lung, records):
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_chunks = -(-SLICES // N)

    def engine(dtype, trunk):
        return DualGeneratorEngine(st, lung, img_size=SIZE,
                                   compute_dtype=dtype, device=dev,
                                   forward="module", trunk=trunk)

    def run(eng):
        t0 = time.perf_counter()
        out = eng.run_patient(vol, 1.0, -1024.0, chunk=N)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fast = engine(torch.bfloat16, "chain")
    run(fast)                                 # warm-up: cuDNN autotune etc.
    k1.residual_chain.launches = 0
    k2.instance_norm.launches = 0
    k1.conv3x3.launches = 0
    out_fast, _ = run(fast)                   # the main path, counted
    launches = {"residual_chain": k1.residual_chain.launches,
                "instance_norm": k2.instance_norm.launches,
                "conv3x3": k1.conv3x3.launches}
    want = {"residual_chain": 2 * 3 * n_chunks,
            "instance_norm": 2 * K2_PER_GEN[None] * n_chunks,
            "conv3x3": 2 * 2 * BLOCKS * n_chunks}
    log(f"engine bf16 chain: launches {launches} (expected {want})")
    if launches != want:
        fail(f"serving path launch counts {launches} != {want}")
    if out_fast.dtype != np.int16 or out_fast.shape != vol.shape:
        fail(f"engine output {out_fast.dtype} {out_fast.shape}")
    records["launches"] = launches

    from ducosy_tpu_torch.ops.kernels import conv_in as k7

    plain = engine(torch.bfloat16, "plain")
    run(plain)
    with tiled_route(k1, k7):
        run(fast)                             # warm the tiled route
    rounds = {"chain": [], "chain, tiled route": [], "plain": []}
    for _ in range(3):                        # alternate the paths
        for name, eng in (("chain", fast), ("chain, tiled route", fast),
                          ("plain", plain)):
            with tiled_route(k1, k7) if "tiled" in name else \
                    contextlib.nullcontext():
                rounds[name].append(SLICES / run(eng)[1])
    for name, rates in rounds.items():
        log(f"engine bf16 {name}: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk {N},"
            f" incl. upload, postprocess, download)")
    records["slices_per_s"] = {k: statistics.median(v)
                               for k, v in rounds.items()}
    check_not_slower("bf16 chain", records["slices_per_s"], "chain")
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
    return out_fast


# a serving rate on the routed path may read this far below the same run's
# tiled-route reading (rounds spread by ~1%; a first round can read 4% low)
RATE_SLACK = 0.97


def check_not_slower(label: str, rates: dict, name: str) -> None:
    """Fail if the median slices/s of ``name`` is below RATE_SLACK of the
    same engine's reading on the tiled route."""
    routed, tiled = rates[name], rates[f"{name}, tiled route"]
    log(f"engine {label}: {name} {routed:.2f} slices/s, on the tiled route "
        f"{tiled:.2f} ({100 * (routed / tiled - 1):+.1f}%)")
    if routed < RATE_SLACK * tiled:
        fail(f"engine {label}: {routed:.2f} slices/s on the routed path, "
             f"{tiled:.2f} on the tiled route")


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
    from ducosy_tpu_torch.ops.kernels import conv_in as k7

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
                route = chain_route(k1, k7, f"K1q {dname}", K1_SHAPE, dtype,
                                    dev)
                line = (f"K1q k={k} pad={pad} {tuple(carry.shape)} {dname} "
                        f"[{route}]: max|d|={emax:.3e} mean|d|={emean:.3e} "
                        f"(atol {atol}, rtol {rtol}, mean "
                        f"{K1Q_MEAN_TOL[tname]})")
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
                    if route == "resident" and pad == 1:
                        rec["rounds"] = rr = route_rounds(
                            k1, k7, lambda: k1.residual_chain(*args, **kw), 3)
                        line += (f"; alternating rounds: resident "
                                 f"{rr['routed']:.3f} ms, tiled "
                                 f"{rr['tiled']:.3f} ms")
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
    x = k2_input(shape, gen, dev).to(torch.bfloat16)
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
    base = k2_input(K2P_SHAPE, gen, dev)
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


def p3_operands(dev):
    """The probe's int8 and bf16 operands at PROBE_SHAPE, from the seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    m, k, n = PROBE_SHAPE
    a8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    b8 = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    a16 = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b16 = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    return (("int8", a8, b8), ("bf16", a16, b16))


def p3_library(a, b, taps: int):
    """One library call of the same value and work, the taps laid along K:
    (m, taps k) x (taps k, n), torch._int_mm for int8, torch.mm with an fp32
    out for bf16. Returns (fn, its name)."""
    import torch

    at, bt = a.repeat(1, taps), b.repeat(taps, 1)
    if a.dtype == torch.int8:
        return (lambda: torch._int_mm(at, bt)), "torch._int_mm"
    return (lambda: torch.mm(at, bt, out_dtype=torch.float32)), \
        "torch.mm(out_dtype=float32)"


def p3_agrees(got, ref, name: str) -> tuple[bool, float]:
    """(agrees, max |d|): int8 exact; bf16 max |d| <= PROBE_BF16_RTOL
    max |ref|."""
    import torch

    err = float((got.double() - ref.double()).abs().max())
    if name == "int8":
        return bool(torch.equal(got, ref)), err
    return err <= PROBE_BF16_RTOL * float(ref.abs().max()), err


def check_tap_probe(tap, dev, records):
    """Phase 3q P3: the kernel and the original kernels (tap.probe design 0)
    against the plain version, int8 exact and bf16 within PROBE_BF16_RTOL, at
    9 and 36 taps; the library call held to the same reference; then the
    kernel, the original kernels and the library call timed in 3 rounds that
    alternate them, by CUDA events (back-to-back calls: the host's work a
    call shows) and, the kernels, by CUDA-graph replay (the device's time;
    not the library call: a cuBLAS call captured from a new side stream
    leaves a workspace allocated for that stream, which later phases' peak
    memory would count). The rate loop of int8 and bf16 at 9 taps is the
    probe's own path: its launches go on the kernels line."""
    import torch

    m, k, n = PROBE_SHAPE
    failures = []
    for taps in (9, 36):
        for name, a, b in p3_operands(dev):
            got = tap.tap_matmul(a, b, taps)
            old = tap.probe(a, b, taps, 0)
            ref = tap.tap_matmul_plain(a, b, taps)
            lib, lib_name = p3_library(a, b, taps)
            torch.cuda.synchronize()
            ok, err = p3_agrees(got, ref, name)
            ok_old, err_old = p3_agrees(old, ref, name)
            ok_lib, err_lib = p3_agrees(lib(), ref, name)
            if not ok_lib:
                fail(f"P3 {name} x{taps}: {lib_name} differs from the "
                     f"reference by {err_lib:.3e}")
            before = tap.tap_matmul.launches
            cuda_ms(lambda: tap.tap_matmul(a, b, taps), 20)
            launches = tap.tap_matmul.launches - before
            plain_ms = cuda_ms(lambda: tap.tap_matmul_plain(a, b, taps), 20)
            calls = {"kernel": lambda: tap.tap_matmul(a, b, taps),
                     "original": lambda: tap.probe(a, b, taps, 0),
                     "library": lib}
            rounds = {}
            for _ in range(3):
                for label, fn in calls.items():
                    rounds.setdefault((label, "events"), []).append(
                        cuda_ms(fn, 20))
                    if label != "library":
                        rounds.setdefault((label, "graph"), []).append(
                            graph_ms(fn))
            t = {key: statistics.median(v) for key, v in rounds.items()}
            ops = 2.0 * m * k * n * taps
            rec = records[("p3", name, taps)] = dict(
                max_abs_err=err, ms=t[("kernel", "events")],
                graph_ms=t[("kernel", "graph")],
                original_ms=t[("original", "events")],
                original_graph_ms=t[("original", "graph")],
                library_ms=t[("library", "events")], plain_ms=plain_ms,
                launches=launches,
                tops=ops / (t[("kernel", "graph")] * 1e-3) / 1e12)
            tol = "exact" if name == "int8" else "rel 1e-4 of max"
            log(f"P3 {name} ({m},{k})x({k},{n}) x{taps}: max|d|={err:.3e}, "
                f"original max|d|={err_old:.3e}, {lib_name} max|d|="
                f"{err_lib:.3e} ({tol}); median of 3 alternating rounds, "
                "events / graph replay: "
                + ", ".join(f"{label} {t[(label, 'events')]:.4f} / "
                            f"{t[(label, 'graph')]:.4f} ms"
                            for label in ("kernel", "original"))
                + f", library {t[('library', 'events')]:.4f} ms; plain "
                f"{plain_ms:.4f} ms; kernel {rec['tops']:.1f} "
                f"TOP/s by graph replay; {launches} launches "
                f"{'ok' if ok and ok_old else 'FAIL'}")
            if not (ok and ok_old):
                failures.append(f"P3 {name} x{taps}")
            del got, old, ref
    for taps in (9, 36):
        i8, b16 = records[("p3", "int8", taps)], records[("p3", "bf16", taps)]
        log(f"P3 x{taps}: int8 / bf16 rate on wgmma (graph replay) "
            f"{b16['graph_ms'] / i8['graph_ms']:.3f}x; the original kernels' "
            f"{b16['original_graph_ms'] / i8['original_graph_ms']:.3f}x")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def check_tap_parts(tap, dev, records):
    """P3 by parts at PROBE_SHAPE, 9 and 36 taps, both dtypes: the whole
    kernel, its operand loads alone, its MMAs on (unloaded) resident
    operands alone, its store alone and the loads with the MMAs (tap.probe
    design 1); CUDA-graph replay, median of 3 rounds that alternate every
    row. A part alone computes nothing meaningful: its time is right, its
    output is not."""
    import torch

    for taps in (9, 36):
        for name, a, b in p3_operands(dev):
            rows = {}
            for _ in range(3):
                for label, parts in P3_PARTS:
                    rows.setdefault(label, []).append(graph_ms(
                        lambda: tap.probe(a, b, taps, 1, parts)))
            med = {label: statistics.median(v) for label, v in rows.items()}
            records[("p3parts", name, taps)] = med
            log(f"P3 {name} x{taps} by parts (CUDA-graph replay, median of "
                "3 alternating rounds): " + ", ".join(
                    f"{label} {v:.4f} ms" for label, v in med.items()))
    torch.cuda.empty_cache()


def check_conv_in(k7, dev, records, shape=K1_SHAPE):
    """Phase 3m: K7 and K8 against their plain versions at the trunk shape
    (phase 3r: at a ragged ``shape``, the carry's interior)."""
    import torch
    import torch.nn.functional as F

    from ducosy_tpu_torch.ops.quant import (INT8_NORM_SCALE,
                                            quantize_weights_int8)

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n, h, w, c = shape
    r = c // 16
    x = torch.randn((n, c, h, w), generator=gen, device=dev)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1) \
        .contiguous()
    wa = torch.randn((3, 3, c, c), generator=gen, device=dev) * 0.02
    wb = torch.randn((3, 3, c, c), generator=gen, device=dev) * 0.02
    tail = (torch.randn((c, r), generator=gen, device=dev) * 0.1,
            torch.randn((r, c), generator=gen, device=dev) * 0.1,
            torch.randn((7, 7, 2, 1), generator=gen, device=dev) * 0.1)
    from ducosy_tpu_torch.ops.kernels import residual_chain as k1

    waq, _ = quantize_weights_int8(wa)
    wbq, wbs = quantize_weights_int8(wb)
    scratch = k7.make_scratch(n, h, w, c, dev)     # serves either route
    trunk = tuple(shape) == tuple(K1_SHAPE)
    failures = []

    def k7_route(name, xin):
        return expect_route(k7, name, k7.launch_conv3x3_in.route, shape,
                            xin.dtype, dev)

    def rounds(rec, route, fn):
        """At the trunk shape a resident kernel is timed beside the tiled
        launches it replaces, in alternating rounds."""
        if not (trunk and route == "resident"):
            return ""
        rec["rounds"] = rr = route_rounds(k1, k7, fn, 5)
        return (f"; alternating rounds: resident {rr['routed']:.3f} ms, "
                f"tiled {rr['tiled']:.3f} ms")

    def codes(name, got, ref, key, fn, plain_fn, xin):
        route = k7_route(name, xin)
        share, dmax = code_agreement(got, ref)
        ok = share >= CODE_SHARE and dmax <= 1
        ms, plain_ms = cuda_ms(fn, 5), cuda_ms(plain_fn, 3)
        rec = records[key] = dict(max_abs_err=float(dmax), code_share=share,
                                  ms=ms, plain_ms=plain_ms)
        log(f"{name} [{route}]: codes equal {share:.6f}, max step {dmax} "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            + rounds(rec, route, fn) + (" ok" if ok else " FAIL"))
        if not ok:
            failures.append(name)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        carry = xp.to(dtype)
        # ---- K7, pad 1: io-dtype write, then the int8 write
        got = k7.conv3x3_in(carry, wa, pad=1, scratch=scratch)
        route = k7_route(f"K7 {dname}", carry)
        ref = k7.conv3x3_in_plain(carry, wa, pad=1)
        torch.cuda.synchronize()
        atol, rtol = K7_TOL[dname]
        ok, emax, emean = compare(got, ref, atol, rtol)
        if dtype == torch.bfloat16 and emean > K7_BF16_MEAN_TOL:
            ok = False
        k7_fn = lambda: k7.conv3x3_in(carry, wa, pad=1, scratch=scratch)
        ms = cuda_ms(k7_fn, 5)
        plain_ms = cuda_ms(lambda: k7.conv3x3_in_plain(carry, wa, pad=1), 3)
        rec = records[("k7", dname)] = dict(max_abs_err=emax, ms=ms,
                                            plain_ms=plain_ms)
        log(f"K7 pad=1 {tuple(carry.shape)} {dname} [{route}]: "
            f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol}, rtol "
            f"{rtol}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            + rounds(rec, route, k7_fn) + (" ok" if ok else " FAIL"))
        if not ok:
            failures.append(f"K7 {dname}")
        kw = dict(pad=1, int8_scale=INT8_NORM_SCALE)
        t8 = k7.conv3x3_in(carry, wa, scratch=scratch, **kw)
        ref8 = k7.conv3x3_in_plain(carry, wa, **kw)
        torch.cuda.synchronize()
        codes(f"K7 int8 write pad=1 {dname}", t8, ref8, ("k7_int8", dname),
              lambda: k7.conv3x3_in(carry, wa, scratch=scratch, **kw),
              lambda: k7.conv3x3_in_plain(carry, wa, **kw), carry)
        if dtype == torch.bfloat16:
            # ---- K7 on an int8 input with int8 weights (not on the trunk)
            got = k7.conv3x3_in(t8, waq, scratch=scratch, **kw)
            ref = k7.conv3x3_in_plain(t8, waq, **kw)
            torch.cuda.synchronize()
            codes("K7 int8 input, int8 write pad=1", got, ref, "k7_in8",
                  lambda: k7.conv3x3_in(t8, waq, scratch=scratch, **kw),
                  lambda: k7.conv3x3_in_plain(t8, waq, **kw), t8)
        # ---- K8 on K7's outputs: pad 1 and 0, then int8 taps
        t = k7.conv3x3_in(carry, wa, pad=1, scratch=scratch)
        for in_int8 in (False, True):
            tp, w = (t8, wbq) if in_int8 else (t, wb)
            qkw = dict(in_int8=True, w_scale=wbs) if in_int8 else {}
            for pad in (1, 0):
                kw8 = dict(pad=pad, x_pad=1, **qkw)
                got = k7.conv_block_tail(tp, carry, w, *tail, scratch=scratch,
                                         **kw8)
                route = expect_route(
                    k7, f"K8 {dname}", k7.launch_conv_block_tail.route, shape,
                    dtype if dtype == torch.float32 else tp.dtype, dev,
                    tail=True)
                ref = k7.conv_block_tail_plain(tp, carry, w, *tail, **kw8)
                torch.cuda.synchronize()
                if in_int8:
                    atol, rtol = K1Q_TOL[dname]
                    mean_tol = K1Q_MEAN_TOL[dname]
                else:
                    atol, rtol = K8_TOL[dname]
                    mean_tol = K8_BF16_MEAN_TOL if dtype == torch.bfloat16 \
                        else float("inf")
                ok, emax, emean = compare(got, ref, atol, rtol)
                ok = ok and emean <= mean_tol
                k8_fn = lambda: k7.conv_block_tail(
                    tp, carry, w, *tail, scratch=scratch, **kw8)
                ms = cuda_ms(k8_fn, 5)
                plain_ms = cuda_ms(lambda: k7.conv_block_tail_plain(
                    tp, carry, w, *tail, **kw8), 3)
                rec = records[("k8", in_int8, pad, dname)] = dict(
                    max_abs_err=emax, ms=ms, plain_ms=plain_ms)
                log(f"K8 pad={pad} x_pad=1 in_int8={in_int8} {dname} "
                    f"[{route}]: max|d|={emax:.3e} mean|d|={emean:.3e} (atol "
                    f"{atol}, rtol {rtol}, mean {mean_tol}) kernel {ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms"
                    + (rounds(rec, route, k8_fn) if pad == 1 else "")
                    + (" ok" if ok else " FAIL"))
                if not ok:
                    failures.append(f"K8 pad={pad} int8={in_int8} {dname}")
    if trunk and k7.resident_blocks(dev) >= n_tiles(*shape[1:3]) and not all(
            "rounds" in records[key] for key in (
                ("k7", "bfloat16"), ("k7_int8", "bfloat16"), "k7_in8",
                ("k8", False, 1, "bfloat16"), ("k8", True, 1, "bfloat16"))):
        fail("the trunk shape did not take the resident route on a card "
             f"that holds {k7.resident_blocks(dev)} blocks at once")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def n_tiles(h: int, w: int) -> int:
    """128-pixel tiles of an (h, w) image (csrc/common.cuh TILE_M)."""
    return -(-h * w // 128)


def check_conv_loop(k7, dev, records):
    """Phase 3c: the conv launch that K1, K6, K7 and K8 share, alone."""
    import torch
    import torch.nn.functional as F

    from ducosy_tpu_torch.ops.quant import (INT8_NORM_SCALE, quantize_shifted,
                                            quantize_weights_int8)

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    n, hw, _, c = K1_SHAPE
    tm, tn = k7.tile_geometry()
    if (tm, tn) != (k7.TILE_M, k7.TILE_N):
        fail(f"tile geometry: the library has {(tm, tn)}, the wrappers "
             f"{(k7.TILE_M, k7.TILE_N)}")
    shape = (n, hw + 2, hw + 2, c)
    x16 = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, c, c), generator=gen, device=dev) * 0.02
    # int8 operands as the trunk has them: t on the shifted grid (ReLU'd, so
    # about half the codes are -128) and per-channel quantized weights
    x8 = quantize_shifted(torch.relu(x16.float()), INT8_NORM_SCALE)
    w8, _ = quantize_weights_int8(w)
    scratch = k7.make_scratch(n, hw, hw, c, dev)
    flop = conv_flop(n, hw, c)
    failures = []
    for name, xp, wt in (("bf16", x16, w), ("int8", x8, w8)):
        got = k7.conv3x3(xp, wt, scratch=scratch)
        ref = k7.conv3x3_plain(xp, wt).reshape(n, hw * hw, c)
        torch.cuda.synchronize()
        if name == "int8":
            ok = bool(torch.equal(got.acc, ref))
            emax = float((got.acc - ref).abs().max())
        else:
            ok, emax, _ = compare(got.acc, ref, *CONV_TOL)
        tiles = ref.reshape(n, -1, tm, c)
        mean = tiles.mean(dim=2)
        m2 = (tiles - mean[:, :, None]).square().sum(dim=2)
        dmean = float((got.partials[0] - mean).abs().max())
        dm2 = float((got.partials[1] - m2).abs().max() / m2.max())
        dmax = float((got.partials[2] - tiles.amax(dim=2)).abs().max())
        scale = float(ref.abs().max()) if name == "int8" else 1.0
        ok = ok and dmean <= 1e-4 * scale and dm2 <= 1e-3 \
            and dmax <= 1e-3 * scale
        ms = cuda_ms(lambda: k7.conv3x3(xp, wt, scratch=scratch), 20)
        plain_ms = cuda_ms(lambda: k7.conv3x3_plain(xp, wt), 3)
        rate = flop / (ms * 1e-3) / 1e12
        log(f"conv3x3 {name} {shape}: max|d|={emax:.3e} "
            f"({'exact' if name == 'int8' else 'atol 1e-3, rtol 1e-2'}); "
            f"partials mean {dmean:.2e} M2 rel {dm2:.2e} max {dmax:.2e}; "
            f"kernel {ms:.4f} ms = {rate:.1f} "
            f"{'TOP/s' if name == 'int8' else 'TFLOP/s'} (card after the "
            f"timing loop: {gpu_state()}), plain {plain_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        records[("conv", name)] = dict(max_abs_err=emax, ms=ms,
                                       plain_ms=plain_ms, rate=rate)
        if not ok:
            failures.append(f"conv3x3 {name}")
    # where the bf16 loop's time goes: the same launch with its store, its
    # statistics, both, or its MMAs compiled out, in alternating rounds
    modes = {7: "whole", 6: "no store", 5: "no statistics",
             4: "ring and MMAs, no epilogue", 0: "ring alone, no MMAs"}
    rounds = {m: [] for m in modes}
    for _ in range(3):
        for m in modes:
            rounds[m].append(cuda_ms(
                lambda: k7.conv3x3_probe(x16, w, m, scratch), 20))
    parts = {m: statistics.median(v) for m, v in rounds.items()}
    records[("conv", "parts")] = parts
    log("conv3x3 bf16 by parts (median of 3 alternating rounds): "
        + ", ".join(f"{name} {parts[m]:.4f} ms" for m, name in modes.items()))
    # the resident kernels by parts, the same way: K7's and K8's cooperative
    # launches with the loop, the barriers and merges, or the epilogue
    # compiled out
    if k7.sample_groups(n, hw, hw, c, torch.bfloat16,
                        k7.resident_blocks(dev), tail=True):
        pw = k7.probe_weights(
            w, torch.randn((c, c // 16), generator=gen, device=dev) * 0.1,
            torch.randn((c // 16, c), generator=gen, device=dev) * 0.1,
            torch.randn((7, 7, 2, 1), generator=gen, device=dev) * 0.1)
        rmodes = {7: "whole", 3: "no epilogue", 5: "no barriers or merges",
                  1: "loop and partials alone", 2: "barriers and merges alone",
                  4: "epilogue alone"}
        for is_tail, name in ((False, "K7"), (True, "K8")):
            rounds = {m: [] for m in rmodes}
            for _ in range(3):
                for m in rmodes:
                    rounds[m].append(cuda_ms(lambda: k7.resident_probe(
                        x16, pw, m, is_tail, scratch), 50))
            rparts = {m: statistics.median(v) for m, v in rounds.items()}
            records[("resident", name, "parts")] = rparts
            log(f"{name} resident bf16 by parts (median of 3 alternating "
                "rounds): " + ", ".join(f"{label} {rparts[m]:.4f} ms"
                                        for m, label in rmodes.items()))
    # one library call of the same function: timed here, used nowhere
    xc = x16.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    lib_ms = cuda_ms(lambda: F.conv2d(xc, wc), 20)
    records[("conv", "bf16")]["library_ms"] = lib_ms
    log(f"conv3x3 bf16: F.conv2d (bf16, channels_last) {lib_ms:.4f} ms = "
        f"{flop / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def run_proto_phase(proto, k7, dev, records):
    """Phase 3p: P1 and P2 against their plain versions at the shapes their
    bench runs, then the prototypes' own parity and A/B bench."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    hw, c = K1_SHAPE[1], K1_SHAPE[3]
    r = c // 16
    rand = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std
    wa, wb = rand(3, 3, c, c, std=0.02), rand(3, 3, c, c, std=0.02)
    tail = (rand(c, r, std=0.1), rand(r, c, std=0.1),
            rand(7, 7, 2, 1, std=0.1))
    failures = []
    for n, dtype in ((8, torch.bfloat16), (8, torch.float32),
                     (32, torch.bfloat16)):
        dname = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        carry = rand(n, hw + 2, hw + 2, c).to(dtype)
        scratch = k7.make_scratch(n, hw, hw, c, dev)
        t = proto.conv3x3_in(carry, wa, scratch=scratch)
        cases = (
            ("p1", "P1 conv3x3_in", K7_TOL[dname], K7_BF16_MEAN_TOL, t,
             lambda: proto.conv3x3_in(carry, wa, scratch=scratch),
             lambda: k7.conv3x3_in_plain(carry, wa)),
            ("p2", "P2 conv_block_tail", K8_TOL[dname], K8_BF16_MEAN_TOL,
             proto.conv_block_tail(t, carry, wb, *tail, scratch=scratch),
             lambda: proto.conv_block_tail(t, carry, wb, *tail,
                                           scratch=scratch),
             lambda: k7.conv_block_tail_plain(t, carry, wb, *tail)))
        for route, is_tail in ((k7.launch_conv3x3_in.route, False),
                               (k7.launch_conv_block_tail.route, True)):
            expect_route(k7, f"P{1 + is_tail} n={n} {dname}", route,
                         (n, hw, hw, c), dtype, dev, tail=is_tail)
        log(f"P1 / P2 n={n} {dname}: routes {k7.launch_conv3x3_in.route} / "
            f"{k7.launch_conv_block_tail.route}")
        for key, name, (atol, rtol), mean_tol, got, fn, plain_fn in cases:
            ref = plain_fn()
            torch.cuda.synchronize()
            ok, emax, emean = compare(got, ref, atol, rtol)
            if bf16 and emean > mean_tol:
                ok = False
            ms, plain_ms = cuda_ms(fn, 5), cuda_ms(plain_fn, 3)
            log(f"{name} {tuple(carry.shape)} {dname}: max|d|={emax:.3e} "
                f"mean|d|={emean:.3e} (atol {atol}, rtol {rtol}"
                + (f", mean {mean_tol}" if bf16 else "")
                + f") kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"{'ok' if ok else 'FAIL'}")
            records[(key, n, dname)] = dict(max_abs_err=emax, ms=ms,
                                            plain_ms=plain_ms)
            if not ok:
                failures.append(f"{name} n={n} {dname}")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")
    del carry, scratch, t, cases, got, ref
    torch.cuda.empty_cache()

    # the prototypes' own path, counted: parity, then the bench
    proto.conv3x3_in.launches = proto.conv_block_tail.launches = 0
    proto.parity(device=dev)                  # raises at 1e-3
    for n in (8, 32):
        records[("proto", n)] = proto.bench(n, device=dev)
        torch.cuda.empty_cache()
    records[("proto", "launches")] = dict(
        conv3x3_in=proto.conv3x3_in.launches,
        conv_block_tail=proto.conv_block_tail.launches)
    log(f"proto launches {records[('proto', 'launches')]}")
    if not all(records[("proto", "launches")].values()):
        fail("the prototype bench launched no kernel")


# device kernels that may not run on the serving path under a resident
# trunk: the tiled route's light passes over the trunk's fp32 accumulator
# and K2's original launches (K2 is in_stats + in_apply)
STRAY = ("channel_gate", "spatial_tail", "norm_apply", "finalize_stats")


def profile_patient(run, label: str, k2_launches: int | None = None) -> dict:
    """One warm patient under torch.profiler: device-busy time (the sum of
    the kernels' and copies' durations; the engine uses one stream) and the
    time by kernel name, logged with the ten largest names and K2's two
    kernels. The idle share is taken against the traced run's own device
    span, from the start of its first device event to the end of its last,
    so the host time before the first kernel and after the last copy is
    outside it. Where the profiler records no device event the numbers are
    "not measured". Times are not judged. With ``k2_launches`` (K2's calls
    in a patient whose trunk runs resident) the run fails if a STRAY kernel
    shows, or if K2's in_stats or in_apply launches are not that count (one
    pair a call: N = 16 <= the SM count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by: dict = {}
    count: dict = {}
    first, last = float("inf"), 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    busy = sum(by.values())
    if not busy:
        log(f"profile {label}: device time not measured (the profiler "
            "recorded no device event)")
        return {}
    span = (last - first) / 1e3
    ours = sum(v for k, v in by.items() if "ducosy::" in k)
    log(f"profile {label}: device span {span:.1f} ms (first to last device "
        f"event of the traced patient), device busy {busy:.1f} ms, idle "
        f"{100 * (1 - busy / span):.1f}% of the span, the port's kernels "
        f"{ours:.1f} ms ({100 * ours / busy:.1f}% of busy)")
    for name, ms in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {name[:160]}")
    # K2's kernels (the second overlaps the first: their sum exceeds K2's
    # share of the span)
    k2_ms = {k: sum(v for n, v in by.items() if f"::{k}<" in n)
             for k in ("in_stats", "in_apply")}
    k2_n = {k: sum(v for n, v in count.items() if f"::{k}<" in n)
            for k in ("in_stats", "in_apply")}
    log(f"profile {label}: K2 in_stats x{k2_n['in_stats']} "
        f"{k2_ms['in_stats']:.2f} ms, in_apply x{k2_n['in_apply']} "
        f"{k2_ms['in_apply']:.2f} ms")
    if k2_launches is not None:
        stray = [k for k in by if any(t in k for t in STRAY)]
        log(f"profile {label}: stray kernels {stray or 'none'}")
        if stray or set(k2_n.values()) != {k2_launches}:
            fail(f"profile {label}: the resident trunk ran {stray}; K2 "
                 f"launches {k2_n}, expected {k2_launches} each")
    return dict(span_ms=span, busy_ms=busy, ours_ms=ours, k2_ms=k2_ms)


def run_mega_engine_phase(k1, k2, k7, dev, st, lung, records):
    """Phase 4m: the engine at trunk="mega", bf16 and both quant modes."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_chunks = -(-SLICES // N)

    def engine(trunk, quant=None, dtype=torch.bfloat16):
        return DualGeneratorEngine(st, lung, img_size=SIZE,
                                   compute_dtype=dtype, device=dev,
                                   forward="module", trunk=trunk,
                                   quant=quant)

    def run(eng):
        t0 = time.perf_counter()
        out = eng.run_patient(vol, 1.0, -1024.0, chunk=N)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    counters = {"conv3x3_in": k7.conv3x3_in,
                "conv_block_tail": k7.conv_block_tail,
                "instance_norm": k2.instance_norm,
                "residual_chain": k1.residual_chain}

    def counted(eng, what, k2_calls):
        run(eng)                              # warm-up
        for f in counters.values():
            f.launches = 0
        out, _ = run(eng)                     # the main path, counted
        got = {k: f.launches for k, f in counters.items()}
        want = {"conv3x3_in": 2 * BLOCKS * n_chunks,
                "conv_block_tail": 2 * BLOCKS * n_chunks,
                "instance_norm": 2 * k2_calls * n_chunks, "residual_chain": 0}
        log(f"engine {what} mega: launches {got} (expected {want})")
        if got != want:
            fail(f"mega {what} launch counts {got} != {want}")
        if out.dtype != np.int16 or out.shape != vol.shape:
            fail(f"mega engine output {out.dtype} {out.shape}")
        records[("launches", "mega", what)] = got
        return out

    def routed(name):
        return tiled_route(k1, k7) if "tiled route" in name else \
            contextlib.nullcontext()

    def rates(engines, label):
        rounds = {k: [] for k in engines}
        for name, eng in engines.items():
            if "tiled route" in name:
                with routed(name):
                    run(eng)                  # warm the tiled route
        for _ in range(3):                    # alternate the modes
            for name, eng in engines.items():
                with routed(name):
                    rounds[name].append(SLICES / run(eng)[1])
        for name, v in rounds.items():
            log(f"engine {label} {name}: slices/s median "
                f"{statistics.median(v):.2f} rounds "
                f"{[round(x, 2) for x in v]} ({SLICES} x {SIZE}^2, chunk {N}, "
                f"bf16 compute, incl. upload, postprocess, download)")
        return {k: statistics.median(v) for k, v in rounds.items()}

    mega = engine("mega")
    out_mega = counted(mega, "bf16", K2_PER_GEN[None])
    chain, plain = engine("chain"), engine("plain")
    ref_out, _ = run(chain)
    run(plain)
    d = dhu_stats(out_mega, ref_out)
    log(f"engine bf16 mega vs bf16 chain: |dHU| mean {d[0]:.4f} p99 "
        f"{d[1]:.4f} max {d[2]:.1f}")
    records["mega_slices_per_s"] = rates(
        {"mega": mega, "mega, tiled route": mega, "chain": chain,
         "plain": plain}, "bf16")
    check_not_slower("bf16", records["mega_slices_per_s"], "mega")
    del plain
    resident = k7.sample_groups(N, *K1_SHAPE[1:], torch.bfloat16,
                                k7.resident_blocks(dev), tail=True) > 0
    k2_calls = lambda quant: 2 * K2_PER_GEN[quant] * n_chunks if resident \
        else None
    for name, eng in (("mega", mega), ("chain", chain)):
        records[("profile", name)] = profile_patient(
            lambda: run(eng), f"bf16 {name}", k2_calls(None))
    with tiled_route(k1, k7):
        records[("profile", "mega, tiled route")] = profile_patient(
            lambda: run(mega), "bf16 mega, tiled route")

    out32, _ = run(engine("mega", dtype=torch.float32))
    ref32, _ = run(engine("plain", dtype=torch.float32))
    diff = np.abs(out32.astype(np.int32) - ref32.astype(np.int32))
    share = float(np.mean(diff <= 1))
    log(f"engine fp32 mega vs fp32 plain: |d|<=1 on {share:.6f} of voxels, "
        f"max |d| {int(diff.max())} stored units")
    if share < STORED_UNIT_SHARE:
        fail(f"fp32 mega vs plain: {share} < {STORED_UNIT_SHARE}")
    records["mega_fp32_share"] = share

    for quant in ("trunk", "full"):
        eng = engine("mega", quant)
        out = counted(eng, f"quant={quant}", K2_PER_GEN[quant])
        final = dhu_stats(out, ref_out)
        sub = vol[:N]
        raw_ref = chain.generate_batch(sub, 1.0, -1024.0)
        raw_q = eng.generate_batch(sub, 1.0, -1024.0)
        keys = ("st_stored", "lung_stored")
        raw = dhu_stats(np.concatenate([raw_q[k].ravel() for k in keys]),
                        np.concatenate([raw_ref[k].ravel() for k in keys]))
        log(f"engine quant={quant} mega vs bf16 chain engine: raw tap |dHU| "
            f"mean {raw[0]:.4f} p99 {raw[1]:.4f} max {raw[2]:.1f}; final tap "
            f"|dHU| mean {final[0]:.4f} p99 {final[1]:.4f} max {final[2]:.1f}")
        records[("fidelity", "mega", quant)] = dict(raw=raw, final=final)
        if final[0] > QUANT_MEAN_DHU_MAX:
            fail(f"mega quant={quant}: final-tap mean |dHU| {final[0]} > "
                 f"{QUANT_MEAN_DHU_MAX}")
        records[("mega_slices_per_s", quant)] = rates(
            {"mega": eng, "mega, tiled route": eng,
             "chain": engine("chain", quant)}, f"quant={quant}")
        check_not_slower(f"quant={quant}",
                         records[("mega_slices_per_s", quant)], "mega")
        records[("profile", quant)] = profile_patient(
            lambda: run(eng), f"quant={quant} mega", k2_calls(quant))
        del eng
        torch.cuda.empty_cache()


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
                                   forward="module", trunk=trunk,
                                   quant=quant)

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
                "instance_norm": 2 * K2_PER_GEN[quant] * n_chunks,
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
    from ducosy_tpu_torch.ops.kernels import conv_in as k7

    engines.update({f"{k}, tiled route": e for k, e in list(engines.items())})
    routed = lambda name: tiled_route(k1, k7) if "tiled route" in name \
        else contextlib.nullcontext()
    for name, eng in engines.items():
        with routed(name):
            run(eng)                          # warm either route
    rounds = {k: [] for k in engines}
    for _ in range(3):                        # alternate the modes and routes
        for name, eng in engines.items():
            with routed(name):
                rounds[name].append(SLICES / run(eng)[1])
    for name, rates in rounds.items():
        log(f"engine {name} chain: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk {N},"
            f" bf16 compute, incl. upload, postprocess, download)")
    records["quant_slices_per_s"] = {k: statistics.median(v)
                                     for k, v in rounds.items()}
    for name in ("bf16", "trunk", "full"):
        check_not_slower("chain", records["quant_slices_per_s"], name)
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
    # K4's routes under the tail trunk, in alternating rounds
    with tiled_route(k1, k7):
        run(tail)                             # warm the tiled route
    rounds = {"tail": [], "tail, tiled route": []}
    for _ in range(3):
        rounds["tail"].append(SLICES / run(tail)[1])
        with tiled_route(k1, k7):
            rounds["tail, tiled route"].append(SLICES / run(tail)[1])
    for name, rates in rounds.items():
        log(f"engine quant=trunk {name}: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]}")
    records["tail_slices_per_s"] = {k: statistics.median(v)
                                    for k, v in rounds.items()}
    check_not_slower("quant=trunk tail", records["tail_slices_per_s"], "tail")
    del tail
    # the int8 convs' im2col blocks go back before the training phase
    torch.cuda.empty_cache()
    records[("launches", "tail")] = got


# ----------------------------------------------------- the packed forward
# K2p at the packed forward's three phase-pooled norms (name, shape, phases):
# the stem, packed-4 of 512^2 x 64; up1, packed-4 of 256^2 x 128 (the shape
# of phase 3q's K2P_SHAPE); up2, packed-16 of 512^2 x 64
K2P_PACKED = (("stem", (N, 256, 256, 256), 4), ("up1", K2P_SHAPE, 4),
              ("up2", (N, 128, 128, 1024), 16))
PACKED_TRUNKS = ("chain3", "mega", "mono", "pallas", "xla")


def packed_launch_want(trunk: str, quant, n_gens: int) -> dict:
    """Exact launches of one 32-slice patient (``n_gens`` generator calls:
    2 generators x the chunks) on the packed forward: the stem, up1 and up2
    norms are K2 with phases (none under quant="full", whose norms around
    the static int8 convs stay plain), down1's and down2's K2 phases 1
    (down2's alone under "full"); the trunk's kernels a call."""
    phased = 0 if quant == "full" else 3
    k2 = phased + (1 if quant == "full" else 2)
    want = {"residual_chain": 0, "instance_norm": k2,
            "instance_norm (phases > 1)": phased, "instance_norm_int8": 0,
            "block_tail": 0, "conv3x3_in": 0, "conv_block_tail": 0}
    if trunk == "chain3":
        want["residual_chain"] = 3
    elif trunk == "mono":
        want["residual_chain"] = BLOCKS
    elif trunk == "mega":
        want["conv3x3_in"] = want["conv_block_tail"] = BLOCKS
    elif trunk == "pallas":
        want["block_tail"] = BLOCKS
        want["instance_norm_int8" if quant else "instance_norm"] += BLOCKS
    else:                                   # xla: no kernel anywhere
        want = {k: 0 for k in want}
    return {k: v * n_gens for k, v in want.items()}


def packed_counters(k1, k2, k4, k7) -> dict:
    return {"residual_chain": k1.residual_chain,
            "instance_norm": k2.instance_norm,
            "instance_norm_int8": k2.instance_norm_int8,
            "block_tail": k4.block_tail, "conv3x3_in": k7.conv3x3_in,
            "conv_block_tail": k7.conv_block_tail}


def read_counts(counters: dict, k2) -> dict:
    got = {k: f.launches for k, f in counters.items()}
    got["instance_norm (phases > 1)"] = k2.instance_norm.phase_launches
    return got


def zero_counts(counters: dict, k2) -> None:
    for f in counters.values():
        f.launches = 0
    k2.instance_norm.phase_launches = 0


def check_k2p_packed(k2, dev, records):
    """Phase 2k: K2 with phases at the packed forward's three norms, bf16
    and fp32, against the plain version, timed beside it and its bound."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    failures = []
    for name, shape, phases in K2P_PACKED:
        base = k2_input(shape, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            x = base.to(dtype)
            kw = dict(relu=True, pad=0, phases=phases)
            got = k2.instance_norm(x, **kw)
            ref = k2.instance_norm_plain(x, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[("k2", dname)]
            ok, emax, emean = compare(got, ref, atol, rtol)
            ms = cuda_ms(lambda: k2.instance_norm(x, **kw), 20)
            plain_ms = cuda_ms(lambda: k2.instance_norm_plain(x, **kw), 5)
            bnd = k2_bound(shape, 0, x.element_size())
            log(f"K2 phases={phases} {name} {tuple(shape)} {dname}: "
                f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol}, rtol "
                f"{rtol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                f"{100 * bnd['bound_ms'] / ms:.1f}%) {'ok' if ok else 'FAIL'}")
            records[("k2p", name, dname)] = dict(
                max_abs_err=emax, ms=ms, plain_ms=plain_ms, bound=bnd)
            if not ok:
                failures.append(f"K2 phases {name} {dname}")
            del x, got, ref
        del base
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def serve(eng, vol):
    import torch

    t0 = time.perf_counter()
    out = eng.run_patient(vol, 1.0, -1024.0, chunk=N)
    torch.cuda.synchronize()
    if out.dtype != np.int16 or out.shape != vol.shape:
        fail(f"engine output {out.dtype} {out.shape}")
    return out, time.perf_counter() - t0


def rate_rounds(engines: dict, vol, label: str) -> dict:
    """slices/s of each engine, the median of 3 rounds that alternate them
    (each warmed first)."""
    for eng in engines.values():
        serve(eng, vol)
    rounds = {k: [] for k in engines}
    for _ in range(3):
        for name, eng in engines.items():
            rounds[name].append(SLICES / serve(eng, vol)[1])
    for name, rates in rounds.items():
        log(f"engine {label} {name}: slices/s median "
            f"{statistics.median(rates):.2f} rounds "
            f"{[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk {N},"
            f" incl. upload, postprocess, download)")
    return {k: statistics.median(v) for k, v in rounds.items()}


def agreement(label: str, got, ref, strict: bool) -> dict:
    """Share of voxels within 1 stored unit and |dHU| mean / p99 / max;
    ``strict`` (fp32 against fp32) fails below STORED_UNIT_SHARE, else a
    mean above QUANT_MEAN_DHU_MAX fails (a wrong layout moves the output by
    hundreds of HU)."""
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    share = float(np.mean(d <= 1))
    mean, p99, mx = dhu_stats(got, ref)
    log(f"{label}: |d|<=1 on {share:.6f} of voxels; |dHU| mean {mean:.4f} "
        f"p99 {p99:.4f} max {mx:.1f}")
    if strict and share < STORED_UNIT_SHARE:
        fail(f"{label}: {share} < {STORED_UNIT_SHARE}")
    if not strict and mean > QUANT_MEAN_DHU_MAX:
        fail(f"{label}: mean |dHU| {mean} > {QUANT_MEAN_DHU_MAX}")
    return dict(share=share, mean=mean, p99=p99, max=mx)


def default_engine(label: str, *args, **kw):
    """A DualGeneratorEngine built with no forward and no trunk, as the
    generate CLI builds it; fails unless it resolved to packed chain3."""
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    eng = DualGeneratorEngine(*args, **kw)
    got = (eng.forward_impl, eng.trunk)
    log(f"{label}: the engine built with no forward and no trunk resolved "
        f"to {got}")
    if got != ("packed", "chain3"):
        fail(f"{label}: the default engine resolved to {got}, not "
             "('packed', 'chain3')")
    return eng


def run_packed_engine_phase(k1, k2, k4, k7, dev, st, lung, module_series,
                            records):
    """Phase 4k: the engine built with no forward and no trunk (the
    default: packed chain3) and forward="packed" at the other trunks
    (bf16), exact launch counts, each against the module forward's
    run_patient and the default against phase 4's module series
    (``module_series``); the fp32 default against the fp32 module plain
    path; rates in alternating rounds beside the module forward; one
    profiled patient of the default."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_gens = 2 * -(-SLICES // N)
    engine = lambda dtype, **kw: DualGeneratorEngine(
        st, lung, img_size=SIZE, compute_dtype=dtype, device=dev, **kw)
    default = lambda dtype: default_engine(
        f"4k {str(dtype)[6:]}", st, lung, img_size=SIZE, compute_dtype=dtype,
        device=dev)
    counters = packed_counters(k1, k2, k4, k7)
    module = engine(torch.bfloat16, forward="module", trunk="chain")
    ref, _ = serve(module, vol)
    engines = {"module chain": module}
    launches = {}
    for trunk in PACKED_TRUNKS:
        eng = engines[f"packed {trunk}"] = default(torch.bfloat16) \
            if trunk == "chain3" else engine(torch.bfloat16,
                                             forward="packed", trunk=trunk)
        serve(eng, vol)                       # warm-up: cuDNN autotune etc.
        zero_counts(counters, k2)
        out, _ = serve(eng, vol)              # the main path, counted
        got = read_counts(counters, k2)
        want = packed_launch_want(trunk, None, n_gens)
        log(f"engine bf16 packed {trunk}: launches {got} (expected {want})")
        if got != want:
            fail(f"packed {trunk} launch counts {got} != {want}")
        launches[trunk] = got
        records[("packed_agreement", trunk)] = agreement(
            f"engine bf16 packed {trunk} vs bf16 module chain", out, ref,
            strict=False)
        if trunk == "chain3":
            records["default_vs_phase4"] = agreement(
                "engine bf16 default (packed chain3) vs phase 4's bf16 "
                "module chain series", out, module_series, strict=False)
    records["packed_launches"] = launches
    out32, _ = serve(default(torch.float32), vol)
    ref32, _ = serve(engine(torch.float32, forward="module", trunk="plain"),
                     vol)
    records["packed_fp32"] = agreement(
        "engine fp32 default (packed chain3) vs fp32 module plain", out32,
        ref32, strict=True)
    del out32, ref32
    records["packed_slices_per_s"] = rate_rounds(engines, vol, "bf16")
    rates = records["packed_slices_per_s"]
    log(f"engine bf16 packed chain3 / module chain: "
        f"{rates['packed chain3'] / rates['module chain']:.4f}")
    records["packed_profile"] = profile_patient(
        lambda: serve(engines["packed chain3"], vol), "packed chain3 bf16",
        k2_launches=launches["chain3"]["instance_norm"])
    del engines, module
    torch.cuda.empty_cache()


def run_packed_quant_phase(k1, k2, k4, k7, dev, st, lung, records):
    """Phase 4kq: forward="packed" at quant="trunk" and "full" under chain3
    and under xla (the XLA trunk's per-sample dynamic requant): exact
    launch counts, raw and final taps against the bf16 module engine (phase
    4q's bound), rates in alternating rounds."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_gens = 2 * -(-SLICES // N)
    engine = lambda **kw: DualGeneratorEngine(
        st, lung, img_size=SIZE, compute_dtype=torch.bfloat16, device=dev,
        **kw)
    counters = packed_counters(k1, k2, k4, k7)
    ref = engine(forward="module", trunk="chain")
    ref_out, _ = serve(ref, vol)
    sub = vol[:N]
    raw_ref = ref.generate_batch(sub, 1.0, -1024.0)
    engines = {}
    for trunk in ("chain3", "xla"):
        for quant in ("trunk", "full"):
            name = f"packed {trunk} quant={quant}"
            eng = engines[name] = engine(forward="packed", trunk=trunk,
                                         quant=quant)
            serve(eng, vol)
            zero_counts(counters, k2)
            out, _ = serve(eng, vol)
            got = read_counts(counters, k2)
            want = packed_launch_want(trunk, quant, n_gens)
            log(f"engine {name}: launches {got} (expected {want})")
            if got != want:
                fail(f"{name} launch counts {got} != {want}")
            raw_q = eng.generate_batch(sub, 1.0, -1024.0)
            if not all(np.isfinite(raw_q[k]).all() for k in raw_q):
                fail(f"{name}: non-finite generate_batch output")
            pick_ = lambda r: np.concatenate(
                [r[k].ravel() for k in ("st_stored", "lung_stored")])
            raw = dhu_stats(pick_(raw_q), pick_(raw_ref))
            log(f"engine {name} vs bf16 module engine: raw tap "
                f"(generate_batch st/lung stored, {N} slices) |dHU| mean "
                f"{raw[0]:.4f} p99 {raw[1]:.4f} max {raw[2]:.1f}")
            final = agreement(f"engine {name} vs bf16 module engine, final "
                              "tap (run_patient)", out, ref_out, strict=False)
            records[("packed_fidelity", trunk, quant)] = dict(raw=raw,
                                                              final=final)
    engines["module chain"] = ref
    records["packed_quant_slices_per_s"] = rate_rounds(engines, vol, "bf16")
    del engines, ref
    torch.cuda.empty_cache()


def run_nocbam_serving_phase(k1, k2, k4, k7, dev, records):
    """Phase 8k: a seeded generator pair without CBAM (1 channel, base 64,
    9 blocks) through the module forward (trunk "auto": plain), the module
    forward with fused_norm (the 18 trunk norms on K2) and the engine built
    with no forward (the default: packed, nominal chain3, run on its XLA
    trunk): exact launch counts, the series against the plain module
    forward (fp32: 1 stored unit on 99.9%; bf16: |dHU|), rates in
    alternating rounds."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
    from ducosy_tpu_torch.models.convert import init_generator_state_dict

    vol = chest_phantom(SLICES, SIZE, SEED)
    n_gens = 2 * -(-SLICES // N)
    st, lung = (init_generator_state_dict(SEED + s, use_cbam=False)
                for s in (13, 14))
    counters = packed_counters(k1, k2, k4, k7)
    kinds = {"module plain": {"forward": "module"},
             "module fused_norm": {"forward": "module", "fused_norm": True},
             "packed": {}}
    norm_launches = {"module plain": 0, "module fused_norm": 2 * BLOCKS,
                     "packed": 0}
    outs, engines = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for name, kw in kinds.items():
            eng = DualGeneratorEngine(st, lung, img_size=SIZE,
                                      compute_dtype=dtype, device=dev, **kw) \
                if kw else default_engine(f"8k {dname}", st, lung,
                                          img_size=SIZE, compute_dtype=dtype,
                                          device=dev)
            serve(eng, vol)
            zero_counts(counters, k2)
            outs[(name, dname)], _ = serve(eng, vol)
            got = read_counts(counters, k2)
            want = {k: 0 for k in got}
            want["instance_norm"] = norm_launches[name] * n_gens
            log(f"engine no-CBAM {name} {dname}: launches {got} (expected "
                f"{want})")
            if got != want:
                fail(f"no-CBAM {name} {dname} launch counts {got} != {want}")
            if dtype == torch.bfloat16:
                engines[name] = eng
    for name in ("module fused_norm", "packed"):
        for dname, strict in (("float32", True), ("bfloat16", False)):
            records[("nocbam", name, dname)] = agreement(
                f"engine no-CBAM {name} {dname} vs module plain {dname}",
                outs[(name, dname)], outs[("module plain", dname)], strict)
    records["nocbam_slices_per_s"] = rate_rounds(engines, vol,
                                                 "no-CBAM bf16")
    del engines, outs
    torch.cuda.empty_cache()


def run_packed_training_phase(k2, k4, tmp: Path, records):
    """Phase 7k: phase 7's tree trained by the training CLI with no
    --gen_forward and no --trunk, which on a card runs the packed step
    (CBAM SOFT_TISSUE, batch 8, 512^2, bf16, remat off, TRAIN_STEPS steps +
    the validation pass): the forward the loop resolved, finite losses,
    exact K2-K5 launches, s/step and peak memory beside phase 7's tail run;
    then a SOFT_TISSUE range without CBAM with fused_norm (the module
    forward's trunk "plain": the 18 trunk norms on K2, K3 their backward)
    for 3 steps: finite losses and exact K2/K3 launches."""
    from ducosy_tpu_torch.cli import train
    from ducosy_tpu_torch.config import (SOFT_TISSUE, ModelConfig,
                                         TrainConfig, replace)
    from ducosy_tpu_torch.train.loop import train_cycle_gan

    counters = {"instance_norm": k2.instance_norm,
                "instance_norm_bwd": k2.instance_norm_bwd,
                "block_tail": k4.block_tail,
                "block_tail_bwd": k4.block_tail_bwd}

    def launches():
        return {k: f.launches for k, f in counters.items()}

    def check(label, out, secs, got, want, steps, forward):
        if out["gen_forward"] != forward:
            fail(f"{label}: the loop ran the {out['gen_forward']} forward, "
                 f"not {forward}")
        losses = {k: v for k, v in out.items() if k.startswith("loss")
                  or k in ("contrast", "val_loss")}
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{label}: non-finite losses {losses}")
        if len(out["step_seconds"]) != steps or out["oom_fallback"]:
            fail(f"{label}: {len(out['step_seconds'])} steps run, remat "
                 f"fallback {out['oom_fallback']}")
        med = statistics.median(out["step_seconds"][1:])
        log(f"{label}: the {forward} forward, {steps} steps + validation "
            f"in {secs:.1f} s; step "
            f"seconds {[round(t, 4) for t in out['step_seconds']]}, median "
            f"of steps 2-{steps} {med:.4f}; peak memory "
            f"{out['peak_memory_bytes'] / 2**30:.2f} GiB; launches {got} "
            f"(expected {want}); losses {losses}")
        if got != want:
            fail(f"{label} launch counts {got} != {want}")
        return med

    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = train.main([
        "--data_root", str(Path(tmp, "data")), "--dataset_names", "Smoke",
        "--training_dir", str(Path(tmp, "run_packed")),
        "--img_size", str(SIZE), "--batch_size", str(TRAIN_N),
        "--num_residual_blocks", str(BLOCKS), "--epochs", "1",
        "--max_steps_per_epoch", str(TRAIN_STEPS), "--resume", "",
        "--num_devices", "1", "--num_workers", "8",
        "--remat", "off"])["soft_tissue"]
    secs = time.perf_counter() - t0
    # the packed "pallas" trunk: K2 and K4 once a block a forward, K3 and K5
    # in each backward (6 forwards a step); validation runs the module
    # forward's tail trunk, 2 x 6 forwards
    fwd, val = 6 * BLOCKS * TRAIN_STEPS, 2 * 6 * BLOCKS
    want = {"instance_norm": fwd + val, "instance_norm_bwd": fwd,
            "block_tail": fwd + val, "block_tail_bwd": fwd}
    med = check("training CLI default (gen_forward auto) remat=off", out,
                secs, launches(), want, TRAIN_STEPS, "packed")
    tail = records.get("s_per_step", {}).get(("tail", "auto"))
    log(f"training s/step packed {med:.4f} beside phase 7's tail "
        f"{tail if tail is None else round(tail, 4)} (batch {TRAIN_N} x "
        f"{SIZE}^2, bf16, {BLOCKS} blocks, SOFT_TISSUE)")
    records["packed_train"] = dict(s_per_step=med,
                                   peak=out["peak_memory_bytes"],
                                   launches=launches())

    steps = 3
    for f in counters.values():
        f.launches = 0
    cfg = replace(TrainConfig(), data_root=str(Path(tmp, "data")),
                  dataset_names="Smoke",
                  training_dir=str(Path(tmp, "run_fused_norm")),
                  img_size=SIZE, batch_size=TRAIN_N, epochs=1, resume="",
                  num_workers=8, remat="off")
    model = ModelConfig(num_residual_blocks=BLOCKS, fused_norm=True)
    t0 = time.perf_counter()
    out = train_cycle_gan(cfg, "soft_tissue", model,
                          range_cfg=replace(SOFT_TISSUE, use_cbam=False),
                          device="cuda", max_epochs=1,
                          max_steps_per_epoch=steps)
    secs = time.perf_counter() - t0
    norms = 2 * BLOCKS                  # K2 a forward; K3 a backward
    want = {"instance_norm": 6 * norms * steps + 2 * 6 * norms,
            "instance_norm_bwd": 6 * norms * steps, "block_tail": 0,
            "block_tail_bwd": 0}
    med = check("training no-CBAM fused_norm remat=off", out, secs,
                launches(), want, steps, "module")
    records["fused_norm_train"] = dict(s_per_step=med,
                                       peak=out["peak_memory_bytes"],
                                       launches=launches())


def cli_quant(flags) -> str | None:
    """The --quant mode among generate CLI ``flags`` (None without)."""
    flags = list(flags)
    return flags[flags.index("--quant") + 1] if "--quant" in flags else None


def check_cli_launches(label: str, counters: dict, k2, flags=()) -> dict:
    """The launches of one 32-slice patient through the generate CLI's
    default engine, packed chain3 (``flags`` may name a quant mode), read
    from ``counters`` and held to packed_launch_want."""
    got = read_counts(counters, k2)
    want = packed_launch_want("chain3", cli_quant(flags),
                              2 * -(-SLICES // N))
    if got != want:
        fail(f"{label}: launches {got} != {want} (packed chain3)")
    return got


def run_cli_phase(counters, k2, st, lung, flags=()):
    import torch

    from ducosy_tpu_torch.cli import generate

    vol = chest_phantom(SLICES, SIZE, SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        write_series(Path(tmp, "input", "Smoke", "patient00", "POST VUE"),
                     vol, "POST VUE")
        paths = {}
        for name, sd in (("st", st), ("lung", lung)):
            paths[name] = str(Path(tmp, f"{name}.pth"))
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       paths[name])
        zero_counts(counters, k2)
        t0 = time.perf_counter()
        done = generate.main([
            "--input_dir_root", str(Path(tmp, "input")),
            "--output_dir_root", str(Path(tmp, "output")),
            "--dataset_names", "Smoke", "--img_size", str(SIZE),
            "--slice_batch", str(N), "--soft_tissue_model", paths["st"],
            "--lung_model", paths["lung"], *flags])
        secs = time.perf_counter() - t0
        if done != 1:
            fail(f"CLI: {done} patients")
        got = check_cli_launches(f"CLI {' '.join(flags) or '(bf16)'}",
                                 counters, k2, flags)
        out = read_series(Path(tmp, "output", "Smoke", "patient00"),
                          "DuCoSyGAN sCECT v2", "CLI")
    log(f"CLI {' '.join(flags) or '(bf16)'}: 1 patient, {SLICES} slices "
        f"written and read back in {secs:.2f} s (incl. engine build), "
        f"served packed chain3; launches {got}")
    return out


def read_series(folder: Path, desc: str | None, what: str) -> np.ndarray:
    """The SLICES slices of a written series, read back as one volume;
    each slice SIZE^2, with SeriesDescription ``desc`` when given."""
    from ducosy_tpu_torch.dicom import dcmread

    files = sorted(folder.glob("*.dcm"))
    if len(files) != SLICES:
        fail(f"{what} wrote {len(files)} slices to {folder.name}, "
             f"expected {SLICES}")
    vol = []
    for f in files:
        ds = dcmread(str(f))
        if ds.pixel_array.shape != (SIZE, SIZE) or \
                (desc and ds.SeriesDescription != desc):
            fail(f"{what} output {folder.name}/{f.name}: "
                 f"{ds.pixel_array.shape} {ds.SeriesDescription!r}")
        vol.append(ds.pixel_array)
    return np.stack(vol)


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


def check_training_kernels(k1, k2, k4, k7, dev, records):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, hw, _, c = TRAIN_SHAPE
    r = c // 16
    rand = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std

    def act_of(shape):
        cs = shape[-1]
        return rand(*shape) * (rand(cs).abs() + 0.5) + rand(cs) * 2.0

    def act():
        return act_of(TRAIN_SHAPE)

    # ---- K3: the backward of each block's first norm (ReLU, pad 1), and
    # ragged shapes
    failures = check_k3(k2, records, act_of, rand)

    # ---- K4 / K5: the block tail and its backward, each call on the route
    # its shape gives (resident here in bf16), held against the plain
    # version; in bf16 also against the tiled route, and timed beside it in
    # alternating rounds
    h, xp = act(), rand(n, hw + 2, hw + 2, c)
    w1, w2, wsa = rand(c, r, std=0.1), rand(r, c, std=0.1), \
        rand(7, 7, 2, 1, std=0.1)
    for pad, x_pad in TAIL_CASES:
        g = rand(n, hw + 2 * pad, hw + 2 * pad, c)
        x = xp if x_pad else xp[:, 1:-1, 1:-1].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            failures += check_tail_case(k1, k4, k7, dev, records, h, x, g,
                                        (w1, w2, wsa), pad, x_pad, dtype)
    del h, xp, g, x
    # ragged images: resident with two samples side by side and a last tile
    # the pixels do not fill; C = 192, which stays tiled
    for shape in TAIL_OTHER_SHAPES:
        h, c2 = act_of(shape), shape[3]
        w1, w2, wsa = rand(c2, c2 // 16, std=0.1), \
            rand(c2 // 16, c2, std=0.1), rand(7, 7, 2, 1, std=0.1)
        for pad, x_pad in TAIL_CASES:
            x = rand(shape[0], shape[1] + 2 * x_pad, shape[2] + 2 * x_pad, c2)
            g = rand(shape[0], shape[1] + 2 * pad, shape[2] + 2 * pad, c2)
            for dtype in (torch.float32, torch.bfloat16):
                failures += check_tail_case(k1, k4, k7, dev, {}, h, x, g,
                                            (w1, w2, wsa), pad, x_pad, dtype,
                                            timed=False)
    torch.cuda.empty_cache()
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def relu_edge(x):
    """Where the pre-ReLU normalized value of x (NHWC, fp32 statistics) is
    within RELU_EDGE of 0: statistics one ulp apart may put such an element
    on either side of the mask."""
    import torch

    x32 = x.float()
    xc = x32 - x32.mean(dim=(1, 2), keepdim=True)
    y = xc * torch.rsqrt(xc.square().mean(dim=(1, 2), keepdim=True) + 1e-5)
    return y.abs() <= RELU_EDGE


def check_k3(k2, records, act_of, rand) -> list:
    """K3 at K3_CASES in fp32 and bf16: the kernel (the wrapper) against its
    plain version and against the original five launches (k2.probe_bwd
    design 0) at TRAIN_TOL, elements at the ReLU edge left out; at the
    training shape timed beside the original launches in K3_ROUNDS
    alternating rounds (events around back-to-back calls as for every
    kernel, and CUDA-graph replay), each time with its share of the bound.
    Returns the failures."""
    import torch

    failures = []
    for shape, relu, pad in K3_CASES:
        n, h, w, c = shape
        x, g = act_of(shape), rand(n, h + 2 * pad, w + 2 * pad, c)
        kw = dict(relu=relu, pad=pad)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            xd, gd = x.to(dtype), g.to(dtype)
            got = k2.instance_norm_bwd(xd, gd, **kw)
            ref = k2.instance_norm_bwd_plain(xd, gd, **kw)
            old = k2.probe_bwd(xd, gd, 0, 7, **kw)
            torch.cuda.synchronize()
            keep = ~relu_edge(xd) if relu else torch.ones_like(xd, dtype=bool)
            atol, rtol = TRAIN_TOL[("k3", dname)]
            ok, emax, emean = compare(got[keep], ref[keep], atol, rtol)
            ok_old, emax_old, _ = compare(got[keep], old[keep], atol, rtol)
            what = f"K3 {tuple(shape)} pad={pad} relu={int(relu)} {dname}"
            line = (f"{what}: vs plain max|d|={emax:.3e} mean|d|={emean:.3e}, "
                    f"vs the original launches max|d|={emax_old:.3e} (atol "
                    f"{atol}, rtol {rtol}; {int((~keep).sum())} elements at "
                    "the ReLU edge left out)")
            if shape == TRAIN_SHAPE:
                bnd = k3_bound(shape, pad, xd.element_size())
                new = lambda: k2.instance_norm_bwd(xd, gd, **kw)
                orig = lambda: k2.probe_bwd(xd, gd, 0, 7, **kw)
                rounds = {"kernel": [], "original": [], "kernel, graph": [],
                          "original, graph": []}
                for _ in range(K3_ROUNDS):
                    rounds["kernel"].append(cuda_ms(new, 10))
                    rounds["original"].append(cuda_ms(orig, 10))
                    rounds["kernel, graph"].append(graph_ms(new))
                    rounds["original, graph"].append(graph_ms(orig))
                med = {k: statistics.median(v) for k, v in rounds.items()}
                ms, ms_old = med["kernel"], med["original"]
                plain_ms = cuda_ms(
                    lambda: k2.instance_norm_bwd_plain(xd, gd, **kw), 10)
                b = bnd["bound_ms"]
                line += (f"; kernel {ms:.4f} ms ({b / ms:.1%} of the bound "
                         f"{b:.4f} ms, {bnd['bound_by']}), the original "
                         f"launches {ms_old:.4f} ms ({b / ms_old:.1%}), "
                         f"{ms_old / ms:.2f}x; by CUDA-graph replay "
                         f"{med['kernel, graph']:.4f} and "
                         f"{med['original, graph']:.4f} ms; median of "
                         f"{K3_ROUNDS} alternating rounds {rounds}; plain "
                         f"{plain_ms:.4f} ms")
                records[("k3", dname)] = dict(
                    max_abs_err=emax, ms=ms, plain_ms=plain_ms,
                    original_ms=ms_old, bound=bnd)
            log(f"{line} {'ok' if ok and ok_old else 'FAIL'}")
            if not (ok and ok_old):
                failures.append(what)
        del x, g, xd, gd, got, ref, old, keep
    torch.cuda.empty_cache()
    return failures


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Mean device milliseconds a call without the host's work: `calls`
    calls captured in one CUDA graph (after a warm-up on a side stream),
    replayed `reps` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def check_k3_parts(k2, dev, records):
    """K3 by parts at TRAIN_SHAPE, bf16, pad 1, ReLU: the K3_PROBES rows,
    median of 3 rounds that alternate every row; then the kernel's whole
    and parts against the batch size (K3_SWEEP samples of 128^2 x 256).
    Timed by CUDA-graph replay (graph_ms): a part alone is shorter than the
    host's work a call, so events around back-to-back calls would time the
    host. A part alone reads what the others would have left in scratch: its
    time is right, its output is not."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, hw, _, c = TRAIN_SHAPE
    bf = torch.bfloat16
    x = k2_input(TRAIN_SHAPE, gen, dev).to(bf)
    g = torch.randn((n, hw + 2, hw + 2, c), generator=gen, device=dev).to(bf)
    rounds = {label: [] for label, *_ in K3_PROBES}
    for _ in range(3):
        for label, design, parts in K3_PROBES:
            rounds[label].append(graph_ms(
                lambda: k2.probe_bwd(x, g, design, parts)))
    ms = {k: statistics.median(v) for k, v in rounds.items()}
    records["k3parts"] = ms
    log(f"K3 {TRAIN_SHAPE} pad=1 relu bf16 by parts (CUDA-graph replay, "
        "median of 3 alternating rounds; the original launches, then the "
        "kernel): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    del x, g
    # bytes each part moves once: x; x and g; x and g in, dx out
    for ns in K3_SWEEP:
        shape = (ns, hw, hw, c)
        x = k2_input(shape, gen, dev).to(bf)
        g = torch.randn((ns, hw + 2, hw + 2, c), generator=gen,
                        device=dev).to(bf)
        xb, gb = x.numel() * 2, g.numel() * 2
        moved = {"whole": 2 * xb + gb, "statistics": xb, "sums": xb + gb,
                 "apply": 2 * xb + gb}
        rows = {}
        for _ in range(3):
            for label, parts in (("whole", 7), ("statistics", 1),
                                 ("sums", 2), ("apply", 4)):
                rows.setdefault(label, []).append(graph_ms(
                    lambda: k2.probe_bwd(x, g, 1, parts)))
        med = {k: statistics.median(v) for k, v in rows.items()}
        records[("k3sweep", ns)] = med
        log(f"K3 ({ns}, {hw}, {hw}, {c}) bf16 by parts [plan "
            f"{tuple(k2.device_plan(x))}]: " + ", ".join(
                f"{k} {v:.4f} ms ({moved[k] / v / 1e9:.2f} TB/s of its "
                "bytes once)" for k, v in med.items()))
        del x, g
    torch.cuda.empty_cache()


def k5_agreement(got, ref, dname: str, tol: float) -> tuple[list, list, float]:
    """K5's outputs against a reference set: the parts of the log line and
    the failures (K5_TOL: relative L2 for every output, fp32 also max |d|
    within tol of the largest |ref|; bf16 dx elementwise)."""
    import torch

    parts, bad, worst = [], [], 0.0
    for name, a, b in zip(("dh", "dx", "dw1", "dw2", "dwsa"), got, ref):
        emax, emean, rel = compare_stats(a, b)
        scale = float(b.float().abs().max())
        if name == "dx" and dname == "bfloat16":
            good = compare(a, b, 1e-2, 1e-2)[0]
        elif dname == "float32":
            good = rel <= tol and emax <= tol * scale
        else:
            good = rel <= tol
        if name == "dh":
            worst = emax
        parts.append(f"{name} max|d|={emax:.3e} mean|d|={emean:.3e} "
                     f"relL2={rel:.2e}{'' if good else ' FAIL'}")
        if not good:
            bad.append(name)
    return parts, bad, worst


def check_tail_case(k1, k4, k7, dev, records, h, x, g, weights, pad, x_pad,
                    dtype, *, timed: bool = True) -> list:
    """K4 and K5 at one case: the route against the shape's, the kernel
    against the plain version (and, on the resident route, against the
    tiled route's launches), times beside the tiled route's in alternating
    rounds. Returns the failures."""
    import torch

    dname = str(dtype)[6:]
    w1, w2, wsa = weights
    hd, xd, gd = h.to(dtype), x.to(dtype), g.to(dtype)
    kw = dict(pad=pad, x_pad=x_pad)
    what = f"pad={pad} x_pad={x_pad} {tuple(hd.shape)} {dname}"
    failures = []

    fwd = lambda: k4.block_tail(hd, xd, w1, w2, wsa, **kw)
    got = fwd()
    route = expect_tail_route(k4, f"K4 {what}", k4.launch_block_tail.route,
                              hd.shape, dtype, dev, backward=False)
    ref = k4.block_tail_plain(hd, xd, w1, w2, wsa, **kw)
    torch.cuda.synchronize()
    atol, rtol = TRAIN_TOL[("k4", dname)]
    ok, emax, emean = compare(got, ref, atol, rtol)
    if dtype == torch.bfloat16 and emean > K4_BF16_MEAN_TOL:
        ok = False
    vs_tiled = ""
    if route == "resident":
        with tiled_route(k1, k7):
            tiled = fwd()
        t_ok, t_max, t_mean = compare(got, tiled, atol, rtol)
        if dtype == torch.bfloat16 and t_mean > K4_BF16_MEAN_TOL:
            t_ok = False
        ok = ok and t_ok
        vs_tiled = f", vs the tiled route max|d|={t_max:.3e} mean|d|={t_mean:.3e}"
    rec = dict(max_abs_err=emax, route=route)
    if timed:
        ms = route_rounds(k1, k7, fwd, 10)
        rec.update(ms=ms["routed"], tiled_ms=ms["tiled"],
                   plain_ms=cuda_ms(lambda: k4.block_tail_plain(
                       hd, xd, w1, w2, wsa, **kw), 10))
    times = (f" {route} {rec['ms']:.4f} ms, tiled route {rec['tiled_ms']:.4f}"
             f" ms, plain {rec['plain_ms']:.4f} ms") if timed else ""
    log(f"K4 {what} [{route}]: max|d|={emax:.3e} mean|d|={emean:.3e} (atol "
        f"{atol}, rtol {rtol}){vs_tiled}{times} {'ok' if ok else 'FAIL'}")
    records[("k4", pad, dname)] = rec
    if not ok:
        failures.append(f"K4 {what}")

    bwd = lambda: k4.block_tail_bwd(hd, gd, w1, w2, wsa, **kw)
    got = bwd()
    route = expect_tail_route(k4, f"K5 {what}",
                              k4.launch_block_tail_bwd.route, hd.shape,
                              dtype, dev, backward=True)
    ref = k4.block_tail_bwd_plain(hd, gd, w1, w2, wsa, **kw)
    torch.cuda.synchronize()
    tol = K5_TOL[dname]
    parts, bad, worst = k5_agreement(got, ref, dname, tol)
    failures += [f"K5 {what} {b}" for b in bad]
    vs_tiled = ""
    if route == "resident":
        with tiled_route(k1, k7):
            tiled = bwd()
        t_parts, t_bad, _ = k5_agreement(got, tiled, dname, tol)
        failures += [f"K5 {what} {b} vs the tiled route" for b in t_bad]
        vs_tiled = "; vs the tiled route: " + "; ".join(t_parts)
    rec = dict(max_abs_err=worst, route=route)
    if timed:
        ms = route_rounds(k1, k7, bwd, 5)
        rec.update(ms=ms["routed"], tiled_ms=ms["tiled"],
                   plain_ms=cuda_ms(lambda: k4.block_tail_bwd_plain(
                       hd, gd, w1, w2, wsa, **kw), 5))
    times = (f" {route} {rec['ms']:.4f} ms, tiled route {rec['tiled_ms']:.4f}"
             f" ms, plain {rec['plain_ms']:.4f} ms") if timed else ""
    log(f"K5 {what} [{route}]: " + "; ".join(parts) + f" (tol {tol})"
        + vs_tiled + times)
    records[("k5", pad, dname)] = rec
    return failures


# K4 / K5 by parts (phase 6) at the training shape, bf16, pad 1, x_pad 1:
# (label, route, parts). The tiled route's parts are its launches (K4: 1 tile
# statistics, 2 channel gate, 4 spatial tail; K5: the BWD_* flags of
# ops/kernels/block_tail.py); the resident kernels' are compiled out (K4: 1
# the load of h and the tile partials, 2 the grid barriers, merges and gate,
# 4 the rest of the epilogue; K5: 1 the copies in and out, 2 the grid
# barriers and merges, 4 the statistics, gate and maps, 8 the 7x7 adjoint,
# 16 the tile sums and gate adjoint, 32 dh).
K4_PROBES = (("tiled: whole", "tiled", 7), ("tiled: tile statistics", "tiled", 1),
             ("tiled: channel gate", "tiled", 2),
             ("tiled: spatial tail", "tiled", 4),
             ("resident: whole", "resident", 7),
             ("resident: load + tile partials", "resident", 1),
             ("resident: load, partials, barriers, merge, gate", "resident", 3),
             ("resident: without the barriers", "resident", 5))
K5_PROBES = (("tiled: whole", "tiled", 31), ("tiled: stats pass", "tiled", 1),
             ("tiled: 7x7 adjoint in PyTorch", "tiled", 2),
             ("tiled: tile sums + gate adjoint", "tiled", 4),
             ("tiled: apply", "tiled", 8), ("tiled: dx fold", "tiled", 16),
             ("resident: whole", "resident", 63),
             ("resident: copies alone", "resident", 1),
             ("resident: copies + barriers", "resident", 3),
             ("resident: copies + statistics, gate, maps", "resident", 5),
             ("resident: copies + 7x7 adjoint", "resident", 9),
             ("resident: copies + tile sums, gate adjoint", "resident", 17),
             ("resident: copies + dh", "resident", 33),
             ("resident: all but the barriers", "resident", 61))


def check_tail_parts(k1, k4, k7, dev, records, routes=("tiled", "resident")):
    """K4 and K5 by parts at TRAIN_SHAPE, bf16, pad 1 / x_pad 1: the
    K4_PROBES and K5_PROBES rows of ``routes``, median of 3 rounds that
    alternate every row. A part alone reads what the others would have
    left in scratch: its time is right, its output is not."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, hw, _, c = TRAIN_SHAPE
    r = c // 16
    rand = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std
    bf = torch.bfloat16
    h = (rand(*TRAIN_SHAPE) * (rand(c).abs() + 0.5) + rand(c) * 2.0).to(bf)
    x = rand(n, hw + 2, hw + 2, c).to(bf)
    g = rand(n, hw + 2, hw + 2, c).to(bf)
    w1, w2, wsa = rand(c, r, std=0.1), rand(r, c, std=0.1), \
        rand(7, 7, 2, 1, std=0.1)
    kw = dict(pad=1, x_pad=1, eps=1e-5)
    groups = {bwd: k4.tail_groups(n, hw, hw, c, bf, k4.resident_blocks(dev, bwd))
              for bwd in (False, True)}
    if "resident" in routes and not all(groups.values()):
        fail(f"K4/K5 by parts: {TRAIN_SHAPE} is not on the resident route")
    scratch = {(route, bwd): k4.tail_scratch(
        n, hw, hw, c, dev, resident=route == "resident", backward=bwd,
        groups=max(groups[bwd], 1)) for route in routes for bwd in (False, True)}

    def call(route, bwd, parts):
        sc = scratch[(route, bwd)]
        ctx = tiled_route(k1, k7) if route == "tiled" else \
            contextlib.nullcontext()
        with ctx:
            if bwd:
                k4.launch_block_tail_bwd(h, g, w1, w2, wsa, parts=parts,
                                         scratch=sc, **kw)
            else:
                k4.launch_block_tail(h, x, w1, w2, wsa, parts=parts,
                                     scratch=sc, **kw)

    for name, bwd, probes in (("K4", False, K4_PROBES),
                              ("K5", True, K5_PROBES)):
        rows = [p for p in probes if p[1] in routes]
        rounds = {p[0]: [] for p in rows}
        for _ in range(3):
            for label, route, parts in rows:
                rounds[label].append(cuda_ms(
                    lambda: call(route, bwd, parts), 10))
        ms = {k: statistics.median(v) for k, v in rounds.items()}
        records[("tailparts", name)] = ms
        log(f"{name} {TRAIN_SHAPE} pad=1 x_pad=1 bf16 by parts (median of 3 "
            "alternating rounds): " + ", ".join(f"{k} {v:.4f} ms"
                                              for k, v in ms.items()))
    del h, x, g
    torch.cuda.empty_cache()


def write_training_tree(root: Path) -> None:
    """TRAIN_PATIENTS synthetic patients of TRAIN_SLICES 512^2 slices: a
    NCCT series and a CECT series with an enhanced aorta and vessels."""
    from ducosy_tpu_torch.dicom.codec import new_ct_dataset

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


def run_training_phase(k2, k4, tmp: Path, records):
    """Phase 7. Leaves its runs under ``tmp`` (phase 8 serves the first
    run's SOFT_TISSUE snapshot)."""
    from ducosy_tpu_torch.cli import train

    counters = (k2.instance_norm, k2.instance_norm_bwd, k4.block_tail,
                k4.block_tail_bwd)
    names = ("instance_norm", "instance_norm_bwd", "block_tail",
             "block_tail_bwd")
    results = {}
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
            "--num_devices", "1",
            "--num_workers", "8", "--trunk", trunk, "--remat", remat])
        out = out["soft_tissue"]
        secs = time.perf_counter() - t0
        if out["gen_forward"] != "module":
            fail(f"training --trunk {trunk}: the loop ran the "
                 f"{out['gen_forward']} forward, not the module forward")
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
    # every step beside the median: a plain step that drifts between runs
    # of unchanged code shows here as a slow step, an out-of-memory retry
    # (its first step, rebuilt under remat) or an even spread
    for (t, r), out in results.items():
        log(f"training {t} remat={r}: steps "
            f"{[round(v, 4) for v in out['step_seconds']]} s, median of "
            f"steps 2-{TRAIN_STEPS} {med[(t, r)]:.4f}, min "
            f"{min(out['step_seconds'][1:]):.4f}, max "
            f"{max(out['step_seconds'][1:]):.4f}; ended in remat "
            f"{out['remat']}, out-of-memory retry "
            f"{'fired' if out['oom_fallback'] else 'did not fire'}, peak "
            f"{out['peak_memory_bytes'] / 2**30:.2f} GiB")
    records["s_per_step"] = med
    records["train_steps"] = {k: v["step_seconds"] for k, v in results.items()}


def run_masked_cli_phase(counters, k2, dev, tmp: Path):
    """Phase 8: the generate CLI serves phase 7's trained 3-channel
    SOFT_TISSUE snapshot with a seeded 2-channel LUNG generator on one
    synthetic 512^2 DICOM patient (its default engine: packed chain3);
    masks are generated and prefetched on the host."""
    import torch

    from ducosy_tpu_torch.cli import generate
    from ducosy_tpu_torch.dicom import dcmread
    from ducosy_tpu_torch.dicom.codec import new_ct_dataset
    from ducosy_tpu_torch.models.convert import (init_generator_state_dict,
                                                 load_torch_state_dict)

    st_path = tmp / "run_tail_auto" / "soft_tissue" / "saved_models" / \
        "G_A2B_last.pth"
    if not st_path.is_file():
        fail(f"phase 8 needs phase 7's snapshot {st_path}")
    lung_path = tmp / "lung2ch.pth"
    lung = init_generator_state_dict(SEED + 12, 2)
    torch.save({k: torch.from_numpy(v) for k, v in lung.items()},
               str(lung_path))
    vol = chest_phantom(SLICES, SIZE, SEED + 2)
    ncct = tmp / "input8" / "Smoke" / "patient00" / "POST VUE"
    ncct.mkdir(parents=True)
    for i, sl in enumerate(vol):
        ds = new_ct_dataset(SIZE, SIZE, instance_number=i + 1,
                            series_description="POST VUE")
        ds.set_pixel_array(sl.astype(np.uint16))
        ds.save_as(str(ncct / f"{i:04d}.dcm"))
    zero_counts(counters, k2)
    t0 = time.perf_counter()
    done = generate.main([
        "--input_dir_root", str(tmp / "input8"),
        "--output_dir_root", str(tmp / "output8"),
        "--dataset_names", "Smoke", "--img_size", str(SIZE),
        "--slice_batch", str(N), "--soft_tissue_model", str(st_path),
        "--lung_model", str(lung_path)])
    secs = time.perf_counter() - t0
    if done != 1:
        fail(f"masked CLI: {done} patients")
    got = check_cli_launches("masked CLI", counters, k2)
    files = sorted((tmp / "output8" / "Smoke" / "patient00").glob("*.dcm"))
    if len(files) != SLICES:
        fail(f"masked CLI wrote {len(files)} slices, expected {SLICES}")
    out = np.stack([dcmread(str(f)).pixel_array for f in files])
    if out.shape != vol.shape or out.dtype != np.uint16:
        fail(f"masked CLI output {out.dtype} {out.shape}")
    eng = default_engine("8", load_torch_state_dict(str(st_path)), lung,
                         img_size=SIZE, device=dev)
    if (eng.st_channels, eng.lung_channels) != (3, 2):
        fail(f"phase 8 checkpoints have {eng.st_channels}, "
             f"{eng.lung_channels} input channels, expected 3 and 2")
    masks = eng._host_masks(vol, 1.0, -1024.0)
    want = eng.run_patient(vol.astype(np.uint16), 1.0, -1024.0, chunk=N)
    if want.dtype != np.int16 or not np.isfinite(want).all():
        fail(f"masked run_patient output {want.dtype}")
    if not np.array_equal(out, want.astype(np.uint16)):
        d = np.abs(out.astype(np.int32) - want.astype(np.int32))
        fail(f"masked CLI series differs from run_patient: max |d| "
             f"{int(d.max())}, equal on {float(np.mean(d == 0)):.6f}")
    log(f"CLI, trained 3-channel SOFT_TISSUE + seeded 2-channel LUNG: "
        f"{SLICES} slices written, read back and equal to run_patient of "
        f"the default engine, in {secs:.2f} s (incl. engine build and host "
        f"masks); served packed chain3, launches {got}; mask voxels set: "
        + ", ".join(f"{k} {int(v.sum())}" for k, v in masks.items()))


# ---------------------------------------------------------------- phase 7r
def run_resume_phase(k2, k4, dev, tmp: Path, records):
    """Phase 7r: phase 7's tail run saved as the reference's
    checkpoint.pth.tar (trainer.py:580-596), imported into a fresh state
    (networks and Adam states bit for bit), then the training CLI resumed
    from it for one step in phase 7's run directory."""
    import argparse

    import torch

    from ducosy_tpu_torch.cli import train
    from ducosy_tpu_torch.config import SOFT_TISSUE, ModelConfig, TrainConfig
    from ducosy_tpu_torch.train.state import NETS, create_state
    from ducosy_tpu_torch.train.torch_resume import \
        import_reference_checkpoint

    run = tmp / "run_tail_auto"
    saved_dir = run / "soft_tissue" / "saved_models"
    sd = torch.load(str(saved_dir / "checkpoint.pt"), map_location="cpu",
                    weights_only=True)
    opts = {"opt_g": "G", "opt_d_a": "D_A", "opt_d_b": "D_B"}
    ref = {"epoch": sd["epoch"], "best_val_loss": sd["best_val_loss"],
           "best_epoch": sd["best_epoch"],
           "args": argparse.Namespace(epochs=1, batch_size=TRAIN_N)}
    for net, name in zip(NETS, ("G_A2B", "G_B2A", "D_A", "D_B")):
        ref[f"{name}_state_dict"] = sd[net]
    for slot, name in opts.items():
        ref[f"optimizer_{name}_state_dict"] = sd[slot]
        lr = sd[slot]["param_groups"][0]["lr"]
        ref[f"scheduler_{name}_state_dict"] = {
            "last_epoch": sd["epoch"] + 1, "base_lrs": [lr],
            "_last_lr": [lr]}
    path = saved_dir / "checkpoint.pth.tar"
    torch.save(ref, str(path))

    state = create_state(TrainConfig(), SOFT_TISSUE,
                         ModelConfig(num_residual_blocks=BLOCKS), device=dev)
    import_reference_checkpoint(str(path), state)
    for net in NETS:
        for k, v in getattr(state, net).state_dict().items():
            if not torch.equal(v.cpu(), sd[net][k]):
                fail(f"resume: {net} {k} differs from the saved tensor")
    for slot in opts:
        got = getattr(state, slot).state_dict()["state"]
        for i, s0 in sd[slot]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                if not torch.equal(got[i][k].cpu(), s0[k]):
                    fail(f"resume: {slot} state {i} {k} differs")
    del state
    torch.cuda.empty_cache()

    counters = {"instance_norm": k2.instance_norm,
                "instance_norm_bwd": k2.instance_norm_bwd,
                "block_tail": k4.block_tail,
                "block_tail_bwd": k4.block_tail_bwd}
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = train.main([
        "--data_root", str(tmp / "data"), "--dataset_names", "Smoke",
        "--training_dir", str(run), "--img_size", str(SIZE),
        "--batch_size", str(TRAIN_N), "--num_residual_blocks", str(BLOCKS),
        "--epochs", str(sd["epoch"] + 2), "--max_steps_per_epoch", "1",
        "--resume", str(path), "--num_workers", "8", "--trunk", "tail",
        "--remat", "auto", "--num_devices", "1"])["soft_tissue"]
    secs = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    # phase 7's launches a step (7 steps + 2 validation calls of 6
    # generator forwards), for one step + the same validation
    val = 2 * 6 * BLOCKS
    p7 = records["train_launches"]
    want = {k: (p7[k] - (val if k in ("instance_norm", "block_tail") else 0))
            // TRAIN_STEPS + (val if k in ("instance_norm", "block_tail")
                             else 0) for k in counters}
    losses = {k: v for k, v in out.items() if k.startswith("loss")
              or k in ("contrast", "val_loss")}
    if out["epochs_run"] != 1 or not all(np.isfinite(v)
                                         for v in losses.values()):
        fail(f"resume: {out['epochs_run']} epochs, losses {losses}")
    if out["oom_fallback"] or launches != want:
        fail(f"resume launch counts {launches} != {want} (remat fallback: "
             f"{out['oom_fallback']})")
    after = torch.load(str(saved_dir / "checkpoint.pt"), map_location="cpu",
                       weights_only=True)
    if after["epoch"] != sd["epoch"] + 1:
        fail(f"resume: saved epoch {after['epoch']}, expected "
             f"{sd['epoch'] + 1}")
    for slot in opts:
        for i, s0 in sd[slot]["state"].items():
            if float(after[slot]["state"][i]["step"]) != \
                    float(s0["step"]) + 1:
                fail(f"resume: {slot} state {i} step "
                     f"{float(after[slot]['state'][i]['step'])}, saved "
                     f"{float(s0['step'])}")
    log(f"resume from checkpoint.pth.tar: networks and Adam states bit for "
        f"bit; epoch {sd['epoch']} -> {after['epoch']}, Adam steps "
        f"{float(sd['opt_g']['state'][0]['step']):.0f} -> "
        f"{float(after['opt_g']['state'][0]['step']):.0f}; one step + "
        f"validation in {secs:.1f} s (incl. data and model set-up), step "
        f"{out['step_seconds'][0]:.3f} s; launches {launches}; losses "
        f"{losses}")


# -------------------------------------------------------- phases 9w - 9e
def write_series(folder: Path, vol: np.ndarray, desc: str) -> None:
    """A (Z, SIZE, SIZE) stored volume as a uint16 DICOM series."""
    from ducosy_tpu_torch.dicom.codec import new_ct_dataset

    folder.mkdir(parents=True)
    for i, sl in enumerate(vol):
        ds = new_ct_dataset(SIZE, SIZE, instance_number=i + 1,
                            series_description=desc)
        ds.set_pixel_array(sl.astype(np.uint16))
        ds.save_as(str(folder / f"{i:04d}.dcm"))


def within_one(got, ref) -> tuple[float, int]:
    """(share of voxels within 1 stored unit, max |d|)."""
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    return float(np.mean(d <= 1)), int(d.max())


def run_generate_working(counters, k2, st, lung, tmp: Path, tag: str,
                         flags):
    """The generate CLI with --write_working (+ ``flags``) on phase 5's
    patient under ``tmp``: exact launch counts of its default engine
    (packed chain3), the three working series, and the generate_batch
    outputs it downloaded (captured)."""
    import torch

    from ducosy_tpu_torch.cli import generate
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED + 1)     # phase 5's patient
    if not (tmp / "input").is_dir():
        write_series(tmp / "input" / "Smoke" / "patient00" / "POST VUE",
                     vol, "POST VUE")
        for name, sd in (("st", st), ("lung", lung)):
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       str(tmp / f"{name}.pth"))
    captured = []
    original = DualGeneratorEngine.generate_batch

    def capture(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        captured.append(out)
        return out

    zero_counts(counters, k2)
    DualGeneratorEngine.generate_batch = capture
    t0 = time.perf_counter()
    try:
        done = generate.main([
            "--input_dir_root", str(tmp / "input"),
            "--working_dir_root", str(tmp / f"working_{tag}"),
            "--output_dir_root", str(tmp / f"output_{tag}"),
            "--dataset_names", "Smoke", "--img_size", str(SIZE),
            "--slice_batch", str(N), "--soft_tissue_model",
            str(tmp / "st.pth"), "--lung_model", str(tmp / "lung.pth"),
            "--write_working", *flags])
    finally:
        DualGeneratorEngine.generate_batch = original
    secs = time.perf_counter() - t0
    if done != 1 or len(captured) != 1:
        fail(f"{tag}: {done} patients, {len(captured)} generate_batch "
             "calls")
    got = check_cli_launches(f"{tag} CLI", counters, k2)
    out = captured[0]
    wdir = tmp / f"working_{tag}" / "Smoke" / "patient00"
    raw = read_series(wdir / "raw", "POST VUE", tag)
    if not np.array_equal(raw, vol.astype(np.uint16)):
        fail(f"{tag}: raw/ is not the source series")
    for sub, key in (("soft_tissue", "st_stored"), ("lung", "lung_stored")):
        got_sub = read_series(wdir / sub, "Synthetic CECT (from POST VUE)",
                              tag)
        if not np.array_equal(got_sub, out[key].astype(np.uint16)):
            fail(f"{tag}: {sub}/ is not generate_batch's {key} cast to "
                 "the series dtype")
    log(f"CLI --write_working {' '.join(flags)}: 1 patient, {SLICES} "
        f"slices, working series raw/soft_tissue/lung and the final series "
        f"written and read back in {secs:.2f} s (incl. engine build); "
        f"served packed chain3, launches {got}")
    return vol, out, tmp / f"output_{tag}" / "Smoke" / "patient00"


def run_working_phase(counters, k2, st, lung, tmp: Path, fast_series,
                      gen):
    """Phase 9w: --write_working, overwrite synthesis; the final series
    against phase 5's fast-path series."""
    vol, out, final_dir = run_generate_working(counters, k2, st, lung, tmp,
                                               "overwrite", ())
    final = read_series(final_dir, "DuCoSyGAN sCECT v2", "9w")
    share, dmax = within_one(final, fast_series)
    log(f"--write_working final series vs the fast path (phase 5): |d|<=1 "
        f"on {share:.6f} of voxels, max |d| {dmax} stored units")
    if share < STORED_UNIT_SHARE:
        fail(f"9w: final series vs the fast path {share} < "
             f"{STORED_UNIT_SHARE}")
    gen.update(vol=vol, out=out, final=final)


def run_additive_phase(counters, k2, st, lung, tmp: Path, gen):
    """Phase 9a: --synthesis_mode additive; the final series against the
    port's additive_composite + synthesize_volume on the CPU, from the
    generate_batch outputs the CLI downloaded."""
    import torch

    from ducosy_tpu_torch.infer import synthesis

    vol, out, final_dir = run_generate_working(
        counters, k2, st, lung, tmp, "additive",
        ("--synthesis_mode", "additive"))
    final = read_series(final_dir, "DuCoSyGAN sCECT v3", "9a")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    slope, intercept = 1.0, -1024.0            # the phantom's rescale
    merged = synthesis.additive_composite(
        t(vol.astype(np.float32)), t(out["raw_hu"]),
        t(out["st_stored"]) * slope + intercept,
        t(out["lung_stored"]) * slope + intercept, slope)
    want = synthesis.synthesize_volume(merged).numpy().astype(np.uint16)
    share, dmax = within_one(final, want)
    changed = float(np.mean(final != gen["final"]))
    log(f"additive (sCECT v3) vs additive_composite + synthesize_volume on "
        f"the CPU: |d|<=1 on {share:.6f} of voxels, max |d| {dmax}; "
        f"differs from the overwrite series on {changed:.4f} of voxels")
    if share < STORED_UNIT_SHARE:
        fail(f"9a: additive series vs the CPU synthesis {share} < "
             f"{STORED_UNIT_SHARE}")


def run_postprocess_phase(dev, gen):
    """Phase 9p: each postprocess method (JAX defaults, sharpening on) on
    the card and on the CPU, on 9w's merged (overwrite) volume."""
    import torch

    from ducosy_tpu_torch.infer import postprocess, synthesis

    out = gen["out"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    merged = synthesis.composite_volume(
        t(gen["vol"].astype(np.float32)), t(out["raw_hu"]),
        t(out["st_stored"]), t(out["lung_stored"]))
    on_card = merged.to(dev)
    for method in postprocess.METHODS:
        run = lambda: postprocess.postprocess_ct_volume(on_card, method)
        got = run().cpu().numpy()
        ref = postprocess.postprocess_ct_volume(merged, method).numpy()
        share, dmax = within_one(got, ref)
        ms = cuda_ms(run, 3)
        log(f"postprocess {method}: card vs CPU |d|<=1 on {share:.6f} of "
            f"voxels, max |d| {dmax}; {ms:.3f} ms a volume "
            f"({SLICES} x {SIZE}^2, CUDA events"
            f"{', host spline included' if method == 'interpolation' else ''}"
            ")")
        if share < STORED_UNIT_SHARE:
            fail(f"9p: {method} card vs CPU {share} < {STORED_UNIT_SHARE}")


def read_detail(root: Path) -> dict:
    """The per-slice MS-SSIM and LPIPS columns of 9e's detail CSV."""
    import csv

    path = root / "calculated" / "detail" / "Smoke_patient00_metrics.csv"
    with open(path) as f:
        rows = list(csv.reader(f))
    cols = {m: rows[0].index(f"{m}_STD_vs_Generated")
            for m in ("ms_ssim", "lpips")}
    return {m: np.array([float(r[c]) for r in rows[1:]])
            for m, c in cols.items()}


def lpips_params(seed: int) -> dict:
    """Seeded LPIPS-AlexNet weights in the canonical layout."""
    from ducosy_tpu_torch.eval.lpips import _CONVS

    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, (_, cout, k, _, _) in enumerate(_CONVS):
        params[f"conv{i}_w"] = rng.normal(
            0, 0.05, (cout, cin, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.05, cout).astype(np.float32)
        params[f"lin{i}"] = np.abs(rng.normal(0, 0.1, cout)).astype(
            np.float32)
        cin = cout
    return params


def run_calculate_phase(dev, tmp: Path):
    """Phase 9e: the calculate CLI (--fast --num_workers 2) on the card and
    on the CPU: POST VUE the phantom, POST STD it with contrast, generated
    9w's final series; seeded LPIPS weights through $DUCOSY_LPIPS_WEIGHTS."""
    import os
    import shutil

    from ducosy_tpu_torch.cli import calculate
    from ducosy_tpu_torch.eval import lpips, metrics, report

    pdir = tmp / "eval_input" / "Smoke" / "patient00"
    write_series(pdir / "POST VUE", chest_phantom(SLICES, SIZE, SEED + 1),
                 "POST VUE")
    write_series(pdir / "POST STD",
                 chest_phantom(SLICES, SIZE, SEED + 1, contrast=True),
                 "POST STD")
    weights = str(tmp / "lpips_alex.npz")
    lpips.save_lpips_weights_npz(lpips_params(SEED + 30), weights)
    saved_env = os.environ.get(lpips.ENV_WEIGHTS)
    os.environ[lpips.ENV_WEIGHTS] = weights
    results, secs = {}, {}
    try:
        for device in ("cuda", "cpu"):
            root = tmp / f"eval_output_{device}"
            shutil.copytree(tmp / "output_overwrite", root)
            t0 = time.perf_counter()
            results[device] = calculate.main([
                "--input_dir_root", str(tmp / "eval_input"),
                "--output_dir_root", str(root), "--dataset_names", "Smoke",
                "--fast", "--num_workers", "2", "--device", device])
            secs[device] = time.perf_counter() - t0
    finally:
        if saved_env is None:
            del os.environ[lpips.ENV_WEIGHTS]
        else:
            os.environ[lpips.ENV_WEIGHTS] = saved_env
    card, host = (results[d]["Smoke/patient00"] for d in ("cuda", "cpu"))
    check_card_vs_cpu("9e", card, host)
    slices = {d: read_detail(tmp / f"eval_output_{d}")
              for d in ("cuda", "cpu")}
    d_ms = np.abs(slices["cuda"]["ms_ssim"] - slices["cpu"]["ms_ssim"])
    r_lp = np.abs(slices["cuda"]["lpips"] / slices["cpu"]["lpips"] - 1)
    if not (d_ms.max() <= 1e-5 and r_lp.max() <= 2e-4):
        fail(f"9e: per-slice MS-SSIM |d| {d_ms.max()}, LPIPS rel "
             f"{r_lp.max()} between the card and the CPU")
    log("calculate CLI: card vs CPU host metrics equal, MS-SSIM |d| "
        f"{abs(card['ms_ssim'][0] - host['ms_ssim'][0]):.2e} (per slice "
        f"max {d_ms.max():.2e}), LPIPS rel "
        f"{abs(card['lpips'][0] / host['lpips'][0] - 1):.2e} (per slice "
        f"max {r_lp.max():.2e}); values "
        + ", ".join(f"{m} {card[m][0]:.6g}" for m in report.ALL_METRICS)
        + f"; wall {secs['cuda']:.2f} s (--device cuda) vs "
        f"{secs['cpu']:.2f} s (--device cpu), 1 patient of {SLICES} x "
        f"{SIZE}^2, 2 spawn workers, conversion included")
    data = tmp / "eval_output_cuda" / "calculated" / "data"
    std = report._normalize(np.load(data / "Smoke_patient00_std.npy"))
    gen = report._normalize(np.load(data / "Smoke_patient00_generated.npy"))
    ms_ssim_ms = cuda_ms(lambda: metrics.calculate_ms_ssim(std, gen,
                                                           device=dev), 3)
    lpips_ms = cuda_ms(lambda: metrics.calculate_lpips(
        std, gen, weights_path=weights, device=dev), 3)
    log(f"card time for one {SLICES}-slice patient (CUDA events, upload "
        f"and per-slice download included): MS-SSIM {ms_ssim_ms:.3f} ms, "
        f"LPIPS {lpips_ms:.3f} ms")


# ------------------------------------------------------------ phases 11, 12
# Phase 11: the masking workflow on 9e's tree, a TotalSegmentator stand-in
# first on the PATH of the CLI's workers. Checks: each masked series has as
# many 9999 pixels as the exclusion mask has voxels and the source's pixels
# elsewhere; the masked scores, card against CPU, by 9e's rule; the masked
# scores differ from 9e's; the mapping CSVs' rows; with the stand-in off the
# PATH, each patient reports the missing binary and the stage returns.
# Phase 12: the aux model (NModelConfig defaults: standard UNet3D, base 16,
# (1, 512, 512) patches, batch 1, lr 5e-5, clip 1.0, fp32) trained on a
# phantom diff tree, then predicting phase 4's phantom. Bounds set before
# the first run: load_model on a checkpoint predicts what the saved module
# predicts, exactly (cuDNN deterministic); the card's prediction within
# NM_PREDICT_TOL_HU of the CPU's (fp32, TF32 off) on every voxel.
NM_PATIENTS, NM_SLICES = 4, 4      # the phantom diff tree
NM_EPOCHS, NM_MAX_STEPS = 2, 10    # train_nmodel: 20 steps
NM_TIMED = 6                       # timed steps (median of the 5 after one)
NM_PREDICT_TOL_HU = 0.5

TOTALSEG_STAND_IN = """#!{python}
# TotalSegmentator stand-in: -i <nifti> -o <out> --device D --ml writes a
# multi-label <out>.nii from the input HU (x, y, z): aorta 52 (contrast),
# lung vessels 55, heart 51 (soft tissue in a disk, and a blob beyond a
# z gap that the heart cleanup cuts), lungs 13 and spine 30 (not targets)
import sys
sys.path.insert(0, {root!r})
import numpy as np
from ducosy_tpu_torch.dicom.nifti import read_nifti, write_nifti
args = sys.argv[1:]
src, out = args[args.index("-i") + 1], args[args.index("-o") + 1]
assert args[args.index("--device") + 1] == "gpu" and "--ml" in args
hu, affine = read_nifti(src)
nx, ny, nz = hu.shape
xx = (np.arange(nx) / nx)[:, None, None]
yy = (np.arange(ny) / ny)[None, :, None]
zz = np.arange(nz)[None, None, :]
labels = np.zeros(hu.shape, np.uint8)
labels[hu < -500] = 13
labels[(hu > 100) & (hu < 250)] = 55
labels[(hu > 250) & (hu < 500)] = 52
labels[hu > 500] = 30
disk = (yy - 0.62) ** 2 + (xx - 0.5) ** 2
cut = int(0.55 * nz)
soft = (hu > -100) & (hu < 100)
labels[soft & (disk < 0.09 ** 2) & (zz < cut)] = 51
labels[soft & (disk < 0.04 ** 2) & (zz >= cut + 3)] = 51
write_nifti(out + ".nii", labels, affine)
"""


def write_stand_in(bin_dir: Path) -> str:
    bin_dir.mkdir(parents=True, exist_ok=True)
    path = bin_dir / "TotalSegmentator"
    path.write_text(TOTALSEG_STAND_IN.format(python=sys.executable,
                                             root=str(ROOT)))
    path.chmod(0o755)
    return str(bin_dir)


def check_card_vs_cpu(what: str, card: dict, host: dict) -> None:
    """9e's rule: host metrics equal, MS-SSIM within 1e-5, LPIPS within
    rtol 2e-4, MS-SSIM and LPIPS finite."""
    from ducosy_tpu_torch.eval import report

    for m in report.ALL_METRICS:
        a, b = np.asarray(card[m], np.float64), np.asarray(host[m],
                                                           np.float64)
        if m in ("ms_ssim", "lpips"):
            ok = np.all(np.isfinite(a)) and (
                np.allclose(a, b, rtol=0, atol=1e-5) if m == "ms_ssim"
                else np.allclose(a, b, rtol=2e-4, atol=0))
        else:
            ok = card[m] == host[m]
        if not ok:
            fail(f"{what}: {m} on the card {card[m]} vs the CPU {host[m]}")


def run_cli(main, argv) -> tuple[str, float]:
    """A CLI's ``main`` in this process: (its standard output, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    secs = time.perf_counter() - t0
    log("    " + buf.getvalue().strip().replace("\n", "\n    "))
    return buf.getvalue(), secs


@contextlib.contextmanager
def env_path(first: str | None):
    """PATH with ``first`` in front (None: as it was), restored after."""
    import os

    saved = os.environ.get("PATH", "")
    os.environ["PATH"] = (first + os.pathsep + saved) if first else saved
    try:
        yield
    finally:
        os.environ["PATH"] = saved


def run_masking_phase(dev, tmp: Path):
    """Phase 11: masking --stage generate (the stand-in) ->
    modify_heart_mask -> masking --stage masking -> calculate --mask on the
    card and on the CPU -> anonymize and anonymize --mask, on 9e's tree;
    then the generate stage without the binary, and visualize and
    mask_preview where PIL imports."""
    import csv
    import os
    import pickle
    import shutil

    from ducosy_tpu_torch.cli import (anonymize, calculate, masking,
                                      modify_heart_mask)
    from ducosy_tpu_torch.dicom.nifti import read_nifti
    from ducosy_tpu_torch.eval import lpips
    from ducosy_tpu_torch.masks.totalseg import (MASK_FILL_VALUE,
                                                 build_exclusion_mask)

    inp, root = tmp / "eval_input", tmp / "mask_output"
    shutil.copytree(tmp / "output_overwrite", root)
    pid = "patient00"
    common = ["--input_dir_root", str(inp), "--output_dir_root", str(root),
              "--dataset_names", "Smoke"]
    secs = {}
    with env_path(write_stand_in(tmp / "bin")):
        out, secs["generate"] = run_cli(
            masking.main, common + ["--stage", "generate", "--batch_size",
                                    "1"])
    if f"  {pid}: OK" not in out.splitlines():
        fail(f"11: the generate stage did not segment {pid}: {out!r}")
    _, secs["modify_heart_mask"] = run_cli(modify_heart_mask.main, [
        "--output_dir_root", str(root), "--dataset_names", "Smoke",
        "--num_workers", "1"])
    raw, _ = read_nifti(str(root / "mask" / "Smoke" / f"{pid}.nii"))
    cleaned, _ = read_nifti(str(root / "modified_mask" / "Smoke"
                                / f"{pid}.nii"))
    cut = int(0.55 * SLICES)
    heart = [int((v == 51).sum()) for v in (raw, cleaned)]
    if not (0 < heart[1] < heart[0] and (raw[..., cut + 3:] == 51).any()
            and not (cleaned[..., cut:] == 51).any()
            and ((raw == 52) == (cleaned == 52)).all()):
        fail(f"11: heart cleanup: label 51 {heart[0]} -> {heart[1]} voxels, "
             "the blob beyond the z gap not cut, or another label moved")
    _, secs["masking"] = run_cli(masking.main, common + ["--stage",
                                                         "masking"])
    excl = build_exclusion_mask(np.transpose(cleaned, (2, 1, 0)))
    n_excl = int(excl.sum())
    sources = {"POST VUE": inp / "Smoke" / pid / "POST VUE",
               "POST STD": inp / "Smoke" / pid / "POST STD",
               "generated": root / "Smoke" / pid}
    for sub, src in sources.items():
        got = read_series(root / "masked" / "Smoke" / pid / sub, None,
                          f"11 masked {sub}")
        want = read_series(src, None, f"11 {sub}").astype(np.int16)
        fill = got == MASK_FILL_VALUE
        if not (int(fill.sum()) == n_excl and (fill == (excl != 0)).all()
                and np.array_equal(got[~fill], want[~fill])):
            fail(f"11: masked {sub}: {int(fill.sum())} pixels at "
                 f"{MASK_FILL_VALUE} for {n_excl} mask voxels, or another "
                 "pixel moved")
    log(f"masked 3 series of {SLICES} x {SIZE}^2: {n_excl} voxels a series "
        f"({100.0 * n_excl / excl.size:.3f}% masked), heart {heart[0]} -> "
        f"{heart[1]} voxels after cleanup")

    weights = str(tmp / "lpips_alex.npz")
    saved_env = os.environ.get(lpips.ENV_WEIGHTS)
    os.environ[lpips.ENV_WEIGHTS] = weights
    results = {}
    try:
        for device in ("cuda", "cpu"):
            droot = tmp / f"mask_eval_{device}"
            shutil.copytree(root / "masked", droot / "masked")
            t0 = time.perf_counter()
            results[device] = calculate.main([
                "--input_dir_root", str(inp), "--output_dir_root",
                str(droot), "--dataset_names", "Smoke", "--fast", "--mask",
                "--num_workers", "2", "--device", device])
            secs[f"calculate --mask ({device})"] = time.perf_counter() - t0
    finally:
        if saved_env is None:
            del os.environ[lpips.ENV_WEIGHTS]
        else:
            os.environ[lpips.ENV_WEIGHTS] = saved_env
    card, host = (results[d][f"Smoke/{pid}"] for d in ("cuda", "cpu"))
    check_card_vs_cpu("11 calculate --mask", card, host)
    with open(tmp / "eval_output_cuda" / "calculated" / "results.pkl",
              "rb") as f:
        unmasked = pickle.load(f)[f"Smoke/{pid}"]
    moved = [m for m in card if card[m] != unmasked[m]]
    if "mae" not in moved or "ms_ssim" not in moved:
        fail(f"11: the masked scores {card} equal 9e's unmasked {unmasked}")
    log("masked calculate: card vs CPU host metrics equal, MS-SSIM |d| "
        f"{abs(card['ms_ssim'][0] - host['ms_ssim'][0]):.2e}, LPIPS rel "
        f"{abs(card['lpips'][0] / host['lpips'][0] - 1):.2e}; masked vs "
        "unmasked (card) " + ", ".join(
            f"{m} {card[m][0]:.6g} vs {unmasked[m][0]:.6g}"
            for m in ("mae", "psnr", "ssim", "ms_ssim", "lpips")))

    for flag in ((), ("--mask",)):
        _, secs[f"anonymize {' '.join(flag)}".strip()] = run_cli(
            anonymize.main, common + list(flag))
        with open(root / "anonymization_mapping.csv") as f:
            rows = list(csv.reader(f))
        vols = sorted((root / "anonymized").glob("*.npy"))
        want = [["Category", "Site", "OriginalPatientID",
                 "AnonymizedPatientID"]] + [[c, "Smoke", pid] for c in (
                     "original", "generated")]
        if [r[:3] if i else r for i, r in enumerate(rows)] != want or \
                sorted(r[3] + ".npy" for r in rows[1:]) != \
                [v.name for v in vols]:
            fail(f"11: anonymize {flag}: mapping rows {rows}, volumes "
                 f"{[v.name for v in vols]}")
        for v in vols:
            a = np.load(v)
            filled = int((a == MASK_FILL_VALUE - 1024).sum())
            if a.shape != (SLICES, SIZE, SIZE) or a.dtype != np.int16 or \
                    (flag and filled != n_excl):
                fail(f"11: anonymize {flag}: {v.name} {a.shape} {a.dtype}, "
                     f"{filled} masked voxels")

    missing = tmp / "mask_missing"
    with env_path(None):
        out, secs["generate without the binary"] = run_cli(
            masking.main, ["--input_dir_root", str(inp), "--output_dir_root",
                           str(missing), "--dataset_names", "Smoke",
                           "--stage", "generate", "--batch_size", "1"])
    if f"  {pid}: FAILED — TotalSegmentator command not found" not in \
            out.splitlines() or any((missing / "mask" / "Smoke").iterdir()):
        fail(f"11: the generate stage without the binary printed {out!r}")
    try:
        import PIL  # noqa: F401
    except ImportError as err:
        log(f"visualize and mask_preview not run: PIL does not import on "
            f"this machine ({err})")
    else:
        from ducosy_tpu_torch.cli import mask_preview, visualize

        _, secs["visualize"] = run_cli(visualize.main, common + [
            "--num_workers", "4"])
        if len(list((root / "visualized").rglob("*.png"))) != SLICES + 1:
            fail("11: visualize did not write a comparison a slice and the "
                 "grid")
        png = tmp / "mask_preview.png"
        out, secs["mask_preview"] = run_cli(mask_preview.main, [
            str(sorted((inp / "Smoke" / pid / "POST VUE").glob("*.dcm"))[0]),
            "--output", str(png)])
        if not png.is_file() or "lung_vessel" not in out:
            fail("11: mask_preview wrote no overlay or no statistics")
    log("wall: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f", 1 patient of {SLICES} x {SIZE}^2 ({gpu_line()})")


def write_diff_tree(root: Path) -> None:
    """vue/{pid}_vue.npy (phantom HU) and diff_map/{pid}_diff.npy (the
    phantom with contrast minus the plain one, clipped at 0)."""
    for sub in ("vue", "diff_map"):
        (root / sub).mkdir(parents=True)
    for k in range(NM_PATIENTS):
        seed = SEED + 40 + k
        plain = chest_phantom(NM_SLICES, SIZE, seed).astype(np.float32) \
            - 1024.0
        post = chest_phantom(NM_SLICES, SIZE, seed, contrast=True).astype(
            np.float32) - 1024.0
        np.save(root / "vue" / f"p{k}_vue.npy", plain)
        np.save(root / "diff_map" / f"p{k}_diff.npy",
                np.maximum(post - plain, 0.0))


def run_nmodel_phase(dev, tmp: Path):
    """Phase 12: train_nmodel (20 steps over 2 epochs), its checkpoints and
    running statistics; NM_TIMED timed steps; load_model exact on the card;
    predict_volume on phase 4's phantom, card against CPU; one step and one
    prediction of UNet3DLight."""
    import json

    import torch

    from ducosy_tpu_torch.models import unet3d
    from ducosy_tpu_torch.models.nmodel_data import (CTDiffDataset,
                                                     NModelConfig)
    from ducosy_tpu_torch.train import nmodel_loop

    data = tmp / "nmodel_data"
    write_diff_tree(data)
    cfg = NModelConfig(data_dir=str(data), output_dir=str(tmp / "nmodel"),
                       patches_per_volume=NM_SLICES)
    card = gpu_line()
    t0 = time.perf_counter()
    summary = nmodel_loop.train_nmodel(cfg, max_epochs=NM_EPOCHS,
                                       max_steps=NM_MAX_STEPS, device=dev)
    train_s = time.perf_counter() - t0
    with open(tmp / "nmodel" / "nmodel_metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    ckpt = {n: Path(cfg.checkpoint_dir) / f"nmodel_{n}.pth"
            for n in ("latest", "best")}
    if [r["epoch"] for r in records] != list(range(1, NM_EPOCHS + 1)) or \
            not all(np.isfinite(r["train_l1"]) and np.isfinite(r["val_l1"])
                    for r in records) or \
            not np.isfinite(summary["val_l1"]) or \
            not all(p.is_file() for p in ckpt.values()):
        fail(f"12: train_nmodel: {records}, {summary}, checkpoints "
             f"{[p.is_file() for p in ckpt.values()]}")
    trained = unet3d.load_model(str(ckpt["latest"]), device=dev)
    norms = [m for m in trained.modules() if isinstance(m, unet3d.BatchNorm)]
    steps = NM_EPOCHS * NM_MAX_STEPS
    if not all(int(m.num_batches_tracked) == steps for m in norms) or \
            not all(float((m.running_var - 1).abs().max()) > 0 and
                    float(m.running_mean.abs().max()) > 0 for m in norms):
        fail("12: the BatchNorm running statistics did not move "
             f"{steps} steps")
    log(f"train_nmodel: {steps} steps over {NM_EPOCHS} epochs in "
        f"{train_s:.2f} s; train L1 "
        + ", ".join(f"{r['train_l1']:.5f}" for r in records)
        + ", val L1 " + ", ".join(f"{r['val_l1']:.5f}" for r in records)
        + f"; {len(norms)} norms' running statistics moved")

    ds = CTDiffDataset(str(data), "train", patch_size=cfg.patch_size,
                       patches_per_volume=NM_SLICES)
    batches = [{k: v[None] for k, v in ds[i].items()}
               for i in range(NM_TIMED)]
    torch.manual_seed(SEED)
    model = nmodel_loop.build_nmodel(cfg).to(dev)
    _, step, _ = nmodel_loop.make_nmodel_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(step(b)))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    if not np.all(np.isfinite(losses)):
        fail(f"12: step losses {losses}")
    path = tmp / "nmodel_timed.pth"
    nmodel_loop.save_nmodel_pth(str(path), model)
    loaded = unet3d.load_model(str(path), device=dev)
    vol = chest_phantom(SLICES, SIZE, SEED).astype(np.float32) - 1024.0
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        want = unet3d.predict_volume(model, vol, device=dev)
        got = unet3d.predict_volume(loaded, vol, device=dev)
        t0 = time.perf_counter()
        unet3d.predict_volume(loaded, vol, device=dev)
        predict_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    if not np.array_equal(got, want):
        fail(f"12: load_model's prediction differs from the saved module's "
             f"by {np.abs(got - want).max()} HU")
    t0 = time.perf_counter()
    host = unet3d.predict_volume(unet3d.load_model(str(path), device="cpu"),
                                 vol, device="cpu")
    host_s = time.perf_counter() - t0
    d = np.abs(got - host)
    if got.shape != vol.shape or not np.all(np.isfinite(got)) or \
            d.max() > NM_PREDICT_TOL_HU:
        fail(f"12: predict_volume card vs CPU max |d| {d.max()} HU "
             f"(bound {NM_PREDICT_TOL_HU})")

    light_cfg = NModelConfig(model_type="light",
                             patches_per_volume=NM_SLICES)
    torch.manual_seed(SEED)
    light = nmodel_loop.build_nmodel(light_cfg).to(dev)
    _, light_step, _ = nmodel_loop.make_nmodel_step(light, light_cfg)
    light_loss = float(light_step(batches[0]))
    light_pred = unet3d.predict_volume(light, vol[:8], device=dev)
    if not (isinstance(light, unet3d.UNet3DLight) and
            np.isfinite(light_loss) and np.all(np.isfinite(light_pred))):
        fail(f"12: UNet3DLight step loss {light_loss}, prediction finite "
             f"{np.all(np.isfinite(light_pred))}")
    log(f"UNet3D base {cfg.base_channels} at {cfg.patch_size}, batch 1, "
        f"fp32: {statistics.median(times[1:]):.4f} s a step (median of "
        f"{NM_TIMED - 1} after the first {times[0]:.3f} s), peak "
        f"{peak / 2**30:.2f} GiB; predict_volume {SLICES} slices "
        f"{SLICES / predict_s:.2f} slices/s (slice_batch 8, upload and "
        f"download included); card vs CPU max |d| {d.max():.3e} HU, mean "
        f"{d.mean():.3e} (CPU {host_s:.2f} s); load_model exact; "
        f"UNet3DLight step loss {light_loss:.5f} ({card})")


# ------------------------------------------------------------ phases 10
# Phase 10t: the data-parallel step against one rank, tolerances set before
# any run. Two ranks of 4 rows and one rank of 8 take TRAIN_DP_STEPS steps
# from the same init on the same global batches (bf16 compute, fp32
# parameters, remat off):
#  - the two ranks' parameters after each step: equal (max |d| 0): both
#    apply the same all-reduced gradients to the same state;
#  - the first step's losses (the same parameters on both sides): each rank
#    computes the global batch's loss on the gathered inputs, which differ
#    from one rank's only where a conv of 4 rows and one of 8 round
#    differently in bf16: rtol DP_LOSS_RTOL. The later steps' are printed:
#    their parameters differ by the sign flips below (this phase has read a
#    term 1.4% apart at step 3, against 1.3e-4 at step 1);
#  - the first step's gradients (the same parameters on both sides) over
#    the weight tensors (a bias that feeds a norm has rounding noise for its
#    gradient): rel-L2 <= DP_GRAD_REL; a gradient summed over the ranks
#    where it should be averaged reads 1.0;
#  - the parameter update over the weight tensors: rel-L2 <= DP_UPDATE_REL.
#    Adam's first steps are ~lr * sign(g): a gradient near zero whose sign
#    differs between the runs moves its update by 2 lr, so 1% of such
#    elements read ~0.2. The gradient bound is the sharper test.
# Phase 10s: two replicas on one card, phase 4's patient and generators,
# chain trunk, chunk N in parts of N/2, cuDNN's autotuner off as in phase 4:
#  - bf16: >= DP_SERVE_SHARE of voxels within 1 stored unit of the
#    single-device engine called on the same parts (chunk N/2). Not of
#    phase 4's chunk-N series: this phase reads 84.4% there, and the same
#    84.4% for the single-device engine alone between chunk N and N/2 (it
#    prints both), as bf16 roundings of another call size grow through the
#    seeded generators;
#  - fp32: >= DP_SERVE_SHARE within 1 stored unit of the single-device
#    engine at chunk N (read: 100%, max |d| 1).
TRAIN_DP_STEPS = 3
DP_LOSS_RTOL = 1e-2
DP_GRAD_REL = 5e-2
DP_UPDATE_REL = 0.25
DP_SERVE_SHARE = 0.9999


# Phase 13: the masking CLI's segmenter at TotalSegmentator's 3d_fullres
# widths (nnU-Net's default plan for CT at 1.5 mm; 25 classes, the organs
# part), bf16, SEG_PATCH_BATCH patches a forward, torch's default init
SEG_PLAN = {"input_channels": 1, "features": [32, 64, 128, 256, 320, 320],
            "kernel_sizes": [[3, 3, 3]] * 6,
            "strides": [[1, 1, 1]] + [[2, 2, 2]] * 5,
            "n_conv_per_stage": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
            "classes": 25, "patch_size": [128, 128, 128],
            "spacing": [1.5, 1.5, 1.5],
            "normalization": {"lower": -1000.0, "upper": 1500.0,
                              "mean": 50.0, "std": 350.0},
            "step": 0.5}
SEG_PATCH_BATCH = 4
SEG_NORMS_PER_FORWARD = 22    # 6 encoder and 5 decoder stages, 2 norms each
SEG_SLOPE = 0.01
# 248 slices at 1 mm of 512^2 at 0.7 mm: 165 x 239 x 239 at 1.5 mm, whose
# origins at step 0.5 are 2 x 3 x 3 = 18 patches, 5 forwards
SEG_SLICES, SEG_SPACING, SEG_PATCHES = 248, (1.0, 0.7, 0.7), 18
# K2 3-D (label, shape) at a forward of 4 patches: stage 0 and decoder
# stage 0 (the most bytes), the 8^3 and 4^3 stages at 320 channels (the
# fewest voxels a channel)
K2_3D_CASES = (("128^3 x 32", (SEG_PATCH_BATCH, 128, 128, 128, 32)),
               ("8^3 x 320", (SEG_PATCH_BATCH, 8, 8, 8, 320)),
               ("4^3 x 320", (SEG_PATCH_BATCH, 4, 4, 4, 320)))


def in3d_bound(shape, itemsize: int) -> dict:
    """K2 3-D's bound: x read once, the output written once, 10 fp32
    operations an element (the norm's 8, the affine and the slope)."""
    inner = float(np.prod(shape))
    return bound(2 * inner * itemsize, fp32=10 * inner)


def check_instance_norm3d(k2, dev, records):
    """Phase 13: K2's 3-D route against its plain version at the
    segmenter's shapes, bf16, affine, LeakyReLU SEG_SLOPE (the K2 bf16
    tolerance: one bf16 ulp), timed beside its bytes bound."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    atol, rtol = TOL[("k2", "bfloat16")]
    failures = []
    for name, shape in K2_3D_CASES:
        c = shape[-1]
        x = k2_input(shape, gen, dev).to(torch.bfloat16)
        w = 1 + 0.3 * torch.randn(c, generator=gen, device=dev)
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        kernel = lambda: k2.instance_norm3d(x, w, b, negative_slope=SEG_SLOPE)
        plain = lambda: k2.instance_norm3d_plain(x, w, b,
                                                 negative_slope=SEG_SLOPE)
        ok, emax, emean = compare(kernel(), plain(), atol, rtol)
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 20)
        bnd = in3d_bound(shape, x.element_size())
        log(f"K2 3-D {name} {shape} bf16 affine slope {SEG_SLOPE}: "
            f"max|d|={emax:.3e} mean|d|={emean:.3e} (atol {atol}, rtol "
            f"{rtol}) kernel {ms:.4f} ms = {bnd['bound_ms'] / ms:.0%} of its "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), plain "
            f"{plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        records[("k2_3d", name)] = dict(max_abs_err=emax, ms=ms,
                                        plain_ms=plain_ms, bound=bnd)
        if not ok:
            failures.append(f"K2 3-D {name}")
        del x
    torch.cuda.empty_cache()
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")


def run_segmenter_phase(k2, dev, records):
    """Phase 13: one full-width patient through the masking CLI's
    segmenter; every norm a K2 3-D launch."""
    import torch

    from ducosy_tpu_torch.infer.segment import Segmenter
    from ducosy_tpu_torch.models.nnunet import PlainConvUNet

    torch.manual_seed(SEED + 13)
    segmenter = Segmenter(PlainConvUNet(SEG_PLAN), SEG_PLAN, device=dev,
                          patch_batch=SEG_PATCH_BATCH)
    hu = (chest_phantom(SEG_SLICES, SIZE, SEED + 13).astype(np.int32)
          - 1024).astype(np.int16)
    segmenter.download(segmenter.segment_async(hu, SEG_SPACING))  # warm-up
    torch.cuda.synchronize()
    k2.instance_norm3d.launches = 0
    flat = k2.instance_norm.launches
    t0 = time.perf_counter()
    labels = segmenter.download(segmenter.segment_async(hu, SEG_SPACING))
    took = time.perf_counter() - t0
    forwards = -(-SEG_PATCHES // SEG_PATCH_BATCH)
    want = SEG_NORMS_PER_FORWARD * forwards
    got = k2.instance_norm3d.launches
    log(f"segmenter: {SEG_SLICES}-slice {SIZE}^2 patient, {SEG_PATCHES} "
        f"patches in {forwards} forwards of up to {SEG_PATCH_BATCH}: "
        f"{took:.3f} s ({SEG_SLICES / took:.1f} slices/s), K2 3-D launches "
        f"{got} (want {want}), 2-D K2 launches "
        f"{k2.instance_norm.launches - flat} (want 0), labels "
        f"{labels.dtype} {labels.shape} max {labels.max()}")
    if got != want or k2.instance_norm.launches != flat:
        fail(f"segmenter: K2 3-D launches {got}, 2-D "
             f"{k2.instance_norm.launches - flat}; want {want} and 0: a "
             "norm left K2's 3-D route")
    if labels.dtype != np.uint8 or labels.shape != hu.shape or \
            labels.max() >= SEG_PLAN["classes"]:
        fail(f"segmenter: labels {labels.dtype} {labels.shape} max "
             f"{labels.max()}; want uint8 {hu.shape} below "
             f"{SEG_PLAN['classes']}")
    records["seg_launches"] = got
    del segmenter
    torch.cuda.empty_cache()


def rel_l2(got: dict, ref: dict) -> float:
    """Relative L2 error over the weight tensors of NETS-keyed arrays."""
    num = den = 0.0
    for net in ref:
        for name, r in ref[net].items():
            if name.endswith(".weight"):
                num += float(np.sum((got[net][name] - r) ** 2.0))
                den += float(np.sum(np.asarray(r, np.float64) ** 2))
    return (num / den) ** 0.5


def dp_batches(data: Path) -> list:
    """TRAIN_DP_STEPS global batches of TRAIN_N from phase 7's tree."""
    from ducosy_tpu_torch.config import SOFT_TISSUE
    from ducosy_tpu_torch.data.dataset import SlicePairDataset
    from ducosy_tpu_torch.data.pairing import list_patient_dirs

    ds = SlicePairDataset(list_patient_dirs(str(data), "Smoke"), SOFT_TISSUE,
                          img_size=SIZE)
    out = []
    for i in range(TRAIN_DP_STEPS):
        items = [ds[(i * TRAIN_N + j) % len(ds)] for j in range(TRAIN_N)]
        out.append({k: np.stack([it[k] for it in items]) for k in items[0]})
    return out


def free_card(what: str) -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"{what}: card memory free {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB")


def run_dp_training_phase(devices, backend: str, data: Path, label: str):
    """Phase 10t (10n: across cards): ``len(devices)`` ranks of the
    data-parallel step against one rank at the global batch, from the same
    init and batches."""
    import torch

    from ducosy_tpu_torch.config import ModelConfig, SOFT_TISSUE, \
        TrainConfig, replace
    from ducosy_tpu_torch.parallel.launch import spawn
    from ducosy_tpu_torch.train.loop import run_steps
    from ducosy_tpu_torch.train.state import init_state_dicts

    cfg = replace(TrainConfig(), img_size=SIZE, batch_size=TRAIN_N)
    model = ModelConfig(num_residual_blocks=BLOCKS)
    init = init_state_dicts(SEED + 30, SOFT_TISSUE, model)
    batches = dp_batches(data)
    kw = dict(trunk="tail", remat=False)
    free_card(f"{label} before spawning {len(devices)} ranks")
    t0 = time.perf_counter()
    ranks = spawn(run_steps, (init, batches, cfg, SOFT_TISSUE, model),
                  devices, kwargs=kw, backend=backend, timeout=600)
    secs = time.perf_counter() - t0
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False   # as in the ranks
    try:
        one = run_steps(devices[0], init, batches, cfg, SOFT_TISSUE, model,
                        **kw)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    free_card(f"{label} after the one-rank run")
    per_step = {k: 6 * BLOCKS for k in ("instance_norm", "instance_norm_bwd",
                                        "block_tail", "block_tail_bwd")}
    for i, r in enumerate(ranks):
        log(f"{label} rank {i} on {devices[i]}: launches a step "
            f"{r['launches']}; seconds a step "
            f"{[round(v, 4) for v in r['seconds']]}")
        if any(l != per_step for l in r["launches"]):
            fail(f"{label} rank {i}: launches {r['launches']}, expected "
                 f"{per_step} a step")
    spread = [max(r["spread"][i] for r in ranks)
              for i in range(TRAIN_DP_STEPS)]
    log(f"{label}: max |d| between the ranks' parameters after each step "
        f"{spread}")
    if any(spread):
        fail(f"{label}: the ranks' parameters differ: {spread}")
    for i in range(TRAIN_DP_STEPS):
        got, ref = ranks[0]["metrics"][i], one["metrics"][i]
        log(f"{label} step {i + 1}: loss_G {len(devices)} ranks "
            f"{got['loss_G']:.6f}, 1 rank {ref['loss_G']:.6f}; loss_D "
            f"{got['loss_D']:.6f}, {ref['loss_D']:.6f}; largest relative "
            f"difference of a term "
            f"{max(abs(got[k] / v - 1) for k, v in ref.items()):.2e}")
        if not all(np.isfinite(v) for v in got.values()):
            fail(f"{label} step {i + 1}: non-finite losses {got}")
    got, ref = ranks[0]["metrics"][0], one["metrics"][0]
    for k, v in ref.items():
        if not abs(got[k] - v) <= DP_LOSS_RTOL * abs(v):
            fail(f"{label} step 1: {k} {got[k]} against one rank's {v} "
                 f"(rtol {DP_LOSS_RTOL})")
    grad = rel_l2(ranks[0]["grads"], one["grads"])
    delta = lambda run: {n: {k: v - init[n][k] for k, v in run[n].items()}
                         for n in run}
    update = rel_l2(delta(ranks[0]["params"]), delta(one["params"]))
    log(f"{label}: rel-L2 over the weights, {len(devices)} ranks against 1:"
        f" first step's gradient {grad:.3e} (tolerance {DP_GRAD_REL}), the "
        f"parameter update of {TRAIN_DP_STEPS} steps {update:.3e} "
        f"(tolerance {DP_UPDATE_REL})")
    if not grad <= DP_GRAD_REL or not update <= DP_UPDATE_REL:
        fail(f"{label}: gradient rel-L2 {grad}, update rel-L2 {update}")
    warm = lambda r: statistics.median(r["seconds"][1:])
    log(f"{label}: seconds a step (median of steps 2-{TRAIN_DP_STEPS}), "
        f"batch {TRAIN_N} x {SIZE}^2 bf16 SOFT_TISSUE: "
        + ", ".join(f"rank {i} {warm(r):.4f}" for i, r in enumerate(ranks))
        + f"; one rank of {TRAIN_N} {warm(one):.4f}; spawn + "
        f"{TRAIN_DP_STEPS} steps {secs:.1f} s ({backend}; {gpu_line()})")


def run_dp_serving_phase(k1, k2, devices, st, lung, ref, label: str):
    """Phase 10s (10n: across cards): the engine with one replica per
    ``devices`` entry on phase 4's patient, against the single-device
    engine (``ref``: phase 4's series)."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
    from ducosy_tpu_torch.parallel.mesh import data_mesh

    vol = chest_phantom(SLICES, SIZE, SEED)
    parts = len(devices)

    def engine(dtype, **kw):
        return DualGeneratorEngine(st, lung, img_size=SIZE,
                                   compute_dtype=dtype, forward="module",
                                   trunk="chain", **kw)

    def run(eng, chunk=N):
        t0 = time.perf_counter()
        out = eng.run_patient(vol, 1.0, -1024.0, chunk=chunk)
        for d in set(devices):
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0

    def held(what, got, want):
        share, dmax = within_one(got, want)
        log(f"{label}: {what}: |d| <= 1 on {share:.6f} of voxels, max |d| "
            f"{dmax} stored units")
        return share

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False    # as in phase 4
    try:
        eng = engine(torch.bfloat16, mesh=data_mesh(devices=devices))
        run(eng)                              # warm-up
        k1.residual_chain.launches = k2.instance_norm.launches = 0
        out, _ = run(eng)                     # the path, counted
        got = (k1.residual_chain.launches, k2.instance_norm.launches)
        n_chunks = -(-SLICES // N)
        want = (2 * 3 * n_chunks * parts,
                2 * K2_PER_GEN[None] * n_chunks * parts)
        log(f"{label}: launches K1 {got[0]} K2 {got[1]} (expected "
            f"{want[0]}, {want[1]})")
        if got != want:
            fail(f"{label}: launches {got} != {want}")
        if out.dtype != np.int16 or out.shape != vol.shape:
            fail(f"{label}: output {out.dtype} {out.shape}")
        rates = [SLICES / run(eng)[1] for _ in range(3)]
        del eng
        single = engine(torch.bfloat16, device=devices[0])
        same_calls = run(single, N // parts)[0]
        del single
        share = held(f"bf16, {parts} replicas against one device called on "
                     f"the same parts of {N // parts}", out, same_calls)
        held(f"bf16, {parts} replicas against phase 4's series (calls of "
             f"{N})", out, ref)
        held(f"bf16, one device, calls of {N // parts} against phase 4's of "
             f"{N} (another call size alone)", same_calls, ref)
        out32 = run(engine(torch.float32, mesh=data_mesh(devices=devices)))[0]
        ref32 = run(engine(torch.float32, device=devices[0]))[0]
        share32 = held(f"fp32, {parts} replicas against one device (calls of"
                       f" {N})", out32, ref32)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    if min(share, share32) < DP_SERVE_SHARE:
        fail(f"{label}: {share} (bf16), {share32} (fp32) of voxels within 1 "
             f"stored unit < {DP_SERVE_SHARE}")
    log(f"{label}: bf16 slices/s median {statistics.median(rates):.2f} "
        f"rounds {[round(v, 2) for v in rates]} ({SLICES} x {SIZE}^2, chunk "
        f"{N} in {parts} parts of {N // parts}, chain trunk; {gpu_line()})")


# Phases 10p and 10q: the (data, sp) mesh, its rows on this card listed
# more than once (10n: (1, 2) across cuda:0 and cuda:1). The JAX package
# runs no Pallas kernel under sp, so neither path may launch one: every
# launch counter reads 0 after each counted run. Set before any run:
#  - serving, fp32: the packed forward at trunk="xla" on row bands within 1
#    stored unit of the single-device packed/xla engine on >=
#    STORED_UNIT_SHARE of voxels (the same ops, each norm's and pool's sums
#    taken per band; the JAX package's own sp test holds 99.9%);
#  - serving, bf16: |dHU| against the single-device engine printed, not
#    held: cuDNN picks other algorithms at band shapes, and bf16 roundings
#    of another call size grow through the seeded generators (10s);
#  - training, fp32, remat on, one step from the same init and batch: the
#    losses within SP_LOSS_RTOL of the single-device plain step's, every
#    parameter within SP_PARAM_LR x lr of it (Adam's first step moves a
#    parameter by ~lr; a gradient at the noise floor may flip its sign);
#  - training, bf16: s/step of steps 6-7 of SP_TRAIN_STEPS (settled) and
#    peak memory, beside the single-device plain step's.
SP_LOSS_RTOL = 2e-4
SP_PARAM_LR = 4
SP_TRAIN_STEPS = 7


def all_counters(k1, k2, k4, k7) -> dict:
    """Every kernel wrapper's launch counter (K3 and K5 too)."""
    return {**packed_counters(k1, k2, k4, k7),
            "instance_norm_bwd": k2.instance_norm_bwd,
            "block_tail_bwd": k4.block_tail_bwd}


def no_launches(counters: dict, k2, label: str) -> None:
    got = read_counts(counters, k2)
    if any(got.values()):
        fail(f"{label}: the sp path launched kernels {got}")


def run_sp_serving_phase(counters, k2, meshes: dict, st, lung, records,
                         label: str):
    """Phase 10p: the engine on each (data, sp) mesh of ``meshes`` with
    phase 4's generators and patient (chunk N), against the single-device
    packed/xla engine on the mesh's first device."""
    import torch

    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine

    vol = chest_phantom(SLICES, SIZE, SEED)
    first = next(iter(meshes.values()))[0][0]
    engine = lambda dtype, **kw: DualGeneratorEngine(
        st, lung, img_size=SIZE, compute_dtype=dtype, **kw)
    one = lambda dtype, **kw: engine(dtype, device=first, **kw)

    def counted(eng, what):
        zero_counts(counters, k2)
        out, _ = serve(eng, vol)
        no_launches(counters, k2, f"{label} {what}")
        return out

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False    # as in phase 4
    try:
        ref32, _ = serve(one(torch.float32, forward="packed", trunk="xla"),
                         vol)
        for name, mesh in meshes.items():
            eng = engine(torch.float32, mesh=mesh)
            if (eng.forward_impl, eng.trunk) != ("packed", "xla"):
                fail(f"{label} {name}: auto resolved to "
                     f"{eng.forward_impl}/{eng.trunk}, not packed/xla")
            records[("sp_fp32", label, name)] = agreement(
                f"{label} {name} fp32 packed/xla vs one device",
                counted(eng, f"{name} fp32"), ref32, strict=True)
            del eng
        del ref32
        engines = {"packed xla, one device":
                   one(torch.bfloat16, forward="packed", trunk="xla")}
        ref16, _ = serve(engines["packed xla, one device"], vol)
        for name, mesh in meshes.items():
            eng = engines[f"sp {name}"] = engine(torch.bfloat16, mesh=mesh)
            records[("sp_bf16", label, name)] = agreement(
                f"{label} {name} bf16 packed/xla vs one device",
                counted(eng, f"{name} bf16"), ref16, strict=False)
        name, mesh = next(iter(meshes.items()))
        out = counted(engine(torch.bfloat16, mesh=mesh, forward="module"),
                      f"{name} module")
        agreement(f"{label} {name} bf16 module forward (plain trunk) vs "
                  "the one-device module plain trunk", out,
                  serve(one(torch.bfloat16, forward="module",
                            trunk="plain"), vol)[0],
                  strict=False)
        rates = rate_rounds(engines, vol, f"{label} bf16")
        del out
        base = rates["packed xla, one device"]
        peaks = {}
        for key, eng in engines.items():
            devs = {d for row in eng.rows for d in row}
            for d in devs:
                torch.cuda.reset_peak_memory_stats(d)
            serve(eng, vol)
            peaks[key] = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                          for d in sorted(devs, key=str)}
        for key, rate in rates.items():
            log(f"{label} bf16 {key}: {rate:.2f} slices/s ({rate / base:.4f}"
                f" of packed xla on one device); peak memory allocated "
                + ", ".join(f"{d} {v:.2f} GiB" for d, v in peaks[key].items())
                + f" ({SLICES} x {SIZE}^2, chunk {N}; {gpu_line()})")
        records[("sp_rates", label)] = dict(rates=rates, peaks=peaks)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    free_card(f"{label} done")


def run_sp_training_phase(counters, k2, row, data: Path, records,
                          label: str):
    """Phase 10q: the training step with the generators on row bands over
    ``row`` (a mesh row of (1, len(row))), against the single-device plain
    step on the same init and batch of 8 from phase 7's tree."""
    import torch

    from ducosy_tpu_torch.config import ModelConfig, SOFT_TISSUE, \
        TrainConfig, replace
    from ducosy_tpu_torch.train.loop import run_steps
    from ducosy_tpu_torch.train.state import init_state_dicts

    model = ModelConfig(num_residual_blocks=BLOCKS)
    init = init_state_dicts(SEED + 40, SOFT_TISSUE, model)
    batches = dp_batches(data)
    # the module forward on both sides, as the plain step it is held to
    cfg = replace(TrainConfig(), img_size=SIZE, batch_size=TRAIN_N,
                  compute_dtype="float32", gen_forward="module")
    row = tuple(row)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        zero_counts(counters, k2)
        sp = run_steps(row, init, batches[:1], cfg, SOFT_TISSUE, model,
                       remat=True)
        no_launches(counters, k2, f"{label} fp32 step")
        one = run_steps(row[0], init, batches[:1], cfg, SOFT_TISSUE, model,
                        trunk="plain", remat=True)
        free_card(f"{label} after the fp32 steps")
        got, ref = sp["metrics"][0], one["metrics"][0]
        rel = {k: abs(got[k] / v - 1) for k, v in ref.items()}
        dmax = max(float(np.abs(sp["params"][n][k] - v).max())
                   for n in one["params"] for k, v in one["params"][n].items())
        log(f"{label} fp32 step, remat on, batch {TRAIN_N} x {SIZE}^2, "
            f"bands on {[str(d) for d in row]}: loss_G {got['loss_G']:.6f} "
            f"against one device's {ref['loss_G']:.6f}; largest relative "
            f"difference of a term {max(rel.values()):.3e} (tolerance "
            f"{SP_LOSS_RTOL}); max |d| of a parameter {dmax:.3e} (tolerance "
            f"{SP_PARAM_LR} lr = {SP_PARAM_LR * cfg.lr:.1e}); seconds "
            f"{sp['seconds'][0]:.3f} against {one['seconds'][0]:.3f}")
        if max(rel.values()) > SP_LOSS_RTOL or not \
                dmax < SP_PARAM_LR * cfg.lr:
            fail(f"{label}: fp32 sp step against one device: relative "
                 f"{rel}, max parameter |d| {dmax}")
        del sp, one
        cfg16 = replace(cfg, compute_dtype="bfloat16")
        steps = [batches[i % len(batches)] for i in range(SP_TRAIN_STEPS)]
        out = {}
        for name, dev_arg, kw in (("sp", row, {}),
                                  ("one device", row[0],
                                   {"trunk": "plain"})):
            for d in set(row):
                torch.cuda.reset_peak_memory_stats(d)
            zero_counts(counters, k2)
            run = run_steps(dev_arg, init, steps, cfg16, SOFT_TISSUE, model,
                            remat=True, **kw)
            no_launches(counters, k2, f"{label} bf16 {name}")
            if not all(np.isfinite(v) for m in run["metrics"]
                       for v in m.values()):
                fail(f"{label} bf16 {name}: non-finite losses")
            settled = run["seconds"][5:7]
            peak = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                    for d in sorted(set(row), key=str)}
            out[name] = dict(s_per_step=statistics.mean(settled), peak=peak)
            log(f"{label} bf16 {name} (plain trunk, remat on): steps "
                f"{[round(v, 4) for v in run['seconds']]} s, settled (6-7) "
                f"{statistics.mean(settled):.4f}; peak memory "
                + ", ".join(f"{d} {v:.2f} GiB" for d, v in peak.items())
                + f" ({gpu_line()})")
            del run
            free_card(f"{label} after bf16 {name}")
        records[("sp_train", label)] = out
    finally:
        torch.backends.cudnn.benchmark = benchmark


def run_multi_card_phase(k1, k2, k4, k7, st, lung, ref, data: Path):
    """Phase 10n: 10t and 10s on cuda:0 and cuda:1 over NCCL, 10p and 10q
    on a (1, 2) mesh across them, and both CLIs with --num_devices 2.
    Needs two cards."""
    import torch

    from ducosy_tpu_torch.cli import generate, train
    from ducosy_tpu_torch.infer.engine import DualGeneratorEngine
    from ducosy_tpu_torch.parallel.mesh import data_sp_mesh

    count = torch.cuda.device_count()
    if count < 2:
        log(f"phase 10n not run: {count} card visible; the NCCL path across "
            "cards needs 2 or more (not counted as passed)")
        return
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    run_dp_training_phase(devices, "nccl", data, "10n training")
    run_dp_serving_phase(k1, k2, devices, st, lung, ref, "10n serving")
    counters = all_counters(k1, k2, k4, k7)
    run_sp_serving_phase(counters, k2, {"(1, 2)": data_sp_mesh(1, 2, devices)},
                         st, lung, {}, "10n sp serving")
    run_sp_training_phase(counters, k2, devices, data, {}, "10n sp training")
    with tempfile.TemporaryDirectory() as tmp:
        out = train.main([
            "--data_root", str(data), "--dataset_names", "Smoke",
            "--training_dir", str(Path(tmp, "run")), "--img_size", str(SIZE),
            "--batch_size", str(TRAIN_N), "--num_residual_blocks",
            str(BLOCKS), "--epochs", "1", "--max_steps_per_epoch", "2",
            "--resume", "", "--num_workers", "8", "--remat", "off",
            "--num_devices", "2"])["soft_tissue"]
        losses = {k: v for k, v in out.items() if k.startswith("loss")}
        if len(out["step_seconds"]) != 2 or not all(
                np.isfinite(v) for v in losses.values()):
            fail(f"10n training CLI: {out['step_seconds']} {losses}")
        log(f"10n training CLI --num_devices 2: steps "
            f"{[round(v, 3) for v in out['step_seconds']]} s, losses "
            f"{losses}")
        vol = chest_phantom(SLICES, SIZE, SEED + 1)
        write_series(Path(tmp, "input", "Smoke", "patient00", "POST VUE"),
                     vol, "POST VUE")
        paths = {}
        for name, sd in (("st", st), ("lung", lung)):
            paths[name] = str(Path(tmp, f"{name}.pth"))
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       paths[name])
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False    # as in phase 10s
        try:
            generate.main([
                "--input_dir_root", str(Path(tmp, "input")),
                "--output_dir_root", str(Path(tmp, "output")),
                "--dataset_names", "Smoke", "--img_size", str(SIZE),
                "--slice_batch", str(N), "--soft_tissue_model", paths["st"],
                "--lung_model", paths["lung"], "--num_devices", "2"])
            want = DualGeneratorEngine(st, lung, img_size=SIZE,
                                       device=devices[0]).run_patient(
                vol, 1.0, -1024.0, chunk=N // 2)
        finally:
            torch.backends.cudnn.benchmark = benchmark
        got = read_series(Path(tmp, "output", "Smoke", "patient00"),
                          "DuCoSyGAN sCECT v2", "10n CLI")
        share, dmax = within_one(got, want)
        log(f"10n generate CLI --num_devices 2 against one card called on "
            f"the same parts: |d| <= 1 on {share:.6f}, max |d| {dmax}")
        if share < DP_SERVE_SHARE:
            fail(f"10n generate CLI: {share} within 1 stored unit")


def kernel_records(records) -> list:
    """One record per kernel for the result line: launches on its path,
    max |d|, measured times, and the bound computed from the shapes."""
    n, hw, c = N, K1_SHAPE[1], K1_SHAPE[3]
    cf = conv_flop(n, hw, c)
    carry = n * (hw + 2) ** 2 * c * 2.0         # padded bf16 trunk tensor
    inner = n * hw * hw * c * 2.0
    wts = 9 * c * c                              # one 3x3 kernel's elements
    k2_rec = lambda name: records[("k2", name, "bfloat16")]
    k2_launches = records["launches"]["instance_norm"]
    k2p_launches = records["packed_launches"]["chain3"][
        "instance_norm (phases > 1)"]
    tn = TRAIN_N
    t_in, t_pad = tn * hw * hw * c, tn * (hw + 2) ** 2 * c
    pm, pk, pn = PROBE_SHAPE
    p3_int8, p3_bf16 = records[("p3", "int8", 9)], records[("p3", "bf16", 9)]
    train = records["train_launches"]
    quant = records[("launches", "trunk")]
    mega = records[("launches", "mega", "bf16")]
    proto = records[("proto", "launches")]
    cf8, carry8 = conv_flop(8, hw, c), 8 * (hw + 2) ** 2 * c * 2.0
    csrc = "ducosy_tpu_torch/csrc/"
    pallas = "ducosy_tpu/ops/pallas/"
    rows = [
        ("residual_chain", "residual_chain.cu", pallas + "conv_in.py:399",
         records["launches"]["residual_chain"],
         records[("k1", 3, 1, "bfloat16")],
         bound(2 * carry + 3 * 2 * wts * 2, bf16=6 * cf), None),
        ("instance_norm", "instance_norm.cu", pallas + "instance_norm.py:206",
         k2_launches, k2_rec("down2"), k2_rec("down2")["bound"], None),
        ("instance_norm_bwd", "instance_norm_bwd.cu",
         pallas + "instance_norm.py:297", train["instance_norm_bwd"],
         records[("k3", "bfloat16")], records[("k3", "bfloat16")]["bound"],
         None),
        ("block_tail", "block_tail.cu", pallas + "cbam_block.py:108",
         train["block_tail"], records[("k4", 1, "bfloat16")],
         bound((t_in + 2 * t_pad) * 2, fp32=12 * t_in + 196 * tn * hw * hw),
         None),
        ("block_tail_bwd", "block_tail_bwd.cu", pallas + "cbam_block.py:272",
         train["block_tail_bwd"], records[("k5", 1, "bfloat16")],
         bound((2 * t_in + 2 * t_pad) * 2, fp32=30 * t_in), None),
        ("residual_chain (K1q, quant=True)", "residual_chain.cu",
         pallas + "conv_in.py:399", quant["residual_chain"],
         records[("k1q", 3, 1, "bfloat16")],
         bound(2 * carry + 3 * wts * 3, bf16=3 * cf, int8=3 * cf), None),
        ("instance_norm (K2 int8 write)", "instance_norm.cu",
         pallas + "instance_norm.py:206",
         records[("launches", "tail")]["instance_norm_int8"],
         records["k2_int8"], bound(inner + carry / 2, fp32=10 * inner / 2),
         None),
        # K2p on the packed forward (phase 4k, chain3: the stem, up1 and up2
        # norms of each generator call, one count for the three shapes)
        ("instance_norm (K2 phases=4)", "instance_norm.cu",
         pallas + "instance_norm.py:206", k2p_launches,
         records[("k2p", "bfloat16")], bound(4 * inner, fp32=8 * inner),
         None),
        ("instance_norm (K2 phases=4 at the packed stem)", "instance_norm.cu",
         pallas + "instance_norm.py:206", k2p_launches,
         records[("k2p", "stem", "bfloat16")],
         records[("k2p", "stem", "bfloat16")]["bound"], None),
        ("instance_norm (K2 phases=16 at the packed up2)", "instance_norm.cu",
         pallas + "instance_norm.py:206", k2p_launches,
         records[("k2p", "up2", "bfloat16")],
         records[("k2p", "up2", "bfloat16")]["bound"], None),
        ("tap_probe (P3, int8, 9 taps)", "tap_probe.cu",
         "scripts/probe_int8_mosaic.py:38", p3_int8["launches"], p3_int8,
         bound(pm * pk + pk * pn + 4 * pm * pn, int8=2.0 * pm * pk * pn * 9),
         p3_int8["library_ms"]),
        ("tap_probe (P3, bf16, 9 taps)", "tap_probe.cu",
         "scripts/probe_int8_mosaic.py:38", p3_bf16["launches"], p3_bf16,
         bound(2 * (pm * pk + pk * pn) + 4 * pm * pn,
               bf16=2.0 * pm * pk * pn * 9),
         p3_bf16["library_ms"]),
        ("conv3x3_in (K7)", "conv_in.cu", pallas + "conv_in.py:119",
         mega["conv3x3_in"], records[("k7", "bfloat16")],
         bound(2 * carry + wts * 2, bf16=cf), None),
        ("conv_block_tail (K8)", "conv_in.cu", pallas + "conv_in.py:231",
         mega["conv_block_tail"], records[("k8", False, 1, "bfloat16")],
         bound(3 * carry + wts * 2, bf16=cf), None),
        ("proto conv3x3_in (P1, n=8)", "conv_in.cu",
         "scripts/proto_conv_in.py:55", proto["conv3x3_in"],
         records[("p1", 8, "bfloat16")],
         bound(2 * carry8 + wts * 2, bf16=cf8), None),
        ("proto conv_block_tail (P2, n=8)", "conv_in.cu",
         "scripts/proto_conv_in.py:156", proto["conv_block_tail"],
         records[("p2", 8, "bfloat16")],
         bound(3 * carry8 + wts * 2, bf16=cf8), None),
        # the same wrapper and count as "instance_norm" above (the serving
        # path calls it at each shape per generator call), at the shapes
        # that one library call computes too
        ("instance_norm (K2 at down1 and up1, pad 0)", "instance_norm.cu",
         pallas + "instance_norm.py:206", k2_launches, k2_rec("down1"),
         k2_rec("down1")["bound"], k2_rec("down1")["library_ms"]),
        ("instance_norm (K2 at the stem and up2, pad 0)", "instance_norm.cu",
         pallas + "instance_norm.py:206", k2_launches, k2_rec("stem"),
         k2_rec("stem")["bound"], k2_rec("stem")["library_ms"]),
        # each training block's first norm: the launches of phase 7's tail
        # trunk (remat off)
        ("instance_norm (K2 at the training shape, pad 1)", "instance_norm.cu",
         pallas + "instance_norm.py:206", train["instance_norm"],
         k2_rec("train"), k2_rec("train")["bound"], None),
    ]
    # K2's 3-D route: the launches of phase 13's patient (every norm of its
    # 5 forwards), at three of the segmenter's norm shapes; no TPU kernel
    rows += [(f"instance_norm3d (K2 3-D at {name})", "instance_norm.cu",
              None, records["seg_launches"], records[("k2_3d", name)],
              records[("k2_3d", name)]["bound"], None)
             for name, _ in K2_3D_CASES]
    rows.append(
        # the conv launch inside K1, K6, K7, K8, P1 and P2, alone
        ("conv3x3 (shared loop)", "conv3x3.cuh", pallas + "conv_in.py:59",
         records["launches"]["conv3x3"], records[("conv", "bf16")],
         bound(carry + wts * 2 + 2 * inner, bf16=cf),
         records[("conv", "bf16")]["library_ms"]))
    # K3 and P3 carry their original launches' time beside the kernel's;
    # P3 also its times by CUDA-graph replay (events of back-to-back calls
    # at ~20 us read the host's work a call)
    extra = ("original_ms", "graph_ms", "original_graph_ms")
    return [dict(name=name, route="cuda", source=csrc + src, replaces=rep,
                 launches=launches, **pick(rec), **bnd, library_ms=lib,
                 **{k: rec[k] for k in extra if k in rec})
            for name, src, rep, launches, rec, bnd, lib in rows]


def log_other_shapes(records) -> None:
    """Time beside bound for a call whose shape the kernels line does not
    carry: K6 (K1 at k = 1)."""
    n, hw, c = N, K1_SHAPE[1], K1_SHAPE[3]
    carry = n * (hw + 2) ** 2 * c * 2.0
    rec = records[("k1", 1, 1, "bfloat16")]
    bnd = bound(2 * carry + 2 * 9 * c * c * 2, bf16=2 * conv_flop(n, hw, c))
    log(f"K6 (K1 k=1, pad 1) bf16: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}), max|d| {rec['max_abs_err']:.3e}")


SOURCES = ("instance_norm", "residual_chain", "conv_in", "instance_norm_bwd",
           "block_tail", "block_tail_bwd", "tap_probe")


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

    from ducosy_tpu_torch.models.convert import init_generator_state_dict
    from ducosy_tpu_torch.ops.kernels import _build
    from ducosy_tpu_torch.ops.kernels import block_tail as k4
    from ducosy_tpu_torch.ops.kernels import conv_in as k7
    from ducosy_tpu_torch.ops.kernels import instance_norm as k2
    from ducosy_tpu_torch.ops.kernels import proto_conv_in as proto
    from ducosy_tpu_torch.ops.kernels import residual_chain as k1
    from ducosy_tpu_torch.ops.kernels import tap_probe
    from ducosy_tpu_torch.parallel.mesh import data_sp_mesh

    t0 = time.perf_counter()
    _build.build_all(SOURCES)          # one nvcc per source, all at once
    log(f"built {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        _build.load_library(name)
        log(f"  {name}.cu -> {_build.library_path(name).name}")
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            spills = "spill" in line and "0 bytes spill stores" not in line
            if "registers" in line or spills:
                log(f"  nvcc: {line.strip()}")
            if spills and ("conv3x3" in entry or "resident" in entry):
                fail(f"{name}.cu: the conv kernel {entry} spills registers: "
                     f"{line.strip()}")

    records: dict = {}
    st = init_generator_state_dict(SEED + 10)
    lung = init_generator_state_dict(SEED + 11)

    def phase(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
        return out

    phase("2", check_instance_norm, k2, dev, records)
    phase("2 parts", check_k2_parts, k2, dev, records)
    phase("3", check_residual_chain, k1, dev, records)
    phase("3q K1q", check_k1q, k1, dev, records)
    phase("3q K2p", check_k2p, k2, dev, records)
    phase("3q P3", check_tap_probe, tap_probe, dev, records)
    phase("3q P3 parts", check_tap_parts, tap_probe, dev, records)
    phase("3m", check_conv_in, k7, dev, records)
    for shape in RAGGED_SHAPES:
        phase(f"3r {shape}", check_conv_in, k7, dev, {}, shape=shape)
    phase("3c", check_conv_loop, k7, dev, records)
    phase("3p", run_proto_phase, proto, k7, dev, records)
    engine_out = phase("4", run_engine_phase, k1, k2, dev, st, lung, records)
    phase("4q", run_quant_engine_phase, k1, k2, k4, dev, st, lung, records)
    phase("4m", run_mega_engine_phase, k1, k2, k7, dev, st, lung, records)
    serving = packed_counters(k1, k2, k4, k7)
    fast_series = phase("5", run_cli_phase, serving, k2, st, lung)
    phase("5q", run_cli_phase, serving, k2, st, lung,
          flags=("--quant", "trunk"))
    phase("2k", check_k2p_packed, k2, dev, records)
    phase("4k", run_packed_engine_phase, k1, k2, k4, k7, dev, st, lung,
          engine_out, records)
    phase("4kq", run_packed_quant_phase, k1, k2, k4, k7, dev, st, lung,
          records)
    phase("8k", run_nocbam_serving_phase, k1, k2, k4, k7, dev, records)
    phase("6", check_training_kernels, k1, k2, k4, k7, dev, records)
    phase("6 parts", check_tail_parts, k1, k4, k7, dev, records)
    phase("6 parts K3", check_k3_parts, k2, dev, records)
    with tempfile.TemporaryDirectory() as run_dir:
        phase("7", run_training_phase, k2, k4, Path(run_dir), records)
        phase("7k", run_packed_training_phase, k2, k4, Path(run_dir),
              records)
        phase("8", run_masked_cli_phase, serving, k2, dev, Path(run_dir))
        phase("7r", run_resume_phase, k2, k4, dev, Path(run_dir), records)
        with tempfile.TemporaryDirectory() as gen_dir:
            gen = {}
            phase("9w", run_working_phase, serving, k2, st, lung,
                  Path(gen_dir), fast_series, gen)
            phase("9a", run_additive_phase, serving, k2, st, lung,
                  Path(gen_dir), gen)
            phase("9p", run_postprocess_phase, dev, gen)
            phase("9e", run_calculate_phase, dev, Path(gen_dir))
            phase("11", run_masking_phase, dev, Path(gen_dir))
            phase("12", run_nmodel_phase, dev, Path(gen_dir))
        phase("13 K2 3-D", check_instance_norm3d, k2, dev, records)
        phase("13", run_segmenter_phase, k2, dev, records)
        data = Path(run_dir, "data")
        phase("10t", run_dp_training_phase, [dev, dev], "gloo", data,
              "10t training")
        phase("10s", run_dp_serving_phase, k1, k2, [dev, dev], st, lung,
              engine_out, "10s serving")
        counters = all_counters(k1, k2, k4, k7)
        phase("10p", run_sp_serving_phase, counters, k2,
              {"(1, 2)": data_sp_mesh(1, 2, [dev] * 2),
               "(2, 2)": data_sp_mesh(2, 2, [dev] * 4)}, st, lung, records,
              "10p serving")
        phase("10q", run_sp_training_phase, counters, k2, [dev, dev], data,
              records, "10q training")
        phase("10n", run_multi_card_phase, k1, k2, k4, k7, st, lung,
              engine_out, data)
    if any(m.split(".")[0] in ("jax", "flax", "optax", "ducosy_tpu")
           for m in sys.modules):
        fail("JAX or the JAX package was imported")

    log_other_shapes(records)
    log(json.dumps({"kernels": kernel_records(records)}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
