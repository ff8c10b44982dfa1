"""P1 and P2: the A/B prototypes of the fused conv + InstanceNorm kernels.

Counterpart of ``scripts/proto_conv_in.py``: its two Pallas kernels,
``conv3x3_in_pallas`` (:55, P1) and ``conv_block_tail_pallas`` (:156, P2),
are K7 and K8 without the int8 modes, so here they are the same two CUDA
entry points (``csrc/conv_in.cu``) at bf16 or fp32, with launch counts of
their own. ``parity`` holds them against the pair they would replace, as
the script does (:205-231); ``bench`` times them against that pair at the
trunk shape (n, 130, 130, 256) bf16 by CUDA events (:259-308). On a card:

    python -m ducosy_tpu_torch.ops.kernels.proto_conv_in

The pair they are measured against is what the port's training trunk runs:
a library conv (with bias), then K2 (IN + ReLU + pad) or K4 (the block
tail).
"""
from __future__ import annotations

import numpy as np
import torch

from ducosy_tpu_torch.models.layers import EPS_INSTANCE_NORM, conv2d
from ducosy_tpu_torch.ops.kernels import block_tail as k4
from ducosy_tpu_torch.ops.kernels import conv_in
from ducosy_tpu_torch.ops.kernels import instance_norm as k2
from ducosy_tpu_torch.ops.kernels.block_tail import hwio_to_oihw


def conv3x3_in(xp, w, *, relu: bool = True, pad: int = 1,
               eps: float = EPS_INSTANCE_NORM, scratch=None) -> torch.Tensor:
    """P1: act(IN(conv3x3_valid(xp, w))), reflect-padded by ``pad``: the K7
    kernel without its int8 modes for a CUDA tensor, the plain version for
    a CPU tensor."""
    if xp.dtype == torch.int8:
        raise TypeError("proto conv3x3_in: float32 or bfloat16 only")
    if xp.device.type == "cpu":
        return conv_in.conv3x3_in_plain(xp, w, relu=relu, pad=pad, eps=eps)
    out = conv_in.launch_conv3x3_in(xp, w, relu=relu, pad=pad,
                                    int8_scale=None, eps=eps, scratch=scratch)
    conv3x3_in.launches += 1
    return out


conv3x3_in.launches = 0


def conv_block_tail(tp, x, w, w1, w2, wsa, *, pad: int = 1, x_pad: int = 1,
                    eps: float = EPS_INSTANCE_NORM,
                    scratch=None) -> torch.Tensor:
    """P2: x(interior) + CBAM(IN(conv3x3_valid(tp, w))), reflect-padded by
    ``pad``: the K8 kernel without ``in_int8`` for a CUDA tensor, the plain
    version for a CPU tensor."""
    if tp.device.type == "cpu":
        return conv_in.conv_block_tail_plain(tp, x, w, w1, w2, wsa, pad=pad,
                                             x_pad=x_pad, eps=eps)
    out = conv_in.launch_conv_block_tail(tp, x, w, w1, w2, wsa, pad=pad,
                                         x_pad=x_pad, in_int8=False, eps=eps,
                                         scratch=scratch)
    conv_block_tail.launches += 1
    return out


conv_block_tail.launches = 0


def library_pair(xp, w, b, *, pad: int = 1) -> torch.Tensor:
    """The pair P1 would replace: library conv with bias, then K2."""
    y = conv2d(xp, hwio_to_oihw(w).to(xp.dtype), b.to(xp.dtype))
    return k2.instance_norm(y.contiguous(), relu=True, pad=pad)


def _weights(rng, c, dtype, device):
    r = max(c // 16, 1)
    mk = lambda shape, std, dt: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(device, dt)
    f32 = torch.float32
    return dict(w=mk((3, 3, c, c), 0.05, dtype), wb=mk((3, 3, c, c), 0.05,
                                                       dtype),
                b=mk((c,), 1.0, dtype), w1=mk((c, r), 0.1, f32),
                w2=mk((r, c), 0.1, f32), wsa=mk((7, 7, 2, 1), 0.1, f32))


def parity(n: int = 2, hw: int = 32, c: int = 128, device="cuda") -> dict:
    """fp32 parity on a small shape: P1 (no bias) against the library pair
    with a conv bias, which the InstanceNorm cancels; P2 against library
    conv + K4. Raises if either differs by 1e-3; returns both max |d|."""
    # fp32 means fp32 for the library conv (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.standard_normal((n, hw + 2, hw + 2, c))
                          .astype(np.float32)).to(device)
    p = _weights(rng, c, torch.float32, device)
    err = float((library_pair(xp, p["w"], p["b"])
                 - conv3x3_in(xp, p["w"])).abs().max())
    print(f"conv+IN parity n={n} hw={hw} c={c} on {xp.device}: "
          f"max|d|={err:.3e}")
    conv_out = conv2d(xp, hwio_to_oihw(p["w"])).contiguous()
    ref_t = k4.block_tail(conv_out, xp, p["w1"], p["w2"], p["wsa"], pad=1,
                          x_pad=1)
    got_t = conv_block_tail(xp, xp, p["w"], p["w1"], p["w2"], p["wsa"])
    err_t = float((ref_t - got_t).abs().max())
    print(f"conv+tail parity: max|d|={err_t:.3e}")
    if not (err < 1e-3 and err_t < 1e-3):
        raise AssertionError(f"proto parity: conv+IN {err}, conv+tail {err_t}")
    return {"conv_in": err, "conv_tail": err_t}


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
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


def bench(n: int = 8, hw: int = 128, c: int = 256, device="cuda") -> dict:
    """Time, at (n, hw+2, hw+2, c) bf16 on the card: conv + IN as P1 and as
    the library pair; the whole residual block as production (conv, K2,
    conv, K4), P1 only (P1, conv, K4) and P1 + P2. Prints times, TFLOP/s of
    the one conv (2 n hw^2 9 c^2) and the ratios; judges nothing. Returns
    the milliseconds and the block's max |d| between P1 + P2 and
    production."""
    if torch.device(device).type != "cuda":
        raise ValueError("proto bench: times are taken on a CUDA device")
    rng = np.random.default_rng(0)
    dt = torch.bfloat16
    xp = torch.from_numpy(rng.standard_normal((n, hw + 2, hw + 2, c))
                          .astype(np.float32)).to(device, dt)
    p = _weights(rng, c, dt, device)
    w, wb, b, tail = p["w"], p["wb"], p["b"], (p["w1"], p["w2"], p["wsa"])
    wo, wbo = hwio_to_oihw(w), hwio_to_oihw(wb)
    scratch = conv_in.make_scratch(n, hw, hw, c, xp.device)

    def prod_block(hp):
        t = k2.instance_norm(conv2d(hp, wo, b).contiguous(), relu=True, pad=1)
        return k4.block_tail(conv2d(t, wbo, b).contiguous(), hp, *tail, pad=1,
                             x_pad=1)

    def half_fused_block(hp):
        t = conv3x3_in(hp, w, scratch=scratch)
        return k4.block_tail(conv2d(t, wbo, b).contiguous(), hp, *tail, pad=1,
                             x_pad=1)

    def fused_block(hp):
        t = conv3x3_in(hp, w, scratch=scratch)
        return conv_block_tail(t, hp, wb, *tail, scratch=scratch)

    ms = {"conv_in": cuda_ms(lambda: conv3x3_in(xp, w, scratch=scratch)),
          "pair": cuda_ms(lambda: library_pair(xp, w, b)),
          "conv_tail": cuda_ms(lambda: conv_block_tail(xp, xp, wb, *tail,
                                                       scratch=scratch)),
          "prod": cuda_ms(lambda: prod_block(xp)),
          "half": cuda_ms(lambda: half_fused_block(xp)),
          "full": cuda_ms(lambda: fused_block(xp))}
    flop = 2 * n * hw * hw * 9 * c * c
    tf = lambda t: flop / (t * 1e-3) / 1e12
    print(f"batch {n} conv+IN : fused {ms['conv_in']:.3f} ms "
          f"({tf(ms['conv_in']):.1f} TF/s) | library conv + K2 "
          f"{ms['pair']:.3f} ms ({tf(ms['pair']):.1f} TF/s) | ratio "
          f"{ms['pair'] / ms['conv_in']:.3f}x")
    print(f"batch {n} block   : prod {ms['prod']:.3f} ms | P1 only "
          f"{ms['half']:.3f} ms ({ms['prod'] / ms['half']:.3f}x) | P1+P2 "
          f"{ms['full']:.3f} ms ({ms['prod'] / ms['full']:.3f}x)")
    err = float((fused_block(xp).float() - prod_block(xp).float()).abs().max())
    print(f"  on-device block parity max|d| = {err:.3e}")
    return {**ms, "block_max_abs_err": err, "flop": flop}


if __name__ == "__main__":
    parity()
    bench(8)
    bench(32)
