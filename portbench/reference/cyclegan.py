"""The CycleGAN training step in plain float32 PyTorch (qqaazz0222/
DuCoSy-GAN, modules/trainer.py:447-525, the optimizers of :360-362).

One step on a batch of NCCT (A) and CECT (B) slices with the range's mask
channels: the generators take [image | masks]; fake_B = G_A2B(A),
fake_A = G_B2A(B), id_A = G_B2A(A), id_B = G_A2B(B), rec_A =
G_B2A([fake_B | masks]), rec_B = G_A2B([fake_A | masks]); the generators'
gradient of the nine-term loss (``losses.generator_terms``); each
discriminator's gradient of its LSGAN loss on the real batch and the
detached fakes, taken before any optimizer steps (the reference steps G
first, but D's weights are not changed by it, so the result is the same);
then Adam (lr 2e-4, betas (0.5, 0.999), eps 1e-8) over both generators
jointly and one per discriminator.

Each generator forward runs under ``torch.utils.checkpoint``: only its
input is kept and the backward recomputes it, which changes no number and
lets a float32 step at batch 8 and 512^2 fit beside what the program left.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import losses
from portbench.reference.nets import discriminator, generator

NETS = ("g_a2b", "g_b2a", "d_a", "d_b")
LR, BETAS, ADAM_EPS = 2e-4, (0.5, 0.999), 1e-8


class Adam:
    """Adam without weight decay over a list of leaves."""

    def __init__(self, params, lr=LR, betas=BETAS, eps=ADAM_EPS):
        self.params, self.lr, self.betas, self.eps = list(params), lr, \
            betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


class CycleGAN:
    """The four networks' parameters (dicts in the reference layout, fp32
    leaves) and their three optimizers. ``conv`` is every network's conv
    operator: ``F.conv2d``, or a lower-precision one for the control."""

    def __init__(self, params: dict, conv=F.conv2d):
        self.p = {net: {k: v.detach().clone().float().requires_grad_(True)
                        for k, v in params[net].items()} for net in NETS}
        self.conv = conv
        leaves = lambda *nets: [v for n in nets for v in self.p[n].values()]
        self.opts = (Adam(leaves("g_a2b", "g_b2a")), Adam(leaves("d_a")),
                     Adam(leaves("d_b")))

    def leaves(self):
        """(name, leaf) of every parameter, named net/key."""
        return [(f"{n}/{k}", v) for n in NETS for k, v in self.p[n].items()]

    def _g(self, net, x):
        return checkpoint(lambda t: generator(self.p[net], t, self.conv), x,
                          use_reentrant=False)

    def _d(self, net, x):
        return discriminator(self.p[net], x, self.conv)

    def step(self, a, b, masks) -> dict:
        """One step on NCHW fp32 batches a, b (N, 1, H, W) and masks (N, M,
        H, W): updates the parameters, returns loss_G and loss_D (floats
        on the device) and this step's gradient of every leaf, by name."""
        with_m = lambda t: torch.cat([t, masks], dim=1)
        fake_b = self._g("g_a2b", with_m(a))
        fake_a = self._g("g_b2a", with_m(b))
        id_a = self._g("g_b2a", with_m(a))
        id_b = self._g("g_a2b", with_m(b))
        rec_a = self._g("g_b2a", with_m(fake_b))
        rec_b = self._g("g_a2b", with_m(fake_a))
        terms = losses.generator_terms(
            a, b, fake_a, fake_b, rec_a, rec_b, id_a, id_b,
            self._d("d_a", fake_a), self._d("d_b", fake_b))
        gen = [*self.p["g_a2b"].values(), *self.p["g_b2a"].values()]
        grads = [torch.autograd.grad(terms["total"], gen)]
        del id_a, id_b, rec_a, rec_b
        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        d_losses = []
        for net, real, fake in (("d_a", a, fake_a), ("d_b", b, fake_b)):
            loss = losses.discriminator_loss(self._d(net, real),
                                             self._d(net, fake))
            grads.append(torch.autograd.grad(loss,
                                             list(self.p[net].values())))
            d_losses.append(loss.detach())
        for opt, gs in zip(self.opts, grads):
            opt.step(gs)
        names = [n for n, _ in self.leaves()]
        flat = [g for gs in grads for g in gs]
        return {"loss_G": terms["total"].detach(),
                "loss_D": d_losses[0] + d_losses[1],
                "grads": dict(zip(names, flat))}


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to a float8 format with a per-tensor scale (its largest
    |value| to the format's largest), back in float32."""
    top = torch.finfo(dtype).max
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(torch.float32) * s


class _Fp8Conv(torch.autograd.Function):
    """A conv computed in float8 as fp8 training does it: the forward's
    operands in e4m3, the backward's incoming gradient in e5m2, every
    product accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        qx, qw = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (b is not None, stride, padding)
        return F.conv2d(qx, qw, b, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        has_b, stride, padding = ctx.conf
        qg = _fp8(g, torch.float8_e5m2)
        dx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride=stride,
                                        padding=padding)
        dw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride=stride,
                                         padding=padding)
        return dx, dw, g.sum(dim=(0, 2, 3)) if has_b else None, None, None


def fp8_conv(x, w, b=None, stride=1, padding=0):
    """The control's conv (``_Fp8Conv``): the nearest step below the bf16
    that the configuration states."""
    return _Fp8Conv.apply(x, w, b, stride, padding)
