"""One CycleGAN training step and the validation step
(ducosy_tpu/train/step.py), in the order of the reference hot loop
(modules/trainer.py:447-525):
  1. the six generator forwards (fakes, identities, reconstructions) from
     the current generators;
  2. the generator update from the 9-term loss (the discriminators' weights
     get no gradient);
  3. the D_A and D_B updates on the same fakes, detached.

Generators take [image | masks] (trainer.py:451-457); the identity and cycle
losses compare image channels only; discriminators see 1-channel images.
With ``remat``, each generator forward and the loss terms run under
``torch.utils.checkpoint``: only their inputs stay saved, and the backward
recomputes them (so the forward kernels launch twice per step).

``gen_forward="packed"`` runs the six generator forwards through the
space-to-depth forward (``models.fused.generator_apply_packed``, as
ducosy_tpu/train/step.py:94-104) with ``encoder_fused=False``: its "auto"
trunk, "pallas" on a card (K2/K3 and K4/K5 through their autograd
Functions) and "xla" on the CPU; a generator without CBAM runs "xla".
"auto" is resolved as the JAX loop resolves it (``resolve.training_forward``;
ducosy_tpu/train/loop.py:188-192): "packed" on a card when the image size
divides by 4, else "module", the generators themselves; a module trunk
the caller named ("tail", "plain") or ``fused_norm`` keeps "module".
Each generator's weights are laid out once a step, differentiably and in
fp32, and its three forwards share that layout, each casting it to the
compute dtype: the weight gradients sum in fp32 at the layout, and the
backward runs through the layout once (the same math as a layout a
forward). Under remat only the forwards are checkpointed, not the layout.

The step is traced (``trace.py``): the span ``step`` (request: the
process's count of steps, the counter ``step.calls``) holds, on the
packed forward, ``step.layout`` (two ``fused.pack_weights``, one a
generator), then six ``step.gen_forward``, ``step.gen_loss`` (the
discriminators' logits on the fakes and the nine-term suite),
``step.gen_backward``, two ``step.disc`` (each discriminator's loss and
gradient) and ``step.optimizer`` (the all-reduce, the gradients'
assignment and the three Adam steps). Under remat the backward runs the
forwards again, with their spans, in the autograd engine's thread on a
card.

In a process group of more than one rank (``parallel/``), each rank runs
the networks on its rows of the global batch, the generator loss and both
discriminator losses take their inputs of the whole batch
(``gather_batch``), so every rank computes the global batch's loss, and
each optimizer's gradients are all-reduced as a mean before it steps: the
step of the global batch on one card, as the JAX step under a sharded
``jit`` (tests/test_train_step.py:100-130).

With ``sp_devices`` (a rank's row of a (data, sp) mesh, its first device
the parameters'), each generator forward runs on row bands over those
devices (``models.banded.banded_apply``: the module forward, or the packed
one under ``gen_forward="packed"``, both on their plain math) and its
output is gathered onto the first device, where the discriminators and
the losses run on whole images: the same math as JAX's step on a (data,
sp) mesh (tests/test_train_step.py:264-294), which also partitions those.
A generator whose forward holds kernels (trunk "tail", ``fused_norm``)
raises, as the JAX engine refuses them under ``sp``.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ducosy_tpu_torch import trace
from ducosy_tpu_torch.config import LossConfig, TrainConfig
from ducosy_tpu_torch.losses.suite import (
    discriminator_loss,
    generator_loss,
    validation_generator_loss,
)
from ducosy_tpu_torch.models.banded import banded_apply
from ducosy_tpu_torch.models.fused import generator_apply_packed, lay_out
from ducosy_tpu_torch.parallel.mesh import all_reduce_mean, gather_batch, \
    world_size
from ducosy_tpu_torch.resolve import training_forward
from ducosy_tpu_torch.train.state import CycleGANState

Batch = Dict[str, torch.Tensor]   # "a", "b" NHW1, "masks" NHWM, "weight" (N,)


def _with_masks(img: torch.Tensor, batch: Batch) -> torch.Tensor:
    masks = batch.get("masks")
    return img if masks is None else torch.cat([img, masks], dim=-1)


def forward_all(gen_apply, g_a2b, g_b2a, batch: Batch, *,
                batched: bool = False):
    """The six generator forwards of one step (trainer.py:464-480):
    (fake_a, fake_b, id_a, id_b, rec_a, rec_b). ``batched`` folds the two
    forwards that share weights and inputs of one direction into one
    2N-batch call (exact: IN and the CBAM gates are per sample)."""
    in_a = _with_masks(batch["a"], batch)
    in_b = _with_masks(batch["b"], batch)
    if batched:
        n = in_a.shape[0]
        fake_b, id_b = gen_apply(g_a2b, torch.cat([in_a, in_b])).split(n)
        fake_a, id_a = gen_apply(g_b2a, torch.cat([in_b, in_a])).split(n)
    else:
        fake_b = gen_apply(g_a2b, in_a)
        fake_a = gen_apply(g_b2a, in_b)
        id_a = gen_apply(g_b2a, in_a)
        id_b = gen_apply(g_a2b, in_b)
    rec_a = gen_apply(g_b2a, _with_masks(fake_b, batch))
    rec_b = gen_apply(g_a2b, _with_masks(fake_a, batch))
    return fake_a, fake_b, id_a, id_b, rec_a, rec_b


def _params(opt: torch.optim.Optimizer):
    return [p for group in opt.param_groups for p in group["params"]]


def make_train_step(cfg: TrainConfig, loss_cfg: LossConfig = LossConfig(), *,
                    remat: bool = True, n_real: int | None = None,
                    batched_forwards: bool = False,
                    gen_forward: str | None = None,
                    sp_devices: Sequence | None = None):
    """Build step(state, batch) -> metrics, which updates the state's
    networks and optimizers in place and returns 0-d tensors (no sync).

    For a wrap-padded final batch (a "weight" vector in the batch) pass the
    count of real samples as ``n_real`` (of the global batch): the losses
    then reproduce the ragged batch's values and gradients exactly. Each
    parameter's gradient of this step (all-reduced) is left in its
    ``.grad``. The step is built for the process group's size at the time
    of the call.

    All three gradients are taken before any optimizer steps (the D steps
    see the pre-update D weights and the detached fakes either way, so the
    result is the reference's order). ``step.updating`` is True once the
    optimizers have started: an error raised before that left the state
    untouched. ``sp_devices``: the generators on row bands over these
    devices (see above); one device or None is the whole image.

    ``gen_forward`` None reads ``cfg.gen_forward``; "auto" is resolved at
    each call from the batch's device, ``cfg.img_size`` and the generators'
    ``fused_norm`` (the loop passes the forward it resolved from the trunk
    its caller named). The forward of the last call is
    ``step.gen_forward``."""
    world = world_size()
    gather = gather_batch if world > 1 else (lambda *xs: xs)
    gen_forward = gen_forward or cfg.gen_forward
    training_forward(gen_forward)                 # refuse a bad name now

    sp = _sp_row(sp_devices)

    def gen_apply(gen, x, forward, layouts):
        if sp:
            fwd = functools.partial(banded_apply, gen, devices=sp,
                                    forward=forward)
        elif forward == "module":
            fwd = gen
        else:
            fwd = functools.partial(generator_apply_packed, layouts[gen],
                                    dtype=gen.compute_dtype or torch.float32,
                                    encoder_fused=False)
        with trace.span("step.gen_forward"):
            if not remat:
                return fwd(x)
            # the saved input is the forward's only residual: keep it in
            # the compute dtype, which the generator casts to first anyway
            dt = gen.compute_dtype or x.dtype
            return checkpoint(fwd, x.to(dt), use_reentrant=False)

    def loss_terms(*args):
        real_a, real_b, fake_a, fake_b, rec_a, rec_b, id_a, id_b, la, lb, w \
            = args
        return generator_loss(
            real_a=real_a, real_b=real_b, fake_a=fake_a, fake_b=fake_b,
            rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
            d_a_fake_logits=la, d_b_fake_logits=lb, cfg=cfg,
            loss_cfg=loss_cfg, sample_weight=w, n_real=n_real)

    def d_loss(disc, real, fake, w):
        if batched_forwards:
            n = real.shape[0]
            logits = disc(torch.cat([real, fake]))
            return discriminator_loss(*gather(logits[:n], logits[n:], w))
        return discriminator_loss(*gather(disc(real), disc(fake), w))

    def step(state: CycleGANState, batch: Batch) -> Dict[str, torch.Tensor]:
        with trace.span("step", trace.count("step.calls")):
            return run(state, batch)

    def run(state: CycleGANState, batch: Batch) -> Dict[str, torch.Tensor]:
        step.updating = False
        step.gen_forward = forward = training_forward(
            gen_forward, fused_norm=state.g_a2b.fused_norm,
            img_size=cfg.img_size,
            on_card=batch["a"].device.type == "cuda")
        w = batch.get("weight")
        layouts = {}
        if forward == "packed" and not sp:
            with trace.span("step.layout"):
                layouts = {g: lay_out(g, dtype=torch.float32)
                           for g in (state.g_a2b, state.g_b2a)}
        fake_a, fake_b, id_a, id_b, rec_a, rec_b = forward_all(
            functools.partial(gen_apply, forward=forward, layouts=layouts),
            state.g_a2b, state.g_b2a, batch, batched=batched_forwards)
        with trace.span("step.gen_loss"):
            args = gather(batch["a"], batch["b"], fake_a, fake_b, rec_a,
                          rec_b, id_a, id_b, state.d_a(fake_a),
                          state.d_b(fake_b), w)
            terms = checkpoint(loss_terms, *args, use_reentrant=False) \
                if remat else loss_terms(*args)
        opts = (state.opt_g, state.opt_d_a, state.opt_d_b)
        with trace.span("step.gen_backward"):
            grads = [torch.autograd.grad(terms.total, _params(state.opt_g))]
        del args, id_a, id_b, rec_a, rec_b, layouts

        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        with trace.span("step.disc"):
            d_a_loss = d_loss(state.d_a, batch["a"], fake_a, w)
            grads.append(torch.autograd.grad(d_a_loss,
                                             _params(state.opt_d_a)))
        with trace.span("step.disc"):
            d_b_loss = d_loss(state.d_b, batch["b"], fake_b, w)
            grads.append(torch.autograd.grad(d_b_loss,
                                             _params(state.opt_d_b)))

        with trace.span("step.optimizer"):
            if world > 1:
                grads = [all_reduce_mean(gs) for gs in grads]
            step.updating = True
            for opt, gs in zip(opts, grads):
                for p, g in zip(_params(opt), gs):
                    p.grad = g
                opt.step()
        return {
            "loss_G": terms.total.detach(),
            "loss_D": (d_a_loss + d_b_loss).detach(),
            "loss_GAN": terms.gan.detach(),
            "loss_cycle": terms.cycle.detach(),
            "loss_id": terms.identity.detach(),
            "loss_ssim": terms.ssim.detach(),
            "contrast": (terms.contrast_attention + terms.contrast_region
                         + terms.contrast_edge).detach(),
        }

    step.updating = False
    step.gen_forward = None
    return step


def _sp_row(devices) -> tuple | None:
    """A row of two or more devices, or None (the whole image)."""
    row = tuple(torch.device(d) for d in devices or ())
    return row if len(row) > 1 else None


@torch.no_grad()
def val_step(state: CycleGANState, batch: Batch, cfg: TrainConfig, *,
             sp_devices: Sequence | None = None):
    """Validation loss, GAN + cycle + identity only (trainer.py:209-255),
    and fake_b; the module forward on row bands over ``sp_devices`` as in
    ``make_train_step``."""
    sp = _sp_row(sp_devices)
    fake_a, fake_b, id_a, id_b, rec_a, rec_b = forward_all(
        (lambda g, x: banded_apply(g, x, sp)) if sp else (lambda g, x: g(x)),
        state.g_a2b, state.g_b2a, batch)
    loss = validation_generator_loss(
        real_a=batch["a"], real_b=batch["b"], fake_a=fake_a, fake_b=fake_b,
        rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
        d_a_fake_logits=state.d_a(fake_a), d_b_fake_logits=state.d_b(fake_b),
        cfg=cfg, sample_weight=batch.get("weight"))
    return loss, fake_b
