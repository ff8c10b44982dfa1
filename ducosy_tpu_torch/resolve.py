"""What "auto" names: the generator forward (and the packed trunk) of the
serving engine and of the training step, resolved as the JAX package
resolves them (ducosy_tpu/infer/engine.py:56-93 and 150-222,
ducosy_tpu/train/loop.py:188-192).

Plain functions of the settings and of ``on_card``, whether the device is
a CUDA device: that is where the JAX package asks ``pallas_available()``,
whether its kernels run. The engine and the training step call them with
``device.type == "cuda"``; tests call them without a card. They decide
from the device alone, never from whether a kernel built.

Serving on one device a mesh row (``serving_forward``):
  - forward "auto" is "packed" on a card when img_size % 4 == 0, else
    "module";
  - under "packed", trunk "auto" is "chain3" on a card ("mono" below 3
    blocks) and stays "auto" on the CPU, which the packed forward runs on
    its XLA trunk. A checkpoint without CBAM keeps the nominal trunk and
    runs the XLA trunk (models/fused.py); a kernel trunk named for it
    raises;
  - ``fused_norm`` changes nothing here: the module forward alone reads it.
Serving under an sp axis: "auto" is the packed forward at trunk "xla" when
img_size % 4 == 0, else the module forward; the kernels and the quantized
modes raise, as do bands that do not divide img_size.

Training (``training_forward``): "auto" is "packed" on a card when
img_size % 4 == 0, else "module"; the packed step keeps the packed
forward's own trunk "auto" ("pallas" on a card) and ``encoder_fused=False``.

The port's deliberate differences (ROADMAP.md):
  - its own trunk names, "tail" and "plain", keep the module forward under
    "auto", and so does a training run with ``fused_norm``;
  - the module forward, named or resolved on the CPU, serves the port's
    module trunks "chain" and "mega" and, for CBAM checkpoints, the quant
    modes, which the JAX engine refuses; on a card under "auto", "chain"
    and "mega" are the JAX names (packed chain1, packed mega);
  - forward "packed" named with img_size % 4 != 0 raises, where the JAX
    engine builds and its packed forward returns the wrong size (68^2 for
    a 66^2 input).
"""
from __future__ import annotations

from ducosy_tpu_torch.models.generator import TRUNKS
from ducosy_tpu_torch.ops.quant import check_quant
from ducosy_tpu_torch.parallel.spatial import GROUP

FORWARDS = ("auto", "module", "packed")
# trunk names the JAX package does not have: they name the module forward
PORT_TRUNKS = ("tail", "plain")


def _check_forward(name: str, forward: str) -> None:
    if forward not in FORWARDS:
        raise ValueError(f"{name} must be 'auto', 'module' or 'packed': "
                         f"{forward!r}")


def serving_forward(forward: str = "auto", trunk: str = "auto", *,
                    quant: str | None = None, trunk_int8: bool = False,
                    fused_norm: bool = False, cbam: bool = True,
                    blocks: int = 9, img_size: int = 512, sp: int = 1,
                    on_card: bool = True) -> tuple[str, str, str | None]:
    """(forward, trunk, quant) the serving engine runs. ``cbam``: every
    checkpoint has CBAM blocks; ``blocks``: the smallest checkpoint's
    residual blocks; ``sp``: devices a mesh row. Raises ValueError where
    the JAX engine refuses, apart from the differences above."""
    _check_forward("forward", forward)
    if quant is None and trunk_int8:
        quant = "trunk"
    quant = check_quant(quant)
    if sp > 1:
        if quant or fused_norm:
            raise ValueError(
                "spatial ('sp') sharding partitions the H axis, which the "
                "kernels and the quantized modes don't support: serve those "
                "on one device or over a pure 'data' mesh")
        if trunk not in ("auto", "xla"):
            raise ValueError(
                f"trunk={trunk!r} is a kernel path; under sp sharding only "
                "trunk='xla' partitions")
        if forward == "auto":
            forward = "packed" if img_size % 4 == 0 else "module"
        if forward == "packed":
            trunk = "xla"
        if img_size % GROUP or img_size // GROUP < sp:
            raise ValueError(
                f"img_size {img_size} under sp = {sp}: the row bands need "
                f"img_size divisible by {GROUP} and at least {GROUP} rows a "
                "band")
    elif forward == "auto":
        if trunk in PORT_TRUNKS or not on_card:
            forward = "module"
        elif img_size % 4 == 0:
            forward = "packed"
        else:
            # the JAX engine's module forward on its accelerator: it takes
            # neither a trunk name nor a quantized mode
            if trunk != "auto":
                raise ValueError(f"trunk={trunk!r} requires the packed "
                                 f"forward, which needs img_size divisible "
                                 f"by 4 (got {img_size})")
            if quant:
                raise ValueError(f"quant={quant!r} requires the packed "
                                 f"forward, which needs img_size divisible "
                                 f"by 4 (got {img_size})")
            forward = "module"
    if forward == "module":
        if trunk != "auto" and trunk not in TRUNKS:
            raise ValueError(f"trunk={trunk!r} requires the packed forward "
                             f"(got forward='module', whose trunks are "
                             f"{TRUNKS})")
        if trunk not in ("auto", "plain") and not cbam:
            raise ValueError(f"trunk={trunk!r} needs CBAM checkpoints (its "
                             "kernels include the CBAM gates); a generator "
                             "without CBAM runs trunk='plain'")
        if quant and not cbam:
            raise ValueError("quant on a generator without CBAM runs on the "
                             "packed forward's XLA trunk (forward='packed')")
        return forward, trunk, quant
    if img_size % 4:
        raise ValueError(f"forward='packed' needs img_size divisible by 4, "
                         f"got {img_size}")
    if trunk in PORT_TRUNKS:
        raise ValueError(f"trunk must be auto/xla/pallas/mega/mono/chain{{k}}"
                         f" under forward='packed': {trunk!r} is a module "
                         "trunk")
    if trunk == "auto":
        if on_card:
            trunk = "chain3" if blocks >= 3 else "mono"
    elif trunk != "xla" and not cbam:
        raise ValueError(f"trunk={trunk!r} needs CBAM checkpoints (the fused "
                         "trunk kernels include the CBAM gates)")
    return forward, trunk, quant


def training_forward(gen_forward: str = "auto", trunk: str = "auto", *,
                     fused_norm: bool = False, img_size: int = 512,
                     on_card: bool = True) -> str:
    """The train step's generator forward, "module" or "packed". ``trunk``
    is the module trunk the caller named (before "auto" becomes "tail" or
    "plain"); under an sp axis the same rule holds, and the banded packed
    forward runs its plain math."""
    _check_forward("gen_forward", gen_forward)
    if gen_forward != "auto":
        return gen_forward
    if trunk != "auto" or fused_norm or not on_card or img_size % 4:
        return "module"
    return "packed"
