"""The chip's peaks and the operations and bytes of the work, from shapes.

Copied from the port's smoke script (``bound``, ``PEAK_OPS``, ``PEAK_BYTES``,
``conv_flop``) and kept here, where the benchmark's yardstick lives. The
peaks are NVIDIA's data sheet for one H100 SXM, dense, without sparsity.
Operations count 2 per multiply-accumulate, at the architecture's published
widths: the packed forward's extra MACs (its sub-pixel and space-to-depth
kernels hold zeros) are not work the model asks for and are not counted.
"""
from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, **ops) -> float:
    """The least seconds the chip could take: the larger of the operations
    over the peak of their type (bf16= and int8= on the tensor cores, fp32=
    on the CUDA cores) and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops = sum(v / PEAK_OPS[k] for k, v in ops.items())
    return max(t_ops, nbytes / PEAK_BYTES)


def conv_flop(n: int, hw: int, c: int) -> float:
    """Operations of one 3x3 conv on (n, hw, hw, c -> c)."""
    return 2.0 * n * hw * hw * 9 * c * c


def conv_macs(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    """Multiply-accumulates of one k x k conv a sample."""
    return float(cin) * cout * k * k * hout * wout


def generator_layers(in_ch: int, base: int, blocks: int, size: int,
                     reduction: int = 16, sa_kernel: int = 7) -> list:
    """The ResNet-9 + CBAM generator's layers (modules/model.py) at a
    size x size input: (name, MACs a sample, whether its input is the
    network input). The CBAM MLP and spatial conv are included."""
    c, s2, s4 = 4 * base, size // 2, size // 4
    layers = [("stem", conv_macs(in_ch, base, 7, size, size), True),
              ("down1", conv_macs(base, 2 * base, 3, s2, s2), False),
              ("down2", conv_macs(2 * base, c, 3, s4, s4), False)]
    for i in range(blocks):
        layers += [(f"block{i}.conv1", conv_macs(c, c, 3, s4, s4), False),
                   (f"block{i}.conv2", conv_macs(c, c, 3, s4, s4), False),
                   (f"block{i}.cbam", 2.0 * 2 * c * (c // reduction)
                    + conv_macs(2, 1, sa_kernel, s4, s4), False)]
    layers += [("up1", conv_macs(c, 2 * base, 3, s2, s2), False),
               ("up2", conv_macs(2 * base, base, 3, size, size), False),
               ("head", conv_macs(base, 1, 7, size, size), False)]
    return layers


def discriminator_layers(in_ch: int, base: int, size: int) -> list:
    """The PatchGAN's layers (modules/model.py): four 4x4 stride-2 convs
    and the 4x4 head on the (2, 1)-padded map; same tuple as above."""
    chans = (in_ch, base, 2 * base, 4 * base, 8 * base)
    layers, s = [], size
    for i in range(4):
        s //= 2
        layers.append((f"conv{i + 1}", conv_macs(chans[i], chans[i + 1], 4,
                                                 s, s), i == 0))
    layers.append(("head", conv_macs(8 * base, 1, 4, s, s), False))
    return layers


def forward_flop(layers) -> float:
    return 2.0 * sum(m for _, m, _ in layers)


def backward_flop(layers, *, wgrad: bool, input_grad: bool) -> float:
    """Operations of the backward pass: the gradient of every layer's input
    (but the network input's unless ``input_grad``) and, with ``wgrad``, of
    its weights; each as many operations as the forward."""
    ops = 0.0
    for _, macs, first in layers:
        if input_grad or not first:
            ops += 2.0 * macs
        if wgrad:
            ops += 2.0 * macs
    return ops


def cyclegan_step_flop(in_ch: int, base: int, blocks: int, disc_base: int,
                       size: int, batch: int) -> float:
    """Operations of one CycleGAN step as the architecture asks for them
    (modules/trainer.py:447-525): six generator forwards and their backward
    for the generators' weights (the four on real inputs need no gradient
    of their input, the two reconstructions do); in the generator loss the
    two discriminators forward and backward to their input only; then each
    discriminator forward on real and fake and backward for its weights."""
    g = generator_layers(in_ch, base, blocks, size)
    d = discriminator_layers(1, disc_base, size)
    gen = 6 * forward_flop(g) + 4 * backward_flop(g, wgrad=True,
                                                  input_grad=False) \
        + 2 * backward_flop(g, wgrad=True, input_grad=True)
    disc_in_g = 2 * (forward_flop(d) + backward_flop(d, wgrad=False,
                                                     input_grad=True))
    disc_step = 4 * forward_flop(d) + 4 * backward_flop(d, wgrad=True,
                                                        input_grad=False)
    return batch * (gen + disc_in_g + disc_step)


def serve_slice_flop(in_ch: int, base: int, blocks: int, size: int,
                     generators: int = 2) -> float:
    """Operations of one served slice: each generator's forward."""
    return generators * forward_flop(generator_layers(in_ch, base, blocks,
                                                      size))


def trunk_call_bound_s(n: int, hw: int, c: int, k: int) -> float:
    """The least time of one trunk call of k residual blocks on n samples
    of the (hw + 2)^2 padded bf16 carry: 2k 3x3 convs' operations against
    the carry read and written and the 2k weights read once."""
    carry = n * (hw + 2) ** 2 * c * 2.0
    weights = 2 * k * 9 * c * c * 2.0
    return bound_s(2 * carry + weights, bf16=2 * k * conv_flop(n, hw, c))


def k5_bound_s(n: int, hw: int, c: int) -> float:
    """The least time of one CBAM block-tail backward (K5) on a bf16
    (n, hw, hw, c) activation with a 1-padded carry: h and g read, dh and
    the padded dx written, and 30 fp32 operations an element (the smoke
    script's count)."""
    t_in, t_pad = n * hw * hw * c, n * (hw + 2) ** 2 * c
    return bound_s((2 * t_in + 2 * t_pad) * 2.0, fp32=30.0 * t_in)
