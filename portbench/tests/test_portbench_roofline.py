"""Operations and bytes from shapes, held to hand counts at two shapes."""
import pytest

from portbench import roofline as rl


@pytest.mark.parametrize("in_ch,base,blocks,size", [(1, 64, 9, 512),
                                                    (3, 8, 2, 64)])
def test_generator_macs_by_hand(in_ch, base, blocks, size):
    c, s2, s4 = 4 * base, size // 2, size // 4
    hand = (in_ch * base * 49 * size * size          # stem 7x7
            + base * 2 * base * 9 * s2 * s2          # down1, stride 2
            + 2 * base * c * 9 * s4 * s4             # down2, stride 2
            + blocks * (2 * c * c * 9 * s4 * s4      # two 3x3 a block
                        + 2 * 2 * c * (c // 16)      # CBAM MLP on 2 pools
                        + 2 * 49 * s4 * s4)          # CBAM 7x7 on 2 maps
            + c * 2 * base * 9 * s2 * s2             # up1 after upsample
            + 2 * base * base * 9 * size * size      # up2 after upsample
            + base * 49 * size * size)               # head 7x7
    got = sum(m for _, m, _ in rl.generator_layers(in_ch, base, blocks,
                                                   size))
    assert got == hand
    assert rl.serve_slice_flop(in_ch, base, blocks, size) == 4.0 * hand


@pytest.mark.parametrize("n,hw,c", [(8, 128, 256), (2, 50, 64)])
def test_k5_and_trunk_bounds_by_hand(n, hw, c):
    t_in, t_pad = n * hw * hw * c, n * (hw + 2) ** 2 * c
    by_bytes = (2 * t_in + 2 * t_pad) * 2 / 3.35e12
    by_ops = 30 * t_in / 67e12
    assert rl.k5_bound_s(n, hw, c) == pytest.approx(max(by_bytes, by_ops))
    ops = 2 * 3 * 2.0 * n * hw * hw * 9 * c * c
    moved = 2 * n * (hw + 2) ** 2 * c * 2 + 2 * 3 * 9 * c * c * 2
    assert rl.trunk_call_bound_s(n, hw, c, 3) == pytest.approx(
        max(ops / 989e12, moved / 3.35e12))


def test_cyclegan_step_by_hand():
    # forward 2 m a layer; backward 2 m for its input (but the network
    # input's where that needs none) + 2 m for its weights where they train
    g = rl.generator_layers(3, 8, 1, 32)
    d = rl.discriminator_layers(1, 8, 32)
    fwd = lambda ls: 2 * sum(m for _, m, _ in ls)
    first = lambda ls: 2 * sum(m for _, m, f in ls if f)
    gen = 6 * fwd(g) + 6 * 2 * fwd(g) - 4 * first(g)
    # in the generator loss the discriminators pass the gradient to the
    # fakes (every input gradient, no weight gradient); in their own steps
    # they train on detached images
    disc = 2 * (fwd(d) + fwd(d)) + 4 * (fwd(d) + 2 * fwd(d) - first(d))
    assert rl.cyclegan_step_flop(3, 8, 1, 8, 32, 2) == pytest.approx(
        2 * (gen + disc))
    assert [m for _, m, _ in d] == [1 * 8 * 16 * 16 * 16, 8 * 16 * 16 * 8 * 8,
                                    16 * 32 * 16 * 4 * 4, 32 * 64 * 16 * 2 * 2,
                                    64 * 1 * 16 * 2 * 2]
