"""The window's share of the card's bf16 peak: the architecture's
operations of a CycleGAN step (six generator forwards and their backward,
the discriminators' passes) times the steps, over the window's seconds."""
from portbench.roofline import PEAK_OPS, cyclegan_step_flop


def read(reading):
    gen, cfg = reading.config["generator"], reading.config
    flop = cyclegan_step_flop(gen["input_channels"], gen["base_channels"],
                              gen["num_residual_blocks"],
                              cfg["discriminator"]["base_channels"],
                              cfg["img_size"], reading.traffic["batch"])
    w = reading.window
    return 100.0 * flop * w["steps"] / w["seconds"] / PEAK_OPS["bf16"]
