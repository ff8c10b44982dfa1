"""The window's share of the card's bf16 peak: the architecture's
operations of every real (unpadded) slice served, both generators' forwards
at published widths, over the window's seconds."""
from portbench.roofline import PEAK_OPS, serve_slice_flop


def read(reading):
    gen, w = reading.config["generator"], reading.window
    flop = serve_slice_flop(gen["input_channels"], gen["base_channels"],
                            gen["num_residual_blocks"],
                            reading.config["img_size"])
    return 100.0 * flop * w["slices"] / w["seconds"] / PEAK_OPS["bf16"]
