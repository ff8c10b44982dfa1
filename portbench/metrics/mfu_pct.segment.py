"""The window's share of the card's bf16 peak: the network's architecture
operations of every patch the window ran (the program's counter
``seg.patches``, its change over the window, times one 128^3 patch's
operations at the configuration's widths) over the window's seconds. It
reads nothing where the program has no such counter."""
from portbench.roofline import PEAK_OPS
from portbench.roofline.nnunet import patch_flop


def read(reading):
    w = reading.window
    if not w.get("patches"):
        return None
    flop = patch_flop(reading.config["network"]) * w["patches"]
    return 100.0 * flop / w["seconds"] / PEAK_OPS["bf16"]
