"""The sliding window's redundant work: voxels run through the network
(the program's counter ``seg.patch_voxels``, patches x 128^3) over the
voxels of the resampled volumes (``seg.volume_voxels``), less 1, in %, over
every patient of the run: warm-up, window and traced segment. It reads
nothing where the program has no such counters."""
from portbench.program import counters


def read(reading):
    c = counters()
    if not c or not c.get("seg.volume_voxels"):
        return None
    return 100.0 * (c["seg.patch_voxels"] / c["seg.volume_voxels"] - 1.0)
