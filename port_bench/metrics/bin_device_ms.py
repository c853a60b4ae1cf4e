"""bin_device_ms: device time a frame of every device operation other
than coverage_raster (binning, and the copies around it), from
torch.profiler over the traced stretch."""


def read(run):
    t = run.trace
    if t is None or t.other_s <= 0:
        return None
    return t.other_s * 1e3 / t.frames
