"""raster_ms: device time a frame of the coverage_raster kernel, from
torch.profiler over the traced stretch."""


def read(run):
    t = run.trace
    if t is None or t.raster_launches == 0:
        return None
    return t.raster_s * 1e3 / t.frames
