"""program_host_ms: the mean over the window's frames (the traced
stretch left out) of FrameProgram.stats' plan_ms + bin_ms + raster_ms,
the frame program's host time a frame."""


def read(run):
    s = run.window.spans
    keys = ("plan_ms", "bin_ms", "raster_ms")
    if not all(s.get(k) for k in keys):
        return None
    return sum(sum(s[k]) for k in keys) / len(s["plan_ms"])
