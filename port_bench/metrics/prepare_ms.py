"""prepare_ms: the mean over the window's frames (the traced stretch left
out) of Renderer.timing["prepare_ms"], host packing and binning's
copies in and replay a frame."""


def read(run):
    v = run.window.spans.get("prepare_ms")
    return sum(v) / len(v) if v else None
