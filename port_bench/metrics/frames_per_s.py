"""frames_per_s: frames completed in the window over the window's host
seconds (first frame's issue to the synchronise after the last)."""


def read(run):
    w = run.window
    return w.frames / w.seconds if w.seconds > 0 else None
