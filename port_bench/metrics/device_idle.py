"""device_idle: the share of the window, its traced stretch left out, in
which the device waited for the host's next frame, percent: over the
intervals between consecutive frames' completion events, the time from
a frame's completion to the next frame's start event (recorded before
the next frame's first operation) over the intervals' sum.  CUDA events,
so the profiler's own cost does not show in it; gaps inside a frame's
work do not count."""


def read(run):
    w = run.window
    traced = set(w.traced)
    idle = total = 0.0
    for k, (interval, gap) in enumerate(zip(w.intervals_ms, w.gaps_ms)):
        if k in traced or k + 1 in traced:
            continue
        idle += gap
        total += interval
    return 100.0 * idle / total if total > 0 else None
