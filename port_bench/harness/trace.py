"""What a profiled stretch of the window says: the device's busy time
(the union of its operations' intervals), each kernel's time, and the
host's activity in the device's idle gaps.  A copy of the arithmetic of
the repository's ``chip_smoke.py::device_busy``, kept here so that the
benchmark's yardstick does not move with the program's tools."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

#: The raster kernel's name, as the trace shows its launches.
RASTER_KERNEL = "coverage_raster"
STRETCH = "port_bench.stretch"


@dataclass
class TraceSummary:
    frames: int
    window_s: float
    busy_s: float
    raster_s: float
    raster_launches: int
    other_s: float
    raster_durations_s: List[float] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union_seconds(spans):
    """Total length of the union of (begin, end) intervals."""
    busy, reach = 0.0, None
    for begin, end in sorted(spans):
        if reach is None or begin > reach:
            busy += end - begin
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def merged(spans):
    out = []
    for begin, end in sorted(spans):
        if out and begin <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([begin, end])
    return out


def summarize(prof, frames, window_s, top=10):
    """The TraceSummary of a torch.profiler session over ``frames``
    frames and ``window_s`` seconds of host time; None where it holds no
    device operation.  Times in the trace are in microseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    stretch = None
    for e in prof.events():
        begin, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # The harness's own ranges are mirrored on the device's
            # timeline as annotations: they are not device work.
            if not (e.name.startswith("port_bench.")
                    or getattr(e, "is_user_annotation", False)):
                device.append((begin, end, e.name))
        else:
            host.append((begin, end, e.name))
            if e.name == STRETCH:
                stretch = (begin, end)
    if not device:
        return None
    by_kernel = defaultdict(float)
    raster = other = 0.0
    launches = 0
    durations = []
    for begin, end, name in sorted(device):
        by_kernel[name] += (end - begin) * 1e-6
        if RASTER_KERNEL in name:
            raster += end - begin
            launches += 1
            durations.append((end - begin) * 1e-6)
        else:
            other += end - begin
    busy = union_seconds([(b, e) for b, e, _ in device]) * 1e-6
    gaps = []
    busy_spans = merged([(b, e) for b, e, _ in device])
    lo = stretch[0] if stretch else busy_spans[0][0]
    hi = stretch[1] if stretch else busy_spans[-1][1]
    edges = [(lo, lo)] + busy_spans + [(hi, hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = [(_host_at(host, (a + b) / 2), (b - a) * 1e-6) for a, b in gaps[:top]]
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        frames=frames, window_s=window_s, busy_s=busy,
        raster_s=raster * 1e-6, raster_launches=launches, other_s=other * 1e-6,
        raster_durations_s=durations,
        device_ops=[[n, s] for n, s in ops[:top]],
        idle_gaps=[[n, s] for n, s in gaps],
    )


def _host_at(host, t):
    """The innermost host operation running at time t (the latest begun
    of those covering it), or ``"host (no operation recorded)"``."""
    best = None
    for begin, end, name in host:
        if begin <= t <= end and name != STRETCH and (best is None or begin > best[0]):
            best = (begin, name)
    return best[1] if best else "host (no operation recorded)"
