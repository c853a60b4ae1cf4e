"""The measured window: a closed frame loop with a bounded number of
frames in flight, like an application behind a swap chain, and the
arithmetic of its end-to-end numbers.

Frame n is issued once frame n - ``in_flight`` has completed; each frame
records an event when it completes.  The window runs from the first
frame's issue to the synchronise after the last; the rate is the frames
completed over that host time, and the interval tail is taken over the
device-clock intervals between consecutive completion events, all of
them.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


class DeviceClock:
    """Completion marks on a device: CUDA events on the card; on the CPU
    (tests), where a frame is done when its call returns, the host
    clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    #: A frame's start mark, recorded before its first operation: on the
    #: card it completes once the frame before has completed and the host
    #: has reached it, so the interval from the frame before's completion
    #: is the time the device waited for the host.
    start = mark

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def interval_ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class Window:
    frames: int
    seconds: float
    intervals_ms: List[float]
    #: gaps_ms[k]: of intervals_ms[k] (frame k's completion to frame
    #: k + 1's), the time before frame k + 1's start mark completed.
    gaps_ms: List[float] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    captures: int = 0
    traced: List[int] = field(default_factory=list)
    trace_seconds: float = 0.0
    gc_collections: int = 0


def percentile(values, q):
    """The q-th percentile of ``values`` with linear interpolation between
    order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Tracer:
    """Profiles ``frames`` consecutive frames of the window with
    torch.profiler, from the first frame issued after ``at`` of the
    window's seconds.  The stretch starts and ends with a synchronise,
    so it holds exactly its frames' device work."""

    def __init__(self, frames, at, clock):
        self.frames, self.at, self.clock = int(frames), float(at), clock
        self.first = None
        self.prof = None
        self.span = None
        self.seconds = 0.0
        self.done = False

    def maybe_start(self, n, elapsed, seconds):
        if self.done or self.prof is not None or elapsed < self.at * seconds:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self.clock.sync()
        acts = [ProfilerActivity.CPU]
        if self.clock.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = record_function("port_bench.stretch")
        self.span.__enter__()
        self.first = n
        self._t0 = time.perf_counter()

    @property
    def active(self):
        return self.prof is not None and not self.done

    def maybe_stop(self, n):
        if not self.active or n + 1 - self.first < self.frames:
            return
        self.clock.sync()
        self.seconds = time.perf_counter() - self._t0
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True

    def traced(self):
        return list(range(self.first, self.first + self.frames)) if self.done else []


def run(issue, seconds, clock, in_flight=2, keep=None, spans=None,
        captured=None, tracer=None):
    """Issue frames ``issue(n)`` for ``seconds`` of host time (and until
    a tracer's stretch has ended); ``keep(n, frame)`` is offered every
    frame, ``spans()`` gives each frame's host spans and ``captured()``
    whether the frame captured a graph.  Returns the Window.

    A completed frame's interval is read as soon as the loop has waited
    for it, so that only the marks of frames in flight stay alive."""
    if tracer is not None:
        from torch.profiler import record_function
    marks = deque()  # (start mark, completion mark) of each frame in flight
    intervals, gaps = [], []

    def read(a, b):
        intervals.append(clock.interval_ms(a[1], b[1]))
        gaps.append(max(0.0, clock.interval_ms(a[1], b[0])))

    collected: Dict[str, List[float]] = {}
    captures = 0
    n = 0
    gc_before = sum(g["collections"] for g in gc.get_stats())
    start = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - start
        if elapsed >= seconds and (tracer is None or not tracer.active):
            break
        if tracer is not None:
            tracer.maybe_start(n, elapsed, seconds)
        traced = tracer is not None and tracer.active
        if n >= in_flight:
            # marks[0] is frame n - in_flight - 1, marks[1] frame n - in_flight.
            if traced:
                with record_function("port_bench.wait"):
                    clock.wait(marks[-in_flight][1])
            else:
                clock.wait(marks[-in_flight][1])
            if len(marks) > in_flight:
                read(marks[0], marks[1])
                marks.popleft()
        begun = clock.start()
        if traced:
            with record_function("port_bench.issue"):
                frame = issue(n)
        else:
            frame = issue(n)
        marks.append((begun, clock.mark()))
        if keep is not None:
            keep(n, frame)
        del frame
        if captured is not None and captured():
            captures += 1
        if spans is not None and not traced:
            for key, value in spans().items():
                collected.setdefault(key, []).append(value)
        if tracer is not None:
            tracer.maybe_stop(n)
        n += 1
    clock.sync()
    total = time.perf_counter() - start
    marks = list(marks)
    for a, b in zip(marks, marks[1:]):
        read(a, b)
    return Window(
        frames=n, seconds=total, intervals_ms=intervals, gaps_ms=gaps, spans=collected,
        captures=captures,
        traced=tracer.traced() if tracer is not None else [],
        trace_seconds=tracer.seconds if tracer is not None else 0.0,
        gc_collections=sum(g["collections"] for g in gc.get_stats()) - gc_before,
    )
