"""Frame timing, device tracing and the port's frame record.

The port's copy of ``contrast_renderer_tpu/utils/profiling.py``.  The
reference's only performance instrumentation is a per-frame time with a
64-frame rolling average (examples/application_framework.rs:251-259);
``FrameTimer`` reproduces it on the host clock.  ``device_trace`` takes
the place of the JAX package's ``jax.profiler.trace``: a
``torch.profiler`` trace of the host and the card, written as a Chrome
trace.

``RECORD``, the frame record, is the port's own: one per process, always
on.  It keeps the last ``RECORD_FRAMES`` frames of the frame entry points
(``FrameProgram.__call__`` and ``render_sequence``, ``Renderer._prepare``),
each with its program, its host spans and the device marks of the
binnings it ran, and the process's counters of the raster kernel and of
binning's cover kernel beside them:

- host spans: a frame's spans tile its call, each boundary one read of
  ``time.perf_counter_ns``; while ``torch.profiler`` records, each span
  is also a ``record_function`` range named ``<prefix>.<span>``, so that
  the profiler's timeline holds the program's spans on the clock of the
  card's kernels (no range is entered while it is off);
- device marks: ``make_prepare`` marks the start of each of its five
  ``STAGES`` by name, and its end (``END``).  On a CUDA device a mark is
  a one-thread kernel (``csrc/frame_marks.cu``) that writes the device's
  global timer into the frame's row of a ring of ``RECORD_FRAMES`` rows
  on the device (the timestamp queries of WebGPU, the reference's
  backend); it is captured with binning's graph and costs the host
  nothing on a replay.  The ring is copied to the host only by
  ``rows``.  On the CPU, where binning runs eagerly, a mark reads the
  host clock into a ring in host memory;
- graph nodes: counted once per capture, in all and per stage, the marks
  left out.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import logging
import os
import time
from collections import Counter, deque
from types import MappingProxyType

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("contrast_renderer_tpu_torch")

ROLLING_WINDOW = 64  # frames (application_framework.rs:251)

#: The Chrome trace's file name inside ``device_trace``'s directory.
TRACE_FILE = "trace.json"

#: Frames the record keeps, and rows of each device ring.
RECORD_FRAMES = 1024

#: The record's counters of the port's kernels: each counter of launches,
#: with its counter of the launches captured into a CUDA graph, which the
#: replays of that graph add to the first.
LAUNCH_COUNTERS = {
    "raster_launches": "raster_captures",
    "cover_bin_launches": "cover_bin_captures",
}

#: make_prepare's stages, in order (ops/coverage.py): triangle setup,
#: flatten, near-plane clip, projection, edge setup and dash modes; local
#: slot enumeration, trivial accepts, the sort, counts and entry rows; the
#: big triangles' matrix; cover clip, hull lines, class and hull bitmask;
#: the unit list, gating, compaction and the overflow counters.
STAGES = ("setup", "slots", "globals", "covers", "units")
#: The mark after the last stage.
END = "end"
#: Device marks a binning writes: one at each boundary of STAGES.
MARKS = len(STAGES) + 1
#: A mark's column in its binning's row, by name.
_MARK_AT = {name: i for i, name in enumerate(STAGES + (END,))}


class FrameTimer:
    """Rolling-average frame timer.

    >>> timer = FrameTimer()
    >>> with timer.frame():
    ...     render()
    >>> timer.average_s, timer.fps
    """

    def __init__(self, window: int = ROLLING_WINDOW, log: bool = False):
        self._times = deque(maxlen=window)
        self._log = log
        self.frame_index = 0
        self.last_s = 0.0

    @contextlib.contextmanager
    def frame(self):
        start = time.perf_counter()
        yield
        self.last_s = time.perf_counter() - start
        self._times.append(self.last_s)
        if self._log:
            logger.info(
                "frame %d: %.1f µs (rolling average %.1f µs, %.1f FPS)",
                self.frame_index, self.last_s * 1e6,
                self.average_s * 1e6, self.fps,
            )
        self.frame_index += 1

    @property
    def average_s(self) -> float:
        if not self._times:
            return 0.0
        return sum(self._times) / len(self._times)

    @property
    def fps(self) -> float:
        avg = self.average_s
        return 1.0 / avg if avg > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace a block with ``torch.profiler`` (host activity, and the
    card's where this build of torch can trace one) and write it as a
    Chrome trace, ``log_dir/trace.json``.  Yields the profiler, whose
    ``key_averages()`` sum the events by name."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    wanted = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    activities = [a for a in wanted if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("wrote device trace to %s", path)


def _enter(prefix, name):
    """A ``record_function`` range named ``<prefix>.<name>``, entered,
    while the profiler records; else None."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    span = _autograd_profiler.record_function(f"{prefix}.{name}")
    span.__enter__()
    return span


@functools.lru_cache(maxsize=None)
def _marks_library():
    """The marks' library (csrc/frame_marks.cu), built on first use."""
    from .. import cuda_build

    lib = cuda_build.load_library("frame_marks", (("frame_marks.cu", ()),))
    lib.frame_mark_launch.argtypes = (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    )
    lib.frame_mark_launch.restype = ctypes.c_int
    lib.frame_mark_capture_nodes.argtypes = (ctypes.c_void_p,)
    lib.frame_mark_capture_nodes.restype = ctypes.c_longlong
    return lib


class Frame:
    """One call of a frame entry point: its program, its host spans (the
    names, and the ``perf_counter_ns`` boundaries that tile the call), the
    binnings it ran (``slots``: (ring, binning number)) and the captured
    graphs it replayed."""

    __slots__ = ("index", "program", "kind", "prefix", "names", "ns",
                 "slots", "graphs", "_range", "_outer")

    def __init__(self, index, program, kind, prefix, first, outer):
        self.index, self.program, self.kind = index, program, kind
        self.prefix = prefix
        self.names = [first]
        self.slots = []
        self.graphs = []
        self._outer = outer
        self._range = _enter(prefix, first)
        self.ns = [time.perf_counter_ns()]

    def span(self, name):
        """End the running span and start ``name``."""
        self.ns.append(time.perf_counter_ns())
        self.names.append(name)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._range = _enter(self.prefix, name)

    def end(self):
        """End the last span and keep the frame in the record."""
        self.ns.append(time.perf_counter_ns())
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        RECORD._close(self)

    def ms(self, *names) -> float:
        """Host ms of the spans named ``names``, summed (once ended)."""
        return sum(
            b - a for n, a, b in zip(self.names, self.ns, self.ns[1:])
            if n in names
        ) / 1e6


class Span:
    """A host span inside a frame's (``FrameStep.warm_up``,
    ``FrameStep.capture``): ``ms`` once it has ended."""

    __slots__ = ("prefix", "name", "ms", "_ns", "_range")

    def __init__(self, prefix, name):
        self.prefix, self.name = prefix, name
        self.ms = None

    def __enter__(self):
        self._range = _enter(self.prefix, self.name)
        self._ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter_ns() - self._ns) / 1e6
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Capture(Span):
    """The capture of a graph, as ``FrameStep.capture``: the binnings
    captured on each ring and the graph's node counts, taken at each mark
    and by ``seal`` at the capture's end.  ``nodes`` and ``stage_nodes``
    leave the marks out; they are None where the count is not known."""

    __slots__ = ("rings", "mark_nodes", "nodes", "stage_nodes")

    def __init__(self):
        super().__init__("FrameStep", "capture")
        self.rings = Counter()
        self.mark_nodes = []
        self.nodes = None
        self.stage_nodes = None

    def __enter__(self):
        RECORD._capture = self
        return super().__enter__()

    def __exit__(self, *exc):
        RECORD._capture = None
        return super().__exit__(*exc)

    def seal(self, stream):
        """Count the nodes of the graph that ``stream`` (a CUDA stream) is
        capturing into, before its capture ends."""
        total = _marks_library().frame_mark_capture_nodes(stream.cuda_stream)
        marks = self.mark_nodes
        if total < 0 or any(n < 0 for n in marks) or len(marks) % MARKS:
            return
        self.nodes = total - len(marks)
        stages = [0] * len(STAGES)
        for first in range(0, len(marks), MARKS):
            group = marks[first:first + MARKS]
            for i in range(len(STAGES)):
                # Mark i's own node is the first after its count.
                stages[i] += group[i + 1] - group[i] - 1
        self.stage_nodes = dict(zip(STAGES, stages))


class _Ring:
    """The device marks of one device: ``RECORD_FRAMES`` rows of (binning
    number, MARKS times), row ``n % RECORD_FRAMES`` for binning n.  On a
    CUDA device the rows and the binning counter live on the device and
    the marks are kernels; ``binnings`` is the host's count of binnings
    the device has begun or been given in replayed graphs.  On the CPU the
    rows are host memory and a mark reads the host clock."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.binnings = 0
        shape = (RECORD_FRAMES, 1 + MARKS)
        if self.cuda:
            self._lib = _marks_library()
            self.table = torch.full(shape, -1, dtype=torch.int64, device=device)
            self._counter = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.table = np.full(shape, -1, np.int64)

    def mark(self, name):
        """Mark the start of stage ``name`` (one of STAGES) of the current
        binning on this device, or its end (END)."""
        i = _MARK_AT[name]
        last = i == MARKS - 1
        if self.cuda:
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream().cuda_stream
                capturing = torch.cuda.is_current_stream_capturing()
                if capturing:
                    RECORD._captured(
                        self, i, self._lib.frame_mark_capture_nodes(stream))
                err = self._lib.frame_mark_launch(
                    self.table.data_ptr(), self._counter.data_ptr(), i, MARKS,
                    RECORD_FRAMES, int(last), stream,
                )
            if err != 0:
                raise RuntimeError(f"frame mark launch failed: CUDA error {err}")
            if capturing:
                return
        else:
            row = self.table[self.binnings % RECORD_FRAMES]
            if i == 0:
                row[0] = self.binnings
            row[1 + i] = time.perf_counter_ns()
        if i == 0:
            RECORD._binning(self)
        if last:
            self.binnings += 1

    def host_table(self):
        if not self.cuda:
            return self.table
        torch.cuda.synchronize(self.device)
        return self.table.cpu().numpy()


class FrameRecord:
    """The process's frame record (``RECORD``): the last ``RECORD_FRAMES``
    frames, the device rings and the counters, read-only to callers
    (``counters``, a mapping that reads 0 for a counter never counted;
    ``rows``).

    Counters: ``raster_launches``, the raster kernel's launches (a
    replay adds those its graph captured), and ``raster_captures``, its
    launches captured into a graph; ``cover_bin_launches`` and
    ``cover_bin_captures``, the same of binning's cover kernel
    (``coverage.cover_bins``).  ``LAUNCH_COUNTERS`` pairs them."""

    def __init__(self):
        self._frames = deque(maxlen=RECORD_FRAMES)
        self._counters = Counter()
        self.counters = MappingProxyType(self._counters)
        self._rings = {}
        self._open = None
        self._capture = None
        self._index = itertools.count()
        self._names = Counter()

    def name(self, kind) -> str:
        """A name of its own for a new program of ``kind``."""
        self._names[kind] += 1
        return f"{kind} {self._names[kind]}"

    def begin(self, program, kind, prefix, first) -> Frame:
        """Open a frame of ``program`` and its first span ``first``; its
        ranges are named ``<prefix>.<span>``."""
        frame = Frame(next(self._index), program, kind, prefix, first,
                      self._open)
        self._open = frame
        return frame

    def _close(self, frame):
        self._open = frame._outer
        frame._outer = None
        self._frames.append(frame)

    def count(self, name, n=1):
        """Add ``n`` to counter ``name``."""
        self._counters[name] += n

    def ring(self, device) -> _Ring:
        """The marks' ring of ``device``, made on first use (never while
        a stream captures: make_prepare asks for it with its constants)."""
        device = torch.device(device)
        ring = self._rings.get(device)
        if ring is None:
            ring = self._rings[device] = _Ring(device)
        return ring

    def _binning(self, ring):
        if self._open is not None:
            self._open.slots.append((ring, ring.binnings))

    def _captured(self, ring, i, nodes):
        capture = self._capture
        if capture is None:
            return
        if i == 0:
            capture.rings[ring] += 1
        capture.mark_nodes.append(nodes)

    def replayed(self, capture):
        """Note a replay of the graph that ``capture`` captured: its
        binnings take the next rows of their rings."""
        frame = self._open
        for ring, binnings in capture.rings.items():
            for _ in range(binnings):
                if frame is not None:
                    frame.slots.append((ring, ring.binnings))
                ring.binnings += 1
        if frame is not None:
            frame.graphs.append(capture)

    def rows(self):
        """The frames kept, oldest first, one dict each: ``frame`` (its
        number in the process), ``program``, ``kind``; ``spans_ms`` (host
        ms by span), ``span_names`` and ``span_ns`` (the boundaries);
        ``marks_ns`` (per binning, its MARKS times: device ns on a card,
        host ``perf_counter_ns`` on the CPU) and ``stages_ms`` (ms by
        stage, summed over its binnings), None where it ran none or its
        rows were overwritten; ``graph_nodes`` and ``stage_nodes`` of the
        graphs it replayed, None where it replayed none or the count is
        not known.  Copies each device ring to the host."""
        tables = {ring: ring.host_table() for ring in self._rings.values()}
        out = []
        for f in self._frames:
            spans = {}
            for name, a, b in zip(f.names, f.ns, f.ns[1:]):
                spans[name] = spans.get(name, 0.0) + (b - a) / 1e6
            marks = []
            for ring, n in f.slots:
                row = tables[ring][n % RECORD_FRAMES]
                if row[0] != n:
                    marks = None
                    break
                marks.append([int(t) for t in row[1:]])
            stages = None
            if marks:
                stages = {
                    s: sum(m[i + 1] - m[i] for m in marks) / 1e6
                    for i, s in enumerate(STAGES)
                }
            known = f.graphs and all(g.nodes is not None for g in f.graphs)
            stage_nodes = None
            if known and all(g.stage_nodes is not None for g in f.graphs):
                stage_nodes = {
                    s: sum(g.stage_nodes[s] for g in f.graphs) for s in STAGES
                }
            out.append({
                "frame": f.index,
                "program": f.program,
                "kind": f.kind,
                "spans_ms": spans,
                "span_names": list(f.names),
                "span_ns": list(f.ns),
                "marks_ns": marks or None,
                "stages_ms": stages,
                "graph_nodes": (sum(g.nodes for g in f.graphs) if known
                                else None),
                "stage_nodes": stage_nodes,
            })
        return out


#: The process's frame record.
RECORD = FrameRecord()
