"""Frame timing and device tracing.

The port's copy of ``contrast_renderer_tpu/utils/profiling.py``.  The
reference's only performance instrumentation is a per-frame time with a
64-frame rolling average (examples/application_framework.rs:251-259);
``FrameTimer`` reproduces it on the host clock.  ``device_trace`` takes
the place of the JAX package's ``jax.profiler.trace``: a
``torch.profiler`` trace of the host and the card, written as a Chrome
trace."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque

logger = logging.getLogger("contrast_renderer_tpu_torch")

ROLLING_WINDOW = 64  # frames (application_framework.rs:251)

#: The Chrome trace's file name inside ``device_trace``'s directory.
TRACE_FILE = "trace.json"


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
