"""frame_interval_p99_ms: the 99th percentile, over all of the window's
frames, of the device-clock interval between consecutive completion
events (a stall, capture or rebuild in the window shows here)."""

from port_bench.harness.window import percentile


def read(run):
    iv = run.window.intervals_ms
    return percentile(iv, 99) if len(iv) >= 100 else None
