"""bin_covers_ms: mean device ms a frame of binning's 'covers' stage (the
cover draws: the hull's near-plane clip, hull lines, each tile's cover
class and hull-line bitmask), over the window's untraced frames: from
the port's frame record, whose marks at the stage's ends are captured
with binning's CUDA graph and read the device's global timer
(harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    return frame_record.stage_ms(run, "covers")
