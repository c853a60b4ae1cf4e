"""bin_units_ms: mean device ms a frame of binning's 'units' stage (the
active unit list: gating of clip and alpha brackets, the per-tile
compaction and the overflow counters, to binning's outputs), over the
window's untraced frames: from the port's frame record, whose marks at
the stage's ends are captured with binning's CUDA graph and read the
device's global timer (harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    return frame_record.stage_ms(run, "units")
