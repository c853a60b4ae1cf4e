"""bin_globals_ms: mean device ms a frame of binning's 'globals' stage (the
big triangles: their per-tile accept and reject matrix, bulk windings,
the per-tile global lists and counts), over the window's untraced
frames: from the port's frame record, whose marks at the stage's ends
are captured with binning's CUDA graph and read the device's global
timer (harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    return frame_record.stage_ms(run, "globals")
