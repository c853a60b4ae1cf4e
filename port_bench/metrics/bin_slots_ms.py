"""bin_slots_ms: mean device ms a frame of binning's 'slots' stage (local
slot enumeration: each small triangle's tile slots, trivial accepts, the
stable sort by (tile, command, class), the counts and the entry rows),
over the window's untraced frames: from the port's frame record, whose
marks at the stage's ends are captured with binning's CUDA graph and
read the device's global timer (harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    return frame_record.stage_ms(run, "slots")
