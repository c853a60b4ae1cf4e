"""bin_setup_ms: mean device ms a frame of binning's 'setup' stage
(triangle setup: every stencil row transformed, flattened, clipped at
the near plane, projected and edge-set-up, with the dash modes), over
the window's untraced frames: from the port's frame record, whose marks
at the stage's ends are captured with binning's CUDA graph and read the
device's global timer (harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    return frame_record.stage_ms(run, "setup")
