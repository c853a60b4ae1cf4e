"""The port's frame record (``Renderer.frame_record``), as the per-layer
metrics of binning's stages and of the frame program's upkeep read it.

The record is the process's: it outlives the program that a run deletes
before its metrics are read, and keeps the last frames of every program
the process ran.  A reader takes the rows of the window's untraced
frames (torch.profiler's cost is in none of them), all of the last
frame's program and each a ``FrameProgram`` call: the record's last row
is the window's last frame, so the row k from the end is window frame
``frames - 1 - k``, and the rows of the traced stretch and of frames
before the window are left out.  On the card the profiler takes seconds
to stop after its stretch, so a 10 s window ends soon after it and the
rows read are those before the stretch.  A port without the record (an
older checkout) gives nothing to read, and neither does a run with fewer
than ``MIN_FRAMES`` such rows.
"""

from __future__ import annotations

from . import port_lib

#: The fewest frames a reading is taken over.
MIN_FRAMES = 100


def frames(run):
    """The record's rows of the window's untraced frames, oldest first,
    or None (see the module's note)."""
    record = getattr(port_lib.renderer(run.cell.config, run.device),
                     "frame_record", None)
    if record is None:
        return None
    rows = record.rows()
    if not rows:
        return None
    w = run.window
    traced = set(w.traced)
    program = rows[-1]["program"]
    picked = []
    for back, row in enumerate(reversed(rows)):
        n = w.frames - 1 - back
        if n < 0 or row["program"] != program or row["kind"] != "FrameProgram":
            break
        if n not in traced:
            picked.append(row)
    picked.reverse()
    return picked if len(picked) >= MIN_FRAMES else None


def mean(values):
    """The mean of ``values`` (None where a frame has none), or None with
    fewer than MIN_FRAMES values."""
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if len(values) >= MIN_FRAMES else None


def stage_ms(run, stage):
    """Mean device ms a frame of binning's stage ``stage``."""
    rows = frames(run)
    if rows is None:
        return None
    return mean(r["stages_ms"][stage] if r["stages_ms"] else None for r in rows)
