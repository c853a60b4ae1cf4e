"""frame_upkeep_ms: mean host ms a frame of FrameProgram's ``upkeep`` span
(the transforms' checks, the deferred overflow counters and any wait for
them, geometry edits and the blend constant), the part of the call that
program_host_ms leaves out; over the window's untraced frames, from the
port's frame record (harness/frame_record.py)."""

from port_bench.harness import frame_record


def read(run):
    rows = frame_record.frames(run)
    if rows is None:
        return None
    return frame_record.mean(r["spans_ms"].get("upkeep") for r in rows)
