"""bin_graph_nodes: binning's nodes in the CUDA graph that each frame
replays (make_prepare's operations, between its first and last mark of
the port's frame record; the raster kernel and the marks left out),
counted once at the graph's capture; the mean over the window's
untraced frames (harness/frame_record.py).  It repeats exactly while the
frames replay one graph; the CPU, which captures none, gives nothing to
read."""

from port_bench.harness import frame_record


def read(run):
    rows = frame_record.frames(run)
    if rows is None:
        return None
    return frame_record.mean(
        sum(r["stage_nodes"].values()) if r["stage_nodes"] else None
        for r in rows)
