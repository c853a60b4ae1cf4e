"""raster_roofline: the least time an H100 could take for the raster work
of the traffic's first ``roofline_frames`` traced frames, over the
coverage_raster kernel's measured time on the same frames, in percent.

The work is counted by the reference from the frames' inputs
(``harness/roofline.py``: operations and bytes, and the card's peaks),
never from the port's binning or counters.  Nothing is returned unless
every traced frame launched the kernel once, so that the launches and
the frames pair up."""

from port_bench.harness import cell, roofline
from port_bench.reference import scene as ref


def read(run):
    t = run.trace
    if t is None or t.raster_launches != t.frames or not run.window.traced:
        return None
    c = run.cell.config
    options = c.get("configuration", {})
    samples, winding_bits = ref.frame_options(options)
    frames = run.window.traced[: int(run.cell.traffic["roofline_frames"])]
    ref_scene = cell.reference_scene(run.cell)
    least = {}
    total = 0.0
    for n in frames:
        key = (run.schedule.position(n), run.schedule.phase(n))
        if key not in least:
            ref_scene.set_phase(key[1])
            ops, nbytes = roofline.frame_work(
                cell.ref_commands(ref_scene, run.stacks[key[0]]), c["width"], c["height"],
                samples, winding_bits, options.get("blending", "back_to_front"), run.device)
            least[key] = roofline.bound_seconds(ops, nbytes)[0]
        total += least[key]
    kernel = sum(t.raster_durations_s[: len(frames)])
    return 100.0 * total / kernel if kernel > 0 else None
