#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py [--ptxas-report] [--breakdown]

Phases, each of which ends the run with a non-zero exit when it fails:

1. a CUDA device is visible; print its name and power limit
   (nvidia-smi);
2. build the coverage raster kernel (csrc/coverage_raster.cu) with nvcc,
   one library per feature set the frames below need (4× MSAA: the base
   build, depth, gradients, gradients and the checker user paint; 16×
   MSAA: the base build; phase 25's profiling builds of the four 4×
   MSAA feature sets and its subtractive build), all at once; with
   ``--ptxas-report`` also the base, depth and gradient builds
   at 1, 2, 8 and 16 samples, which no frame uses; print each library's
   build seconds and ptxas' registers and spills per instantiation;
3. on the BASELINE config-2 frame (1,000 integral quadratic and cubic
   Bézier fills, 1920×1080, 4× MSAA), binned by the port on the card,
   hold the kernel against its plain torch version on the same tensors,
   float and packed-RGBA8 output (the kernel's (H, W) frame against the
   plain version's tiles de-tiled by ``coverage.detile``);
4. render that frame through ``Renderer.render`` on the card, and check
   that it went through the kernel, has the right shape, finite values,
   alpha in [0, 1] and covered pixels;
5. render the README circle at 256² and hold its coverage against the
   scalar oracle (mean error ≤ 1e-3);
6. time the kernel, its plain version and the frame with CUDA events
   after warm-up;
7. the BASELINE config-3 frame (60 dashed polylines, three joins, a
   two-interval dash, 1920×1080, 4× MSAA): kernel against plain on the
   card as in phase 3, then ``Renderer.render`` at two dash phases: one
   binning, two different images;
8. the showcase (``models.showcase``, with text) at 3840×2160, 4× MSAA,
   both variants: the 46-instance frame, and the frame inside two nested
   clips and a transparency group (``alpha_layer_count=1``,
   front-to-back; and the same commands with ``alpha_layer_count=2``,
   whose layers the kernel keeps in shared memory); for each, kernel
   against plain on the prepared frame, then ``Renderer.render``; for
   the clip/alpha variant, nothing outside the outer clip, the tiles
   that the bracket gating emptied, and its image equal to the image
   rendered without gate spans; then the clip/alpha variant at 16×
   MSAA with 16 alpha layers, whose layers go to the global scratch of
   resident blocks: its peak device memory over a render (binning
   cached) must stay under 1 GiB, and its image must equal the same
   frame's with one layer held in registers;
9. the cap sheet through ``Renderer.render`` against the reference's
   golden (tests/golden/cap_styles_96x72.npy), bit for bit;
10. time the kernel, its plain version, the cached-binning frame (CUDA
   events, and the host clock around the call with no synchronise) and
   the binning of each frame of phases 7-8; then one cached showcase
   frame at 3840×2160, float output, under torch.profiler: its device
   operations in order, which must be the coverage kernel with nothing
   after it (the kernel writes the frame's own (H, W, 4) layout; no
   de-tiling copy follows), and the frame's time;
11. the showcase with text at 3840×2160 under the reference showcase's
   own depth state (LessEqual, depth write): kernel against plain, then
   ``Renderer.render``; the pixels that differ from the frame without
   depth (phase 8) show the depth body fired;
12. the gradient card (``scenes.gradient_card``, the frame of
   examples/gradients.py) at 3840×2160: kernel against plain, then
   ``Renderer.render``; the card's colour near its two ends against its
   first and last stop;
13. the mixed-paints frame (``scenes.mixed_paints``: a gradient, an
   instanced solid pair, the checker ``UserPaint`` compiled into the
   kernel) at 1920×1080 under LessEqual with depth write: kernel against
   plain, then ``Renderer.render``; both checker colours show;
14. time phases 11-13's frames as in phase 10;
15. BASELINE config 4 (10,080 TrueType glyphs, 1920×1080, 4× MSAA) in
   its three forms (``scenes.config4_text``): the monolith (one shape of
   296k triangles), the fused form (one multi-shape stencil over every
   glyph instance and one cover) and the per-glyph form (one instanced
   pair per unique glyph): for each, its scene build seconds, commands,
   units and triangles, its render through ``Renderer.render`` with the
   peak device memory, its kernel against its plain version to the bit,
   and its times and bound as in phase 10; the fused and per-glyph
   forms' images against the monolith's: equal, or at most 0.1% of
   pixels off, each in at most two of its four samples
   (``compare_with_monolith``), beside the monolith against itself with
   its transform's scales one float32 step larger;
16. the showcase frames of phase 8 went through the default path, which
   auto-instances them: their fused command counts, and their packed
   RGBA8 images against the same commands walked in sequence
   (``auto_instance=False``), with both walks' kernel times;
17. ``render(carry=...)``: ten chained config-2 frames from a 0-d tensor
   on the card: the carry equals ten times the image's alpha sum (rtol
   1e-5), and the image equals a render without carry;
18. ``strict_capacity=False``: tests/test_coverage_exec.py's 20 nested
   circles at 256² with ``tile_capacity=8``: the capacity grows within
   two frames, and the image then equals a strict render's;
19. the moving camera: the showcase with text under the orbit of
   benchmarks/run_configs.py::config5_orbit (0.05 rad a frame about the y
   axis, the dash phase 0.032 a frame), at 3840×2160 and at 1920×1080,
   through ``Renderer.compile_frame(uint8_output=True)``: the settled
   capacities, ``plan_for_motion`` over the 99 frames timed (the fused
   plan, its commands, the scouted capacities), with its scout through
   a binning graph and, on a second program, with the eager scout (same
   plan and capacities), the time to build one variant, each variant's
   capture (the fused plan's by ``plan_for_motion``, the sequential
   walk's forced) with its host ms,
   launches and the graph pool's memory, each frame's near-plane
   crossings (from the sequential walk's binning); one window of the 99
   frames on the eager path (the variant's prepare and rasterize outside
   its graph), kept; three windows of 99 frames replaying the graphs,
   chained through ``carry`` with one fetch each: frames/s next to the
   eager window's, the coverage kernel launched once a frame, no frame
   captured, the host time a frame for planning, copies in and replay,
   copy out and carry, every frame equal to the eager frame to the bit;
   the peak device memory of graph and eager frames and rebuilds; the
   frame record (``frame_record_check``) of the last window, each frame
   one binning with six rising device marks, binning's stages in ms a
   frame, and an eager binning of two frames whose stages sum to within
   5% of CUDA events around it; the calls of one frame that wait for the device; under torch.profiler, the device's
   busy share, the kernel's and binning's device time and the device
   operations a frame; the frame with the most
   crossings, a fused frame and a frame that fell back (where one does)
   against ``Renderer(auto_instance=False).render``, packed RGBA8, to
   the bit; the kernel against plain on the crossing frame, its times and
   bound; ``render_sequence`` over 16 frames against the per-frame
   calls, to the bit, with its frames/s; and the 99 frames through a
   program that never planned (``unplanned_orbit_run``: the hysteresis
   at work; frames/s, frames fused, groupings built, the frames that
   captured a graph with their host ms, each frame's host ms and the
   longest, every frame equal to the eager sequential walk's to the
   bit);
19b. moved frames through ``Renderer.render``, each a miss of its
   binning cache, replayed from the binning step's CUDA graph: the
   showcase orbit (with text, the dash phase moving) at 3840×2160 and
   1920×1080, config 2 and config 3 at 1920×1080 under a drifting
   camera (``camera_drift``), 99 frames each, packed RGBA8, at
   ``strict_capacity`` True and False (``moved_render_phase``): frames/s
   over three windows against the eager binning, the host split a
   frame, the captures, the graph pool, every frame equal to the eager
   frame to the bit, the synchronising calls of a replayed miss (none
   without strict_capacity, the one overflow read with it), the device's
   busy share, frames 0, 30 and 98 against the same renderer with its
   steps cleared, and at 4K the copy that keeps a cached binning out of
   the graph's buffers against a frame's copy;
19c. triangles clipped at the near plane (``near_plane_phase``): the
   repro of tests/test_torch_near_plane.py (the showcase with text at
   64² under orbit frame 31: pair 18's stencil, then pair 15's stencil
   and cover, ``auto_instance=False``): the crossings binned, the kernel
   against plain, and the frame against pair 15 alone and against the
   frame binned in float64 (``coverage.prepare_in_float64``), packed
   RGBA8, each to the bit, the differing pixels counted; then the 99
   orbit frames at 256² through a program that never planned
   (``unplanned_orbit_run``), whose fused groupings reorder stencils and
   covers: every frame against the eager sequential walk, to the bit;
   and orbit frames 30 and 98 at 3840×2160 through ``Renderer.render``
   against their float64 binning: the pixels that differ counted, at
   most 0.1% of them;
19d. binning's cover kernel (csrc/cover_bins.cu, ``cover_bins_phase``)
   at the drift cells' shapes (config 3 and config 2 at 1920x1080), the
   4K orbit's frame 30 and config 4 per glyph at 1920x1080: its outputs
   against its plain version's on the card to the bit, its time beside
   its bound, the plain version's time eager and replayed from a CUDA
   graph, its registers and the launches counted; it fails where the
   kernel is slower than its plain version;
20. the orbit example's app (``examples.orbit_camera``) through
   ``FrameLoop`` at 3840×2160 for 24 frames: a scripted drag and a wheel
   event, 1920×1080 asked for after frame 12, a ``PngSink`` every 8
   frames; the last frame at each size against the app's
   ``compile_frame`` program called outside the loop, RGBA8, to the bit;
   each PNG read back against the frame presented; ``FrameTimer``'s fps
   and average at each size; each of the drag's 10 frames' host ms and
   the longest, each against the eager sequential walk's frame, RGBA8,
   to the bit; the frames that captured a variant's graph, with their
   host ms, and the other frames' median; one more frame under
   ``utils.profiling.device_trace``, whose trace must hold the kernel;
21. the standalone fill rasterizer (``ops.raster.make_fill_rasterizer``,
   plain torch on the card): BASELINE config 1 (the circle at 256²)
   against the port's oracle, error 0.0; config 2's fill table at
   1920×1080: its time, ``max_count``, tile chunk and peak memory, the
   overflow reported below ``max_count``, and the winding on the card
   against the CPU's to the bit;
22. the showcase with text at 3840×2160 over a ``parallel.Mesh`` of 4
   row bands (``cuda:{i % n}``): ``render_sharded`` of the showcase and
   of its clip/alpha variant, and ``render_sharded_2d`` on 2×2, against
   the single-device render (mean |Δ| < 1e-4); ``ShardedFrameProgram``
   on 8 orbit frames against ``render_sharded`` (atol 1e-6) and its
   packed-RGBA8 twin; the time a frame; that program and a
   ``ShardedFrameProgram2D`` on 2×2 through their per-rect CUDA graphs
   (``sharded_graph_run``: host and synchronised ms a frame, each
   rect's replay, the captures per rect, the graph pools, every frame
   equal to the eager sharded frame to the bit); each band's kernel
   time, and the slowest band's kernel against plain with its bound;
23. the viewer example at 1920×1080 served on 127.0.0.1: the page and 3
   frames over HTTP;
24. the examples ``render_showcase`` (4 frames at 1920×1080) and
   ``gradients`` (3840×2160), their PNGs read back; the gradient card's
   PNG against phase 12's image over white;
25. the kernel body by body on config 2, config 3, the showcase, the
   showcase + depth, the gradient card, the mixed-paints frame and orbit
   frame 30 at 3840x2160 as the planned program bins it: the profiling
   build's warp-cycles per body (``coverage.PROFILE_BODIES``) and each
   body's share, the kernel's time in the build that renders and in the
   profiling build, the subtractive builds of ``BREAKDOWN_OMIT``, and
   the stencil walk's counts (``walk_counts``).

Phase 25 bins its frames itself (``breakdown_frames``) and holds each
against its plain version before it times it.  With ``--breakdown`` the
run stops after phase 2 (without the 16× MSAA build), runs phase 25
alone, and ends with ``{"breakdown_only": true, "device": ...}`` in
place of the full run's last line.

Kernel times are the median of 5 batches of launches, printed with the
batches' least and greatest.  Beside each frame's bound it prints what
the kernel's stencil walk skipped on that frame (``rasterize_plain``'s
``work``): the (block, entry) rows staged, the (warp, entry) pairs
walked, culled by the box test and dropped by the edge reject, the
stroke pairs with an inside sample, the predicate lanes used, the
curve pairs with no sample inside, and the stroke sample evaluations
that the warp vote skipped.

Kernel against plain is equality to the bit, float and packed RGBA8,
frame against de-tiled tiles.  The line before the two JSON lines gives
the run's seconds.
The line before the last is ``{"kernels": [...]}``, one entry per ported
body of the kernel with the frame that exercised it, its launches on the
main path, its time, its plain version's, and its bound: the least time
the card could take for the work this frame's data needs
(``kernel_bound``: each entry over the samples in its bounding box, each
cover body over the samples its mask passed); no single PyTorch call
computes this function, so ``library_ms`` is null.  The last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

WIDTH, HEIGHT = 1920, 1080
SHOWCASE_W, SHOWCASE_H = 3840, 2160
CIRCLE_SIZE = 256
KERNEL_SOURCE = "contrast_renderer_tpu_torch/csrc/coverage_raster.cu"
TPU_KERNEL = "contrast_renderer_tpu/ops/coverage.py"
CAP_GOLDEN = "tests/golden/cap_styles_96x72.npy"
#: The most device memory a 4K render with 16 alpha layers at 16× MSAA
#: may take (binning cached): a layer scratch sized by the frame would
#: take 8.5 GB, one sized by the card's resident blocks tens of MB.
LAYER_MEMORY_LIMIT = 1 << 30
#: The share of pixels in which config 4's fused and per-glyph images may
#: differ from its monolith's, and the samples of one pixel that may
#: differ (see compare_with_monolith).
TEXT_MISMATCH_LIMIT = 1e-3
TEXT_MISMATCH_SAMPLES = 2
#: Frames of the orbit timed (the reference's 99-frame animation), and of
#: the render_sequence segment held to per-frame calls.
ORBIT_FRAMES = 99
ORBIT_SEQUENCE = 16
#: Timed windows of the orbit's frames per resolution.
ORBIT_WINDOWS = 3
#: Frames of the orbit example through FrameLoop, the frame after which
#: it asks for 1920x1080, and the PngSink's stride.
LOOP_FRAMES, LOOP_RESIZE_AFTER, LOOP_PNG_EVERY = 24, 12, 8
#: Frames of each moved run through Renderer.render (phase 19b), its
#: timed windows, its frames under torch.profiler, and the frames held
#: against the same renderer with its binning steps cleared.
MOVED_FRAMES, MOVED_WINDOWS, MOVED_PROFILED = 99, 3, 33
MOVED_CHECKED = (0, 30, 98)
#: The near-plane repro of phase 19c: its size and orbit frame, the
#: showcase commands drawn (pair 18's stencil, then pair 15's stencil and
#: cover) and pair 15 alone; the size of its unplanned orbit.
NEAR_SIZE, NEAR_FRAME = 64, 31
NEAR_REPRO, NEAR_ALONE = (36, 30, 31), (30, 31)
NEAR_ORBIT_SIZE = 256
#: Orbit frames of phase 19c held at 3840x2160 against their float64
#: binning (181 and 7 near-plane crossings), and the share of pixels they
#: may differ in (float32 rounding at samples on an edge).
NEAR_4K_FRAMES, NEAR_4K_LIMIT = (30, 98), 1e-3
#: Row bands of the sharded phase, and ShardedFrameProgram's orbit frames.
SHARD_BANDS, SHARD_FRAMES = 4, 8
#: Sharded against single-device frames: mean |Δ| over the float image
#: (tests/test_showcase.py's bar for the JAX package); a sharded
#: program's frame against render_sharded (tests/test_showcase.py).
SHARD_MEAN_ABS, SHARD_PROGRAM_ATOL = 1e-4, 1e-6
#: Viewer frames fetched over HTTP at 1920x1080.
VIEWER_FRAMES = 3
#: The subtractive build of the breakdown phase: {frame: bodies} of
#: coverage.PROFILE_BODIES skipped, timing only; frames of the base
#: build (KernelFeatures(4)).
BREAKDOWN_OMIT = {"showcase": ("fill",), "config 3": ("stroke",)}
#: The orbit frame of the breakdown phase (181 near-plane crossings at
#: 3840x2160, as the planned program bins it).
ORBIT_BREAKDOWN_FRAME = 30
#: H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, and
#: float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# Float operations (a multiply, add, compare, divide, square root, min,
# max or floor is one) that the kernel's arithmetic in
# csrc/coverage_raster.cu needs, per pixel or per sample.  Terms that
# depend on the entry or draw alone (edge gradients, a sample's offset
# along an edge, 1 - alpha of a solid colour), integer and boolean logic,
# and the sample positions bx + sample_x are not counted.
#
# Per pixel of a binned entry, in coverage.CLS_* order (stroke_cover,
# fill_entry): the three edge functions a*px + b*py + c (12); with
# interpolated channels, the barycentrics e*inv_area (3) and each
# channel's l0*w0 + l1*w1 + l2*w2 (5); strokes also 1/w at the centre (5).
ENTRY_PIXEL_OPS = (
    30, 30, 30,   # line: 12 + 3 + 2 texcoords * 5 + 5
    35, 35, 35,   # joint: 12 + 3 + 3 texcoords * 5 + 5
    12, 30, 35,   # fill: solid 12; quadratic 12 + 3 + 3 * 5; cubic + 4 * 5
)
# Per sample of a binned entry: the edge tests, e > nt and e == nt for
# three edges (6).  Strokes: 1/w at the sample (an add), its zero guard
# and the divide (3), each texcoord's add and multiply by 1/w (2 each);
# joints add the radius (2 multiplies, an add, a square root) and the
# join compare (5), and with a dash the atan2 polynomial (30: two fabs,
# max, min, the floored max, a divide, a square, the polynomial's 17
# multiplies and adds, three octant compares and their three
# subtractions or negations)
# scaled by 1/tau and added to the texcoord (2).  The dash remainder
# (a subtract, fmodf, two sign compares and the fix-up add: 5) and
# past, past <= 0 and the distance to the interval's end (3); the
# general dash also searches its four intervals (a subtract and a
# compare each: 8) and takes one cap predicate per side (at least 1
# each, as the cap varies by sample).  Quadratic fills: three channel
# adds, x*x - y*z and its test (7); cubic: four adds, x*x*x - y*z*w and
# its test (10).  Cap predicates are added per entry below.
ENTRY_SAMPLE_OPS = (
    6 + 3 + 4,                  # line, solid (+ the one cap its flag picks)
    6 + 3 + 4 + 5 + 3,          # line, single dash (+ two caps)
    6 + 3 + 4 + 5 + 3 + 8 + 2,  # line, general dash
    6 + 3 + 6 + 5,              # joint, solid
    6 + 3 + 6 + 5 + 32 + 5 + 3,  # joint, single dash (+ two caps)
    6 + 3 + 6 + 5 + 32 + 5 + 3 + 8 + 2,  # joint, general dash
    6, 6 + 7, 6 + 10,           # fill: solid, quadratic, cubic
)
#: cap_mask per cap code (square, round, out, in, right, left, butt):
#: y <= .5; x*x + y*y < .25; .5 - y > |x|; y < |x|; .5 - y > x;
#: y - .5 < x; y < 0.
CAP_OPS = (1, 4, 3, 2, 2, 2, 1)
#: A solid line's end cap (tex.y - end_y and its predicate) or start cap
#: (-tex.y, its predicate and tex.y >= 0), by the entry's end-cap flag.
END_CAP_OPS, START_CAP_OPS = 1, 2
#: One hull-line test at a sample: h0*x + h1*y + h2 >= 0.
HULL_LINE_OPS = 5
#: The depth plane at a sample, (a*x + b*y) + c, and its compare.
DEPTH_PLANE_OPS, DEPTH_COMPARE_OPS = 4, 1
#: gradient_paint per sample: rel_x, rel_y (2); linear t, a dot product
#: and a divide (4), or radial t, a squared length, a divide and a
#: square root (5); clip to [0, 1] (2); and the premultiply (3).  Per
#: ramp segment whose two stops differ: t minus its offset, the divide,
#: the clip (4) and four channels' multiply-add (8).
GRADIENT_OPS = {1: 2 + 4 + 2 + 3, 2: 2 + 5 + 2 + 3}
GRADIENT_SEGMENT_OPS = 12
#: scenes.CHECKER_CUDA per sample: two divides by 4, two floors, the
#: float conversion and 1 - v (6); then the premultiply (3).
CHECKER_OPS = 6 + 3
#: Alpha ops per updated sample: scale (1 - g) + g*a (2), restore
#: a - (1 - saved)*(1 - g) (3), save+scale as scale; save copies.
ALPHA_OP_OPS = {4: 0, 5: 2, 6: 3, 7: 2}


def fail(message):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def raster_launches():
    """The raster kernel's launches in this process, from the port's
    frame record (a replayed graph adds the launches it captured)."""
    from contrast_renderer_tpu_torch.utils.profiling import RECORD

    return RECORD.counters["raster_launches"]


def cover_bin_launches():
    """Binning's cover kernel's launches in this process, from the port's
    frame record, counted as ``raster_launches`` are."""
    from contrast_renderer_tpu_torch.utils.profiling import RECORD

    return RECORD.counters["cover_bin_launches"]


def frame_record_check(program, n, stacks, label):
    """The port's frame record of ``program``'s last ``n`` frames: fails
    unless each holds one binning with its six device marks rising, and
    unless an eager binning of each of ``stacks`` has its five stages sum
    to within 5% of CUDA events around it.  Returns the mean ms a frame
    of each stage over the ``n`` frames."""
    import torch
    from contrast_renderer_tpu_torch.utils.profiling import MARKS, RECORD, STAGES

    rows = [r for r in RECORD.rows() if r["program"] == program._name][-n:]
    bad = [
        i for i, r in enumerate(rows)
        if not r["marks_ns"] or len(r["marks_ns"]) != 1
        or len(r["marks_ns"][0]) != MARKS
        or any(a >= b for a, b in zip(r["marks_ns"][0], r["marks_ns"][0][1:]))
    ]
    if len(rows) != n or bad:
        fail(f"{label}: the frame record holds {len(rows)} of {n} frames; "
             f"frames {bad[:8]} lack six rising device marks")
    dev = program._renderer.device
    for t in stacks:
        variant, transforms = program._choose(program._opt_rows(t),
                                              derive=False)
        d = {k: torch.as_tensor(a, device=dev)
             for k, a in program._descriptors().items()}
        args = (*program._scene.arrays, torch.as_tensor(transforms, device=dev),
                d["static"], variant.paints)
        variant.prepare(*args)
        torch.cuda.synchronize()
        frame = RECORD.begin("chip_smoke eager binning", "check", "check", "bin")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        variant.prepare(*args)
        end.record()
        frame.end()
        torch.cuda.synchronize()
        row = [r for r in RECORD.rows() if r["frame"] == frame.index][0]
        stages, events = sum(row["stages_ms"].values()), start.elapsed_time(end)
        if abs(stages - events) > 0.05 * events:
            fail(f"{label}: an eager binning's stages sum to {stages:.4f} ms "
                 f"against {events:.4f} ms of CUDA events")
    return {s: sum(r["stages_ms"][s] for r in rows) / n for s in STAGES}


def cuda_ms(fn, reps, iters, warmup):
    """(median, least, greatest) over ``reps`` batches of the device time
    per call of ``fn``, each batch ``iters`` calls between two CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times), max(times)


def host_ms(fn, reps, warmup):
    """Median host time per call of ``fn`` with no synchronise: the
    host's work for a call, which overlaps the device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def raster_args(coverage, spec, runtime):
    """coverage_raster's arguments for a prepared frame: (spec, prepared,
    cmd_i, cmd_f, unit_cmd, unit_draw, desc_f, desc_i)."""
    import torch

    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    draws = coverage.draw_tables(spec)
    device = prepared.tri_f.device
    units = (
        torch.as_tensor(draws.unit_cmd, device=device),
        torch.as_tensor(draws.unit_draw, device=device),
    )
    return (spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i)


def kernel_vs_plain(coverage, spec, runtime, label):
    """Hold the kernel's frame against rasterize_plain's tiles de-tiled
    (``coverage.detile``) on the same tensors, float and packed RGBA8:
    equal to the bit.  Returns the float max abs error (0.0)."""
    from dataclasses import replace

    import torch

    max_abs_err = None
    args = raster_args(coverage, spec, runtime)
    for u8 in (False, True):
        mode = (replace(spec, out_uint8=u8),) + args[1:]
        got = coverage.coverage_raster(*mode)
        want = coverage.detile(mode[0], coverage.rasterize_plain(*mode))
        torch.cuda.synchronize()
        if u8:
            gb = got.view(torch.uint8).reshape(-1, 4).int()
            wb = want.view(torch.uint8).reshape(-1, 4).int()
            px = (gb != wb).any(-1)
            worst = int((gb - wb).abs().max())
            n_px = int(px.sum())
            print(f"{label}: kernel vs plain, packed RGBA8: {n_px} of "
                  f"{px.numel()} pixels differ, max {worst} LSB", flush=True)
            if n_px:
                fail(f"{label}: packed RGBA8 output disagrees with the plain version")
        else:
            max_abs_err = float((got - want).abs().max())
            print(f"{label}: kernel vs plain, float: max abs err "
                  f"{max_abs_err:.3g}, bit-identical "
                  f"{bool(torch.equal(got, want))}", flush=True)
            if not torch.equal(got, want):
                fail(f"{label}: float output off by {max_abs_err}")
            if not bool((want[..., 3] > 0).any()):
                fail(f"{label}: the plain version covered nothing")
    return max_abs_err


def breakdown_phase(coverage, frames, card, omit):
    """The kernel body by body on each frame of ``frames`` ({label:
    (spec, runtime)}), each first held against its plain version
    (kernel_vs_plain): the profiling build's warp-cycles per body
    (``coverage.PROFILE_BODIES``) of one launch and each body's share of
    their sum; the kernel's time in the build that renders and in the
    profiling build; and, for each body of ``omit``, the time of the
    subtractive build that skips it (timing only, the image not kept).
    Returns {label: {"shares": {...}, "cycles": {...}, "ms": ...,
    "profile_ms": ..., "omit_ms": {...}}}.  ``omit``: {label: bodies}."""
    import torch

    bodies = coverage.PROFILE_BODIES
    out = {}
    for label, (spec, runtime) in frames.items():
        kernel_vs_plain(coverage, spec, runtime, f"breakdown {label}")
    for label, (spec, runtime) in frames.items():
        args = raster_args(coverage, spec, runtime)
        prof = torch.zeros(len(bodies), dtype=torch.int64, device="cuda")
        coverage.coverage_raster(*args, profile=prof)
        cycles = dict(zip(bodies, prof.tolist()))
        total = sum(cycles.values())
        if total <= 0:
            fail(f"breakdown {label}: the profiling build counted no cycles")
        shares = {b: c / total for b, c in cycles.items()}
        ms = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        profile_ms = cuda_ms(
            lambda: coverage.coverage_raster(*args, profile=prof), 5, 10, 3
        )
        omit_ms = {
            body: cuda_ms(lambda: coverage.coverage_raster(*args, omit=body), 5, 10, 3)
            for body in omit.get(label, ())
        }
        work = {}
        coverage.rasterize_plain(*args, work=work)
        out[label] = {"shares": shares, "cycles": cycles, "ms": ms,
                      "profile_ms": profile_ms, "omit_ms": omit_ms, "work": work}
        split = ", ".join(f"{b} {shares[b]:.3f}" for b in bodies)
        omitted = "; ".join(
            f"without {b} {v[0]:.3f} ms [{v[1]:.3f}, {v[2]:.3f}]"
            for b, v in omit_ms.items()
        )
        print(f"breakdown {label} ({card}): warp-cycle shares {split} "
              f"({total:.4g} warp-cycles); kernel {ms[0]:.3f} ms "
              f"[{ms[1]:.3f}, {ms[2]:.3f}], profiling build {profile_ms[0]:.3f} ms"
              f"{'; ' + omitted if omitted else ''}", flush=True)
        print(f"breakdown {label}: {walk_counts(work)}", flush=True)
    return out


def orbit_frame(coverage, showcase, Configuration, Renderer, index,
                width=SHOWCASE_W, height=SHOWCASE_H):
    """Orbit frame ``index`` (the showcase with text, its dash phase) as
    a program planned over the orbit's frames bins it: (spec, runtime)
    of the variant that frame takes."""
    shape = showcase.build_shape(with_text=True)
    stacks = [showcase.orbit_transforms(i, width, height)
              for i in range(ORBIT_FRAMES)]
    renderer = Renderer(Configuration(), width, height, strict_capacity=False,
                        device="cuda")
    program = renderer.compile_frame(
        showcase.showcase_commands(shape, width, height), uint8_output=True)
    program.plan_for_motion(stacks)
    shape.set_dynamic_stroke_options(
        0, showcase.dashed_options(index * showcase.ORBIT_DASH_STEP))
    variant, runtime = program._bin(program._opt_rows(stacks[index]))
    return variant.spec, runtime


def breakdown_frames(coverage, scenes, showcase, api):
    """Phase 25's frames, binned on the card: {label: (spec, runtime)}."""
    import torch

    cfg, op, Shape = api.Configuration, api.RenderOperation, api.Shape
    depth = cfg(depth_compare="less_equal", depth_write_enabled=True)
    t = scenes.ortho(WIDTH, HEIGHT)

    def pair(shape, color):
        return [api.DrawCommand(op.STENCIL, shape, t),
                api.DrawCommand(op.COLOR, shape, t, color=color)]

    show = showcase.showcase_commands(
        showcase.build_shape(with_text=True), SHOWCASE_W, SHOWCASE_H)
    frames = {
        "config 2": (cfg(), WIDTH, HEIGHT, pair(
            Shape(scenes.bezier_fill_paths(1000, WIDTH, HEIGHT, seed=0)),
            (0.9, 0.4, 0.1, 1.0))),
        "config 3": (cfg(), WIDTH, HEIGHT, pair(
            Shape(*scenes.dashed_strokes(WIDTH, HEIGHT, seed=1)), (1, 1, 1, 1))),
        "showcase": (cfg(), SHOWCASE_W, SHOWCASE_H, show),
        "showcase + depth": (depth, SHOWCASE_W, SHOWCASE_H, show),
        "gradient card": (cfg(), SHOWCASE_W, SHOWCASE_H,
                          scenes.gradient_card(SHOWCASE_W, SHOWCASE_H)[0]),
        "mixed paints": (depth, WIDTH, HEIGHT, scenes.mixed_paints(WIDTH, HEIGHT)),
    }
    yardsticks = {}
    for label, (config, width, height, commands) in frames.items():
        spec, _, runtime = api.Renderer(config, width, height,
                                        device="cuda")._prepare(commands)
        yardsticks[label] = (spec, runtime)
    yardsticks[f"orbit 4K frame {ORBIT_BREAKDOWN_FRAME}"] = orbit_frame(
        coverage, showcase, api.Configuration, api.Renderer, ORBIT_BREAKDOWN_FRAME)
    torch.cuda.synchronize()
    return yardsticks


def blend_ops(coverage, blending):
    """Float operations of one blended sample (blend_channel over four
    channels): a multiply per factor other than zero and one, the add or
    subtract of two nonzero terms, one op for min and max, the saturated
    factor's min, and 1 - dst alpha once where a factor uses it."""
    color, alpha = coverage._canonical_blend(blending)
    ops, one_minus_da = 0, False
    for chan in range(4):
        src, op, dst = alpha if chan == 3 else color
        if op in ("min", "max"):
            ops += 1
            continue
        terms = 0
        for f in (src, dst):
            if f == "zero":
                continue
            terms += 1
            if f == "one" or (f == "src_alpha_saturated" and chan == 3):
                continue
            ops += 2 if f == "src_alpha_saturated" else 1
            one_minus_da |= f in ("one_minus_dst_alpha", "src_alpha_saturated")
        ops += terms == 2
    return ops + one_minus_da


def entry_ops(coverage, spec, prepared, desc_i):
    """Float operations of the frame's binned entries: each entry's
    ENTRY_PIXEL_OPS over the pixels, and its ENTRY_SAMPLE_OPS and cap
    predicates over the samples, that lie in its bounding box (RF_AABB)
    clipped to its tile."""
    import torch

    dev = prepared.tri_f.device
    S, lw, lh = spec.samples, spec.screen_tile_w, spec.screen_tile_h
    offsets = coverage.SAMPLE_PATTERNS[S]
    t = torch.arange(spec.n_tiles, device=dev)
    x0 = ((t % spec.ntx) * lw).double()[:, None]
    y0 = ((t // spec.ntx) * lh).double()[:, None]
    pixel_ops = torch.tensor(ENTRY_PIXEL_OPS, device=dev, dtype=torch.float64)
    sample_ops = torch.tensor(ENTRY_SAMPLE_OPS, device=dev, dtype=torch.float64)
    cap_ops = torch.tensor(CAP_OPS + (0,), device=dev, dtype=torch.float64)
    desc_i = desc_i.long()

    def span(lo, hi, origin, size, o_lo, o_hi):
        """Pixels p of [origin, origin + size) with lo <= p + o <= hi for
        some offset o in [o_lo, o_hi]."""
        first = torch.maximum(torch.ceil(lo - o_hi), origin)
        last = torch.minimum(torch.floor(hi - o_lo), origin + size - 1)
        return torch.clamp(last - first + 1, min=0)

    def cap(code):
        return cap_ops[torch.clamp(code, 0, len(CAP_OPS))]

    total = 0.0
    for rows_f, rows_i, off in (
        (prepared.tri_f, prepared.tri_i, prepared.off),
        (prepared.g_tri_f, prepared.g_tri_i, prepared.g_off),
    ):
        n_rows = off[:, 0, -1].long()
        live = torch.arange(rows_f.shape[1], device=dev)[None, :] < n_rows[:, None]
        box = rows_f[..., coverage.RF_AABB:coverage.RF_AABB + 4].double()
        xs = [o[0] for o in offsets]
        ys = [o[1] for o in offsets]
        pixels = (span(box[..., 0], box[..., 2], x0, lw, min(xs), max(xs))
                  * span(box[..., 1], box[..., 3], y0, lh, min(ys), max(ys)))
        samples = sum(
            span(box[..., 0], box[..., 2], x0, lw, ox, ox)
            * span(box[..., 1], box[..., 3], y0, lh, oy, oy)
            for ox, oy in offsets
        )
        cls = rows_i[..., coverage.RI_CLASS].long().clamp(0, coverage.N_CLASSES - 1)
        group = rows_i[..., coverage.RI_GROUP].long().clamp(0, desc_i.shape[0] - 1)
        di = desc_i[group]                                  # (T, K, 16)
        end_flag = (rows_i[..., coverage.RI_FLAGS] & coverage.FLAG_END_CAP) != 0
        per_sample = sample_ops[cls] + torch.where(
            cls == coverage.CLS_LINE_SOLID,
            torch.where(end_flag, END_CAP_OPS + cap(di[..., 12]),
                        START_CAP_OPS + cap(di[..., 11])),
            0.0,
        ) + torch.where(
            (cls == coverage.CLS_LINE_SOLID + 1) | (cls == coverage.CLS_JOINT_SOLID + 1),
            cap(di[..., 0]) + cap(di[..., 4]),
            0.0,
        )
        ops = pixels * pixel_ops[cls] + samples * per_sample
        total += float(torch.where(live, ops, 0.0).sum())
    return total


def cover_ops(coverage, spec, runtime, draws, work):
    """Float operations of the cover bodies and the resolve, from the
    samples the plain version's masks passed (rasterize_plain's
    ``work``)."""
    prepared, cmd_i, cmd_f, _, _ = runtime
    ops = work.get("hull", 0) * HULL_LINE_OPS
    compare = spec.depth_compare not in ("always", "never")
    ops += work.get("depth", 0) * (DEPTH_PLANE_OPS + DEPTH_COMPARE_OPS * compare)
    ops += work.get("blend", 0) * blend_ops(coverage, spec.blending)
    for d, n in work.get("paint", {}).items():
        code = int(cmd_i[int(draws.c_cmd[d]), 3])
        if code >= 3:
            ops += n * CHECKER_OPS
            continue
        stops = cmd_f[d, :16].reshape(4, 4)
        segments = int((stops[1:] != stops[:-1]).any(-1).sum())
        ops += n * (GRADIENT_OPS[code] + segments * GRADIENT_SEGMENT_OPS)
    for op, n in work.get("alpha", {}).items():
        ops += n * ALPHA_OP_OPS[op]
    # Resolve: per pixel of an active tile and channel, S adds and a
    # multiply; packed RGBA8 adds the clamp, scale, round and floor (5).
    active = int((prepared.acount > 0).sum())
    per_channel = spec.samples + 1 + (5 if spec.out_uint8 else 0)
    ops += active * spec.tile_h * spec.tile_w * 4 * per_channel
    return ops


def kernel_bound(coverage, spec, runtime, work=None):
    """The least time the card could take for coverage_raster's work on
    this prepared frame: the larger of the bytes it must move (every
    entry row in the tiles' ranges, the active tiles' range and class
    tables, the per-draw tables, each read once, and the output written
    once) over PEAK_BYTES_S, and the float operations this frame's data
    needs (entry_ops over each entry's own samples, cover_ops over the
    samples the plain version's masks passed) over PEAK_F32_OPS_S.
    Returns (bound_ms, "bytes" or "operations", bytes, operations); the
    plain version's ``work`` counts go into ``work`` where given."""
    work = {} if work is None else work
    coverage.rasterize_plain(*raster_args(coverage, spec, runtime), work=work)
    return bound_from_work(coverage, spec, runtime, work)


def bound_from_work(coverage, spec, runtime, work):
    """kernel_bound from the ``work`` counts of a plain run already made
    on this prepared frame."""
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    draws = coverage.draw_tables(spec)
    ops = entry_ops(coverage, spec, prepared, desc_i)
    ops += cover_ops(coverage, spec, runtime, draws, work)
    C = spec.n_commands
    active = int((prepared.acount > 0).sum())
    rows = int(prepared.off[:, 0, -1].long().sum() + prepared.g_off[:, 0, -1].long().sum())
    tables = sum(int(t.numel()) * t.element_size() for t in (
        prepared.hull_lines, prepared.paint_xy, prepared.zplane, cmd_i,
        cmd_f, desc_f, desc_i,
    ))
    nbytes = (
        rows * 4 * (coverage.D_F + coverage.D_I)
        + active * 4 * (2 * (coverage.N_CLASSES * C + 1) + C
                        + 2 * len(draws.c_cmd) + len(draws.unit_cmd) + 1)
        + tables
        + spec.width * spec.height * (4 if spec.out_uint8 else 16)
    )
    byte_s, op_s = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(byte_s, op_s) * 1e3, ("bytes" if byte_s >= op_s else "operations"), nbytes, ops


def walk_counts(work):
    """The stencil walk's counts of a plain run (rasterize_plain's
    ``work``), as printed beside each frame: what a block stages, what
    its warps walk, and how full the stroke predicates' lanes are."""
    def share(key, of):
        n, d = work.get(key, 0), work.get(of, 0)
        return f"{n} of {d}" + (f" ({n / d:.3f})" if d else "")

    return (
        f"staged {share('staged_rows', 'entry_blocks')} (block, entry) rows; "
        f"walked {share('walked', 'entry_warps')} (warp, entry) pairs, box "
        f"test culled {work.get('culled', 0)}, edge reject dropped "
        f"{work.get('edge_rejected', 0)}; stroke pairs with an inside sample "
        f"{share('inside_pairs', 'stroke_pairs')}; predicate lanes used "
        f"{share('keep_lanes', 'keep_slots_sample')}; curve pairs with no sample "
        f"inside {share('fill_pairs_outside', 'fill_pairs')}"
    )


def check_frame(image, height, width, label):
    """Shape, device, finite values, alpha in [0, 1]; returns the covered
    share of pixels, which must be positive."""
    import torch

    if tuple(image.shape) != (height, width, 4) or image.device.type != "cuda":
        fail(f"{label}: frame shape {tuple(image.shape)} on {image.device}")
    if not bool(torch.isfinite(image).all()):
        fail(f"{label}: non-finite values in the frame")
    alpha = image[..., 3]
    if float(alpha.min()) < 0.0 or float(alpha.max()) > 1.0:
        fail(f"{label}: alpha outside [0, 1]")
    covered = float((alpha > 0).float().mean())
    if covered <= 0.0:
        fail(f"{label}: no pixel covered")
    return covered


def render_main_path(coverage, renderer, commands, label, height, width):
    """One frame through Renderer.render, the launch count read just
    before and just after; fails unless the kernel launched."""
    import torch

    since = raster_launches()
    image = renderer.render(commands, to_host=False)
    torch.cuda.synchronize()
    launches = raster_launches() - since
    if launches < 1:
        fail(f"{label}: Renderer.render did not launch coverage_raster")
    covered = check_frame(image, height, width, label)
    print(f"{label}: render: {launches} coverage_raster launch(es), "
          f"{covered:.3f} of pixels covered", flush=True)
    return image, launches


def binning_ms(renderer, commands, reps):
    """Median host time of _prepare with the binning cache cleared, to
    the end of its device work."""
    import torch

    times = []
    for _ in range(reps):
        renderer._prepared_cache.clear()
        start = time.perf_counter()
        renderer._prepare(commands)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def main():
    run_start = time.perf_counter()
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    try:
        from contrast_renderer_tpu_torch import cuda_build, scenes
        from contrast_renderer_tpu_torch import renderer as renderer_module
        from contrast_renderer_tpu_torch.models import showcase
        from contrast_renderer_tpu_torch.ops import coverage
        from contrast_renderer_tpu_torch.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer, Shape,
        )
    except ImportError as exc:
        fail(f"the port does not import from beside this script: {exc}")

    # ---- 2. build -------------------------------------------------------
    KF = coverage.KernelFeatures
    only_breakdown = "--breakdown" in sys.argv[1:]
    features = [
        KF(4),                                   # phases 3-10
        KF(4, depth=True),                       # showcase + depth
        KF(4, paint_mode=1),                     # gradient card
        KF(4, True, 2, (scenes.CHECKER_CUDA,)),  # mixed paints
    ]
    if not only_breakdown:
        features.append(KF(16))                  # 16 alpha layers, 16x MSAA
    # Phase 25's profiling builds, and its subtractive build.
    features += [f._replace(variant="profile") for f in features[:4]]
    features += [KF(4, variant=f"omit_{body}")
                 for bodies in BREAKDOWN_OMIT.values() for body in bodies]
    if "--ptxas-report" in sys.argv[1:]:
        # For ptxas' report only: the depth and gradient builds at the
        # other sample counts, where their registers and spills differ.
        features += [KF(s) for s in (1, 2, 8, 16) if KF(s) not in features]
        features += [KF(s, depth=True) for s in (1, 2, 8, 16)]
        features += [KF(s, paint_mode=1) for s in (1, 2, 8, 16)]
    start = time.perf_counter()
    coverage.build_kernels(features)
    build_s = time.perf_counter() - start
    print(f"build: {len(features)} coverage_raster libraries "
          f"loaded in {build_s:.1f} s", flush=True)
    for name, (seconds, log) in cuda_build.build_logs.items():
        print(f"  {name}: built in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    if only_breakdown:
        breakdown_phase(coverage,
                        breakdown_frames(coverage, scenes, showcase, renderer_module),
                        card, BREAKDOWN_OMIT)
        # Not the full run's last line: only phases 1, 2 and 25 ran.
        print(json.dumps({"breakdown_only": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return

    # ---- 3. kernel vs plain on the config-2 frame -------------------------
    start = time.perf_counter()
    shape = Shape(scenes.bezier_fill_paths(1000, WIDTH, HEIGHT, seed=0))
    t = scenes.ortho(WIDTH, HEIGHT)
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(0.9, 0.4, 0.1, 1.0)),
    ]
    print(f"scene: {len(shape.triangles)} triangles, built in "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    renderer = Renderer(Configuration(), WIDTH, HEIGHT, device="cuda")
    start = time.perf_counter()
    spec, _, runtime = renderer._prepare(commands)
    torch.cuda.synchronize()
    print(f"binning: first frame prepared in "
          f"{time.perf_counter() - start:.2f} s; spec tile "
          f"{spec.tile_h}x{spec.tile_w} strips {spec.tile_strips}, "
          f"{spec.n_tiles} tiles; stats {renderer.stats}", flush=True)
    max_abs_err = kernel_vs_plain(coverage, spec, runtime, "config 2")

    # ---- 4. the fill path end to end --------------------------------------
    _, launches = render_main_path(
        coverage, renderer, commands, "config 2", HEIGHT, WIDTH
    )

    # ---- 5. the README circle against the oracle -------------------------
    size = CIRCLE_SIZE
    circle = Shape([scenes.Path.from_circle((128, 128), 100)])
    t_circle = scenes.ortho(size, size)
    circle_image = Renderer(Configuration(), size, size, device="cuda").render([
        DrawCommand(RenderOperation.STENCIL, circle, t_circle),
        DrawCommand(RenderOperation.COLOR, circle, t_circle, color=(1, 0, 0, 1)),
    ])
    expected = scenes.oracle_coverage(circle.triangles, size, size)
    circle_err = float(np.mean(np.abs(circle_image[..., 3] - expected)))
    print(f"circle {size}²: mean coverage error vs oracle {circle_err:.3g}",
          flush=True)
    if not circle_err <= 1e-3:
        fail(f"circle coverage error {circle_err} > 1e-3")

    # ---- 6. timing --------------------------------------------------------
    args = raster_args(coverage, spec, runtime)
    kernel_ms, k_lo, k_hi = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 20, 5)
    plain_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 3, 1, 1)[0]
    # A frame: Renderer.render with the binning cached (unchanged
    # transforms), from the host call to the end of its last kernel.
    frame_ms = cuda_ms(
        lambda: renderer.render(commands, to_host=False), 20, 1, 5
    )[0]
    bin_ms = binning_ms(renderer, commands, 5)
    print(f"timing ({card}): coverage_raster {kernel_ms:.3f} ms "
          f"[{k_lo:.3f}, {k_hi:.3f}], "
          f"rasterize_plain {plain_ms:.3f} ms, frame (cached binning) "
          f"median {frame_ms:.3f} ms, binning median {bin_ms:.3f} ms",
          flush=True)

    # ---- 7. config 3: dashed strokes --------------------------------------
    paths, options = scenes.dashed_strokes(WIDTH, HEIGHT, seed=1)
    dashed = Shape(paths, options)
    commands3 = [
        DrawCommand(RenderOperation.STENCIL, dashed, t),
        DrawCommand(RenderOperation.COLOR, dashed, t, color=(1, 1, 1, 1)),
    ]
    renderer3 = Renderer(Configuration(), WIDTH, HEIGHT, device="cuda")
    spec3, _, runtime3 = renderer3._prepare(commands3)
    torch.cuda.synchronize()
    print(f"config 3: {len(dashed.triangles)} triangles; spec tile "
          f"{spec3.tile_h}x{spec3.tile_w} strips {spec3.tile_strips}; "
          f"stats {renderer3.stats}", flush=True)
    if not spec3.has_strokes:
        fail("config 3: the spec has no stroke rows")
    err3 = kernel_vs_plain(coverage, spec3, runtime3, "config 3")
    since = raster_launches()
    images = []
    for phase in (0.0, 0.3):
        for g, join in enumerate(scenes.DASHED_JOINS):
            dashed.set_dynamic_stroke_options(g, scenes.dashed_options(join, phase))
        images.append(renderer3.render(commands3, to_host=False))
    torch.cuda.synchronize()
    launches3 = raster_launches() - since
    if launches3 < 2:
        fail(f"config 3: {launches3} launches for two frames")
    for image in images:
        check_frame(image, HEIGHT, WIDTH, "config 3")
    moved = int((images[0][..., 3] != images[1][..., 3]).sum())
    print(f"config 3: render at phases 0 and 0.3: {launches3} launches, "
          f"{len(renderer3._prepared_cache)} binning(s), {moved} pixels "
          f"changed", flush=True)
    if len(renderer3._prepared_cache) != 1 or moved == 0:
        fail("config 3: a dash phase change rebinned or moved nothing")

    # ---- 8. the showcase at 4K, both variants ------------------------------
    start = time.perf_counter()
    show_shape = showcase.build_shape(with_text=True)
    print(f"showcase: {len(show_shape.triangles)} triangles, built in "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    variants = {
        "showcase": (
            Configuration(),
            showcase.showcase_commands(show_shape, SHOWCASE_W, SHOWCASE_H),
        ),
        "showcase clip/alpha": (
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            showcase.showcase_commands_clip_alpha(
                show_shape, SHOWCASE_W, SHOWCASE_H
            ),
        ),
    }
    # The same commands with two alpha layers: layer mode 0, the layers
    # in the block's shared memory.
    variants["showcase clip/alpha L=2"] = (
        Configuration(alpha_layer_count=2, blending="front_to_back"),
        variants["showcase clip/alpha"][1],
    )
    shown = {}
    for label, (config, cmds) in variants.items():
        r = Renderer(config, SHOWCASE_W, SHOWCASE_H, device="cuda")
        start = time.perf_counter()
        spec_v, _, runtime_v = r._prepare(cmds)
        torch.cuda.synchronize()
        print(f"{label}: {len(cmds)} commands, binned in "
              f"{time.perf_counter() - start:.2f} s; spec tile "
              f"{spec_v.tile_h}x{spec_v.tile_w} strips {spec_v.tile_strips}, "
              f"layer mode {coverage.layer_mode(spec_v)}; stats {r.stats}",
              flush=True)
        err_v = kernel_vs_plain(coverage, spec_v, runtime_v, label)
        image, launches_v = render_main_path(
            coverage, r, cmds, label, SHOWCASE_H, SHOWCASE_W
        )
        shown[label] = (r, cmds, spec_v, runtime_v, err_v, launches_v, image)
    has_clip, has_alpha = coverage.clip_alpha_ops(shown["showcase clip/alpha"][2])
    if not (has_clip and has_alpha):
        fail("showcase clip/alpha: the frame holds no clip or alpha ops")
    clipped = shown["showcase clip/alpha"][6]
    corners = torch.stack([
        clipped[:2, :2].abs().max(), clipped[:2, -2:].abs().max(),
        clipped[-2:, :2].abs().max(), clipped[-2:, -2:].abs().max(),
    ])
    if float(corners.max()) != 0.0:
        fail("showcase clip/alpha: pixels outside the outer clip")
    print("showcase clip/alpha: the four corners outside the clip are empty",
          flush=True)
    gating_phase(coverage, renderer_module, shown["showcase clip/alpha"])
    layers_phase(coverage, Configuration, Renderer, shown["showcase clip/alpha"][1])

    # ---- 9. the cap sheet against the golden --------------------------------
    w, h = scenes.CAP_SHEET_SIZE
    caps = Shape(*scenes.cap_sheet())
    t_caps = scenes.ortho(w, h)
    cap_alpha = Renderer(Configuration(), w, h, device="cuda").render([
        DrawCommand(RenderOperation.STENCIL, caps, t_caps),
        DrawCommand(RenderOperation.COLOR, caps, t_caps, color=(1, 1, 1, 1)),
    ])[..., 3]
    golden = np.load(os.path.join(here, CAP_GOLDEN))
    cap_diff = int((cap_alpha != golden).sum())
    print(f"cap sheet: {cap_diff} of {golden.size} pixels differ from the "
          f"golden", flush=True)
    if cap_diff:
        fail("the cap sheet differs from the golden")

    # ---- 10. timing of the new frames ---------------------------------------
    timed = {"config 3": (renderer3, commands3, spec3, runtime3, err3, launches3)}
    timed.update({k: v[:6] for k, v in shown.items()})
    times = time_frames(coverage, timed, card)
    # The first torch.profiler session of the run (phase 19's and 20's
    # come later): one cached showcase frame's device operations.
    cached_frame_trace(coverage, *shown["showcase"][:2], card)

    # ---- 11. the showcase under the reference's depth state ----------------
    paint_frames = {}
    depth_cmds = shown["showcase"][1]
    r = Renderer(
        Configuration(depth_compare="less_equal", depth_write_enabled=True),
        SHOWCASE_W, SHOWCASE_H, device="cuda",
    )
    depth_image = frame_phase(coverage, r, depth_cmds, "showcase + depth",
                              SHOWCASE_H, SHOWCASE_W, paint_frames)
    if not coverage.kernel_features(paint_frames["showcase + depth"][2]).depth:
        fail("showcase + depth: the frame does not take the depth build")
    changed = int((depth_image != shown["showcase"][6]).any(-1).sum())
    print(f"showcase + depth: {changed} pixels differ from the frame without "
          f"depth", flush=True)
    if changed == 0:
        fail("showcase + depth: the depth test changed no pixel")

    # ---- 12. the gradient card -------------------------------------------------
    card_cmds, (start_pt, end_pt) = scenes.gradient_card(SHOWCASE_W, SHOWCASE_H)
    r = Renderer(Configuration(), SHOWCASE_W, SHOWCASE_H, device="cuda")
    card_image = frame_phase(coverage, r, card_cmds, "gradient card",
                             SHOWCASE_H, SHOWCASE_W, paint_frames)
    if coverage.paint_mode(paint_frames["gradient card"][2]) != 1:
        fail("gradient card: the frame does not take the gradient build")
    # The card's two ends along its axis: on each end's corner arc, 3 px
    # inside the card, where t is nearest 0 and 1.
    axis = np.subtract(end_pt, start_pt)
    unit = axis / np.linalg.norm(axis)
    inset = scenes.CARD_RADIUS * SHOWCASE_H
    corners = np.array([inset, -inset])
    for sign, centre, (_, stop) in (
        (-1.0, np.add(start_pt, corners), scenes.CARD_STOPS[0]),
        (1.0, np.subtract(end_pt, corners), scenes.CARD_STOPS[-1]),
    ):
        x, y = centre + sign * (inset - 3.0) * unit
        t_end = float(np.dot((x, y) - np.asarray(start_pt), axis) / np.dot(axis, axis))
        got = card_image[int(SHOWCASE_H - y), int(x)].tolist()
        off = max(abs(a - b) for a, b in zip(got, stop))
        print(f"gradient card: colour at t = {t_end:.4f} of its axis "
              f"{[round(v, 4) for v in got]}, stop {list(stop)}, max channel "
              f"difference {off:.4f}", flush=True)
        if not off <= 0.02:
            fail("gradient card: the card's end does not match its stop")

    # ---- 13. mixed paints with a user paint, under depth -----------------------
    mixed_cmds = scenes.mixed_paints(WIDTH, HEIGHT)
    r = Renderer(
        Configuration(depth_compare="less_equal", depth_write_enabled=True),
        WIDTH, HEIGHT, device="cuda",
    )
    mixed_image = frame_phase(coverage, r, mixed_cmds, "mixed paints",
                              HEIGHT, WIDTH, paint_frames)
    features = coverage.kernel_features(paint_frames["mixed paints"][2])
    if features.user_sources != (scenes.CHECKER_CUDA,) or not features.depth:
        fail("mixed paints: the frame does not take the user-paint build")
    rgba8 = Renderer._quantize(mixed_image)
    for rgb in ((204, 0, 204), (0, 204, 0)):
        hits = int((rgba8[..., :3] == torch.tensor(rgb, device=rgba8.device,
                                                   dtype=torch.uint8)).all(-1).sum())
        print(f"mixed paints: checker colour {rgb}: {hits} pixels", flush=True)
        if hits == 0:
            fail(f"mixed paints: the checker colour {rgb} is missing")

    # ---- 14. timing of the depth and paint frames ------------------------------
    times.update(time_frames(coverage, paint_frames, card))

    # ---- 15. config 4 in its three forms ---------------------------------------
    text_frames = config4_phase(coverage, scenes, Configuration, Renderer, card)

    # ---- 16. the showcase on the default, auto-instanced path --------------------
    fused_showcase_phase(coverage, Renderer, shown, card)

    # ---- 17. the carry probe --------------------------------------------------
    carry_phase(renderer, commands, card)

    # ---- 18. the deferred capacity check --------------------------------------
    deferred_capacity_phase(scenes, Configuration, DrawCommand, RenderOperation,
                            Renderer, Shape)

    # ---- 19. the showcase orbit through FrameProgram ----------------------------
    orbit = orbit_phase(coverage, showcase, Configuration, Renderer, card,
                        SHOWCASE_W, SHOWCASE_H)
    orbit_phase(coverage, showcase, Configuration, Renderer, card, WIDTH, HEIGHT)
    near_plane_phase(coverage, showcase, Configuration, Renderer, card)
    cover_bins_phase(coverage, scenes, showcase, renderer_module, card)
    moved_render_phase(coverage, renderer_module, scenes, showcase, card)

    # ---- 20. the orbit example through FrameLoop ---------------------------------
    frame_loop_phase(coverage, Renderer, card)

    # ---- 21. the standalone fill rasterizer -----------------------------------------
    fill_raster_phase(scenes, card)

    # ---- 22. row bands and tiles over a Mesh of the cards -----------------------------
    sharded = sharded_phase(coverage, showcase, Configuration, Renderer, card)

    # ---- 23. the HTTP viewer ---------------------------------------------------------
    viewer_phase(card)

    # ---- 24. the examples -------------------------------------------------------------
    examples_phase(Renderer, card_image)

    # ---- 25. the kernel body by body ----------------------------------------------
    breakdown_phase(coverage,
                    breakdown_frames(coverage, scenes, showcase, renderer_module),
                    card, BREAKDOWN_OMIT)

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    if any(m == "contrast_renderer_tpu" or m.startswith("contrast_renderer_tpu.")
           for m in sys.modules):
        fail("a module of the JAX package was imported")

    frames = {"config 2": (spec, runtime, launches, max_abs_err)}
    frames.update({k: (v[2], v[3], v[5], v[4]) for k, v in timed.items()})
    frames.update({k: (v[2], v[3], v[5], v[4]) for k, v in paint_frames.items()})
    times["config 2"] = (kernel_ms, plain_ms)
    bounds = {}
    for label, (spec_v, runtime_v, _, _) in frames.items():
        work = {}
        bounds[label] = kernel_bound(coverage, spec_v, runtime_v, work)
        b_ms, b_by, nbytes, ops = bounds[label]
        print(f"bound {label}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP "
              f"-> {b_ms:.4f} ms ({b_by}); kernel {times[label][0]:.3f} ms; "
              f"clip vote skipped {work.get('clip_skipped', 0)} (warp, unit) "
              f"pairs; {walk_counts(work)}; warp vote "
              f"skipped {work.get('vote_skipped', 0)} of "
              f"{work.get('stroke_samples', 0)} stroke sample evaluations; cover "
              f"vote skipped {work.get('cover_skipped', 0)} of "
              f"{work.get('cover_warps', 0)} (warp, colour unit) pairs",
              flush=True)
    for label, (spec_v, runtime_v, launches_v, err_v, k_ms, p_ms, bound) in (
            text_frames.items()):
        frames[label] = (spec_v, runtime_v, launches_v, err_v)
        times[label] = (k_ms, p_ms)
        bounds[label] = bound
    for label, result in (("orbit", orbit), ("sharded", sharded)):
        spec_v, runtime_v, launches_v, err_v, k_ms, p_ms, bound = result
        frames[label] = (spec_v, runtime_v, launches_v, err_v)
        times[label] = (k_ms, p_ms)
        bounds[label] = bound

    def entry(name, line, label, frame):
        _, _, launches_v, err_v = frames[label]
        b_ms, b_by, _, _ = bounds[label]
        return {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:{line}", "frame": frame,
            "launches": launches_v, "max_abs_err": err_v,
            "ms": times[label][0], "plain_ms": times[label][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }

    print(f"run: {time.perf_counter() - run_start:.1f} s to here, builds "
          f"included", flush=True)
    config2 = ("config 2", "config 2 (1,000 Bézier fills, 1920x1080)")
    clip_alpha = ("showcase clip/alpha", "showcase clip/alpha variant, 3840x2160")
    print(json.dumps({"kernels": [
        entry("coverage_raster: tile driver and resolve", 1446, *config2),
        entry("coverage_raster: fill stencil", 1672, *config2),
        entry("coverage_raster: solid colour cover", 1894, *config2),
        entry("coverage_raster: stroke stencil", 1511, "config 3",
              "config 3 (60 dashed polylines, 1920x1080)"),
        entry("coverage_raster: clip", 2109, *clip_alpha),
        entry("coverage_raster: alpha groups", 2126, *clip_alpha),
        entry("coverage_raster: alpha groups, two layers in shared memory", 2126,
              "showcase clip/alpha L=2",
              "showcase clip/alpha variant, alpha_layer_count=2, 3840x2160"),
        entry("coverage_raster: depth", 1938, "showcase + depth",
              "showcase with text, LessEqual + depth write, 3840x2160"),
        entry("coverage_raster: gradient paints", 2037, "gradient card",
              "gradient card (examples/gradients.py), 3840x2160"),
        entry("coverage_raster: user paints", 2016, "mixed paints",
              "mixed paints with the checker UserPaint, depth, 1920x1080"),
        entry("coverage_raster: config 4, monolith", 1446, "config 4 monolith",
              "config 4 monolith (shape_of_text, 10,080 glyphs), 1920x1080"),
        entry("coverage_raster: config 4, fused", 1446, "config 4 fused",
              "config 4 fused (text_commands_fused: one multi-shape stencil "
              "over 10,080 glyph instances), 1920x1080"),
        entry("coverage_raster: config 4, per-glyph", 1446, "config 4 per-glyph",
              "config 4 per-glyph (text_commands: one instanced pair per "
              "unique glyph), 1920x1080"),
        dict(entry("coverage_raster: showcase orbit (FrameProgram)", 1446, "orbit",
                   f"showcase with text under the orbit, {ORBIT_FRAMES} frames "
                   f"through FrameProgram, packed RGBA8, 3840x2160; times on the "
                   f"frame with the most near-plane crossings"),
             frames=ORBIT_FRAMES, launches_per_frame=orbit[2] / ORBIT_FRAMES),
        entry("coverage_raster: showcase over 4 row bands (render_sharded)", 1446,
              "sharded",
              f"showcase with text, 3840x2160 over a Mesh of {SHARD_BANDS} row "
              f"bands (3840x540 each); launches over one render_sharded frame; "
              f"times and bound of its slowest band"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def cached_frame_trace(coverage, renderer, commands, card):
    """One frame of the showcase at 4K, float output, binning cached,
    under torch.profiler after one small torch operation (a marker: the
    trace then holds the card's operations of the window): the device
    operations in order, of which the coverage kernel must be the last
    (it writes the frame's own layout: no de-tiling copy follows); and
    the frame's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    renderer.render(commands, to_host=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        image = renderer.render(commands, to_host=False)
        torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    listed = "; ".join(
        f"{e.name[:48]} {e.time_range.end - e.time_range.start:.1f} us"
        for e in events
    )
    frame_ms = cuda_ms(lambda: renderer.render(commands, to_host=False), 10, 1, 3)
    print(f"cached showcase frame, 3840x2160 float ({card}): {tuple(image.shape)} "
          f"{image.dtype}; device operations in order, the marker first: "
          f"{listed or 'none traced'}; frame (cached binning) {frame_ms[0]:.3f} "
          f"ms [{frame_ms[1]:.3f}, {frame_ms[2]:.3f}]", flush=True)
    kernel = [i for i, e in enumerate(events) if "coverage_raster" in e.name]
    if kernel != [len(events) - 1]:
        fail("cached showcase frame: the trace does not end in the one coverage "
             "kernel launch")
    if tuple(image.shape) != (SHOWCASE_H, SHOWCASE_W, 4) or not image.is_contiguous():
        fail(f"cached showcase frame: {tuple(image.shape)}, not the (H, W, 4) frame")


def gating_phase(coverage, renderer_module, shown):
    """The clip/alpha frame's bracket gating: the tiles it emptied (its
    binning against the binning without gate spans), and its packed
    RGBA8 image against the image rendered without gate spans."""
    import torch

    r, cmds, spec, runtime = shown[:4]
    if not spec.gate_spans:
        fail("showcase clip/alpha: the frame has no gate spans")
    gated = r.render(cmds, to_host=False, as_uint8=True)
    analysis = renderer_module._gate_spans
    renderer_module._gate_spans = lambda commands, spec: ()
    try:
        plain = renderer_module.Renderer(r.config, r.width, r.height, device="cuda")
        ungated_spec, _, ungated_runtime = plain._prepare(cmds)
        ungated = plain.render(cmds, to_host=False, as_uint8=True)
    finally:
        renderer_module._gate_spans = analysis
    torch.cuda.synchronize()
    if ungated_spec.gate_spans:
        fail("showcase clip/alpha: the ungated render still has gate spans")
    acount = runtime[0].acount.reshape(-1)
    full = ungated_runtime[0].acount.reshape(-1)
    spans = [(len(c), len(m), len(p)) for c, m, p in spec.gate_spans]
    print(f"showcase clip/alpha: gate spans (content units, machinery units, "
          f"row pairs) {spans}; {int((acount == 0).sum())} of {acount.numel()} "
          f"tiles empty gated, {int((full == 0).sum())} ungated; "
          f"{int(full.sum()) - int(acount.sum())} (tile, unit) pairs dropped",
          flush=True)
    differ = int((gated != ungated).any(-1).sum())
    print(f"showcase clip/alpha: gated vs ungated image, packed RGBA8: "
          f"{differ} pixels differ", flush=True)
    if differ:
        fail("showcase clip/alpha: the gated image differs from the ungated one")


def layers_phase(coverage, Configuration, Renderer, cmds):
    """The clip/alpha frame at 16x MSAA with 16 alpha layers: the layer
    scratch of resident blocks, its size, the peak device memory over a
    render with the binning cached, and the image against the frame with
    one layer in registers."""
    import torch

    images = {}
    for layers in (16, 1):
        config = Configuration(alpha_layer_count=layers, blending="front_to_back",
                               msaa_sample_count=16)
        r = Renderer(config, SHOWCASE_W, SHOWCASE_H, device="cuda")
        spec, _, _ = r._prepare(cmds)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        since = raster_launches()
        images[layers] = r.render(cmds, to_host=False, as_uint8=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        blocks = coverage.layer_scratch_blocks(spec, images[layers].device)
        scratch = blocks * max(1, spec.n_layers) * spec.samples * 256 * 4
        print(f"showcase clip/alpha, 16x MSAA, {layers} alpha layer(s): layer "
              f"mode {coverage.layer_mode(spec)}, layer scratch {blocks} blocks, "
              f"{scratch / 2**20:.1f} MiB; {raster_launches() - since} launch(es); "
              f"peak device memory over the render {peak / 2**20:.1f} MiB",
              flush=True)
        if (raster_launches() - since) < 1:
            fail("showcase clip/alpha, 16 layers: the render did not launch the kernel")
        if layers == 16 and (blocks == 0 or peak > LAYER_MEMORY_LIMIT):
            fail(f"showcase clip/alpha, 16 layers: {blocks} scratch blocks, "
                 f"peak {peak} bytes over a render")
    differ = int((images[16] != images[1]).any(-1).sum())
    print(f"showcase clip/alpha, 16x MSAA: 16 layers vs 1 layer, packed RGBA8: "
          f"{differ} pixels differ", flush=True)
    if differ:
        fail("showcase clip/alpha, 16x MSAA: 16 layers and 1 layer differ")


def frame_phase(coverage, renderer, commands, label, height, width, frames):
    """Bin a frame on the card, hold the kernel against plain on it,
    render it through Renderer.render (counting launches), and record it
    in ``frames`` for timing.  Returns the rendered frame."""
    import torch

    start = time.perf_counter()
    spec_v, _, runtime_v = renderer._prepare(commands)
    torch.cuda.synchronize()
    print(f"{label}: {len(commands)} commands, binned in "
          f"{time.perf_counter() - start:.2f} s; spec tile "
          f"{spec_v.tile_h}x{spec_v.tile_w} strips {spec_v.tile_strips}; "
          f"build {coverage.kernel_features(spec_v).name}; stats "
          f"{renderer.stats}", flush=True)
    err_v = kernel_vs_plain(coverage, spec_v, runtime_v, label)
    image, launches_v = render_main_path(
        coverage, renderer, commands, label, height, width
    )
    frames[label] = (renderer, commands, spec_v, runtime_v, err_v, launches_v)
    return image


def time_frames(coverage, frames, card):
    """Kernel, plain version, cached-binning frame (CUDA events and the
    host clock with no synchronise) and one binning of each frame;
    returns {label: (kernel ms, plain ms)}."""
    times = {}
    for label, (r, cmds, spec_v, runtime_v, _, _) in frames.items():
        args = raster_args(coverage, spec_v, runtime_v)
        k_ms, k_lo, k_hi = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        p_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 1, 1, 0)[0]
        f_ms = cuda_ms(lambda: r.render(cmds, to_host=False), 10, 1, 3)[0]
        h_ms = host_ms(lambda: r.render(cmds, to_host=False), 20, 3)
        b_ms = binning_ms(r, cmds, 3)
        times[label] = (k_ms, p_ms)
        print(f"timing {label} ({card}): coverage_raster {k_ms:.3f} ms "
              f"[{k_lo:.3f}, {k_hi:.3f}], "
              f"rasterize_plain {p_ms:.3f} ms, frame (cached binning) "
              f"median {f_ms:.3f} ms, its host time median {h_ms:.3f} ms, "
              f"binning median {b_ms:.3f} ms", flush=True)
    return times


def stencil_triangles(commands):
    """Triangles over the stencil draws of a command list: each
    instance's shape's triangles."""
    total = 0
    for c in commands:
        if int(c.operation) != 0:
            continue
        shapes = c.shapes
        per = sum(len(s.triangles) for s in shapes)
        total += per if len(shapes) > 1 else per * c.n_instances
    return total


def config4_phase(coverage, scenes, Configuration, Renderer, card):
    """Phase 15: config 4's three forms at 1920x1080.  Returns {label:
    (spec, runtime, launches, max_abs_err, kernel ms, plain ms, bound)}."""
    from dataclasses import replace

    import numpy as np
    import torch

    results, images = {}, {}
    for form in scenes.CONFIG4_FORMS:
        label = "config 4 " + form.replace("_", "-")
        start = time.perf_counter()
        cmds = scenes.config4_text(form)
        build_s = time.perf_counter() - start
        r = Renderer(Configuration(), WIDTH, HEIGHT, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        spec, _, runtime = r._prepare(cmds)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - start
        image, launches = render_main_path(coverage, r, cmds, label, HEIGHT, WIDTH)
        peak = torch.cuda.max_memory_allocated() - base
        units = len(coverage.draw_tables(spec).unit_cmd)
        print(f"{label}: scene built in {build_s:.2f} s; {len(cmds)} commands "
              f"({spec.n_commands} walked), {units} units, "
              f"{stencil_triangles(cmds)} triangles; first binning "
              f"{first_s:.2f} s; spec tile {spec.tile_h}x{spec.tile_w} strips "
              f"{spec.tile_strips}, {spec.n_tiles} tiles; stats {r.stats}; "
              f"peak device memory over the first binning and render "
              f"{peak / 2**20:.1f} MiB", flush=True)
        args = raster_args(coverage, spec, runtime)
        k_ms, k_lo, k_hi = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        f_ms = cuda_ms(lambda: r.render(cmds, to_host=False), 10, 1, 3)[0]
        h_ms = host_ms(lambda: r.render(cmds, to_host=False), 20, 3)
        b_ms = binning_ms(r, cmds, 3)
        # The plain version once: its output, its time and the work
        # counts of the bound.
        got = coverage.coverage_raster(*args)
        work = {}
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        want = coverage.detile(spec, coverage.rasterize_plain(*args, work=work))
        end.record()
        torch.cuda.synchronize()
        p_ms = begin.elapsed_time(end)
        err = float((got - want).abs().max())
        print(f"{label}: kernel vs plain, float: max abs err {err:.3g}, "
              f"bit-identical {bool(torch.equal(got, want))}", flush=True)
        if not torch.equal(got, want):
            fail(f"{label}: float output off by {err}")
        if form != "per_glyph":  # its plain version takes seconds
            packed = (replace(spec, out_uint8=True),) + args[1:]
            if not torch.equal(coverage.coverage_raster(*packed), coverage.detile(
                    packed[0], coverage.rasterize_plain(*packed))):
                fail(f"{label}: packed RGBA8 output disagrees with the plain version")
            print(f"{label}: kernel vs plain, packed RGBA8: equal", flush=True)
        bound = bound_from_work(coverage, spec, runtime, work)
        print(f"timing {label} ({card}): coverage_raster {k_ms:.3f} ms "
              f"[{k_lo:.3f}, {k_hi:.3f}], rasterize_plain {p_ms:.3f} ms, frame "
              f"(cached binning) median {f_ms:.3f} ms, its host time median "
              f"{h_ms:.3f} ms, binning median {b_ms:.3f} ms; kernel_bound "
              f"{bound[0]:.4f} ms ({bound[1]}: {bound[2] / 1e6:.1f} MB, "
              f"{bound[3] / 1e9:.2f} GFLOP)", flush=True)
        images[form] = image
        results[label] = (spec, runtime, launches, err, k_ms, p_ms, bound)
        if form == "monolith":
            # The same frame with the transform's x and y scales one
            # float32 step larger: how far rounding alone moves it.
            nudged = scenes.config4_transform()
            for i in (0, 1):
                nudged[i, i] = np.nextafter(nudged[i, i], np.float32(1.0))
            images["nudged"] = Renderer(Configuration(), WIDTH, HEIGHT).render(
                [replace(c, transform=nudged) for c in cmds], to_host=False
            )
    compare_with_monolith(Renderer, "monolith, scales one float32 step up",
                          images["nudged"], images["monolith"], gate=False)
    for form in ("fused", "per_glyph"):
        compare_with_monolith(Renderer, form.replace("_", "-"), images[form],
                              images["monolith"])
    print(f"config 4: fused vs per-glyph image (same instance transforms, "
          f"other covers): equal to the bit "
          f"{bool(torch.equal(images['fused'], images['per_glyph']))}", flush=True)
    return results


def compare_with_monolith(Renderer, label, image, monolith, gate=True):
    """A config-4 image against the monolith's, packed RGBA8: the pixels
    that differ, by how many of their four samples (opaque white: 255/4
    per sample).  With ``gate``, fails beyond TEXT_MISMATCH_LIMIT of
    pixels or TEXT_MISMATCH_SAMPLES samples in a pixel.  The forms
    cannot be held to equality: the monolith stamps each glyph's table
    at its pen position in float64 before the float32 transform, the
    others compose the pen position into float32 instance matrices, so
    a sample within a float32 step of an edge (1.2e-4 px at x = 1920)
    can land on either side, in the JAX package as here; the monolith
    with its transform nudged by one float32 step shows the scale."""
    import numpy as np
    import torch

    label = f"config 4: {label} vs monolith image"
    if torch.equal(image, monolith):
        print(f"{label}: equal to the bit", flush=True)
        return
    got = Renderer._quantize(image).int()
    want = Renderer._quantize(monolith).int()
    lsb = (got - want).abs().amax(-1)
    samples = torch.round(lsb.double() * 4 / 255).long()
    share = float((lsb > 0).double().mean())
    counts = np.bincount(samples[lsb > 0].cpu().numpy(), minlength=5)[1:]
    print(f"{label}, packed RGBA8: {int((lsb > 0).sum())} pixels ({share:.2e}) "
          f"differ, max {int(lsb.max())} LSB; pixels off by 1, 2, 3, 4 "
          f"samples: {counts.tolist()}", flush=True)
    if gate and (share > TEXT_MISMATCH_LIMIT
                 or int(samples.max()) > TEXT_MISMATCH_SAMPLES):
        fail(f"{label}: beyond {TEXT_MISMATCH_LIMIT} of pixels or "
             f"{TEXT_MISMATCH_SAMPLES} samples in a pixel")


def fused_showcase_phase(coverage, Renderer, shown, card):
    """Phase 16: phase 8's showcase frames were auto-instanced on the
    default path; each against the same commands walked in sequence."""
    import torch

    for label in ("showcase", "showcase clip/alpha"):
        r, cmds, spec, runtime = shown[label][:4]
        walked = Renderer(r.config, r.width, r.height, auto_instance=False,
                          device="cuda")
        seq_spec, _, seq_runtime = walked._prepare(cmds)
        fused = r.render(cmds, to_host=False, as_uint8=True)
        sequential = walked.render(cmds, to_host=False, as_uint8=True)
        torch.cuda.synchronize()
        differ = int((fused != sequential).any(-1).sum())
        timed = {}
        for name, (rr, sp, rt) in (("fused", (r, spec, runtime)),
                                   ("sequential", (walked, seq_spec, seq_runtime))):
            args = raster_args(coverage, sp, rt)
            timed[name] = (
                cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)[0],
                cuda_ms(lambda: rr.render(cmds, to_host=False), 10, 1, 3)[0],
                host_ms(lambda: rr.render(cmds, to_host=False), 20, 3),
            )
        print(f"{label}: {len(cmds)} commands, {spec.n_commands} after "
              f"auto-instancing (instances {spec.cmd_inst}), "
              f"{seq_spec.n_commands} walked in sequence; fused vs sequential, "
              f"packed RGBA8: {differ} pixels differ; ({card}) kernel, frame "
              f"(cached binning), host: fused {timed['fused'][0]:.3f}, "
              f"{timed['fused'][1]:.3f}, {timed['fused'][2]:.3f} ms; sequential "
              f"{timed['sequential'][0]:.3f}, {timed['sequential'][1]:.3f}, "
              f"{timed['sequential'][2]:.3f} ms", flush=True)
        if spec.n_commands >= seq_spec.n_commands:
            fail(f"{label}: the default path did not auto-instance the frame")
        if differ:
            fail(f"{label}: the fused image differs from the sequential walk's")


def carry_phase(renderer, commands, card):
    """Phase 17: ten config-2 frames chained through render(carry=...)."""
    import torch

    image = renderer.render(commands, to_host=False)
    acc = torch.zeros((), device="cuda")
    for _ in range(10):
        out, acc = renderer.render(commands, carry=acc)
    torch.cuda.synchronize()
    want = 10 * float(image[..., 3].double().sum())
    rel = abs(float(acc) - want) / want
    equal = bool(torch.equal(out, image))
    carried = cuda_ms(lambda: renderer.render(commands, carry=acc), 10, 1, 3)[0]
    print(f"carry: ten chained config-2 frames: {float(acc):.6g} against "
          f"10 x alpha sum {want:.6g} (relative error {rel:.2e}), on "
          f"{acc.device}; image equal to a render without carry {equal}; "
          f"frame with carry median {carried:.3f} ms ({card})", flush=True)
    if acc.device.type != "cuda" or not rel <= 1e-5 or not equal:
        fail("carry: the chained sum or the image is wrong")


def deferred_capacity_phase(scenes, Configuration, DrawCommand, RenderOperation,
                            Renderer, Shape):
    """Phase 18: strict_capacity=False on tests/test_coverage_exec.py's 20
    nested circles, scaled from 64² to 256², from a tile capacity of 8."""
    import torch

    size = CIRCLE_SIZE
    k = size / 64
    t = scenes.ortho(size, size)
    commands = []
    for i in range(20):
        s = Shape([scenes.Path.from_circle((32 * k, 32 * k), (28 - i) * k)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t, color=(1.0, 0.0, 0.0, 1.0)),
        ]
    r = Renderer(Configuration(), size, size, tile_capacity=8,
                 strict_capacity=False, device="cuda")
    grown_at = None
    for frame in (1, 2, 3):
        image = r.render(commands, to_host=False, as_uint8=True)
        if grown_at is None and r.tile_capacity > 8:
            grown_at = frame
    strict = Renderer(Configuration(), size, size, tile_capacity=8, device="cuda")
    want = strict.render(commands, to_host=False, as_uint8=True)
    torch.cuda.synchronize()
    differ = int((image != want).any(-1).sum())
    print(f"deferred capacity: tile capacity 8 -> {r.tile_capacity} (strict "
          f"render: {strict.tile_capacity}) at frame {grown_at}; third frame vs "
          f"strict render, packed RGBA8: {differ} pixels differ", flush=True)
    if grown_at is None or differ:
        fail("deferred capacity: the capacity did not grow within two frames, "
             "or the image differs from a strict render's")


def device_busy(prof, raster_name="coverage_raster"):
    """(device busy µs, coverage_raster µs, other device µs, device
    events) of a torch.profiler trace: the union of its device events'
    intervals, the sums of the kernel's and of every other device
    event's durations, and their count; None where the trace holds no
    device event."""
    from torch.autograd import DeviceType

    spans, raster, other = [], 0.0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        begin, end = e.time_range.start, e.time_range.end
        spans.append((begin, end))
        if raster_name in e.name:
            raster += end - begin
        else:
            other += end - begin
    if not spans:
        return None
    busy, reach = 0.0, None
    for begin, end in sorted(spans):
        if reach is None or begin > reach:
            busy += end - begin
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy, raster, other, len(spans)


def graph_pool_mib(pool):
    """The device memory that the segments of the CUDA graph memory pool
    ``pool`` (a ``renderer._GraphPool``, its current pool, or a handle)
    hold, as text ("not measured" where the allocator's snapshot does
    not name the pools of its segments)."""
    import torch

    handle = tuple(getattr(pool, "handle", pool))
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured"
    held = sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == handle)
    return f"{held / 2**20:.1f} MiB"


def orbit_phase(coverage, showcase, Configuration, Renderer, card, width, height):
    """Phase 19: the showcase with text under the orbit of
    run_configs.config5_orbit (0.05 rad a frame about the y axis, the
    dash phase 0.032 a frame) through ``Renderer.compile_frame`` with
    packed RGBA8 output and ``plan_for_motion`` over the frames timed.
    Returns (spec, runtime, launches, max_abs_err, kernel ms, plain ms,
    bound) for the kernels line, on the orbit frame with the most
    near-plane crossings."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    label = f"orbit {width}x{height}"
    n = ORBIT_FRAMES
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, width, height)
    stacks = [showcase.orbit_transforms(i, width, height) for i in range(n)]

    def at(i):
        """Frame i's dash phase, set on the shape; its transform stack."""
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP)
        )
        return stacks[i]

    renderer = Renderer(Configuration(), width, height, strict_capacity=False,
                        device="cuda")
    start = time.perf_counter()
    program = renderer.compile_frame(commands, uint8_output=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - start
    settled = dict(program._caps)
    start = time.perf_counter()
    fused = program.plan_for_motion(stacks)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - start
    plan = program._plan
    walked = program._seq.opt_commands if plan is None else plan.commands
    print(f"{label}: compile_frame {compile_s:.2f} s, settled capacities "
          f"{settled}; plan_for_motion over {n} frames {plan_s:.2f} s (the "
          f"scout through a binning graph, the plan's build and capture): "
          f"fused plan active {fused}, {len(commands)} "
          f"commands -> {len(walked)} after fusion (groups "
          f"{[len(g) for g in plan.signature[0][1:]] if plan else None}), "
          f"capacities {program._caps}", flush=True)
    # The same plan_for_motion on a program of its own, scouting with the
    # eager prepare over every frame instead (the scout before the
    # binning graph): same plan, same capacities.
    eager_program = renderer.compile_frame(commands, uint8_output=True)
    eager_program._scout = lambda *a: eager_scout(eager_program, *a)
    start = time.perf_counter()
    eager_program.plan_for_motion(stacks)
    torch.cuda.synchronize()
    eager_plan_s = time.perf_counter() - start
    same = (eager_program._caps == program._caps
            and eager_program._plan.signature == plan.signature)
    print(f"{label} ({card}): plan_for_motion over {n} frames with the graph "
          f"scout {plan_s:.3f} s, with the eager scout {eager_plan_s:.3f} s in "
          f"this process; same plan and capacities {same}", flush=True)
    if not same:
        fail(f"{label}: the graph scout and the eager scout disagree: "
             f"{program._caps} against {eager_program._caps}")
    del eager_program
    builds = []
    for _ in range(5):
        start = time.perf_counter()
        program._build_variant(walked)
        builds.append((time.perf_counter() - start) * 1e3)
    print(f"{label}: building one variant (in the calling thread) median "
          f"{statistics.median(builds):.2f} ms of 5", flush=True)
    # Each variant's frame step: plan_for_motion captured the plan's; the
    # sequential walk's warms up (rendering frame 0) and captures here.
    captures = {
        "fused plan" if v is not program._seq else "sequential walk": v.step
        for v in program._variants() if v.step is not None
    }
    reserved = torch.cuda.memory_reserved()
    program._stage_descriptors()
    seq_step = program._frame_step(program._seq, program._opt_rows(at(0)))
    seq_step.capture()
    torch.cuda.synchronize()
    captures.setdefault("sequential walk", seq_step)
    print(f"{label} ({card}): capture (host ms, the graph's instantiation "
          f"included; each variant warmed up before) "
          + ", ".join(f"{k} {step.capture_ms:.1f} ms ({step.launches} "
                      f"coverage_raster launch, "
                      f"{step.replay_launches['cover_bin_launches']} cover_bins "
                      f"launch a replay)"
                      for k, step in captures.items())
          + f"; reserved device memory {reserved / 2**20:.1f} -> "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB over the sequential "
          f"walk's capture; the program's graph pool "
          f"{graph_pool_mib(program._pool)}", flush=True)
    if any(step.replay_launches != {"raster_launches": 1,
                                    "cover_bin_launches": 1}
           for step in captures.values()):
        fail(f"{label}: a captured step does not launch the raster kernel and "
             f"the cover kernel once each: "
             f"{ {k: step.replay_launches for k, step in captures.items()} }")

    # Near-plane crossings of every frame, from the sequential walk.
    walk = Renderer(Configuration(), width, height, auto_instance=False,
                    device="cuda")

    def walk_commands(i):
        return showcase.showcase_commands(
            shape, width, height, view_rotation=showcase.orbit_rotor(i)
        )

    crossings = []
    for i in range(n):
        at(i)
        walk._prepare(walk_commands(i))
        crossings.append(walk.stats["near_plane_crossings"])
    crossing = int(np.argmax(crossings))
    print(f"{label}: {sum(c > 0 for c in crossings)} of {n} frames cross the "
          f"near plane; the most crossings {crossings[crossing]} at frame "
          f"{crossing}", flush=True)
    if crossings[crossing] == 0:
        fail(f"{label}: no orbit frame crosses the near plane")

    acc = torch.zeros((), device=renderer.device)
    for i in range(3):
        _, acc = program(at(i), carry=acc)
    torch.cuda.synchronize()

    # The eager path of the same frames: the variant's own prepare and
    # rasterize outside its graph, on inputs uploaded for the frame (the
    # program's frame path before the graphs).  One window, timed as
    # below; its frames are kept, and every timed frame of the graph is
    # held against them to the bit.
    def eager_frame(i, acc):
        variant, runtime = program._bin(program._opt_rows(at(i)))
        image = variant.rasterize(*runtime)
        return image, renderer._carry(acc, image)

    eager = []
    start = time.perf_counter()
    for i in range(n):
        image, acc = eager_frame(i, acc)
        eager.append(image)
    float(acc)
    eager_wall = time.perf_counter() - start
    # The allocator holds a window's frames from here on, so that the
    # graph's windows, which keep theirs, allocate nothing new.
    cached = [torch.empty_like(eager[0]) for _ in range(n)]
    del cached
    built = program.builds
    walls = []
    for window in range(ORBIT_WINDOWS):
        host = {"plan_ms": 0.0, "bin_ms": 0.0, "raster_ms": 0.0}
        fused_at, held, captured = [], [], 0
        since, covers_since = raster_launches(), cover_bin_launches()
        start = time.perf_counter()
        for i in range(n):
            image, acc = program(at(i), carry=acc)
            held.append(image)
            for key in host:
                host[key] += program.stats[key]
            fused_at.append(program.stats["fused"])
            captured += "capture_ms" in program.stats
        total = float(acc)
        walls.append(time.perf_counter() - start)
        launches = raster_launches() - since
        covers = cover_bin_launches() - covers_since
        differ = [i for i in range(n) if not torch.equal(held[i], eager[i])]
        del held
        print(f"{label} ({card}), window {window + 1}: {n} frames in "
              f"{walls[-1] * 1e3:.1f} ms, {n / walls[-1]:.2f} frames/s; "
              f"{launches} coverage_raster launches, {covers} cover_bins "
              f"launches; {sum(fused_at)} frames "
              f"fused; {captured} captured; host per frame: planning "
              f"{host['plan_ms'] / n:.3f} ms, copies in and replay (bin_ms) "
              f"{host['bin_ms'] / n:.3f} ms, copy out and carry (raster_ms) "
              f"{host['raster_ms'] / n:.3f} ms; alpha sum {total:.6g}; frames "
              f"equal to the eager path's {n - len(differ)} of {n}", flush=True)
        if captured:
            fail(f"{label}: {captured} frames captured a graph in a timed "
                 f"window")
        if launches != n or covers != n:
            fail(f"{label}: {launches} coverage_raster launches and {covers} "
                 f"cover_bins launches for {n} frames")
        if not np.isfinite(total) or total <= 0:
            fail(f"{label}: the frames' alpha sum is {total}")
        if differ:
            fail(f"{label}: frames {differ[:8]} of the graph differ from the "
                 f"eager path's")
    wall = statistics.median(walls)
    rebuilds = program.builds - built
    del eager
    stages = frame_record_check(program, n, [stacks[0], stacks[crossing]],
                                label)
    print(f"{label} ({card}): frame record over the last window's {n} frames, "
          f"binning's stages in device ms a frame: "
          + ", ".join(f"{s} {ms:.3f}" for s, ms in stages.items())
          + "; every frame six rising marks; an eager binning's stages "
          "within 5% of its CUDA events", flush=True)

    def peak_mib(frame):
        """Peak device memory of 8 frames above what was allocated before
        them, in MiB."""
        nonlocal acc
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(8):
            _, acc = frame(i, acc)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    graph_peak = peak_mib(lambda i, acc: program(at(i), carry=acc))
    eager_peak = peak_mib(eager_frame)
    print(f"{label} ({card}): median of {ORBIT_WINDOWS} windows "
          f"{n / wall:.2f} frames/s ({wall * 1e3 / n:.3f} ms a frame) replaying "
          f"the graphs, against {n / eager_wall:.2f} frames/s ({eager_wall * 1e3 / n:.3f} "
          f"ms a frame) on the eager path in this process; peak device memory "
          f"of a frame above the allocated: graph {graph_peak:.1f} MiB (the graph "
          f"pool {graph_pool_mib(program._pool)} besides), eager {eager_peak:.1f} "
          f"MiB; rebuilds {rebuilds}", flush=True)

    # Calls that wait for the device in one frame (each upload from
    # pageable host memory is one).
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, acc = program(at(5), carry=acc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"{label}: {syncs} synchronising CUDA calls in one frame "
          f"(torch.cuda.set_sync_debug_mode)", flush=True)

    # The same frames under torch.profiler: device busy share, binning's
    # and the kernel's device time.
    frames = range(min(n, 33))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in frames:
            _, acc = program(at(i), carry=acc)
        float(acc)
        profiled = time.perf_counter() - start
    busy = device_busy(prof)
    if busy is None:
        print(f"{label}: device time not measured (the trace holds no device "
              f"events)", flush=True)
    else:
        b_us, r_us, o_us, count = busy
        k = len(frames)
        print(f"{label} ({card}), torch.profiler over {k} frames: device busy "
              f"{b_us / k / 1e3:.3f} ms a frame, {b_us / (profiled * 1e6):.3f} of "
              f"the profiled window and {b_us / k / 1e3 / (wall * 1e3 / n):.3f} of "
              f"an unprofiled frame; coverage_raster {r_us / k / 1e3:.3f} ms a "
              f"frame; binning and the rest {o_us / k / 1e3:.3f} ms a frame, in "
              f"{count / k:.1f} device operations a frame", flush=True)

    # Images against the sequential walk: the frame with the most
    # crossings, a fused frame without crossings, a frame that fell back.
    chosen = {"most near-plane crossings": crossing}
    plain_frames = [i for i in range(n) if fused_at[i] and crossings[i] == 0]
    if plain_frames:
        chosen["fused, no crossing"] = plain_frames[0]
    fallback = [i for i in range(n) if not fused_at[i]]
    if fallback:
        chosen["fell back to the sequential walk"] = fallback[0]
    else:
        print(f"{label}: no frame fell back to the sequential walk", flush=True)
    for why, i in chosen.items():
        got = program(at(i))
        was_fused = program.stats["fused"]
        want = walk.render(walk_commands(i), to_host=False, as_uint8=True)
        torch.cuda.synchronize()
        differ = int((got != want).any(-1).sum())
        print(f"{label}: frame {i} ({why}; fused {was_fused}, {crossings[i]} "
              f"crossings) vs Renderer(auto_instance=False).render, packed "
              f"RGBA8: {differ} pixels differ", flush=True)
        if got.dtype != torch.uint8 or differ:
            fail(f"{label}: frame {i} differs from the sequential walk")

    # The kernel on the crossing frame as the program bins it.
    at(crossing)
    variant, runtime = program._bin(program._opt_rows(stacks[crossing]))
    err = kernel_vs_plain(coverage, variant.spec, runtime,
                          f"{label} frame {crossing}")
    args = raster_args(coverage, variant.spec, runtime)
    k_ms, k_lo, k_hi = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
    p_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 1, 1, 0)[0]
    work = {}
    bound = kernel_bound(coverage, variant.spec, runtime, work)
    print(f"timing {label} frame {crossing} ({card}): coverage_raster "
          f"{k_ms:.3f} ms [{k_lo:.3f}, {k_hi:.3f}], rasterize_plain "
          f"{p_ms:.3f} ms; kernel_bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{bound[2] / 1e6:.1f} MB, {bound[3] / 1e9:.2f} GFLOP); "
          f"{walk_counts(work)}", flush=True)

    # render_sequence over a segment at one dash phase, against __call__.
    segment = np.stack(stacks[:ORBIT_SEQUENCE])
    at(0)
    frames_seq = program.render_sequence(segment)
    singles = [program(t) for t in segment]
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(frames_seq, singles)]
    holds = all(
        program._plan_transforms_if_valid(program._plan, program._opt_rows(t))
        is not None for t in segment
    ) if program._plan is not None else False
    times = []
    for _ in range(3):
        start = time.perf_counter()
        program.render_sequence(segment)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    seq_s = statistics.median(times)
    print(f"{label} ({card}): render_sequence of {len(segment)} frames "
          f"{tuple(frames_seq.shape)} {frames_seq.dtype}, fused plan holds on "
          f"every frame {holds}; frames equal to __call__'s {sum(equal)} of "
          f"{len(equal)}; median {seq_s * 1e3:.1f} ms, "
          f"{len(segment) / seq_s:.2f} frames/s", flush=True)
    if not all(equal):
        fail(f"{label}: render_sequence differs from __call__")
    unplanned_orbit_run(Configuration, Renderer, card, width, height, commands,
                        at)
    return variant.spec, runtime, launches, err, k_ms, p_ms, bound


def in_float64(coverage, fn):
    """``fn()`` while ``coverage.make_prepare`` bins in float64
    (``coverage.prepare_in_float64``): phase 19c's oracle."""
    make_prepare = coverage.make_prepare
    coverage.make_prepare = lambda s: coverage.prepare_in_float64(
        make_prepare(s))
    try:
        return fn()
    finally:
        coverage.make_prepare = make_prepare


def cover_bins_inputs(coverage, run):
    """The arguments of the last ``coverage.cover_bins`` call that
    ``run()`` makes (make_prepare's cover stage)."""
    seen = []
    original = coverage.cover_bins

    def spy(*args):
        seen.append(args)
        return original(*args)

    coverage.cover_bins = spy
    try:
        run()
    finally:
        coverage.cover_bins = original
    return seen[-1]


#: Calls of the cover kernel captured into the graph that phase 19d times.
COVER_GRAPH_CALLS = 20


def graph_ms(fn, calls):
    """(median, least, greatest) device ms a call of ``fn`` replayed from a
    CUDA graph that captures ``calls`` calls of it (warmed up on a side
    stream first), as ``cuda_ms`` times the replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return tuple(t / calls for t in cuda_ms(graph.replay, 5, 10, 2))


def cover_bins_bound(spec, hull, transforms, c_shape):
    """(ms, "bytes" or "operations", bytes, operations): the least time of
    the cover stage's work on the card (the peaks of ``kernel_bound``).
    Operations: 10 a (tile, cover, hull line) pair (_corner_min_max's 4
    multiplies and 6 adds) and about 60 a cover's hull vertex (transform
    28, clip 14, projection 6, area 3, line 9).  Bytes: the hull and
    transform tables and the two index tables read once, hull_lines and
    the (tiles, covers) int32 cls and hbits written once."""
    rc, h2 = c_shape.shape[0], spec.h_max + 2
    size = hull.element_size()
    ops = 10 * spec.n_tiles * rc * h2 + 60 * rc * h2
    nbytes = ((hull.numel() + transforms.numel() + 4 * rc * h2) * size
              + 16 * rc + 8 * spec.n_tiles * rc)
    by_ops, by_bytes = ops / 67e12, nbytes / 3.35e12
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", nbytes, ops)


def cover_bins_phase(coverage, scenes, showcase, api, card):
    """Phase 19d: binning's cover kernel (csrc/cover_bins.cu) at the drift
    cells' shapes (config 3 and config 2 at 1920x1080, one cover each),
    the 4K orbit's frame 30 and config 4 per glyph at 1920x1080: its
    outputs against cover_bins_plain's on the card to the bit, its time
    (back-to-back launches between CUDA events) beside its bound, the
    plain version's time eager and replayed from a CUDA graph (as binning's
    graph ran it), its registers (ptxas) and the ``cover_bin_launches``
    counted.  Fails where the kernel is slower than the plain version."""
    import torch
    from contrast_renderer_tpu_torch import cuda_build
    from contrast_renderer_tpu_torch.utils.profiling import RECORD

    coverage._cover_bins_library()
    log = cuda_build.build_logs.get("cover_bins", (None, ""))[1]
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  cover_bins ptxas: {line.strip()}", flush=True)
    op = api.RenderOperation
    drift = api.Configuration(msaa_sample_count=4, winding_counter_bits=4)
    t = scenes.ortho(WIDTH, HEIGHT)

    def drift_frame(shape, color):
        commands = [api.DrawCommand(op.STENCIL, shape, t),
                    api.DrawCommand(op.COLOR, shape, t, color=color)]
        return lambda: api.Renderer(
            drift, WIDTH, HEIGHT, strict_capacity=False, device="cuda",
        )._prepare(commands, graph=False)

    frames = {
        "strokes-1080p.drift": drift_frame(
            api.Shape(*scenes.dashed_strokes(WIDTH, HEIGHT, seed=1)), (1, 1, 1, 1)),
        "fills-1080p.drift": drift_frame(
            api.Shape(scenes.bezier_fill_paths(1000, WIDTH, HEIGHT, seed=0)),
            (0.9, 0.4, 0.1, 1.0)),
        "orbit 4K frame 30": lambda: orbit_frame(
            coverage, showcase, api.Configuration, api.Renderer, 30),
        "config 4 per-glyph 1080p": lambda: api.Renderer(
            api.Configuration(), WIDTH, HEIGHT, device="cuda",
        )._prepare(scenes.config4_text("per_glyph"), graph=False),
    }
    for label, run in frames.items():
        args = cover_bins_inputs(coverage, run)
        spec, hull, transforms, c_shape, _ = args
        got = coverage.cover_bins(*args)
        want = coverage.cover_bins_plain(*args)
        for name, a, b in zip(("hull_lines", "cls", "hbits"), got, want):
            if a.is_floating_point():
                bits = torch.int64 if a.dtype == torch.float64 else torch.int32
                a, b = a.view(bits), b.view(bits)
            if not torch.equal(a, b):
                fail(f"cover_bins {label}: {name} differs from the plain "
                     f"version in {int((a != b).sum())} places")
        before = RECORD.counters["cover_bin_launches"]
        # Eager calls: paced by the wrapper's host work, not the card.
        eager_k = cuda_ms(lambda: coverage.cover_bins(*args), 5, 100, 10)[0]
        launches = RECORD.counters["cover_bin_launches"] - before
        eager_p = cuda_ms(lambda: coverage.cover_bins_plain(*args), 5, 3, 1)[0]
        # As binning's graph runs the stage: the kernel as one node of a
        # graph of GRAPH_CALLS calls, the plain version's nodes replayed.
        k_ms, k_lo, k_hi = graph_ms(lambda: coverage.cover_bins(*args),
                                    COVER_GRAPH_CALLS)
        p_ms = graph_ms(lambda: coverage.cover_bins_plain(*args), 1)[0]
        b_ms, b_by, nbytes, ops = cover_bins_bound(spec, hull, transforms, c_shape)
        print(f"cover_bins {label} ({card}): {c_shape.shape[0]} covers, "
              f"{spec.h_max + 2} hull lines, {spec.n_tiles} tiles of "
              f"{spec.screen_tile_w}x{spec.screen_tile_h} px; kernel "
              f"{k_ms:.4f} ms [{k_lo:.4f}, {k_hi:.4f}] a node of a graph, "
              f"{eager_k:.4f} ms a call eager ({launches} cover_bin_launches "
              f"over 510 calls); plain {p_ms:.4f} ms replayed from a graph, "
              f"{eager_p:.4f} ms eager; bound {b_ms:.6f} ms ({b_by}: "
              f"{nbytes / 1e3:.1f} kB, {ops / 1e6:.3f} MFLOP); equal to the "
              f"plain version to the bit", flush=True)
        if launches != 510:
            fail(f"cover_bins {label}: {launches} launches counted for 510 calls")
        if k_ms > p_ms or eager_k > eager_p:
            fail(f"cover_bins {label}: the kernel ({k_ms:.4f} ms in a graph, "
                 f"{eager_k:.4f} ms eager) is slower than the plain version "
                 f"({p_ms:.4f}, {eager_p:.4f} ms)")


def near_plane_phase(coverage, showcase, Configuration, Renderer, card):
    """Phase 19c: the near-plane repro, kernel against plain and its
    frame against pair 15 alone and the float64-binned frame; the 256²
    orbit through a program that never planned; two 4K orbit frames
    against their float64 binning."""
    size = NEAR_SIZE
    shape = showcase.build_shape(with_text=True)
    every = showcase.showcase_commands(
        shape, size, size, view_rotation=showcase.orbit_rotor(NEAR_FRAME))

    def render(indices):
        r = Renderer(Configuration(), size, size, auto_instance=False,
                     device="cuda")
        return r.render([every[i] for i in indices], to_host=False,
                        as_uint8=True)

    label = f"near plane {size}x{size}"
    r = Renderer(Configuration(), size, size, auto_instance=False,
                 device="cuda")
    spec, _, runtime = r._prepare([every[i] for i in NEAR_REPRO])
    crossings = int(runtime[0].overflow[3])
    kernel_vs_plain(coverage, spec, runtime, label)
    got, alone = render(NEAR_REPRO), render(NEAR_ALONE)
    oracle = in_float64(coverage, lambda: render(NEAR_REPRO))
    unlike_alone = int((got != alone).any(-1).sum())
    unlike_oracle = int((got != oracle).any(-1).sum())
    print(f"{label} ({card}): orbit frame {NEAR_FRAME}, commands "
          f"{list(NEAR_REPRO)}: {crossings} near-plane crossings binned; "
          f"{int((got[..., 3] > 0).sum())} covered pixels; pixels unlike "
          f"pair 15 alone {unlike_alone}, unlike the float64-binned frame "
          f"{unlike_oracle}", flush=True)
    if crossings == 0:
        fail(f"{label}: no near-plane crossing binned")
    if unlike_alone or unlike_oracle:
        fail(f"{label}: winding leaks from the clipped stencil")

    size = NEAR_ORBIT_SIZE
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, size, size)
    stacks = [showcase.orbit_transforms(i, size, size)
              for i in range(ORBIT_FRAMES)]

    def at(i):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP))
        return stacks[i]

    unplanned_orbit_run(Configuration, Renderer, card, size, size, commands,
                        at)

    width, height = SHOWCASE_W, SHOWCASE_H
    shape = showcase.build_shape(with_text=True)
    for i in NEAR_4K_FRAMES:
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP))
        frame = showcase.showcase_commands(
            shape, width, height, view_rotation=showcase.orbit_rotor(i))

        def render_4k():
            r = Renderer(Configuration(), width, height, auto_instance=False,
                         device="cuda")
            return r, r.render(frame, to_host=False, as_uint8=True)

        r, got = render_4k()
        _, want = in_float64(coverage, render_4k)
        unlike = (got != want).any(-1)
        share = float(unlike.float().mean())
        worst = int((got.int() - want.int()).abs().max())
        print(f"near plane {width}x{height} ({card}): orbit frame {i}, "
              f"{r.stats['near_plane_crossings']} crossings: {int(unlike.sum())} "
              f"of {unlike.numel()} pixels ({share:.2e}) unlike the "
              f"float64-binned frame, max {worst} LSB", flush=True)
        if share > NEAR_4K_LIMIT:
            fail(f"near plane {width}x{height}: frame {i} off its float64 "
                 f"binning in {share:.2e} of the pixels")


def eager_scout(program, plan, stacks, desc_static, paints):
    """One round of plan_for_motion's capacity scout as it ran before the
    binning graph: the round spec's prepare on every frame, eagerly, the
    overflow counters reduced by max on the device and read once."""
    import numpy as np
    import torch

    from contrast_renderer_tpu_torch.ops import coverage

    prepare = coverage.make_prepare(program._variant_spec(plan.commands))
    device = program._renderer.device
    worst = None
    for t in stacks:
        overflow = prepare(
            *program._scene.arrays,
            torch.as_tensor(np.ascontiguousarray(t[plan.gather]), device=device),
            desc_static, paints,
        ).overflow
        worst = overflow if worst is None else torch.maximum(worst, overflow)
    return worst.cpu().numpy()


def eager_sequential(program, transforms, descriptors=None):
    """The frame of ``program`` under ``transforms`` (the public layout)
    and ``descriptors`` (``program._descriptors()`` by default) through
    its sequential walk's own prepare and rasterize, outside every graph,
    whatever variant the program would choose."""
    import torch

    seq, device = program._seq, program._renderer.device
    if descriptors is None:
        descriptors = program._descriptors()
    d = {k: torch.as_tensor(a, device=device) for k, a in descriptors.items()}
    prepared = seq.prepare(
        *program._scene.arrays,
        torch.as_tensor(program._opt_rows(transforms), device=device),
        d["static"], seq.paints,
    )
    return seq.rasterize(prepared, seq.cmd_i, seq.cmd_f, d["f"], d["i"])


def unplanned_orbit_run(Configuration, Renderer, card, width, height, commands,
                        at):
    """Phase 19, last: the orbit's frames through a new program with no
    plan_for_motion, as an app that never planned would run them.  The
    hysteresis builds the groupings met twice, and each variant warms up
    on its first frame and captures its graph on its second.  Frames
    chained through ``carry``, one fetch at the end: frames/s, frames
    fused, groupings counted and built, the frames that captured a graph
    with their host ms, each frame's host ms (the call, unsynchronised)
    and the longest, the frames over 50 ms; every frame kept and, unless
    its binning overflowed the capacities it ran at (the deferred
    growth's under-populated frames, counted), held against the eager
    sequential walk's to the bit."""
    import torch

    label = f"unplanned orbit {width}x{height}"
    n = ORBIT_FRAMES
    renderer = Renderer(Configuration(), width, height, strict_capacity=False,
                        device="cuda")
    program = renderer.compile_frame(commands, uint8_output=True)
    torch.cuda.synchronize()
    acc = torch.zeros((), device=renderer.device)
    held, host_ms, fused, captured = [], [], 0, []
    counters, slow = [], []
    start = time.perf_counter()
    for i in range(n):
        t = at(i)
        caps = [program._caps[name] for name in ("capacity", "global_capacity",
                                                 "tile_global_capacity",
                                                 "clip_pool")]
        builds = program.builds
        begin = time.perf_counter()
        image, acc = program(t, carry=acc)
        host_ms.append((time.perf_counter() - begin) * 1e3)
        held.append(image)
        # The frame's overflow counters (a pinned copy behind an event).
        counters.append((program._pending[-1][:2], caps))
        fused += program.stats["fused"]
        if "capture_ms" in program.stats:
            captured.append(f"{i}: {program.stats['capture_ms']:.1f}")
        if host_ms[-1] > 50.0:
            slow.append(f"{i}: {host_ms[-1]:.1f} ms (fused "
                        f"{program.stats['fused']}, captured "
                        f"{'capture_ms' in program.stats}, rebuilt "
                        f"{program.builds > builds})")
    float(acc)
    wall = time.perf_counter() - start
    differ, overflowed = [], []
    for i in range(n):
        (host, event), caps = counters[i]
        event.synchronize()
        if any(int(c) > cap for c, cap in zip(host.tolist(), caps)):
            overflowed.append(i)
        else:
            want = eager_sequential(program, at(i))
            if not torch.equal(held[i], want):
                differ.append((i, int((held[i] != want).any(-1).sum())))
    longest = max(range(n), key=host_ms.__getitem__)
    print(f"{label} ({card}): {n} frames in {wall * 1e3:.1f} ms, "
          f"{n / wall:.2f} frames/s; {fused} fused; groupings counted "
          f"{len(program._sig_counts)}, built {len(program._fused_variants)}; "
          f"{len(captured)} frames captured a graph (frame: host ms "
          f"{', '.join(captured) or 'none'}); host ms a frame: median "
          f"{statistics.median(host_ms):.2f}, longest {host_ms[longest]:.2f} "
          f"(frame {longest}); frames over 50 ms: {'; '.join(slow) or 'none'}; "
          f"{len(overflowed)} frames overflowed their capacities (deferred "
          f"growth: {overflowed}), the other {n - len(overflowed)} equal to "
          f"the eager sequential walk's {n - len(overflowed) - len(differ)}; "
          f"builds {program.builds}", flush=True)
    if differ:
        fail(f"{label}: (frame, pixels) {differ[:8]} differ from the eager "
             f"sequential walk")


def camera_drift(i, width, height):
    """Frame i of a drifting 2D camera, in pixels: a turn of 0.005 rad a
    frame about the frame's centre and a pan of 2 px a frame along x."""
    import numpy as np

    a = 0.005 * i
    c, s = np.cos(a), np.sin(a)
    cx, cy = width / 2.0, height / 2.0
    m = np.eye(4)
    m[:2, :2] = ((c, -s), (s, c))
    m[0, 3] = cx - c * cx + s * cy + 2.0 * i
    m[1, 3] = cy - s * cx - c * cy
    return m


def moved_frames(api, scenes, showcase, n=None):
    """Phase 19b's moved frames: {label: (configuration, width, height,
    commands of each frame, at(i))}, ``at(i)`` setting what frame i
    changes on a shape (the showcase's dash phase) before its render.
    The showcase with text under the orbit at 4K and 1080p
    (``showcase.orbit_transforms``, the dash phase 0.032 a frame);
    config 2 and config 3 at 1080p under ``camera_drift``."""
    import numpy as np
    from dataclasses import replace

    n = MOVED_FRAMES if n is None else n
    op = api.RenderOperation
    out = {}
    shape = showcase.build_shape(with_text=True)

    def dash(i):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP))

    for w, h in ((SHOWCASE_W, SHOWCASE_H), (WIDTH, HEIGHT)):
        commands = showcase.showcase_commands(shape, w, h)
        out[f"showcase {w}x{h}"] = (api.Configuration(), w, h, [
            [replace(c, transform=np.ascontiguousarray(t))
             for c, t in zip(commands, showcase.orbit_transforms(i, w, h))]
            for i in range(n)
        ], dash)
    fills = api.Shape(scenes.bezier_fill_paths(1000, WIDTH, HEIGHT, seed=0))
    dashed = api.Shape(*scenes.dashed_strokes(WIDTH, HEIGHT, seed=1))
    ortho = np.asarray(scenes.ortho(WIDTH, HEIGHT), np.float64)
    for label, s, color in (("config 2", fills, (0.9, 0.4, 0.1, 1.0)),
                            ("config 3", dashed, (1, 1, 1, 1))):
        frames = []
        for i in range(n):
            t = (ortho @ camera_drift(i, WIDTH, HEIGHT)).astype(np.float32)
            frames.append([api.DrawCommand(op.STENCIL, s, t),
                           api.DrawCommand(op.COLOR, s, t, color=color)])
        out[f"{label} {WIDTH}x{HEIGHT}"] = (
            api.Configuration(), WIDTH, HEIGHT, frames, lambda i: None)
    return out


def copy_costs(coverage, prepared, width, height):
    """Device ms of the copies each way of keeping a replayed miss out of
    a graph's buffers costs at this size: cloning the binning (what a
    cache entry keeps) and cloning a float and a packed frame (what
    capturing the raster too would add); and the binning's MB."""
    import torch

    mb = sum(t.numel() * t.element_size() for t in prepared) / 1e6
    frames = {
        "float": torch.empty((height, width, 4), device="cuda"),
        "packed": torch.empty((height, width, 4), dtype=torch.uint8,
                              device="cuda"),
    }
    binning = cuda_ms(lambda: coverage.PreparedFrame(
        *(t.clone() for t in prepared)), 5, 10, 3)[0]
    return mb, binning, {k: cuda_ms(f.clone, 5, 10, 3)[0]
                         for k, f in frames.items()}


def moved_render_run(coverage, Renderer, config, width, height, frames, at,
                     strict, label, card):
    """One moved run of phase 19b (see moved_render_phase); returns its
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    label = f"{label}, strict_capacity={strict}"
    r = Renderer(config, width, height, strict_capacity=strict, device="cuda")
    eager = Renderer(config, width, height, device="cuda")

    def eager_frame(i):
        at(i)
        eager._prepared_cache.clear()
        _, rasterize, runtime = eager._prepare(
            frames[i], uint8_kernel=True, graph=False)
        return rasterize(*runtime)

    acc = torch.zeros((), device="cuda")
    captures = []
    start = time.perf_counter()
    # Two passes before the timed windows: the first grows the
    # capacities (each growth drops every step) and warms up and
    # captures the keys it meets after its last growth; the second
    # captures the keys met before it.
    for i in list(range(n)) * 2:
        at(i)
        _, acc = r.render(frames[i], uint8_kernel=True, carry=acc)
        if "capture_ms" in r.timing:
            captures.append(r.timing["capture_ms"])
    float(acc)
    first_s = (time.perf_counter() - start) / 2
    start = time.perf_counter()
    want = [eager_frame(i) for i in range(n)]
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - start
    walls, split = [], {"call_ms": 0.0, "prepare_ms": 0.0, "bin_ms": 0.0}
    recaptured = [0] * MOVED_WINDOWS
    counted = []
    for window in range(MOVED_WINDOWS):
        held = []
        since, covers_since = raster_launches(), cover_bin_launches()
        start = time.perf_counter()
        for i in range(n):
            at(i)
            called = time.perf_counter()
            image, acc = r.render(frames[i], uint8_kernel=True, carry=acc)
            split["call_ms"] += (time.perf_counter() - called) * 1e3
            split["prepare_ms"] += r.timing["prepare_ms"]
            split["bin_ms"] += r.timing["bin_ms"]
            recaptured[window] += "capture_ms" in r.timing
            held.append(image)
        total = float(acc)
        walls.append(time.perf_counter() - start)
        launches = raster_launches() - since
        covers = cover_bin_launches() - covers_since
        counted.append((launches, covers))
        differ = [i for i in range(n) if not torch.equal(held[i], want[i])]
        # Each frame misses the cache (8 frames) and bins once, through
        # its key's step.
        if launches != n or covers != n or differ or not total > 0:
            fail(f"moved {label}: window {window + 1}: {launches} "
                 f"coverage_raster and {covers} cover_bins launches for "
                 f"{n} frames, frames {differ[:8]} differ from the eager "
                 f"frames, alpha sum {total}")
    kept = held
    frames_s = [n / w for w in walls]
    k = MOVED_WINDOWS * n
    print(f"moved {label} ({card}): {n} frames a window, frames/s "
          f"{', '.join(f'{f:.2f}' for f in frames_s)} (median "
          f"{statistics.median(frames_s):.2f}; "
          f"eager binning in this process {n / eager_s:.2f}, the two passes "
          f"{n / first_s:.2f} a pass); host a frame: render call "
          f"{split['call_ms'] / k:.3f} ms, of it _prepare "
          f"{split['prepare_ms'] / k:.3f} ms, of it the binning step's copies "
          f"in and replay {split['bin_ms'] / k:.3f} ms; captures in the two "
          f"passes {len(captures)} ({', '.join(f'{c:.1f}' for c in captures[:32])} "
          f"ms), in each window {recaptured}; (coverage_raster, cover_bins) "
          f"launches in each window {counted}; binning steps kept "
          f"{len(r._bin_steps)}, graph pool {graph_pool_mib(r._pool)}; every "
          f"window frame equal to the eager frame to the bit", flush=True)
    # A key met on one frame a pass captures on its second miss after
    # the last growth, which may fall in the first window.
    if any(recaptured[1:]):
        fail(f"moved {label}: the timed windows captured {recaptured} times")

    # Synchronising calls of a replayed miss.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(5):
                at(i % n)
                _, acc = r.render(frames[i % n], uint8_kernel=True, carry=acc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"moved {label}: {syncs} synchronising CUDA calls in 5 replayed "
          f"misses (torch.cuda.set_sync_debug_mode)", flush=True)
    if syncs != (5 if strict else 0):
        fail(f"moved {label}: {syncs} synchronising calls in 5 misses")

    # The device under torch.profiler.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(MOVED_PROFILED):
            at(i % n)
            _, acc = r.render(frames[i % n], uint8_kernel=True, carry=acc)
        float(acc)
        profiled = time.perf_counter() - start
    busy = device_busy(prof)
    if busy is None:
        print(f"moved {label}: device time not measured (the trace holds no "
              f"device events)", flush=True)
    else:
        b_us, r_us, o_us, count = busy
        m = MOVED_PROFILED
        print(f"moved {label} ({card}), torch.profiler over {m} frames: device "
              f"busy {b_us / m / 1e3:.3f} ms a frame, {b_us / (profiled * 1e6):.3f} "
              f"of the profiled window; coverage_raster {r_us / m / 1e3:.3f} ms a "
              f"frame; binning and the rest {o_us / m / 1e3:.3f} ms a frame, in "
              f"{count / m:.1f} device operations a frame", flush=True)

    # Frames against the same renderer's eager render, its steps cleared.
    for i in MOVED_CHECKED:
        if i >= n:
            continue
        r._drop_bin_steps()
        r._prepared_cache.clear()
        at(i)
        again = r.render(frames[i], uint8_kernel=True, to_host=False)
        if r._bin_steps and next(iter(r._bin_steps.values())).graph is not None:
            fail(f"moved {label}: frame {i} after clearing the steps replayed")
        if not torch.equal(again, kept[i]):
            fail(f"moved {label}: frame {i} differs from the same renderer's "
                 f"eager render with its steps cleared")
    print(f"moved {label}: frames {[i for i in MOVED_CHECKED if i < n]} equal "
          f"to the same renderer's eager render with its steps cleared",
          flush=True)
    return r


def moved_render_phase(coverage, api, scenes, showcase, card):
    """Phase 19b: moved frames through ``Renderer.render``, each a miss of
    its binning cache (``moved_frames``: the showcase orbit at 4K and
    1080p, config 2 and config 3 at 1080p), at strict_capacity True and
    False, packed RGBA8, chained through ``carry``: two passes (the
    capacities' growth, each key's warm-up and capture); the eager frames (binned outside every
    step) and their frames/s; MOVED_WINDOWS timed windows (frames/s, the
    host split a frame: the render call, ``_prepare``, the binning
    step's copies in and replay), every frame equal to the eager frame
    to the bit and one kernel launch each, no capture after the first
    window; the captures'
    ms, the steps kept and the graph pool's MiB; the synchronising calls
    of 5 replayed misses (none without strict_capacity, one each with
    it); MOVED_PROFILED frames under torch.profiler; frames
    MOVED_CHECKED against the same renderer with its steps cleared; and
    at 4K the copy that keeps a cache entry out of the graph's buffers
    against the copy of a frame."""
    for label, (config, w, h, frames, at) in moved_frames(
            api, scenes, showcase).items():
        for strict in (True, False):
            r = moved_render_run(coverage, api.Renderer, config, w, h, frames,
                                 at, strict, label, card)
        if w == SHOWCASE_W:
            prepared = next(iter(r._prepared_cache.values()))[0]
            mb, binning, frame_ms = copy_costs(coverage, prepared, w, h)
            print(f"moved {label} ({card}): keeping a replayed miss out of the "
                  f"graph's buffers: a clone of its binning ({mb:.1f} MB) "
                  f"{binning:.4f} ms on the device; a clone of the frame, which "
                  f"capturing the raster too would add, float "
                  f"{frame_ms['float']:.4f} ms, packed {frame_ms['packed']:.4f} "
                  f"ms", flush=True)
        del r


def frame_loop_phase(coverage, Renderer, card):
    """Phase 20: the orbit example's app through FrameLoop at 3840x2160
    for LOOP_FRAMES frames: a scripted drag (button down, 8 pointer
    moves, up) and a wheel event, 1920x1080 asked for after frame
    LOOP_RESIZE_AFTER, a PngSink every LOOP_PNG_EVERY frames.  The last
    frame at each size equals Renderer._quantize of the app's
    FrameProgram called outside the loop under the same camera and dash
    phase (the first frame of a program built after the resize may be
    under-populated until its deferred overflow counters are read,
    FrameProgram's contract); each of the drag's 10 frames whose binning
    did not overflow equals the eager sequential walk under its camera
    and descriptors, held after the loop so that the checks do not pace
    the drag; every PNG reads back as the frame presented; no frame is
    blank."""
    import tempfile

    import numpy as np
    import torch

    from contrast_renderer_tpu_torch.app import FrameLoop, PngSink
    from contrast_renderer_tpu_torch.examples.orbit_camera import ShowcaseOrbitApp
    from contrast_renderer_tpu_torch.utils.png import read_png
    from contrast_renderer_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    label = "frame loop"
    with tempfile.TemporaryDirectory() as out:
        png_sink = PngSink(out, every=LOOP_PNG_EVERY)
        presented = {}

        def sink(image, index):
            presented[index] = image
            png_sink(image, index)

        app = ShowcaseOrbitApp(with_text=True)
        start = time.perf_counter()
        loop = FrameLoop(app, SHOWCASE_W, SHOWCASE_H, sink=sink)
        print(f"{label}: FrameLoop on {loop.renderer.device}, the orbit app "
              f"created at {SHOWCASE_W}x{SHOWCASE_H} in "
              f"{time.perf_counter() - start:.2f} s", flush=True)
        if loop.renderer.device.type != "cuda":
            fail(f"{label}: the loop's renderer is on {loop.renderer.device}")
        seconds, captured, dragged = {}, {}, []
        since, covers_since = raster_launches(), cover_bin_launches()
        for index in range(LOOP_FRAMES):
            if index == 0:
                loop.send_button(True)
                loop.send_pointer(0.0, 0.0)
            elif index <= 8:
                loop.send_pointer(40.0 * index, 6.0 * index)
            elif index == 9:
                loop.send_button(False)
            elif index == 10:
                loop.send_wheel(-2.0)
            image = loop.step()
            size = (loop.renderer.width, loop.renderer.height)
            seconds.setdefault(size, []).append(loop.timer.last_s)
            captured.setdefault(size, []).append(
                app._program.stats.get("capture_ms"))
            if index < 10:
                # The drag: what each frame needs to be held against the
                # eager sequential walk after the loop (its camera, its
                # descriptors with the dash phase, its overflow counters
                # and the capacities it ran at).
                program = app._program
                dragged.append((
                    image, program, app.transforms(loop.renderer),
                    program._descriptors(), program._pending[-1][:2],
                    [program._caps[k] for k in ("capacity", "global_capacity",
                                                "tile_global_capacity",
                                                "clip_pool")],
                ))
            if index in (LOOP_RESIZE_AFTER, LOOP_FRAMES - 1):
                # The app's program outside the loop, same camera and
                # dash phase (set on the shape by the frame's render).
                want = Renderer._quantize(app._program(app.transforms(loop.renderer)))
                differ = int((torch.from_numpy(image) != want.cpu()).any(-1).sum())
                print(f"{label}: frame {index} at {size[0]}x{size[1]} vs the "
                      f"app's compile_frame program called outside the loop, "
                      f"RGBA8: {differ} pixels differ", flush=True)
                if differ:
                    fail(f"{label}: frame {index} differs from its direct render")
            if not (image[..., 3] > 0).any():
                fail(f"{label}: frame {index} is blank")
            if index == LOOP_RESIZE_AFTER:
                print(f"{label} ({card}): FrameTimer after {index + 1} "
                      f"frames at {size[0]}x{size[1]}: fps {loop.timer.fps:.2f}, "
                      f"average_s {loop.timer.average_s:.5f}", flush=True)
                loop.request_resize(WIDTH, HEIGHT)
        launches = raster_launches() - since
        covers = cover_bin_launches() - covers_since
        print(f"{label} ({card}): FrameTimer after {LOOP_FRAMES} frames: "
              f"fps {loop.timer.fps:.2f}, average_s {loop.timer.average_s:.5f}; "
              + "; ".join(
                  f"{w}x{h}: {len(v)} frames, median {statistics.median(v) * 1e3:.2f} "
                  f"ms a frame (render, quantize and fetch)"
                  for (w, h), v in seconds.items())
              + f"; {launches} coverage_raster launches, {covers} cover_bins "
              f"launches; builds of the "
              f"{WIDTH}x{HEIGHT} program {app._program.builds}", flush=True)
        overflowed = []
        for index, (image, program, t, desc, (host, event), caps) in enumerate(
                dragged):
            event.synchronize()
            if any(int(c) > cap for c, cap in zip(host.tolist(), caps)):
                overflowed.append(index)
                continue
            want = Renderer._quantize(
                eager_sequential(program, t, desc)).cpu().numpy()
            if not np.array_equal(image, want):
                fail(f"{label}: drag frame {index} differs from the eager "
                     f"sequential walk")
        del dragged
        drag = seconds[(SHOWCASE_W, SHOWCASE_H)][:10]
        longest = max(range(10), key=drag.__getitem__)
        print(f"{label} ({card}) {SHOWCASE_W}x{SHOWCASE_H}: the drag's 10 frames "
              f"(host ms, render, quantize and fetch) "
              f"{', '.join(f'{t * 1e3:.1f}' for t in drag)}: {sum(drag) * 1e3:.1f} "
              f"ms in all, the longest {drag[longest] * 1e3:.1f} ms (frame "
              f"{longest}); {len(overflowed)} overflowed their capacities "
              f"(deferred growth: {overflowed}), the other "
              f"{10 - len(overflowed)} equal to the eager sequential walk",
              flush=True)
        for (w, h), v in seconds.items():
            caps = captured[(w, h)]
            other = [t for t, c in zip(v, caps) if c is None]
            print(f"{label} ({card}) {w}x{h}: {sum(c is not None for c in caps)} "
                  f"of {len(v)} frames captured a variant's graph (host ms "
                  f"{', '.join(f'{c:.1f}' for c in caps if c is not None)}); the "
                  f"others' median "
                  f"{statistics.median(other) * 1e3 if other else float('nan'):.2f} "
                  f"ms a frame", flush=True)
        if launches < LOOP_FRAMES:
            fail(f"{label}: {launches} coverage_raster launches for "
                 f"{LOOP_FRAMES} frames")
        if (WIDTH, HEIGHT) not in seconds:
            fail(f"{label}: the resize did not take effect")
        written = sorted(os.listdir(out))
        for name in written:
            index = int(name[len("frame_"):-len(".png")])
            if not np.array_equal(read_png(os.path.join(out, name)), presented[index]):
                fail(f"{label}: {name} does not read back as the frame presented")
        print(f"{label}: {len(written)} PNGs ({', '.join(written)}) read back "
              f"equal to the frames presented", flush=True)
        if len(written) != -(-LOOP_FRAMES // LOOP_PNG_EVERY):
            fail(f"{label}: {len(written)} PNGs written")
        # One more frame under utils.profiling.device_trace.
        loop.sink = None
        trace_dir = os.path.join(out, "trace")
        with device_trace(trace_dir) as prof:
            loop.step()
        raster_us = sum(e.device_time_total for e in prof.key_averages()
                        if "coverage_raster" in e.key)
        trace_bytes = os.path.getsize(os.path.join(trace_dir, TRACE_FILE))
        print(f"{label}: device_trace of one {WIDTH}x{HEIGHT} frame: a Chrome "
              f"trace of {trace_bytes} bytes; coverage_raster device time "
              f"{raster_us / 1e3:.3f} ms in it", flush=True)
        if not raster_us > 0:
            fail(f"{label}: device_trace holds no coverage_raster device time")


def fill_raster_phase(scenes, card):
    """Phase 21: ops/raster.py's make_fill_rasterizer on the card.
    BASELINE config 1 (the circle at 256², radius 90) against the port's
    scalar oracle: error 0.0.  Config 2's fill table (one FillBuilder over
    its 1,000 Bézier paths) at 1920x1080: times (CUDA events), max_count,
    the tile chunk and the peak memory at the default capacity; a run at
    a capacity below max_count reports the overflow; and the winding on
    the card equals the same function on the CPU to the bit, both at the
    capacity max_count (a host refitting its capacity to max_count, as
    the overflow report invites; at 256 slots the CPU would take minutes
    for slots that hold nothing)."""
    import numpy as np
    import torch

    from contrast_renderer_tpu_torch import oracle
    from contrast_renderer_tpu_torch.fill import FillBuilder
    from contrast_renderer_tpu_torch.ops import raster

    def table_of(paths):
        builder = FillBuilder()
        for p in paths:
            builder.add_path([], p)
        return builder.build()

    def args_of(table, width, height):
        return (table.xy, table.aux, table.kind, table.meta,
                scenes.ortho(width, height))

    size = CIRCLE_SIZE
    circle = table_of([scenes.Path.from_circle((128, 128), 90)])
    winding, max_count = raster.make_fill_rasterizer(size, size)(
        *args_of(circle, size, size))
    err = float(np.mean(winding.cpu().numpy()
                        != oracle.rasterize_fill_table(circle, size, size)))
    print(f"fill raster: config 1 circle {size}² on {winding.device}: error vs "
          f"the oracle {err} (fraction of samples), max_count {int(max_count)}",
          flush=True)
    if winding.device.type != "cuda" or err != 0.0:
        fail("fill raster: config 1 is not exact on the card")

    start = time.perf_counter()
    table = table_of(scenes.bezier_fill_paths(1000, WIDTH, HEIGHT, seed=0))
    build_s = time.perf_counter() - start
    args = args_of(table, WIDTH, HEIGHT)
    # The table on the card once, as a caller that keeps it there would.
    on_card = tuple(torch.as_tensor(np.asarray(a), device="cuda") for a in args)
    rasterize = raster.make_fill_rasterizer(WIDTH, HEIGHT)
    rasterize(*on_card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    winding, max_count = rasterize(*on_card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    fit = int(max_count)
    triangles = len(table.kind)
    capacity = min(256, triangles)
    med, lo, hi = cuda_ms(lambda: rasterize(*on_card), 5, 3, 2)
    print(f"fill raster ({card}): config 2 table ({triangles} triangles, built in "
          f"{build_s:.2f} s) at {WIDTH}x{HEIGHT}, capacity {capacity}: "
          f"max_count {fit}, tile chunk {raster.tile_chunk(32, 4, capacity)} of "
          f"{-(-WIDTH // 32) * -(-HEIGHT // 32)} tiles; median {med:.3f} ms "
          f"[{lo:.3f}, {hi:.3f}] a call (CUDA events, 5 batches of 3, the table "
          f"on the card); peak device memory over a call "
          f"{peak / 2**20:.1f} MiB", flush=True)
    low = max(1, fit // 2)
    _, over = raster.make_fill_rasterizer(WIDTH, HEIGHT, capacity=low)(*args)
    print(f"fill raster: config 2 at capacity {low}: max_count {int(over)} "
          f"reports the overflow {int(over) > low}", flush=True)
    if not int(over) > low:
        fail("fill raster: a capacity below max_count did not report the overflow")
    got, got_max = raster.make_fill_rasterizer(WIDTH, HEIGHT, capacity=fit)(*args)
    start = time.perf_counter()
    want, want_max = raster.make_fill_rasterizer(
        WIDTH, HEIGHT, capacity=fit, device="cpu")(*args)
    cpu_s = time.perf_counter() - start
    equal = bool(torch.equal(got.cpu(), want)) and int(got_max) == int(want_max)
    same_default = bool(torch.equal(got, winding))
    print(f"fill raster: config 2 at capacity {fit}: card vs CPU winding equal "
          f"to the bit {equal} (CPU {cpu_s:.1f} s on "
          f"{torch.get_num_threads()} threads); card at capacity {fit} vs "
          f"{capacity}: equal {same_default}; covered samples "
          f"{int((want != 0).sum())}", flush=True)
    if not equal or (fit <= capacity and not same_default) or not (want != 0).any():
        fail("fill raster: config 2's winding on the card differs from the CPU's")


def sharded_phase(coverage, showcase, Configuration, Renderer, card):
    """Phase 22: the showcase with text at 3840x2160 over a Mesh of
    SHARD_BANDS row bands, cuda:{i % n} for the n cards visible (one
    card: the same card four times).  render_sharded of the showcase (92
    commands) and of its clip/alpha variant, and render_sharded_2d on a
    2x2 mesh, against the single-device render: mean |Δ| <
    SHARD_MEAN_ABS; ShardedFrameProgram on SHARD_FRAMES orbit frames
    against render_sharded of the same transforms (atol
    SHARD_PROGRAM_ATOL), its uint8_output twin against it in RGBA8, the
    time a frame (host clock, synchronised); each band's kernel time
    (CUDA events) and the bound of the slowest band, whose kernel is held
    against plain.  Returns the slowest band's (spec, runtime, launches,
    max_abs_err, kernel ms, plain ms, bound)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from contrast_renderer_tpu_torch.parallel import (
        Mesh, ShardedFrameProgram, ShardedFrameProgram2D, render_sharded,
        render_sharded_2d,
    )
    from contrast_renderer_tpu_torch.parallel import mesh as mesh_module

    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i % n_cards}" for i in range(SHARD_BANDS)]
    mesh = Mesh(devices, ("y",))
    grid = Mesh(np.array(devices).reshape(2, 2), ("y", "x"))
    print(f"sharded: {n_cards} CUDA device(s) visible; band mesh {devices}, "
          f"2x2 mesh {grid.devices.tolist()}", flush=True)
    shape = showcase.build_shape(with_text=True)
    variants = {
        "showcase": (Configuration(),
                     showcase.showcase_commands(shape, SHOWCASE_W, SHOWCASE_H)),
        "showcase clip/alpha": (
            Configuration(alpha_layer_count=1, blending="front_to_back"),
            showcase.showcase_commands_clip_alpha(shape, SHOWCASE_W, SHOWCASE_H),
        ),
    }
    launches = None
    for label, (config, cmds) in variants.items():
        single = Renderer(config, SHOWCASE_W, SHOWCASE_H).render(cmds, to_host=False)
        runs = [("render_sharded, 4 bands", render_sharded, mesh)]
        if label == "showcase":
            runs.append(("render_sharded_2d, 2x2", render_sharded_2d, grid))
        for name, fn, where in runs:
            since = raster_launches()
            start = time.perf_counter()
            sharded = fn(Renderer(config, SHOWCASE_W, SHOWCASE_H), cmds, where)
            seconds = time.perf_counter() - start
            count = raster_launches() - since
            if launches is None:
                launches = count
            got = torch.from_numpy(sharded).to(single.device)
            mean = float((got - single).abs().mean())
            differ = float((Renderer._quantize(got) != Renderer._quantize(single))
                           .any(-1).double().mean())
            print(f"sharded {label}, {name}: {count} coverage_raster launches, "
                  f"{seconds:.2f} s with packing; vs the single-device render: "
                  f"mean |d| {mean:.3g}, RGBA8 pixels that differ {differ:.3g}",
                  flush=True)
            if count < len(where.devices.reshape(-1)) or not mean < SHARD_MEAN_ABS:
                fail(f"sharded {label}, {name}: {count} launches, mean |d| {mean}")

    # ShardedFrameProgram on orbit frames, against render_sharded.
    config, cmds = variants["showcase"]
    start = time.perf_counter()
    program = ShardedFrameProgram(Renderer(config, SHOWCASE_W, SHOWCASE_H), cmds, mesh)
    packed = ShardedFrameProgram(Renderer(config, SHOWCASE_W, SHOWCASE_H), cmds,
                                 mesh, uint8_output=True)
    torch.cuda.synchronize()
    print(f"sharded program: two programs (float, packed RGBA8) built in "
          f"{time.perf_counter() - start:.2f} s; band capacities "
          f"{program._limits}", flush=True)
    stacks = [showcase.orbit_transforms(i, SHOWCASE_W, SHOWCASE_H)
              for i in range(SHARD_FRAMES)]
    # One pass over the motion first: a frame that outgrows the settled
    # capacities renders under-populated until its deferred counters are
    # read (at most OVERFLOW_MAX_LAG frames), as FrameProgram's do.
    limits = (program._limits, packed._limits)
    for t in stacks:
        program(t)
        packed(t)
    torch.cuda.synchronize()
    print(f"sharded program: band capacities over a first pass of the "
          f"{SHARD_FRAMES} frames {limits[0]} -> {program._limits} (float), "
          f"{limits[1]} -> {packed._limits} (packed)", flush=True)
    worst, rgba_differ = 0.0, 0
    for t in stacks:
        got = program(t)
        want = render_sharded(Renderer(config, SHOWCASE_W, SHOWCASE_H),
                              [replace(c, transform=row) for c, row in zip(cmds, t)],
                              mesh)
        worst = max(worst, float((got.cpu() - torch.from_numpy(want)).abs().max()))
        rgba_differ += int((packed(t) != Renderer._quantize(got)).any(-1).sum())
    print(f"sharded program: {SHARD_FRAMES} orbit frames vs render_sharded of the "
          f"same transforms: max |d| {worst:.3g}; packed RGBA8 program vs the "
          f"float program quantized: {rgba_differ} pixels differ", flush=True)
    if not worst <= SHARD_PROGRAM_ATOL or rgba_differ:
        fail("sharded program: frames differ from render_sharded or in RGBA8")
    times = []
    for t in stacks * 2:
        start = time.perf_counter()
        program(t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    print(f"sharded program ({card}): {len(times)} orbit frames at "
          f"{SHOWCASE_W}x{SHOWCASE_H} over {SHARD_BANDS} bands: median "
          f"{statistics.median(times):.2f} ms a frame [{min(times):.2f}, "
          f"{max(times):.2f}] (host clock, synchronised each frame)", flush=True)

    # The band program and a 2x2 program through their per-rect steps.
    sharded_graph_run(mesh_module, program, stacks, "4 bands, float", card)
    sharded_graph_run(
        mesh_module,
        ShardedFrameProgram2D(Renderer(config, SHOWCASE_W, SHOWCASE_H), cmds,
                              grid),
        stacks, "2x2, float", card)

    # Each band's kernel on the program's own binning of frame 0.
    pipeline, bands = program._pipeline, program._grid
    band_ms, band_runtime = [], []
    for b, device in enumerate(bands.devices):
        adjusted = torch.as_tensor(bands.adjust(program._default_transform, b),
                                   device=device)
        runtime = pipeline.runtime(device, adjusted)
        args = raster_args(coverage, pipeline.spec, runtime)
        with torch.cuda.device(device):
            band_ms.append(cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3))
        band_runtime.append(runtime)
    slowest = max(range(len(band_ms)), key=lambda b: band_ms[b][0])
    spec, runtime = pipeline.spec, band_runtime[slowest]
    err = kernel_vs_plain(coverage, spec, runtime, f"sharded band {slowest}")
    args = raster_args(coverage, spec, runtime)
    p_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 1, 1, 0)[0]
    work = {}
    bound = kernel_bound(coverage, spec, runtime, work)
    print(f"timing sharded bands ({card}): coverage_raster per band "
          + ", ".join(f"{b}: {m[0]:.3f} ms [{m[1]:.3f}, {m[2]:.3f}]"
                      for b, m in enumerate(band_ms))
          + f"; sum {sum(m[0] for m in band_ms):.3f} ms; slowest band {slowest}: "
          f"rasterize_plain {p_ms:.3f} ms, kernel_bound {bound[0]:.4f} ms "
          f"({bound[1]}: {bound[2] / 1e6:.1f} MB, {bound[3] / 1e9:.2f} GFLOP); "
          f"band spec tile {spec.tile_h}x{spec.tile_w} strips {spec.tile_strips}, "
          f"{spec.n_tiles} tiles, {spec.n_commands} commands walked", flush=True)
    return spec, runtime, launches, err, band_ms[slowest][0], p_ms, bound


def sharded_graph_run(mesh_module, program, stacks, label, card):
    """Phase 22's sharded program through its per-rect steps (each rect's
    warm-up, capture and replays): passes over ``stacks`` until one
    neither rebuilds nor captures (the captures, per rect), then two
    timed passes: the
    frame's host ms (no synchronise) and its time synchronised, each
    rect's copies in and replay, every frame equal to the eager sharded
    frame of the same transforms (``mesh._run_grid``) to the bit; the
    graph pool's MiB per device."""
    import torch

    captures = {}
    builds = program._limits
    # Passes until one neither rebuilds (a deferred growth drops every
    # step) nor captures: then every rect's step is captured.
    for _ in range(4):
        limits, captured = program._limits, False
        for stack in stacks:
            program(stack)
            for cell, ms in enumerate(program.stats["capture_ms"]):
                if ms is not None:
                    captures.setdefault(cell, []).append(ms)
                    captured = True
        if not captured and program._limits == limits:
            break
    torch.cuda.synchronize()
    host, synced, rects = [], [], []
    since, covers_since = raster_launches(), cover_bin_launches()
    for stack in stacks * 2:
        start = time.perf_counter()
        program(stack)
        host.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - start) * 1e3)
        rects.append(program.stats["rect_ms"])
        if any(c is not None for c in program.stats["capture_ms"]):
            fail(f"sharded graph {label}: a timed frame captured")
    # Each rect's step replays one binning and one raster a frame.
    launches = raster_launches() - since
    covers = cover_bin_launches() - covers_since
    expected = len(stacks) * 2 * len(program._steps)
    per_step = {cell: s.replay_launches for cell, s in program._steps.items()}
    if launches != expected or covers != expected or any(
            r != {"raster_launches": 1, "cover_bin_launches": 1}
            for r in per_step.values()):
        fail(f"sharded graph {label}: {launches} coverage_raster and {covers} "
             f"cover_bins launches over {len(host)} frames of "
             f"{len(program._steps)} rects; each rect's step a replay "
             f"{per_step}")
    differ = 0
    for stack in stacks:
        got = program(stack)
        want, _ = mesh_module._run_grid(program._pipeline, program._grid,
                                        program._rows(stack))
        differ += not torch.equal(got, want)
    pools = {str(d): graph_pool_mib(p) for d, p in program._pools.items()}
    per_rect = [statistics.median(r[c] for r in rects)
                for c in range(len(rects[0]))]
    print(f"sharded graph {label} ({card}): {len(host)} frames: host "
          f"{statistics.median(host):.3f} ms a frame [{min(host):.3f}, "
          f"{max(host):.3f}], synchronised {statistics.median(synced):.3f} ms "
          f"[{min(synced):.3f}, {max(synced):.3f}]; each rect's copies in and "
          f"replay (median) {', '.join(f'{m:.3f}' for m in per_rect)} ms; "
          f"captures per rect (ms) "
          f"{ {c: [round(m, 1) for m in ms] for c, ms in captures.items()} }; "
          f"{launches} coverage_raster and {covers} cover_bins launches; "
          f"capacities {builds} -> {program._limits}; graph pool {pools}; "
          f"frames that differ from the eager sharded frame {differ} of "
          f"{len(stacks)}", flush=True)
    if differ or not all(s.graph is not None for s in program._steps.values()):
        fail(f"sharded graph {label}: frames differ from the eager sharded "
             f"frame, or a rect's step was not captured")


def viewer_phase(card):
    """Phase 23: the viewer example's ShowcaseSession at 1920x1080 on the
    card, served on 127.0.0.1 (a free port); the page and VIEWER_FRAMES
    frames fetched over HTTP, each W·H·4 bytes and not blank."""
    import threading
    import urllib.request

    import numpy as np

    from contrast_renderer_tpu_torch.examples import viewer_server

    start = time.perf_counter()
    session = viewer_server.ShowcaseSession(WIDTH, HEIGHT)
    ready_s = time.perf_counter() - start
    server = viewer_server.make_server(session, port=0)
    host, port = server.server_address[:2]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://{host}:{port}"
        page = urllib.request.urlopen(base + "/", timeout=60).read().decode()
        if "<canvas" not in page:
            fail("viewer: the page has no canvas")
        seconds = []
        for i in range(VIEWER_FRAMES):
            begin = time.perf_counter()
            raw = urllib.request.urlopen(
                f"{base}/frame?yaw={0.4 * i}&pitch=0.1&dist=5&t={0.5 * i}",
                timeout=120).read()
            seconds.append(time.perf_counter() - begin)
            if len(raw) != WIDTH * HEIGHT * 4:
                fail(f"viewer: frame {i} is {len(raw)} bytes")
            frame = np.frombuffer(raw, np.uint8).reshape(HEIGHT, WIDTH, 4)
            if not (frame[..., :3] < 250).any():
                fail(f"viewer: frame {i} is blank")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"viewer: session ready in {ready_s:.2f} s (plan_for_motion over 16 yaw "
          f"samples); served on {host}:{port}; page and {VIEWER_FRAMES} frames of "
          f"{WIDTH}x{HEIGHT}x4 bytes fetched, round trips "
          f"{', '.join(f'{s * 1e3:.1f}' for s in seconds)} ms ({card})",
          flush=True)
    if host != "127.0.0.1":
        fail(f"viewer: bound {host}")


def examples_phase(Renderer, card_image):
    """Phase 24: render_showcase for 4 frames at 1920x1080 and gradients
    at 3840x2160, on the card, into a temporary directory; the gradient
    PNG decoded against phase 12's gradient card composited over white
    and quantized."""
    import tempfile

    import numpy as np
    import torch

    from contrast_renderer_tpu_torch.examples import gradients, render_showcase
    from contrast_renderer_tpu_torch.utils.png import read_png

    with tempfile.TemporaryDirectory() as out:
        frames_dir = os.path.join(out, "frames")
        start = time.perf_counter()
        render_showcase.main(["--size", f"{WIDTH}x{HEIGHT}", "--frames", "4",
                              "--out", frames_dir])
        showcase_s = time.perf_counter() - start
        written = sorted(os.listdir(frames_dir))
        for name in written:
            image = read_png(os.path.join(frames_dir, name))
            if image.shape != (HEIGHT, WIDTH, 4) or not (image[..., 3] > 0).any():
                fail(f"examples: render_showcase wrote a blank or misshapen {name}")
        if len(written) != 4:
            fail(f"examples: render_showcase wrote {written}")
        card_png = os.path.join(out, "gradients.png")
        start = time.perf_counter()
        gradients.main(["--size", f"{SHOWCASE_W}x{SHOWCASE_H}", "--out", card_png])
        gradients_s = time.perf_counter() - start
        got = read_png(card_png)
    white = torch.ones(4, device=card_image.device)
    want = Renderer._composite_quantize(card_image, white).cpu().numpy()
    differ = int((got != want).any(-1).sum())
    print(f"examples: render_showcase wrote {len(written)} PNGs at "
          f"{WIDTH}x{HEIGHT} in {showcase_s:.2f} s; gradients at "
          f"{SHOWCASE_W}x{SHOWCASE_H} in {gradients_s:.2f} s (with its PNG); its "
          f"PNG vs the gradient-card phase's image over white, RGBA8: {differ} "
          f"pixels differ", flush=True)
    if got.shape != want.shape or differ:
        fail("examples: the gradients PNG differs from the gradient card phase")


if __name__ == "__main__":
    main()
