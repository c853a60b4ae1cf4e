#!/usr/bin/env python3
"""Interleaved A/B of the coverage kernel between checkouts of this
repository, on one CUDA device.

    python3 chip_ab.py ROOT_A ROOT_B [ROOT_C ...]

Fresh processes, each root three times in the order A, B, B, A, A, B
(with more roots, the roots in order, reversed, then in order again),
each import ``contrast_renderer_tpu_torch`` from their root (its kernels
built from that root's sources into its own ``build/``), bin
chip_smoke.py's eight 4× MSAA frames on the card, config 3 at 8× MSAA,
config 2 under LessEqual with depth write (the depth build without
strokes) and orbit frame 30 at 3840x2160 as a planned program bins it
(``chip_smoke.orbit_frame``), and time each: the
kernel (``coverage_raster``, median of 5 batches of 10 launches, with
the batches' least and greatest; CUDA events, chip_smoke.py's
``cuda_ms``) and the frame with cached binning (``Renderer.render``,
median of 10 frames; none for the orbit frame), and, for the 4K
showcase, the device operations of
one cached frame under torch.profiler (whether a de-tiling copy follows
the kernel). Each process also hashes each frame's packed RGBA8 kernel
output as an (H, W) frame (a root whose kernel writes tiles has them
de-tiled here), so that the roots' images are compared bit for bit. A
process that built the kernels prints ptxas' registers and spills. The
last lines are one row per frame (each root's kernel medians, least and
greatest over its processes, whether the images are equal) and one JSON
object with all of it. Exits non-zero if a process fails, no CUDA device
is visible, or the roots' images differ.

The frames use only what both roots offer: ``Renderer`` with an
explicit device, ``Renderer._prepare``, ``coverage.coverage_raster``,
``coverage.draw_tables``, ``coverage.build_kernels`` and the scene
builders of ``scenes`` and ``models.showcase``.  A root whose ``scenes``
has ``config4_text`` also renders config 4's fused form; a frame that
only one root renders is timed but not compared.  Each frame prints the
commands its root walks (after auto-instancing, where the root has it).
Imports nothing of JAX.

    python3 chip_ab.py --orbit ROOT_A ROOT_B [ROOT_C ...]

The moving camera instead, in processes of the same order: the showcase
orbit of chip_smoke.py's phase 19 (the showcase with text,
``showcase.orbit_transforms``, the dash phase 0.032 a frame, packed
RGBA8) through ``Renderer.compile_frame`` and ``plan_for_motion`` at
3840x2160 and 1920x1080: three windows of 99 frames chained through
``carry`` (host clock, one fetch at the end of each), the host split of
``FrameProgram.stats`` a frame, the capture ms where the root captures
its frame steps, 33 frames under torch.profiler (the device's busy share
and operations a frame), the peak device memory over the windows, and
the packed frames 0, 30 and 98 hashed for the comparison; the time of
``plan_for_motion`` over the 99 frames at each size; the orbit at
3840x2160 through a program that never planned (frames/s, frames fused,
frames that captured a graph, the longest frame's host ms, frames 0, 30
and 98 hashed); then the orbit
example's app through ``app.FrameLoop`` at 3840x2160, 24 frames under
chip_smoke.py phase 20's drag and wheel (the median of the last 20, of
all, the drag's 10 frames in all and each, its longest, the frames that
captured a graph).  The last lines are one row per size and one
JSON object.  Exits non-zero if a process fails or the roots' orbit
frames differ, but for frames that cross the near plane (their
crossings counted by the sequential walk's binning): those may differ,
and the pixels that do are counted and printed.

    python3 chip_ab.py --moved ROOT_A ROOT_B [ROOT_C ...]

Moved frames through ``Renderer.render`` instead, in processes of the
same order: chip_smoke.py phase 19b's frames (``moved_frames``: the
showcase orbit at 3840x2160 and 1920x1080, config 2 and config 3 at
1920x1080 under a drifting camera), each a miss of the binning cache, at
``strict_capacity`` True and False, packed RGBA8: two passes, then
three windows of 99 frames chained through ``carry`` (frames/s; the host
ms of the render call a frame, and of ``_prepare`` where the root
records it), frames 0, 30 and 98 of the last window hashed; then
``ShardedFrameProgram`` over 4 row bands and ``ShardedFrameProgram2D``
over 2x2 at 3840x2160 on chip_smoke.py phase 22's 8 orbit frames (a
first pass, then the median of 16 frames synchronised each; frame 0
hashed).  The last lines are one row per frame and one JSON object.
Exits non-zero if a process fails or the roots' frames differ, but for
frames that cross the near plane (counted as in --orbit).

In both modes a hashed frame that crosses the near plane is also kept
as a .npy file under .checkouts/ab_frames/ (gitignored) for the count.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))
LETTERS = "ABCDEFGH"


def order(n):
    """The processes' order over n roots: ABBAAB for two; the roots in
    order, reversed, then in order again for more."""
    roots = LETTERS[:n]
    return "ABBAAB" if n == 2 else roots + roots[::-1] + roots


def fail(message):
    print(f"chip_ab: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def chip_smoke():
    """chip_smoke.py beside this script (not a root's copy)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: Where the workers keep their hashed frames that cross the near plane,
#: one folder per root, for the summary's count of the pixels that differ.
FRAMES_DIR = os.path.join(HERE, ".checkouts", "ab_frames")


def frame_path(root, label, index):
    folder = os.path.join(FRAMES_DIR,
                          hashlib.sha256(root.encode()).hexdigest()[:12])
    os.makedirs(folder, exist_ok=True)
    name = "".join(c if c.isalnum() else "_" for c in label)
    return os.path.join(folder, f"{name}_{index}.npy")


def keep_frames(root, label, result):
    """Save the result's crossing frames (``result.pop("images")``) for
    the summary; what stays in ``result`` is JSON."""
    import numpy as np

    images = result.pop("images")
    for index, crossings, image in zip(result["indices"], result["crossings"],
                                       images):
        if crossings:
            np.save(frame_path(root, label, index), image.cpu().numpy())


def sequential_crossings(program, transforms):
    """Near-plane crossings that a FrameProgram's sequential walk bins for
    ``transforms`` (its own prepare, outside every graph)."""
    import torch

    seq, device = program._seq, program._renderer.device
    d = program._descriptors()
    prepared = seq.prepare(
        *program._scene.arrays,
        torch.as_tensor(program._opt_rows(transforms), device=device),
        torch.as_tensor(d["static"], device=device), seq.paints,
    )
    return int(prepared.overflow[3])


def compare_frames(roots, runs, label):
    """Whether the roots' hashed frames of ``label`` agree as they must:
    each root's processes alike, and across roots every frame that
    crosses no near plane equal to the bit.  Returns (agree, text), the
    text naming each frame's crossings and, where a crossing frame
    differs from root A's, the pixels that differ."""
    import numpy as np

    first = {}
    for letter in roots:
        hashes = {tuple(r[label]["rgba8"]) for r in runs[letter]}
        if len(hashes) != 1:
            return False, f"{letter}'s processes differ"
        first[letter] = runs[letter][0][label]
    a = first["A"]
    agree, notes = True, []
    indices = a.get("indices", list(range(len(a["rgba8"]))))
    for k, index in enumerate(indices):
        crossings = [first[letter].get("crossings", [0] * len(indices))[k]
                     for letter in roots]
        differ = []
        for letter in list(roots)[1:]:
            if first[letter]["rgba8"][k] == a["rgba8"][k]:
                continue
            if not all(crossings):
                agree = False
                differ.append(f"{letter} differs")
                continue
            want = np.load(frame_path(os.path.abspath(roots["A"]), label,
                                      index))
            got = np.load(frame_path(os.path.abspath(roots[letter]), label,
                                     index))
            unlike = got != want
            if unlike.ndim == 3:
                unlike = unlike.any(-1)
            differ.append(f"{letter} {int(unlike.sum())} of {unlike.size} "
                          f"pixels unlike A")
        notes.append(f"frame {index} ({'/'.join(map(str, crossings))} "
                     f"crossings): {', '.join(differ) or 'equal'}")
    return agree, "; ".join(notes)


def frames(api, scenes, showcase, smoke):
    """chip_smoke.py's frames: {label: (configuration, width, height,
    commands)}; config 3 at dash phase 0."""
    w, h = smoke.WIDTH, smoke.HEIGHT
    sw, sh = smoke.SHOWCASE_W, smoke.SHOWCASE_H
    op, cfg = api.RenderOperation, api.Configuration
    t = scenes.ortho(w, h)
    fills = api.Shape(scenes.bezier_fill_paths(1000, w, h, seed=0))
    dashed = api.Shape(*scenes.dashed_strokes(w, h, seed=1))
    shape = showcase.build_shape(with_text=True)
    show = showcase.showcase_commands(shape, sw, sh)
    depth = cfg(depth_compare="less_equal", depth_write_enabled=True)
    out = {
        "config 2": (cfg(), w, h, [
            api.DrawCommand(op.STENCIL, fills, t),
            api.DrawCommand(op.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)),
        ]),
        "config 3": (cfg(), w, h, [
            api.DrawCommand(op.STENCIL, dashed, t),
            api.DrawCommand(op.COLOR, dashed, t, color=(1, 1, 1, 1)),
        ]),
        "showcase": (cfg(), sw, sh, show),
        "showcase clip/alpha": (
            cfg(alpha_layer_count=1, blending="front_to_back"), sw, sh,
            showcase.showcase_commands_clip_alpha(shape, sw, sh),
        ),
        "showcase clip/alpha L=2": (
            cfg(alpha_layer_count=2, blending="front_to_back"), sw, sh,
            showcase.showcase_commands_clip_alpha(shape, sw, sh),
        ),
        "showcase + depth": (depth, sw, sh, show),
        "gradient card": (cfg(), sw, sh, scenes.gradient_card(sw, sh)[0]),
        "mixed paints": (depth, w, h, scenes.mixed_paints(w, h)),
        # The builds whose register counts move the most: strokes at 8x
        # MSAA, and depth without strokes.
        "config 3 S=8": (cfg(msaa_sample_count=8), w, h, [
            api.DrawCommand(op.STENCIL, dashed, t),
            api.DrawCommand(op.COLOR, dashed, t, color=(1, 1, 1, 1)),
        ]),
        "config 2 + depth": (depth, w, h, [
            api.DrawCommand(op.STENCIL, fills, t),
            api.DrawCommand(op.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)),
        ]),
    }
    if hasattr(scenes, "config4_text"):
        out["config 4 fused"] = (cfg(), w, h, scenes.config4_text("fused"))
    return out


def packed_frame(spec, out):
    """The packed RGBA8 frame (H, W) of a kernel output: as it is, or
    de-tiled from the (n_tiles, th, tw) tiles of a root whose kernel
    writes tiles (lane l of a tile's row r is screen pixel ((l // lw)·th
    + r, l % lw) of its footprint)."""
    if out.dim() == 2:
        return out
    nty, ntx = spec.nty, spec.ntx
    th, strips, lw = spec.tile_h, spec.tile_strips, spec.screen_tile_w
    image = out.reshape(nty, ntx, th, strips, lw).permute(0, 3, 2, 1, 4)
    image = image.reshape(nty * spec.screen_tile_h, ntx * lw)
    return image[:spec.height, :spec.width].contiguous()


def cached_ops(renderer, commands):
    """The device operations, in order, of one frame of ``renderer``
    with binning cached, under torch.profiler after a marker operation
    (a one-element fill, listed first): [(name, µs)].  The worker's only
    profiler session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    renderer.render(commands, to_host=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        renderer.render(commands, to_host=False)
        torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    return [(e.name[:60], e.time_range.end - e.time_range.start) for e in events]


def worker(root):
    """Time the frames with the port of ``root``; prints one line
    ``AB {json}``."""
    root = os.path.abspath(root)
    smoke = chip_smoke()
    sys.path.insert(0, root)
    from contrast_renderer_tpu_torch import cuda_build, scenes
    from contrast_renderer_tpu_torch import renderer as api
    from contrast_renderer_tpu_torch.models import showcase
    from contrast_renderer_tpu_torch.ops import coverage

    if not coverage.__file__.startswith(root + os.sep):
        fail(f"imported {coverage.__file__}, not the port of {root}")
    KF = coverage.KernelFeatures
    coverage.build_kernels([
        KF(4), KF(4, depth=True), KF(4, paint_mode=1),
        KF(4, True, 2, (scenes.CHECKER_CUDA,)), KF(8),
    ])
    for name, (seconds, log) in cuda_build.build_logs.items():
        print(f"  {name}: built in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    results = {}
    todo = dict(frames(api, scenes, showcase, smoke))
    # Orbit frame 30 at 3840x2160 as a planned FrameProgram bins it (no
    # frame time: it is not a Renderer.render frame).
    todo[f"orbit 4K frame {smoke.ORBIT_BREAKDOWN_FRAME}"] = None
    for label, frame in todo.items():
        if frame is None:
            renderer = commands = None
            spec, runtime = smoke.orbit_frame(
                coverage, showcase, api.Configuration, api.Renderer,
                smoke.ORBIT_BREAKDOWN_FRAME)
        else:
            config, w, h, commands = frame
            renderer = api.Renderer(config, w, h, device="cuda")
            spec, _, runtime = renderer._prepare(commands)
        args = smoke.raster_args(coverage, spec, runtime)
        k_ms, k_lo, k_hi = smoke.cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        f_ms = (float("nan") if renderer is None else smoke.cuda_ms(
            lambda: renderer.render(commands, to_host=False), 10, 1, 3)[0])
        packed_spec = replace(spec, out_uint8=True)
        packed = packed_frame(
            packed_spec, coverage.coverage_raster(packed_spec, *args[1:])
        )
        results[label] = {
            "kernel_ms": k_ms, "kernel_lo": k_lo, "kernel_hi": k_hi, "frame_ms": f_ms,
            "commands": spec.n_commands,
            "rgba8": hashlib.sha256(packed.cpu().numpy().tobytes()).hexdigest()[:16],
        }
        print(f"  {label}: {spec.n_commands} commands walked, kernel {k_ms:.4f} ms "
              f"[{k_lo:.4f}, {k_hi:.4f}], frame {f_ms:.4f} ms", flush=True)
        if label == "showcase":
            ops = cached_ops(renderer, commands)
            results[label]["cached_ops"] = ops
            print(f"  {label}: a cached frame's device operations, the marker "
                  f"first: {'; '.join(f'{n} {us:.1f} us' for n, us in ops)}",
                  flush=True)
    print("AB " + json.dumps({"root": root, "frames": results}), flush=True)


#: The orbit's frames, timed windows, profiled frames, hashed frames,
#: and the FrameLoop's frames (the first ones build and capture).
ORBIT_FRAMES, ORBIT_WINDOWS, ORBIT_PROFILED = 99, 3, 33
ORBIT_HASHED = (0, 30, 98)
LOOP_FRAMES, LOOP_SETTLE = 24, 4


def orbit_size(api, showcase, smoke, width, height):
    """One size of the orbit through compile_frame: the numbers of the
    --orbit mode's docstring."""
    import statistics
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    shape = showcase.build_shape(with_text=True)
    stacks = [showcase.orbit_transforms(i, width, height)
              for i in range(ORBIT_FRAMES)]

    def at(i):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP))
        return stacks[i]

    renderer = api.Renderer(api.Configuration(), width, height,
                            strict_capacity=False, device="cuda")
    program = renderer.compile_frame(
        showcase.showcase_commands(shape, width, height), uint8_output=True)
    start = time.perf_counter()
    fused = program.plan_for_motion(stacks)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - start
    captures = [
        v.step.capture_ms for _, v in program._fused_variants.values()
        if getattr(v, "step", None) is not None and v.step.capture_ms is not None
    ]
    acc = torch.zeros((), device="cuda")
    for i in range(3):
        _, acc = program(at(i), carry=acc)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fps, split = [], {"plan_ms": 0.0, "bin_ms": 0.0, "raster_ms": 0.0}
    for _ in range(ORBIT_WINDOWS):
        start = time.perf_counter()
        for i in range(ORBIT_FRAMES):
            _, acc = program(at(i), carry=acc)
            for key in split:
                split[key] += program.stats[key]
            if "capture_ms" in program.stats:
                captures.append(program.stats["capture_ms"])
        float(acc)
        fps.append(ORBIT_FRAMES / (time.perf_counter() - start))
    peak = torch.cuda.max_memory_allocated() - base
    frames = ORBIT_FRAMES * ORBIT_WINDOWS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(ORBIT_PROFILED):
            _, acc = program(at(i), carry=acc)
        float(acc)
        profiled = time.perf_counter() - start
    busy = smoke.device_busy(prof)
    hashes, images = [], []
    for i in ORBIT_HASHED:
        image = program(at(i))
        images.append(image)
        hashes.append(hashlib.sha256(image.cpu().numpy().tobytes()).hexdigest()[:16])
    crossings = [sequential_crossings(program, stacks[i]) for i in ORBIT_HASHED]
    out = {
        "fused": fused, "plan_for_motion_s": plan_s, "frames_per_s": fps,
        "median_frames_per_s": statistics.median(fps),
        **{key: value / frames for key, value in split.items()},
        "capture_ms": captures, "peak_mib": peak / 2**20,
        "reserved_mib": torch.cuda.memory_reserved() / 2**20,
        "builds": program.builds, "rgba8": hashes,
        "indices": list(ORBIT_HASHED), "crossings": crossings,
        "images": images,
    }
    if busy is not None:
        b_us, r_us, o_us, count = busy
        out.update(
            busy_share=b_us / (profiled * 1e6),
            busy_ms=b_us / ORBIT_PROFILED / 1e3,
            raster_ms_device=r_us / ORBIT_PROFILED / 1e3,
            other_ms_device=o_us / ORBIT_PROFILED / 1e3,
            device_ops=count / ORBIT_PROFILED,
        )
    return out


def unplanned_orbit(api, showcase, width, height):
    """The orbit's frames through a program that never planned (chip_smoke
    phase 19's unplanned orbit), chained through ``carry`` with one fetch
    at the end: frames/s, frames fused, frames that captured a graph,
    each frame's host ms (the call) and the longest, frames 0, 30 and 98
    hashed."""
    import statistics
    import time

    import torch

    shape = showcase.build_shape(with_text=True)
    stacks = [showcase.orbit_transforms(i, width, height)
              for i in range(ORBIT_FRAMES)]
    renderer = api.Renderer(api.Configuration(), width, height,
                            strict_capacity=False, device="cuda")
    program = renderer.compile_frame(
        showcase.showcase_commands(shape, width, height), uint8_output=True)
    torch.cuda.synchronize()
    acc = torch.zeros((), device="cuda")
    host_ms, fused, captured, kept = [], 0, 0, []
    start = time.perf_counter()
    for i in range(ORBIT_FRAMES):
        shape.set_dynamic_stroke_options(
            0, showcase.dashed_options(i * showcase.ORBIT_DASH_STEP))
        begin = time.perf_counter()
        image, acc = program(stacks[i], carry=acc)
        host_ms.append((time.perf_counter() - begin) * 1e3)
        fused += program.stats["fused"]
        captured += "capture_ms" in program.stats
        if i in ORBIT_HASHED:
            kept.append(image)
    float(acc)
    wall = time.perf_counter() - start
    return {
        "frames_per_s": ORBIT_FRAMES / wall, "fused": fused,
        "captured": captured,
        "median_ms": statistics.median(host_ms), "longest_ms": max(host_ms),
        "rgba8": [hashlib.sha256(h.cpu().numpy().tobytes()).hexdigest()[:16]
                  for h in kept],
        "indices": list(ORBIT_HASHED),
        "crossings": [sequential_crossings(program, stacks[i])
                      for i in ORBIT_HASHED],
        "images": kept,
    }


def orbit_worker(root):
    """The --orbit mode's numbers with the port of ``root``; prints one
    line ``AB {json}``."""
    import statistics

    root = os.path.abspath(root)
    smoke = chip_smoke()
    sys.path.insert(0, root)
    from contrast_renderer_tpu_torch import renderer as api
    from contrast_renderer_tpu_torch.app import FrameLoop
    from contrast_renderer_tpu_torch.examples.orbit_camera import ShowcaseOrbitApp
    from contrast_renderer_tpu_torch.models import showcase
    from contrast_renderer_tpu_torch.ops import coverage

    if not coverage.__file__.startswith(root + os.sep):
        fail(f"imported {coverage.__file__}, not the port of {root}")
    coverage.build_kernels([coverage.KernelFeatures(4)])
    results = {}
    for w, h in ((smoke.SHOWCASE_W, smoke.SHOWCASE_H), (smoke.WIDTH, smoke.HEIGHT)):
        label = f"orbit {w}x{h}"
        results[label] = r = orbit_size(api, showcase, smoke, w, h)
        keep_frames(root, label, r)
        print(f"  {label}: {r['median_frames_per_s']:.2f} frames/s "
              f"({', '.join(f'{v:.2f}' for v in r['frames_per_s'])}); host a "
              f"frame: plan {r['plan_ms']:.3f} ms, bin {r['bin_ms']:.3f} ms, "
              f"raster {r['raster_ms']:.3f} ms; device busy "
              f"{r.get('busy_share', float('nan')):.3f} of the profiled window, "
              f"{r.get('busy_ms', float('nan')):.3f} ms a frame in "
              f"{r.get('device_ops', float('nan')):.1f} operations "
              f"(coverage_raster {r.get('raster_ms_device', float('nan')):.3f} ms); "
              f"capture ms {[round(c, 1) for c in r['capture_ms']]}; peak "
              f"{r['peak_mib']:.1f} MiB over the windows, reserved "
              f"{r['reserved_mib']:.1f} MiB; builds {r['builds']}", flush=True)
    label = f"unplanned orbit {smoke.SHOWCASE_W}x{smoke.SHOWCASE_H}"
    results[label] = r = unplanned_orbit(api, showcase, smoke.SHOWCASE_W,
                                         smoke.SHOWCASE_H)
    keep_frames(root, label, r)
    print(f"  {label}: {r['frames_per_s']:.2f} frames/s, {r['fused']} fused, "
          f"{r['captured']} frames captured a graph; host ms a frame median "
          f"{r['median_ms']:.2f}, "
          f"longest {r['longest_ms']:.2f}", flush=True)
    app = ShowcaseOrbitApp(with_text=True)
    loop = FrameLoop(app, smoke.SHOWCASE_W, smoke.SHOWCASE_H)
    seconds, captures = [], 0
    for index in range(LOOP_FRAMES):
        # chip_smoke.py phase 20's script: a drag, then a wheel event.
        if index == 0:
            loop.send_button(True)
            loop.send_pointer(0.0, 0.0)
        elif index <= 8:
            loop.send_pointer(40.0 * index, 6.0 * index)
        elif index == 9:
            loop.send_button(False)
        elif index == 10:
            loop.send_wheel(-2.0)
        loop.step()
        seconds.append(loop.timer.last_s)
        captures += "capture_ms" in app._program.stats
    loop_ms = statistics.median(seconds[LOOP_SETTLE:]) * 1e3
    results["frame loop"] = {
        "median_ms": loop_ms, "all_median_ms": statistics.median(seconds) * 1e3,
        "drag_ms": sum(seconds[:10]) * 1e3, "first_ms": seconds[0] * 1e3,
        "drag_frames_ms": [t * 1e3 for t in seconds[:10]],
        "drag_longest_ms": max(seconds[:10]) * 1e3, "captures": captures,
    }
    print(f"  frame loop {smoke.SHOWCASE_W}x{smoke.SHOWCASE_H}: median "
          f"{loop_ms:.2f} ms a frame of the last {LOOP_FRAMES - LOOP_SETTLE}, "
          f"{results['frame loop']['all_median_ms']:.2f} of all {LOOP_FRAMES}; "
          f"the drag's 10 frames {results['frame loop']['drag_ms']:.1f} ms in "
          f"all ({', '.join(f'{t * 1e3:.1f}' for t in seconds[:10])}), the "
          f"longest {results['frame loop']['drag_longest_ms']:.1f}; first "
          f"{seconds[0] * 1e3:.1f} ms; {captures} frames captured a graph",
          flush=True)
    print("AB " + json.dumps({"root": root, "frames": results}), flush=True)


def moved_worker(root):
    """The --moved mode's numbers with the port of ``root``; prints one
    line ``AB {json}``."""
    import statistics
    import time

    import numpy as np
    import torch

    root = os.path.abspath(root)
    smoke = chip_smoke()
    sys.path.insert(0, root)
    from contrast_renderer_tpu_torch import renderer as api
    from contrast_renderer_tpu_torch import scenes
    from contrast_renderer_tpu_torch.models import showcase
    from contrast_renderer_tpu_torch.ops import coverage
    from contrast_renderer_tpu_torch.parallel import (
        Mesh, ShardedFrameProgram, ShardedFrameProgram2D,
    )

    if not coverage.__file__.startswith(root + os.sep):
        fail(f"imported {coverage.__file__}, not the port of {root}")
    coverage.build_kernels([coverage.KernelFeatures(4)])
    results = {}
    n = smoke.MOVED_FRAMES
    for label, (config, w, h, frames, at) in smoke.moved_frames(
            api, scenes, showcase).items():
        for strict in (True, False):
            r = api.Renderer(config, w, h, strict_capacity=strict, device="cuda")
            acc = torch.zeros((), device="cuda")
            for i in list(range(n)) * 2:  # chip_smoke.py's two passes
                at(i)
                _, acc = r.render(frames[i], uint8_kernel=True, carry=acc)
            float(acc)
            fps, call, prepare, held = [], 0.0, 0.0, None
            for _ in range(smoke.MOVED_WINDOWS):
                held = []
                start = time.perf_counter()
                for i in range(n):
                    at(i)
                    called = time.perf_counter()
                    image, acc = r.render(frames[i], uint8_kernel=True, carry=acc)
                    call += time.perf_counter() - called
                    prepare += getattr(r, "timing", {}).get("prepare_ms", 0.0)
                    held.append(image)
                float(acc)
                fps.append(n / (time.perf_counter() - start))
            k = n * smoke.MOVED_WINDOWS
            key = f"{label}, strict_capacity={strict}"
            crossings = []
            for i in smoke.MOVED_CHECKED:
                at(i)
                _, _, runtime = r._prepare(frames[i], graph=False)
                crossings.append(int(runtime[0].overflow[3]))
            results[key] = {
                "frames_per_s": fps, "median_frames_per_s": statistics.median(fps),
                "call_ms": call * 1e3 / k, "prepare_ms": prepare / k,
                "rgba8": [hashlib.sha256(held[i].cpu().numpy().tobytes())
                          .hexdigest()[:16] for i in smoke.MOVED_CHECKED],
                "indices": list(smoke.MOVED_CHECKED), "crossings": crossings,
                "images": [held[i] for i in smoke.MOVED_CHECKED],
            }
            keep_frames(root, key, results[key])
            print(f"  moved {key}: {results[key]['median_frames_per_s']:.2f} "
                  f"frames/s ({', '.join(f'{f:.2f}' for f in fps)}); host a "
                  f"frame: render call {results[key]['call_ms']:.3f} ms, "
                  f"_prepare {results[key]['prepare_ms']:.3f} ms (0: not "
                  f"recorded by this root)", flush=True)
            del r, held
    devices = [f"cuda:{i % torch.cuda.device_count()}"
               for i in range(smoke.SHARD_BANDS)]
    shape = showcase.build_shape(with_text=True)
    sw, sh = smoke.SHOWCASE_W, smoke.SHOWCASE_H
    commands = showcase.showcase_commands(shape, sw, sh)
    stacks = [showcase.orbit_transforms(i, sw, sh)
              for i in range(smoke.SHARD_FRAMES)]
    for name, make in (
        ("sharded 4 bands", lambda r: ShardedFrameProgram(
            r, commands, Mesh(devices, ("y",)))),
        ("sharded 2x2", lambda r: ShardedFrameProgram2D(
            r, commands, Mesh(np.array(devices).reshape(2, 2), ("y", "x")))),
    ):
        program = make(api.Renderer(api.Configuration(), sw, sh, device="cuda"))
        for t in stacks:
            program(t)
        torch.cuda.synchronize()
        synced = []
        for t in stacks * 2:
            start = time.perf_counter()
            program(t)
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - start) * 1e3)
        first = program(stacks[0])
        results[name] = {
            "frame_ms": statistics.median(synced), "frame_lo": min(synced),
            "frame_hi": max(synced),
            "rgba8": [hashlib.sha256(api.Renderer._quantize(first).cpu()
                                     .numpy().tobytes()).hexdigest()[:16]],
        }
        print(f"  {name} {sw}x{sh}: {results[name]['frame_ms']:.3f} ms a frame "
              f"[{min(synced):.3f}, {max(synced):.3f}] (synchronised, "
              f"{len(synced)} frames)", flush=True)
        del program
    print("AB " + json.dumps({"root": root, "frames": results}), flush=True)


def moved_summary(roots, runs):
    """Rows of the --moved mode; returns whether the roots' frames agree
    (compare_frames)."""
    equal = True
    labels = list(dict.fromkeys(k for rs in runs.values() for r in rs for k in r))
    for label in labels:
        agree, text = compare_frames(roots, runs, label)
        equal &= agree
        key = "frame_ms" if label.startswith("sharded") else "median_frames_per_s"
        unit = "ms a frame" if key == "frame_ms" else "frames/s"
        print(f"{label}: " + "; ".join(
            f"{letter} {', '.join(f'{r[label][key]:.2f}' for r in runs[letter])} "
            f"{unit}" for letter in roots)
            + f"; frames as they must be {agree}: {text}", flush=True)
    return equal


def orbit_summary(roots, runs):
    """Rows of the --orbit mode; returns whether the roots' frames agree
    (compare_frames)."""
    equal = True
    for label in (f"orbit {w}x{h}" for w, h in ((3840, 2160), (1920, 1080))):
        agree, text = compare_frames(roots, runs, label)
        equal &= agree
        cells = []
        for letter in roots:
            done = [r[label] for r in runs[letter]]
            cells.append(
                f"{letter} {', '.join(f'{d['median_frames_per_s']:.2f}' for d in done)} "
                f"frames/s, bin {', '.join(f'{d['bin_ms']:.2f}' for d in done)} ms, "
                f"busy {', '.join(f'{d.get('busy_share', float('nan')):.3f}' for d in done)}"
            )
        print(f"{label}: {'; '.join(cells)}; frames as they must be {agree}: "
              f"{text}", flush=True)
    print("plan_for_motion, 99 frames: " + "; ".join(
        f"{letter} " + " / ".join(
            ", ".join(f"{r[f'orbit {w}x{h}']['plan_for_motion_s']:.3f}"
                      for r in runs[letter])
            for w, h in ((3840, 2160), (1920, 1080)))
        + " s (4K / 1080p)" for letter in roots), flush=True)
    label = "unplanned orbit 3840x2160"
    agree, text = compare_frames(roots, runs, label)
    equal &= agree
    print(f"{label}: " + "; ".join(
        f"{letter} {', '.join(f'{r[label]['frames_per_s']:.2f}' for r in runs[letter])} "
        f"frames/s, fused {', '.join(str(r[label]['fused']) for r in runs[letter])}, "
        f"captured {', '.join(str(r[label]['captured']) for r in runs[letter])}, "
        f"longest {', '.join(f'{r[label]['longest_ms']:.1f}' for r in runs[letter])} ms"
        for letter in roots) + f"; frames as they must be {agree}: {text}",
        flush=True)
    print("frame loop: " + "; ".join(
        f"{letter} {', '.join(f'{r['frame loop']['median_ms']:.2f}' for r in runs[letter])} ms "
        f"(drag {', '.join(f'{r['frame loop']['drag_ms']:.0f}' for r in runs[letter])} ms, "
        f"its longest frame "
        f"{', '.join(f'{r['frame loop'].get('drag_longest_ms', float('nan')):.1f}' for r in runs[letter])} ms, "
        f"captured {', '.join(str(r['frame loop']['captures']) for r in runs[letter])})"
        for letter in roots), flush=True)
    return equal


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return
    if argv[:1] == ["--orbit-worker"]:
        orbit_worker(argv[1])
        return
    if argv[:1] == ["--moved-worker"]:
        moved_worker(argv[1])
        return
    mode = argv[0][2:] if argv[:1] in (["--orbit"], ["--moved"]) else None
    if mode:
        argv = argv[1:]
    if not 2 <= len(argv) <= len(LETTERS):
        fail("usage: chip_ab.py [--orbit | --moved] ROOT_A ROOT_B [ROOT_C ...]")
    roots = dict(zip(LETTERS, argv))
    sequence = order(len(argv))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    runs = {letter: [] for letter in roots}
    for letter in sequence:
        print(f"{letter}: {roots[letter]}", flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             f"--{mode}-worker" if mode else "--worker", roots[letter]],
            capture_output=True, text=True, timeout=900,
        )
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                runs[letter].append(json.loads(line[3:])["frames"])
            else:
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"the {letter} process exited {proc.returncode}")
    if mode:
        equal = (orbit_summary if mode == "orbit" else moved_summary)(roots, runs)
        print(json.dumps({mode: runs, "roots": roots, "order": sequence}),
              flush=True)
        if not equal:
            fail(f"the roots' {mode} frames differ where no near plane is "
                 f"crossed")
        return
    summary = {}
    labels = list(dict.fromkeys(k for rs in runs.values() for r in rs for k in r))
    for label in labels:
        row = {}
        for letter in roots:
            done = [r[label] for r in runs[letter] if label in r]
            row[letter] = {
                "commands": sorted({d.get("commands") for d in done}, key=str),
                "kernel_ms": [d["kernel_ms"] for d in done],
                "kernel_lo": min(d["kernel_lo"] for d in done),
                "kernel_hi": max(d["kernel_hi"] for d in done),
                "frame_ms": [d["frame_ms"] for d in done],
                "rgba8": sorted({d["rgba8"] for d in done}),
            } if done else None
        present = [row[letter] for letter in roots if row[letter]]
        row["equal"] = (
            len({h for r in present for h in r["rgba8"]}) == 1
            if len(present) >= 2 else None
        )
        summary[label] = row
        cells = "; ".join(
            f"{letter} ({row[letter]['commands']} commands) kernel "
            f"{', '.join(f'{v:.4f}' for v in row[letter]['kernel_ms'])} "
            f"[{row[letter]['kernel_lo']:.4f}, {row[letter]['kernel_hi']:.4f}] ms, "
            f"frame {', '.join(f'{v:.3f}' for v in row[letter]['frame_ms'])} ms"
            if row[letter] else f"{letter} does not render it"
            for letter in roots
        )
        print(f"{label}: {cells}; images equal {row['equal']}", flush=True)
    print(json.dumps({"ab": summary, "roots": roots, "order": sequence}), flush=True)
    if any(row["equal"] is False for row in summary.values()):
        fail("the roots' images differ")


if __name__ == "__main__":
    main()
