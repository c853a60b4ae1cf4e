#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. a CUDA device is visible; print its name and power limit
   (nvidia-smi);
2. build the coverage raster kernel (csrc/coverage_raster.cu) with nvcc
   and print ptxas' registers and spills per instantiation;
3. on the BASELINE config-2 frame (1,000 integral quadratic and cubic
   Bézier fills, 1920×1080, 4× MSAA), binned by the port on the card,
   hold the kernel against its plain torch version on the same tensors,
   float and packed-RGBA8 output;
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
   front-to-back); for each, kernel against plain on the prepared frame,
   then ``Renderer.render``; for the clip/alpha variant, nothing outside
   the outer clip;
9. the cap sheet through ``Renderer.render`` against the reference's
   golden (tests/golden/cap_styles_96x72.npy), bit for bit;
10. time the kernel, its plain version, the cached-binning frame (CUDA
   events, and the host clock around the call with no synchronise) and
   the binning of each frame of phases 7-8.

The line before the last is ``{"kernels": [...]}``, one entry per ported
body of the kernel with the frame that exercised it; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
SHOWCASE_W, SHOWCASE_H = 3840, 2160
CIRCLE_SIZE = 256
KERNEL_SOURCE = "contrast_renderer_tpu_torch/csrc/coverage_raster.cu"
TPU_KERNEL = "contrast_renderer_tpu/ops/coverage.py"
CAP_GOLDEN = "tests/golden/cap_styles_96x72.npy"
FLOAT_TOL = 1e-6
U8_MAX_FRACTION = 1e-4


def fail(message):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, iters, warmup):
    """Median over ``reps`` batches of the device time per call of
    ``fn``, each batch ``iters`` calls between two CUDA events, after
    ``warmup`` calls."""
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
    return statistics.median(times)


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
    """Hold the kernel against rasterize_plain on the same tensors, float
    (max abs error ≤ FLOAT_TOL) and packed RGBA8 (at most U8_MAX_FRACTION
    of pixels differ, by at most 1 LSB).  Returns the float max abs
    error."""
    from dataclasses import replace

    import torch

    max_abs_err = None
    args = raster_args(coverage, spec, runtime)
    for u8 in (False, True):
        mode = (replace(spec, out_uint8=u8),) + args[1:]
        got = coverage.coverage_raster(*mode)
        want = coverage.rasterize_plain(*mode)
        torch.cuda.synchronize()
        if u8:
            gb = got.view(torch.uint8).reshape(-1, 4).int()
            wb = want.view(torch.uint8).reshape(-1, 4).int()
            px = (gb != wb).any(-1)
            worst = int((gb - wb).abs().max())
            n_px = int(px.sum())
            print(f"{label}: kernel vs plain, packed RGBA8: {n_px} of "
                  f"{px.numel()} pixels differ, max {worst} LSB", flush=True)
            if n_px > U8_MAX_FRACTION * px.numel() or worst > 1:
                fail(f"{label}: packed RGBA8 output disagrees with the plain version")
        else:
            max_abs_err = float((got - want).abs().max())
            print(f"{label}: kernel vs plain, float: max abs err "
                  f"{max_abs_err:.3g}, bit-identical "
                  f"{bool(torch.equal(got, want))}", flush=True)
            if not max_abs_err <= FLOAT_TOL:
                fail(f"{label}: float output off by {max_abs_err} > {FLOAT_TOL}")
            if not bool((want[:, 3] > 0).any()):
                fail(f"{label}: the plain version covered nothing")
    return max_abs_err


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
    """One frame through Renderer.render with the launch count set to 0
    just before and read just after; fails unless the kernel launched."""
    import torch

    coverage.raster_launches = 0
    image = renderer.render(commands, to_host=False)
    torch.cuda.synchronize()
    launches = coverage.raster_launches
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
        from contrast_renderer_tpu_torch.models import showcase
        from contrast_renderer_tpu_torch.ops import coverage
        from contrast_renderer_tpu_torch.renderer import (
            Configuration, DrawCommand, RenderOperation, Renderer, Shape,
        )
    except ImportError as exc:
        fail(f"the port does not import from beside this script: {exc}")

    # ---- 2. build -------------------------------------------------------
    start = time.perf_counter()
    coverage.build_kernel()
    build_s = time.perf_counter() - start
    print(f"build: coverage_raster loaded in {build_s:.1f} s", flush=True)
    for _, log in cuda_build.build_logs.values():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

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
    kernel_ms = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 20, 5)
    plain_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 3, 1, 1)
    # A frame: Renderer.render with the binning cached (unchanged
    # transforms), from the host call to the end of its last kernel.
    frame_ms = cuda_ms(
        lambda: renderer.render(commands, to_host=False), 20, 1, 5
    )
    bin_ms = binning_ms(renderer, commands, 5)
    print(f"timing ({card}): coverage_raster {kernel_ms:.3f} ms, "
          f"rasterize_plain {plain_ms:.3f} ms, frame (cached binning) "
          f"median {frame_ms:.3f} ms, binning median {bin_ms:.3f} ms",
          flush=True)
    fill_entry = dict(frame="config 2 (1,000 Bézier fills, 1920x1080)",
                      launches=launches, max_abs_err=max_abs_err,
                      ms=kernel_ms, plain_ms=plain_ms)

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
    coverage.raster_launches = 0
    images = []
    for phase in (0.0, 0.3):
        for g, join in enumerate(scenes.DASHED_JOINS):
            dashed.set_dynamic_stroke_options(g, scenes.dashed_options(join, phase))
        images.append(renderer3.render(commands3, to_host=False))
    torch.cuda.synchronize()
    launches3 = coverage.raster_launches
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
    times = {}
    for label, (r, cmds, spec_v, runtime_v, err_v, launches_v) in timed.items():
        args = raster_args(coverage, spec_v, runtime_v)
        k_ms = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        p_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 1, 1, 0)
        f_ms = cuda_ms(lambda: r.render(cmds, to_host=False), 10, 1, 3)
        h_ms = host_ms(lambda: r.render(cmds, to_host=False), 20, 3)
        b_ms = binning_ms(r, cmds, 3)
        times[label] = (k_ms, p_ms)
        print(f"timing {label} ({card}): coverage_raster {k_ms:.3f} ms, "
              f"rasterize_plain {p_ms:.3f} ms, frame (cached binning) "
              f"median {f_ms:.3f} ms, its host time median {h_ms:.3f} ms, "
              f"binning median {b_ms:.3f} ms", flush=True)

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    def entry(name, line, frame, launches, max_abs_err, ms, plain_ms):
        return {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_KERNEL}:{line}", "frame": frame,
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
        }

    def measured(label, frame):
        _, _, _, _, err_v, launches_v = timed[label]
        return dict(frame=frame, launches=launches_v, max_abs_err=err_v,
                    ms=times[label][0], plain_ms=times[label][1])

    config3 = measured("config 3", "config 3 (60 dashed polylines, 1920x1080)")
    clip_alpha = measured(
        "showcase clip/alpha", "showcase clip/alpha variant, 3840x2160"
    )
    print(json.dumps({"kernels": [
        entry("coverage_raster: tile driver and resolve", 1446, **fill_entry),
        entry("coverage_raster: fill stencil", 1672, **fill_entry),
        entry("coverage_raster: solid colour cover", 1894, **fill_entry),
        entry("coverage_raster: stroke stencil", 1511, **config3),
        entry("coverage_raster: clip", 2109, **clip_alpha),
        entry("coverage_raster: alpha groups", 2126, **clip_alpha),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
