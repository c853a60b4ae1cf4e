#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. a CUDA device is visible; print its name and power limit
   (nvidia-smi);
2. build the coverage raster kernel (csrc/coverage_raster.cu) with nvcc;
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
   after warm-up.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
CIRCLE_SIZE = 256
KERNEL_SOURCE = "contrast_renderer_tpu_torch/csrc/coverage_raster.cu"
TPU_KERNEL = "contrast_renderer_tpu/ops/coverage.py:1446"
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


def main():
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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

    from dataclasses import replace

    import numpy as np

    try:
        from contrast_renderer_tpu_torch import cuda_build, scenes
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
            if "registers" in line or "spill" in line:
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
    prepared, cmd_i, cmd_f = runtime[:3]
    draws = coverage.draw_tables(spec)
    units = (
        torch.as_tensor(draws.unit_cmd, device="cuda"),
        torch.as_tensor(draws.unit_draw, device="cuda"),
    )
    max_abs_err = None
    for u8 in (False, True):
        mode = replace(spec, out_uint8=u8)
        args = (mode, prepared, cmd_i, cmd_f, *units)
        got = coverage.coverage_raster(*args)
        want = coverage.rasterize_plain(*args)
        torch.cuda.synchronize()
        if u8:
            gb = got.view(torch.uint8).reshape(-1, 4).int()
            wb = want.view(torch.uint8).reshape(-1, 4).int()
            px = (gb != wb).any(-1)
            worst = int((gb - wb).abs().max())
            n_px = int(px.sum())
            print(f"kernel vs plain, packed RGBA8: {n_px} of {px.numel()} "
                  f"pixels differ, max {worst} LSB", flush=True)
            if n_px > U8_MAX_FRACTION * px.numel() or worst > 1:
                fail("packed RGBA8 output disagrees with the plain version")
        else:
            max_abs_err = float((got - want).abs().max())
            print(f"kernel vs plain, float: max abs err {max_abs_err:.3g}, "
                  f"bit-identical {bool(torch.equal(got, want))}", flush=True)
            if not max_abs_err <= FLOAT_TOL:
                fail(f"float output off by {max_abs_err} > {FLOAT_TOL}")

    # ---- 4. the slice end to end ----------------------------------------
    coverage.raster_launches = 0
    image = renderer.render(commands, to_host=False)
    torch.cuda.synchronize()
    launches = coverage.raster_launches
    if launches < 1:
        fail("Renderer.render did not launch coverage_raster")
    if tuple(image.shape) != (HEIGHT, WIDTH, 4) or image.device.type != "cuda":
        fail(f"frame shape {tuple(image.shape)} on {image.device}")
    if not bool(torch.isfinite(image).all()):
        fail("non-finite values in the frame")
    alpha = image[..., 3]
    if float(alpha.min()) < 0.0 or float(alpha.max()) > 1.0:
        fail("alpha outside [0, 1]")
    covered = float((alpha > 0).float().mean())
    if covered <= 0.0:
        fail("no pixel covered")
    print(f"render: {launches} coverage_raster launch(es), "
          f"{covered:.3f} of pixels covered", flush=True)

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
    args = (spec, prepared, cmd_i, cmd_f, *units)
    kernel_ms = cuda_ms(lambda: coverage.coverage_raster(*args), 5, 20, 5)
    plain_ms = cuda_ms(lambda: coverage.rasterize_plain(*args), 3, 1, 1)
    # A frame: Renderer.render with the binning cached (unchanged
    # transforms), from the host call to the end of its last kernel.
    frame_ms = cuda_ms(
        lambda: renderer.render(commands, to_host=False), 20, 1, 5
    )
    binning = []
    for _ in range(5):
        renderer._prepared_cache.clear()
        start = time.perf_counter()
        renderer._prepare(commands)
        torch.cuda.synchronize()
        binning.append((time.perf_counter() - start) * 1e3)
    binning_ms = statistics.median(binning)
    print(f"timing ({card}): coverage_raster {kernel_ms:.3f} ms, "
          f"rasterize_plain {plain_ms:.3f} ms, frame (cached binning) "
          f"median {frame_ms:.3f} ms, binning median {binning_ms:.3f} ms",
          flush=True)

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "coverage_raster",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
