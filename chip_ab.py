#!/usr/bin/env python3
"""Interleaved A/B of the coverage kernel between checkouts of this
repository, on one CUDA device.

    python3 chip_ab.py ROOT_A ROOT_B [ROOT_C ...]

Fresh processes, each root three times in the order A, B, B, A, A, B
(with more roots, the roots in order, reversed, then in order again),
each import ``contrast_renderer_tpu_torch`` from their root (its kernels
built from that root's sources into its own ``build/``), bin
chip_smoke.py's eight 4× MSAA frames on the card, and time each: the
kernel (``coverage_raster``, median of 5 batches of 10 launches, with
the batches' least and greatest; CUDA events, chip_smoke.py's
``cuda_ms``) and the frame with cached binning (``Renderer.render``,
median of 10 frames), and, for the 4K showcase, the device operations of
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
        KF(4, True, 2, (scenes.CHECKER_CUDA,)),
    ])
    for name, (seconds, log) in cuda_build.build_logs.items():
        print(f"  {name}: built in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    results = {}
    for label, (config, w, h, commands) in frames(api, scenes, showcase, smoke).items():
        renderer = api.Renderer(config, w, h, device="cuda")
        spec, _, runtime = renderer._prepare(commands)
        args = smoke.raster_args(coverage, spec, runtime)
        k_ms, k_lo, k_hi = smoke.cuda_ms(lambda: coverage.coverage_raster(*args), 5, 10, 3)
        f_ms = smoke.cuda_ms(lambda: renderer.render(commands, to_host=False), 10, 1, 3)[0]
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


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return
    if not 2 <= len(argv) <= len(LETTERS):
        fail("usage: chip_ab.py ROOT_A ROOT_B [ROOT_C ...]")
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
            [sys.executable, os.path.abspath(__file__), "--worker", roots[letter]],
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
