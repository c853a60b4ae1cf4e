"""The readings that a cell's comparison limit is set from, in one
process: the port's off share on each seed's kept frames (the lower
reading) and the control's, the reference computed in bfloat16 in the
port's place, on the same frames (the upper reading)."""

from __future__ import annotations

import json
import statistics
import sys

import torch

from . import cell as cell_mod
from .window import percentile


def many(cell, seeds, seconds, t0, device="cuda", fault=None):
    port = cell_mod.set_up(cell, seeds[0], device)
    print(f"set-up {cell_mod.time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)
    for seed in seeds:
        schedule = cell.schedule(seed)
        port.schedule = port.entry.schedule = schedule
        run = cell_mod.measure(cell, port, seed, seconds, False, 0.0, device, fault)
        ref_scene = cell_mod.reference_scene(cell)
        shares, control = [], []
        tol = cell.config["check"]["channel_tolerance"]
        for n in sorted(run.kept):
            high = cell_mod.reference_frame(cell, ref_scene, schedule, port.stacks, n,
                                            torch.float64, device)
            low = cell_mod.reference_frame(cell, ref_scene, schedule, port.stacks, n,
                                           torch.bfloat16, device)
            shares.append(cell_mod.check.off_share(run.kept[n], high, tol))
            control.append(cell_mod.check.off_share(low, high, tol))
        w = run.window
        print(json.dumps({
            "seed": seed, "frames": w.frames, "frames_per_s": w.frames / w.seconds,
            "frame_interval_p99_ms": (percentile(w.intervals_ms, 99)
                                      if w.intervals_ms else None),
            "frame_interval_median_ms": (statistics.median(w.intervals_ms)
                                         if w.intervals_ms else None),
            "captures": w.captures, "kept": sorted(run.kept),
            "off_share": shares, "control_off_share": control,
            "positions": [schedule.position(n) for n in sorted(run.kept)],
        }), flush=True)
        del run
        cell_mod.check.free_device_memory()
    return 0
