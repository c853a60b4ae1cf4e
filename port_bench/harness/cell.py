"""One cell of the benchmark: its configuration, traffic and metrics,
found by name from ``BENCHMARK.json``, and the steps of a run: set-up,
the measured window, the comparison with the reference, the metrics.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, traffic as traffic_mod, window as window_mod
from .trace import TraceSummary, summarize

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path, name):
    """A module from a file, by path (names hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scene_module(name):
    return importlib.import_module(f"port_bench.scenes.{name}")


def entry_class(name):
    """The ``Entry`` of ``port_bench/entries/<name>.py``."""
    return importlib.import_module(f"port_bench.entries.{name}").Entry


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files loaded."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def params(self):
        c = self.config
        return {**c["params"], "width": c["width"], "height": c["height"]}

    @property
    def dash_period(self):
        """The scene's dash period, None for a scene without dashes."""
        return self.config["params"].get("dash", {}).get("period")

    def schedule(self, seed):
        return traffic_mod.Schedule(self.traffic, seed, self.dash_period)


def load_cell(name, bench_path=None, config_overrides=None, traffic_overrides=None):
    """The cell ``name`` of BENCHMARK.json (``bench_path``, by default the
    one at the checkout's root); overrides replace keys of its
    configuration or traffic (the CPU tests shrink a cell so)."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = traffic_mod.load(bench_path.parent / configs[w["config"]]["file"])
    config.update(config_overrides or {})
    traffic = traffic_mod.load(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    traffic.update(traffic_overrides or {})
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, w, config, traffic, e2e, layer)


@dataclass
class Port:
    """The port's side of a cell once set up."""

    entry: object
    scene: object
    stacks: np.ndarray
    schedule: traffic_mod.Schedule


def stacks_of(cell):
    """Every path position's (R, 4, 4) transform stack, float32."""
    scene = scene_module(cell.config["scene"])
    return np.stack([traffic_mod.camera_stack(scene, cell.params, cell.traffic, p)
                     for p in range(int(cell.traffic["path_frames"]))])


def set_up(cell, seed, device, split=None):
    """Build the port's scene and entry and warm up every position of the
    traffic's path.  ``split``, where given, gets the seconds of each
    step, and of the builds inside them (``native_load_s``: the port's
    g++ library, built on a checkout's first run; ``nvcc_s``: its kernel
    libraries, the same)."""
    from dataclasses import replace

    from . import port_lib

    split = {} if split is None else split
    cuda = torch.device(device).type == "cuda"
    tick = time.perf_counter()

    def lap(key):
        nonlocal tick
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        split[key] = now - tick
        tick = now

    split["native_load_s"] = port_lib.load_native()
    tick = time.perf_counter()
    probe = None
    if cuda:
        from .settle import Probe

        probe = Probe(device)
    lap("context_s")
    scene = scene_module(cell.config["scene"]).build(cell.params, port_lib.lib())
    stacks = stacks_of(cell)
    # The commands carry the path's first position, the frame that a
    # program settles its capacities on.
    scene.commands[:] = [replace(c, transform=np.asarray(t, np.float64))
                         for c, t in zip(scene.commands, stacks[0])]
    lap("scene_s")
    schedule = cell.schedule(seed)
    entry = entry_class(cell.traffic["entry"])(cell.config, scene, stacks, schedule, device)
    lap("entry_s")
    entry.warm(int(cell.traffic["warm_cycles"]))
    lap("warm_s")
    split["nvcc_s"] = port_lib.nvcc_seconds()
    # What set-up made lives for the whole run: moved out of the garbage
    # collector's generations, so that a collection in the window does
    # not walk it.
    gc.collect()
    gc.freeze()
    if probe is not None:
        first, last, waited = probe.wait()
        split.update(probe_first_ms=first, probe_last_ms=last, settle_s=waited)
    return Port(entry, scene, stacks, schedule)


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: Cell
    window: window_mod.Window
    setup_s: float
    memory_peak_bytes: int
    trace: Optional[TraceSummary] = None
    kept: Dict[int, object] = field(default_factory=dict)
    schedule: Optional[traffic_mod.Schedule] = None
    stacks: Optional[np.ndarray] = None
    device: str = "cuda"
    described: str = ""
    setup: Dict[str, float] = field(default_factory=dict)


def reference_scene(cell):
    from ..reference import scene as ref

    return scene_module(cell.config["scene"]).build(cell.params, ref.lib())


def ref_commands(ref_scene, stack):
    from dataclasses import replace

    return [replace(c, transform=t) for c, t in zip(ref_scene.commands, stack)]


def reference_frame(cell, ref_scene, schedule, stacks, n, dtype, device):
    """The reference's packed RGBA8 frame n of the window."""
    from ..reference import scene as ref

    ref_scene.set_phase(schedule.phase(n))
    c = cell.config
    samples, winding_bits = ref.frame_options(c.get("configuration", {}))
    return ref.render(ref_commands(ref_scene, stacks[schedule.position(n)]),
                      c["width"], c["height"], samples, winding_bits,
                      dtype=dtype, device=device)


def measure(cell, port, seed, seconds, trace, setup_s, device, fault=None, split=None):
    """The measured window of a set-up port; with ``trace``, a profiled
    stretch inside it.  ``fault``, in tests, wraps the entry."""
    clock = window_mod.DeviceClock(device)
    t = cell.traffic
    keeper = traffic_mod.Reservoir(t["check_frames"], seed)
    tracer = (window_mod.Tracer(t["trace_frames"], t["trace_at"], clock)
              if trace else None)
    issue = port.entry if fault is None else fault(port.entry)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    w = window_mod.run(issue, seconds, clock, t["frames_in_flight"], keeper.offer,
                       port.entry.spans, port.entry.captured, tracer)
    summary = None
    if tracer is not None and tracer.done:
        summary = summarize(tracer.prof, len(w.traced), w.trace_seconds)
    peak = (torch.cuda.max_memory_reserved() if torch.device(device).type == "cuda"
            else 0)
    return Run(cell, w, setup_s, peak, summary, keeper.kept, port.schedule,
               port.stacks, device, port.entry.describe(), dict(split or {}))


def compare(cell, run, device, dtype=torch.float64):
    """(correct, checks, frames failed) of a run against the reference."""
    ref_scene = reference_scene(cell)
    shares = []
    tol = cell.config["check"]["channel_tolerance"]
    for n in sorted(run.kept):
        expected = reference_frame(cell, ref_scene, run.schedule, run.stacks, n,
                                   dtype, device)
        shares.append(check.off_share(run.kept[n], expected, tol))
        del expected
    return check.judge(shares, cell.config["check"]["off_share"],
                       len(run.kept))


def control_shares(cell, frames, schedule, stacks, device, dtype):
    """The off shares of the reference computed in ``dtype`` against the
    float64 reference, on the frames ``frames``: the control."""
    ref_scene = reference_scene(cell)
    tol = cell.config["check"]["channel_tolerance"]
    out = []
    for n in frames:
        low = reference_frame(cell, ref_scene, schedule, stacks, n, dtype, device)
        high = reference_frame(cell, ref_scene, schedule, stacks, n, torch.float64, device)
        out.append(check.off_share(low, high, tol))
    return out


def metric_values(cell, run, trace):
    """The cell's metrics (end-to-end, or per-layer with ``trace``) from
    their readers under ``port_bench/metrics``; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                             f"port_bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_record(device, run, trace):
    rec = {
        "platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(0)
                 if torch.device(device).type == "cuda" else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(run.memory_peak_bytes),
    }
    if trace and run.trace is not None:
        rec["busy_s"] = run.trace.busy_s
        rec["window_s"] = run.trace.window_s
    return rec


FORBIDDEN = ("jax", "jaxlib", "flax", "contrast_renderer_tpu")


def forbidden_modules(modules):
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def window_line(run):
    """One line on the window, for the log: frames, interval percentiles,
    captures and garbage collections in it."""
    w = run.window
    iv = sorted(w.intervals_ms)
    q = {p: window_mod.percentile(iv, p) for p in (50, 90, 99, 99.9)} if iv else {}
    spans = "; ".join(f"{k} {sum(v) / len(v):.4f}" for k, v in w.spans.items() if v)
    setup = " ".join(f"{k} {v:.3f}" for k, v in run.setup.items())
    return (f"setup {setup}\n"
            f"window {w.frames} frames {w.seconds:.3f} s; interval ms p50 "
            f"{q.get(50, 0):.4f} p90 {q.get(90, 0):.4f} p99 {q.get(99, 0):.4f} "
            f"p99.9 {q.get(99.9, 0):.4f} max {iv[-1] if iv else 0:.4f}; "
            f"captures {w.captures}; gc {w.gc_collections}; {spans}; {run.described}")


def run_once(name, seed, seconds, trace, t0, device="cuda", config_overrides=None,
             traffic_overrides=None, fault=None, bench_path=None):
    """A whole run of cell ``name``: returns (result dict, check lines)."""
    cell = load_cell(name, bench_path, config_overrides, traffic_overrides)
    split = {"start_s": time.perf_counter() - t0}
    port = set_up(cell, seed, device, split)
    # The wait for the card's fast mode is the harness's, not the
    # program's set-up (harness/settle.py): it is reported apart.
    setup_s = time.perf_counter() - t0 - split.get("settle_s", 0.0)
    run = measure(cell, port, seed, seconds, trace, setup_s, device, fault, split)
    dev = device_record(device, run, trace)
    # The program's state goes before the reference runs; the frames kept
    # for the comparison stay.
    del port
    check.free_device_memory()
    metrics = metric_values(cell, run, trace)
    correct, checks, failed = compare(cell, run, device)
    result = {
        "correct": correct,
        "attempted": run.window.frames,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    # Set-up's steps (the builds among them), which the driver ignores:
    # setup_s holds them all.
    result["setup"] = run.setup
    result["checks"] = checks
    return result, run
