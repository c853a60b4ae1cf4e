"""The per-layer metrics that read the port's frame record (binning's five
stages, its graph's nodes, the frame program's upkeep): each returns a
number once the record holds enough of the window's untraced frames, and
None while it does not, or where the port keeps no record; the traced
stretch is left out.  The fill cell's timed path runs on the port's
plain CPU path, shrunk to a few small paths; a cuda case runs the cell
through the command on the card."""

import dataclasses
import json
import subprocess
import sys

import pytest

from port_bench.harness import cell as cell_mod
from port_bench.harness import frame_record, port_lib

STAGE_METRICS = ["bin_setup_ms", "bin_slots_ms", "bin_globals_ms",
                 "bin_covers_ms", "bin_units_ms"]
RECORD_METRICS = STAGE_METRICS + ["bin_graph_nodes", "frame_upkeep_ms"]


def readings(run):
    out = {}
    for name in RECORD_METRICS:
        reader = cell_mod.load_module(cell_mod.BENCH_DIR / "metrics" / f"{name}.py",
                                      f"probe_record_{name}")
        out[name] = reader.read(run)
    return out


@pytest.fixture(scope="module")
def drift():
    """The fill cell at 128 x 64 with 8 paths (tens of ms a frame on the
    CPU), its traced stretch the window's first two frames."""
    base = cell_mod.load_cell("fills-1080p.drift").config["params"]
    params = dict(base, fills={"paths": 8, "margin": 10.0, "radius": [4.0, 12.0]})
    cell = cell_mod.load_cell(
        "fills-1080p.drift",
        config_overrides={"width": 128, "height": 64, "params": params},
        traffic_overrides={"path_frames": 3, "check_frames": 2, "warm_cycles": 1,
                           "trace_frames": 2, "trace_at": 0.0})
    port = cell_mod.set_up(cell, 5, "cpu")
    run = cell_mod.measure(cell, port, 2**31 + 5, 0.2, True, 0.0, "cpu")
    assert run.window.traced == [0, 1]
    return cell, port, run


def test_the_cell_reports_the_record_metrics():
    cell = cell_mod.load_cell("fills-1080p.drift")
    names = [m["name"] for m in cell.per_layer]
    assert set(RECORD_METRICS) <= set(names)
    assert cell_mod.load_cell("strokes-1080p.drift").per_layer == cell.per_layer


def test_none_before_enough_untraced_frames(drift):
    # The window's own frames, however many follow it in the record.
    _, _, run = drift
    assert run.window.frames - len(run.window.traced) < frame_record.MIN_FRAMES
    assert readings(run) == dict.fromkeys(RECORD_METRICS)


def longer(run, more):
    """The run as if its window had gone on for ``more`` frames."""
    return dataclasses.replace(
        run, window=dataclasses.replace(run.window, frames=run.window.frames + more))


MORE = frame_record.MIN_FRAMES + 10


@pytest.fixture(scope="module")
def extended(drift):
    """The drift cell's run after MORE frames past its window, in any
    order of the tests."""
    cell, port, run = drift
    for n in range(run.window.frames, run.window.frames + MORE):
        port.entry(n)
    return cell, port, run


def test_a_number_once_the_record_holds_enough(extended):
    cell, port, run = extended
    more = MORE
    values = readings(longer(run, more))
    # No graph on the CPU: nothing to count.
    assert values.pop("bin_graph_nodes") is None
    assert all(isinstance(v, float) and v > 0 for v in values.values()), values
    rows = frame_record.frames(longer(run, more))
    assert len(rows) == run.window.frames + more - len(run.window.traced)


def test_the_traced_stretch_is_left_out(extended):
    cell, port, run = extended
    more = MORE
    frames = run.window.frames + more
    everything = frame_record.frames(dataclasses.replace(
        run, window=dataclasses.replace(run.window, frames=frames, traced=[])))
    assert len(everything) == frames
    stretch = list(range(frames - 12, frames - 7))
    rows = frame_record.frames(dataclasses.replace(
        run, window=dataclasses.replace(run.window, frames=frames, traced=stretch)))
    kept = {r["frame"] for r in rows}
    assert kept == {r["frame"] for r in everything[:-12] + everything[-7:]}
    # Rows from before the window are no frames of it.
    rows = frame_record.frames(dataclasses.replace(
        run, window=dataclasses.replace(run.window, frames=frames - 5, traced=[])))
    assert len(rows) == frames - 5


def test_a_port_without_the_record_gives_nothing(drift, monkeypatch):
    cell, port, run = drift
    monkeypatch.setattr(port_lib, "renderer", lambda config, device: object())
    assert readings(longer(run, frame_record.MIN_FRAMES + 10)) == dict.fromkeys(
        RECORD_METRICS)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_traced_run_reports_the_record_metrics(card):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "fills-1080p.drift",
         "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "1"],
        cwd=cell_mod.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    metrics = result["metrics"]
    assert set(RECORD_METRICS) <= set(metrics), sorted(metrics)
    assert metrics["bin_graph_nodes"]["value"] == int(metrics["bin_graph_nodes"]["value"])
    stages = sum(metrics[m]["value"] for m in STAGE_METRICS)
    assert 0 < stages <= 1.05 * metrics["bin_device_ms"]["value"]
