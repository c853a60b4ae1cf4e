"""The comparison that decides ``correct`` fails what it must: the
control (the reference computed in bfloat16 in the port's place) and a
run whose timed path is broken underneath.  These run the port's plain
CPU path at small sizes, with the harness's look for a card skipped."""

import pytest
import torch

from port_bench.harness import cell as cell_mod
from port_bench.harness import check

SMALL = {"width": 320, "height": 240}
WORKLOADS = [w["name"] for w in cell_mod.json.loads(
    (cell_mod.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    cell = cell_mod.load_cell(workload, config_overrides=SMALL,
                              traffic_overrides={"path_frames": 3})
    ref = cell_mod.reference_scene(cell)
    stacks = cell_mod.stacks_of(cell)
    limit = cell.config["check"]["off_share"]
    for seed in (1, 2**31 + 11, 2**40 + 3):
        schedule = cell.schedule(seed)
        high = cell_mod.reference_frame(cell, ref, schedule, stacks, 1, torch.float64, "cpu")
        low = cell_mod.reference_frame(cell, ref, schedule, stacks, 1, torch.bfloat16, "cpu")
        share = check.off_share(low, high, cell.config["check"]["channel_tolerance"])
        assert (high[..., 3] > 0).float().mean() > 0.05
        assert share > 3 * limit


@pytest.fixture(scope="module")
def drift():
    """The fill cell's timed path at 160 x 120 on the port's plain CPU
    path (the stroke cell's takes seconds a frame there)."""
    cell = cell_mod.load_cell(
        "fills-1080p.drift", config_overrides={"width": 160, "height": 120},
        traffic_overrides={"path_frames": 3, "check_frames": 2, "warm_cycles": 1})
    return cell, cell_mod.set_up(cell, 5, "cpu")


def judged(cell, port, seed, fault):
    # The plain CPU path takes seconds a frame: a window of two or three.
    run = cell_mod.measure(cell, port, seed, 12.0, False, 0.0, "cpu", fault)
    assert run.window.frames >= 2
    correct, checks, failed = cell_mod.compare(cell, run, "cpu")
    return correct, checks, failed


def altered(entry):
    """A frame altered where it is produced: its top quarter of rows
    written black."""
    def issue(n):
        frame = entry(n).clone()
        frame[: frame.shape[0] // 4] = 0
        return frame
    return issue


def stale(entry):
    """A step that hands out its previous frame: the state not moved."""
    last = {}

    def issue(n):
        frame = entry(n)
        out = last.get("frame", frame)
        last["frame"] = frame
        return out
    return issue


def test_sound_run_is_correct(drift):
    correct, checks, failed = judged(*drift, 2**31 + 5, None)
    assert correct and failed == 0, checks


@pytest.mark.parametrize("fault", [altered, stale], ids=["altered", "stale"])
def test_broken_timed_path_is_not_correct(drift, fault):
    correct, checks, failed = judged(*drift, 2**31 + 5, fault)
    assert not correct and failed >= 1, checks
