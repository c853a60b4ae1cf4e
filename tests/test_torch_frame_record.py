"""The port's frame record (utils/profiling.py) on the CPU: a
FrameProgram frame's five host spans tile its call, binning's five stage
marks come in order inside its replay, ``stats`` and ``timing`` keep
their keys and sums, builds and forced overflow waits show where they
happen, the record keeps the last RECORD_FRAMES frames, ranges are
entered under torch.profiler and never without it, and binning's
outputs are the same to the bit with the marks in."""

import time

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.path import Path
from contrast_renderer_tpu_torch.renderer import (
    Configuration,
    DrawCommand,
    FrameProgram,
    RenderOperation,
    Renderer,
    Shape,
)
from contrast_renderer_tpu_torch.utils import profiling
from contrast_renderer_tpu_torch.utils.profiling import (
    MARKS,
    RECORD,
    RECORD_FRAMES,
    STAGES,
)
from test_torch_frame_program import circle, nested_circles, pairs, stack
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64
SPANS = ["upkeep", "plan", "stage", "replay", "out"]


def program_of(commands, **kw):
    return Renderer(Configuration(), SIZE, SIZE, device="cpu",
                    **kw).compile_frame(commands)


def last_row(program_or_name):
    name = getattr(program_or_name, "_name", program_or_name)
    return [r for r in RECORD.rows() if r["program"] == name][-1]


@pytest.fixture(scope="module")
def fused():
    """Three disjoint circles, one fused pair: (program, commands)."""
    commands = pairs(circle(), [(0, 0), (20, 0), (40, 0)])
    return program_of(commands), commands


def test_host_spans_tile_the_call(fused):
    program, _ = fused
    before = time.perf_counter_ns()
    program()
    after = time.perf_counter_ns()
    row = last_row(program)
    assert row["kind"] == "FrameProgram" and row["span_names"] == SPANS
    ns = row["span_ns"]
    assert len(ns) == len(SPANS) + 1
    assert before <= ns[0] and ns[-1] <= after
    assert all(a <= b for a, b in zip(ns, ns[1:]))
    assert sum(row["spans_ms"].values()) == pytest.approx(
        (ns[-1] - ns[0]) / 1e6)


def test_stage_marks_come_in_order_inside_replay(fused):
    program, _ = fused
    program()
    row = last_row(program)
    assert len(row["marks_ns"]) == 1 and len(row["marks_ns"][0]) == MARKS
    marks = row["marks_ns"][0]
    ns = row["span_ns"]
    replay = row["span_names"].index("replay")
    assert ns[replay] <= marks[0]
    assert all(a <= b for a, b in zip(marks, marks[1:]))
    assert marks[-1] <= ns[replay + 1]
    assert list(row["stages_ms"]) == list(STAGES)
    assert sum(row["stages_ms"].values()) == pytest.approx(
        (marks[-1] - marks[0]) / 1e6)
    # No graph on the CPU, so no nodes.
    assert row["graph_nodes"] is None and row["stage_nodes"] is None


def test_stats_and_timing_keep_their_keys_and_sums(fused):
    program, commands = fused
    program()
    row = last_row(program)
    spans = row["spans_ms"]
    assert set(program.stats) == {"fused", "plan_ms", "bin_ms", "raster_ms"}
    assert program.stats["plan_ms"] == pytest.approx(spans["plan"])
    assert program.stats["bin_ms"] == pytest.approx(
        spans["stage"] + spans["replay"])
    assert program.stats["raster_ms"] == pytest.approx(spans["out"])
    renderer = Renderer(Configuration(), SIZE, SIZE, device="cpu")
    renderer.render(commands)
    row = last_row(renderer._name)
    assert row["kind"] == "Renderer.prepare"
    assert set(row["span_names"]) == {"pack", "lookup", "step", "store"}
    assert set(renderer.timing) == {"bin_ms", "prepare_ms"}
    assert renderer.timing["bin_ms"] == pytest.approx(row["spans_ms"]["step"])
    assert renderer.timing["prepare_ms"] == pytest.approx(
        sum(row["spans_ms"].values()))
    renderer.render(commands)
    row = last_row(renderer._name)
    assert "step" not in row["spans_ms"] and renderer.timing["bin_ms"] == 0.0


def test_fused_and_sequential_frames_count(fused):
    """Each call is one row of the record, its five spans and one
    binning's marks, fused or not; a sequence is one row with a binning
    a frame."""
    program, _ = fused
    moved = stack(pairs(circle(), [(0, 0), (3, 2), (40, 0)]))
    apart = stack(pairs(circle(), [(0, 0), (20, 0), (40, 0)]))

    def rows():
        return [r for r in RECORD.rows() if r["program"] == program._name]

    before = len(rows())
    program()
    assert program.stats["fused"]
    program(moved)
    assert not program.stats["fused"]
    new = rows()[before:]
    assert len(new) == 2
    for row in new:
        assert row["kind"] == "FrameProgram" and row["span_names"] == SPANS
        assert len(row["marks_ns"]) == 1
    # The plan active again, a sequence under it renders fused.
    program(apart)
    program.render_sequence(np.stack([apart] * 3))
    assert len(rows()) == before + 4
    assert last_row(program)["kind"] == "FrameProgram.render_sequence"
    assert last_row(program)["span_names"] == SPANS
    assert len(last_row(program)["marks_ns"]) == 3


def test_capacity_growth_counts_a_build():
    program = program_of(nested_circles(), strict_capacity=False)
    program._caps["capacity"] = 8
    program._build()
    builds = program.builds
    program()
    assert program.builds == builds
    program()
    # On the CPU the counters are read on the next call, inside its
    # upkeep span.
    assert program.builds == builds + 1
    assert last_row(program)["span_names"] == SPANS


def test_geometry_edit_counts_a_build():
    """An edit of the same padded size drops the graphs and builds
    nothing; one that outgrows it builds the program once."""
    shape = circle(7.0)
    program = program_of(pairs(shape, [(0, 0), (40, 0)]))
    program()
    builds, pool = program.builds, program._pool
    shape.update_paths([Path.from_circle((8.0, 8.0), 6.0)])
    program()
    assert program.builds == builds and program._pool is not pool
    shape.update_paths([Path.from_circle((8.0, 8.0), 6.0),
                        Path.from_circle((8.0, 8.0), 3.0)])
    program()
    assert program.builds == builds + 1
    program()
    assert program.builds == builds + 1


class SlowEvent:
    """A deferred counter's event that has not passed: its wait is
    forced at OVERFLOW_MAX_LAG frames, and takes WAIT_S."""

    WAIT_S = 0.02

    def __init__(self):
        self.waited = False

    def query(self):
        return False

    def synchronize(self):
        time.sleep(self.WAIT_S)
        self.waited = True


def test_forced_overflow_wait_at_max_lag(fused):
    """The forced wait falls in the frame's upkeep span, which
    frame_upkeep_ms reads, and in no span of ``stats``."""
    program, _ = fused
    event = SlowEvent()
    program._pending.append((torch.zeros(4, dtype=torch.int32), event,
                             program._frame))
    for _ in range(FrameProgram.OVERFLOW_MAX_LAG - 1):
        program()
    assert not event.waited
    program()
    assert event.waited
    row = last_row(program)
    assert row["spans_ms"]["upkeep"] >= 1e3 * SlowEvent.WAIT_S
    assert sum(program.stats[k] for k in ("plan_ms", "bin_ms", "raster_ms")) == (
        pytest.approx(sum(row["spans_ms"].values()) - row["spans_ms"]["upkeep"]))


def test_marks_are_named_by_stage():
    """A binning's marks go by stage name, END last, into its row; a name
    that is no stage is refused."""
    ring = RECORD.ring("cpu")
    frame = RECORD.begin("named marks", "test", "test", "bin")
    for name in (*STAGES, profiling.END):
        ring.mark(name)
    frame.end()
    row = last_row("named marks")
    assert len(row["marks_ns"]) == 1 and len(row["marks_ns"][0]) == MARKS
    assert list(row["stages_ms"]) == list(STAGES)
    with pytest.raises(KeyError):
        ring.mark("sort")


def test_the_record_keeps_the_last_frames():
    ring = RECORD.ring("cpu")
    first = None
    for _ in range(RECORD_FRAMES + 9):
        frame = RECORD.begin("record test", "test", "test", "bin")
        for name in (*STAGES, profiling.END):
            ring.mark(name)
        frame.end()
        first = frame.index if first is None else first
    rows = RECORD.rows()
    assert len(rows) == RECORD_FRAMES
    assert [r["frame"] for r in rows] == list(
        range(first + 9, first + 9 + RECORD_FRAMES))
    assert all(r["marks_ns"] is not None and len(r["marks_ns"]) == 1 for r in rows)


def test_no_range_without_the_profiler(fused, monkeypatch):
    program, commands = fused
    entered = []
    real = profiling._autograd_profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", counting)
    program()
    Renderer(Configuration(), SIZE, SIZE, device="cpu").render(commands)
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program()
        Renderer(Configuration(), SIZE, SIZE, device="cpu").render(commands)
    names = {e.name for e in prof.events()}
    assert {f"FrameProgram.{s}" for s in SPANS} <= names
    assert {"Renderer.prepare.pack", "Renderer.prepare.lookup",
            "Renderer.prepare.step", "Renderer.prepare.store"} <= names
    assert sorted(set(entered)) == sorted(
        {f"FrameProgram.{s}" for s in SPANS}
        | {f"Renderer.prepare.{s}" for s in ("pack", "lookup", "step", "store")})


class NoMarks:
    def mark(self, name):
        pass


@pytest.mark.parametrize("scene", ["fills", "strokes"])
def test_binning_is_the_same_with_the_marks_in(scene, monkeypatch):
    if scene == "fills":
        commands = nested_circles()
    else:
        commands = scenes.stroke_over_fill(SIZE)
        commands.append(DrawCommand(
            RenderOperation.STENCIL, Shape([Path.from_circle((20.0, 30.0), 9.0)]),
            scenes.ortho(SIZE, SIZE)))
    program = program_of(commands)
    variant, runtime = program._bin(program._opt_rows(None))
    args = (*program._scene.arrays, torch.as_tensor(program._opt_rows(None)),
            torch.as_tensor(program._descriptors()["static"]), variant.paints)
    binnings = RECORD.ring("cpu").binnings
    marked = variant.prepare(*args)
    assert RECORD.ring("cpu").binnings == binnings + 1
    monkeypatch.setattr(profiling.RECORD, "ring", lambda device: NoMarks())
    plain = coverage.make_prepare(variant.spec)(*args)
    for name, a, b in zip(coverage.PreparedFrame._fields, marked, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(runtime[0], marked):
        assert torch.equal(a, b)
