"""FrameProgram's compile hysteresis and plan_for_motion's graph scout on
the CPU: a rebuild forgets the counts, MAX_FUSED_VARIANTS stops the
counting, the eager checks of a frame derive nothing, plan_for_motion
takes the reference's ``wait`` and ``timeout``, and the scout through a
binning step sizes the capacities as the eager scout does."""

import numpy as np
import torch

from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.renderer import FrameProgram
from test_torch_frame_program import (
    Path,
    Shape,
    circle,
    pairs,
    renderer,
    sequential,
    stack,
)
from test_torch_instance import one_thread  # noqa: F401

#: The three circles of test_regroups_when_covers_touch_and_back, as
#: built, and moved so that the second overlaps the first.
SHAPE = circle(7.0)
APART = pairs(SHAPE, [(0, 0), (40, 0), (20, 20)])
MOVED = pairs(SHAPE, [(0, 0), (6, 4), (40, 0)])
THIRD = pairs(SHAPE, [(0, 0), (40, 0), (44, 4)])
SPLIT = ((False, (0,), (1, 2)),)


def walk(program, commands, frames=1):
    """``frames`` frames of ``commands``, each equal to the sequential
    walk's and walked in sequence."""
    for _ in range(frames):
        assert np.array_equal(program(stack(commands)).numpy(),
                              sequential(commands))
        assert not program.stats["fused"]


def test_rebuild_forgets_the_counts():
    """A _build() after one derivation of the split empties the counts
    and the groupings built since: the split has to be derived twice
    again before it is built."""
    program = renderer().compile_frame(APART)
    walk(program, MOVED)
    assert program._sig_counts == {SPLIT: 1}
    program._build()
    assert not program._sig_counts and len(program._fused_variants) == 1
    walk(program, MOVED)
    assert program._sig_counts == {SPLIT: 1}
    assert SPLIT not in program._fused_variants
    walk(program, MOVED)
    assert SPLIT in program._fused_variants
    assert np.array_equal(program(stack(MOVED)).numpy(), sequential(MOVED))
    assert program.stats["fused"] and program._plan.signature == SPLIT


def test_max_fused_variants_stops_the_counting():
    """With room for two fused variants, the one built with the program
    and the split fill it: a third grouping is neither counted nor built,
    and its frames walk in sequence."""
    program = renderer().compile_frame(APART)
    program.MAX_FUSED_VARIANTS = 2
    walk(program, MOVED, frames=2)
    assert len(program._fused_variants) == 2
    other = program._derive_plan(stack(THIRD))
    assert other is not None and other.signature not in program._fused_variants
    walk(program, THIRD, frames=3)
    assert other.signature not in program._sig_counts
    assert len(program._fused_variants) == 2


def test_eager_check_derives_nothing():
    """_bin on a frame no cached grouping holds chooses the sequential
    walk and leaves the counts as they were; after the frames that build
    the split, it chooses the split as a frame would."""
    program = renderer().compile_frame(APART)
    rows = program._opt_rows(stack(MOVED))
    for _ in range(2):
        variant, _ = program._bin(rows)
        assert variant is program._seq and not program._sig_counts
    walk(program, MOVED, frames=2)
    variant, runtime = program._bin(rows)
    assert variant is program._fused_variants[SPLIT][1]
    assert program._sig_counts == {SPLIT: 2}
    image = variant.rasterize(*runtime)
    assert np.array_equal(image.numpy(), sequential(MOVED))


def test_plan_for_motion_takes_the_reference_keywords():
    """plan_for_motion(..., wait=False, timeout=...) as the reference
    takes it: True, the plan built and active at return, so that
    wait_fused_compiles(timeout=0.05) is True at once and the motion's
    first frame is fused."""
    program = renderer().compile_frame(APART)
    motion = [stack(APART), stack(MOVED)]
    assert program.plan_for_motion(motion, wait=False, timeout=1.0) is True
    assert program._plan.signature in program._fused_variants
    assert program.wait_fused_compiles(timeout=0.05) is True
    assert np.array_equal(program(stack(MOVED)).numpy(), sequential(MOVED))
    assert program.stats["fused"]
    assert program.plan_for_motion(motion, wait=True, timeout=1.0) is True


def eager_scout(self, plan, stacks, desc_static, paints):
    """The scout before the binning step: the spec's prepare on every
    frame, outside any step."""
    prepare = coverage.make_prepare(self._variant_spec(plan.commands))
    worst = None
    for t in stacks:
        overflow = prepare(
            *self._scene.arrays,
            torch.as_tensor(np.ascontiguousarray(t[plan.gather])),
            desc_static, paints,
        ).overflow
        worst = overflow if worst is None else torch.maximum(worst, overflow)
    return worst.numpy()


def test_step_scout_sizes_as_the_eager_scout(monkeypatch):
    """test_scout_sizes_every_frame_of_a_long_motion's 257 frames, one of
    them heavy: plan_for_motion through the binning step and through the
    eager scout, each on a program of its own, give the same plan and
    capacities, and a round's binning through the step equals the eager
    one on the heavy frame."""
    size = 256
    dots = Shape([
        Path.from_circle((8.0 + 16.0 * (i % 6), 8.0 + 16.0 * (i // 6)), 6.0)
        for i in range(36)
    ])
    offsets = [(0, 0), (128, 0), (0, 128), (128, 128)]
    light = pairs(dots, offsets, size=size)
    heavy = pairs(dots, [(x / 8 + 40, y / 8 + 40) for x, y in offsets],
                  size=size, scale=1 / 8)
    motion = [stack(light)] * 257
    motion[1] = stack(heavy)
    seen = {}
    for name in ("step", "eager"):
        program = port.Renderer(port.Configuration(), size, size,
                                device="cpu").compile_frame(light)
        with monkeypatch.context() as m:
            if name == "eager":
                m.setattr(FrameProgram, "_scout", eager_scout)
            assert program.plan_for_motion(motion)
        seen[name] = (program._plan.signature, dict(program._caps))
        plan = program._plan
        rounds = [
            scout(program, plan, [program._opt_rows(stack(heavy))],
                  torch.as_tensor(program._descriptors()["static"]),
                  program._device_paints(plan.commands))
            for scout in (FrameProgram._scout, eager_scout)
        ]
        assert np.array_equal(*rounds)
    assert seen["step"] == seen["eager"]
    assert seen["step"][1]["capacity"] > 8
