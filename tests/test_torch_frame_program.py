"""The port's FrameProgram against the port's own Renderer.render, on the
CPU: fused dispatch and the sequential walk give the same pixels, the
grouping follows the covers as they move, plan_for_motion, the sequence
renderer, carry, packed RGBA8, the animated blend constant, the row
check, deferred capacity growth, and two defects of the reference's
plan_for_motion that the port does not have (a variant reported that
does not exist, capacities sized on a sample of the frames)."""

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.path import Path
from contrast_renderer_tpu_torch.renderer import (
    BlendComponent,
    BlendState,
    Configuration,
    DrawCommand,
    FrameProgram,
    RenderOperation,
    Renderer,
    Shape,
)
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64


def translate(tx, ty, size=SIZE, scale=1.0):
    t = scenes.ortho(size, size)
    t[:2, :2] *= scale
    t[0, 3] += 2.0 * tx / size
    t[1, 3] += 2.0 * ty / size
    return t


def pairs(shape, offsets, colors=None, **kw):
    out = []
    for k, (dx, dy) in enumerate(offsets):
        t = translate(dx, dy, **kw)
        color = (1.0 - 0.2 * k, 0.2 * k, 0.3, 0.6) if colors is None else colors
        out += [
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(RenderOperation.COLOR, shape, t, color=color),
        ]
    return out


def circle(r=5.0):
    return Shape([Path.from_circle((r + 1.0, r + 1.0), r)])


def renderer(**kw):
    return Renderer(Configuration(**kw.pop("config", {})), SIZE, SIZE,
                    device="cpu", **kw)


def sequential(commands, size=SIZE, **config):
    return Renderer(Configuration(**config), size, size, auto_instance=False,
                    device="cpu").render(commands)


def stack(commands):
    return Renderer._pack_transforms(commands)


def test_fused_dispatch_matches_sequential_walk():
    """Three disjoint circles fuse into one instanced pair at build; the
    program's frame equals the walk of the six commands, and the image is
    a new tensor every call."""
    commands = pairs(circle(), [(0, 0), (20, 0), (40, 0)])
    program = renderer().compile_frame(commands)
    assert program._runs and program._plan is not None
    assert len(program._plan.commands) == 2
    first = program()
    assert program.stats["fused"]
    assert np.array_equal(first.numpy(), sequential(commands))
    second = program(stack(pairs(circle(), [(0, 10), (20, 0), (40, 0)])))
    assert first.data_ptr() != second.data_ptr()
    assert np.array_equal(first.numpy(), sequential(commands))


def test_regroups_when_covers_touch_and_back():
    """Covers slid onto each other: the plan stops holding, nothing fuses
    and the sequential walk renders; apart again, the cached grouping
    serves.  A partial overlap splits the run into (0,) + (1, 2), as the
    reference's test_partial_overlap_regroups_into_disjoint_groups has
    it: the first frame under it only counts the grouping, the second
    builds it, both walk in sequence, and from the third the same
    transforms dispatch fused."""
    shape = circle(7.0)
    commands = pairs(shape, [(0, 0), (40, 0)])
    program = renderer().compile_frame(commands)
    moved = pairs(shape, [(0, 0), (6, 4)])
    assert program._plan_transforms_if_valid(program._plan,
                                             stack(moved)) is None
    assert program._derive_plan(stack(moved)) is None
    assert np.array_equal(program(stack(moved)).numpy(), sequential(moved))
    assert program._plan is None and not program.stats["fused"]
    assert np.array_equal(program(stack(commands)).numpy(),
                          sequential(commands))
    assert program._plan is not None and program.stats["fused"]

    commands = pairs(shape, [(0, 0), (40, 0), (20, 20)])
    program = renderer().compile_frame(commands)
    moved = pairs(shape, [(0, 0), (6, 4), (40, 0)])
    sig = ((False, (0,), (1, 2)),)
    for count in (1, 2):
        assert np.array_equal(program(stack(moved)).numpy(),
                              sequential(moved))
        assert program._plan is None and not program.stats["fused"]
        assert program._sig_counts[sig] == count
    assert program.wait_fused_compiles(timeout=300.0)
    assert len(program._fused_variants) == 2
    assert np.array_equal(program(stack(moved)).numpy(), sequential(moved))
    assert program._plan.signature == sig and program.stats["fused"]


def test_mismatched_rows_and_translucent_overlap_never_fuse():
    """A stack whose cover row differs from its stencil row never fuses;
    overlapping translucent covers have no escape; one opaque colour
    fuses whole despite the overlap, pixel for pixel."""
    shape = circle()
    commands = pairs(shape, [(0, 0), (20, 0)])
    program = renderer().compile_frame(commands)
    rows = stack(commands).copy()
    rows[1, 0, 3] += 0.25
    assert program._plan_transforms_if_valid(program._plan, rows) is None
    assert program._derive_plan(rows) is None

    shape = circle(7.0)
    translucent = pairs(shape, [(0, 0), (6, 4)], colors=(0.2, 0.7, 0.9, 0.5))
    assert renderer().compile_frame(translucent)._plan is None
    opaque = pairs(shape, [(0, 0), (6, 4), (40, 0)],
                   colors=(0.2, 0.7, 0.9, 1.0))
    program = renderer().compile_frame(opaque)
    assert program._plan.signature == ((True, (0, 1, 2)),)
    assert np.array_equal(program().numpy(), sequential(opaque))


def test_plan_for_motion_excludes_colliding_pairs():
    """A pair that meets its group-mate in any frame of the motion leaves
    the group; the others still fuse, and both frames are exact."""
    shape = circle(7.0)
    commands = pairs(shape, [(0, 0), (40, 0), (20, 28)])
    near = pairs(shape, [(0, 0), (6, 4), (20, 28)])
    program = renderer().compile_frame(commands)
    assert program.plan_for_motion([stack(commands), stack(near)])
    assert program._plan.signature == ((False, (0,), (1, 2)),)
    for frame in (near, commands):
        assert np.array_equal(program(stack(frame)).numpy(),
                              sequential(frame))
        assert program.stats["fused"]


def test_near_plane_frame_matches_sequential_walk():
    """A circle whose hull crosses the near plane fuses when its clipped
    cover is apart from the others; the frame equals the walk's."""
    commands = pairs(circle(), [(0, 0), (24, 0), (48, 0)])
    crossing = np.array([[0.02, 0, 0, 0], [0, 0.02, 0, 0], [0, 0, 0, 0],
                         [0, 0.1, 0, -0.5]], np.float32)
    frame = [c for c in commands]
    for i in (0, 1):
        frame[i] = DrawCommand(frame[i].operation, frame[i].shape, crossing,
                               color=frame[i].color)
    program = renderer().compile_frame(commands)
    assert program.plan_for_motion([stack(commands), stack(frame)])
    image = program(stack(frame))
    assert program.stats["fused"]
    assert np.array_equal(image.numpy(), sequential(frame))


def count_calls(variant):
    calls = []
    inner = variant.rasterize
    variant.rasterize = lambda *a: calls.append(1) or inner(*a)
    return calls


def test_render_sequence_matches_calls_and_falls_back():
    """A segment the active plan holds on renders fused; one frame that
    breaks it sends the whole segment down the sequential walk.  Frames
    equal per-frame calls, float and uint8."""
    shape = circle(7.0)
    commands = pairs(shape, [(0, 0), (40, 0)])
    program = renderer().compile_frame(commands)
    fused = count_calls(program._fused_variants[
        program._plan.signature][1])
    walked = count_calls(program._seq)
    apart = [stack(pairs(shape, [(0, dy), (40, 0)])) for dy in (0, 4, 8)]
    frames = program.render_sequence(np.stack(apart), as_uint8=False)
    assert frames.shape == (3, SIZE, SIZE, 4) and len(fused) == 3
    for got, t in zip(frames, apart):
        assert torch.equal(got, program(t))
    packed = program.render_sequence(np.stack(apart))
    assert packed.dtype == torch.uint8
    assert torch.equal(packed[1], Renderer._quantize(frames[1]))
    walked.clear()
    broken = apart[:2] + [stack(pairs(shape, [(0, 0), (6, 4)]))]
    frames = program.render_sequence(np.stack(broken), as_uint8=False)
    assert len(walked) == 3
    for got, t in zip(frames, broken):
        want = sequential([
            DrawCommand(c.operation, c.shape, m, color=c.color)
            for c, m in zip(commands, t)
        ])
        assert np.array_equal(got.numpy(), want)


def test_carry_and_packed_output():
    """carry adds the frame's alpha sum and chains; uint8_output equals
    the float frame quantized."""
    commands = pairs(circle(), [(0, 0), (20, 0), (40, 10)])
    program = renderer().compile_frame(commands)
    image = program()
    acc = torch.zeros(())
    for _ in range(3):
        out, acc = program(carry=acc)
    assert torch.equal(out, image)
    assert np.isclose(float(acc), 3 * float(image[..., 3].double().sum()),
                      rtol=1e-6)
    packed = renderer().compile_frame(commands, uint8_output=True)
    got = packed()
    assert got.dtype == torch.uint8 and got.shape == (SIZE, SIZE, 4)
    assert torch.equal(got, Renderer._quantize(image))
    _, acc8 = packed(carry=0.5)
    assert np.isclose(float(acc8), 0.5 + float(got[..., 3].double().sum()))


def test_blend_constant_animates_without_rebuild():
    """A state that reads the blend constant: each new constant renders
    as Renderer.render does with it, and the program is built once."""
    state = BlendState(
        color=BlendComponent("constant", "add", "one_minus_src_alpha"),
        alpha=BlendComponent("one", "add", "one_minus_src_alpha"),
    )
    commands = pairs(circle(), [(0, 0), (20, 0), (40, 10)])
    r = renderer(config={"blending": state})
    program = r.compile_frame(commands)
    walk = Renderer(Configuration(blending=state), SIZE, SIZE,
                    auto_instance=False, device="cpu")
    images = []
    for constant in ((0.25, 0.5, 0.75, 0.5), (1.0, 0.0, 0.0, 1.0)):
        r.set_blend_constant(constant)
        walk.set_blend_constant(constant)
        images.append(program().numpy())
        assert np.array_equal(images[-1], walk.render(commands))
    assert not np.array_equal(*images)
    assert program.builds == 1


def test_wrong_row_count_raises():
    commands = pairs(circle(), [(0, 0), (20, 0)])
    program = renderer().compile_frame(commands)
    rows = stack(commands)
    with pytest.raises(ValueError, match="expected 4 transform rows"):
        program(rows[:3])
    with pytest.raises(ValueError, match="expected 4 transform rows"):
        program(np.concatenate([rows, rows[:1]]))
    with pytest.raises(ValueError, match="per frame"):
        program.render_sequence(rows[None, :3])
    with pytest.raises(ValueError, match="expected 4 transform rows"):
        program.plan_for_motion([rows[:2]])


def nested_circles():
    """tests/test_coverage_exec.py's 20 nested circles, in 20 colours."""
    commands = []
    t = scenes.ortho(SIZE, SIZE)
    for i in range(20):
        s = Shape([Path.from_circle((32.0, 32.0), 28.0 - i)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t,
                        color=(i / 20, 1 - i / 20, 0.5, 1.0)),
        ]
    return commands


def test_shrunk_capacity_self_heals():
    """Capacities shrunk below what the frame bins: the overflow read a
    frame later grows them (x2 headroom) and rebuilds the program within
    OVERFLOW_MAX_LAG frames, and the frame is then exact."""
    commands = nested_circles()
    program = renderer(strict_capacity=False).compile_frame(commands)
    program._caps["capacity"] = 8
    program._build()
    builds = program.builds
    want = sequential(commands)
    images = []
    for _ in range(FrameProgram.OVERFLOW_MAX_LAG):
        images.append(program().numpy())
        if program.builds > builds:
            break
    # On the CPU the counters are read on the next call.
    assert program.builds == builds + 1 and len(images) == 2
    assert program._caps["capacity"] > 8
    assert not np.array_equal(images[0], want)
    assert np.array_equal(images[-1], want)


def test_plan_for_motion_false_when_no_variant_can_be_installed():
    """With no room for a fused variant, plan_for_motion says False and
    leaves the active plan as it was (the reference's could report a
    compile that never ran)."""
    shape = circle(7.0)
    commands = pairs(shape, [(0, 0), (40, 0), (20, 28)])
    near = pairs(shape, [(0, 0), (6, 4), (20, 28)])
    program = renderer().compile_frame(commands)
    plan = program._plan
    program.MAX_FUSED_VARIANTS = 0
    assert program.plan_for_motion([stack(commands), stack(near)]) is False
    assert program._plan is plan and len(program._fused_variants) == 1
    assert program.plan_for_motion([stack(commands)]) is True
    del program.MAX_FUSED_VARIANTS
    assert program.plan_for_motion([stack(commands), stack(near)]) is True
    assert program._plan.signature in program._fused_variants


def test_scout_sizes_every_frame_of_a_long_motion():
    """A motion of 257 frames whose one heavy frame (all four instances
    shrunk into one tile) has an odd index: the reference's scout takes
    every second frame past 128 and misses it.  Here the capacities fit
    it: the frame bins without overflow, rebuilds nothing, and equals the
    sequential walk."""
    size = 256
    dots = Shape([
        Path.from_circle((8.0 + 16.0 * (i % 6), 8.0 + 16.0 * (i // 6)), 6.0)
        for i in range(36)
    ])
    offsets = [(0, 0), (128, 0), (0, 128), (128, 128)]
    light = pairs(dots, offsets, size=size)
    heavy = pairs(dots, [(x / 8 + 40, y / 8 + 40) for x, y in offsets],
                  size=size, scale=1 / 8)
    r = Renderer(Configuration(), size, size, device="cpu")
    program = r.compile_frame(light)
    strict = Renderer(Configuration(), size, size, auto_instance=False,
                      device="cpu")
    want = strict.render(heavy)
    need = strict.stats["max_tile_entries"]
    assert need > program._caps["capacity"]
    motion = [stack(light)] * 257
    motion[1] = stack(heavy)
    assert program.plan_for_motion(motion)
    assert program._caps["capacity"] >= need
    builds = program.builds
    variant, runtime = program._bin(program._opt_rows(stack(heavy)))
    assert int(runtime[0].overflow[0]) <= program._caps["capacity"]
    assert np.array_equal(program(stack(heavy)).numpy(), want)
    program(stack(heavy))
    assert program.builds == builds
