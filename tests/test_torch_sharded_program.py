"""The port's persistent sharded frame steps (``ShardedFrameProgram``,
``ShardedFrameProgram2D``) against ``render_sharded`` of the same
transforms, on a Mesh of the CPU repeated (tests/test_showcase.py's
program tests, on the port).  A file of its own, so that another worker
runs it beside test_torch_sharded.py."""

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.parallel import (
    ShardedFrameProgram,
    ShardedFrameProgram2D,
    render_sharded,
    render_sharded_2d,
)
from contrast_renderer_tpu_torch.renderer import Configuration, Renderer
from test_torch_instance import one_thread  # noqa: F401
from test_torch_sharded import CLIP_ALPHA, cpu_mesh, renderer

SIZE = 64
#: A program's frame against render_sharded of the same transforms
#: (tests/test_showcase.py's bar for the JAX package).
ATOL = 1e-6


@pytest.fixture(scope="module")
def shape():
    return showcase.build_shape(with_text=False)


def _rotor(angle):
    return np.array([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0])


def test_program_matches_render_sharded_under_motion(shape):
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:4]
    mesh = cpu_mesh()
    program = ShardedFrameProgram(renderer(), commands, mesh)
    for angle in (0.0, 0.2):
        moved = showcase.command_transforms(
            SIZE, SIZE, view_rotation=_rotor(angle))[:4]
        got = program(moved)
        assert isinstance(got, torch.Tensor) and got.shape == (SIZE, SIZE, 4)
        for c, t in zip(commands, moved):
            c.transform = t
        want = render_sharded(renderer(), commands, mesh)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        assert (want[..., 3] > 0).any()


def test_program_2d_matches_render_sharded_2d(shape):
    width, height = 256, 64
    commands = showcase.showcase_commands(shape, width, height)[:4]
    mesh = cpu_mesh((2, 2), ("y", "x"))
    program = ShardedFrameProgram2D(
        renderer(width=width, height=height), commands, mesh)
    want = render_sharded_2d(renderer(width=width, height=height), commands, mesh)
    np.testing.assert_allclose(program().numpy(), want, rtol=0, atol=ATOL)


def test_program_gathers_the_public_transform_layout(shape):
    """Rows of fused-away SAVE covers are dropped through keep_rows; a
    stack of the wrong length raises ValueError."""
    full = showcase.showcase_commands_clip_alpha(shape, SIZE, SIZE)
    commands = full[:8] + full[-3:]  # 11 commands, SAVE+SCALE at 4/5
    program = ShardedFrameProgram(renderer(Configuration(**CLIP_ALPHA)),
                                  commands, cpu_mesh())
    assert program._keep_rows is not None
    assert program._default_transform.shape[0] == len(commands) - 1
    stack = np.stack([np.asarray(c.transform, np.float32) for c in commands])
    assert torch.equal(program(stack), program())
    with pytest.raises(ValueError, match="transform rows"):
        program(stack[:-1])
    with pytest.raises(ValueError, match="transform rows"):
        program(np.concatenate([stack, stack[:1]]))


def test_program_heals_after_overflow(shape):
    """A scene that outgrows the settled capacities rebuilds with grown
    ones (FrameProgram's deferred contract) instead of raising."""
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:2]
    program = ShardedFrameProgram(renderer(), commands, cpu_mesh())
    want = program()
    program._sub.tile_capacity = 1
    program._build()
    assert program._limits[0] == 1
    program.OVERFLOW_MAX_LAG = 0
    program()  # overflows, possibly under-populated
    healed = program()
    assert program._sub.tile_capacity > 1
    np.testing.assert_allclose(healed.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_program_uint8_output(shape):
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:2]
    mesh = cpu_mesh()
    fprog = ShardedFrameProgram(renderer(), commands, mesh)
    uprog = ShardedFrameProgram(renderer(), commands, mesh, uint8_output=True)
    want = Renderer._quantize(fprog())
    got = uprog()
    assert got.dtype == torch.uint8 and got.shape == (SIZE, SIZE, 4)
    assert torch.equal(got, want)
