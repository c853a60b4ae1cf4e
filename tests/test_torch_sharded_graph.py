"""The sharded programs' per-rect steps, on the CPU.

On a CUDA device each rect of a ``ShardedFrameProgram`` or
``ShardedFrameProgram2D`` renders through a step of its own
(``renderer._FrameStep``, binning and raster): warmed up by the rect's
first frame, captured as a CUDA graph by its second, replayed after
that; on the CPU the same step objects run eagerly on their own
buffers.  Here, on a Mesh of the CPU repeated: moved frames through the
steps against the eager sharded frame of the same transforms
(``mesh._run_grid``), float and packed RGBA8, bands and a 2×2 grid;
returned frames that later frames leave alone; one band of a moved
frame against the JAX package's ``Renderer`` at band size under its own
``band_adjusted_transform`` (one reference render, its kernel in
interpret mode); and a rebuild that drops every step."""

import dataclasses

import numpy as np
import pytest
import torch

from contrast_renderer_tpu import renderer as ref_renderer
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu.parallel import mesh as ref_mesh
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.parallel import (
    ShardedFrameProgram,
    ShardedFrameProgram2D,
)
from contrast_renderer_tpu_torch.parallel import mesh as mesh_module
from contrast_renderer_tpu_torch.renderer import Renderer
from test_torch_instance import one_thread  # noqa: F401
from test_torch_sharded import BAND, BANDS, cpu_mesh, renderer

SIZE = 64
#: The showcase's first commands (two instances, stencil and colour).
COMMANDS = 4
#: Camera angles about the y axis of the moved frames, in radians.
ANGLES = (0.0, 0.15, 0.3)


@pytest.fixture(scope="module")
def shape():
    return showcase.build_shape(with_text=False)


def moved_stack(api_showcase, angle, width=SIZE, height=SIZE):
    rotor = np.array([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0])
    return api_showcase.command_transforms(
        width, height, view_rotation=rotor)[:COMMANDS]


def sharded_program(shape, grid, uint8_output=False):
    """The band program ("bands") or the 2x2 program ("2x2") of the
    showcase's first COMMANDS commands, and its frame width."""
    if grid == "bands":
        return ShardedFrameProgram(
            renderer(), showcase.showcase_commands(shape, SIZE, SIZE)[:COMMANDS],
            cpu_mesh(), uint8_output=uint8_output), SIZE
    width = 2 * SIZE
    return ShardedFrameProgram2D(
        renderer(width=width),
        showcase.showcase_commands(shape, width, SIZE)[:COMMANDS],
        cpu_mesh((2, 2), ("y", "x")), uint8_output=uint8_output), width


@pytest.mark.parametrize("grid, uint8_output",
                         [("bands", False), ("2x2", False), ("bands", True)])
def test_rect_steps_equal_eager_frames(shape, grid, uint8_output):
    """The program's moved frames through its per-rect steps equal the
    eager sharded frame of the same transforms to the bit; each rect
    keeps one step over the frames; every returned frame is a tensor of
    its own, unchanged by later frames."""
    program, width = sharded_program(shape, grid, uint8_output)
    frames, kept, steps = [], [], None
    for angle in ANGLES:
        stack = moved_stack(showcase, angle, width)
        got = program(stack)
        want, _ = mesh_module._run_grid(
            program._pipeline, program._grid, program._rows(stack))
        assert torch.equal(got, want), angle
        if steps is None:
            steps = dict(program._steps)
        frames.append(got)
        kept.append(got.clone())
    assert len(steps) == len(program._grid.devices) == 4
    assert all(program._steps[c] is s for c, s in steps.items())
    own = {s.frame.data_ptr() for s in steps.values()}
    for f, k in zip(frames, kept):
        assert f.data_ptr() not in own and torch.equal(f, k)
    assert not torch.equal(frames[0], frames[-1])
    assert got.dtype == (torch.uint8 if uint8_output else torch.float32)
    assert len(program.stats["rect_ms"]) == 4
    assert program.stats["capture_ms"] == [None] * 4


def test_band_of_moved_frame_equals_reference_renderer(shape):
    """Band BAND of a moved frame through the band program's steps
    against the JAX Renderer at band size, its commands under the moved
    transforms and the JAX package's band_adjusted_transform, RGBA8,
    to the bit."""
    angle = ANGLES[2]
    height = SIZE // BANDS
    program, _ = sharded_program(shape, "bands", uint8_output=True)
    program(moved_stack(showcase, ANGLES[1]))
    got = program(moved_stack(showcase, angle)).numpy()
    got = got[BAND * height:(BAND + 1) * height]
    ref_shape = ref_showcase.build_shape(with_text=False)
    ref_commands = [
        dataclasses.replace(c, transform=np.asarray(
            ref_mesh.band_adjusted_transform(t, BAND, BANDS)))
        for c, t in zip(
            ref_showcase.showcase_commands(ref_shape, SIZE, SIZE)[:COMMANDS],
            moved_stack(ref_showcase, angle))
    ]
    want = ref_renderer.Renderer(
        ref_renderer.Configuration(), SIZE, height, tile_size=16,
        interpret=True,
    ).render(ref_commands, as_uint8=True)
    assert got.shape == want.shape == (height, SIZE, 4)
    assert np.array_equal(got, want)
    assert (want[..., 3] > 0).any()


def test_rebuild_drops_rect_steps(shape):
    """A rebuild (what a capacity growth runs) drops every rect's step;
    the next frame makes new ones and equals the eager frame."""
    program, _ = sharded_program(shape, "bands")
    stack = moved_stack(showcase, ANGLES[1])
    program(stack)
    old = dict(program._steps)
    assert len(old) == 4
    program._build()
    assert not program._steps
    got = program(stack)
    assert all(program._steps[c] is not s for c, s in old.items())
    want, _ = mesh_module._run_grid(
        program._pipeline, program._grid, program._rows(stack))
    assert torch.equal(got, want)
    assert torch.equal(Renderer._quantize(got), Renderer._quantize(want))
