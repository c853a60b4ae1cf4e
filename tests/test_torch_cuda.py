"""The CUDA raster kernel on the card: held against its plain torch
version across sample counts, strip layouts, output modes and blend
states, and the whole slice on the card against the slice on the CPU.

Needs a CUDA device and the CUDA toolkit; skips without them.  The
file imports no jax, so on a machine without jax run it without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from contrast_renderer_tpu.path import Path
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.renderer import (
    BlendComponent,
    BlendState,
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)

pytestmark = pytest.mark.cuda
# The scene keeps to the left 256 columns, so the right tiles are empty.
SIZE = 256
WIDTH, HEIGHT = 384, 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def frame_commands():
    """Bézier fills, an instanced circle with per-instance colors, and a
    command at a nonzero clip depth (a no-op without clip commands)."""
    fills = Shape(scenes.bezier_fill_paths(
        120, SIZE, SIZE, seed=3, margin=10.0, radius=(4.0, 24.0)
    ))
    circle = Shape([Path.from_circle((0, 0), 30)])
    t = scenes.ortho(WIDTH, HEIGHT)
    moves = np.stack([t.copy() for _ in range(3)])
    for i, (x, y) in enumerate([(60, 60), (150, 90), (100, 200)]):
        moves[i, 0, 3] += 2.0 * x / WIDTH
        moves[i, 1, 3] += 2.0 * y / HEIGHT
    colors = np.array(
        [[0.1, 0.6, 0.8, 0.6], [0.8, 0.2, 0.3, 0.9], [0.3, 0.9, 0.2, 0.4]],
        np.float32,
    )
    return [
        DrawCommand(RenderOperation.STENCIL, fills, t),
        DrawCommand(RenderOperation.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)),
        DrawCommand(RenderOperation.STENCIL, circle, moves),
        DrawCommand(RenderOperation.COLOR, circle, moves, color=colors),
        DrawCommand(RenderOperation.STENCIL, fills, t, clip_depth=1),
    ]


CONSTANT_BLEND = BlendState(
    BlendComponent("constant", "add", "one_minus_src_alpha"),
    BlendComponent("src_alpha_saturated", "reverse_subtract", "one"),
)


@pytest.mark.parametrize("samples", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("strips", [1, 2])
@pytest.mark.parametrize(
    "blending", ["back_to_front", "front_to_back", "additive", CONSTANT_BLEND],
    ids=["over", "front_to_back", "additive", "constant"],
)
def test_kernel_matches_plain(card, samples, strips, blending):
    """Float output bit for bit (both round every step in the same
    order); packed RGBA8 identical."""
    renderer = Renderer(
        Configuration(msaa_sample_count=samples, blending=blending),
        WIDTH, HEIGHT, tile_strips=strips, device=card,
    )
    renderer.set_blend_constant((0.25, 0.5, 0.75, 0.5))
    spec, _, runtime = renderer._prepare(frame_commands())
    prepared, cmd_i, cmd_f = runtime[:3]
    draws = coverage.draw_tables(spec)
    units = (
        torch.as_tensor(draws.unit_cmd, device=card),
        torch.as_tensor(draws.unit_draw, device=card),
    )
    for u8 in (False, True):
        args = (replace(spec, out_uint8=u8), prepared, cmd_i, cmd_f, *units)
        before = coverage.raster_launches
        got = coverage.coverage_raster(*args)
        want = coverage.rasterize_plain(*args)
        torch.cuda.synchronize()
        assert coverage.raster_launches == before + 1
        assert torch.equal(got, want), (samples, strips, u8)
    assert int((prepared.acount == 0).sum()) > 0  # empty tiles were taken


def test_slice_on_card_matches_slice_on_cpu(card):
    """Renderer.render on the card (torch binning on the card, CUDA
    kernel) against Renderer.render on the CPU (torch binning, plain
    rasterizer): packed RGBA8 identical."""
    commands = frame_commands()
    want = Renderer(Configuration(), WIDTH, HEIGHT).render(commands, as_uint8=True)
    got = Renderer(Configuration(), WIDTH, HEIGHT, device=card).render(
        commands, as_uint8=True
    )
    assert np.array_equal(got, want)


def test_bad_arguments_raise(card):
    renderer = Renderer(Configuration(), WIDTH, HEIGHT, device=card)
    spec, _, runtime = renderer._prepare(frame_commands())
    prepared, cmd_i, cmd_f = runtime[:3]
    draws = coverage.draw_tables(spec)
    units = (
        torch.as_tensor(draws.unit_cmd, device=card),
        torch.as_tensor(draws.unit_draw, device=card),
    )
    with pytest.raises(ValueError, match="cmd_f"):
        coverage.coverage_raster(spec, prepared, cmd_i, cmd_f[:, :4], *units)
    with pytest.raises(ValueError, match="cmd_i is on cpu"):
        coverage.coverage_raster(spec, prepared, cmd_i.cpu(), cmd_f, *units)
