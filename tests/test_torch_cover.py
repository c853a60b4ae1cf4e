"""The coverage kernel's colour cover and frame layout, checked on the
CPU: the plain version's count of (warp, unit) pairs that the cover
vote skips equals a brute-force count over the warp footprints; with
the vote's skips modelled (``rasterize_plain(work=...)``), no pixel of
the showcase, clip/alpha, paint and depth scenes changes; ``detile``
puts each lane of each tile at its screen pixel, as the kernel writes
it; and the blend state selects the kernel's blend kind.

Scenes, each at most 128² pixels: axis-aligned rectangles (edges off
every sample, so that each sample's coverage is known in closed form),
the showcase with text in both variants, ``scenes.mixed_paints`` and
the showcase under its own depth state."""

from functools import lru_cache

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.path import Path
from contrast_renderer_tpu_torch.renderer import (
    BlendComponent,
    BlendState,
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)
from test_torch_cull import pixel_grid, warp_lanes
from test_torch_instance import one_thread  # noqa: F401

#: (x0, y0, x1, y1) in screen pixels (y down); none lies within 0.05 px
#: of a sample of the 4x pattern.
RECTS = ((10.3, 6.3, 47.3, 29.3), (40.3, 20.3, 150.3, 60.3), (150.3, 2.3, 199.3, 9.3))
RECT_W, RECT_H = 200, 72


def rect_commands():
    """A stencil and cover pair per rectangle of RECTS, in a frame whose
    size is not a multiple of the tile."""
    t = scenes.ortho(RECT_W, RECT_H)
    commands = []
    for i, (x0, y0, x1, y1) in enumerate(RECTS):
        centre = ((x0 + x1) / 2, RECT_H - (y0 + y1) / 2)
        shape = Shape([Path.from_rect(centre, ((x1 - x0) / 2, (y1 - y0) / 2))])
        commands += [
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(RenderOperation.COLOR, shape, t,
                        color=(0.2 * i, 0.5, 0.9, 0.7)),
        ]
    return commands


def plain_args(spec, runtime):
    draws = coverage.draw_tables(spec)
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    return (spec, prepared, cmd_i, cmd_f, torch.as_tensor(draws.unit_cmd),
            torch.as_tensor(draws.unit_draw), desc_f, desc_i)


def brute_force_cover_skips(spec, runtime):
    """(skipped, reached) (warp, colour unit) pairs of rect_commands: a
    colour unit reaches the vote in every tile whose active list holds it
    and whose class for its draw is not 0, and skips each warp with no
    sample inside its rectangle (winding is 1 exactly there, as every
    earlier cover reset its own samples)."""
    prepared = runtime[0]
    draws = coverage.draw_tables(spec)
    offsets = coverage.SAMPLE_PATTERNS[spec.samples].astype(np.float64)
    warps = warp_lanes(spec)
    skipped = reached = 0
    for t in range(spec.n_tiles):
        xs, ys = pixel_grid(spec, t)
        sx = xs[:, None] + offsets[None, :, 0]
        sy = ys[:, None] + offsets[None, :, 1]
        for j in range(int(prepared.acount[t, 0, 0])):
            u = int(prepared.aclist[t, 0, j])
            d = int(draws.unit_draw[u])
            if d < 0 or int(prepared.cls[t, 0, d]) == 0:
                continue
            x0, y0, x1, y1 = RECTS[int(draws.unit_cmd[u]) // 2]
            inside = (sx > x0) & (sx < x1) & (sy > y0) & (sy < y1)
            hit = inside.any(1)[warps].any(1)
            skipped += int((~hit).sum())
            reached += len(hit)
    return skipped, reached


@pytest.mark.parametrize("strips", [1, 2])
def test_cover_skips_match_brute_force(strips):
    renderer = Renderer(Configuration(), RECT_W, RECT_H, tile_strips=strips,
                        device="cpu")
    spec, _, runtime = renderer._prepare(rect_commands())
    assert spec.tile_strips == strips
    work = {}
    image = coverage.rasterize_plain(*plain_args(spec, runtime), work=work)
    assert torch.equal(image, coverage.rasterize_plain(*plain_args(spec, runtime)))
    skipped, reached = brute_force_cover_skips(spec, runtime)
    assert (work["cover_skipped"], work["cover_warps"]) == (skipped, reached)
    assert 0 < skipped < reached


@lru_cache(maxsize=None)
def scene(name):
    """(configuration, commands) of a 128² scene.  The clip/alpha and
    depth variants of the showcase run at one sample a pixel, which
    quarters their plain renders' stroke work (the test's time)."""
    shape = showcase.build_shape(with_text=True)
    depth = dict(depth_compare="less_equal", depth_write_enabled=True)
    return {
        "showcase": (Configuration(), showcase.showcase_commands(shape, 128, 128)),
        "clip_alpha": (
            Configuration(alpha_layer_count=1, blending="front_to_back",
                          msaa_sample_count=1),
            showcase.showcase_commands_clip_alpha(shape, 128, 128),
        ),
        "paints": (Configuration(**depth), scenes.mixed_paints(128, 128)),
        "depth": (Configuration(msaa_sample_count=1, **depth),
                  showcase.showcase_commands(shape, 128, 128)),
    }[name]


@pytest.mark.parametrize("name", ["showcase", "clip_alpha", "paints", "depth"])
def test_modelled_cover_skips_change_no_pixel(name):
    """With the kernel's skips modelled (a warp the cover vote skips
    takes no update), every pixel equals the unskipped render; the vote
    skips some warps and keeps others."""
    config, commands = scene(name)
    spec, _, runtime = Renderer(config, 128, 128, device="cpu")._prepare(commands)
    work = {}
    args = plain_args(spec, runtime)
    assert torch.equal(coverage.rasterize_plain(*args, work=work),
                       coverage.rasterize_plain(*args))
    assert 0 < work["cover_skipped"] < work["cover_warps"]


@pytest.mark.parametrize(
    "tile_h, tile_w, strips, width, height",
    [(32, 128, 1, 200, 72), (32, 128, 2, 200, 72), (8, 128, 4, 45, 30),
     (32, 128, 1, 256, 64)],
)
@pytest.mark.parametrize("out_uint8", [False, True])
def test_detile_places_each_lane_at_its_pixel(tile_h, tile_w, strips, width,
                                              height, out_uint8):
    """Lane l of row r of tile t is screen pixel (x0 + l % lw, y0 +
    (l // lw)·th + r), the pixel the kernel writes; pixels past the
    frame are cut."""
    spec = coverage.FrameSpec(
        width=width, height=height, ops=(), cmd_shape=(), n_shapes=0,
        t_max=0, h_max=0, samples=4, winding_bits=8, n_layers=0,
        blending="back_to_front", tile_h=tile_h, tile_w=tile_w,
        tile_strips=strips, out_uint8=out_uint8,
    )
    gen = torch.Generator().manual_seed(0)
    if out_uint8:
        tiles = torch.randint(-2**31, 2**31 - 1, (spec.n_tiles, tile_h, tile_w),
                              generator=gen, dtype=torch.int32)
    else:
        tiles = torch.rand((spec.n_tiles, 4, tile_h, tile_w), generator=gen)
    image = coverage.detile(spec, tiles)
    assert image.shape == ((height, width) if out_uint8 else (height, width, 4))
    assert image.is_contiguous()
    want = np.zeros(tuple(image.shape), image.numpy().dtype)
    seen = np.zeros((height, width), int)
    for t in range(spec.n_tiles):
        xs, ys = pixel_grid(spec, t)
        for pix, (x, y) in enumerate(zip(xs, ys)):
            if x < width and y < height:
                r, lane = divmod(pix, tile_w)
                want[y, x] = (tiles[t, r, lane] if out_uint8
                              else tiles[t, :, r, lane]).numpy()
                seen[y, x] += 1
    assert (seen == 1).all()
    np.testing.assert_array_equal(image.numpy(), want)


def test_blend_kind_names_the_three_named_states():
    """A named state, given by name or as its BlendState, runs the
    kernel's formula for it; any other state the generic codes."""
    for kind, name in enumerate(("back_to_front", "front_to_back", "additive"), 1):
        src, op, dst = coverage._NAMED_BLEND[name]
        comp = BlendComponent(src, op, dst)
        assert coverage.blend_kind(name) == kind
        assert coverage.blend_kind(BlendState(comp, comp).canonical()) == kind
    over = BlendComponent("one", "add", "one_minus_src_alpha")
    other = BlendComponent("one", "add", "one")
    assert coverage.blend_kind(BlendState(over, other).canonical()) == 0
    constant = BlendState(
        BlendComponent("constant", "add", "one_minus_src_alpha"),
        BlendComponent("src_alpha_saturated", "reverse_subtract", "one"),
    )
    assert coverage.blend_kind(constant.canonical()) == 0
