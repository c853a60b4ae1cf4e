"""The coverage kernel's stencil walk, checked on the CPU: a block stages
only the entry rows whose culling box meets its rectangle of pixel
centres, a warp walks only those whose box meets its own rectangle and,
for strokes, that its edge reject keeps; every (warp, entry) pair with a
sample inside the entry is still walked (brute force over each warp's
pixels and samples, with the kernel's edge arithmetic); the plain
version's model of those skips changes no pixel; the stroke rows of a
command run before its fill rows; and each row carries the class of the
range it lies in, which the kernel's walk switches on.

Scenes, each at most 128² pixels: 128² windows of BASELINE config 2
(``scenes.bezier_fill_paths(1000, 1920, 1080, seed=0)``) and config 3
(``scenes.dashed_strokes(1920, 1080, seed=1)``), the showcase with text
at 128², the showcase orbit's frame 30 at 96² (near-plane slivers) and
``scenes.thin_strokes``; config 3 and the thin strokes also at 32 strips
a tile, where a warp's 8 lanes span two strips.  The block's and the
warp's rectangles are those the kernel computes from its thread indices
(``coverage.block_rects``, ``coverage.warp_rects``), each checked
against its pixels' bounds at every strip count."""

from functools import lru_cache

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.renderer import (
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)
from test_torch_cull import pixel_grid, warp_lanes
from test_torch_instance import one_thread  # noqa: F401


def window(shape, size=128, x0=800.0, y0=450.0):
    """A stencil and cover pair of ``shape`` through a ``size``² window
    whose lower left corner is (x0, y0) of the 1920x1080 frame."""
    t = scenes.ortho(size, size)
    t[0, 3] -= 2.0 * x0 / size
    t[1, 3] -= 2.0 * y0 / size
    return [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)),
    ]


SCENES = {
    "config2": lambda: (128, window(
        Shape(scenes.bezier_fill_paths(1000, 1920, 1080, seed=0)))),
    "config3": lambda: (128, window(
        Shape(*scenes.dashed_strokes(1920, 1080, seed=1)))),
    "showcase": lambda: (128, showcase.showcase_commands(
        showcase.build_shape(with_text=True), 128, 128)),
    "orbit30": lambda: (96, showcase.showcase_commands(
        showcase.build_shape(with_text=True), 96, 96,
        view_rotation=showcase.orbit_rotor(30))),
    "thin": lambda: (128, window(Shape(*scenes.thin_strokes(128)), x0=0.0, y0=0.0)),
}
STROKE_SCENES = ("config3", "showcase", "orbit30", "thin")


#: Scenes also checked at 32 strips a tile, where a strip (4 pixels) is
#: narrower than a warp's 8 lanes.
NARROW = ("config3", "thin")


@lru_cache(maxsize=None)
def frame(scene, strips=1):
    """(spec, runtime) of a scene binned on the CPU."""
    size, commands = SCENES[scene]()
    renderer = Renderer(Configuration(), size, size, tile_strips=strips,
                        device="cpu")
    spec, _, runtime = renderer._prepare(commands)
    return spec, runtime


def tables(prepared):
    return (
        (prepared.tri_f, prepared.tri_i, prepared.off),
        (prepared.g_tri_f, prepared.g_tri_i, prepared.g_off),
    )


def walk_pairs(spec, prepared, t, rows_f, rows_i, n):
    """For the first n rows of one of tile t's tables: which (entry,
    warp) pairs have a sample inside the entry (brute force over the
    warp's 32 pixels and S samples, the kernel's edge arithmetic), and
    which the kernel walks: its block stages the row (the row's box
    meets the block's rectangle), the warp's box test keeps it, and for
    a stroke row the edge reject keeps it, each rectangle as the kernel
    computes it (coverage.block_rects, coverage.warp_rects).  Returns
    (inside, walked, staged, in_box, rejected), each (n, W) bool."""
    coord = spec.ntx * spec.screen_tile_w + spec.nty * spec.screen_tile_h + 1
    warps = torch.as_tensor(warp_lanes(spec))            # (W, 32)
    xs, ys = pixel_grid(spec, t)
    px = torch.as_tensor(xs, dtype=torch.float32)
    py = torch.as_tensor(ys, dtype=torch.float32)
    rf, ri = rows_f[t, None, :n], rows_i[t, None, :n]
    edges = coverage._edges(rf, ri, (px + 0.5)[None, None], (py + 0.5)[None, None])
    inside = torch.zeros((n, len(warps)), dtype=torch.bool)
    for ox, oy in coverage.SAMPLE_PATTERNS[spec.samples]:
        hit = coverage._inside(edges, float(ox) - 0.5, float(oy) - 0.5)[0]
        inside |= hit[:, warps].any(-1)
    x0, y0, x1, y1 = (v[0, :, None] for v in coverage._cull_boxes(rf, coord))

    def meets(rect):
        rx0, ry0, rx1, ry1 = (v[None, :] for v in rect)
        return ~((x1 < rx0) | (x0 > rx1) | (y1 < ry0) | (y0 > ry1))

    # Each warp's and each block's rectangle of pixel centres, as the
    # kernel computes them from its thread indices.
    x0 = (t % spec.ntx) * spec.screen_tile_w
    y0 = (t // spec.ntx) * spec.screen_tile_h

    def centres(rects):
        rects = rects.float()
        return (x0 + rects[:, 0] + 0.5, y0 + rects[:, 1] + 0.5,
                x0 + rects[:, 2] + 0.5, y0 + rects[:, 3] + 0.5)

    warp_rect = centres(coverage.warp_rects(spec))
    in_box = meets(warp_rect)
    per_block = len(warps) // (spec.tile_h * spec.tile_w // 256)
    staged = meets(centres(coverage.block_rects(spec)))
    staged = staged.repeat_interleave(per_block, 1)
    stroke = ri[0, :, coverage.RI_CLASS] < coverage.CLS_FILL_SOLID
    rejected = coverage._edge_reject(
        rf[0, :, None, :], [v[None] for v in warp_rect], coord
    ) & stroke[:, None]
    return inside, staged & in_box & ~rejected, staged, in_box, rejected


def check_every_pair_walked(scene, strips):
    """Every binned entry of every tile against every warp: a pair with
    a sample inside the entry is staged by its block, kept by the warp's
    box test and, for strokes, by the edge reject; each of the three
    drops pairs on these scenes (the edge reject on the stroke scenes)."""
    spec, runtime = frame(scene, strips)
    assert spec.tile_strips == strips
    prepared = runtime[0]
    dropped = {"staging": 0, "box": 0, "edge": 0}
    total = 0
    for t in range(spec.n_tiles):
        for rows_f, rows_i, off in tables(prepared):
            n = int(off[t, 0, -1])
            if n == 0:
                continue
            inside, walked, staged, in_box, rejected = walk_pairs(
                spec, prepared, t, rows_f, rows_i, n)
            missed = inside & ~walked
            assert not bool(missed.any()), (t, int(missed.sum()))
            total += int(inside.sum())
            dropped["staging"] += int((~staged).sum())
            dropped["box"] += int((staged & ~in_box).sum())
            dropped["edge"] += int((staged & in_box & rejected).sum())
    assert total > 0
    assert dropped["staging"] > 0 and dropped["box"] > 0
    if scene in STROKE_SCENES:
        assert dropped["edge"] > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_every_pair_with_an_inside_sample_is_walked(scene):
    check_every_pair_walked(scene, 1)


@pytest.mark.parametrize("scene", NARROW)
def test_every_pair_is_walked_in_narrow_strips(scene):
    """As above at 32 strips a tile: a warp's 8 lanes span two strips,
    32 rows apart, and its rectangle (coverage.warp_rects) holds both."""
    check_every_pair_walked(scene, 32)


def check_modelled_skips(scene, strips):
    """rasterize_plain with ``work`` models the block staging, the box
    test and the edge reject (a warp takes no update of an entry it does
    not walk): the image equals the one without, and the counts add up,
    each walked pair neither culled nor rejected."""
    spec, runtime = frame(scene, strips)
    assert spec.tile_strips == strips
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    draws = coverage.draw_tables(spec)
    units = (torch.as_tensor(draws.unit_cmd), torch.as_tensor(draws.unit_draw))
    work = {}
    image = coverage.rasterize_plain(
        spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i, work=work
    )
    assert torch.equal(
        image,
        coverage.rasterize_plain(spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i),
    )
    assert work["walked"] == (
        work["entry_warps"] - work["culled"] - work.get("edge_rejected", 0)
    )
    assert 0 < work["staged_rows"] < work["entry_blocks"]
    if scene in STROKE_SCENES:
        assert 0 < work["inside_pairs"] <= work["stroke_pairs"]
        assert 0 < work["keep_lanes"] <= work["keep_slots_sample"]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_modelled_skips_change_no_pixel(scene):
    check_modelled_skips(scene, 1)


@pytest.mark.parametrize("scene", NARROW)
def test_modelled_skips_change_no_pixel_in_narrow_strips(scene):
    check_modelled_skips(scene, 32)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rows_carry_their_range_class(scene):
    """The kernel's walk stages a command's rows in runs (local strokes,
    global strokes, local fills, global fills) and switches on each
    row's RI_CLASS: every row of range (command, class) holds that
    class."""
    spec, runtime = frame(scene)
    prepared = runtime[0]
    for rows_f, rows_i, off in tables(prepared):
        off = off.reshape(spec.n_tiles, -1)
        for t in range(spec.n_tiles):
            for r in range(off.shape[1] - 1):
                lo, hi = int(off[t, r]), int(off[t, r + 1])
                got = rows_i[t, lo:hi, coverage.RI_CLASS]
                assert bool((got == r % coverage.N_CLASSES).all()), (t, r)


#: Every strip count that FrameSpec accepts for a 128-lane tile.
ALL_STRIPS = [1, 2, 4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("strips", ALL_STRIPS)
def test_block_rects_bound_each_block(strips):
    """coverage.block_rects (the kernel's slab rectangle, computed from
    the block's index) is the bounding rectangle of the block's pixels
    in every strip layout of a 32x128 tile."""
    spec, _ = frame("config2")
    from dataclasses import replace

    spec = replace(spec, tile_strips=strips)
    assert spec.screen_tile_w == 128 // strips
    warps = warp_lanes(spec)
    xs, ys = pixel_grid(spec, 0)
    rects = coverage.block_rects(spec).tolist()
    per_block = 8
    for b, rect in enumerate(rects):
        lanes = warps[b * per_block:(b + 1) * per_block].ravel()
        assert rect == [int(xs[lanes].min()), int(ys[lanes].min()),
                        int(xs[lanes].max()), int(ys[lanes].max())], (b, rect)


@pytest.mark.parametrize("strips", ALL_STRIPS)
def test_warp_rects_bound_each_warp(strips):
    """coverage.warp_rects (the kernel's warp rectangle, the warp min and
    max of its threads' pixels) is the bounding rectangle of the warp's
    pixels, written out lane by lane, in every strip layout of a 32x128
    tile; where a strip is narrower than 8 pixels the warp spans several
    strips and its rectangle is taller than 4 rows."""
    spec, _ = frame("config2")
    from dataclasses import replace

    spec = replace(spec, tile_strips=strips)
    warps = warp_lanes(spec)
    xs, ys = pixel_grid(spec, 0)
    want = np.stack([xs[warps].min(1), ys[warps].min(1),
                     xs[warps].max(1), ys[warps].max(1)], 1)
    got = coverage.warp_rects(spec).numpy()
    assert np.array_equal(got, want)
    heights = got[:, 3] - got[:, 1] + 1
    assert bool((heights == 4).all()) == (spec.screen_tile_w >= 8)


@pytest.mark.parametrize("bits,covered", [(1, False), (4, True)])
def test_strokes_run_before_fills(bits, covered):
    """scenes.stroke_over_fill: one stencil command with fill and stroke
    rows over the same samples.  With a one-bit winding counter a sample
    inside both is covered only if the fill's add came first; the walk
    runs the stroke OR first (0 -> 1 -> 1 ± 1, even), as the reference
    kernel does, so the overlap stays empty, while the square alone and
    the stroke alone are covered.  With four bits the overlap is
    covered either way."""
    size = 64
    renderer = Renderer(Configuration(winding_counter_bits=bits), size, size,
                        device="cpu")
    spec, _, _ = renderer._prepare(scenes.stroke_over_fill(size))
    assert spec.has_strokes
    image = np.asarray(renderer.render(scenes.stroke_over_fill(size)))
    alpha = image[..., 3]
    row = size - 1 - size // 2                           # y = size / 2, top row first
    assert alpha[row, size // 2] == (1.0 if covered else 0.0)
    assert alpha[row, size // 8] == 1.0                   # the stroke alone
    assert alpha[size // 3, size // 2] == 1.0             # the square alone
