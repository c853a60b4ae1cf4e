"""The coverage kernel's per-warp skips, checked on the CPU: the box test
by which each warp culls stroke and fill entries is exact (no sample
that passes an entry's three edge tests lies outside the entry's
widened box), the plain version's counts of the stencil walk (the
(block, entry) rows staged, the (warp, entry) pairs culled by the box
test, dropped by the edge reject and walked, the stroke samples skipped
by the warp vote, the predicate lanes, the curve pairs with no sample
inside) and of (warp, unit) pairs skipped by the clip vote equal a brute-force
count over the block and warp footprints, and the renderer's entry
point runs on the card unless asked for the CPU.

Scenes, each at most 128² pixels: a 128² window of BASELINE config 3
(``scenes.dashed_strokes(1920, 1080, seed=1)``, widths unchanged), the
showcase with text at 128², ``scenes.warp_boundaries``, whose
vertices lie on pixel, sample, warp and tile boundaries, and
``scenes.rect_clips``, content inside two nested rectangular clips."""

import inspect
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
from test_torch_instance import one_thread  # noqa: F401


def config3_window(size=128, x0=800.0, y0=450.0):
    """Config 3's polylines through a ``size``² window whose lower left
    corner is (x0, y0) of the 1920x1080 frame."""
    paths, options = scenes.dashed_strokes(1920, 1080, seed=1)
    shape = Shape(paths, options)
    t = scenes.ortho(size, size)
    t[0, 3] -= 2.0 * x0 / size
    t[1, 3] -= 2.0 * y0 / size
    return size, size, [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1, 1, 1, 1)),
    ]


def showcase_128():
    shape = showcase.build_shape(with_text=True)
    return 128, 128, showcase.showcase_commands(shape, 128, 128)


def boundaries():
    return (*scenes.BOUNDARY_SIZE, scenes.warp_boundaries())


SCENES = {
    "config3": config3_window,
    "showcase": showcase_128,
    "boundaries": boundaries,
}


@lru_cache(maxsize=None)
def frame(scene, strips=None):
    """(spec, runtime) of a scene binned on the CPU."""
    width, height, commands = SCENES[scene]()
    renderer = Renderer(
        Configuration(), width, height, tile_strips=strips, device="cpu"
    )
    spec, _, runtime = renderer._prepare(commands)
    return spec, runtime


def pixel_grid(spec, t):
    """Screen pixel (x, y) of each lane of tile t, in the kernel's lane
    order (pix = row * tile_w + lane), written out lane by lane."""
    th, tw, lw = spec.tile_h, spec.tile_w, spec.screen_tile_w
    x0 = (t % spec.ntx) * lw
    y0 = (t // spec.ntx) * spec.screen_tile_h
    xs, ys = [], []
    for pix in range(th * tw):
        r, l = divmod(pix, tw)
        if spec.tile_strips == 1:
            col, row = l, r
        else:
            col, row = l % lw, (l // lw) * th + r
        xs.append(x0 + col)
        ys.append(y0 + row)
    return np.array(xs), np.array(ys)


def warp_lanes(spec):
    """The lane-major pixel index of each thread of each warp of a tile,
    thread by thread from the kernel's layout: block b is 4 rows x 64
    lanes of the tile, and its warp w the 4 rows x 8 lanes from lane 8w."""
    th, tw = spec.tile_h, spec.tile_w
    warps = []
    for b in range(th * tw // 256):
        row0 = (b // (tw // 64)) * 4
        lane0 = (b % (tw // 64)) * 64
        for w in range(8):
            warps.append([
                (row0 + q // 8) * tw + lane0 + 8 * w + q % 8 for q in range(32)
            ])
    warps = np.array(warps)
    assert sorted(warps.ravel().tolist()) == list(range(th * tw))
    return warps


def tables(prepared):
    return (
        (prepared.tri_f, prepared.tri_i, prepared.off),
        (prepared.g_tri_f, prepared.g_tri_i, prepared.g_off),
    )


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_no_passing_sample_lies_outside_the_widened_box(scene):
    """Every binned entry of every tile, stroke and fill classes: the
    pixels with a sample that passes its three edge tests (the kernel's
    arithmetic) have their centres in its culling box, so a warp none of
    whose pixel centres lies in that box has no sample the entry
    covers."""
    spec, runtime = frame(scene)
    prepared = runtime[0]
    coord = spec.ntx * spec.screen_tile_w + spec.nty * spec.screen_tile_h + 1
    classes = set()
    passing = 0
    for t in range(spec.n_tiles):
        xs, ys = pixel_grid(spec, t)
        bx = torch.as_tensor(xs, dtype=torch.float32)[None, None, :]
        by = torch.as_tensor(ys, dtype=torch.float32)[None, None, :]
        for rows_f, rows_i, off in tables(prepared):
            n = int(off[t, 0, -1])
            if n == 0:
                continue
            rf, ri = rows_f[t, None, :n], rows_i[t, None, :n]
            classes |= set(ri[0, :, coverage.RI_CLASS].tolist())
            edges = coverage._edges(rf, ri, bx + 0.5, by + 0.5)
            x0, y0, x1, y1 = (v[..., None] for v in coverage._cull_boxes(rf, coord))
            for ox, oy in coverage.SAMPLE_PATTERNS[spec.samples]:
                inside = coverage._inside(edges, float(ox) - 0.5, float(oy) - 0.5)
                px, py = bx + 0.5, by + 0.5
                in_box = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
                assert not bool((inside & ~in_box).any()), (t, ox, oy)
                passing += int(inside.sum())
    assert passing > 0
    strokes = {code for code, _, _ in coverage.STROKE_CLASSES}
    assert classes & strokes
    if scene != "config3":  # config 3 is strokes only
        assert classes & set(coverage.FILL_CLASSES)


def edge_rejects(row, wx, wy, coord):
    """The kernel's edge reject of one entry row for warps whose pixels
    are (wx, wy), (W, 32) each, in numpy float32: one of its edge
    functions, at the corner of the warp's sample footprint (the union of
    its pixels' squares' bounding rectangle) that maximises it, below
    minus 2^-20 of its magnitude (and 2^-100)."""
    f32 = np.float32
    x_lo, y_lo = wx.min(1), wy.min(1)
    x_hi, y_hi = wx.max(1) + 1, wy.max(1) + 1
    out = np.zeros(len(wx), bool)
    for edge in range(3):
        a, b, c = (f32(row[3 * edge + i]) for i in range(3))
        x = (x_hi if a > 0 else x_lo).astype(f32)
        y = (y_hi if b > 0 else y_lo).astype(f32)
        e = (a * x + b * y) + c
        margin = f32(2.0 ** -20) * ((abs(a) + abs(b)) * f32(coord) + abs(c)) + f32(2.0 ** -100)
        out |= e < -margin
    return out


def brute_force_counts(spec, runtime):
    """The stencil walk's counts, pair by pair: every (block, entry) and
    (warp, entry) of the stencil units in each tile's active list, the
    rectangles of the block's 256 and the warp's 32 pixel centres, the
    box test against ``_cull_boxes``, the edge reject of stroke pairs
    in the box, and for the pairs walked the samples that no lane of the
    warp has inside (edge tests in numpy float32): the warp vote of
    strokes, the predicate lanes, and the curve pairs with none."""
    prepared, cmd_i = runtime[0], runtime[1]
    draws = coverage.draw_tables(spec)
    S = spec.samples
    offsets = coverage.SAMPLE_PATTERNS[S].astype(np.float64)
    coord = spec.ntx * spec.screen_tile_w + spec.nty * spec.screen_tile_h + 1
    stroke_codes = {code for code, _, _ in coverage.STROKE_CLASSES}
    counts = dict(entry_blocks=0, staged_rows=0, entry_warps=0, culled=0,
                  edge_rejected=0, walked=0, stroke_pairs=0, inside_pairs=0,
                  stroke_samples=0, vote_skipped=0, keep_lanes=0,
                  keep_slots_sample=0, fill_pairs=0,
                  fill_pairs_outside=0)
    f32 = np.float32
    warps = warp_lanes(spec)
    blocks = warps.reshape(-1, 8 * 32)
    for t in range(spec.n_tiles):
        xs, ys = pixel_grid(spec, t)
        wx, wy = xs[warps], ys[warps]
        fp = (wx.min(1) + 0.5, wy.min(1) + 0.5, wx.max(1) + 0.5, wy.max(1) + 0.5)
        bx, by = xs[blocks], ys[blocks]
        bp = (bx.min(1) + 0.5, by.min(1) + 0.5, bx.max(1) + 0.5, by.max(1) + 0.5)
        pxc, pyc = (xs + 0.5).astype(f32), (ys + 0.5).astype(f32)
        for k in range(int(prepared.acount[t, 0, 0])):
            u = int(prepared.aclist[t, 0, k])
            c = int(draws.unit_cmd[u])
            if int(cmd_i[c, 0]) != coverage.OP_STENCIL or int(cmd_i[c, 1]) != 0:
                continue
            for rows_f, rows_i, off in tables(prepared):
                base = coverage.N_CLASSES * c
                lo = int(off[t, 0, base])
                hi = int(off[t, 0, base + coverage.N_CLASSES])
                for j in range(lo, hi):
                    row = rows_f[t, j]
                    box = [float(v) for v in coverage._cull_boxes(row[None], coord)]

                    def meets(r):
                        return ~((box[2] < r[0]) | (box[0] > r[2])
                                 | (box[3] < r[1]) | (box[1] > r[3]))

                    staged = meets(bp).repeat(8)
                    in_box = meets(fp)
                    counts["entry_blocks"] += len(bp[0])
                    counts["staged_rows"] += int(meets(bp).sum())
                    counts["entry_warps"] += len(in_box)
                    counts["culled"] += int((~in_box).sum())
                    walked = staged & in_box
                    cls = int(rows_i[t, j, coverage.RI_CLASS])
                    if cls in stroke_codes:
                        rejected = edge_rejects(row.numpy(), wx, wy, coord)
                        counts["edge_rejected"] += int((walked & rejected).sum())
                        walked &= ~rejected
                    counts["walked"] += int(walked.sum())
                    if cls == coverage.CLS_FILL_SOLID:
                        continue
                    a, b, e = [], [], []
                    for edge in range(3):
                        ak, bk, ck = (f32(row[3 * edge + i]) for i in range(3))
                        a.append(ak)
                        b.append(bk)
                        e.append(ak * pxc + bk * pyc + ck)
                    flags = int(rows_i[t, j, coverage.RI_FLAGS])
                    lanes_in = np.zeros((len(in_box), S), bool)
                    pairs = np.zeros(len(in_box), int)
                    for s, (ox, oy) in enumerate(offsets):
                        dx, dy = f32(ox - 0.5), f32(oy - 0.5)
                        inside = np.ones(len(xs), bool)
                        for edge in range(3):
                            nt = -(a[edge] * dx + b[edge] * dy)
                            tl = bool(flags >> edge & 1)
                            inside &= (e[edge] > nt) | ((e[edge] == nt) & tl)
                        lanes_in[:, s] = inside[warps].any(1)
                        pairs += inside[warps].sum(1)
                    n = int(walked.sum())
                    voted = lanes_in[walked].sum(1)
                    if cls not in stroke_codes:
                        counts["fill_pairs"] += n
                        counts["fill_pairs_outside"] += int((voted == 0).sum())
                        continue
                    counts["stroke_pairs"] += n
                    counts["inside_pairs"] += int((pairs[walked] > 0).sum())
                    counts["stroke_samples"] += n * 32 * S
                    counts["vote_skipped"] += 32 * int((S - voted).sum())
                    counts["keep_lanes"] += int(pairs[walked].sum())
                    counts["keep_slots_sample"] += 32 * int(voted.sum())
    return counts


@pytest.mark.parametrize(
    "scene,strips",
    [("boundaries", 1), ("boundaries", 4), ("config3", 2), ("boundaries", 32)],
)
def test_warp_counts_match_brute_force(scene, strips):
    spec, runtime = frame(scene, strips)
    assert spec.tile_strips == strips
    draws = coverage.draw_tables(spec)
    units = (torch.as_tensor(draws.unit_cmd), torch.as_tensor(draws.unit_draw))
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    work = {}
    image = coverage.rasterize_plain(
        spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i, work=work
    )
    assert torch.equal(
        image,
        coverage.rasterize_plain(spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i),
    )
    want = brute_force_counts(spec, runtime)
    assert {key: work.get(key, 0) for key in want} == want
    # Each mechanism has work to skip on these frames.
    assert 0 < want["staged_rows"] < want["entry_blocks"]
    assert 0 < want["culled"] < want["entry_warps"]
    assert 0 < want["edge_rejected"]
    assert 0 < want["vote_skipped"] < want["stroke_samples"]
    assert 0 < want["keep_lanes"] < want["keep_slots_sample"]


def brute_force_clip_skips(spec, runtime):
    """The (warp, unit) pairs that the clip vote skips on
    scenes.rect_clips, unit by unit from each tile's active list: the
    clip counters follow the clip and unclip ops in closed form (a
    sample inside a clip rectangle with the counter one below the clip's
    depth is promoted; one inside it and deeper is demoted), and every
    other unit skips each warp with no sample at the unit's depth."""
    prepared, cmd_i = runtime[0], runtime[1]
    draws = coverage.draw_tables(spec)
    offsets = coverage.SAMPLE_PATTERNS[spec.samples].astype(np.float64)
    k = spec.width / 128.0
    rects = {}
    for c in range(spec.n_commands):
        if int(cmd_i[c, 0]) in (coverage.OP_CLIP, coverage.OP_UNCLIP):
            level = int(cmd_i[c, 1]) - (int(cmd_i[c, 0]) == coverage.OP_CLIP) + 1
            rects[c] = [v * k for v in scenes.RECT_CLIPS[level - 1]]
    warps = warp_lanes(spec)
    skipped = kept = 0
    for t in range(spec.n_tiles):
        xs, ys = pixel_grid(spec, t)
        sx = xs[:, None] + offsets[None, :, 0]
        sy = ys[:, None] + offsets[None, :, 1]
        clip = np.zeros(sx.shape, int)
        for j in range(int(prepared.acount[t, 0, 0])):
            c = int(draws.unit_cmd[int(prepared.aclist[t, 0, j])])
            op, depth = int(cmd_i[c, 0]), int(cmd_i[c, 1])
            if op in (coverage.OP_CLIP, coverage.OP_UNCLIP):
                x0, y0, x1, y1 = rects[c]
                inside = (sx > x0) & (sx < x1) & (sy > y0) & (sy < y1)
                hit = clip == depth - 1 if op == coverage.OP_CLIP else clip > depth
                clip = np.where(inside & hit, depth, clip)
                continue
            at = (clip == depth).any(1)[warps].any(1)
            skipped += int((~at).sum())
            kept += int(at.sum())
    return skipped, kept


@pytest.mark.parametrize("strips", [1, 2])
def test_clip_skips_match_brute_force(strips):
    """On scenes.rect_clips, whose content lies partly outside two
    nested rectangular clips, the plain version's count of (warp, unit)
    pairs skipped by the clip vote equals the brute force; both occur,
    skipped and kept pairs, and counting changes no pixel."""
    renderer = Renderer(
        Configuration(alpha_layer_count=1, blending="front_to_back"),
        128, 128, tile_strips=strips, device="cpu",
    )
    spec, _, runtime = renderer._prepare(scenes.rect_clips(128))
    assert spec.tile_strips == strips and spec.gate_spans
    draws = coverage.draw_tables(spec)
    units = (torch.as_tensor(draws.unit_cmd), torch.as_tensor(draws.unit_draw))
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    work = {}
    image = coverage.rasterize_plain(
        spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i, work=work
    )
    assert torch.equal(
        image,
        coverage.rasterize_plain(spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i),
    )
    skipped, kept = brute_force_clip_skips(spec, runtime)
    assert work["clip_skipped"] == skipped
    assert skipped > 0 and kept > 0


def test_renderer_defaults_to_the_card():
    """No ``device=`` means the card: on a host without one the
    constructor raises, as for an explicit ``"cuda"``; nothing falls
    back to the CPU."""
    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(Configuration(), 64, 64)
