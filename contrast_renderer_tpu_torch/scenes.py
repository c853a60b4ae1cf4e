"""Scenes the port is checked and measured on, built from the shared
``path`` module so that both packages can tessellate the same paths,
and the shared scalar oracle that their coverage is held against.
``Path`` is re-exported for scripts that build scenes through the port."""

from __future__ import annotations

import numpy as np

from contrast_renderer_tpu import oracle
from contrast_renderer_tpu.path import (
    Cap,
    CurveApproximation,
    DashInterval,
    DynamicStrokeOptions,
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    Join,
    LineSegment,
    Path,
    StrokeOptions,
)


def ortho(width, height):
    """Pixel-space model coordinates (y up) → clip space."""
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def oracle_coverage(triangles, width, height):
    """Per-pixel coverage (H, W) of a fill triangle table under the
    default ortho transform and 4× MSAA, from the scalar oracle: the
    share of samples whose winding is nonzero modulo 16."""
    winding = oracle.rasterize_fill_table(triangles, width, height)
    return oracle.coverage_from_winding(winding).mean(-1)


def bezier_fill_paths(n, width, height, seed=0, margin=40.0,
                      radius=(8.0, 30.0)):
    """``n`` closed fills, alternately one integral quadratic and one
    integral cubic Bézier closed by a line, with random centres, radii
    and control points from ``np.random.default_rng(seed)``.

    With the defaults and (1000, 1920, 1080, 0) this is BASELINE config 2
    (benchmarks/run_configs.py::config2), draw for draw."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        cx = rng.uniform(margin, width - margin)
        cy = rng.uniform(margin, height - margin)
        r = rng.uniform(*radius)
        pts = np.stack(
            [cx + rng.uniform(-r, r, 4), cy + rng.uniform(-r, r, 4)], axis=1
        )
        p = Path(start=(cx - r, cy))
        if i % 2 == 0:
            p.push_integral_quadratic_curve(
                IntegralQuadraticCurveSegment([tuple(pts[0]), tuple(pts[1])])
            )
        else:
            p.push_integral_cubic_curve(
                IntegralCubicCurveSegment(
                    [tuple(pts[0]), tuple(pts[1]), tuple(pts[2])]
                )
            )
        p.push_line(LineSegment([(cx - r, cy)]))
        paths.append(p)
    return paths


#: The joins of the dashed-stroke scene's three descriptor groups.
DASHED_JOINS = (Join.MITER, Join.BEVEL, Join.ROUND)


def dashed_options(join, phase):
    """The dashed-stroke scene's two-interval dash pattern (a round-to-
    out dash then a butt dash) with ``join``, at pattern phase
    ``phase``."""
    return DynamicStrokeOptions.make_dashed(
        join,
        [
            DashInterval(gap_start=2.0, gap_end=3.0,
                         dash_start=Cap.ROUND, dash_end=Cap.OUT),
            DashInterval(gap_start=5.0, gap_end=5.5,
                         dash_start=Cap.BUTT, dash_end=Cap.BUTT),
        ],
        phase=phase,
    )


def dashed_strokes(width, height, seed=1):
    """60 open polylines of 6 random segments each, stroked 10 px wide
    with a mitre clip of 2, in three dash groups (one per join of
    DASHED_JOINS, path i in group i % 3).  Returns ``(paths, options)``,
    the options at phase 0; animate with ``dashed_options(join,
    phase)``.

    With (1920, 1080, 1) this is BASELINE config 3
    (benchmarks/run_configs.py::config3), path for path."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(60):
        p = Path(start=(rng.uniform(100, width - 100),
                        rng.uniform(100, height - 100)))
        for _ in range(6):
            p.push_line(LineSegment([
                (rng.uniform(50, width - 50), rng.uniform(50, height - 50))
            ]))
        p.stroke_options = StrokeOptions(
            width=10.0, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=i % 3,
            curve_approximation=CurveApproximation.uniform_tangent_angle(0.1),
        )
        paths.append(p)
    return paths, [dashed_options(join, 0.0) for join in DASHED_JOINS]


#: The cap sheet's frame size.
CAP_SHEET_SIZE = (96, 72)
#: Its cap styles, one stroked line each, top to bottom.
CAP_SHEET_CAPS = (
    Cap.SQUARE, Cap.ROUND, Cap.OUT, Cap.IN, Cap.RIGHT, Cap.LEFT, Cap.BUTT,
)


def cap_sheet():
    """The scene of the cap golden (tests/golden/cap_styles_96x72.npy):
    one 6 px horizontal line per cap style, each its own solid group
    with that cap at both ends.  Returns ``(paths, options)``; render
    it white under ``ortho(*CAP_SHEET_SIZE)`` at 4× MSAA."""
    paths, options = [], []
    for i, cap in enumerate(CAP_SHEET_CAPS):
        y = 8.0 + 8.0 * i
        p = Path(start=(24.0, y))
        p.push_line(LineSegment([(72.0, y)]))
        p.stroke_options = StrokeOptions(
            width=6.0, offset=0.0, miter_clip=1.0, closed=False,
            dynamic_stroke_options_group=i,
        )
        paths.append(p)
        options.append(DynamicStrokeOptions.make_solid(Join.MITER, cap, cap))
    return paths, options


def stroke_sampler(size=128, seed=7):
    """A scene that reaches all six stroke classes, with every join and
    several caps: three random open polylines of five segments (from
    ``np.random.default_rng(seed)``), one per group — a solid bevel group
    with round and square caps, a single-interval mitre dash and a
    two-interval round-join dash — and a quadratic curve stroke in the
    solid group, flattened by uniform tangent angle.  Returns ``(paths,
    options)`` for a ``size``² frame under ``ortho``."""
    options = [
        DynamicStrokeOptions.make_solid(Join.BEVEL, Cap.ROUND, Cap.SQUARE),
        DynamicStrokeOptions.make_dashed(
            Join.MITER,
            [DashInterval(gap_start=4.0, gap_end=6.5,
                          dash_start=Cap.OUT, dash_end=Cap.BUTT)],
            phase=0.75,
        ),
        DynamicStrokeOptions.make_dashed(
            Join.ROUND,
            [
                DashInterval(gap_start=2.0, gap_end=3.0,
                             dash_start=Cap.ROUND, dash_end=Cap.IN),
                DashInterval(gap_start=5.0, gap_end=5.5,
                             dash_start=Cap.LEFT, dash_end=Cap.RIGHT),
            ],
            phase=0.25,
        ),
    ]
    s = size / 128.0
    rng = np.random.default_rng(seed)
    paths = []
    for group, width in enumerate((5.0, 4.0, 6.0)):
        p = Path(start=tuple(rng.uniform(12 * s, size - 12 * s, 2)))
        for _ in range(5):
            p.push_line(LineSegment(
                [tuple(rng.uniform(12 * s, size - 12 * s, 2))]
            ))
        p.stroke_options = StrokeOptions(
            width=width * s, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=group,
        )
        paths.append(p)
    curve = Path(start=(16.0 * s, 110.0 * s))
    curve.push_integral_quadratic_curve(
        IntegralQuadraticCurveSegment([(64.0 * s, 20.0 * s), (112.0 * s, 100.0 * s)])
    )
    curve.stroke_options = StrokeOptions(
        width=3.0 * s, offset=0.0, miter_clip=1.0, closed=False,
        dynamic_stroke_options_group=0,
        curve_approximation=CurveApproximation.uniform_tangent_angle(0.1),
    )
    paths.append(curve)
    return paths, options


def _content(api, size):
    """Bézier fills and a mitred zig-zag stroke over most of a ``size``²
    frame, as ``api``'s Shapes."""
    s = size / 96.0
    fills = api.Shape(bezier_fill_paths(
        24, size, size, seed=5, margin=8.0 * s, radius=(6.0 * s, 18.0 * s)
    ))
    zigzag = Path(start=(6.0 * s, 20.0 * s))
    for i in range(1, 7):
        zigzag.push_line(LineSegment(
            [((6.0 + 14.0 * i) * s, (20.0 + 56.0 * (i % 2)) * s)]
        ))
    zigzag.stroke_options = StrokeOptions(
        width=5.0 * s, offset=0.0, miter_clip=2.0, closed=False,
        dynamic_stroke_options_group=0,
    )
    stroke = api.Shape(
        [zigzag],
        [DynamicStrokeOptions.make_solid(Join.MITER, Cap.ROUND, Cap.OUT)],
    )
    return fills, stroke


def nested_clip_commands(api, size=96):
    """Two nested clips (a rounded rect, then a circle inside it), one
    group of opacity 0.6 on layer 0 (save and scale fuse into one op),
    fills and a stroke inside them, the unwinding, and a circle drawn
    after the clips.  ``api`` is a renderer module (this package's or the
    reference's) giving Shape, DrawCommand and RenderOperation; render
    with ``alpha_layer_count >= 1`` and front-to-back blending."""
    op = api.RenderOperation
    s = size / 96.0
    fills, stroke = _content(api, size)
    outer = api.Shape([Path.from_rounded_rect(
        (48.0 * s, 48.0 * s), (40.0 * s, 34.0 * s), 10.0 * s
    )])
    inner = api.Shape([Path.from_circle((52.0 * s, 46.0 * s), 36.0 * s)])
    cover = api.Shape([Path.from_rect((48.0 * s, 48.0 * s), (48.0 * s, 48.0 * s))])
    corner = api.Shape([Path.from_circle((8.0 * s, 8.0 * s), 7.0 * s)])
    t = ortho(size, size)
    group = (0.0, 0.0, 0.0, 0.6)
    return [
        api.DrawCommand(op.STENCIL, outer, t),
        api.DrawCommand(op.CLIP, outer, t, clip_depth=1),
        api.DrawCommand(op.STENCIL, inner, t, clip_depth=1),
        api.DrawCommand(op.CLIP, inner, t, clip_depth=2),
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, t, clip_depth=2),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover, t, clip_depth=2,
                        color=group),
        api.DrawCommand(op.STENCIL, fills, t, clip_depth=2),
        api.DrawCommand(op.COLOR, fills, t, clip_depth=2,
                        color=(0.9, 0.4, 0.1, 1.0)),
        api.DrawCommand(op.STENCIL, stroke, t, clip_depth=2),
        api.DrawCommand(op.COLOR, stroke, t, clip_depth=2,
                        color=(0.1, 0.7, 0.9, 0.8)),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, t, clip_depth=2,
                        color=group),
        api.DrawCommand(op.UNCLIP, inner, t, clip_depth=1),
        api.DrawCommand(op.UNCLIP, outer, t, clip_depth=0),
        api.DrawCommand(op.STENCIL, corner, t),
        api.DrawCommand(op.COLOR, corner, t, color=(1.0, 1.0, 1.0, 1.0)),
    ]


def nested_group_commands(api, size=96):
    """Group 0 (opacity 0.7, layer 0; save and scale over two different
    covers, so they stay two ops) around the fills and group 1 (opacity
    0.5, layer 1; save and scale fused) around the stroke.  ``api`` as in
    nested_clip_commands; render with ``alpha_layer_count >= 2``."""
    op = api.RenderOperation
    s = size / 96.0
    fills, stroke = _content(api, size)
    cover = api.Shape([Path.from_rect((48.0 * s, 48.0 * s), (48.0 * s, 48.0 * s))])
    cover_b = api.Shape([Path.from_rect((48.0 * s, 48.0 * s), (47.0 * s, 47.0 * s))])
    t = ortho(size, size)
    outer_g, inner_g = (0.0, 0.0, 0.0, 0.7), (0.0, 0.0, 0.0, 0.5)
    return [
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, t, alpha_layer=0),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover_b, t, color=outer_g),
        api.DrawCommand(op.STENCIL, fills, t),
        api.DrawCommand(op.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)),
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, t, alpha_layer=1),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover, t, alpha_layer=1,
                        color=inner_g),
        api.DrawCommand(op.STENCIL, stroke, t),
        api.DrawCommand(op.COLOR, stroke, t, color=(0.1, 0.7, 0.9, 0.8)),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, t, alpha_layer=1,
                        color=inner_g),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, t, alpha_layer=0,
                        color=outer_g),
    ]
