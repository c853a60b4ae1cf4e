"""Scenes the port is checked and measured on, and the scalar oracle
that their coverage is held against.  ``Path`` is re-exported for
scripts that build scenes through the port.

Every path builder takes ``geometry``: the module whose ``Path``,
segments, stroke options, caps and joins it builds with; this package's
``path`` module by default.  The builders that return commands take
``api`` as well, the renderer module giving Shape, DrawCommand and
RenderOperation, and ``mixed_paints`` takes ``user_paint``.  These
parameters exist only for the parity tests, which pass the JAX
package's modules to build the same scene for the reference (each
package's tessellator takes only its own Path, since it dispatches on
segment types by identity); other callers leave them at their
defaults."""

from __future__ import annotations

import numpy as np

from . import oracle
from . import path as _path
from .path import Cap, Join, Path  # noqa: F401

def _geo(geometry):
    """The scene's path module: the argument, or this package's."""
    return _path if geometry is None else geometry


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
                      radius=(8.0, 30.0), geometry=None):
    """``n`` closed fills, alternately one integral quadratic and one
    integral cubic Bézier closed by a line, with random centres, radii
    and control points from ``np.random.default_rng(seed)``.

    With the defaults and (1000, 1920, 1080, 0) this is BASELINE config 2
    (benchmarks/run_configs.py::config2), draw for draw."""
    g = _geo(geometry)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        cx = rng.uniform(margin, width - margin)
        cy = rng.uniform(margin, height - margin)
        r = rng.uniform(*radius)
        pts = np.stack(
            [cx + rng.uniform(-r, r, 4), cy + rng.uniform(-r, r, 4)], axis=1
        )
        p = g.Path(start=(cx - r, cy))
        if i % 2 == 0:
            p.push_integral_quadratic_curve(
                g.IntegralQuadraticCurveSegment([tuple(pts[0]), tuple(pts[1])])
            )
        else:
            p.push_integral_cubic_curve(
                g.IntegralCubicCurveSegment(
                    [tuple(pts[0]), tuple(pts[1]), tuple(pts[2])]
                )
            )
        p.push_line(g.LineSegment([(cx - r, cy)]))
        paths.append(p)
    return paths


#: The joins of the dashed-stroke scene's three descriptor groups.
DASHED_JOINS = (Join.MITER, Join.BEVEL, Join.ROUND)


def dashed_options(join, phase, geometry=None):
    """The dashed-stroke scene's two-interval dash pattern (a round-to-
    out dash then a butt dash) with ``join``, at pattern phase
    ``phase``."""
    g = _geo(geometry)
    return g.DynamicStrokeOptions.make_dashed(
        g.Join(int(join)),
        [
            g.DashInterval(gap_start=2.0, gap_end=3.0,
                           dash_start=g.Cap.ROUND, dash_end=g.Cap.OUT),
            g.DashInterval(gap_start=5.0, gap_end=5.5,
                           dash_start=g.Cap.BUTT, dash_end=g.Cap.BUTT),
        ],
        phase=phase,
    )


def dashed_strokes(width, height, seed=1, geometry=None):
    """60 open polylines of 6 random segments each, stroked 10 px wide
    with a mitre clip of 2, in three dash groups (one per join of
    DASHED_JOINS, path i in group i % 3).  Returns ``(paths, options)``,
    the options at phase 0; animate with ``dashed_options(join,
    phase)``.

    With (1920, 1080, 1) this is BASELINE config 3
    (benchmarks/run_configs.py::config3), path for path."""
    g = _geo(geometry)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(60):
        p = g.Path(start=(rng.uniform(100, width - 100),
                          rng.uniform(100, height - 100)))
        for _ in range(6):
            p.push_line(g.LineSegment([
                (rng.uniform(50, width - 50), rng.uniform(50, height - 50))
            ]))
        p.stroke_options = g.StrokeOptions(
            width=10.0, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=i % 3,
            curve_approximation=g.CurveApproximation.uniform_tangent_angle(0.1),
        )
        paths.append(p)
    return paths, [dashed_options(join, 0.0, g) for join in DASHED_JOINS]


#: The cap sheet's frame size.
CAP_SHEET_SIZE = (96, 72)
#: Its cap styles, one stroked line each, top to bottom.
CAP_SHEET_CAPS = (
    Cap.SQUARE, Cap.ROUND, Cap.OUT, Cap.IN, Cap.RIGHT, Cap.LEFT, Cap.BUTT,
)


def cap_sheet(geometry=None):
    """The scene of the cap golden (tests/golden/cap_styles_96x72.npy):
    one 6 px horizontal line per cap style, each its own solid group
    with that cap at both ends.  Returns ``(paths, options)``; render
    it white under ``ortho(*CAP_SHEET_SIZE)`` at 4× MSAA."""
    g = _geo(geometry)
    paths, options = [], []
    for i, cap in enumerate(CAP_SHEET_CAPS):
        y = 8.0 + 8.0 * i
        p = g.Path(start=(24.0, y))
        p.push_line(g.LineSegment([(72.0, y)]))
        p.stroke_options = g.StrokeOptions(
            width=6.0, offset=0.0, miter_clip=1.0, closed=False,
            dynamic_stroke_options_group=i,
        )
        paths.append(p)
        cap = g.Cap(int(cap))
        options.append(g.DynamicStrokeOptions.make_solid(g.Join.MITER, cap, cap))
    return paths, options


def stroke_sampler(size=128, seed=7, geometry=None):
    """A scene that reaches all six stroke classes, with every join and
    several caps: three random open polylines of five segments (from
    ``np.random.default_rng(seed)``), one per group — a solid bevel group
    with round and square caps, a single-interval mitre dash and a
    two-interval round-join dash — and a quadratic curve stroke in the
    solid group, flattened by uniform tangent angle.  Returns ``(paths,
    options)`` for a ``size``² frame under ``ortho``."""
    g = _geo(geometry)
    cap, join = g.Cap, g.Join
    options = [
        g.DynamicStrokeOptions.make_solid(join.BEVEL, cap.ROUND, cap.SQUARE),
        g.DynamicStrokeOptions.make_dashed(
            join.MITER,
            [g.DashInterval(gap_start=4.0, gap_end=6.5,
                            dash_start=cap.OUT, dash_end=cap.BUTT)],
            phase=0.75,
        ),
        g.DynamicStrokeOptions.make_dashed(
            join.ROUND,
            [
                g.DashInterval(gap_start=2.0, gap_end=3.0,
                               dash_start=cap.ROUND, dash_end=cap.IN),
                g.DashInterval(gap_start=5.0, gap_end=5.5,
                               dash_start=cap.LEFT, dash_end=cap.RIGHT),
            ],
            phase=0.25,
        ),
    ]
    s = size / 128.0
    rng = np.random.default_rng(seed)
    paths = []
    for group, width in enumerate((5.0, 4.0, 6.0)):
        p = g.Path(start=tuple(rng.uniform(12 * s, size - 12 * s, 2)))
        for _ in range(5):
            p.push_line(g.LineSegment(
                [tuple(rng.uniform(12 * s, size - 12 * s, 2))]
            ))
        p.stroke_options = g.StrokeOptions(
            width=width * s, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=group,
        )
        paths.append(p)
    curve = g.Path(start=(16.0 * s, 110.0 * s))
    curve.push_integral_quadratic_curve(
        g.IntegralQuadraticCurveSegment(
            [(64.0 * s, 20.0 * s), (112.0 * s, 100.0 * s)]
        )
    )
    curve.stroke_options = g.StrokeOptions(
        width=3.0 * s, offset=0.0, miter_clip=1.0, closed=False,
        dynamic_stroke_options_group=0,
        curve_approximation=g.CurveApproximation.uniform_tangent_angle(0.1),
    )
    paths.append(curve)
    return paths, options


def _content(api, size, g):
    """Bézier fills and a mitred zig-zag stroke over most of a ``size``²
    frame, as ``api``'s Shapes."""
    s = size / 96.0
    fills = api.Shape(bezier_fill_paths(
        24, size, size, seed=5, margin=8.0 * s, radius=(6.0 * s, 18.0 * s),
        geometry=g,
    ))
    zigzag = g.Path(start=(6.0 * s, 20.0 * s))
    for i in range(1, 7):
        zigzag.push_line(g.LineSegment(
            [((6.0 + 14.0 * i) * s, (20.0 + 56.0 * (i % 2)) * s)]
        ))
    zigzag.stroke_options = g.StrokeOptions(
        width=5.0 * s, offset=0.0, miter_clip=2.0, closed=False,
        dynamic_stroke_options_group=0,
    )
    stroke = api.Shape(
        [zigzag],
        [g.DynamicStrokeOptions.make_solid(g.Join.MITER, g.Cap.ROUND, g.Cap.OUT)],
    )
    return fills, stroke


def nested_clip_commands(api, size=96, geometry=None):
    """Two nested clips (a rounded rect, then a circle inside it), one
    group of opacity 0.6 on layer 0 (save and scale fuse into one op),
    fills and a stroke inside them, the unwinding, and a circle drawn
    after the clips.  ``api`` is a renderer module (this package's or the
    reference's) giving Shape, DrawCommand and RenderOperation; render
    with ``alpha_layer_count >= 1`` and front-to-back blending."""
    g = _geo(geometry)
    op = api.RenderOperation
    s = size / 96.0
    fills, stroke = _content(api, size, g)
    outer = api.Shape([g.Path.from_rounded_rect(
        (48.0 * s, 48.0 * s), (40.0 * s, 34.0 * s), 10.0 * s
    )])
    inner = api.Shape([g.Path.from_circle((52.0 * s, 46.0 * s), 36.0 * s)])
    cover = api.Shape([g.Path.from_rect((48.0 * s, 48.0 * s), (48.0 * s, 48.0 * s))])
    corner = api.Shape([g.Path.from_circle((8.0 * s, 8.0 * s), 7.0 * s)])
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


def bracket_commands(api, geometry=None, unclip_transform=None):
    """A clip and an alpha group over the whole viewport around a small
    circle of content in its top-left corner (the reference's bracket
    gating scene, tests/test_renderer.py::TestBracketGating), in NDC:
    binning drops the bracket from the tiles the circle does not reach.
    ``unclip_transform`` moves the UNCLIP's cover, which turns the
    gating off at run time.  ``api`` as in nested_clip_commands; render
    with ``alpha_layer_count >= 1`` and front-to-back blending."""
    g = _geo(geometry)
    op = api.RenderOperation
    identity = np.eye(4, dtype=np.float32)
    clip_shape = api.Shape([g.Path.from_rect((0.0, 0.0), (1.0, 1.0))])
    cover = api.Shape([g.Path.from_rect((0.0, 0.0), (1.0, 1.0))])
    content = api.Shape([g.Path.from_circle((-0.7, 0.7), 0.15)])
    ut = identity if unclip_transform is None else unclip_transform
    return [
        api.DrawCommand(op.STENCIL, clip_shape, identity),
        api.DrawCommand(op.CLIP, clip_shape, identity, clip_depth=1),
        api.DrawCommand(op.SAVE_ALPHA_CONTEXT, cover, identity, clip_depth=1,
                        alpha_layer=0),
        api.DrawCommand(op.SCALE_ALPHA_CONTEXT, cover, identity, clip_depth=1,
                        color=(0.0, 0.0, 0.0, 0.5)),
        api.DrawCommand(op.STENCIL, content, identity, clip_depth=1),
        api.DrawCommand(op.COLOR, content, identity,
                        color=(0.9, 0.4, 0.1, 1.0), clip_depth=1),
        api.DrawCommand(op.RESTORE_ALPHA_CONTEXT, cover, identity,
                        clip_depth=1, color=(0.0, 0.0, 0.0, 0.5),
                        alpha_layer=0),
        api.DrawCommand(op.UNCLIP, clip_shape, ut, clip_depth=0),
    ]


#: rect_clips' clip rectangles in screen pixels (x0, y0, x1, y1), outer
#: then inner, at size 128: their edges lie 0.3 px past a pixel edge,
#: off every sample position.
RECT_CLIPS = ((20.3, 30.3, 100.3, 90.3), (45.3, 40.3, 95.3, 80.3))


def rect_clips(size=128):
    """Content over most of a ``size``² frame (the fills and stroke of
    nested_clip_commands) inside two nested rectangular clips and one
    group of opacity 0.6 on layer 0, so that part of the content lies
    outside each clip; then a circle after the clips.  The clips'
    samples are known in closed form (RECT_CLIPS, scaled by size / 128).
    Render with ``alpha_layer_count >= 1`` and front-to-back blending."""
    from . import renderer as api

    op = api.RenderOperation
    fills, stroke = _content(api, size, _path)
    k = size / 128.0

    def rect(x0, y0, x1, y1):
        # Screen y runs down; the model's y runs up (ortho).
        x0, y0, x1, y1 = x0 * k, y0 * k, x1 * k, y1 * k
        centre = ((x0 + x1) / 2, size - (y0 + y1) / 2)
        return api.Shape([Path.from_rect(centre, ((x1 - x0) / 2, (y1 - y0) / 2))])

    outer, inner = (rect(*r) for r in RECT_CLIPS)
    cover = api.Shape([Path.from_rect((size / 2, size / 2), (size / 2, size / 2))])
    corner = api.Shape([Path.from_circle((8.0 * k, 8.0 * k), 7.0 * k)])
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


def nested_group_commands(api, size=96, geometry=None):
    """Group 0 (opacity 0.7, layer 0; save and scale over two different
    covers, so they stay two ops) around the fills and group 1 (opacity
    0.5, layer 1; save and scale fused) around the stroke.  ``api`` as in
    nested_clip_commands; render with ``alpha_layer_count >= 2``."""
    g = _geo(geometry)
    op = api.RenderOperation
    s = size / 96.0
    fills, stroke = _content(api, size, g)
    cover = api.Shape([g.Path.from_rect((48.0 * s, 48.0 * s), (48.0 * s, 48.0 * s))])
    cover_b = api.Shape([g.Path.from_rect((48.0 * s, 48.0 * s), (47.0 * s, 47.0 * s))])
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


#: The gradient card's corner radius, as a share of the frame height.
CARD_RADIUS = 0.08
#: The gradient card's three stops (offset, straight RGBA), along the
#: card's diagonal from its upper-left to its lower-right corner.
CARD_STOPS = (
    (0.0, (0.08, 0.12, 0.35, 1.0)),
    (0.55, (0.25, 0.10, 0.45, 1.0)),
    (1.0, (0.62, 0.18, 0.35, 1.0)),
)


def gradient_card(width, height, with_text=True):
    """The frame of examples/gradients.py (this package's types): a
    rounded card filled with a three-stop linear gradient along its
    diagonal (CARD_STOPS), a radial glow fading from amber to alpha 0,
    and "Contrast TPU" set in glyphs filled with a two-stop linear
    gradient.  Returns ``(commands, card_axis)``: the commands under
    ``ortho(width, height)``, and the card gradient's model-space
    ``(start, end)``."""
    from . import renderer as api
    from .assets import load_default_font
    from .text import Alignment, Layout, Orientation, paths_of_text
    from .utils import ga2d

    op = api.RenderOperation
    t = ortho(width, height)
    cx, cy = width / 2, height / 2
    start = (cx - 0.42 * width, cy + 0.38 * height)
    end = (cx + 0.42 * width, cy - 0.38 * height)
    card = api.Shape([Path.from_rounded_rect(
        (cx, cy), (0.42 * width, 0.38 * height), CARD_RADIUS * height
    )])
    glow = api.Shape([Path.from_circle((0.72 * width, 0.62 * height),
                                       0.28 * height)])
    draws = [
        (card, api.LinearGradient(start=start, end=end, stops=CARD_STOPS)),
        (glow, api.RadialGradient(
            center=(0.72 * width, 0.62 * height),
            edge=(width, 0.62 * height),
            color0=(1.0, 0.85, 0.3, 0.9),
            color1=(1.0, 0.85, 0.3, 0.0),
        )),
    ]
    if with_text:
        glyphs = paths_of_text(
            load_default_font().face,
            Layout(
                size=0.16 * height,
                orientation=Orientation.LEFT_TO_RIGHT,
                major_alignment=Alignment.CENTER,
                minor_alignment=Alignment.CENTER,
            ),
            "Contrast TPU",
        )
        center = ga2d.translate2d(np.array([cx, cy]))
        text = api.Shape([glyph.transform(1.0, center) for glyph in glyphs])
        draws.append((text, api.LinearGradient(
            start=(cx - 0.3 * width, cy), end=(cx + 0.3 * width, cy),
            color0=(1.0, 1.0, 1.0, 1.0), color1=(0.6, 0.9, 1.0, 1.0),
        )))
    commands = []
    for shape, paint in draws:
        commands += [
            api.DrawCommand(op.STENCIL, shape, t),
            api.DrawCommand(op.COLOR, shape, t, color=paint),
        ]
    return commands, (start, end)


#: The mixed frame's checker colours (straight RGBA): cells of 4 × 4
#: pixels alternate between these two.
CHECKER_COLORS = ((1.0, 0.0, 1.0, 0.8), (0.0, 1.0, 0.0, 0.8))

#: The checker as the device function of a UserPaint (``cuda``).
CHECKER_CUDA = """
__device__ float4 paint(float px, float py, float x0, float y0, float x1,
                        float y1) {
  const int c = ((int)floorf(px / 4.0f) + (int)floorf(py / 4.0f)) % 2;
  const float v = (float)c;
  return make_float4(v, 1.0f - v, v, 0.8f);
}
"""


def checker(px, py, anchor):
    """The checker as the torch function of a UserPaint (``fn``), the
    same steps as CHECKER_CUDA: 4-pixel cells, colour c or 1 - c."""
    import torch

    c = ((px // 4).to(torch.int32) + (py // 4).to(torch.int32)) % 2
    c = c.to(torch.float32)
    return c, 1.0 - c, c, torch.full_like(c, 0.8)


def mixed_paints(width, height, api=None, geometry=None, user_paint=None):
    """A frame of every paint kind (tests/test_coverage_exec.py's mixed
    frame, scaled by min(width, height)/64 into the frame's left
    square): a disc with a two-stop linear gradient, an instanced pair
    of squares in solid colour, and a disc painted by the checker
    UserPaint.  Render it under depth (less_equal, with write) to reach
    every per-draw table the colour cover reads.  For the parity tests
    only: ``api`` is a renderer module (default this package's) and
    ``user_paint`` the checker paint (default this package's UserPaint
    of ``checker`` and ``CHECKER_CUDA``)."""
    if api is None:
        from . import renderer as api
    g = _geo(geometry)
    if user_paint is None:
        user_paint = api.UserPaint(checker, cuda=CHECKER_CUDA)
    op = api.RenderOperation
    s = min(width, height) / 64.0
    disc = api.Shape([g.Path.from_circle((16.0 * s, 16.0 * s), 12.0 * s)])
    rect = api.Shape([g.Path.from_rect((16.0 * s, 16.0 * s), (10.0 * s, 10.0 * s))])
    grad = api.LinearGradient(
        start=(4.0 * s, 16.0 * s), end=(28.0 * s, 16.0 * s),
        color0=(1.0, 0.0, 0.0, 1.0), color1=(0.0, 0.0, 1.0, 0.5),
    )

    def t(ox, oy):
        m = ortho(width, height)
        m[0, 3] += 2.0 * ox * s / width
        m[1, 3] += 2.0 * oy * s / height
        return m

    stacked = np.stack([t(0, 0), t(24, 24)])
    return [
        api.DrawCommand(op.STENCIL, disc, t(4, 4)),
        api.DrawCommand(op.COLOR, disc, t(4, 4), color=grad),
        api.DrawCommand(op.STENCIL, rect, stacked),
        api.DrawCommand(op.COLOR, rect, stacked, color=(0.2, 0.9, 0.4, 0.7)),
        api.DrawCommand(op.STENCIL, disc, t(20, 2)),
        api.DrawCommand(op.COLOR, disc, t(20, 2), color=user_paint),
    ]


#: The warp-boundary scene's frame size: two tile columns.
BOUNDARY_SIZE = (256, 64)


def warp_boundaries():
    """Commands of a frame whose entries sit on the kernel's culling
    boundaries (``BOUNDARY_SIZE``, 4× MSAA): fill triangles whose boxes
    end exactly on warp footprints (x a multiple of 8 or 32) and on tile
    boundaries, one whose vertices lie on sample positions, two slivers,
    a quadratic fill from one warp boundary to another; a stroke 0.25 px
    wide whose inside samples all lie in pixel column 8 (at sample x
    offset 0.375: one lane in each row of its warps), a horizontal stroke
    whose edges lie on pixel rows and on a tile boundary, and a dashed
    polyline with a round join.  Coordinates below are in pixels, y
    down."""
    from . import renderer as api

    width, height = BOUNDARY_SIZE

    def at(x, y):
        return (float(x), float(height - y))

    def polygon(*points):
        p = Path(start=at(*points[0]))
        for point in points[1:] + points[:1]:
            p.push_line(_path.LineSegment([at(*point)]))
        return p

    fills = [
        polygon((32, 8), (64, 8), (32, 24)),
        polygon((96, 16), (128, 16), (128, 32)),
        polygon((128, 32), (160, 32), (128, 48)),
        polygon((40.375, 40.125), (72.875, 40.375), (40.125, 56.625)),
        polygon((0, 60), (192, 60), (192, 60.5)),
        polygon((130, 2), (250, 58), (251, 58)),
    ]
    curve = Path(start=at(160, 24))
    curve.push_integral_quadratic_curve(
        _path.IntegralQuadraticCurveSegment([at(192, 4), at(224, 24)])
    )
    curve.push_line(_path.LineSegment([at(160, 24)]))
    fills.append(curve)

    def stroke(points, width_px, group):
        p = Path(start=at(*points[0]))
        for point in points[1:]:
            p.push_line(_path.LineSegment([at(*point)]))
        p.stroke_options = _path.StrokeOptions(
            width=width_px, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=group,
        )
        return p

    strokes = [
        stroke([(8.375, 4), (8.375, 60)], 0.25, 0),
        stroke([(64, 30), (192, 30)], 4.0, 0),
        stroke([(200, 8), (232, 40), (248, 8)], 3.0, 1),
    ]
    options = [
        _path.DynamicStrokeOptions.make_solid(Join.BEVEL, Cap.BUTT, Cap.BUTT),
        _path.DynamicStrokeOptions.make_dashed(
            Join.ROUND,
            [_path.DashInterval(gap_start=4.0, gap_end=6.0,
                                dash_start=Cap.ROUND, dash_end=Cap.BUTT)],
            phase=0.5,
        ),
    ]
    op = api.RenderOperation
    fill, line = api.Shape(fills), api.Shape(strokes, options)
    t = ortho(width, height)
    return [
        api.DrawCommand(op.STENCIL, fill, t),
        api.DrawCommand(op.COLOR, fill, t, color=(0.9, 0.4, 0.1, 1.0)),
        api.DrawCommand(op.STENCIL, line, t),
        api.DrawCommand(op.COLOR, line, t, color=(0.1, 0.7, 0.9, 0.8)),
    ]


def thin_strokes(size=128, geometry=None):
    """Thin diagonal strokes, whose culling boxes are loose: twelve
    lines from 0.3 to 1.4 px wide at angles from 5 to 148 degrees
    through a ``size``² frame (solid, butt caps), and two zigzag
    polylines 0.8 and 1.2 px wide, one with a single-interval dash and
    round joins, one with a two-interval dash and mitre joins.  Returns
    ``(paths, options)`` for a ``size``² frame under ``ortho``."""
    g = _geo(geometry)
    cap, join = g.Cap, g.Join
    options = [
        g.DynamicStrokeOptions.make_solid(join.BEVEL, cap.BUTT, cap.BUTT),
        g.DynamicStrokeOptions.make_dashed(
            join.ROUND,
            [g.DashInterval(gap_start=3.0, gap_end=5.0,
                            dash_start=cap.ROUND, dash_end=cap.BUTT)],
            phase=0.25,
        ),
        g.DynamicStrokeOptions.make_dashed(
            join.MITER,
            [
                g.DashInterval(gap_start=2.0, gap_end=3.0,
                               dash_start=cap.BUTT, dash_end=cap.SQUARE),
                g.DashInterval(gap_start=5.0, gap_end=6.5,
                               dash_start=cap.OUT, dash_end=cap.IN),
            ],
            phase=0.5,
        ),
    ]

    def line(points, width, group):
        p = g.Path(start=points[0])
        for point in points[1:]:
            p.push_line(g.LineSegment([point]))
        p.stroke_options = g.StrokeOptions(
            width=width, offset=0.0, miter_clip=3.0, closed=False,
            dynamic_stroke_options_group=group,
        )
        return p

    c = size / 2.0
    paths = []
    for i in range(12):
        angle = np.radians(5.0 + 13.0 * i)
        dx, dy = np.cos(angle) * 0.45 * size, np.sin(angle) * 0.45 * size
        paths.append(line([(c - dx, c - dy), (c + dx, c + dy)], 0.3 + 0.1 * i, 0))
    zig = [(0.08 * size + 0.12 * size * k, (0.2 if k % 2 else 0.3) * size)
           for k in range(8)]
    paths.append(line(zig, 0.8, 1))
    paths.append(line([(x, size - y) for x, y in zig], 1.2, 2))
    return paths, options


def stroke_over_fill(size=64, api=None, geometry=None):
    """One stencil command whose shape has fill and stroke rows that
    cover the same samples: a square (the middle half of a ``size``²
    frame) and a horizontal stroke across it (0.2·size wide, butt caps),
    then its colour cover.  With a one-bit winding counter (even-odd),
    a sample inside both ends covered only if the stroke OR precedes the
    fill's add (0 -> 1 -> 2, even) and not the other way (±1, odd)."""
    g = _geo(geometry)
    if api is None:
        from . import renderer as api
    square = g.Path(start=(0.25 * size, 0.25 * size))
    for x, y in ((0.75, 0.25), (0.75, 0.75), (0.25, 0.75), (0.25, 0.25)):
        square.push_line(g.LineSegment([(x * size, y * size)]))
    line = g.Path(start=(0.1 * size, 0.5 * size))
    line.push_line(g.LineSegment([(0.9 * size, 0.5 * size)]))
    line.stroke_options = g.StrokeOptions(
        width=0.2 * size, offset=0.0, miter_clip=1.0, closed=False,
        dynamic_stroke_options_group=0,
    )
    shape = api.Shape(
        [square, line],
        [g.DynamicStrokeOptions.make_solid(g.Join.BEVEL, g.Cap.BUTT, g.Cap.BUTT)],
    )
    t = ortho(size, size)
    op = api.RenderOperation
    return [
        api.DrawCommand(op.STENCIL, shape, t),
        api.DrawCommand(op.COLOR, shape, t, color=(1.0, 1.0, 1.0, 1.0)),
    ]


#: BASELINE config 4's text (benchmarks/run_configs.py::config4): 112
#: lines of two pangrams with digits, 10,080 glyphs.
CONFIG4_TEXT = "\n".join(
    "the quick brown fox jumps over the lazy dog 0123456789 " * 2
    for _ in range(112)
)
#: The three command forms of config 4's text.
CONFIG4_FORMS = ("monolith", "fused", "per_glyph")


def config4_transform():
    """Config 4's layout → clip transform: its glyph box, about
    [0, 850] × [-200, 1370] layout units, onto the viewport."""
    t = np.diag([2.0 / 1800.0, 2.0 / 1500.0, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = 0.95
    return t


def config4_text(form, api=None, text_module=None, text=None,
                 transform=None):
    """BASELINE config 4 (10k TrueType glyphs; 1920×1080 in the
    benchmark) as draw commands in one of CONFIG4_FORMS, all in colour
    (1, 1, 1, 1):

    - ``"monolith"``: ``shape_of_text``, one STENCIL and one COLOR over
      one shape holding every glyph instance's triangles;
    - ``"fused"``: ``text_commands_fused``, one multi-shape STENCIL over
      the per-glyph shapes and one cover of the string's ink box;
    - ``"per_glyph"``: ``text_commands``, one instanced pair per unique
      glyph, with overlapping instances split into single pairs.

    The text is set in the bundled font at size 16, left to right,
    aligned at its beginning on both axes, under ``config4_transform()``;
    the commands do not depend on the frame's size.  ``text`` and
    ``transform`` replace CONFIG4_TEXT and that transform (the CPU tests
    set a short text larger).  ``api`` and ``text_module`` are the
    renderer and text modules to build with, this package's by default
    (each text module builds with its own path module); the parity tests
    pass the JAX package's."""
    if form not in CONFIG4_FORMS:
        raise ValueError(f"form must be one of {CONFIG4_FORMS}, got {form!r}")
    if api is None:
        from . import renderer as api
    if text_module is None:
        from . import text as text_module
    from .assets import font_path

    with open(font_path(), "rb") as fh:
        face = text_module.Font("OpenSans", fh.read()).face
    layout = text_module.Layout(
        size=16.0,
        orientation=text_module.Orientation.LEFT_TO_RIGHT,
        major_alignment=text_module.Alignment.BEGIN,
        minor_alignment=text_module.Alignment.BEGIN,
    )
    text = CONFIG4_TEXT if text is None else text
    t = config4_transform() if transform is None else np.asarray(
        transform, np.float32
    )
    color = (1.0, 1.0, 1.0, 1.0)
    if form == "monolith":
        shape = text_module.shape_of_text(face, layout, text)
        op = api.RenderOperation
        return [
            api.DrawCommand(op.STENCIL, shape, t),
            api.DrawCommand(op.COLOR, shape, t, color=color),
        ]
    build = (
        text_module.text_commands_fused if form == "fused"
        else text_module.text_commands
    )
    return build(face, layout, text, t, color=color)
