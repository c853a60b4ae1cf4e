"""Dashed polylines: open paths of random line segments stroked with a
two-interval dash pattern, in one dash group per join (BASELINE config
3: miter, bevel and round joins, round/out and butt caps, an animated
dash phase), drawn as one STENCIL and one COLOR in pixel space (y up).

The geometry is drawn from ``params["geometry_seed"]``, path for path as
the repository's config 3 (``np.random.default_rng``: a start point,
then each segment's end point).
"""

from __future__ import annotations

import numpy as np

from ..harness.traffic import Scene
from .pixel_space import transforms  # noqa: F401


def _dash(params, lib, join, phase):
    return lib.DynamicStrokeOptions.make_dashed(
        lib.Join[join],
        [lib.DashInterval(gap_start=i[0], gap_end=i[1],
                          dash_start=lib.Cap[i[2]], dash_end=lib.Cap[i[3]])
         for i in params["dash"]["intervals"]],
        phase=phase,
    )


def build(params, lib):
    w, h = params["width"], params["height"]
    s = params["strokes"]
    joins = params["dash"]["joins"]
    rng = np.random.default_rng(params["geometry_seed"])
    paths = []
    for i in range(s["paths"]):
        p = lib.Path(start=(rng.uniform(s["start_margin"], w - s["start_margin"]),
                            rng.uniform(s["start_margin"], h - s["start_margin"])))
        for _ in range(s["segments"]):
            p.push_line(lib.LineSegment([
                (rng.uniform(s["point_margin"], w - s["point_margin"]),
                 rng.uniform(s["point_margin"], h - s["point_margin"]))
            ]))
        p.stroke_options = lib.StrokeOptions(
            width=s["width"], offset=0.0, miter_clip=s["miter_clip"], closed=False,
            dynamic_stroke_options_group=i % len(joins),
            curve_approximation=lib.CurveApproximation.uniform_tangent_angle(
                s["tangent_angle"]),
        )
        paths.append(p)
    shape = lib.Shape(paths, [_dash(params, lib, j, 0.0) for j in joins])
    color = tuple(float(c) for c in params["color"])
    commands = [
        lib.DrawCommand(lib.RenderOperation.STENCIL, shape, np.eye(4)),
        lib.DrawCommand(lib.RenderOperation.COLOR, shape, np.eye(4), color=color),
    ]

    def set_phase(phase):
        for g, j in enumerate(joins):
            shape.set_dynamic_stroke_options(g, _dash(params, lib, j, phase))

    return Scene(commands, set_phase)

