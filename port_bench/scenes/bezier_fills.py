"""Bézier fills: closed paths of one integral quadratic or cubic curve
closed by a line, alternately, with random centres, radii and control
points (BASELINE config 2: a batch of integral quadratic and cubic
Bézier fills at 1080p), drawn as one STENCIL and one COLOR in pixel
space (y up).

The geometry is drawn from ``params["geometry_seed"]``, path for path as
the repository's config 2 (``np.random.default_rng``: a centre, a
radius, then four control point offsets in x and four in y).
"""

from __future__ import annotations

import numpy as np

from ..harness.traffic import Scene
from .pixel_space import transforms  # noqa: F401


def build(params, lib):
    w, h = params["width"], params["height"]
    f = params["fills"]
    margin = f["margin"]
    rng = np.random.default_rng(params["geometry_seed"])
    paths = []
    for i in range(f["paths"]):
        cx = rng.uniform(margin, w - margin)
        cy = rng.uniform(margin, h - margin)
        r = rng.uniform(*f["radius"])
        pts = np.stack([cx + rng.uniform(-r, r, 4), cy + rng.uniform(-r, r, 4)], axis=1)
        p = lib.Path(start=(cx - r, cy))
        if i % 2 == 0:
            p.push_integral_quadratic_curve(
                lib.IntegralQuadraticCurveSegment([tuple(pts[0]), tuple(pts[1])]))
        else:
            p.push_integral_cubic_curve(
                lib.IntegralCubicCurveSegment([tuple(pts[0]), tuple(pts[1]),
                                               tuple(pts[2])]))
        p.push_line(lib.LineSegment([(cx - r, cy)]))
        paths.append(p)
    shape = lib.Shape(paths)
    color = tuple(float(c) for c in params["color"])
    commands = [
        lib.DrawCommand(lib.RenderOperation.STENCIL, shape, np.eye(4)),
        lib.DrawCommand(lib.RenderOperation.COLOR, shape, np.eye(4), color=color),
    ]
    return Scene(commands, lambda phase: None)
