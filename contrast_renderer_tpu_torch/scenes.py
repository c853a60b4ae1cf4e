"""Scenes the port is checked and measured on, built from the shared
``path`` module so that both packages can tessellate the same paths,
and the shared scalar oracle that their coverage is held against.
``Path`` is re-exported for scripts that build scenes through the port."""

from __future__ import annotations

import numpy as np

from contrast_renderer_tpu import oracle
from contrast_renderer_tpu.path import (
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    LineSegment,
    Path,
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
