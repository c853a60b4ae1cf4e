"""2D convex hull (Andrew's monotone chain).

Mirrors reference src/convex_hull.rs:7-40: lexicographic sort, pop while
the turn is not strictly counterclockwise beyond ERROR_MARGIN (removing
collinear points), two chains.  Output is the hull in counterclockwise
order, which downstream code triangulates as a fan of CCW triangles for
the cover passes.
"""

from __future__ import annotations

import numpy as np

from .error import ERROR_MARGIN


def _cross(o, a, b):
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def outer_polygon(hull, k: int = 16) -> np.ndarray:
    """Conservative k-gon superset of a convex hull (a k-DOP).

    The cover passes only need a convex region *containing* the shape:
    painting is gated by the winding counter (zero outside the shape)
    and the alpha-group algebra is the identity on un-inked pixels, so
    enlarging the cover region never changes output — it only bounds
    the per-tile hull-line work.  A dense hull (e.g. 68 vertices for the
    showcase shape, from sampled round corners) costs every boundary
    tile |hull| line evaluations per sample; capping at k=16 supporting
    directions bounds that at ~2% area overshoot (1/cos(pi/k)).
    """
    hull = np.asarray(hull, dtype=np.float64).reshape(-1, 2)
    if len(hull) <= k:
        return hull
    ang = np.arange(k) * (2.0 * np.pi / k)
    d = np.stack([np.cos(ang), np.sin(ang)], axis=-1)      # (k, 2)
    h = (hull @ d.T).max(axis=0)                           # support values
    nxt = (np.arange(k) + 1) % k
    a1, b1, c1 = d[:, 0], d[:, 1], h
    a2, b2, c2 = d[nxt, 0], d[nxt, 1], h[nxt]
    det = a1 * b2 - a2 * b1                                # sin(2*pi/k) > 0
    x = (c1 * b2 - c2 * b1) / det
    y = (a1 * c2 - a2 * c1) / det
    return np.stack([x, y], axis=-1)


def _prune_interior(pts: np.ndarray, k: int = 16) -> np.ndarray:
    """Drop points that provably cannot be on the hull.

    The argmax points of k support directions are hull vertices; their
    convex polygon is inside the hull, so any point strictly inside it
    (with margin) is interior.  Vectorized — the sequential chain then
    runs on the few survivors (large proto-hulls, e.g. a 10k-glyph
    scene's ~600k points, are otherwise dominated by Python turn
    tests).

    Points on (or within ERROR_MARGIN doubled-area of) a chord between
    two extremes are also dropped: a chord between hull vertices lies
    inside the hull, so such points are interior or collinear — the
    sequential chain would remove them anyway (it pops turns
    ≤ ERROR_MARGIN).  This matters for text scenes, where every glyph
    on a line contributes points exactly on the block's bounding edges.
    The extremes themselves are re-appended since they sit on their own
    chords."""
    ang = np.arange(k) * (2.0 * np.pi / k)
    d = np.stack([np.cos(ang), np.sin(ang)], axis=-1)       # (k, 2)
    support = pts @ d.T                                     # (n, k)
    extreme = pts[np.argmax(support, axis=0)]               # (k, 2)
    # Deduplicate consecutive repeats, keep direction (= CCW) order.
    keep = np.any(extreme != np.roll(extreme, 1, axis=0), axis=1)
    poly = extreme[keep]
    if len(poly) < 3:
        return pts
    a = poly
    b = np.roll(poly, -1, axis=0)
    e = (b[:, 0] - a[:, 0])[None, :] * (pts[:, 1:2] - a[:, 1][None, :]) - (
        b[:, 1] - a[:, 1]
    )[None, :] * (pts[:, 0:1] - a[:, 0][None, :])
    interior = np.all(e > -ERROR_MARGIN, axis=1)
    return np.concatenate([pts[~interior], poly], axis=0)


def andrew(input_points) -> np.ndarray:
    """Convex hull of (n, 2) points, counterclockwise, collinear points
    removed (up to ERROR_MARGIN in doubled-area units)."""
    pts = np.asarray(input_points, dtype=np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return pts.copy()
    if len(pts) > 1024:
        from . import native

        if native.available():
            return native.convex_hull(pts, ERROR_MARGIN)
        pts = _prune_interior(pts)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]
    hull = []
    for p in pts:
        while len(hull) > 1 and _cross(hull[-2], hull[-1], p) <= ERROR_MARGIN:
            hull.pop()
        hull.append(p)
    hull.pop()
    t = len(hull) + 1
    for p in pts[::-1]:
        while len(hull) > t and _cross(hull[-2], hull[-1], p) <= ERROR_MARGIN:
            hull.pop()
        hull.append(p)
    hull.pop()
    return np.array(hull)
