"""3D projective geometric algebra helpers on (w, x, y, v) coordinates.

Replaces the `geometric_algebra::ppga3d` usage of the fill tessellator
(reference src/fill.rs:70-85), where 2D control points are lifted into a
third dimension carrying the Loop-Blinn implicit weight, and the plane
through three lifted points becomes the screen-space interpolation plane
of that weight.
"""

from __future__ import annotations

import numpy as np


def join3(p0, p1, p2):
    """Regressive product of three homogeneous 4D points → plane 4-vector.

    The plane n satisfies ``dot(n, p) == 0`` for all three points; computed
    as the 4D generalized cross product (cofactor expansion).  The overall
    sign is irrelevant to callers because `weight_planes` re-normalizes by
    the last component (reference fill.rs:81).

    Broadcasts over leading dimensions; inputs shape (..., 4).
    """
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    m = np.stack([p0, p1, p2], axis=-2)  # (..., 3, 4)
    out = np.empty(p0.shape, dtype=np.float64)
    cols = np.arange(4)
    for k in range(4):
        minor = m[..., :, cols[cols != k]]  # (..., 3, 3)
        out[..., k] = ((-1.0) ** k) * np.linalg.det(minor)
    return out


def normalize4(v):
    """Normalize a 4-vector by its L2 norm (reference: `Signum` on a
    ppga3d Rotor holding the inflection-point polynomial coefficients,
    curve.rs:142)."""
    v = np.asarray(v, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        # Zero input propagates NaN, matching the reference's 0/0 behavior
        # for fully degenerate (collinear) cubics; downstream threshold
        # comparisons filter these out.
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
