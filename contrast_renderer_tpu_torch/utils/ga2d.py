"""2D projective geometric algebra on (w, x, y) homogeneous coordinates.

Replaces the reference's `geometric_algebra::ppga2d` usage
(src/utils.rs:3, src/curve.rs:6-10, src/path.rs:8-11, src/stroke.rs:14-16).

Representations (all plain float arrays; every function broadcasts over
leading batch dimensions so the geometry build can be vectorized):

- **point**: shape ``(..., 3)`` = ``(w, x*w, y*w)`` — a homogeneous point.
  ``w == 1`` for unweighted points; rational Bezier control points carry
  their weight in ``w``.
- **line** (the reference calls it a "Plane"): shape ``(..., 3)`` =
  ``(c, a, b)`` representing the oriented line ``a*x + b*y + c = 0``.
  Its direction along the line is ``(b, -a)``; the pair ``(a, b)`` is the
  left normal.  Tangent lines built by :func:`join` through consecutive
  path points use ``(a, b)`` as the 90°-CCW-rotated direction, matching
  the reference's polar-angle bookkeeping (src/curve.rs:230-233).
- **motor**: shape ``(..., 4)`` = ``(m0, m1, m2, m3)`` — an even-grade
  PGA element encoding rotation + translation.  ``(m0, m1)`` is the rotor
  ``cos(θ/2), sin(θ/2)``; ``(m2, m3)`` carry the translation.

Derivation of the sandwich/product formulas is from first principles
(even subalgebra of Cl(2,0,1): U=e12 with U²=-1, two null translation
generators); verified against the reference's observable behavior
(utils.rs:121-140, path.rs:387-439) by the unit tests.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Points and lines
# ---------------------------------------------------------------------------

def vec_to_point(v):
    """Unweighted homogeneous point from (x, y) (reference utils.rs:111-113)."""
    v = np.asarray(v, dtype=np.float64)
    w = np.ones(v.shape[:-1] + (1,), dtype=v.dtype)
    return np.concatenate([w, v], axis=-1)


def weighted_vec_to_point(w, v):
    """Weighted homogeneous point (w, x*w, y*w) (reference utils.rs:116-118)."""
    v = np.asarray(v, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)[..., None]
    return np.concatenate([w, v * w], axis=-1)


def point_to_vec(p):
    """Project a homogeneous point to (x, y) (reference utils.rs:106-108)."""
    p = np.asarray(p, dtype=np.float64)
    return p[..., 1:] / p[..., :1]


def join(p, q):
    """Regressive product of two points: the oriented line through p then q.

    (reference: `RegressiveProduct` on ppga2d points, e.g. path.rs:203-205)

    With points as (w, xw, yw) this is the 3-vector cross product; the
    orientation convention makes ``triple(A, B, C) > 0`` for counter-
    clockwise triangles (in a y-up coordinate system).
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return np.cross(p, q)


def triple(a, b, c):
    """Triple regressive product of three points → scalar.

    Twice the signed area of the triangle (for unit-weight points);
    positive for counterclockwise orientation.
    (reference: chained RegressiveProduct, e.g. convex_hull.rs:16-19,
    curve.rs:137-140)
    """
    return np.sum(join(a, b) * np.asarray(c, dtype=np.float64), axis=-1)


def point_line(p, l):
    """Regressive product of a point with a line → scalar incidence.

    Equals ``w*c + x*a + y*b``; zero iff the point lies on the line.
    (reference: stroke.rs:101, utils.rs:90)
    """
    return np.sum(np.asarray(p, dtype=np.float64) * np.asarray(l, dtype=np.float64), axis=-1)


def meet(a, b):
    """Outer product of two lines: their intersection point, unnormalized.

    (reference utils.rs:67-70 normalizes by component 0; use
    :func:`line_line_intersection` for that behavior)
    """
    return np.cross(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


def line_line_intersection(a, b):
    """Intersection point of two lines, normalized to w == 1
    (reference utils.rs:67-70)."""
    p = meet(a, b)
    return p / p[..., :1]


def inner_ll(a, b):
    """Inner product of two lines → scalar.

    For lines normalized with :func:`signum` this is the cosine of the
    angle between their directions (reference: `InnerProduct` of tangent
    planes, stroke.rs:62).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def outer_ll(a, b):
    """e012-component of the outer product of two lines → scalar.

    The sine of the angle between directions for normalized lines; its
    sign tells which side a turn bends to (reference stroke.rs:66 reads
    component [0] of the outer product).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]


def magnitude(l):
    """Euclidean magnitude of a line: sqrt(a² + b²).

    The join of two unit-weight points has magnitude equal to their
    distance (reference: `Magnitude`, e.g. stroke.rs:156).
    """
    l = np.asarray(l, dtype=np.float64)
    return np.hypot(l[..., 1], l[..., 2])


def squared_magnitude(l):
    l = np.asarray(l, dtype=np.float64)
    return l[..., 1] ** 2 + l[..., 2] ** 2


def signum(l):
    """Normalize a line by its Euclidean magnitude (reference `Signum`).

    Degenerate (zero-direction) lines produce NaN, matching the
    reference's NaN-propagation that the stroke builder relies on
    (stroke.rs:182, 267).
    """
    l = np.asarray(l, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return l / magnitude(l)[..., None]


def rotate_90_degree_clockwise(l):
    """Rotate a line 90° clockwise: (c, a, b) → (0, b, -a)
    (reference utils.rs:101-103; note it drops the c component)."""
    l = np.asarray(l, dtype=np.float64)
    return np.stack(
        [np.zeros_like(l[..., 0]), l[..., 2], -l[..., 1]], axis=-1
    )


def dual_point(p):
    """Dual of a point → line with the same components.

    (reference: `Dual` on ppga2d points, curve.rs:312; component-wise
    identity in this basis up to overall sign, which cancels in the
    root-finding use sites.)
    """
    return np.asarray(p, dtype=np.float64).copy()


def line_through_point_with_direction(direction_line, point):
    """The line through `point` parallel to `direction_line`.

    Re-derives the reference's `tangent.inner_product(vertex)
    .geometric_product(vertex)` construction (stroke.rs:71-75): keep the
    direction (a, b) of `direction_line` and solve c so the (normalized)
    point is incident.
    """
    d = np.asarray(direction_line, dtype=np.float64)
    p = np.asarray(point, dtype=np.float64)
    xy = p[..., 1:] / p[..., :1]
    c = -(d[..., 1] * xy[..., 0] + d[..., 2] * xy[..., 1])
    return np.stack([c, d[..., 1], d[..., 2]], axis=-1)


# ---------------------------------------------------------------------------
# Motors (rotation + translation)
# ---------------------------------------------------------------------------

def rotate2d(angle):
    """Motor rotating CCW by `angle` radians about the origin
    (reference utils.rs:121-124)."""
    angle = np.asarray(angle, dtype=np.float64) * 0.5
    z = np.zeros_like(angle)
    return np.stack([np.cos(angle), np.sin(angle), z, z], axis=-1)


def translate2d(v):
    """Motor translating by vector v (reference utils.rs:127-129)."""
    v = np.asarray(v, dtype=np.float64)
    one = np.ones_like(v[..., 0])
    zero = np.zeros_like(one)
    return np.stack([one, zero, -0.5 * v[..., 1], 0.5 * v[..., 0]], axis=-1)


def rotation2d(motor):
    """Rotation angle in radians of a motor (reference utils.rs:132-134)."""
    motor = np.asarray(motor, dtype=np.float64)
    return 2.0 * np.arctan2(motor[..., 1], motor[..., 0])


def translation2d(motor):
    """Translation vector of a motor (reference utils.rs:137-140)."""
    m = np.asarray(motor, dtype=np.float64)
    m0, m1, m2, m3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    n = m0 * m0 + m1 * m1
    # motor * reverse(rotor part) → pure translator components.
    t2 = (m0 * m2 - m1 * m3) / n
    t3 = (m0 * m3 + m1 * m2) / n
    return np.stack([2.0 * t3, -2.0 * t2], axis=-1)


def motor_product(a, b):
    """Geometric product of two motors: the motor applying b first, then a."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            a0 * b0 - a1 * b1,
            a0 * b1 + a1 * b0,
            a0 * b2 + a2 * b0 - a1 * b3 + a3 * b1,
            a0 * b3 + a3 * b0 + a1 * b2 - a2 * b1,
        ],
        axis=-1,
    )


def motor_apply(motor, point):
    """Sandwich transformation of a homogeneous point by a motor
    (reference `Transformation`)."""
    m = np.asarray(motor, dtype=np.float64)
    p = np.asarray(point, dtype=np.float64)
    m0, m1, m2, m3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    w, x, y = p[..., 0], p[..., 1], p[..., 2]
    rr = m0 * m0 + m1 * m1
    cos2 = m0 * m0 - m1 * m1
    sin2 = 2.0 * m0 * m1
    xo = cos2 * x - sin2 * y + 2.0 * w * (m0 * m3 + m1 * m2)
    yo = cos2 * y + sin2 * x + 2.0 * w * (m1 * m3 - m0 * m2)
    return np.stack([rr * w, xo, yo], axis=-1)


def motor2d_to_mat3(motor):
    """Convert a motor to a 3x3 matrix of basis-point columns
    (reference utils.rs:154-165).

    Returns shape (..., 3, 3): rows [0],[1] are the transformed x/y basis
    directions as (x, y, w)-style triplets and row [2] the transformed
    origin, matching the reference's `[ppga2d::Point; 3]` layout consumed
    by `Path.transform` (path.rs:391-397).
    """
    m = np.asarray(motor, dtype=np.float64)
    rows = []
    for index in (1, 2, 0):
        basis = np.zeros(m.shape[:-1] + (3,), dtype=np.float64)
        basis[..., index] = 1.0
        out = motor_apply(m, basis)
        rows.append(np.stack([out[..., 1], out[..., 2], out[..., 0]], axis=-1))
    return np.stack(rows, axis=-2)


# ---------------------------------------------------------------------------
# Convex polygon helpers
# ---------------------------------------------------------------------------

def aabb_to_convex_polygon(bounding_box):
    """Convert an AABB [min_x, min_y, max_x, max_y] into 4 points
    (reference utils.rs:73-80; note the clockwise-for-SAT ordering)."""
    x0, y0, x1, y1 = bounding_box
    return np.array(
        [[1.0, x0, y0], [1.0, x0, y1], [1.0, x1, y1], [1.0, x1, y0]],
        dtype=np.float64,
    )


def do_convex_polygons_overlap(a, b):
    """Separating axis theorem for two convex polygons of homogeneous
    points, ordered clockwise (reference utils.rs:85-98).

    With this module's orientation conventions, the edge line joined in
    polygon order points its normal outward for clockwise polygons; an
    edge whose line has every vertex of the other polygon strictly on the
    positive (outer) side is a separating axis.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    for first, second in ((a, b), (b, a)):
        n = len(first)
        for index in range(n):
            plane = join(first[index], first[(index + 1) % n])
            if all(point_line(p, plane) > 0.0 for p in second):
                return False
    return True
