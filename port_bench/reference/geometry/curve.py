"""Bezier curve math in power basis form.

Mirrors the reference's curve module (src/curve.rs): power-basis
conversion, linear reparametrization (splitting/trimming), point and
derivative evaluation, the inflection-point polynomial and its root
classification (Loop-Blinn serpentine/cusp/loop), and uniform-tangent-
angle parameter generation for stroking.

All control points / power-basis rows are homogeneous (w, x*w, y*w)
arrays of shape (n, 3); "lines"/"tangents" are (3,) arrays per
`utils.ga2d` conventions.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .error import ERROR_MARGIN
from . import ga2d, ga3d
from .polynomial import (
    ROOT_AT_INFINITY,
    Root,
    solve_cubic,
    solve_linear,
    solve_quadratic,
    solve_quartic,
)

F32_EPSILON = float(np.finfo(np.float32).eps)

# Bernstein → power basis matrices (rows: power-basis coefficient =
# matrix row · control points); reference curve.rs:26-42.
_QUADRATIC_POWER = np.array(
    [[1.0, 0.0, 0.0], [-2.0, 2.0, 0.0], [1.0, -2.0, 1.0]]
)
_CUBIC_POWER = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [-3.0, 3.0, 0.0, 0.0],
        [3.0, -6.0, 3.0, 0.0],
        [-1.0, 3.0, -3.0, 1.0],
    ]
)


def rational_quadratic_control_points_to_power_basis(control_points):
    """(3,3) control points → (3,3) power basis (curve.rs:26-32)."""
    return _QUADRATIC_POWER @ np.asarray(control_points, dtype=np.float64)


def rational_cubic_control_points_to_power_basis(control_points):
    """(4,3) control points → (4,3) power basis (curve.rs:35-42)."""
    return _CUBIC_POWER @ np.asarray(control_points, dtype=np.float64)


def reparametrize_rational_quadratic(power_basis, a, b):
    """Linear reparametrization of a quadratic to [a, b]
    (curve.rs:47-53); usable for splitting, trimming and blossoming."""
    pb = np.asarray(power_basis, dtype=np.float64)
    m = np.array(
        [
            [1.0, a, a * a],
            [0.0, b - a, 2.0 * a * (b - a)],
            [0.0, 0.0, (a - b) ** 2],
        ]
    )
    return m @ pb


def reparametrize_rational_cubic(power_basis, a, b):
    """Linear reparametrization of a cubic to [a, b] (curve.rs:58-83)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    d = b - a
    m = np.array(
        [
            [1.0, a, a * a, a**3],
            [0.0, d, 2.0 * a * d, 3.0 * a * a * d],
            [0.0, 0.0, d * d, 3.0 * a * d * d],
            [0.0, 0.0, 0.0, d**3],
        ]
    )
    return m @ pb


def rational_quadratic_point(power_basis, t):
    """Homogeneous point at parameter t (curve.rs:86-88)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    basis = np.stack([np.ones_like(t), t, t * t], axis=-1)
    return basis @ pb


def rational_quadratic_first_order_derivative(power_basis, t):
    """Tangent line at parameter t: p(t) ∨ p'(t) (curve.rs:91-95)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    p = np.stack([np.ones_like(t), t, t * t], axis=-1) @ pb
    d1 = np.stack([np.zeros_like(t), np.ones_like(t), 2.0 * t], axis=-1) @ pb
    return ga2d.join(p, d1)


def rational_quadratic_second_order_derivative(power_basis, t):
    """Second-order derivative line (curve.rs:98-102)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    p = rational_quadratic_point(pb, t)
    return ga2d.join(p, 2.0 * pb[2])


def rational_cubic_point(power_basis, t):
    """Homogeneous point at parameter t (curve.rs:105-107)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    basis = np.stack([np.ones_like(t), t, t * t, t**3], axis=-1)
    return basis @ pb


def rational_cubic_first_order_derivative(power_basis, t):
    """Tangent line at parameter t (curve.rs:110-114)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    p = np.stack([np.ones_like(t), t, t * t, t**3], axis=-1) @ pb
    d1 = (
        np.stack(
            [np.zeros_like(t), np.ones_like(t), 2.0 * t, 3.0 * t * t], axis=-1
        )
        @ pb
    )
    return ga2d.join(p, d1)


def rational_cubic_second_order_derivative(power_basis, t):
    """Second-order derivative line (curve.rs:117-121)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    p = rational_cubic_point(pb, t)
    d2 = np.stack([np.zeros_like(t), np.zeros_like(t), np.full_like(t, 2.0), 6.0 * t], axis=-1) @ pb
    return ga2d.join(p, d2)


def rational_cubic_third_order_derivative(power_basis, t):
    """Third-order derivative line (curve.rs:124-130)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    p = rational_cubic_point(pb, t)
    d1 = np.stack([np.zeros_like(t), np.ones_like(t), 2.0 * t, 3.0 * t * t], axis=-1) @ pb
    d2 = np.stack([np.zeros_like(t), np.zeros_like(t), np.full_like(t, 2.0), 6.0 * t], axis=-1) @ pb
    d3 = 6.0 * pb[3]
    return ga2d.join(p, d3) + ga2d.join(d1, d2)


def inflection_point_polynomial_coefficients(power_basis, integral: bool):
    """Coefficients of the inflection point polynomial of a cubic
    (curve.rs:133-144), normalized to a unit 4-vector.

    ippc[j] = ±det of the power basis rows excluding row j; for integral
    cubics ippc[0] (which would involve only w-free rows) is forced to 0.
    """
    pb = np.asarray(power_basis, dtype=np.float64)
    ippc = np.zeros(4)
    for j in range(1 if integral else 0, 4):
        rows = [pb[i] for i in range(4) if i != j]
        sign = float(j % 2 * 2 - 1)
        ippc[j] = ga2d.triple(rows[0], rows[1], rows[2]) * sign
    return ga3d.normalize4(ippc)


def integral_inflection_points(
    ippc, loop_self_intersection: bool
) -> Tuple[float, List[Root]]:
    """Roots of the inflection point polynomial of an integral cubic,
    plus the classifying discriminant (curve.rs:146-190).

    discriminant > 0: serpentine/arch; < 0: loop; == 0: cusp.  With
    `loop_self_intersection`, the two returned roots of a loop lie at the
    self-intersection parameters.
    """
    d1, d2, d3 = ippc[1], ippc[2], ippc[3]
    discriminant = 3.0 * d2 * d2 - 4.0 * d1 * d3
    if abs(d1) <= ERROR_MARGIN:
        if abs(d2) <= ERROR_MARGIN:
            return (
                -1.0,
                [Root(complex(-1.0, 0.0), 1.0), ROOT_AT_INFINITY, ROOT_AT_INFINITY],
            )
        return (
            1.0,
            [Root(complex(d3, 0.0), 3.0 * d2), ROOT_AT_INFINITY, ROOT_AT_INFINITY],
        )
    if discriminant < 0.0:
        factor = -1.0 if loop_self_intersection else 0.0
    else:
        factor = 1.0 / 3.0
    d = math.sqrt(discriminant * factor)
    return (
        discriminant,
        [
            Root(complex(d2 + d, 0.0), 2.0 * d1),
            Root(complex(d2 - d, 0.0), 2.0 * d1),
            ROOT_AT_INFINITY,
        ],
    )


def rational_inflection_points(
    ippc, loop_self_intersection: bool
) -> Tuple[float, List[Root]]:
    """Roots of the inflection point polynomial of a rational cubic
    (curve.rs:192-226).

    Solves the cubic ``-d3 + 3·d2·t - 3·d1·t² + d0·t³``; for loops with
    `loop_self_intersection` the double-point parameters come from the
    Hessian quadratic and the returned discriminant is negated so that
    a loop is reported as negative.
    """
    d0, d1, d2, d3 = ippc
    if abs(d0) <= ERROR_MARGIN:
        return integral_inflection_points(ippc, loop_self_intersection)
    discriminant, roots, real_root = solve_cubic(
        (-d3, 3.0 * d2, -3.0 * d1, d0), ERROR_MARGIN
    )
    roots = list(roots[:3])
    if not loop_self_intersection:
        return (discriminant, roots)
    hessian_disc, hessian_roots = solve_quadratic(
        (
            d1 * d3 - d2 * d2,
            d1 * d2 - d0 * d3,
            d0 * d2 - d1 * d1,
        ),
        ERROR_MARGIN,
    )
    if hessian_disc > 0.0:
        roots[2] = roots[real_root]
        if len(hessian_roots) == 2:
            roots[0], roots[1] = hessian_roots[0], hessian_roots[1]
        elif len(hessian_roots) == 1:
            roots[0] = hessian_roots[0]
            roots[1] = ROOT_AT_INFINITY
    return (-hessian_disc, roots)


# ---------------------------------------------------------------------------
# Uniform tangent angle sampling
# ---------------------------------------------------------------------------

def _interpolate_normal(start_tangent, end_tangent, angle_step, solve_for_normal):
    """Walk the tangent angle from start to end in uniform polar steps,
    solving for the curve parameter of each intermediate angle
    (curve.rs:228-252).

    `solve_for_normal(normal)` returns the candidate `Root`s for the
    parameter whose tangent direction matches `normal`; the first one
    with a real value in [0, 1] wins, else 0.0.
    """
    ps = complex(start_tangent[1], start_tangent[2])
    pe = complex(end_tangent[1], end_tangent[2])
    if ps == 0 or pe == 0 or not (np.isfinite(ps.real) and np.isfinite(pe.real)):
        return []
    polar_range = pe / ps
    arg = math.atan2(polar_range.imag, polar_range.real)
    if not math.isfinite(arg / angle_step):
        return []
    steps = int(abs(arg / angle_step) + 0.5)
    if steps <= 1:
        return []
    step_angle = arg / steps
    polar_step = complex(math.cos(step_angle), math.sin(step_angle))
    parameters = []
    interpolated = ps
    for _ in range(1, steps):
        interpolated = interpolated * polar_step
        normal = np.array([0.0, interpolated.real, interpolated.imag])
        parameter = 0.0
        for root in solve_for_normal(normal):
            if root.denominator == 0.0:
                continue
            value = root.numerator.real / root.denominator
            if 0.0 <= value <= 1.0:
                parameter = value
                break
        parameters.append(parameter)
    return parameters


def _normal_fan(start_tangent, end_tangent, angle_step):
    """The (N, 2) direction components of `_interpolate_normal`'s
    intermediate normals (the uniform polar walk, curve.rs:228-252),
    or None when the walk has fewer than 2 steps."""
    ps = complex(start_tangent[1], start_tangent[2])
    pe = complex(end_tangent[1], end_tangent[2])
    if ps == 0 or pe == 0 or not (np.isfinite(ps.real) and np.isfinite(pe.real)):
        return None
    polar_range = pe / ps
    arg = math.atan2(polar_range.imag, polar_range.real)
    if not math.isfinite(arg / angle_step):
        return None
    steps = int(abs(arg / angle_step) + 0.5)
    if steps <= 1:
        return None
    k = np.arange(1, steps, dtype=np.float64)
    rot = np.exp(1j * (arg / steps) * k) * ps
    return np.stack([rot.real, rot.imag], axis=-1)


def _first_root_in_unit_interval(r1, v1, r2, v2):
    """Vectorized `_interpolate_normal` root selection: the first valid
    candidate with a value in [0, 1], else the second, else 0."""
    with np.errstate(invalid="ignore"):
        ok1 = v1 & (r1 >= 0.0) & (r1 <= 1.0)
        ok2 = v2 & (r2 >= 0.0) & (r2 <= 1.0)
    return np.where(ok1, r1, np.where(ok2, r2, 0.0))


def integral_quadratic_uniform_tangent_angle(
    power_basis, start_tangent, end_tangent, angle_step: float
) -> List[float]:
    """Parameters of an integral quadratic with uniform tangent angle
    steps (curve.rs:305-322).  Includes the end parameter 1.0 but not
    0.0.  All angle steps are solved in one batch (the scalar loop is
    the stroke builder's hot path)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    planes = [ga2d.dual_point(pb[1]), ga2d.dual_point(pb[2]) * 2.0]
    fan = _normal_fan(start_tangent, end_tangent, angle_step)
    if fan is None:
        return [1.0]
    # solve_linear((n·p0, n·p1)): root -c0/c1 when |c1| > tolerance.
    c0 = fan @ planes[0][1:3]
    c1 = fan @ planes[1][1:3]
    valid = np.abs(c1) > ERROR_MARGIN
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -c0 / c1
    params = _first_root_in_unit_interval(
        t, valid, np.zeros_like(t), np.zeros_like(valid)
    )
    return list(params) + [1.0]


def rational_quadratic_uniform_tangent_angle(
    power_basis, start_tangent, end_tangent, angle_step: float
) -> List[float]:
    """Parameters of a rational quadratic with uniform tangent angle
    steps (curve.rs:354-380); all angle steps solved in one batch with
    `solve_quadratic`'s exact case/order semantics."""
    pb = np.asarray(power_basis, dtype=np.float64)
    planes = [
        ga2d.join(pb[1], pb[0]),
        ga2d.join(pb[2], pb[0]) * 2.0,
        ga2d.join(pb[2], pb[1]),
    ]
    fan = _normal_fan(start_tangent, end_tangent, angle_step)
    if fan is None:
        return [1.0]
    # n = rotate_90_degree_clockwise(normal): components (n_y, -n_x).
    n = np.stack([fan[:, 1], -fan[:, 0]], axis=-1)
    c0 = n @ planes[0][1:3]
    c1 = n @ planes[1][1:3]
    c2 = n @ planes[2][1:3]
    with np.errstate(divide="ignore", invalid="ignore"):
        linear = np.abs(c2) <= ERROR_MARGIN
        disc = c1 * c1 - 4.0 * c0 * c2
        double = ~linear & (np.abs(disc) <= ERROR_MARGIN)
        positive = ~linear & ~double & (disc > 0.0)
        negative = ~linear & ~double & ~positive
        sq = np.sqrt(np.where(positive, disc, 0.0))
        q = -0.5 * (c1 + np.copysign(sq, c1))
        # Candidate roots per solve_quadratic's return order:
        # linear → (-c0/c1, —); double/negative → (-c1/(2c2), —)
        # (complex pair's real part, matching the scalar selection);
        # positive & q==0 → ((-c1±sq)/(2c2)); positive → (q/c2, c0/q).
        r_lin = -c0 / c1
        r_mid = -c1 / (2.0 * c2)
        q_zero = positive & (q == 0.0)
        r1 = np.where(
            linear, r_lin,
            np.where(
                positive,
                np.where(q_zero, (-c1 + sq) / (2.0 * c2), q / c2),
                r_mid,
            ),
        )
        r2 = np.where(q_zero, (-c1 - sq) / (2.0 * c2), c0 / q)
    v1 = np.where(linear, np.abs(c1) > ERROR_MARGIN, True)
    v2 = positive
    params = _first_root_in_unit_interval(r1, v1, r2, v2)
    return list(params) + [1.0]


def _cubic_uniform_tangent_angle(
    power_basis, angle_step, discriminant, roots, planes_of_trimmed, solve_with_planes
):
    """Shared cubic sampling: split at inflection/double-point roots, then
    walk each interval with uniform tangent angles (curve.rs:254-303)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    split_parameters = sorted(
        r.numerator.real / r.denominator
        for r in roots
        if r.denominator != 0.0
        and 0.0 <= r.numerator.real / r.denominator <= 1.0
    )
    deduped: List[float] = []
    for s in split_parameters:
        if not deduped or s - deduped[-1] >= ERROR_MARGIN:
            deduped.append(s)
    intervals = []
    previous_split = 0.0
    for s in deduped:
        if abs(discriminant) < ERROR_MARGIN:
            intervals.append((previous_split, s - F32_EPSILON))
            previous_split = s + F32_EPSILON
        else:
            intervals.append((previous_split, s))
            previous_split = s
    intervals.append((previous_split, 1.0))
    parameters: List[float] = []
    for a, b in intervals:
        trimmed = reparametrize_rational_cubic(pb, a, b)
        start_tangent = ga2d.signum(rational_cubic_first_order_derivative(pb, a))
        end_tangent = ga2d.signum(rational_cubic_first_order_derivative(pb, b))
        planes = planes_of_trimmed(trimmed)

        def solve(normal, planes=planes):
            return solve_with_planes(normal, planes)

        interval_parameters = sorted(
            a + (b - a) * t
            for t in _interpolate_normal(start_tangent, end_tangent, angle_step, solve)
        )
        parameters.extend(interval_parameters)
        parameters.append(b)
    return parameters


def integral_cubic_uniform_tangent_angle(power_basis, angle_step: float) -> List[float]:
    """Parameters of an integral cubic with uniform tangent angle steps,
    splitting at inflection points (curve.rs:324-352)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    ippc = inflection_point_polynomial_coefficients(pb, True)
    discriminant, roots = integral_inflection_points(ippc, False)

    def planes_of_trimmed(trimmed):
        return [
            ga2d.dual_point(trimmed[1]),
            ga2d.dual_point(trimmed[2]) * 2.0,
            ga2d.dual_point(trimmed[3]) * 3.0,
        ]

    def solve_with_planes(normal, planes):
        return solve_quadratic(
            (
                ga2d.inner_ll(normal, planes[0]),
                ga2d.inner_ll(normal, planes[1]),
                ga2d.inner_ll(normal, planes[2]),
            ),
            ERROR_MARGIN,
        )[1]

    return _cubic_uniform_tangent_angle(
        pb, angle_step, discriminant, roots, planes_of_trimmed, solve_with_planes
    )


def rational_cubic_uniform_tangent_angle(power_basis, angle_step: float) -> List[float]:
    """Parameters of a rational cubic with uniform tangent angle steps,
    splitting at inflection points (curve.rs:382-418)."""
    pb = np.asarray(power_basis, dtype=np.float64)
    ippc = inflection_point_polynomial_coefficients(pb, False)
    discriminant, roots = rational_inflection_points(ippc, False)

    def planes_of_trimmed(trimmed):
        return [
            ga2d.join(trimmed[1], trimmed[0]),
            ga2d.join(trimmed[2], trimmed[0]) * 2.0,
            ga2d.join(trimmed[2], trimmed[1]) + ga2d.join(trimmed[3], trimmed[0]) * 3.0,
            ga2d.join(trimmed[3], trimmed[1]) * 2.0,
            ga2d.join(trimmed[3], trimmed[2]),
        ]

    def solve_with_planes(normal, planes):
        n = ga2d.rotate_90_degree_clockwise(normal)
        return solve_quartic(
            tuple(ga2d.inner_ll(n, p) for p in planes), ERROR_MARGIN
        )[1]

    return _cubic_uniform_tangent_angle(
        pb, angle_step, discriminant, roots, planes_of_trimmed, solve_with_planes
    )


def uniform_arc_length_parameters(
    power_basis, point_fn, step: float, oversample: int = 128
) -> List[float]:
    """Parameters splitting a curve into spans of ~equal arc length
    `step` (model units).

    The reference declares this approximation but leaves it
    unimplemented (path.rs:162-166, commented out); delivered here.  A
    dense uniform parameter sampling builds the cumulative chord-length
    table, which is inverted by linear interpolation.  Includes the end
    parameter 1.0 but not 0.0 (matching the tangent-angle generators).
    """
    if step <= 0.0:
        raise ValueError("arc-length step must be positive")
    ts = np.linspace(0.0, 1.0, int(oversample) + 1)
    pts = ga2d.point_to_vec(point_fn(power_basis, ts))
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(cum[-1])
    if total <= step:
        return [1.0]
    n = max(1, int(round(total / step)))
    targets = np.arange(1, n + 1) * (total / n)
    params = np.interp(targets, cum, ts)
    params[-1] = 1.0
    return [float(t) for t in params]
