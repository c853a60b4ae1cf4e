"""Fill tessellation: paths → triangle tables with implicit-curve weights.

Re-implements the reference's fill builder (src/fill.rs) on top of the
Loop-Blinn implicit-curve construction:

- line segments extend a triangle fan of path anchor points
  (fill.rs:280-284),
- quadratic curves emit one triangle with fixed implicit-space
  coordinates (fill.rs:285-295; rational variant scaled by 1/w,
  fill.rs:321-333),
- cubic curves are classified by the inflection-point discriminant
  (serpentine/cusp/loop), lifted to 4 implicit weight channels
  (k, l, m, n) built from products of the root linear forms
  (fill.rs:34-68), oriented to the filled side (fill.rs:98-114), split
  at loop self-intersections (fill.rs:14-32, 206-216), and the control
  quadrilateral is triangulated into 1-2 triangles by signed-area
  analysis (fill.rs:134-204).

The fragment-side predicates these weights feed are
``x² - y ≤ 0`` (integral quadratic), ``x³ - y·z ≤ 0`` (integral cubic),
``x² - y·z ≤ 0`` (rational quadratic) and ``x³ - y·z·w ≤ 0`` (rational
cubic) — reference src/shaders.wgsl:237-266.

Winding semantics in this renderer: a fill triangle contributes
``sign(signed area)`` to the winding counter (the array-code equivalent
of the reference's front-Increment / back-Decrement stencil state,
renderer.rs:577-582), so triangles are emitted in their natural,
path-orientation-covariant order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .curve import (
    inflection_point_polynomial_coefficients,
    integral_inflection_points,
    rational_cubic_control_points_to_power_basis,
    rational_cubic_first_order_derivative,
    rational_cubic_point,
    rational_inflection_points,
    reparametrize_rational_cubic,
)
from .error import ERROR_MARGIN
from .path import Path, SegmentType
from . import ga2d, ga3d
from .polynomial import Root
from .vertex import (
    KIND_INTEGRAL_CUBIC,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    TriangleBuilder,
    TriangleTable,
    fan_triangles,
)


def _convex_hull_order(points) -> list:
    """Indices of the convex hull of up to 4 points, counterclockwise
    (gift wrapping; tiny n)."""
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    order = sorted(range(n), key=lambda i: (pts[i, 0], pts[i, 1]))
    hull: list = []
    for phase in range(2):
        seq = order if phase == 0 else order[::-1]
        base = len(hull)
        for i in seq:
            while len(hull) - base > 1:
                u = pts[hull[-1]] - pts[hull[-2]]
                v = pts[i] - pts[hull[-1]]
                if u[0] * v[1] - u[1] * v[0] > 0.0:
                    break
                hull.pop()
            hull.append(i)
        hull.pop()
    return hull


def find_double_point_issue(discriminant: float, roots) -> Optional[float]:
    """For a loop cubic, the self-intersection parameter if exactly one of
    the double-point parameters lies strictly inside (0, 1)
    (fill.rs:14-32)."""
    if discriminant < 0.0:
        result = -1.0
        inside = 0
        for root in roots:
            if root.denominator != 0.0:
                parameter = root.numerator.real / root.denominator
                if 0.0 < parameter < 1.0:
                    result = parameter
                    inside += 1
        if inside == 1:
            return result
    return None


def _bernstein_weights_of_root_product(roots) -> np.ndarray:
    """Cubic Bernstein coefficients of ∏ᵢ (numᵢ - denᵢ·t) for three
    homogeneous roots (fill.rs:34-48)."""
    n = [r.numerator.real for r in roots]
    d = [r.denominator for r in roots]
    power = np.array(
        [
            n[0] * n[1] * n[2],
            -(d[0] * n[1] * n[2] + n[0] * d[1] * n[2] + n[0] * n[1] * d[2]),
            n[0] * d[1] * d[2] + d[0] * n[1] * d[2] + d[0] * d[1] * n[2],
            -d[0] * d[1] * d[2],
        ]
    )
    return np.array(
        [
            power[0],
            power[0] + power[1] / 3.0,
            power[0] + power[1] * 2.0 / 3.0 + power[2] / 3.0,
            power[0] + power[1] + power[2] + power[3],
        ]
    )


def weights(discriminant: float, roots) -> np.ndarray:
    """The 4x4 implicit weight matrix: rows = control points 0..3,
    columns = (k, l, m, n) channels (fill.rs:51-68).

    Satisfies k³ == l·m·n along the curve for each classification:
    serpentine k=L0·L1·L2, l=L0³, m=L1³, n=L2³; loop k=Ld·Le·Li,
    l=Ld²·Le, m=Le²·Ld, n=Li³; cusp (discriminant exactly 0)
    k=L0²·L2, l=m=L0³, n=L2³.
    """
    out = np.zeros((4, 4))
    if discriminant == 0.0:
        out[:, 0] = _bernstein_weights_of_root_product([roots[0], roots[0], roots[2]])
        out[:, 1] = _bernstein_weights_of_root_product([roots[0], roots[0], roots[0]])
        out[:, 2] = _bernstein_weights_of_root_product([roots[0], roots[0], roots[0]])
    elif discriminant < 0.0:
        out[:, 0] = _bernstein_weights_of_root_product([roots[0], roots[1], roots[2]])
        out[:, 1] = _bernstein_weights_of_root_product([roots[0], roots[0], roots[1]])
        out[:, 2] = _bernstein_weights_of_root_product([roots[1], roots[1], roots[0]])
    else:
        out[:, 0] = _bernstein_weights_of_root_product([roots[0], roots[1], roots[2]])
        out[:, 1] = _bernstein_weights_of_root_product([roots[0], roots[0], roots[0]])
        out[:, 2] = _bernstein_weights_of_root_product([roots[1], roots[1], roots[1]])
    out[:, 3] = _bernstein_weights_of_root_product([roots[2], roots[2], roots[2]])
    return out


def weight_planes(control_points, weight_matrix) -> np.ndarray:
    """Screen-space interpolation planes of the 4 weight channels: the 3D
    plane through the lifted control points (x, y, weight), normalized so
    its weight coefficient is -1 (fill.rs:70-85).

    Returns (4, 3) lines (c, a, b): channel value at (x, y) is
    c + a·x + b·y.
    """
    cps = np.asarray(control_points, dtype=np.float64)
    planes = np.zeros((4, 3))
    for i in range(4):
        lifted = np.concatenate([cps, weight_matrix[:, i : i + 1]], axis=1)  # (4,4)
        plane = ga3d.join3(lifted[0], lifted[1], lifted[2])
        if float(np.dot(plane, plane)) < ERROR_MARGIN:
            plane = ga3d.join3(lifted[0], lifted[1], lifted[3])
        with np.errstate(divide="ignore", invalid="ignore"):
            plane = plane * (1.0 / -plane[3])
        planes[i] = plane[:3]
    return planes


def implicit_curve_value(w) -> float:
    """f = k³ - l·m·n (fill.rs:87-89; shader predicate shaders.wgsl:260-266)."""
    return w[0] ** 3 - w[1] * w[2] * w[3]


def implicit_curve_gradient(planes, w) -> np.ndarray:
    """Gradient line of f at a point with channel values w (fill.rs:91-96)."""
    return (
        planes[0] * (3.0 * w[0] * w[0])
        - planes[1] * (w[2] * w[3])
        - planes[2] * (w[1] * w[3])
        - planes[3] * (w[1] * w[2])
    )


def normalize_implicit_curve_side(
    planes, weight_matrix, power_basis, path_orientation: float, anchor_t: float = 0.0
) -> bool:
    """Orient the implicit function so the kept side (f ≤ 0) is the path's
    INTERIOR side of the curve.

    The reference flips when the gradient at t=0 agrees with the walk
    tangent's left normal (fill.rs:98-114), anchoring the kept side to
    the left of the walk — correct when the surrounding path is
    counterclockwise (interior on the left).  This renderer derives the
    winding increment from each triangle's natural signed area (which
    flips under path reversal), so the kept side must stay the
    geometrically fixed interior side: the reference condition is
    conditioned on the overall path orientation `path_orientation`
    (+1 counterclockwise, -1 clockwise).

    Returns True if a flip happened (planes/weights mutated in place).
    """
    # The anchor can be degenerate (point at infinity when the rational
    # weight vanishes at anchor_t, or a zero gradient at a cusp), which
    # would make `alignment` NaN and silently skip the flip; probe a few
    # parameters until one yields a finite, nonzero alignment.  A second
    # degeneracy source: a numerically near-linear cubic at the
    # Loop-Blinn classification boundary gives ±inf/NaN weight PLANES
    # (config-2 corpus path #167, pinned by
    # test_fill.TestDegenerateCubic) — then every probe is NaN, the
    # errstate block below masks the arithmetic, and the no-flip
    # fallback stands (the curve has ~1e-6 curvature; either side is
    # sub-sample).  Fallback
    # probes stay in a shrinking neighborhood of anchor_t (clamped to
    # [0, 1]) rather than at fixed global parameters: an unsplit cubic
    # whose domain crosses a cusp/double point changes tangent-gradient
    # sign across it, so a far-away probe could land on the wrong
    # segment of the curve.
    alignment = 0.0
    probes = (anchor_t,) + tuple(
        min(1.0, max(0.0, anchor_t + sign * eps))
        for eps in (0.25, 0.125, 0.0625)
        for sign in (1.0, -1.0)
    )
    for t in probes:
        tangent = rational_cubic_first_order_derivative(power_basis, t)
        point = rational_cubic_point(power_basis, t)
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = point[1:] / point[0]
            channels = (
                planes[:, 0] + planes[:, 1] * xy[0] + planes[:, 2] * xy[1]
            )
            gradient = implicit_curve_gradient(planes, channels)
            candidate = float(ga2d.inner_ll(tangent, gradient))
        if np.isfinite(candidate) and candidate != 0.0:
            alignment = candidate
            break
    if alignment * (path_orientation if path_orientation != 0.0 else 1.0) > 0.0:
        planes *= -1.0
        weight_matrix[:, 0] *= -1.0
        weight_matrix[:, 1] *= -1.0
        return True
    return False


def path_orientation_sign(path: Path) -> float:
    """+1 if the path is counterclockwise (in y-up model space), -1 if
    clockwise: the sign of the enclosed area weighted by winding number
    (shoelace over a flattened polyline).

    Well-defined for self-crossing paths too (e.g. a cubic whose loop is
    smaller than the region between its tails), where a control-polygon
    estimate would be unreliable.
    """
    points = [np.asarray(path.start, dtype=np.float64)]
    ts = np.linspace(0.0, 1.0, 17)[1:]
    for segment_type, segment in path.iter_segments():
        if segment_type is SegmentType.LINE:
            points.append(segment.control_points[0])
            continue
        if segment_type in (
            SegmentType.INTEGRAL_QUADRATIC_CURVE,
            SegmentType.RATIONAL_QUADRATIC_CURVE,
        ):
            w = getattr(segment, "weight", 1.0)
            cps = np.stack(
                [
                    ga2d.vec_to_point(points[-1]),
                    ga2d.weighted_vec_to_point(w, segment.control_points[0]),
                    ga2d.vec_to_point(segment.control_points[1]),
                ]
            )
            from .curve import (
                rational_quadratic_control_points_to_power_basis,
                rational_quadratic_point,
            )

            pb = rational_quadratic_control_points_to_power_basis(cps)
            points.extend(ga2d.point_to_vec(rational_quadratic_point(pb, ts)))
        else:
            w = getattr(segment, "weights", np.ones(4))
            cps = np.stack(
                [ga2d.weighted_vec_to_point(w[0], points[-1])]
                + [
                    ga2d.weighted_vec_to_point(w[i + 1], segment.control_points[i])
                    for i in range(3)
                ]
            )
            pb = rational_cubic_control_points_to_power_basis(cps)
            points.extend(ga2d.point_to_vec(rational_cubic_point(pb, ts)))
    poly = np.asarray(points)
    x, y = poly[:, 0], poly[:, 1]
    area2 = float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
    if area2 > 0.0:
        return 1.0
    if area2 < 0.0:
        return -1.0
    return 0.0


def split_curve_at(control_points, param):
    """De Casteljau split of 4 homogeneous points at `param`
    (fill.rs:206-216).  Works for any trailing dimension."""
    cp = np.asarray(control_points, dtype=np.float64)
    u = 1.0 - param
    p10 = cp[0] * u + cp[1] * param
    p11 = cp[1] * u + cp[2] * param
    p12 = cp[2] * u + cp[3] * param
    p20 = p10 * u + p11 * param
    p21 = p11 * u + p12 * param
    p30 = p20 * u + p21 * param
    return (
        np.stack([cp[0], p10, p20, p30]),
        np.stack([p30, p21, p12, cp[3]]),
    )


class FillBuilder:
    """Accumulates fill geometry for a set of paths into triangle tables
    (replaces reference FillBuilder, fill.rs:252-368)."""

    def __init__(self):
        self._triangles = TriangleBuilder()
        self._solid_fans: List[np.ndarray] = []

    def build(self) -> TriangleTable:
        builder = TriangleBuilder()
        for fan in self._solid_fans:
            for tri in fan_triangles(fan):
                builder.push(tri, KIND_SOLID)
        curve_table = self._triangles.build()
        solid_table = builder.build()
        return TriangleTable.concatenate([solid_table, curve_table])

    # ------------------------------------------------------------------

    def add_path(self, proto_hull: List, path: Path):
        """Tessellate one filled path (fill.rs:263-367)."""
        orientation = path_orientation_sign(path)
        fan: List[np.ndarray] = [np.asarray(path.start, dtype=np.float64)]
        proto_hull.append(np.asarray(path.start, dtype=np.float64))
        for segment_type, segment in path.iter_segments():
            if segment_type is SegmentType.LINE:
                p = segment.control_points[0]
                proto_hull.append(p)
                fan.append(p)
            elif segment_type is SegmentType.INTEGRAL_QUADRATIC_CURVE:
                # One Loop-Blinn triangle with fixed implicit-space coords
                # (fill.rs:285-295).  Vertex order is path-natural
                # (start, ctrl, end) so the triangle's signed area carries
                # the path orientation (this renderer's winding convention
                # is +1 for model-space CCW; the reference's reversed order
                # encodes the same fact for wgpu's y-down framebuffer
                # winding).
                c0, c1 = segment.control_points
                last = fan[-1]
                # The third channel is a constant 1 so the predicate is the
                # homogeneous x² - y·z form, allowing per-triangle weight
                # rescaling for float32 conditioning.
                self._triangles.push(
                    np.stack([last, c0, c1]),
                    KIND_INTEGRAL_QUADRATIC,
                    aux=np.array([[0.0, 0.0, 1.0], [0.5, 0.0, 1.0], [1.0, 1.0, 1.0]]),
                )
                proto_hull.extend([c0, c1])
                fan.append(c1)
            elif segment_type is SegmentType.RATIONAL_QUADRATIC_CURVE:
                c0, c1 = segment.control_points
                u = 1.0 / segment.weight
                last = fan[-1]
                self._triangles.push(
                    np.stack([last, c0, c1]),
                    KIND_RATIONAL_QUADRATIC,
                    aux=np.array(
                        [[0.0, 0.0, 1.0], [0.5 * u, 0.0, u], [1.0, 1.0, 1.0]]
                    ),
                )
                proto_hull.extend([c0, c1])
                fan.append(c1)
            elif segment_type is SegmentType.INTEGRAL_CUBIC_CURVE:
                cps = np.stack(
                    [ga2d.vec_to_point(fan[-1])]
                    + [ga2d.vec_to_point(p) for p in segment.control_points]
                )
                power_basis = rational_cubic_control_points_to_power_basis(cps)
                ippc = inflection_point_polynomial_coefficients(power_basis, True)
                discriminant, roots = integral_inflection_points(ippc, True)
                self._emit_cubic_curve(
                    proto_hull,
                    fan,
                    cps,
                    power_basis,
                    discriminant,
                    roots,
                    KIND_INTEGRAL_CUBIC,
                    orientation,
                )
            else:  # rational cubic
                w = segment.weights
                cps = np.stack(
                    [ga2d.weighted_vec_to_point(w[0], fan[-1])]
                    + [
                        ga2d.weighted_vec_to_point(w[i + 1], segment.control_points[i])
                        for i in range(3)
                    ]
                )
                power_basis = rational_cubic_control_points_to_power_basis(cps)
                ippc = inflection_point_polynomial_coefficients(power_basis, False)
                discriminant, roots = rational_inflection_points(ippc, True)
                self._emit_cubic_curve(
                    proto_hull,
                    fan,
                    cps,
                    power_basis,
                    discriminant,
                    roots,
                    KIND_RATIONAL_CUBIC,
                    orientation,
                )
        self._solid_fans.append(np.stack(fan))

    # ------------------------------------------------------------------

    def _emit_cubic_curve(
        self,
        proto_hull,
        fan,
        control_points,
        power_basis,
        discriminant,
        roots,
        kind,
        orientation,
    ):
        """Classify, orient, possibly split, and triangulate one cubic
        segment (fill.rs:218-250)."""
        weight_matrix = weights(discriminant, roots)
        split_parameters = []
        if discriminant < 0.0:
            # Split a loop at every double-point parameter inside the
            # segment.  The reference splits only when exactly one is
            # inside (fill.rs:14-32, 232-241); splitting at both (three
            # pieces, the middle one being the closed lobe) additionally
            # removes the spurious implicit sheet near the lobe apex.
            split_parameters = sorted(
                r.numerator.real / r.denominator
                for r in roots
                if r.denominator != 0.0
                and 0.0 < r.numerator.real / r.denominator < 1.0
            )
        if split_parameters:
            bounds = [0.0] + split_parameters + [1.0]
            cps_rest, w_rest = control_points, weight_matrix
            consumed = 0.0
            pieces = []
            for a, b in zip(bounds[:-1], bounds[1:]):
                if b >= 1.0:
                    pieces.append((a, 1.0, cps_rest, w_rest))
                    break
                local = (b - consumed) / (1.0 - consumed) if consumed < 1.0 else 0.0
                cps_piece, cps_rest = split_curve_at(cps_rest, local)
                w_piece, w_rest = split_curve_at(w_rest, local)
                pieces.append((a, b, cps_piece, w_piece))
                consumed = b
            for index, (a, b, cps_piece, w_piece) in enumerate(pieces):
                pb_piece = reparametrize_rational_cubic(power_basis, a, b)
                piece_orientation = orientation
                start_xy = ga2d.point_to_vec(cps_piece[0])
                end_xy = ga2d.point_to_vec(cps_piece[3])
                if float(np.sum((start_xy - end_xy) ** 2)) <= ERROR_MARGIN:
                    # Closed lobe: its winding is its own traversal
                    # orientation, independent of the rest of the path.
                    ts = np.linspace(0.0, 1.0, 33)
                    poly = ga2d.point_to_vec(
                        rational_cubic_point(
                            np.asarray(pb_piece, dtype=np.float64), ts
                        )
                    )
                    x, y = poly[:, 0], poly[:, 1]
                    area2 = float(
                        np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
                    )
                    if area2 != 0.0:
                        piece_orientation = float(np.sign(area2))
                w_piece = np.array(w_piece, dtype=np.float64)
                planes_piece = weight_planes(cps_piece, w_piece)
                normalize_implicit_curve_side(
                    planes_piece, w_piece, pb_piece, piece_orientation, 0.5
                )
                self._triangulate_quadrilateral(
                    fan, cps_piece, w_piece, kind, piece_orientation
                )
                if index < len(pieces) - 1:
                    fan.append(end_xy)
        else:
            planes = weight_planes(control_points, weight_matrix)
            normalize_implicit_curve_side(
                planes, weight_matrix, power_basis, orientation
            )
            self._triangulate_quadrilateral(
                fan, control_points, weight_matrix, kind, orientation
            )
        for i in (1, 2, 3):
            proto_hull.append(ga2d.point_to_vec(control_points[i]))
        fan.append(ga2d.point_to_vec(control_points[3]))

    def _triangulate_quadrilateral(
        self, fan, control_points, weight_matrix, kind, orientation
    ):
        """Triangulate the control quadrilateral into 1-2 curve triangles
        and push interior control points into the solid fan
        (fill.rs:134-204)."""
        cps = np.asarray(control_points, dtype=np.float64)
        # Per-vertex attributes must be the channel values at the projected
        # vertex: divide by the homogeneous weight (fill.rs:137-139).
        with np.errstate(divide="ignore", invalid="ignore"):
            w = weight_matrix / cps[:, :1]
        signed_areas = np.array(
            [
                ga2d.triple(*[cps[j] for j in range(4) if j != i])
                for i in range(4)
            ]
        )
        # Triangulate the convex hull of the four (projected) control
        # points as a fan.  This uniformly handles every configuration the
        # reference case-splits on (fill.rs:134-204): convex quads (hull =
        # quad, fan = a diagonal split), one point inside ("enclosing
        # triangle" — hull is the other three), chord-crossing bowties and
        # edge-crossing hourglasses (hull reorders the vertices).  The
        # f ≤ 0 trim then restricts coverage to the region between the
        # curve and the fan polyline, which always winds with the path.
        xy = np.stack([ga2d.point_to_vec(c) for c in cps])
        if np.all(np.isfinite(xy)):
            hull_order = _convex_hull_order(xy)
            for a in range(1, len(hull_order) - 1):
                idx = [hull_order[0], hull_order[a], hull_order[a + 1]]
                self._emit_curve_triangle(xy, w, idx, kind, orientation)
        # Push interior control points on the filled side into the fan
        # (fill.rs:191-201).
        added = []
        for i in (1, 2):
            if implicit_curve_value(w[i]) < 0.0:
                added.append(ga2d.point_to_vec(cps[i]))
        if len(added) == 2 and signed_areas[0] * signed_areas[1] < 0.0:
            added.reverse()
        fan.extend(added)

    def _emit_curve_triangle(self, xy, w, idx, kind, orientation):
        """Emit one curve triangle over vertex indices `idx`, skipping
        degenerate slivers (fill.rs:116-131).

        The vertex order is chosen so the triangle's winding contribution
        (the sign of its signed area under the rasterizer's convention)
        equals the path orientation: the region between the curve and the
        fan polyline on the kept (interior-anchored, f ≤ 0) side always
        winds with the path, regardless of which way the control
        quadrilateral happens to turn.  (The reference encodes the
        equivalent fact by reversing negative-area triangles for the
        GPU's fixed front-face rule, fill.rs:124-129.)
        """
        u = xy[idx[1]] - xy[idx[0]]
        v = xy[idx[2]] - xy[idx[0]]
        area = float(u[0] * v[1] - u[1] * v[0])
        if abs(area) <= ERROR_MARGIN or not np.isfinite(area):
            return
        if orientation != 0.0 and area * orientation < 0.0:
            idx = idx[::-1]
        tri_xy = np.stack([xy[j] for j in idx])
        aux = np.stack([w[j] for j in idx])
        if not np.all(np.isfinite(aux)):
            return
        if kind == KIND_INTEGRAL_CUBIC:
            # Constant fourth channel: the integral predicate becomes the
            # homogeneous x³ - y·z·w form (n ≡ 1, curve.rs:133-144 forces
            # ippc[0]=0 so the n root product is the constant 1).
            aux = aux.copy()
            aux[:, 3] = 1.0
        # Rescale to unit magnitude: the predicates are homogeneous in the
        # channels, so a positive per-triangle scale preserves the sign of
        # f while keeping float32 evaluation well conditioned.
        scale = np.max(np.abs(aux))
        if scale > 0.0 and np.isfinite(scale):
            aux = aux / scale
        self._triangles.push(tri_xy, kind, aux=aux)
