"""The path model: segments, stroke options and path constructors.

Mirrors the reference's scene layer (src/path.rs) so that scenes written
against the reference port unchanged: the same five segment types with
SoA storage and an interleaving type tape (path.rs:213-230), the same
stroke option structures (path.rs:71-201), and the same constructors
including the SVG endpoint-parameterized elliptical arc
(path.rs:639-708).

All control points are plain (x, y) float tuples / numpy rows; weights
are scalars.  Validation of finiteness happens in `push_*`/constructors,
standing in for the reference's SafeFloat (src/safe_float.rs:44-52).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .error import ERROR_MARGIN
from .utils import ga2d

TAU = 2.0 * math.pi


def _pt(p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64).reshape(2)
    if not np.all(np.isfinite(p)):
        raise ValueError(f"control point must be finite, got {p}")
    # Normalize -0.0 to +0.0 (reference safe_float.rs:47-49).
    return p + 0.0


class SegmentType(enum.IntEnum):
    """Different types of path segments (reference path.rs:56-67)."""

    LINE = 0
    INTEGRAL_QUADRATIC_CURVE = 1
    INTEGRAL_CUBIC_CURVE = 2
    RATIONAL_QUADRATIC_CURVE = 3
    RATIONAL_CUBIC_CURVE = 4


@dataclass
class LineSegment:
    """A line; start implicit from the previous segment (path.rs:14-18)."""

    control_points: np.ndarray  # (1, 2)

    def __init__(self, control_points):
        self.control_points = np.stack([_pt(p) for p in control_points])
        assert self.control_points.shape == (1, 2)


@dataclass
class IntegralQuadraticCurveSegment:
    """An integral quadratic bezier curve (path.rs:21-25)."""

    control_points: np.ndarray  # (2, 2)

    def __init__(self, control_points):
        self.control_points = np.stack([_pt(p) for p in control_points])
        assert self.control_points.shape == (2, 2)


@dataclass
class IntegralCubicCurveSegment:
    """An integral cubic bezier curve (path.rs:28-32)."""

    control_points: np.ndarray  # (3, 2)

    def __init__(self, control_points):
        self.control_points = np.stack([_pt(p) for p in control_points])
        assert self.control_points.shape == (3, 2)


@dataclass
class RationalQuadraticCurveSegment:
    """A rational quadratic bezier curve; the middle control point carries
    `weight`, start/end weights are fixed to 1 (path.rs:34-43)."""

    weight: float
    control_points: np.ndarray  # (2, 2)

    def __init__(self, weight, control_points):
        self.weight = float(weight)
        self.control_points = np.stack([_pt(p) for p in control_points])
        assert self.control_points.shape == (2, 2)


@dataclass
class RationalCubicCurveSegment:
    """A rational cubic bezier curve; `weights` includes the start weight,
    thus shifted by one vs the control points (path.rs:45-52)."""

    weights: np.ndarray  # (4,)
    control_points: np.ndarray  # (3, 2)

    def __init__(self, weights, control_points):
        self.weights = np.asarray(weights, dtype=np.float64).reshape(4)
        self.control_points = np.stack([_pt(p) for p in control_points])
        assert self.control_points.shape == (3, 2)


class Join(enum.IntEnum):
    """Geometry where path segments meet (reference path.rs:70-82).

    The integer values are the GPU encoding consumed by the stroke
    predicate (reference renderer.rs:39, shaders.wgsl:191-203).
    """

    MITER = 0
    BEVEL = 1
    ROUND = 2


class Cap(enum.IntEnum):
    """Geometry at the start/end of a dash (reference path.rs:85-101).

    Values are the 4-bit GPU encoding (reference renderer.rs:46-47,
    shaders.wgsl:165-189).
    """

    SQUARE = 0
    ROUND = 1
    OUT = 2
    IN = 3
    RIGHT = 4
    LEFT = 5
    BUTT = 6


@dataclass
class DashInterval:
    """One gap interval of a dash pattern, measured in stroke widths
    (reference path.rs:104-118)."""

    gap_start: float
    gap_end: float
    dash_start: Cap = Cap.BUTT
    dash_end: Cap = Cap.BUTT


#: Maximum number of DashIntervals in DynamicStrokeOptions (path.rs:121).
MAX_DASH_INTERVALS = 4


@dataclass
class DynamicStrokeOptions:
    """Dynamic (per-frame updatable) part of StrokeOptions, shared by a
    group of paths in one Shape (reference path.rs:123-149).

    Use the :meth:`dashed` / :meth:`solid` constructors.
    """

    join: Join
    dashed: bool
    pattern: List[DashInterval] = field(default_factory=list)
    phase: float = 0.0
    start: Cap = Cap.BUTT
    end: Cap = Cap.BUTT

    @classmethod
    def make_dashed(cls, join: Join, pattern: Sequence[DashInterval], phase: float):
        return cls(join=join, dashed=True, pattern=list(pattern), phase=float(phase))

    @classmethod
    def make_solid(cls, join: Join, start: Cap, end: Cap):
        return cls(join=join, dashed=False, start=start, end=end)


@dataclass(frozen=True)
class CurveApproximation:
    """Parametric sampling strategy for stroking curves
    (reference path.rs:151-167)."""

    kind: str  # "uniform_parameters" | "uniform_tangent_angle" | "uniform_arc_length"
    value: float

    @classmethod
    def uniformly_spaced_parameters(cls, n: int):
        """Step size 1/n → n+1 parameters including start and end."""
        return cls("uniform_parameters", int(n))

    @classmethod
    def uniform_arc_length(cls, step: float):
        """Sample spacing in model-space arc length (the approximation
        the reference plans but does not implement, path.rs:162-166)."""
        return cls("uniform_arc_length", float(step))

    @classmethod
    def uniform_tangent_angle(cls, angle: float):
        """Tangent step angle in radians."""
        return cls("uniform_tangent_angle", float(angle))


@dataclass
class StrokeOptions:
    """How a path is stroked (reference path.rs:169-201)."""

    width: float
    offset: float = 0.0
    miter_clip: float = 1.0
    closed: bool = False
    dynamic_stroke_options_group: int = 0
    curve_approximation: CurveApproximation = field(
        default_factory=lambda: CurveApproximation.uniformly_spaced_parameters(16)
    )

    def legalize(self):
        """Clamp parameters into their allowed ranges (path.rs:194-201)."""
        self.width = abs(float(self.width))
        self.offset = min(0.5, max(-0.5, float(self.offset)))
        self.miter_clip = abs(float(self.miter_clip))
        return self


def _tangent_from_points(a, b):
    return ga2d.join(ga2d.vec_to_point(a), ga2d.vec_to_point(b))


_SEGMENT_LISTS = {
    SegmentType.LINE: "line_segments",
    SegmentType.INTEGRAL_QUADRATIC_CURVE: "integral_quadratic_curve_segments",
    SegmentType.INTEGRAL_CUBIC_CURVE: "integral_cubic_curve_segments",
    SegmentType.RATIONAL_QUADRATIC_CURVE: "rational_quadratic_curve_segments",
    SegmentType.RATIONAL_CUBIC_CURVE: "rational_cubic_curve_segments",
}


class Path:
    """A sequence of segments that can be either stroked or filled
    (reference path.rs:207-230).

    Every "move to" command requires a new Path.  The order of the
    segments defines the direction of the Path; filled paths increment
    the winding counter when counterclockwise and decrement when
    clockwise.
    """

    def __init__(self, start=(0.0, 0.0), stroke_options: Optional[StrokeOptions] = None):
        self.stroke_options = stroke_options
        self.start = _pt(start)
        self.line_segments: List[LineSegment] = []
        self.integral_quadratic_curve_segments: List[IntegralQuadraticCurveSegment] = []
        self.integral_cubic_curve_segments: List[IntegralCubicCurveSegment] = []
        self.rational_quadratic_curve_segments: List[RationalQuadraticCurveSegment] = []
        self.rational_cubic_curve_segments: List[RationalCubicCurveSegment] = []
        self.segment_types: List[SegmentType] = []

    def copy(self) -> "Path":
        """Cheap deep copy (segments' arrays duplicated) — lets callers
        cache prototype paths (e.g. glyph outlines) and transform the
        copies per instance."""
        return self._clone(lambda pts: pts.copy())

    def copy_affine(self, scale: float, offset) -> "Path":
        """Fused copy + uniform-scale + translate — the exact transform
        text layout applies per glyph (reference text.rs:255-259), an
        order of magnitude cheaper than `copy()` + `transform()` with a
        motor.  Like `transform`, stroke options are carried unchanged
        (stroke width is in post-transform units, path.rs:171-176)."""
        offset = np.asarray(offset, dtype=np.float64)
        return self._clone(lambda pts: pts * scale + offset)

    def _clone(self, point_map) -> "Path":
        out = Path.__new__(Path)
        out.stroke_options = self.stroke_options
        out.start = point_map(np.asarray(self.start, dtype=np.float64))
        out.segment_types = list(self.segment_types)
        for name in _SEGMENT_LISTS.values():
            clones = []
            for seg in getattr(self, name):
                clone = object.__new__(type(seg))
                clone.__dict__.update(seg.__dict__)
                clone.control_points = point_map(seg.control_points)
                clones.append(clone)
            setattr(out, name, clones)
        return out

    # -- push commands (reference path.rs:232-261) -------------------------

    def push_line(self, segment: LineSegment):
        self.line_segments.append(segment)
        self.segment_types.append(SegmentType.LINE)

    def push_integral_quadratic_curve(self, segment: IntegralQuadraticCurveSegment):
        self.integral_quadratic_curve_segments.append(segment)
        self.segment_types.append(SegmentType.INTEGRAL_QUADRATIC_CURVE)

    def push_integral_cubic_curve(self, segment: IntegralCubicCurveSegment):
        self.integral_cubic_curve_segments.append(segment)
        self.segment_types.append(SegmentType.INTEGRAL_CUBIC_CURVE)

    def push_rational_quadratic_curve(self, segment: RationalQuadraticCurveSegment):
        self.rational_quadratic_curve_segments.append(segment)
        self.segment_types.append(SegmentType.RATIONAL_QUADRATIC_CURVE)

    def push_rational_cubic_curve(self, segment: RationalCubicCurveSegment):
        self.rational_cubic_curve_segments.append(segment)
        self.segment_types.append(SegmentType.RATIONAL_CUBIC_CURVE)

    # -- iteration helpers -------------------------------------------------

    def iter_segments(self):
        """Yield (SegmentType, segment) pairs in tape order."""
        counters = dict.fromkeys(_SEGMENT_LISTS.values(), 0)
        for segment_type in self.segment_types:
            name = _SEGMENT_LISTS[segment_type]
            yield segment_type, getattr(self, name)[counters[name]]
            counters[name] += 1

    def __len__(self):
        return len(self.segment_types)

    def __eq__(self, other):
        if not isinstance(other, Path):
            return NotImplemented
        if self.segment_types != other.segment_types:
            return False
        if not np.array_equal(self.start, other.start):
            return False
        for (_, a), (_, b) in zip(self.iter_segments(), other.iter_segments()):
            if not np.array_equal(a.control_points, b.control_points):
                return False
            if isinstance(a, RationalQuadraticCurveSegment) and a.weight != b.weight:
                return False
            if isinstance(a, RationalCubicCurveSegment) and not np.array_equal(
                a.weights, b.weights
            ):
                return False
        return self.stroke_options == other.stroke_options

    # -- queries (reference path.rs:263-373) -------------------------------

    def get_end(self) -> np.ndarray:
        """The current end of the path; `start` if empty (path.rs:266-290)."""
        if not self.segment_types:
            return self.start.copy()
        last_type = self.segment_types[-1]
        segment = getattr(self, _SEGMENT_LISTS[last_type])[-1]
        return segment.control_points[-1].copy()

    def _segment_first_control_point(self, segment):
        return segment.control_points[0]

    def get_start_tangent(self) -> np.ndarray:
        """Normalized tangent line at the start, in path direction; zero if
        empty (path.rs:292-320).  Useful for arrow heads / tails."""
        if not self.segment_types:
            return np.zeros(3)
        first_type = self.segment_types[0]
        segment = getattr(self, _SEGMENT_LISTS[first_type])[0]
        return ga2d.signum(_tangent_from_points(self.start, segment.control_points[0]))

    def get_end_tangent(self) -> np.ndarray:
        """Normalized tangent line at the end, in path direction; zero if
        empty (path.rs:322-373)."""
        if not self.segment_types:
            return np.zeros(3)
        last_type = self.segment_types[-1]
        segment = getattr(self, _SEGMENT_LISTS[last_type])[-1]
        if last_type is SegmentType.LINE:
            # Previous point is the end of the second-to-last segment.
            if len(self.segment_types) >= 2:
                prev_type = self.segment_types[-2]
                if prev_type is SegmentType.LINE:
                    previous_point = self.line_segments[-2].control_points[0]
                else:
                    previous_point = getattr(self, _SEGMENT_LISTS[prev_type])[-1].control_points[-1]
            else:
                previous_point = self.start
            return ga2d.signum(
                _tangent_from_points(previous_point, segment.control_points[0])
            )
        return ga2d.signum(
            _tangent_from_points(segment.control_points[-2], segment.control_points[-1])
        )

    # -- mutators (reference path.rs:375-628) ------------------------------

    def append(self, other: "Path"):
        """Concatenate `other`'s segments, leaving it empty (path.rs:376-384).

        Like the reference, this does not bridge the positional gap and
        also moves the segment type tape.
        """
        for name in _SEGMENT_LISTS.values():
            getattr(self, name).extend(getattr(other, name))
            getattr(other, name).clear()
        self.segment_types.extend(other.segment_types)
        other.segment_types.clear()

    def transform(self, scale: float, motor) -> "Path":
        """Transform all control points by `scale` then `motor`
        (path.rs:386-439).

        Matches the reference's composition: the motor's 3x3 matrix with
        its linear part scaled (rotation+scale applied to the point, then
        translation).
        """
        mat = ga2d.motor2d_to_mat3(np.asarray(motor, dtype=np.float64))
        mat = mat.copy()
        mat[0, 0] *= scale
        mat[1, 1] *= scale

        def tp(p):
            return np.array(
                [
                    mat[2, 0] + p[0] * mat[0, 0] + p[1] * mat[1, 0],
                    mat[2, 1] + p[0] * mat[0, 1] + p[1] * mat[1, 1],
                ]
            )

        self.start = tp(self.start)
        for _, segment in self.iter_segments():
            segment.control_points = np.stack(
                [tp(p) for p in segment.control_points]
            )
        return self

    def reverse(self) -> "Path":
        """Reverse the direction of the path and all its segments; flips
        orientation (path.rs:441-488)."""
        previous = self.start
        for segment_type, segment in self.iter_segments():
            cps = segment.control_points
            if segment_type is SegmentType.LINE:
                previous, cps[0] = cps[0].copy(), previous
            elif segment_type in (
                SegmentType.INTEGRAL_QUADRATIC_CURVE,
                SegmentType.RATIONAL_QUADRATIC_CURVE,
            ):
                previous, cps[1] = cps[1].copy(), previous
            else:
                cps[[0, 1]] = cps[[1, 0]]
                previous, cps[2] = cps[2].copy(), previous
                if segment_type is SegmentType.RATIONAL_CUBIC_CURVE:
                    segment.weights = segment.weights[::-1].copy()
            segment.control_points = cps
        self.start = previous
        self.segment_types.reverse()
        for name in _SEGMENT_LISTS.values():
            getattr(self, name).reverse()
        return self

    def convert_integral_curves_to_rational_curves(self) -> "Path":
        """Lift integral quadratic/cubic segments to rational ones with
        unit weights (path.rs:490-534)."""
        new_rq: List[RationalQuadraticCurveSegment] = []
        new_rc: List[RationalCubicCurveSegment] = []
        iq_iter = iter(self.integral_quadratic_curve_segments)
        ic_iter = iter(self.integral_cubic_curve_segments)
        rq_iter = iter(self.rational_quadratic_curve_segments)
        rc_iter = iter(self.rational_cubic_curve_segments)
        new_types = []
        for segment_type in self.segment_types:
            if segment_type is SegmentType.INTEGRAL_QUADRATIC_CURVE:
                segment = next(iq_iter)
                new_rq.append(
                    RationalQuadraticCurveSegment(1.0, segment.control_points)
                )
                new_types.append(SegmentType.RATIONAL_QUADRATIC_CURVE)
            elif segment_type is SegmentType.INTEGRAL_CUBIC_CURVE:
                segment = next(ic_iter)
                new_rc.append(
                    RationalCubicCurveSegment([1.0] * 4, segment.control_points)
                )
                new_types.append(SegmentType.RATIONAL_CUBIC_CURVE)
            elif segment_type is SegmentType.RATIONAL_QUADRATIC_CURVE:
                new_rq.append(next(rq_iter))
                new_types.append(segment_type)
            elif segment_type is SegmentType.RATIONAL_CUBIC_CURVE:
                new_rc.append(next(rc_iter))
                new_types.append(segment_type)
            else:
                new_types.append(segment_type)
        self.integral_quadratic_curve_segments = []
        self.integral_cubic_curve_segments = []
        self.rational_quadratic_curve_segments = new_rq
        self.rational_cubic_curve_segments = new_rc
        self.segment_types = new_types
        return self

    def convert_quadratic_curves_to_cubic_curves(self) -> "Path":
        """Degree-elevate quadratic segments to cubic ones
        (path.rs:536-615)."""
        new_ic: List[IntegralCubicCurveSegment] = []
        new_rc: List[RationalCubicCurveSegment] = []
        new_types = []
        line_iter = iter(self.line_segments)
        iq_iter = iter(self.integral_quadratic_curve_segments)
        ic_iter = iter(self.integral_cubic_curve_segments)
        rq_iter = iter(self.rational_quadratic_curve_segments)
        rc_iter = iter(self.rational_cubic_curve_segments)
        previous = self.start
        for segment_type in self.segment_types:
            if segment_type is SegmentType.LINE:
                previous = next(line_iter).control_points[0]
                new_types.append(segment_type)
            elif segment_type is SegmentType.INTEGRAL_QUADRATIC_CURVE:
                segment = next(iq_iter)
                a, b = segment.control_points
                new_ic.append(
                    IntegralCubicCurveSegment(
                        [
                            previous + (a - previous) * (2.0 / 3.0),
                            b + (a - b) * (2.0 / 3.0),
                            b,
                        ]
                    )
                )
                new_types.append(SegmentType.INTEGRAL_CUBIC_CURVE)
                previous = b
            elif segment_type is SegmentType.INTEGRAL_CUBIC_CURVE:
                segment = next(ic_iter)
                new_ic.append(segment)
                new_types.append(segment_type)
                previous = segment.control_points[2]
            elif segment_type is SegmentType.RATIONAL_QUADRATIC_CURVE:
                segment = next(rq_iter)
                p0 = ga2d.vec_to_point(previous)
                p1 = ga2d.weighted_vec_to_point(
                    segment.weight, segment.control_points[0]
                )
                p2 = ga2d.vec_to_point(segment.control_points[1])
                n0 = p0 + (p1 - p0) * (2.0 / 3.0)
                n1 = p2 + (p1 - p2) * (2.0 / 3.0)
                new_rc.append(
                    RationalCubicCurveSegment(
                        [1.0, n0[0], n1[0], 1.0],
                        [
                            ga2d.point_to_vec(n0),
                            ga2d.point_to_vec(n1),
                            segment.control_points[1],
                        ],
                    )
                )
                new_types.append(SegmentType.RATIONAL_CUBIC_CURVE)
                previous = segment.control_points[1]
            else:
                segment = next(rc_iter)
                new_rc.append(segment)
                new_types.append(segment_type)
                previous = segment.control_points[2]
        self.integral_quadratic_curve_segments = []
        self.rational_quadratic_curve_segments = []
        self.integral_cubic_curve_segments = new_ic
        self.rational_cubic_curve_segments = new_rc
        self.segment_types = new_types
        return self

    def close(self) -> "Path":
        """"close" command: push a line back to `start` unless already
        there (path.rs:617-628)."""
        if (
            ga2d.squared_magnitude(_tangent_from_points(self.start, self.get_end()))
            <= ERROR_MARGIN
        ):
            return self
        self.push_line(LineSegment([self.start]))
        return self

    # -- arc commands (reference path.rs:630-708) --------------------------

    def push_quarter_ellipse(self, tangent_crossing, to):
        """"arc to" for rectangular angles, defined by the point where the
        start and end tangents cross (path.rs:630-636)."""
        self.push_rational_quadratic_curve(
            RationalQuadraticCurveSegment(
                math.sqrt(0.5), [tangent_crossing, to]
            )
        )

    def push_elliptical_arc(
        self, half_extent, rotation: float, large_arc: bool, sweep: bool, to
    ):
        """"arc to" for general elliptical arcs, SVG endpoint
        parameterization (path.rs:638-708; w3.org/TR/SVG/implnote.html).

        Emits a sequence of rational quadratic segments covering at most
        120° each.
        """
        rx, ry = abs(half_extent[0]), abs(half_extent[1])
        if rx == 0.0 or ry == 0.0:
            self.push_line(LineSegment([to]))
            return
        radii = np.array([rx, ry])
        src = self.get_end()
        dst = _pt(to)
        cos_r, sin_r = math.cos(rotation), math.sin(rotation)

        def rot(v, c, s):
            return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1]])

        # Half chord vector in the ellipse's unrotated frame.
        vertex = rot((dst - src) * 0.5, cos_r, -sin_r)
        radii_sq = radii * radii
        scale_factor_squared = (
            vertex[0] ** 2 / radii_sq[0] + vertex[1] ** 2 / radii_sq[1]
        )
        if scale_factor_squared > 1.0:
            # Scale radii up so they can cover the endpoint distance.
            radii = radii * math.sqrt(scale_factor_squared)
            radii_sq = radii * radii
        rsvs = radii_sq[0] * vertex[1] ** 2 + radii_sq[1] * vertex[0] ** 2
        offset = math.sqrt(max(0.0, (radii_sq[0] * radii_sq[1] - rsvs) / rsvs))
        if large_arc == sweep:
            offset = -offset
        # 90° CW rotation of the radii-normalized chord, rescaled.
        center_offset = (
            np.array(
                [radii[0] * vertex[1] / radii[1], -radii[1] * vertex[0] / radii[0]]
            )
            * offset
        )
        center = (src + dst) * 0.5 + rot(center_offset, cos_r, sin_r)
        start_normal = (-vertex - center_offset) / radii
        end_normal = (vertex - center_offset) / radii
        polar_start = complex(start_normal[0], start_normal[1])
        polar_start /= abs(polar_start)
        polar_end = complex(end_normal[0], end_normal[1])
        polar_end /= abs(polar_end)
        polar_range = polar_end / polar_start
        small_arc = math.atan2(polar_range.imag, polar_range.real)
        if small_arc < 0.0:
            polar_range = polar_range.conjugate()
            small_arc = -small_arc
        angle = small_arc
        if large_arc:
            angle -= TAU
        steps = max(1, math.ceil(abs(angle) / (TAU / 3.0)))
        if large_arc != sweep:
            angle = -angle
        step_angle = angle / steps
        polar_step = complex(math.cos(step_angle), math.sin(step_angle))
        half_polar_step_back = complex(
            math.cos(-0.5 * step_angle), math.sin(-0.5 * step_angle)
        )
        weight = math.cos(abs(angle) / steps * 0.5)
        tangent_crossing_radii = radii / weight
        interpolated = polar_start
        for _ in range(steps):
            interpolated = interpolated * polar_step
            vertex_u = np.array([interpolated.real, interpolated.imag]) * radii
            vertex_point = center + rot(vertex_u, cos_r, sin_r)
            mid = interpolated * half_polar_step_back
            crossing_u = np.array([mid.real, mid.imag]) * tangent_crossing_radii
            crossing_point = center + rot(crossing_u, cos_r, sin_r)
            self.push_rational_quadratic_curve(
                RationalQuadraticCurveSegment(weight, [crossing_point, vertex_point])
            )

    # -- constructors (reference path.rs:710-815) --------------------------

    @classmethod
    def from_polygon(cls, vertices: Sequence[Tuple[float, float]]) -> "Path":
        """Polygon from a sequence of points (path.rs:710-723)."""
        it = iter(vertices)
        result = cls(start=next(it))
        for control_point in it:
            result.push_line(LineSegment([control_point]))
        return result

    @classmethod
    def from_regular_polygon(
        cls, center, radius: float, rotation: float, vertex_count: int
    ) -> "Path":
        """Regular polygon approximating a circle (path.rs:725-733)."""
        vertices = [
            (
                center[0] + radius * math.cos(rotation + i / vertex_count * TAU),
                center[1] + radius * math.sin(rotation + i / vertex_count * TAU),
            )
            for i in range(vertex_count)
        ]
        return cls.from_polygon(vertices)

    @classmethod
    def from_rect(cls, center, half_extent) -> "Path":
        """Axis-aligned rectangle (path.rs:735-743)."""
        cx, cy = center
        hx, hy = half_extent
        return cls.from_polygon(
            [(cx - hx, cy - hy), (cx - hx, cy + hy), (cx + hx, cy + hy), (cx + hx, cy - hy)]
        )

    @classmethod
    def from_rounded_rect(cls, center, half_extent, radius: float) -> "Path":
        """Rectangle with quarter-circle corner roundings (path.rs:745-780)."""
        cx, cy = center
        hx, hy = half_extent
        corners = [
            ((cx - hx + radius, cy - hy), (cx - hx, cy - hy), (cx - hx, cy - hy + radius)),
            ((cx - hx, cy + hy - radius), (cx - hx, cy + hy), (cx - hx + radius, cy + hy)),
            ((cx + hx - radius, cy + hy), (cx + hx, cy + hy), (cx + hx, cy + hy - radius)),
            ((cx + hx, cy - hy + radius), (cx + hx, cy - hy), (cx + hx - radius, cy - hy)),
        ]
        result = cls(start=corners[3][2])
        for from_pt, corner, to_pt in corners:
            result.push_line(LineSegment([from_pt]))
            result.push_quarter_ellipse(corner, to_pt)
        return result

    @classmethod
    def from_ellipse(cls, center, half_extent) -> "Path":
        """Ellipse from four quarter arcs (path.rs:782-810)."""
        cx, cy = center
        hx, hy = half_extent
        quads = [
            ((cx - hx, cy - hy), (cx - hx, cy)),
            ((cx - hx, cy + hy), (cx, cy + hy)),
            ((cx + hx, cy + hy), (cx + hx, cy)),
            ((cx + hx, cy - hy), (cx, cy - hy)),
        ]
        result = cls(start=quads[3][1])
        for corner, to_pt in quads:
            result.push_quarter_ellipse(corner, to_pt)
        return result

    @classmethod
    def from_circle(cls, center, radius: float) -> "Path":
        """Circle (path.rs:812-815)."""
        return cls.from_ellipse(center, (radius, radius))
