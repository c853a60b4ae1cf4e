"""Stroke tessellation: paths → stroke line/joint triangle tables.

Re-implements the reference's stroke builder (src/stroke.rs): strokes
are approximated by polygon tessellation of the parametric curves —
two offset vertices per sample point with texcoords
(side ∈ {-0.5, +0.5}, arc-length/width) (stroke.rs:24-51), five-vertex
joint polygons with miter clipping and polar texcoords
(stroke.rs:53-121), start/end cap extensions flagged for the per-sample
cap predicates (stroke.rs:270-293, 443-462), and per-curve sampling by
uniformly spaced parameters or uniform tangent angle
(stroke.rs:134-168).

Joins, caps and dashing are *not* baked into geometry: they are resolved
per sample by the device predicates (reference src/shaders.wgsl:165-300)
using the texcoords and the dynamic stroke descriptor of the path's
group, so dash phase animates without re-tessellation.

Triangle encoding (see vertex.py):
- ``KIND_STROKE_LINE``: aux = (side, offset_along_path, 0, 0) per vertex;
  meta = (group + END_CAP_FLAG?, provoking vertex's offset) — the flat
  attributes of the reference's provoking vertex (shaders.wgsl:94-100).
- ``KIND_STROKE_JOINT``: aux = (x, y, offset_along_path, 0) in the joint's
  local width-units frame; meta = (group + JOINT_TIP_FLAG?, 0).  The tip
  flag marks the miter-tip triangles beyond the bevel triangle, enabling
  a correct bevel join (the reference wires a bevel flag in its shader,
  shaders.wgsl:191-203, but never sets it, stroke.rs:98-107).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .curve import (
    integral_cubic_uniform_tangent_angle,
    integral_quadratic_uniform_tangent_angle,
    rational_cubic_control_points_to_power_basis,
    rational_cubic_first_order_derivative,
    rational_cubic_point,
    rational_cubic_uniform_tangent_angle,
    rational_quadratic_control_points_to_power_basis,
    rational_quadratic_first_order_derivative,
    rational_quadratic_point,
    rational_quadratic_uniform_tangent_angle,
    uniform_arc_length_parameters,
)
from .error import ERROR_MARGIN
from .path import Path, SegmentType
from .utils import ga2d
from .vertex import (
    END_CAP_FLAG,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
    TriangleBuilder,
    TriangleTable,
)

#: Marks joint triangles belonging to the miter tip (beyond the bevel
#: triangle); consumed by the bevel join predicate.
JOINT_TIP_FLAG = 0x20000

TAU = 2.0 * math.pi


def _direction(tangent_line):
    """Unit direction vector (d.x, d.y) of a normalized tangent line."""
    return np.array([tangent_line[2], -tangent_line[1]])


def _left_normal(tangent_line):
    """Unit left normal (the line's (a, b) components)."""
    return np.array([tangent_line[1], tangent_line[2]])


class StrokeBuilder:
    """Accumulates stroke geometry for a set of paths
    (replaces reference StrokeBuilder, stroke.rs:170-177)."""

    def __init__(self):
        self._triangles = TriangleBuilder()
        # Current strip: list of (position(2,), side, offset, flagged_group)
        self._strip: List = []

    def build(self) -> TriangleTable:
        return self._triangles.build()

    # -- strip management --------------------------------------------------

    def _emit_vertex_pair(self, opts, group_flags, length_accumulator, point_xy, tangent):
        """Two offset vertices for one sample point (stroke.rs:24-51)."""
        width = opts.width
        n = _left_normal(tangent)
        offset_along_path = length_accumulator / width
        for side in (-0.5, 0.5):
            pos = point_xy + n * ((opts.offset + side) * width)
            self._strip.append((pos, side, offset_along_path, group_flags))

    def _cut_strip(self, proto_hull):
        """Flush the current strip into triangles (stroke.rs:123-132)."""
        strip = self._strip
        self._strip = []
        if len(strip) < 3:
            return
        pos = np.asarray([p[0] for p in strip], dtype=np.float64)
        side = np.asarray([p[1] for p in strip], dtype=np.float64)
        off = np.asarray([p[2] for p in strip], dtype=np.float64)
        grp = np.asarray([p[3] for p in strip], dtype=np.float64)
        proto_hull.extend(pos)
        # Strip → triangle windows (i, i+1, i+2), provoking vertex i.
        xy = np.stack([pos[:-2], pos[1:-1], pos[2:]], axis=1)
        aux = np.zeros((len(strip) - 2, 3, 2), dtype=np.float64)
        aux[..., 0] = np.stack([side[:-2], side[1:-1], side[2:]], axis=1)
        aux[..., 1] = np.stack([off[:-2], off[1:-1], off[2:]], axis=1)
        meta = np.stack([grp[:-2], off[:-2]], axis=1)
        self._triangles.push_many(xy, KIND_STROKE_LINE, aux=aux, meta=meta)

    # -- joints ------------------------------------------------------------

    def _emit_join(
        self,
        proto_hull,
        opts,
        length_accumulator,
        control_point_xy,
        previous_tangent,
        next_tangent,
    ):
        """Joint polygon where two segments meet (stroke.rs:53-121).

        Returns the updated length accumulator.
        """
        dot = ga2d.inner_ll(previous_tangent, next_tangent)
        if abs(dot - 1.0) <= ERROR_MARGIN:
            return length_accumulator
        width = opts.width
        side_sign = 1.0 if ga2d.outer_ll(previous_tangent, next_tangent) >= 0.0 else -1.0
        miter_clip = width * opts.miter_clip
        side_offset = (opts.offset - side_sign * 0.5) * width
        n_prev = _left_normal(previous_tangent)
        n_next = _left_normal(next_tangent)
        d_prev = _direction(previous_tangent)
        d_next = _direction(next_tangent)
        c = np.asarray(control_point_xy, dtype=np.float64)
        prev_edge_vertex = c + n_prev * side_offset
        next_edge_vertex = c + n_next * side_offset
        prev_edge_line = ga2d.line_through_point_with_direction(
            previous_tangent, ga2d.vec_to_point(prev_edge_vertex)
        )
        next_edge_line = ga2d.line_through_point_with_direction(
            next_tangent, ga2d.vec_to_point(next_edge_vertex)
        )
        anti_parallel = abs(dot + 1.0) <= ERROR_MARGIN
        if not anti_parallel:
            intersection = ga2d.point_to_vec(
                ga2d.line_line_intersection(prev_edge_line, next_edge_line)
            )
        else:
            intersection = c  # replaced below
        vertices = [c, prev_edge_vertex, next_edge_vertex, intersection, intersection]
        if anti_parallel or np.linalg.norm(intersection - c) > miter_clip:
            if anti_parallel:
                mid_tangent = -ga2d.rotate_90_degree_clockwise(previous_tangent)
            else:
                mid_tangent = ga2d.signum(previous_tangent + next_tangent)
            mid_n = _left_normal(mid_tangent)
            clipping_vertex = c + mid_n * (-side_sign * miter_clip)
            clipping_line = ga2d.line_through_point_with_direction(
                mid_tangent, ga2d.vec_to_point(clipping_vertex)
            )
            vertices[3] = ga2d.point_to_vec(
                ga2d.line_line_intersection(prev_edge_line, clipping_line)
            )
            vertices[4] = ga2d.point_to_vec(
                ga2d.line_line_intersection(clipping_line, next_edge_line)
            )
            proto_hull.append(vertices[3])
            proto_hull.append(vertices[4])
        else:
            proto_hull.append(vertices[3])
        offset_along_path = length_accumulator / width
        texcoords = []
        for v in vertices:
            delta = (np.asarray(v) - c) / width
            tex_x = -side_sign * float(np.dot(delta, n_prev))
            tex_y = float(np.dot(delta, d_prev))
            texcoords.append((tex_x, tex_y, offset_along_path))
        group = float(opts.dynamic_stroke_options_group)
        # Strip triangles (0,1,2), (1,2,3), (2,3,4); the first is the bevel
        # triangle, the others form the (possibly clipped) miter tip.
        for t_index in range(3):
            idx = (t_index, t_index + 1, t_index + 2)
            xy = np.stack([vertices[j] for j in idx])
            aux = np.array([[*texcoords[j], 0.0] for j in idx])
            flags = group if t_index == 0 else group + JOINT_TIP_FLAG
            self._triangles.push(
                xy, KIND_STROKE_JOINT, aux=aux, meta=(flags, 0.0)
            )
        length_accumulator += math.acos(max(-1.0, min(1.0, dot))) / TAU * width
        return length_accumulator

    # -- curve sampling ----------------------------------------------------

    def _emit_curve_stroke(
        self,
        opts,
        group,
        length_accumulator,
        previous_point_h,
        power_basis,
        point_fn,
        derivative_fn,
        parameters,
    ):
        """Sample a curve segment into offset vertex pairs
        (stroke.rs:134-168) — all samples evaluated in one batch."""
        previous = ga2d.point_to_vec(previous_point_h)
        ts = np.asarray(parameters, dtype=np.float64)
        if ts.size == 0:
            return length_accumulator
        tangents = derivative_fn(power_basis, ts)  # (N, 3)
        degenerate = ga2d.squared_magnitude(tangents) == 0.0
        if np.any(degenerate):
            # Zero-tangent samples: ε-nudge toward the curve interior
            # (stroke.rs:134-168's zero-tangent handling).
            eps = np.finfo(np.float32).eps
            nudged = ts + np.where(ts < 0.5, eps, -eps)
            tangents = np.where(
                degenerate[..., None],
                derivative_fn(power_basis, nudged),
                tangents,
            )
        tangents = ga2d.signum(tangents)
        points = ga2d.point_to_vec(point_fn(power_basis, ts))  # (N, 2)
        deltas = np.linalg.norm(
            np.diff(np.concatenate([previous[None], points]), axis=0),
            axis=-1,
        )
        offsets = length_accumulator + np.cumsum(deltas)
        width = opts.width
        normals = tangents[..., 1:3]
        path_offsets = offsets / width
        lo = points + normals * ((opts.offset - 0.5) * width)
        hi = points + normals * ((opts.offset + 0.5) * width)
        strip = self._strip
        for i in range(len(points)):
            strip.append((lo[i], -0.5, path_offsets[i], group))
            strip.append((hi[i], 0.5, path_offsets[i], group))
        return float(offsets[-1])

    # -- main entry --------------------------------------------------------

    def add_path(self, proto_hull: List, path: Path):
        """Tessellate one stroked path (stroke.rs:205-465)."""
        opts = path.stroke_options
        width = opts.width
        group = float(opts.dynamic_stroke_options_group)
        previous_point = ga2d.vec_to_point(path.start)
        first_tangent = np.zeros(3)
        previous_tangent = np.zeros(3)
        length_accumulator = 0.0
        is_first_segment = True

        for segment_type, segment in path.iter_segments():
            prev_xy = ga2d.point_to_vec(previous_point)
            if segment_type is SegmentType.LINE:
                next_point = ga2d.vec_to_point(segment.control_points[0])
                start_tangent = ga2d.signum(ga2d.join(previous_point, next_point))
                end_tangent = start_tangent
            elif segment_type in (
                SegmentType.INTEGRAL_QUADRATIC_CURVE,
                SegmentType.RATIONAL_QUADRATIC_CURVE,
            ):
                next_point = ga2d.vec_to_point(segment.control_points[1])
                mid = ga2d.vec_to_point(segment.control_points[0])
                start_tangent = ga2d.signum(ga2d.join(previous_point, mid))
                end_tangent = ga2d.signum(ga2d.join(mid, next_point))
                if np.isnan(start_tangent[0]) or np.isnan(end_tangent[0]):
                    start_tangent = ga2d.signum(ga2d.join(previous_point, next_point))
                    end_tangent = start_tangent
            else:
                next_point = ga2d.vec_to_point(segment.control_points[2])
                c1 = ga2d.vec_to_point(segment.control_points[0])
                c2 = ga2d.vec_to_point(segment.control_points[1])
                start_tangent = ga2d.signum(ga2d.join(previous_point, c1))
                if np.isnan(start_tangent[0]):
                    start_tangent = ga2d.signum(ga2d.join(previous_point, c2))
                end_tangent = ga2d.signum(ga2d.join(c2, next_point))
                if np.isnan(end_tangent[0]):
                    end_tangent = ga2d.signum(ga2d.join(c1, next_point))
                if np.isnan(start_tangent[0]) or np.isnan(end_tangent[0]):
                    end_tangent = ga2d.signum(ga2d.join(previous_point, next_point))
                    start_tangent = end_tangent
            if np.isnan(start_tangent[0]) or np.isnan(end_tangent[0]):
                continue  # degenerate segment (stroke.rs:267-269)

            if is_first_segment:
                is_first_segment = False
                first_tangent = start_tangent
                if not opts.closed:
                    # Start cap pre-extension, half a width beyond the
                    # start (stroke.rs:270-283).
                    d = _direction(start_tangent)
                    self._emit_vertex_pair(
                        opts,
                        group,
                        length_accumulator - 0.5 * width,
                        ga2d.point_to_vec(previous_point) - d * (0.5 * abs(width)),
                        start_tangent,
                    )
                if opts.closed or segment_type is not SegmentType.LINE:
                    self._emit_vertex_pair(
                        opts,
                        group,
                        length_accumulator,
                        ga2d.point_to_vec(previous_point),
                        start_tangent,
                    )
            else:
                length_accumulator = self._emit_join(
                    proto_hull,
                    opts,
                    length_accumulator,
                    ga2d.point_to_vec(previous_point),
                    previous_tangent,
                    start_tangent,
                )
                self._cut_strip_before_continue(proto_hull, opts, group,
                                                length_accumulator,
                                                ga2d.point_to_vec(previous_point),
                                                start_tangent)

            approx = opts.curve_approximation
            if segment_type is SegmentType.LINE:
                length_accumulator += float(
                    np.linalg.norm(
                        ga2d.point_to_vec(next_point) - ga2d.point_to_vec(previous_point)
                    )
                )
                self._emit_vertex_pair(
                    opts, group, length_accumulator,
                    ga2d.point_to_vec(next_point), end_tangent,
                )
            elif segment_type in (
                SegmentType.INTEGRAL_QUADRATIC_CURVE,
                SegmentType.RATIONAL_QUADRATIC_CURVE,
            ):
                w = getattr(segment, "weight", 1.0)
                cps = np.stack(
                    [
                        previous_point,
                        ga2d.weighted_vec_to_point(w, segment.control_points[0]),
                        next_point,
                    ]
                )
                pb = rational_quadratic_control_points_to_power_basis(cps)
                if approx.kind == "uniform_parameters":
                    n = int(approx.value)
                    parameters = [(i + 1) / n for i in range(n)]
                elif approx.kind == "uniform_arc_length":
                    parameters = uniform_arc_length_parameters(
                        pb, rational_quadratic_point, approx.value
                    )
                elif segment_type is SegmentType.INTEGRAL_QUADRATIC_CURVE:
                    parameters = integral_quadratic_uniform_tangent_angle(
                        pb, start_tangent, end_tangent, approx.value
                    )
                else:
                    parameters = rational_quadratic_uniform_tangent_angle(
                        pb, start_tangent, end_tangent, approx.value
                    )
                length_accumulator = self._emit_curve_stroke(
                    opts, group, length_accumulator, previous_point, pb,
                    rational_quadratic_point,
                    rational_quadratic_first_order_derivative,
                    parameters,
                )
            else:
                w = getattr(segment, "weights", np.ones(4))
                cps = np.stack(
                    [ga2d.weighted_vec_to_point(w[0], ga2d.point_to_vec(previous_point))]
                    + [
                        ga2d.weighted_vec_to_point(w[i + 1], segment.control_points[i])
                        for i in range(3)
                    ]
                )
                pb = rational_cubic_control_points_to_power_basis(cps)
                if approx.kind == "uniform_parameters":
                    n = int(approx.value)
                    parameters = [(i + 1) / n for i in range(n)]
                elif approx.kind == "uniform_arc_length":
                    parameters = uniform_arc_length_parameters(
                        pb, rational_cubic_point, approx.value
                    )
                elif segment_type is SegmentType.INTEGRAL_CUBIC_CURVE:
                    parameters = integral_cubic_uniform_tangent_angle(pb, approx.value)
                else:
                    parameters = rational_cubic_uniform_tangent_angle(pb, approx.value)
                length_accumulator = self._emit_curve_stroke(
                    opts, group, length_accumulator, previous_point, pb,
                    rational_cubic_point,
                    rational_cubic_first_order_derivative,
                    parameters,
                )
            previous_point = next_point
            previous_tangent = end_tangent

        if is_first_segment:
            return  # no drawable segments
        if opts.closed:
            # Implicit closing line + double join (stroke.rs:400-442).
            start_point = ga2d.vec_to_point(path.start)
            closing = ga2d.join(previous_point, start_point)
            length = ga2d.magnitude(closing)
            if length > 0.0:
                closing_tangent = closing / length
                length_accumulator = self._emit_join(
                    proto_hull, opts, length_accumulator,
                    ga2d.point_to_vec(previous_point),
                    previous_tangent, closing_tangent,
                )
                self._cut_strip_before_continue(
                    proto_hull, opts, group, length_accumulator,
                    ga2d.point_to_vec(previous_point), closing_tangent,
                )
                length_accumulator += length
                self._emit_vertex_pair(
                    opts, group, length_accumulator,
                    ga2d.point_to_vec(start_point), closing_tangent,
                )
                length_accumulator = self._emit_join(
                    proto_hull, opts, length_accumulator,
                    ga2d.point_to_vec(start_point), closing_tangent, first_tangent,
                )
                self._cut_strip_before_continue(
                    proto_hull, opts, group, length_accumulator,
                    ga2d.point_to_vec(start_point), first_tangent,
                )
            else:
                length_accumulator = self._emit_join(
                    proto_hull, opts, length_accumulator,
                    ga2d.point_to_vec(start_point), previous_tangent, first_tangent,
                )
                self._cut_strip_before_continue(
                    proto_hull, opts, group, length_accumulator,
                    ga2d.point_to_vec(start_point), first_tangent,
                )
        else:
            # End cap extension, flagged so the fragment predicate applies
            # the end cap beyond the provoking vertex's offset
            # (stroke.rs:443-462).
            self._cut_strip(proto_hull)
            flagged = group + END_CAP_FLAG
            self._emit_vertex_pair(
                opts, flagged, length_accumulator,
                ga2d.point_to_vec(previous_point), previous_tangent,
            )
            d = _direction(previous_tangent)
            self._emit_vertex_pair(
                opts, flagged, length_accumulator + 0.5 * width,
                ga2d.point_to_vec(previous_point) + d * (0.5 * abs(width)),
                previous_tangent,
            )
        self._cut_strip(proto_hull)

    def _cut_strip_before_continue(
        self, proto_hull, opts, group, length_accumulator, point_xy, tangent
    ):
        """After a joint: flush the strip and restart it at the control
        point with the next tangent (stroke.rs:112-121)."""
        self._cut_strip(proto_hull)
        self._emit_vertex_pair(opts, group, length_accumulator, point_xy, tangent)
