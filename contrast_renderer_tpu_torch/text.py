"""Text layout: font faces, glyph outlines → paths.

The layout part of the reference's text subsystem (src/text.rs) on top
of the pure-Python TTF reader (`ttf.py`): glyph outlines become Paths
(one per contour, src/text.rs:60-94), and strings are laid out with
kerning, line breaking and alignment (src/text.rs:145-230).  The text
command builders and caret geometry are not ported yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .path import (
    IntegralCubicCurveSegment,
    IntegralQuadraticCurveSegment,
    LineSegment,
    Path,
)
from .ttf import Face
from .utils import ga2d

REPLACEMENT_CHARACTER = "�"


class Font:
    """Heap-owned font face (reference src/text.rs:10-38)."""

    def __init__(self, name: str, font_data: bytes):
        self._name = name
        self.face = Face(bytes(font_data), 0)

    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"Font({self._name!r})"


class _OutlineBuilder:
    """Maps outline callbacks to Path pushes, one Path per contour
    (reference src/text.rs:60-94)."""

    def __init__(self):
        self.path = Path()
        self.paths: List[Path] = []

    def move_to(self, x, y):
        self.path.start = np.array([x, y], dtype=np.float64)

    def line_to(self, x, y):
        self.path.push_line(LineSegment([(x, y)]))

    def quad_to(self, x1, y1, x, y):
        self.path.push_integral_quadratic_curve(
            IntegralQuadraticCurveSegment([(x1, y1), (x, y)])
        )

    def curve_to(self, x1, y1, x2, y2, x, y):
        self.path.push_integral_cubic_curve(
            IntegralCubicCurveSegment([(x1, y1), (x2, y2), (x, y)])
        )

    def close(self):
        path, self.path = self.path, Path()
        self.paths.append(path)


def paths_of_glyph(face: Face, glyph_id: int) -> List[Path]:
    """Paths of a glyph in font units (reference src/text.rs:97-104)."""
    builder = _OutlineBuilder()
    if face.outline_glyph(glyph_id, builder):
        return builder.paths
    return []


class Orientation(enum.Enum):
    """Axis and direction of text flow (reference src/text.rs:107-117)."""

    RIGHT_TO_LEFT = "right_to_left"
    LEFT_TO_RIGHT = "left_to_right"
    TOP_TO_BOTTOM = "top_to_bottom"
    BOTTOM_TO_TOP = "bottom_to_top"


class Alignment(enum.Enum):
    """Where the origin of the text is (reference src/text.rs:119-130)."""

    BEGIN = "begin"
    BASELINE = "baseline"
    CENTER = "center"
    END = "end"


@dataclass
class Layout:
    """Geometric layout of a text (reference src/text.rs:132-143)."""

    size: float
    orientation: Orientation = Orientation.LEFT_TO_RIGHT
    major_alignment: Alignment = Alignment.CENTER
    minor_alignment: Alignment = Alignment.CENTER


def _calculate_aligned_positions(face: Face, layout: Layout, text: str):
    """Kerned, aligned glyph positions per line
    (reference src/text.rs:145-230).

    Returns (extent [2], offset [2], lines: list of (line_range_end,
    [(position [2], glyph_id), ...])).  Positions are in font units.
    """
    replacement_glyph = face.glyph_index(REPLACEMENT_CHARACTER)
    orientation_map = {
        Orientation.RIGHT_TO_LEFT: (0, -1, -1),
        Orientation.LEFT_TO_RIGHT: (0, 1, -1),
        Orientation.TOP_TO_BOTTOM: (1, 1, -1),
        Orientation.BOTTOM_TO_TOP: (1, 1, 1),
    }
    major_axis, sign_x, sign_y = orientation_map[layout.orientation]
    if major_axis == 0:
        line_minor_extent = face.height()
        line_gap = face.line_gap()
    else:
        line_minor_extent = face.vertical_height() or 0
        line_gap = face.vertical_line_gap() or 0
    lines = []
    line_major_extent = 0
    extent = [0, 0]
    glyph_positions = []
    prev_glyph_id = None
    index = 0
    for char in text:
        index += 1
        position = extent.copy()
        position[major_axis] = line_major_extent
        if char == "\n":
            glyph_positions.append((position, 0))
            lines.append((index, glyph_positions))
            glyph_positions = []
            extent[major_axis] = max(extent[major_axis], line_major_extent)
            extent[1 - major_axis] += line_minor_extent + line_gap
            line_major_extent = 0
            prev_glyph_id = None
        else:
            glyph_id = face.glyph_index(char)
            if glyph_id is None:
                glyph_id = replacement_glyph or 0
            if prev_glyph_id is not None:
                kerning = face.glyphs_kerning(prev_glyph_id, glyph_id)
                if kerning is not None:
                    line_major_extent += kerning
            prev_glyph_id = glyph_id
            if major_axis == 0:
                advance = face.glyph_hor_advance(glyph_id)
            else:
                advance = face.glyph_ver_advance(glyph_id)
            if advance is not None:
                line_major_extent += advance
            glyph_positions.append((position, glyph_id))
    position = extent.copy()
    position[major_axis] = line_major_extent
    glyph_positions.append((position, 0))
    lines.append((index + 1, glyph_positions))
    extent[major_axis] = max(extent[major_axis], line_major_extent)
    extent[1 - major_axis] += line_minor_extent

    offset = [0, 0]
    if layout.minor_alignment is Alignment.BEGIN:
        offset[1 - major_axis] = -face.descender
    elif layout.minor_alignment is Alignment.BASELINE:
        offset[1 - major_axis] = 0
    elif layout.minor_alignment is Alignment.CENTER:
        offset[1 - major_axis] = (face.x_height() or 0) // 2
    else:
        offset[1 - major_axis] = -line_minor_extent
    for _line_range_end, positions in lines:
        line_extent = positions[-1][0][major_axis]
        line_offset = offset.copy()
        if layout.major_alignment is Alignment.BEGIN:
            line_offset[major_axis] = -extent[major_axis] // 2
        elif layout.major_alignment in (Alignment.BASELINE, Alignment.CENTER):
            line_offset[major_axis] = -line_extent // 2
        else:
            line_offset[major_axis] = (
                extent[major_axis] // 2 - line_extent
            )
        line_offset[1 - major_axis] -= (
            extent[1 - major_axis] - line_minor_extent
        ) // 2
        for position, _glyph_id in positions:
            position[0] = sign_x * (position[0] + line_offset[0])
            position[1] = sign_y * (position[1] + line_offset[1])
    return extent, [sign_x * offset[0], sign_y * offset[1]], lines


def paths_of_text(
    face: Face,
    layout: Layout,
    text: str,
    clipping_area: Optional[np.ndarray] = None,
) -> List[Path]:
    """Arrange a string into glyph paths (reference src/text.rs:232-263).

    Glyphs completely outside the convex `clipping_area` (homogeneous
    points, clockwise) are discarded.
    """
    _extent, _offset, lines = _calculate_aligned_positions(face, layout, text)
    scale = layout.size / face.height()
    result: List[Path] = []
    # Outline cache: a glyph's paths are parsed once and copied per
    # instance (repeated glyphs dominate real text).
    outline_cache = {}
    for _line_range_end, glyph_positions in lines:
        for (x, y), glyph_id in glyph_positions[:-1]:
            if clipping_area is not None:
                bbox = face.glyph_bounding_box(glyph_id)
                if bbox is not None:
                    aabb = [
                        (bbox[0] + x) * scale,
                        (bbox[1] + y) * scale,
                        (bbox[2] + x) * scale,
                        (bbox[3] + y) * scale,
                    ]
                    if not ga2d.do_convex_polygons_overlap(
                        ga2d.aabb_to_convex_polygon(aabb), clipping_area
                    ):
                        continue
            protos = outline_cache.get(glyph_id)
            if protos is None:
                protos = paths_of_glyph(face, glyph_id)
                outline_cache[glyph_id] = protos
            offset = (x * scale, y * scale)
            for proto in protos:
                result.append(proto.copy_affine(scale, offset))
    return result
