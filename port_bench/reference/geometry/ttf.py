"""Minimal TrueType / OpenType font reader.

Replaces the reference's external `ttf-parser` crate (Cargo.toml:19,
used by src/text.rs) with a pure-Python reader of the tables the text
subsystem needs: head, maxp, cmap (formats 0/4/6/12), loca, glyf
(simple and composite outlines), CFF (Type 2 charstrings — OpenType
.otf outlines, see cff.py), hhea/hmtx (advances), kern (format 0) and
OS/2 (x-height).  Sufficient for general TrueType and OpenType/CFF
fonts (e.g. the bundled OpenSans-Regular.ttf); CFF2 variable outlines
raise error.UnsupportedFontFormat.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .error import UnsupportedFontFormat


def _u16(data, offset):
    return struct.unpack_from(">H", data, offset)[0]


def _i16(data, offset):
    return struct.unpack_from(">h", data, offset)[0]


def _u32(data, offset):
    return struct.unpack_from(">I", data, offset)[0]


@dataclass
class GlyphPoint:
    x: float
    y: float
    on_curve: bool


class Face:
    """A parsed TrueType face (subset of ttf-parser's `Face` API that the
    text layer consumes, reference src/text.rs)."""

    def __init__(self, data: bytes, index: int = 0):
        self.data = data
        num_tables = _u16(data, 4)
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(num_tables):
            record = 12 + 16 * i
            tag = data[record : record + 4].decode("latin-1")
            offset = _u32(data, record + 8)
            length = _u32(data, record + 12)
            self.tables[tag] = (offset, length)
        head, _ = self.tables["head"]
        self.units_per_em = _u16(data, head + 18)
        self.index_to_loc_format = _i16(data, head + 50)
        maxp, _ = self.tables["maxp"]
        self.num_glyphs = _u16(data, maxp + 4)
        hhea, _ = self.tables["hhea"]
        self.ascender = _i16(data, hhea + 4)
        self.descender = _i16(data, hhea + 6)
        self._line_gap = _i16(data, hhea + 8)
        self.number_of_h_metrics = _u16(data, hhea + 34)
        self._x_height = None
        if "OS/2" in self.tables:
            os2, length = self.tables["OS/2"]
            version = _u16(data, os2)
            if version >= 2 and length >= 88:
                self._x_height = _i16(data, os2 + 86)
        self._cmap = self._parse_cmap()
        self._cff = None
        self._cff_bbox: Dict[int, object] = {}
        if "glyf" in self.tables and "loca" in self.tables:
            self._loca = self._parse_loca()
        elif "CFF " in self.tables or "CFF2" in self.tables:
            raise UnsupportedFontFormat(
                "CFF2 (variable) outlines are not supported; supply a "
                "static TrueType (glyf) or OpenType (CFF) font"
            )
        else:
            raise UnsupportedFontFormat(
                "font carries no glyf/loca or CFF outline tables"
            )
        self._kern = self._parse_kern()

    # -- metrics -----------------------------------------------------------

    def height(self) -> int:
        """ascender - descender (ttf-parser's Face::height)."""
        return self.ascender - self.descender

    def line_gap(self) -> int:
        return self._line_gap

    def x_height(self) -> Optional[int]:
        return self._x_height

    def vertical_height(self) -> Optional[int]:
        return None  # vhea unsupported (not present in target fonts)

    def vertical_line_gap(self) -> Optional[int]:
        return None

    # -- cmap --------------------------------------------------------------

    def _parse_cmap(self):
        cmap, _ = self.tables["cmap"]
        data = self.data
        n = _u16(data, cmap + 2)
        best = None
        for i in range(n):
            rec = cmap + 4 + 8 * i
            platform = _u16(data, rec)
            encoding = _u16(data, rec + 2)
            offset = cmap + _u32(data, rec + 4)
            fmt = _u16(data, offset)
            score = 0
            if platform == 3 and encoding == 10:
                score = 4
            elif platform == 0 and encoding in (4, 6):
                score = 4
            elif platform == 3 and encoding == 1:
                score = 3
            elif platform == 0:
                score = 2
            if fmt not in (0, 4, 6, 12):
                continue
            # Prefer the segmented Unicode formats; the byte/trimmed
            # formats (0, 6) are legacy fallbacks some fonts ship alone.
            if fmt in (0, 6):
                score -= 10
            if best is None or score > best[0]:
                best = (score, fmt, offset)
        if best is None:
            return {}
        _, fmt, offset = best
        mapping: Dict[int, int] = {}
        if fmt == 0:
            # Byte encoding table: 256 one-byte glyph ids.
            for code in range(256):
                glyph = data[offset + 6 + code]
                if glyph != 0:
                    mapping[code] = glyph
        elif fmt == 6:
            # Trimmed table: dense u16 range [first, first + count).
            first = _u16(data, offset + 6)
            count = _u16(data, offset + 8)
            for i in range(count):
                glyph = _u16(data, offset + 10 + 2 * i)
                if glyph != 0:
                    mapping[first + i] = glyph
        elif fmt == 4:
            seg_count = _u16(data, offset + 6) // 2
            ends = [_u16(data, offset + 14 + 2 * i) for i in range(seg_count)]
            starts = [
                _u16(data, offset + 16 + 2 * seg_count + 2 * i)
                for i in range(seg_count)
            ]
            deltas = [
                _i16(data, offset + 16 + 4 * seg_count + 2 * i)
                for i in range(seg_count)
            ]
            range_offset_pos = offset + 16 + 6 * seg_count
            for i in range(seg_count):
                range_offset = _u16(data, range_offset_pos + 2 * i)
                for code in range(starts[i], min(ends[i], 0x10FFFF) + 1):
                    if range_offset == 0:
                        glyph = (code + deltas[i]) & 0xFFFF
                    else:
                        addr = (
                            range_offset_pos
                            + 2 * i
                            + range_offset
                            + 2 * (code - starts[i])
                        )
                        glyph = _u16(data, addr)
                        if glyph != 0:
                            glyph = (glyph + deltas[i]) & 0xFFFF
                    if glyph != 0:
                        mapping[code] = glyph
        else:  # format 12
            n_groups = _u32(data, offset + 12)
            for g in range(n_groups):
                rec = offset + 16 + 12 * g
                start = _u32(data, rec)
                end = _u32(data, rec + 4)
                start_glyph = _u32(data, rec + 8)
                for code in range(start, end + 1):
                    mapping[code] = start_glyph + (code - start)
        return mapping

    def glyph_index(self, char) -> Optional[int]:
        """Glyph id for a character, or None (ttf-parser Face::glyph_index)."""
        return self._cmap.get(ord(char))

    # -- loca / glyf -------------------------------------------------------

    def _parse_loca(self):
        loca, _ = self.tables["loca"]
        data = self.data
        n = self.num_glyphs + 1
        if self.index_to_loc_format == 0:
            return [2 * _u16(data, loca + 2 * i) for i in range(n)]
        return [_u32(data, loca + 4 * i) for i in range(n)]

    def glyph_bounding_box(self, glyph_id: int):
        """(x_min, y_min, x_max, y_max) in font units, or None."""
        if self._cff is not None:
            if glyph_id not in self._cff_bbox:
                self._cff_bbox[glyph_id] = self._cff.bounding_box(glyph_id)
            return self._cff_bbox[glyph_id]
        span = self._glyph_span(glyph_id)
        if span is None:
            return None
        offset, _ = span
        data = self.data
        return (
            _i16(data, offset + 2),
            _i16(data, offset + 4),
            _i16(data, offset + 6),
            _i16(data, offset + 8),
        )

    def _glyph_span(self, glyph_id):
        if glyph_id is None or glyph_id >= self.num_glyphs:
            return None
        glyf, _ = self.tables["glyf"]
        start = self._loca[glyph_id]
        end = self._loca[glyph_id + 1]
        if end <= start:
            return None
        return (glyf + start, end - start)

    def outline_glyph(self, glyph_id: int, builder) -> bool:
        """Stream the glyph outline into `builder` (move_to/line_to/
        quad_to/curve_to/close callbacks, like ttf_parser::OutlineBuilder,
        reference src/text.rs:66-94).  Returns False for empty glyphs.
        """
        if self._cff is not None:
            return self._cff.outline(glyph_id, builder)
        contours = self._glyph_contours(glyph_id, depth=0)
        if not contours:
            return False
        for contour in contours:
            self._emit_contour(contour, builder)
        return True

    def _glyph_contours(self, glyph_id, depth) -> List[List[GlyphPoint]]:
        if depth > 5:
            return []
        span = self._glyph_span(glyph_id)
        if span is None:
            return []
        offset, _ = span
        data = self.data
        number_of_contours = _i16(data, offset)
        if number_of_contours >= 0:
            return self._simple_glyph(offset, number_of_contours)
        # Composite glyph.
        contours: List[List[GlyphPoint]] = []
        p = offset + 10
        while True:
            flags = _u16(data, p)
            component = _u16(data, p + 2)
            p += 4
            if flags & 0x0001:  # ARG_1_AND_2_ARE_WORDS
                arg1, arg2 = _i16(data, p), _i16(data, p + 2)
                p += 4
            else:
                arg1 = struct.unpack_from(">b", data, p)[0]
                arg2 = struct.unpack_from(">b", data, p + 1)[0]
                p += 2
            a, b, c, d = 1.0, 0.0, 0.0, 1.0
            if flags & 0x0008:  # WE_HAVE_A_SCALE
                a = d = _i16(data, p) / 16384.0
                p += 2
            elif flags & 0x0040:  # X_AND_Y_SCALE
                a = _i16(data, p) / 16384.0
                d = _i16(data, p + 2) / 16384.0
                p += 4
            elif flags & 0x0080:  # TWO_BY_TWO
                a = _i16(data, p) / 16384.0
                b = _i16(data, p + 2) / 16384.0
                c = _i16(data, p + 4) / 16384.0
                d = _i16(data, p + 6) / 16384.0
                p += 8
            dx, dy = (arg1, arg2) if flags & 0x0002 else (0, 0)
            for contour in self._glyph_contours(component, depth + 1):
                contours.append(
                    [
                        GlyphPoint(
                            a * pt.x + c * pt.y + dx,
                            b * pt.x + d * pt.y + dy,
                            pt.on_curve,
                        )
                        for pt in contour
                    ]
                )
            if not flags & 0x0020:  # MORE_COMPONENTS
                break
        return contours

    def _simple_glyph(self, offset, number_of_contours):
        data = self.data
        end_pts = [
            _u16(data, offset + 10 + 2 * i) for i in range(number_of_contours)
        ]
        n_points = (end_pts[-1] + 1) if end_pts else 0
        instruction_length = _u16(data, offset + 10 + 2 * number_of_contours)
        p = offset + 12 + 2 * number_of_contours + instruction_length
        flags = []
        while len(flags) < n_points:
            flag = data[p]
            p += 1
            flags.append(flag)
            if flag & 0x08:  # REPEAT
                repeat = data[p]
                p += 1
                flags.extend([flag] * repeat)
        xs: List[int] = []
        x = 0
        for flag in flags:
            if flag & 0x02:  # X_SHORT
                dx = data[p]
                p += 1
                x += dx if flag & 0x10 else -dx
            elif not flag & 0x10:
                x += _i16(data, p)
                p += 2
            xs.append(x)
        ys: List[int] = []
        y = 0
        for flag in flags:
            if flag & 0x04:  # Y_SHORT
                dy = data[p]
                p += 1
                y += dy if flag & 0x20 else -dy
            elif not flag & 0x20:
                y += _i16(data, p)
                p += 2
            ys.append(y)
        contours = []
        start = 0
        for end in end_pts:
            contour = [
                GlyphPoint(float(xs[i]), float(ys[i]), bool(flags[i] & 0x01))
                for i in range(start, end + 1)
            ]
            contours.append(contour)
            start = end + 1
        return contours

    @staticmethod
    def _emit_contour(points: List[GlyphPoint], builder):
        if not points:
            return
        # Find a starting on-curve point, synthesizing one from the
        # midpoint of two off-curve points if needed (TrueType rules).
        start_index = next(
            (i for i, pt in enumerate(points) if pt.on_curve), None
        )
        if start_index is None:
            first = points[0]
            last = points[-1]
            synthetic = GlyphPoint(
                (first.x + last.x) / 2.0, (first.y + last.y) / 2.0, True
            )
            points = [synthetic] + points + [synthetic]
            start_index = 0
        else:
            points = (
                points[start_index:] + points[: start_index + 1]
            )
            start_index = 0
        builder.move_to(points[0].x, points[0].y)
        i = 1
        while i < len(points):
            pt = points[i]
            if pt.on_curve:
                builder.line_to(pt.x, pt.y)
                i += 1
            else:
                if i + 1 < len(points):
                    nxt = points[i + 1]
                else:
                    nxt = points[0]
                if nxt.on_curve:
                    builder.quad_to(pt.x, pt.y, nxt.x, nxt.y)
                    i += 2
                else:
                    mid_x = (pt.x + nxt.x) / 2.0
                    mid_y = (pt.y + nxt.y) / 2.0
                    builder.quad_to(pt.x, pt.y, mid_x, mid_y)
                    i += 1
        builder.close()

    # -- metrics tables ----------------------------------------------------

    def glyph_hor_advance(self, glyph_id: int) -> Optional[int]:
        if glyph_id is None or glyph_id >= self.num_glyphs:
            return None
        hmtx, _ = self.tables["hmtx"]
        if glyph_id < self.number_of_h_metrics:
            return _u16(self.data, hmtx + 4 * glyph_id)
        return _u16(self.data, hmtx + 4 * (self.number_of_h_metrics - 1))

    def glyph_ver_advance(self, glyph_id: int) -> Optional[int]:
        return None  # vmtx unsupported

    def _parse_kern(self):
        if "kern" not in self.tables:
            return {}
        kern, _ = self.tables["kern"]
        data = self.data
        n_subtables = _u16(data, kern + 2)
        p = kern + 4
        pairs: Dict[Tuple[int, int], int] = {}
        for _ in range(n_subtables):
            length = _u16(data, p + 2)
            coverage = _u16(data, p + 4)
            fmt = coverage >> 8
            if fmt == 0:
                n_pairs = _u16(data, p + 6)
                for k in range(n_pairs):
                    rec = p + 14 + 6 * k
                    left = _u16(data, rec)
                    right = _u16(data, rec + 2)
                    value = _i16(data, rec + 4)
                    pairs[(left, right)] = value
                break  # first horizontal subtable wins (like text.rs:148)
            p += length
        return pairs

    def glyphs_kerning(self, left: int, right: int) -> Optional[int]:
        return self._kern.get((left, right))
