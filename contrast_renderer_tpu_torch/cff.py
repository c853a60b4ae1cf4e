"""Minimal CFF (Compact Font Format) outline reader.

Completes the OpenType side of the font stack: the reference's text
feature rides `ttf_parser::Face` (src/text.rs:25, Cargo.toml:19), which
parses both TrueType `glyf` and OpenType `CFF ` outlines; `ttf.Face`
delegates to this module when a font carries a `CFF ` table instead of
`glyf`/`loca`.

Scope: CFF version 1, Type 2 charstrings, local/global subroutines,
plain and CID-keyed fonts (FDArray/FDSelect).  Out of scope: CFF2
(variable fonts — `ttf.Face` raises UnsupportedFontFormat), seac accent
composition via `endchar`'s 4-argument form (the deprecated Type 1
compatibility path; such glyphs render without their accent).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple


def _u8(data, o):
    return data[o]


def _u16(data, o):
    return struct.unpack_from(">H", data, o)[0]


def _u24(data, o):
    return (data[o] << 16) | (data[o + 1] << 8) | data[o + 2]


def _u32(data, o):
    return struct.unpack_from(">I", data, o)[0]


_OFF = {1: _u8, 2: _u16, 3: _u24, 4: _u32}


def _parse_index(data: bytes, offset: int) -> Tuple[List[bytes], int]:
    """A CFF INDEX at `offset` → (items, offset past the INDEX)."""
    count = _u16(data, offset)
    if count == 0:
        return [], offset + 2
    off_size = data[offset + 2]
    read = _OFF[off_size]
    offs = [
        read(data, offset + 3 + i * off_size) for i in range(count + 1)
    ]
    base = offset + 3 + (count + 1) * off_size - 1  # offsets are 1-based
    items = [data[base + offs[i]: base + offs[i + 1]] for i in range(count)]
    return items, base + offs[count]


def _parse_dict(data: bytes) -> Dict[int, List[float]]:
    """A CFF DICT → {operator: operands} (two-byte ops keyed 1200+b1)."""
    out: Dict[int, List[float]] = {}
    operands: List[float] = []
    i = 0
    n = len(data)
    while i < n:
        b0 = data[i]
        if 32 <= b0 <= 246:
            operands.append(b0 - 139)
            i += 1
        elif 247 <= b0 <= 250:
            operands.append((b0 - 247) * 256 + data[i + 1] + 108)
            i += 2
        elif 251 <= b0 <= 254:
            operands.append(-(b0 - 251) * 256 - data[i + 1] - 108)
            i += 2
        elif b0 == 28:
            operands.append(struct.unpack_from(">h", data, i + 1)[0])
            i += 3
        elif b0 == 29:
            operands.append(struct.unpack_from(">i", data, i + 1)[0])
            i += 5
        elif b0 == 30:  # packed BCD real
            s = ""
            i += 1
            done = False
            while not done:
                byte = data[i]
                i += 1
                for nibble in (byte >> 4, byte & 0xF):
                    if nibble <= 9:
                        s += str(nibble)
                    elif nibble == 0xA:
                        s += "."
                    elif nibble == 0xB:
                        s += "E"
                    elif nibble == 0xC:
                        s += "E-"
                    elif nibble == 0xE:
                        s += "-"
                    elif nibble == 0xF:
                        done = True
                        break
            operands.append(float(s or "0"))
        elif b0 == 12:
            out[1200 + data[i + 1]] = operands
            operands = []
            i += 2
        else:  # single-byte operator
            out[b0] = operands
            operands = []
            i += 1
    return out


def _subr_bias(count: int) -> int:
    if count < 1240:
        return 107
    if count < 33900:
        return 1131
    return 32768


class _BBoxBuilder:
    """Outline sink that records the control-point bounding box (a
    superset of the tight curve bbox — safe for SAT glyph culling,
    text.py's only consumer)."""

    def __init__(self):
        self.min_x = self.min_y = float("inf")
        self.max_x = self.max_y = float("-inf")

    def _see(self, x, y):
        self.min_x = min(self.min_x, x)
        self.min_y = min(self.min_y, y)
        self.max_x = max(self.max_x, x)
        self.max_y = max(self.max_y, y)

    def move_to(self, x, y):
        self._see(x, y)

    def line_to(self, x, y):
        self._see(x, y)

    def curve_to(self, x1, y1, x2, y2, x, y):
        self._see(x1, y1)
        self._see(x2, y2)
        self._see(x, y)

    def close(self):
        pass

    @property
    def empty(self):
        return self.min_x > self.max_x


class CFFTable:
    """A parsed `CFF ` table exposing Type 2 charstring outlines."""

    def __init__(self, data: bytes):
        self.data = data
        hdr_size = data[2]
        _, p = _parse_index(data, hdr_size)             # Name INDEX
        top_dicts, p = _parse_index(data, p)            # Top DICT INDEX
        _, p = _parse_index(data, p)                    # String INDEX
        self.gsubrs, _ = _parse_index(data, p)          # Global Subr INDEX
        top = _parse_dict(top_dicts[0])
        if top.get(1206, [2])[0] != 2:  # CharstringType
            raise ValueError("only Type 2 charstrings are supported")
        self.charstrings, _ = _parse_index(data, int(top[17][0]))
        self.is_cid = 1230 in top  # ROS
        self._fd_select = None
        self._fd_subrs: List[List[bytes]] = []
        if self.is_cid:
            fd_dicts, _ = _parse_index(data, int(top[1236][0]))
            self._fd_subrs = [
                self._private_subrs(_parse_dict(fd)) for fd in fd_dicts
            ]
            self._fd_select = self._parse_fd_select(int(top[1237][0]))
            self.lsubrs = []
        else:
            self.lsubrs = self._private_subrs(top)

    def _private_subrs(self, d: Dict[int, List[float]]) -> List[bytes]:
        if 18 not in d:
            return []
        size, offset = int(d[18][0]), int(d[18][1])
        private = _parse_dict(self.data[offset: offset + size])
        if 19 not in private:  # Subrs (offset relative to Private DICT)
            return []
        subrs, _ = _parse_index(self.data, offset + int(private[19][0]))
        return subrs

    def _parse_fd_select(self, offset: int):
        data = self.data
        fmt = data[offset]
        n = len(self.charstrings)
        if fmt == 0:
            return list(data[offset + 1: offset + 1 + n])
        if fmt == 3:
            n_ranges = _u16(data, offset + 1)
            out = [0] * n
            for r in range(n_ranges):
                first = _u16(data, offset + 3 + 3 * r)
                fd = data[offset + 5 + 3 * r]
                nxt = _u16(data, offset + 3 + 3 * (r + 1)) if (
                    r + 1 < n_ranges
                ) else _u16(data, offset + 3 + 3 * n_ranges)
                for g in range(first, min(nxt, n)):
                    out[g] = fd
            return out
        raise ValueError(f"unsupported FDSelect format {fmt}")

    @property
    def num_glyphs(self) -> int:
        return len(self.charstrings)

    def outline(self, glyph_id: int, builder) -> bool:
        """Stream glyph `glyph_id` into `builder` (move_to/line_to/
        curve_to/close).  Returns False for empty/missing glyphs."""
        if glyph_id is None or glyph_id >= len(self.charstrings):
            return False
        code = self.charstrings[glyph_id]
        if not code:
            return False
        lsubrs = (
            self._fd_subrs[self._fd_select[glyph_id]]
            if self.is_cid and self._fd_select is not None
            else self.lsubrs
        )
        interp = _Type2Interp(self.gsubrs, lsubrs, builder)
        try:
            interp.run(code)
        except (IndexError, struct.error, ZeroDivisionError):
            # Malformed/hostile charstring (operand-stack underflow,
            # truncated operand bytes, …): fail the glyph gracefully —
            # ttf-parser's permissive model — instead of crashing text
            # layout.  Callers treat False as an empty glyph.
            return False
        return interp.any_path

    def bounding_box(self, glyph_id: int):
        """(x_min, y_min, x_max, y_max) in font units, or None."""
        bbox = _BBoxBuilder()
        if not self.outline(glyph_id, bbox) or bbox.empty:
            return None
        return (
            math.floor(bbox.min_x), math.floor(bbox.min_y),
            math.ceil(bbox.max_x), math.ceil(bbox.max_y),
        )


class _Type2Interp:
    """Type 2 charstring interpreter (Adobe TN #5177)."""

    MAX_DEPTH = 10

    def __init__(self, gsubrs, lsubrs, builder):
        self.gsubrs = gsubrs
        self.lsubrs = lsubrs
        self.gbias = _subr_bias(len(gsubrs))
        self.lbias = _subr_bias(len(lsubrs))
        self.builder = builder
        self.stack: List[float] = []
        #: 32-slot transient array for put/get (12 20 / 12 21).
        self.transient: List[float] = [0.0] * 32
        self.x = 0.0
        self.y = 0.0
        self.n_stems = 0
        self.open = False
        self.any_path = False
        self.done = False

    # -- helpers --------------------------------------------------------
    #
    # The optional leading width argument (one per charstring, before
    # the first stack-clearing operator, TN #5177 §3.1) never needs
    # explicit removal here: movetos read their operands from the END
    # of the stack, stem counts use len//2 (identical with or without
    # the odd leading width), and endchar ignores its operands.

    def _moveto(self, dx, dy):
        if self.open:
            self.builder.close()
        self.x += dx
        self.y += dy
        self.builder.move_to(self.x, self.y)
        self.open = True
        self.any_path = True

    def _lineto(self, dx, dy):
        self.x += dx
        self.y += dy
        self.builder.line_to(self.x, self.y)

    def _curveto(self, dx1, dy1, dx2, dy2, dx3, dy3):
        x1 = self.x + dx1
        y1 = self.y + dy1
        x2 = x1 + dx2
        y2 = y1 + dy2
        self.x = x2 + dx3
        self.y = y2 + dy3
        self.builder.curve_to(x1, y1, x2, y2, self.x, self.y)

    def _stems(self):
        self.n_stems += len(self.stack) // 2
        self.stack.clear()

    # -- interpreter ----------------------------------------------------

    def run(self, code: bytes, depth: int = 0):
        if depth > self.MAX_DEPTH:
            raise ValueError("charstring subroutine recursion too deep")
        st = self.stack
        i = 0
        n = len(code)
        while i < n and not self.done:
            b0 = code[i]
            if b0 >= 32 or b0 == 28:
                if b0 == 28:
                    st.append(struct.unpack_from(">h", code, i + 1)[0])
                    i += 3
                elif b0 <= 246:
                    st.append(b0 - 139)
                    i += 1
                elif b0 <= 250:
                    st.append((b0 - 247) * 256 + code[i + 1] + 108)
                    i += 2
                elif b0 <= 254:
                    st.append(-(b0 - 251) * 256 - code[i + 1] - 108)
                    i += 2
                else:  # 255: 16.16 fixed
                    st.append(
                        struct.unpack_from(">i", code, i + 1)[0] / 65536.0
                    )
                    i += 5
                continue
            i += 1
            if b0 in (1, 3, 18, 23):  # h/vstem(hm)
                self._stems()
            elif b0 in (19, 20):  # hintmask / cntrmask
                self._stems()
                i += (self.n_stems + 7) // 8
            elif b0 == 21:  # rmoveto
                self._moveto(st[-2] if len(st) >= 2 else 0.0,
                             st[-1] if len(st) >= 2 else 0.0)
                st.clear()
            elif b0 == 22:  # hmoveto
                self._moveto(st[-1] if st else 0.0, 0.0)
                st.clear()
            elif b0 == 4:  # vmoveto
                self._moveto(0.0, st[-1] if st else 0.0)
                st.clear()
            elif b0 == 5:  # rlineto
                for k in range(0, len(st) - 1, 2):
                    self._lineto(st[k], st[k + 1])
                st.clear()
            elif b0 in (6, 7):  # hlineto / vlineto (alternating)
                horizontal = b0 == 6
                for v in st:
                    if horizontal:
                        self._lineto(v, 0.0)
                    else:
                        self._lineto(0.0, v)
                    horizontal = not horizontal
                st.clear()
            elif b0 == 8:  # rrcurveto
                for k in range(0, len(st) - 5, 6):
                    self._curveto(*st[k:k + 6])
                st.clear()
            elif b0 == 24:  # rcurveline
                k = 0
                while len(st) - k >= 8:
                    self._curveto(*st[k:k + 6])
                    k += 6
                if len(st) - k >= 2:
                    self._lineto(st[k], st[k + 1])
                st.clear()
            elif b0 == 25:  # rlinecurve
                k = 0
                while len(st) - k >= 8:
                    self._lineto(st[k], st[k + 1])
                    k += 2
                if len(st) - k >= 6:
                    self._curveto(*st[k:k + 6])
                st.clear()
            elif b0 == 26:  # vvcurveto
                k = 0
                dx1 = 0.0
                if len(st) % 4 == 1:
                    dx1 = st[0]
                    k = 1
                while len(st) - k >= 4:
                    self._curveto(dx1, st[k], st[k + 1], st[k + 2],
                                  0.0, st[k + 3])
                    dx1 = 0.0
                    k += 4
                st.clear()
            elif b0 == 27:  # hhcurveto
                k = 0
                dy1 = 0.0
                if len(st) % 4 == 1:
                    dy1 = st[0]
                    k = 1
                while len(st) - k >= 4:
                    self._curveto(st[k], dy1, st[k + 1], st[k + 2],
                                  st[k + 3], 0.0)
                    dy1 = 0.0
                    k += 4
                st.clear()
            elif b0 in (30, 31):  # vhcurveto / hvcurveto
                horizontal = b0 == 31
                k = 0
                while len(st) - k >= 4:
                    last = len(st) - k == 5
                    d5 = st[k + 4] if last else 0.0
                    if horizontal:
                        self._curveto(st[k], 0.0, st[k + 1], st[k + 2],
                                      d5, st[k + 3])
                    else:
                        self._curveto(0.0, st[k], st[k + 1], st[k + 2],
                                      st[k + 3], d5)
                    horizontal = not horizontal
                    k += 4
                st.clear()
            elif b0 == 10:  # callsubr
                idx = int(st.pop()) + self.lbias
                if 0 <= idx < len(self.lsubrs):
                    self.run(self.lsubrs[idx], depth + 1)
            elif b0 == 29:  # callgsubr
                idx = int(st.pop()) + self.gbias
                if 0 <= idx < len(self.gsubrs):
                    self.run(self.gsubrs[idx], depth + 1)
            elif b0 == 11:  # return
                return
            elif b0 == 14:  # endchar (seac accent form unsupported)
                if self.open:
                    self.builder.close()
                    self.open = False
                self.done = True
            elif b0 == 12:  # escape
                b1 = code[i]
                i += 1
                if 34 <= b1 <= 37:
                    self._flex(b1)
                else:
                    self._escape_op(b1)
            else:
                # Unknown/arithmetic operators: clear the stack and
                # continue (hint replacement etc. don't affect outline).
                st.clear()
        if not self.done and depth == 0 and self.open:
            self.builder.close()
            self.open = False

    def _escape_op(self, b1: int):
        """Non-flex escape (12 x) operators: Type 2 arithmetic, storage
        and conditional operators (TN #5177 §4.4-4.5).  These leave their
        results ON the stack — real-world CFF fonts converted from
        Type 1 use e.g. `div` (12 12) for fractional operand values, so
        clearing the stack here would silently drop path segments."""
        st = self.stack
        if b1 == 0:  # dotsection (deprecated no-op, takes no operands)
            return
        if b1 == 3:  # and
            b = st.pop()
            a = st.pop()
            st.append(1.0 if (a != 0.0 and b != 0.0) else 0.0)
        elif b1 == 4:  # or
            b = st.pop()
            a = st.pop()
            st.append(1.0 if (a != 0.0 or b != 0.0) else 0.0)
        elif b1 == 5:  # not
            st.append(1.0 if st.pop() == 0.0 else 0.0)
        elif b1 == 9:  # abs
            st.append(abs(st.pop()))
        elif b1 == 10:  # add
            b = st.pop()
            st.append(st.pop() + b)
        elif b1 == 11:  # sub
            b = st.pop()
            st.append(st.pop() - b)
        elif b1 == 12:  # div
            b = st.pop()
            a = st.pop()
            st.append(a / b if b != 0.0 else 0.0)
        elif b1 == 14:  # neg
            st.append(-st.pop())
        elif b1 == 15:  # eq
            b = st.pop()
            st.append(1.0 if st.pop() == b else 0.0)
        elif b1 == 18:  # drop
            st.pop()
        elif b1 == 20:  # put
            j = int(st.pop())
            v = st.pop()
            if 0 <= j < len(self.transient):
                self.transient[j] = v
        elif b1 == 21:  # get
            j = int(st.pop())
            st.append(
                self.transient[j] if 0 <= j < len(self.transient) else 0.0
            )
        elif b1 == 22:  # ifelse: s1 s2 v1 v2 → s1 if v1 <= v2 else s2
            v2 = st.pop()
            v1 = st.pop()
            s2 = st.pop()
            s1 = st.pop()
            st.append(s1 if v1 <= v2 else s2)
        elif b1 == 23:  # random: spec says (0, 1]; deterministic here
            st.append(0.5)
        elif b1 == 24:  # mul
            b = st.pop()
            st.append(st.pop() * b)
        elif b1 == 26:  # sqrt
            st.append(math.sqrt(abs(st.pop())))
        elif b1 == 27:  # dup
            st.append(st[-1])
        elif b1 == 28:  # exch
            st[-1], st[-2] = st[-2], st[-1]
        elif b1 == 29:  # index
            k = int(st.pop())
            st.append(st[-1] if k < 0 else st[-1 - k])
        elif b1 == 30:  # roll: rotate the top n elements by j
            j = int(st.pop())
            nn = int(st.pop())
            if nn > 0:
                j %= nn
                if j:
                    st[-nn:] = st[-j:] + st[-nn:-j]
        else:
            # Unknown escape operator: per spec this is an error; be
            # permissive like ttf-parser and drop the operands.
            st.clear()

    def _flex(self, b1: int):
        """The four flex operators (12 34-37): two curves whose joint
        rides near a line — emitted as plain cubics (resolution-
        independent fills don't need the flex-height hinting)."""
        st = self.stack
        if b1 == 35:  # flex: 13 args
            self._curveto(*st[0:6])
            self._curveto(*st[6:12])
        elif b1 == 34:  # hflex: 7 args
            self._curveto(st[0], 0.0, st[1], st[2], st[3], 0.0)
            self._curveto(st[4], 0.0, st[5], -st[2], st[6], 0.0)
        elif b1 == 36:  # hflex1: 9 args
            dy_total = st[1] + st[3] + st[7]
            self._curveto(st[0], st[1], st[2], st[3], st[4], 0.0)
            self._curveto(st[5], 0.0, st[6], st[7], st[8], -dy_total)
        elif b1 == 37:  # flex1: 11 args
            dx = sum(st[k] for k in (0, 2, 4, 6, 8))
            dy = sum(st[k] for k in (1, 3, 5, 7, 9))
            start_x = self.x
            start_y = self.y
            self._curveto(*st[0:6])
            # Final point: the dominant axis takes the last argument,
            # the other returns to the pre-flex coordinate.
            if abs(dx) > abs(dy):
                d6x = st[10]
                d6y = start_y - (self.y + st[7] + st[9])
            else:
                d6x = start_x - (self.x + st[6] + st[8])
                d6y = st[10]
            self._curveto(st[6], st[7], st[8], st[9], d6x, d6y)
        st.clear()
