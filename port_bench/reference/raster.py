"""The benchmark's plain reference renderer: stencil-then-cover vector
graphics with MSAA, in plain PyTorch.

It renders a list of draw commands (``scene.RefCommand``: a STENCIL or a
COLOR of a ``scene.RefShape`` under a row-major 4x4 model-to-clip
matrix) into packed RGBA8, with the semantics the port implements and
none of its machinery (no tiles, binning, culling or graphs):

- geometry: each triangle's model points (x, y, 0, 1) through the
  matrix, clipped against w > ``NEAR_W`` (Sutherland-Hodgman, the
  attributes interpolated linearly in clip space, the new vertices'
  w set to ``NEAR_W``), divided by w, and mapped to pixels
  (px = (ndc_x + 1) W / 2, py = (1 - ndc_y) H / 2, y down);
- coverage at each MSAA sample: the three edge tests with the top-left
  rule; perspective-correct attributes (the vertices' attributes over
  w, interpolated in screen space, divided by the interpolated 1 / w);
- a STENCIL's stroke triangles first, an OR (the Equal + IncrementWrap
  state: only a sample at winding 0 goes to 1), under the cap, join and
  dash predicates of the upstream shaders; then its fill triangles add
  minus the pixel-space orientation where the Loop-Blinn test holds
  (x^2 - yz <= 0 quadratic, x^3 - yzw <= 0 cubic);
- a COLOR paints every sample whose winding is nonzero modulo
  2^winding_bits with the premultiplied colour, blended back to front
  (out = src + dst (1 - src_alpha)), and zeroes that winding.  The port
  limits a cover to the shape's convex hull, a superset of every sample
  its stencil can reach, so the whole frame is the same region;
- the resolve: the mean of a pixel's samples, clamped to [0, 1],
  floor(255 v + 1/2).

Every float of the geometry and of the colours is computed in
``dtype``: float64 for the reference, and a lower precision for the
benchmark's control.  Samples are visited per triangle over the 16 x 16
pixel tiles of its bounding box that no edge rules out (a conservative
test in float64, which only saves work), in blocks, so that a frame
fits in memory whatever its size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry.path import Cap, Join, MAX_DASH_INTERVALS
from .geometry.stroke import JOINT_TIP_FLAG
from .geometry.vertex import (
    END_CAP_FLAG,
    KIND_INTEGRAL_CUBIC,
    KIND_RATIONAL_CUBIC,
    KIND_SOLID,
    KIND_STROKE_LINE,
)

#: The standard MSAA sample positions (x, y) within a pixel, y down.
SAMPLE_OFFSETS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: ((0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625)),
    16: ((0.5625, 0.5625), (0.4375, 0.3125), (0.3125, 0.625),
         (0.75, 0.4375), (0.1875, 0.375), (0.625, 0.8125),
         (0.8125, 0.6875), (0.6875, 0.1875), (0.375, 0.875),
         (0.5, 0.0625), (0.25, 0.125), (0.125, 0.75),
         (0.03125, 0.5), (0.9375, 0.25), (0.875, 0.9375),
         (0.0625, 0.03125)),
}

#: The near plane: clip-space w must exceed this.
NEAR_W = 1e-6
#: Pixel tiles of the conservative test, and (triangle, tile) pairs per
#: block of sample tests.
TILE = 16
BLOCK_PAIRS = 8192
TAU = 2.0 * math.pi


def project_rows(xy, aux, kind, meta, transform, width, height, dtype):
    """Clip and project one draw's triangles.  xy (T, 3, 2), aux (T, 3,
    4), kind (T,), meta (T, 2) tensors of the shape, ``transform`` a
    (4, 4) tensor; returns (pixel vertices (N, 3, 2), 1 / w (N, 3), aux
    (N, 3, 4), kind (N,), meta (N, 2)) of the triangles in front of the
    near plane, those that cross it replaced by their clipped pieces,
    all floats in ``dtype``."""
    m = transform.to(dtype)
    x = xy[..., 0].to(dtype)
    y = xy[..., 1].to(dtype)
    clip = torch.stack(
        [x * m[r, 0] + y * m[r, 1] + m[r, 3] for r in range(4)], -1
    )                                                   # (T, 3, 4)
    attr = torch.cat([clip, aux.to(dtype)], -1)         # (T, 3, 8)
    inside = clip[..., 3] > NEAR_W
    n_in = inside.sum(-1)
    whole = n_in == 3
    cross = (n_in > 0) & ~whole
    parts = [(attr[whole], kind[whole], meta[whole])]
    if bool(cross.any()):
        a = attr[cross]
        a_in = inside[cross]
        nxt = a[:, [1, 2, 0]]
        b_in = a_in[:, [1, 2, 0]]
        wa, wb = a[..., 3], nxt[..., 3]
        denom = torch.where(wb != wa, wb - wa, torch.ones_like(wa))
        t = (NEAR_W - wa) / denom
        inter = a + t[..., None] * (nxt - a)
        inter[..., 3] = NEAR_W
        cand = torch.stack([a, inter], 2).reshape(-1, 6, 8)
        ok = torch.stack([a_in, a_in != b_in], 2).reshape(-1, 6)
        order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :4]
        poly = torch.gather(cand, 1, order[..., None].expand(-1, -1, 8))
        count = ok.sum(1)
        k, mt = kind[cross], meta[cross]
        parts.append((poly[:, [0, 1, 2]], k, mt))
        quad = count == 4
        parts.append((poly[quad][:, [0, 2, 3]], k[quad], mt[quad]))
    attr = torch.cat([p[0] for p in parts])
    kind = torch.cat([p[1] for p in parts])
    meta = torch.cat([p[2] for p in parts])
    w = attr[..., 3]
    inv_w = 1.0 / w
    px = (attr[..., 0] * inv_w + 1.0) * (0.5 * width)
    py = (1.0 - attr[..., 1] * inv_w) * (0.5 * height)
    return torch.stack([px, py], -1), inv_w, attr[..., 4:], kind, meta


def _tile_pairs(verts, width, height):
    """(row, tile x, tile y) of every 16 x 16 pixel tile that a sample of
    triangle ``row`` may cover: the tiles of its bounding box on screen
    that none of its edges rules out.  Computed in float64."""
    v = verts.double()
    dev = v.device
    finite = torch.isfinite(v).all(-1).all(-1)
    v = torch.where(finite[:, None, None], v, torch.zeros_like(v))
    lo = torch.floor(v.amin(1)) - 1.0
    hi = torch.floor(v.amax(1))
    x0 = lo[:, 0].clamp(0, width - 1).long()
    y0 = lo[:, 1].clamp(0, height - 1).long()
    x1 = hi[:, 0].clamp(0, width - 1).long()
    y1 = hi[:, 1].clamp(0, height - 1).long()
    empty = (hi[:, 0] < 0) | (hi[:, 1] < 0) | (lo[:, 0] > width - 1) | (
        lo[:, 1] > height - 1) | ~finite
    tx0, ty0 = x0 // TILE, y0 // TILE
    ntx = x1 // TILE - tx0 + 1
    nty = y1 // TILE - ty0 + 1
    count = torch.where(empty, 0, ntx * nty)
    row = torch.repeat_interleave(torch.arange(len(v), device=dev), count)
    if row.numel() == 0:
        return row, row, row
    start = torch.cumsum(count, 0) - count
    k = torch.arange(row.numel(), device=dev) - start[row]
    tx = tx0[row] + k % ntx[row]
    ty = ty0[row] + k // ntx[row]
    # The tile's sample footprint [x0, x1 + 1] x [y0, y1 + 1] against each
    # edge, at the corner that maximises the edge function.
    area = _cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    sign = torch.sign(area)[row]
    keep = torch.ones_like(row, dtype=torch.bool)
    fx0 = (tx * TILE).double()
    fy0 = (ty * TILE).double()
    for i, j in ((0, 1), (1, 2), (2, 0)):
        a, b = v[row, i], v[row, j]
        ex = -(b[:, 1] - a[:, 1]) * sign
        ey = (b[:, 0] - a[:, 0]) * sign
        cx = torch.where(ex > 0, fx0 + TILE, fx0)
        cy = torch.where(ey > 0, fy0 + TILE, fy0)
        e = ex * (cx - a[:, 0]) + ey * (cy - a[:, 1])
        margin = 1e-9 * (ex.abs() * (cx - a[:, 0]).abs()
                         + ey.abs() * (cy - a[:, 1]).abs()) + 1e-300
        keep &= e >= -margin
    return row[keep], tx[keep], ty[keep]


def _cross(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _top_left(a, b, orient):
    """The top-left rule of edge a -> b, taken in pixel-space
    counterclockwise order (y down)."""
    pos = orient[:, None] > 0
    aa = torch.where(pos, a, b)
    bb = torch.where(pos, b, a)
    return ((aa[:, 1] == bb[:, 1]) & (bb[:, 0] > aa[:, 0])) | (bb[:, 1] > aa[:, 1])


def _cap(cap, x, y):
    """The cap predicates of the upstream shaders (the port's Square cap:
    the documented half-width rectangle, y <= 1/2)."""
    ax = torch.abs(x)
    out = (cap == int(Cap.BUTT)) & (y < 0.0)
    cases = {
        Cap.SQUARE: y <= 0.5,
        Cap.ROUND: x * x + y * y < 0.25,
        Cap.OUT: 0.5 - y > ax,
        Cap.IN: y < ax,
        Cap.RIGHT: 0.5 - y > x,
        Cap.LEFT: y - 0.5 < x,
    }
    for value, case in cases.items():
        out = out | ((cap == int(value)) & case)
    return out


def _dash(d, group, x, y):
    """Dashed coverage at pattern position y, side x, for the stroke
    descriptors ``d`` (dict of tensors, one row per group)."""
    last = d["last_interval"][group]
    pattern = torch.gather(d["gap_end"][group], 1, last[:, None])[:, 0]
    pos = torch.remainder(y - d["phase"][group], pattern)
    interval = last.clone()
    for i in range(MAX_DASH_INTERVALS - 1, -1, -1):
        hit = (d["gap_end"][group, i] - pos >= 0.0) & (i <= last)
        interval = torch.where(hit, i, interval)
    sel = interval[:, None]
    g_start = torch.gather(d["gap_start"][group], 1, sel)[:, 0]
    g_end = torch.gather(d["gap_end"][group], 1, sel)[:, 0]
    e_cap = torch.gather(d["end_caps"][group], 1, sel)[:, 0]
    s_cap = torch.gather(d["start_caps"][group], 1, sel)[:, 0]
    past = pos - g_start
    return (past <= 0.0) | _cap(e_cap, x, past) | _cap(s_cap, x, g_end - pos)


def _stroke_keep(kind, flags, end_y, tex, d):
    """Whether each sample's texcoords lie on the stroke (line body and
    caps, joints, dashes)."""
    group = (flags & 0xFFFF).long()
    dashed = d["dashed"][group]
    line = kind == KIND_STROKE_LINE
    x, y, z = tex[:, 0], tex[:, 1], tex[:, 2]
    # Lines.
    end = (flags & END_CAP_FLAG) != 0
    solid = torch.where(
        end, _cap(d["solid_end_cap"][group], x, y - end_y),
        (y >= 0.0) | _cap(d["solid_start_cap"][group], x, -y),
    )
    keep_line = torch.where(dashed, _dash(d, group, x, y), solid)
    # Joints.
    radius = torch.sqrt(x * x + y * y)
    join = d["join"][group]
    tip = (flags & JOINT_TIP_FLAG) != 0
    fill = torch.where(
        join == int(Join.ROUND), radius <= 0.5,
        torch.where(join == int(Join.BEVEL), ~tip, torch.ones_like(tip)),
    )
    angle = torch.atan2(y, x) / TAU
    keep_joint = fill & (~dashed | _dash(d, group, radius, z + angle))
    return torch.where(line, keep_line, keep_joint)


def stencil(state, rows, descriptors, work=None):
    """Apply one STENCIL draw's projected ``rows`` (project_rows) to
    ``state``: the stroke OR, then the fills' winding.  ``descriptors``
    holds the shape's stroke descriptors, one row per group (see
    ``scene.descriptor_tensors``).  ``work``, where given, receives each
    row's samples inside it (``"row_samples"``) and pixels with a sample
    inside it (``"row_pixels"``), float64 tensors over the rows."""
    verts, inv_w, aux, kind, meta = rows
    if len(kind) == 0:
        return
    W, H, S = state.width, state.height, state.samples
    dev, dtype = state.winding.device, verts.dtype
    offsets = torch.tensor(SAMPLE_OFFSETS[S], dtype=dtype, device=dev)
    stroke = kind >= KIND_STROKE_LINE
    covered = torch.zeros(H * W * S, dtype=torch.bool, device=dev)
    delta = torch.zeros(H * W * S, dtype=torch.int32, device=dev)
    area = _cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    good = torch.isfinite(area) & (area != 0.0)
    orient = torch.sign(area)
    inv_area = 1.0 / torch.where(good, area.abs(), torch.ones_like(area))
    tl = [_top_left(verts[:, i], verts[:, j], orient)
          for i, j in ((0, 1), (1, 2), (2, 0))]
    aux_w = aux * inv_w[..., None]
    flags = meta[:, 0].to(torch.int64)
    end_y = meta[:, 1]
    row_all, tx_all, ty_all = _tile_pairs(verts, W, H)
    keep_rows = good[row_all]
    row_all, tx_all, ty_all = row_all[keep_rows], tx_all[keep_rows], ty_all[keep_rows]
    if work is not None:
        work["row_samples"] = torch.zeros(len(kind), dtype=torch.float64, device=dev)
        work["row_pixels"] = torch.zeros(len(kind), dtype=torch.float64, device=dev)
    local = torch.arange(TILE * TILE, device=dev)
    lx, ly = local % TILE, local // TILE
    for b0 in range(0, row_all.numel(), BLOCK_PAIRS):
        row = row_all[b0:b0 + BLOCK_PAIRS]
        px = (tx_all[b0:b0 + BLOCK_PAIRS] * TILE)[:, None] + lx
        py = (ty_all[b0:b0 + BLOCK_PAIRS] * TILE)[:, None] + ly
        on = (px < W) & (py < H)
        row = row[:, None].expand_as(px)[on]
        px, py = px[on], py[on]
        v = verts[row]
        any_inside = torch.zeros_like(row, dtype=torch.bool)
        for s in range(S):
            sx = px.to(dtype) + offsets[s, 0]
            sy = py.to(dtype) + offsets[s, 1]
            e = []
            inside = torch.ones_like(row, dtype=torch.bool)
            for k, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
                a, bv = v[:, i], v[:, j]
                ek = ((bv[:, 0] - a[:, 0]) * (sy - a[:, 1])
                      - (bv[:, 1] - a[:, 1]) * (sx - a[:, 0])) * orient[row]
                inside &= (ek > 0.0) | ((ek == 0.0) & tl[k][row])
                e.append(ek)
            if work is not None:
                any_inside |= inside
                work["row_samples"].index_add_(
                    0, row[inside], torch.ones_like(row[inside], dtype=torch.float64))
            if not bool(inside.any()):
                continue
            r = row[inside]
            lam = torch.stack([e[1][inside], e[2][inside], e[0][inside]], -1)
            lam = lam * inv_area[r][:, None]
            a_int = (lam[..., None] * aux_w[r]).sum(1)          # (n, 4)
            iw = (lam * inv_w[r]).sum(1)
            k_r = kind[r]
            idx = (py[inside] * W + px[inside]) * S + s
            st = stroke[r]
            if bool(st.any()):
                tex = a_int[st] / iw[st][:, None]
                keep = _stroke_keep(k_r[st], flags[r][st], end_y[r][st], tex,
                                    descriptors)
                covered[idx[st][keep]] = True
            fl = ~st
            if bool(fl.any()):
                ax_, ay_, az_, aw_ = a_int[fl].unbind(-1)
                kf = k_r[fl]
                cubic = (kf == KIND_INTEGRAL_CUBIC) | (kf == KIND_RATIONAL_CUBIC)
                test = torch.where(
                    kf == KIND_SOLID, torch.ones_like(kf, dtype=torch.bool),
                    torch.where(cubic, ax_ * ax_ * ax_ - ay_ * az_ * aw_ <= 0.0,
                                ax_ * ax_ - ay_ * az_ <= 0.0),
                )
                contrib = (-orient[r][fl]).to(torch.int32)
                delta.index_add_(0, idx[fl][test], contrib[test])
        if work is not None:
            work["row_pixels"].index_add_(
                0, row[any_inside], torch.ones_like(row[any_inside], dtype=torch.float64))
    w = state.winding
    w.copy_(torch.where(covered & (w == 0), 1, w) + delta)


def cover(state, color, dtype, work=None):
    """Apply one COLOR draw: back-to-front blend of the straight RGBA
    ``color`` wherever the winding is nonzero, which it then zeroes;
    ``work``, where given, counts the samples blended (``"blended"``)."""
    mask = (state.winding & state.winding_mask) != 0
    if work is not None:
        work["blended"] = work.get("blended", 0) + int(mask.sum())
    c = torch.as_tensor(np.asarray(color, np.float64), dtype=dtype,
                        device=state.color.device)
    src = torch.cat([c[:3] * c[3], c[3:]])
    blended = src + state.color * (1.0 - c[3])
    state.color.copy_(torch.where(mask[:, None], blended, state.color))
    state.winding.masked_fill_(mask, 0)


class FrameState:
    """Per-sample winding and colour of one frame being rendered."""

    def __init__(self, width, height, samples, winding_bits, dtype, device):
        self.width, self.height, self.samples = width, height, samples
        self.winding_mask = (1 << winding_bits) - 1
        n = width * height * samples
        self.winding = torch.zeros(n, dtype=torch.int32, device=device)
        self.color = torch.zeros((n, 4), dtype=dtype, device=device)

    def resolve(self):
        """Packed RGBA8 (H, W, 4) uint8: the sample mean, rounded."""
        c = self.color.reshape(self.height, self.width, self.samples, 4)
        mean = c.sum(2) / self.samples
        return torch.floor(mean.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
