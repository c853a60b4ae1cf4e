"""The raster kernel's roofline: the least time an H100 could take for a
frame's raster work, counted from the frame's inputs by the reference's
own geometry and coverage, never from the port's binning or counters.

Operations, the work these inputs need: for each stencil triangle (after
the reference's near-plane clipping) its class's operations per pixel
over the pixels with a sample inside it, and per sample over the samples
inside it; the blend of every sample a cover paints; the resolve of
every pixel.  Bytes: every triangle row whose box meets the screen and
every cover draw's hull read once, the packed frame written once.  The
bound is the larger of operations over the float32 peak and bytes over
the memory peak.

The per-class tables are a frozen copy of the repository's
``chip_smoke.py`` tables (``ENTRY_PIXEL_OPS``, ``ENTRY_SAMPLE_OPS``,
``CAP_OPS``, ``blend_ops``): the float operations the kernel's arithmetic
needs per pixel or sample, with terms that depend on the entry alone,
integer logic and sample positions left out.  Samples in a triangle's
bounding box but outside it, and hull-line tests, are work a kernel may
skip, so they are not counted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import raster
from ..reference.geometry.dynamic_stroke import StrokeDescriptorTable
from ..reference.geometry.vertex import (
    END_CAP_FLAG,
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
)
from ..reference import scene as ref_scene

#: NVIDIA's published H100 SXM peaks (data sheet, dense, at 700 W): HBM
#: bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# Per pixel of a triangle, by class (line solid, single dash, general
# dash; joint the same three; fill solid, quadratic, cubic): the three
# edge functions (12); with interpolated channels the barycentrics (3)
# and each channel's three-term sum (5); strokes also 1/w (5).
ENTRY_PIXEL_OPS = (30, 30, 30, 35, 35, 35, 12, 30, 35)
# Per sample: the edge tests (6); strokes 1/w's add, guard and divide
# (3) and each texcoord's add and multiply (2 each); joints the radius
# and join compare (5) and, dashed, the atan2 polynomial and its scaling
# (32); the dash remainder (5), past and its tests (3); the general dash
# its interval search (8) and one cap predicate a side (2); quadratic
# fills three adds and x*x - y*z <= 0 (7), cubic four and x*x*x - y*z*w
# <= 0 (10).
ENTRY_SAMPLE_OPS = (
    6 + 3 + 4,
    6 + 3 + 4 + 5 + 3,
    6 + 3 + 4 + 5 + 3 + 8 + 2,
    6 + 3 + 6 + 5,
    6 + 3 + 6 + 5 + 32 + 5 + 3,
    6 + 3 + 6 + 5 + 32 + 5 + 3 + 8 + 2,
    6, 6 + 7, 6 + 10,
)
#: A cap predicate by cap code (square, round, out, in, right, left, butt).
CAP_OPS = (1, 4, 3, 2, 2, 2, 1)
#: A solid line's end cap (its offset and predicate) or start cap.
END_CAP_OPS, START_CAP_OPS = 1, 2
#: One blended sample, by blend state: back to front is a multiply and
#: an add on each of four channels.
BLEND_OPS = {"back_to_front": 8}
#: Per pixel and channel of the resolve: S adds and a multiply, and for
#: packed RGBA8 the clamp, scale, round and floor.
RESOLVE_OPS_PACKED = 1 + 5
#: Bytes of one triangle row (32 float and 8 integer words) and of one
#: cover draw's hull (16 lines of three floats).
ROW_BYTES = 160
HULL_BYTES = 16 * 3 * 4


def _classes(kind, flags, table):
    """Each row's class index and its cap operations per sample."""
    group = (flags & 0xFFFF).long().clamp(0, len(table.dashed) - 1)
    dashed = torch.as_tensor(np.asarray(table.dashed, bool), device=kind.device)[group]
    last = torch.as_tensor(np.asarray(table.last_interval), device=kind.device)[group]
    mode = torch.where(dashed, torch.where(last == 0, 1, 2), 0)
    cls = torch.where(
        kind == KIND_STROKE_LINE, mode,
        torch.where(kind == KIND_STROKE_JOINT, 3 + mode,
                    torch.where(kind == KIND_SOLID, 6,
                                torch.where((kind == KIND_INTEGRAL_QUADRATIC)
                                            | (kind == KIND_RATIONAL_QUADRATIC), 7, 8))))
    cap = torch.tensor(CAP_OPS, dtype=torch.float64, device=kind.device)

    def caps(a):
        return cap[torch.as_tensor(np.asarray(a), device=kind.device)[group].long()]

    end = (flags & END_CAP_FLAG) != 0
    solid = torch.where(end, END_CAP_OPS + caps(table.solid_end_cap),
                        START_CAP_OPS + caps(table.solid_start_cap))
    single = caps(table.end_caps[:, 0]) + caps(table.start_caps[:, 0])
    extra = torch.where(cls == 0, solid, torch.where((cls == 1) | (cls == 4), single, 0.0))
    return cls, extra


def frame_work(commands, width, height, samples, winding_bits, blending, device):
    """(float operations, bytes) of one frame's raster work: the
    reference renders the frame and counts."""
    pixel_ops = torch.tensor(ENTRY_PIXEL_OPS, dtype=torch.float64, device=device)
    sample_ops = torch.tensor(ENTRY_SAMPLE_OPS, dtype=torch.float64, device=device)
    total = {"ops": 0.0, "rows": 0}

    def on_stencil(c, rows, counts):
        verts, _, _, kind, meta = rows
        lo, hi = verts.amin(1), verts.amax(1)
        area = raster._cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
        total["rows"] += int((torch.isfinite(area) & (area != 0.0) & (lo[:, 0] <= width)
                              & (hi[:, 0] >= 0) & (lo[:, 1] <= height)
                              & (hi[:, 1] >= 0)).sum())
        if not counts:
            return
        table = StrokeDescriptorTable.from_options(c.shape.dynamic_stroke_options)
        cls, extra = _classes(kind, meta[:, 0].long(), table)
        total["ops"] += float((counts["row_pixels"] * pixel_ops[cls]
                               + counts["row_samples"] * (sample_ops[cls] + extra)).sum())

    work = {}
    ref_scene.render(commands, width, height, samples, winding_bits, torch.float64,
                     device, on_stencil=on_stencil, work=work)
    ops = total["ops"] + work.get("blended", 0) * BLEND_OPS[blending]
    ops += width * height * 4 * (samples + RESOLVE_OPS_PACKED)
    covers = sum(1 for c in commands if c.operation != ref_scene.RenderOperation.STENCIL)
    nbytes = width * height * 4 + ROW_BYTES * total["rows"] + HULL_BYTES * covers
    return ops, float(nbytes)


def bound_seconds(ops, nbytes):
    """(least seconds, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = ops / PEAK_F32_OPS_S, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
