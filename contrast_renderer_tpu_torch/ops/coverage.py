"""Tile-binned stencil-and-cover coverage in PyTorch, with the raster
kernel written by hand in CUDA for Hopper.

The counterpart of ``contrast_renderer_tpu/ops/coverage.py``; the names
match so that a reader finds each piece in both packages.

1. ``make_prepare`` (torch tensor code): transforms every stencil
   draw's triangles in full f32, clips them at the near plane, sets up
   the edge and interpolation rows, and bins them to pixel tiles as
   per-(tile, command, class) entry ranges; cover hulls get a per-tile
   class (skip / boundary / full) and a bitmask of the hull lines that
   cross the tile.  The same arithmetic as the reference, op by op, so
   the binning outputs agree with it.  The cover hulls' stage
   (``cover_bins``) is one launch of a CUDA kernel
   (``csrc/cover_bins.cu``) on CUDA tensors and ``cover_bins_plain``,
   its torch version, on CPU tensors.
2. ``make_rasterize``: packs the arguments of ``coverage_raster``,
   which returns the frame.  It launches the CUDA kernel
   (``csrc/coverage_raster.cu``), which writes each pixel at its place
   in the frame, on CUDA tensors, and runs ``rasterize_plain``, its
   plain torch version, whose tiles ``detile`` turns into the frame, on
   CPU tensors.

Every body of the reference kernel is ported: the fill stencil, the
stroke stencil (lines and joints; solid, single-interval and general
dashes; caps and joins), clip and unclip, the alpha-group ops, the depth
test and write, and the colour cover with solid, gradient and user
paints.  Binning also ports the reference's clip and alpha bracket
gating (``FrameSpec.gate_spans``): it drops a balanced bracket's
machinery from the tiles no content touches, which changes no pixel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..path import MAX_DASH_INTERVALS, TAU, Cap, Join
from ..vertex import (
    KIND_INTEGRAL_QUADRATIC,
    KIND_RATIONAL_CUBIC,
    KIND_RATIONAL_QUADRATIC,
    KIND_SOLID,
    KIND_STROKE_JOINT,
    KIND_STROKE_LINE,
)
from ..utils.profiling import END, RECORD

OP_STENCIL = 0
OP_CLIP = 1
OP_UNCLIP = 2
OP_COLOR = 3
OP_SAVE_ALPHA = 4
OP_SCALE_ALPHA = 5
OP_RESTORE_ALPHA = 6
#: Fused SAVE then SCALE over the same hull (renderer._optimize_commands).
OP_SAVE_SCALE = 7

#: Gradient stop budget (cmd_f row: MAX_STOPS RGBA colors + MAX_STOPS
#: offsets).
MAX_STOPS = 4

#: Standard MSAA sample positions (x, y) within a pixel, y-down.
SAMPLE_PATTERNS = {
    1: np.array([[0.5, 0.5]], np.float32),
    2: np.array([[0.75, 0.75], [0.25, 0.25]], np.float32),
    4: np.array(
        [[0.375, 0.125], [0.875, 0.375], [0.125, 0.625], [0.625, 0.875]],
        np.float32,
    ),
    8: np.array(
        [
            [0.5625, 0.3125], [0.4375, 0.6875], [0.8125, 0.5625],
            [0.3125, 0.1875], [0.1875, 0.8125], [0.0625, 0.4375],
            [0.6875, 0.9375], [0.9375, 0.0625],
        ],
        np.float32,
    ),
    16: np.array(
        [
            [0.5625, 0.5625], [0.4375, 0.3125], [0.3125, 0.625],
            [0.75, 0.4375], [0.1875, 0.375], [0.625, 0.8125],
            [0.8125, 0.6875], [0.6875, 0.1875], [0.375, 0.875],
            [0.5, 0.0625], [0.25, 0.125], [0.125, 0.75],
            [0.03125, 0.5], [0.9375, 0.25], [0.875, 0.9375],
            [0.0625, 0.03125],
        ],
        np.float32,
    ),
}

# Float row layout (one packed row per screen-space triangle).
RF_EDGE = 0        # 0..8: (a, b, c) × 3 oriented edges (inside ⇒ e ≥ 0)
RF_INV_AREA = 9    # 1/|pixel area| (λ_k = ẽ_k · invA)
RF_AW = 10         # 10..21: aux·(1/w), vertex paired with edge k
RF_IW = 22         # 22..24: 1/w, vertex paired with edge k
RF_END_Y = 25      # end-cap provoking texcoord.y
RF_AABB = 26       # 26..29: pixel-space min_x, min_y, max_x, max_y
D_F = 32

# Int row layout.
RI_KIND = 0
RI_CONTRIB = 1
RI_GROUP = 2
RI_FLAGS = 3       # bits 0..2 top-left edge rule, 3 end-cap, 4 joint tip
RI_FILL = 4        # 1 for fill kinds, 0 for strokes
RI_CMD = 5         # originating command index
RI_CLASS = 6       # processing class (CLS_*)
D_I = 8

#: Entries are range-sorted per (tile, command, class); stroke classes
#: sort before fill classes (the reference's draw order).
CLS_LINE_SOLID = 0
CLS_LINE_DASH1 = 1
CLS_LINE_DASHN = 2
CLS_JOINT_SOLID = 3
CLS_JOINT_DASH1 = 4
CLS_JOINT_DASHN = 5
CLS_FILL_SOLID = 6
CLS_FILL_QUAD = 7
CLS_FILL_CUBIC = 8
N_CLASSES = 9
#: (class, joint, dash mode) of the stroke classes in the kernel's walk
#: order: lines then joints, each solid, single-interval dash, general
#: dash (dash mode 0, 1, 2).
STROKE_CLASSES = (
    (CLS_LINE_SOLID, False, 0),
    (CLS_LINE_DASH1, False, 1),
    (CLS_LINE_DASHN, False, 2),
    (CLS_JOINT_SOLID, True, 0),
    (CLS_JOINT_DASH1, True, 1),
    (CLS_JOINT_DASHN, True, 2),
)
FILL_CLASSES = (CLS_FILL_SOLID, CLS_FILL_QUAD, CLS_FILL_CUBIC)
#: Default fill batch width.  The CUDA kernel walks entries one at a
#: time; the batch only sets the entry-row padding (FrameSpec.entry_pad)
#: so the binning outputs keep the reference's shapes.
NB = 2

FLAG_END_CAP = 8
FLAG_JOINT_TIP = 16

# Descriptor row layout (global dynamic-stroke table).
DESC_F = 12
DESC_I = 16


@dataclass(frozen=True)
class FrameSpec:
    """Static signature of a frame: the reference's FrameSpec without
    the TPU memory-space knobs (``stream_draws``, ``interpret``)."""

    width: int
    height: int
    ops: tuple            # per-command RenderOperation ints
    #: Per-command shape index, or a per-instance tuple of indices.
    cmd_shape: tuple
    n_shapes: int
    t_max: int            # padded triangle count per shape
    h_max: int            # padded hull vertex count per shape
    samples: int
    winding_bits: int
    n_layers: int
    #: Named mode or a canonical ((src, op, dst), (src, op, dst)) tuple.
    blending: object
    cmd_inst: tuple = ()
    paints: tuple = ()
    depth_compare: str = "always"
    depth_write: bool = False
    #: Resolve to packed RGBA8 (one int32 per pixel) in the kernel.
    out_uint8: bool = False
    tile_h: int = 32
    tile_w: int = 128
    #: Vertical strips per tile: the physical (tile_h, tile_w) block
    #: covers a (tile_h·strips, tile_w/strips) screen rectangle.
    tile_strips: int = 1
    capacity: int = 256             # per-tile local entry rows
    global_capacity: int = 2048     # big-triangle rows
    tile_global_capacity: int = 128  # per-tile big-triangle entries
    clip_pool: int = 64             # near-plane-crossing triangle slots
    slots_x: int = 2
    slots_y: int = 2
    fill_batch: int = NB
    stroke_batch: int = 1
    #: Clip/alpha bracket gating (renderer._gate_spans): tuples of
    #: (content units, machinery units, transform row pairs); binning
    #: drops the machinery units from the tiles that no content unit
    #: touches, for each span whose row pairs hold equal transforms.
    gate_spans: tuple = ()
    #: Whether any stencil draw carries stroke rows.
    has_strokes: bool = True

    def __post_init__(self):
        if self.tile_w % self.tile_strips:
            raise ValueError(
                f"tile_strips={self.tile_strips} must divide "
                f"tile_w={self.tile_w}"
            )
        object.__setattr__(self, "_hash", None)

    def __hash__(self):
        h = self._hash
        if h is None:
            h = hash(tuple(
                getattr(self, f.name) for f in dataclasses.fields(self)
            ))
            object.__setattr__(self, "_hash", h)
        return h

    @property
    def entry_pad(self):
        """Row padding past the capacity (the reference's batched
        reads stay in bounds)."""
        return max(self.fill_batch, self.stroke_batch)

    @property
    def n_commands(self):
        return len(self.ops)

    @property
    def screen_tile_w(self):
        return self.tile_w // self.tile_strips

    @property
    def screen_tile_h(self):
        return self.tile_h * self.tile_strips

    @property
    def ntx(self):
        return -(-self.width // self.screen_tile_w)

    @property
    def nty(self):
        return -(-self.height // self.screen_tile_h)

    @property
    def n_tiles(self):
        return self.ntx * self.nty


#: wgpu::CompareFunction names in the order of their kernel codes.
DEPTH_COMPARE_CODES = {
    name: code for code, name in enumerate((
        "never", "less", "equal", "less_equal", "greater", "not_equal",
        "greater_equal", "always",
    ))
}


def has_depth(spec: FrameSpec) -> bool:
    """Whether the frame tests or writes depth (the reference's static
    ``has_depth``): the colour cover then keeps S depth values per
    pixel, cleared to 1.0 per tile."""
    return spec.depth_write or spec.depth_compare != "always"


def user_paints(spec: FrameSpec):
    """The frame's user paints with distinct ``fn``, in first-appearance
    order: paint code 3 + i selects entry i (the reference's
    ``user_fns``; renderer._pack_commands_runtime assigns the codes)."""
    out, seen = [], set()
    for p in spec.paints:
        fn = getattr(p, "fn", None)
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            out.append(p)
    return out


def paint_mode(spec: FrameSpec) -> int:
    """The paint bodies a frame compiles in: 0 solid colour only, 1 with
    gradients, 2 with gradients and user paints."""
    if not any(spec.paints):
        return 0
    return 2 if user_paints(spec) else 1


ALPHA_OPS = (OP_SAVE_ALPHA, OP_SCALE_ALPHA, OP_RESTORE_ALPHA, OP_SAVE_SCALE)


def clip_alpha_ops(spec: FrameSpec):
    """(has_clip, has_alpha): whether the frame holds clip or unclip ops,
    and alpha-group ops.  Without clip ops the clip buffer stays zero, so
    commands at a nonzero clip depth are no-ops and are skipped whole."""
    ops = set(spec.ops)
    return bool(ops & {OP_CLIP, OP_UNCLIP}), bool(ops & set(ALPHA_OPS))


#: Named blend modes as canonical (src_factor, operation, dst_factor).
_NAMED_BLEND = {
    "back_to_front": ("one", "add", "one_minus_src_alpha"),
    "front_to_back": ("one_minus_dst_alpha", "add", "one"),
    "additive": ("one", "add", "one"),
}

#: Integer codes of the blend algebra, as the CUDA kernel reads them.
BLEND_FACTOR_CODES = {
    "zero": 0,
    "one": 1,
    "src_alpha": 2,
    "one_minus_src_alpha": 3,
    "dst_alpha": 4,
    "one_minus_dst_alpha": 5,
    "src_alpha_saturated": 6,
    "constant": 7,
    "one_minus_constant": 8,
}
BLEND_OP_CODES = {
    "add": 0, "subtract": 1, "reverse_subtract": 2, "min": 3, "max": 4,
}


def _canonical_blend(blending):
    """spec.blending → (color_component, alpha_component) tuples."""
    if isinstance(blending, str):
        comp = _NAMED_BLEND[blending]
        return comp, comp
    color, alpha = blending
    return tuple(color), tuple(alpha)


def blend_uses_constant(blending) -> bool:
    """True when the blend state references the runtime blend-constant
    color; the packer then appends it to cmd_f columns 20:24."""
    color, alpha = _canonical_blend(blending)
    return any(
        f in ("constant", "one_minus_constant")
        for comp in (color, alpha)
        for f in (comp[0], comp[2])
    )


def _blend_codes(blending):
    """(src, op, dst) codes for color then alpha."""
    return tuple(
        code
        for src, op, dst in _canonical_blend(blending)
        for code in (
            BLEND_FACTOR_CODES[src], BLEND_OP_CODES[op],
            BLEND_FACTOR_CODES[dst],
        )
    )


def blend_kind(blending) -> int:
    """The kernel's blend kind: 1, 2 or 3 where both components are
    those of "back_to_front", "front_to_back" or "additive" (the kernel
    evaluates that formula), else 0 (the kernel reads the codes of
    ``_blend_codes``)."""
    color, alpha = _canonical_blend(blending)
    for kind, comp in enumerate(_NAMED_BLEND.values(), 1):
        if color == alpha == comp:
            return kind
    return 0


def _blend_channel(comp, s, d, ca, da, chan=0, const=None):
    """out = op(s·src_factor, d·dst_factor) for one channel, wgpu
    semantics (premultiplied; ``min``/``max`` ignore factors).

    ``ca``: the draw's source alpha; ``da``: the destination alpha
    before this draw touched any channel; ``const``: the 4 blend-constant
    scalars (present iff the state uses constant factors).  Every
    operand is a float32 tensor, so each step rounds as in the kernel."""
    src_f, op, dst_f = comp
    if op == "min":
        return torch.minimum(s, d)
    if op == "max":
        return torch.maximum(s, d)

    def factor(name):
        if name == "zero":
            return 0.0
        if name == "one":
            return 1.0
        if name == "src_alpha":
            return ca
        if name == "one_minus_src_alpha":
            return 1.0 - ca
        if name == "dst_alpha":
            return da
        if name == "one_minus_dst_alpha":
            return 1.0 - da
        if name == "src_alpha_saturated":
            # min(αs, 1−αd) on RGB, 1 on alpha.
            return torch.minimum(ca, 1.0 - da) if chan < 3 else 1.0
        if name == "constant":
            return const[chan]
        if name == "one_minus_constant":
            return 1.0 - const[chan]
        raise ValueError(f"unknown blend factor {name!r}")

    st = s * factor(src_f) if src_f != "zero" else 0.0
    dt = d * factor(dst_f) if dst_f != "zero" else 0.0
    if op == "add":
        return st + dt
    if op == "subtract":
        return st - dt
    return dt - st  # reverse_subtract


class PreparedFrame(NamedTuple):
    """Tensors produced by ``prepare``, consumed by ``rasterize``; the
    reference's fields and shapes."""

    tri_f: torch.Tensor    # (n_tiles, K+PAD, D_F)
    tri_i: torch.Tensor    # (n_tiles, K+PAD, D_I)
    off: torch.Tensor      # (n_tiles, 1, 9C+1) per-(cmd, class) ranges
    g_tri_f: torch.Tensor  # (n_tiles, Kg+PAD, D_F) per-tile big triangles
    g_tri_i: torch.Tensor  # (n_tiles, Kg+PAD, D_I)
    g_off: torch.Tensor    # (n_tiles, 1, 9C+1)
    bulk: torch.Tensor     # (n_tiles, 1, C) trivially-accepted winding
    cls: torch.Tensor      # (n_tiles, 1, Rc) cover-draw class 0/1/2
    hbits: torch.Tensor    # (n_tiles, 1, Rc) crossing hull-line bitmask
    aclist: torch.Tensor   # (n_tiles, 1, U) active unit indices
    acount: torch.Tensor   # (n_tiles, 1, 1)
    hull_lines: torch.Tensor  # (Rc, Hm+2, 4) inward-oriented pixel lines
    paint_xy: torch.Tensor    # (Rc, 4) paint points in pixels (zeros
    #                           without paints)
    zplane: torch.Tensor      # (Rc, 3) NDC-z planes (zeros without depth)
    overflow: torch.Tensor    # (4,) max local count, global count,
    #                           max tile globals, near-plane crossings


# ---------------------------------------------------------------------------
# prepare: setup + binning (torch)
# ---------------------------------------------------------------------------


class DrawTables(NamedTuple):
    """Static expansion of the command list into draws and units (see
    the reference's DrawTables)."""

    inst: np.ndarray        # (C,) per-command instance count
    row_base: np.ndarray    # (C+1,) transform-row offset per command
    s_cmd: np.ndarray       # (Rs,) stencil draw → command
    s_row: np.ndarray       # (Rs,) stencil draw → transform row
    c_cmd: np.ndarray       # (Rc,) cover draw → command
    c_row: np.ndarray       # (Rc,) cover draw → transform row
    unit_cmd: np.ndarray    # (U,) unit → command
    unit_draw: np.ndarray   # (U,) unit → cover draw (-1 for stencil)


def draw_tables(spec: FrameSpec) -> DrawTables:
    C = spec.n_commands
    ops = np.asarray(spec.ops, np.int32)
    inst = np.asarray(
        spec.cmd_inst if spec.cmd_inst else (1,) * C, np.int32
    )
    if len(inst) != C or not (inst >= 1).all():
        raise ValueError("cmd_inst must give every command >= 1 instance")
    row_base = np.concatenate([[0], np.cumsum(inst)]).astype(np.int32)
    s_cmd, s_row, c_cmd, c_row = [], [], [], []
    unit_cmd, unit_draw = [], []
    for c in range(C):
        rows = range(int(row_base[c]), int(row_base[c + 1]))
        if ops[c] == OP_STENCIL:
            s_cmd += [c] * int(inst[c])
            s_row += list(rows)
            unit_cmd.append(c)
            unit_draw.append(-1)
        else:
            for r in rows:
                unit_cmd.append(c)
                unit_draw.append(len(c_cmd))
                c_cmd.append(c)
                c_row.append(r)
    # A dummy draw that no unit references keeps every table non-empty,
    # as in the reference.
    if not s_cmd:
        s_cmd, s_row = [0], [0]
    if not c_cmd:
        c_cmd, c_row = [0], [0]
    i32 = np.int32
    return DrawTables(
        inst=inst,
        row_base=row_base,
        s_cmd=np.asarray(s_cmd, i32),
        s_row=np.asarray(s_row, i32),
        c_cmd=np.asarray(c_cmd, i32),
        c_row=np.asarray(c_row, i32),
        unit_cmd=np.asarray(unit_cmd, i32),
        unit_draw=np.asarray(unit_draw, i32),
    )


def _corner_min_max(a, b, c, x0, y0, tw, th):
    """Min/max of the linear function a·x+b·y+c over the tile rectangle
    [x0, x0+tw] × [y0, y0+th] (all broadcastable)."""
    base = a * x0 + b * y0 + c
    # The products once each: every operation is a node of the binning's
    # CUDA graph, and this runs for each edge slot and hull line a frame.
    dx = a * tw
    dy = b * th
    lo = base + torch.clamp(dx, max=0.0) + torch.clamp(dy, max=0.0)
    hi = base + torch.clamp(dx, min=0.0) + torch.clamp(dy, min=0.0)
    return lo, hi


def _nearer_endpoint(p, q, mp, mq):
    """Of each edge p → q (points (..., 2), magnitudes mp and mq, max
    |coordinate|), the endpoint of smaller magnitude, ties to the smaller
    x, then the smaller y: the same point whichever way the edge runs.
    An edge's constant c = -(a·x + b·y) taken there makes two triangles
    that share the edge get exactly negated (a, b, c), so that the
    top-left rule keeps it watertight.

    The reference takes c at the edge's first vertex.  A vertex clipped
    at the near plane (w = 1e-6) projects to about 1e8 px, where a float
    is 8 px apart; c taken there misses the line's position by pixels,
    and two triangles that evaluate the shared edge from opposite ends
    disagree.  make_prepare takes this rule for the clip pool's rows and
    a clipped hull's lines only: every row of unclipped geometry keeps
    the reference's rounding."""
    use_q = (mq < mp) | (
        (mq == mp) & ((q[..., 0] < p[..., 0])
                      | ((q[..., 0] == p[..., 0]) & (q[..., 1] < p[..., 1])))
    )
    return torch.where(use_q[..., None], q, p)


def _from_nearest_vertex(pix, mag, cycles):
    """Triangles (N, 3, 2) with their vertices in the same cyclic order
    but starting from the one of smallest magnitude ``mag`` (N, 3);
    ``cycles`` is the (3, 3) table of the three rotations of (0, 1, 2).

    The area (v1 - v0) × (v2 - v0), as the reference takes it, is then
    taken at that vertex.  At a vertex clipped at the near plane (about
    1e8 px) both differences round alike, and a thin triangle's area
    cancels to 0, which drops the triangle: make_prepare takes the
    areas of the clip pool's rows so."""
    order = cycles[torch.argmin(mag, -1)]
    return torch.gather(pix, 1, order[..., None].expand(-1, -1, 2))


def _transform_points(x, y, m):
    """clip[..., r] = x·m[r,0] + y·m[r,1] + 0·m[r,2] + 1·m[r,3]: the
    reference's full-f32 einsum over the homogeneous (x, y, 0, 1),
    written as an explicit multiply-add over the 4 columns so no matmul
    precision mode (TF32) can enter.  ``m`` is (..., 4, 4) broadcastable
    against ``x[..., None]``."""
    zero = torch.zeros_like(x)[..., None]
    one = torch.ones_like(x)[..., None]
    return (
        x[..., None] * m[..., 0]
        + y[..., None] * m[..., 1]
        + zero * m[..., 2]
        + one * m[..., 3]
    )


def _scatter_rows(n_rows, slots, values):
    """Rows of ``values`` written at row indices ``slots`` of an
    (n_rows, width) zero buffer; several rows may target the dump row
    n_rows - 1, whose content is never read."""
    out = torch.zeros(
        (n_rows, values.shape[-1]), dtype=values.dtype, device=values.device
    )
    out[slots] = values
    return out


def _det3(a):
    """jnp.linalg.det of (..., 3, 3): the rule of Sarrus, term for term."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _solve3(a, b):
    """x with a @ x = b for (R, 3, 3) ``a`` and (R, 3) ``b``: LU with
    partial pivoting (LAPACK getrf: pivot on the largest magnitude,
    scale the column by the pivot's reciprocal), then the unit-lower and
    upper triangular solves, every step an elementwise torch op, so
    that the CPU and the card round alike."""
    a = a.clone()
    b = b.clone()
    rows = torch.arange(a.shape[0], device=a.device)
    for k in range(3):
        piv = k + torch.argmax(torch.abs(a[:, k:, k]), dim=1)
        for m in (a, b):
            head = m[rows, k].clone()
            m[rows, k] = m[rows, piv]
            m[rows, piv] = head
        inv = 1.0 / a[:, k, k]
        for i in range(k + 1, 3):
            lik = a[:, i, k] * inv
            a[:, i, k] = lik
            for j in range(k + 1, 3):
                a[:, i, j] = a[:, i, j] - lik * a[:, k, j]
    y = [b[:, 0]]
    for i in (1, 2):
        acc = b[:, i]
        for j in range(i):
            acc = acc - a[:, i, j] * y[j]
        y.append(acc)
    x = [None, None, None]
    for i in (2, 1, 0):
        acc = y[i]
        for j in range(i + 1, 3):
            acc = acc - a[:, i, j] * x[j]
        x[i] = acc / a[:, i, i]
    return torch.stack(x, -1)


def _project_points(points, ctf, W, H):
    """Model-space (x, y) points (Rc, P, 2) through the draws' transforms
    (Rc, 4, 4) into pixels (Rc, P, 2), with the homogeneous divide
    guarded at |w| <= 1e-6 (the reference's gradient endpoints)."""
    clip = _transform_points(points[..., 0], points[..., 1], ctf[:, None])
    w = clip[..., 3]
    inv_w = torch.where(torch.abs(w) > 1e-6, 1.0 / w, 0.0)
    ndc = clip[..., :2] * inv_w[..., None]
    return torch.stack(
        [(ndc[..., 0] + 1.0) * (0.5 * W), (1.0 - ndc[..., 1]) * (0.5 * H)], -1
    )


def _depth_planes(ctf, W, H):
    """Per cover draw, the NDC-z plane z = a·px + b·py + c (Rc, 3) of
    planar model geometry (z = 0), solved from the transform rows with
    no perspective divide: px·w = (x_clip + w)·W/2 and py·w = (w −
    y_clip)·H/2 are affine over the model plane, so matching the
    coefficients of (x, y, 1) in Z = a·(X + W)·W/2 + b·(W − Y)·H/2 + c·W
    gives a 3×3 system.  A draw whose system is singular (|det| ≤ 1e-30)
    gets the zero plane (reference coverage.py:1007-1043)."""
    # Coefficients over (x, y, 1): columns 0, 1 and 3, taken one by one
    # (a list index would upload from the host, which a capture refuses).
    xr, yr, zr, wr = (
        torch.stack([ctf[:, r, 0], ctf[:, r, 1], ctf[:, r, 3]], -1)
        for r in range(4)
    )
    a = torch.stack([(xr + wr) * (0.5 * W), (wr - yr) * (0.5 * H), wr], -1)
    safe = torch.abs(_det3(a)) > 1e-30
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a)
    solved = _solve3(torch.where(safe[:, None, None], a, eye), zr)
    return torch.where(safe[:, None], solved, 0.0)


def _gate_masks(spec: FrameSpec, draws: DrawTables):
    """Per gate span, numpy (content unit mask, machinery unit mask,
    opener rows, closer rows) over the frame's U units and transform
    rows.  Raises ValueError for a span that is not a (content units,
    machinery units, row pairs) triple of indices in range."""
    U = len(draws.unit_cmd)
    R = int(draws.row_base[-1])
    masks = []
    for span in spec.gate_spans:
        try:
            content_u, mach_u, row_pairs = span
            content = np.asarray(content_u, np.int64).reshape(-1)
            mach = np.asarray(mach_u, np.int64).reshape(-1)
            pairs = np.asarray(row_pairs, np.int64).reshape(-1, 2)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"gate span {span!r} is not (content units, machinery "
                f"units, row pairs)"
            ) from exc
        if ((content < 0) | (content >= U)).any() or (
            (mach < 0) | (mach >= U)
        ).any():
            raise ValueError(f"gate span {span!r}: a unit outside [0, {U})")
        if ((pairs < 0) | (pairs >= R)).any():
            raise ValueError(f"gate span {span!r}: a row outside [0, {R})")
        content_m = np.zeros(U, bool)
        content_m[content] = True
        mach_m = np.zeros(U, bool)
        mach_m[mach] = True
        masks.append((content_m, mach_m, pairs[:, 0], pairs[:, 1]))
    return masks


#: The hull clip's threshold: a hull vertex is kept where w > HULL_EPS,
#: taken as a float32 (the reference's constant).
HULL_EPS = 1e-5


def cover_bins_plain(spec: FrameSpec, hull, transforms, c_shape, c_row):
    """The cover stage of ``make_prepare`` in torch operations: each cover
    draw's hull (``hull[c_shape]``, (Rc, h_max, 2)) through its transform
    (``transforms[c_row]``), clipped against w > HULL_EPS, projected to
    pixels and turned into inward lines; then each (tile, cover) pair's
    class (0 outside, 1 boundary, 2 inside) and bitmask of the hull lines
    that cross the tile.  Returns ``hull_lines`` (Rc, h_max + 2, 4) of the
    hull's dtype, ``cls`` and ``hbits`` (n_tiles, Rc) int32.

    The CPU path of ``cover_bins`` and its kernel's oracle on the card."""
    dev = hull.device
    f32 = torch.float32
    i32 = torch.int32
    i64 = torch.int64
    Hm = spec.h_max
    W, H = spec.width, spec.height
    tw, th = spec.screen_tile_w, spec.screen_tile_h
    ntx, nty, n_tiles = spec.ntx, spec.nty, spec.n_tiles
    Rc = c_shape.shape[0]

    def arange(n, dtype=i32):
        return torch.arange(n, dtype=dtype, device=dev)

    tile_x0 = arange(ntx).to(f32) * tw
    tile_y0 = arange(nty).to(f32) * th
    hp = hull[c_shape]                               # (Rc, Hm, 2)
    ctf = transforms[c_row]                          # (Rc, 4, 4)
    Cc = Rc
    hclip = _transform_points(hp[..., 0], hp[..., 1], ctf[:, None])
    # Sutherland–Hodgman clip of the convex hull against w > eps.
    H2 = Hm + 2
    eps = float(np.float32(HULL_EPS))
    b_vert = torch.roll(hclip, -1, 1)
    wa = hclip[..., 3]
    wb = b_vert[..., 3]
    in_a = wa > eps
    denom = torch.where(wb - wa != 0.0, wb - wa, 1.0)
    t_int = (eps - wa) / denom
    inter = hclip + t_int[..., None] * (b_vert - hclip)
    out_v = torch.stack([hclip, inter], 2).reshape(Cc, 2 * Hm, 4)
    out_valid = torch.stack([in_a, in_a != (wb > eps)], 2).reshape(
        Cc, 2 * Hm
    )
    h_rank = torch.cumsum(out_valid.to(i32), 1) - 1
    h_count = out_valid.to(i32).sum(1)
    rows_c = arange(Cc, i64)[:, None].expand(Cc, 2 * Hm)
    slot = torch.where(out_valid, torch.clamp(h_rank, max=H2), H2).to(i64)
    clipped = _scatter_rows(
        Cc * (H2 + 1), (rows_c * (H2 + 1) + slot).reshape(-1),
        out_v.reshape(-1, 4),
    ).reshape(Cc, H2 + 1, 4)[:, :H2]
    # Unused slots repeat the first vertex: degenerate edges, replaced
    # by pass lines below.
    in_use = arange(H2)[None, :] < torch.clamp(h_count, max=H2)[:, None]
    clipped = torch.where(in_use[..., None], clipped, clipped[:, 0:1, :])
    hvalid = h_count >= 3

    hw = clipped[..., 3]
    hiw = torch.where(hw > 0.0, 1.0 / hw, 0.0)
    hndc = clipped[..., :2] * hiw[..., None]
    hx = (hndc[..., 0] + 1.0) * (0.5 * W)
    hy = (1.0 - hndc[..., 1]) * (0.5 * H)
    hxn = torch.roll(hx, -1, -1)
    hyn = torch.roll(hy, -1, -1)
    h_area = torch.sum(hx * hyn - hxn * hy, -1)
    hsign = torch.where(h_area >= 0, 1.0, -1.0)[:, None]
    ha = -(hyn - hy) * hsign
    hb = (hxn - hx) * hsign
    # A hull clipped at the near plane takes each line's constant at
    # its nearer endpoint (_nearer_endpoint); the others as the
    # reference does.
    h_pt = torch.stack([hx, hy], -1)
    h_next = torch.stack([hxn, hyn], -1)
    h_mag = torch.abs(h_pt).amax(-1)
    h_at = torch.where(
        in_a.all(-1)[:, None, None],
        h_pt,
        _nearer_endpoint(h_pt, h_next, h_mag, torch.roll(h_mag, -1, -1)),
    )
    hc = -(ha * h_at[..., 0] + hb * h_at[..., 1])
    degenerate = (ha == 0.0) & (hb == 0.0)
    ha = torch.where(degenerate, 0.0, ha)
    hb = torch.where(degenerate, 0.0, hb)
    hc = torch.where(degenerate, 1.0, hc)
    hull_lines = torch.stack(
        [ha, hb, hc, torch.zeros_like(ha)], -1
    )                                                # (Rc, H2, 4)

    hovx = (hx.amin(-1)[:, None] <= tile_x0[None, :] + tw) & (
        hx.amax(-1)[:, None] >= tile_x0[None, :]
    )
    hovy = (hy.amin(-1)[:, None] <= tile_y0[None, :] + th) & (
        hy.amax(-1)[:, None] >= tile_y0[None, :]
    )
    h_reject = torch.zeros((Cc, nty, ntx), dtype=torch.bool, device=dev)
    h_accept = torch.ones((Cc, nty, ntx), dtype=torch.bool, device=dev)
    # Per-(tile, cover) bitmask of the hull lines crossing the tile.
    h_bits = torch.zeros((Cc, nty, ntx), dtype=i32, device=dev)
    if H2 > 31:
        raise ValueError("hull-line bitmask needs a single i32 word")
    for h_index in range(H2):
        a = ha[:, h_index][:, None, None]
        b = hb[:, h_index][:, None, None]
        c = hc[:, h_index][:, None, None]
        lo, hi = _corner_min_max(
            a, b, c, tile_x0[None, None, :], tile_y0[None, :, None], tw, th
        )
        h_reject = h_reject | (hi < 0.0)
        h_accept = h_accept & (lo > 0.0)
        h_bits = h_bits | torch.where(lo > 0.0, 0, 1 << h_index).to(i32)
    h_over = hovy[:, :, None] & hovx[:, None, :] & hvalid[:, None, None]
    cls = torch.where(
        h_over,
        torch.where(h_accept, 2, torch.where(h_reject, 0, 1)),
        0,
    ).to(i32).permute(1, 2, 0).reshape(n_tiles, Rc)
    hbits = h_bits.permute(1, 2, 0).reshape(n_tiles, Rc)
    return hull_lines, cls, hbits


@functools.lru_cache(maxsize=None)
def _cover_bins_library():
    """The cover stage's library (csrc/cover_bins.cu), built on first
    use."""
    lib = cuda_build.load_library("cover_bins", (("cover_bins.cu", ()),))
    lib.cover_bins_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_double, ctypes.c_double, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]
    )
    lib.cover_bins_launch.restype = ctypes.c_int
    return lib


def cover_bins(spec: FrameSpec, hull, transforms, c_shape, c_row):
    """``cover_bins_plain``'s outputs, ``(hull_lines, cls, hbits)``: CPU
    tensors run it; CUDA tensors launch the kernel of csrc/cover_bins.cu
    on the current stream, which writes the same values to the bit, in
    float32 or float64 as ``hull`` and ``transforms`` are.  ``c_shape``
    and ``c_row`` are int64 (Rc,) tables of rows of ``hull`` (n_shapes,
    h_max, 2) and ``transforms`` (R, 4, 4)."""
    device = hull.device
    if device.type == "cpu":
        return cover_bins_plain(spec, hull, transforms, c_shape, c_row)
    if device.type != "cuda":
        raise ValueError(f"cover_bins takes CPU or CUDA tensors, not {device}")
    H2 = spec.h_max + 2
    if H2 > 31:
        raise ValueError("hull-line bitmask needs a single i32 word")
    dtype = hull.dtype
    if dtype not in (torch.float32, torch.float64) or transforms.dtype != dtype:
        raise ValueError(
            f"hull and transforms must share float32 or float64, not "
            f"{hull.dtype} and {transforms.dtype}")
    Rc = c_shape.shape[0]
    for name, t, shape, want in (
        ("hull", hull, tuple(hull.shape[:1]) + (spec.h_max, 2), dtype),
        ("transforms", transforms, tuple(transforms.shape[:1]) + (4, 4), dtype),
        ("c_shape", c_shape, (Rc,), torch.int64),
        ("c_row", c_row, (Rc,), torch.int64),
    ):
        if (t.device != device or t.dtype != want or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"cover_bins: {name} must be a contiguous {want} tensor of "
                f"shape {shape} on {device}, not {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    lib = _cover_bins_library()
    hull_lines = torch.empty((Rc, H2, 4), dtype=dtype, device=device)
    cls = torch.empty((spec.n_tiles, Rc), dtype=torch.int32, device=device)
    hbits = torch.empty_like(cls)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cover_bins_launch(
            hull.data_ptr(), transforms.data_ptr(), c_shape.data_ptr(),
            c_row.data_ptr(), hull_lines.data_ptr(), cls.data_ptr(),
            hbits.data_ptr(), Rc, spec.h_max, spec.ntx, spec.nty,
            spec.screen_tile_w, spec.screen_tile_h, 0.5 * spec.width,
            0.5 * spec.height, HULL_EPS, int(dtype == torch.float64), stream,
        )
        captured = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"cover_bins launch failed: CUDA error {err}")
    # Counted as the raster kernel's launches are (coverage_raster).
    RECORD.count("cover_bin_captures" if captured else "cover_bin_launches")
    return hull_lines, cls, hbits


def make_prepare(spec: FrameSpec):
    C = spec.n_commands
    draws = draw_tables(spec)
    gates = _gate_masks(spec, draws)
    _row_base = draws.row_base

    def _shape_at(c, r):
        e = spec.cmd_shape[c]
        return e[r - _row_base[c]] if isinstance(e, (tuple, list)) else e

    s_shape_np = np.asarray(
        [_shape_at(c, r) for c, r in zip(draws.s_cmd, draws.s_row)],
        np.int64,
    )
    c_shape_np = np.asarray(
        [_shape_at(c, r) for c, r in zip(draws.c_cmd, draws.c_row)],
        np.int64,
    )
    Rs = len(draws.s_cmd)
    Rc = len(draws.c_cmd)
    U = len(draws.unit_cmd)
    T = spec.t_max
    W, H = spec.width, spec.height
    # All binning geometry is in screen space: the tile footprint.
    tw, th = spec.screen_tile_w, spec.screen_tile_h
    ntx, nty, n_tiles = spec.ntx, spec.nty, spec.n_tiles
    K = spec.capacity
    G = spec.global_capacity
    Kg = spec.tile_global_capacity
    PAD = spec.entry_pad
    mx, my = spec.slots_x, spec.slots_y
    M = mx * my
    constants = {}

    def device_constants(dev):
        """The spec's index tables, gate masks and scalars as tensors on
        ``dev``, made by the first call for that device and kept, so
        that a later call uploads nothing from the host (and a CUDA graph
        can capture it)."""
        c = constants.get(dev)
        if c is None:
            def idx(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=dev)

            c = constants[dev] = dict(
                s_cmd=torch.as_tensor(draws.s_cmd, device=dev),
                sshape=idx(s_shape_np),
                s_row=idx(draws.s_row),
                rot=idx([1, 2, 0]),
                cycles=idx([[0, 1, 2], [1, 2, 0], [2, 0, 1]]),
                fan0=idx([0, 1, 2]),
                fan1=idx([0, 2, 3]),
                perm=idx([2, 0, 1]),
                c_shape=idx(c_shape_np),
                c_row=idx(draws.c_row),
                unit_cmd=idx(draws.unit_cmd),
                unit_draw=idx(np.maximum(draws.unit_draw, 0)),
                is_cover_u=torch.as_tensor(draws.unit_draw >= 0, device=dev),
                gates=[
                    (torch.as_tensor(content_m, device=dev),
                     torch.as_tensor(~mach_m, device=dev),
                     idx(rows_a), idx(rows_b))
                    for content_m, mach_m, rows_a, rows_b in gates
                ],
                w_eps=torch.tensor(1e-6, dtype=torch.float32, device=dev),
                # The frame record's marks of the stages below.
                mark=RECORD.ring(dev).mark,
            )
        return c

    def prepare(xy, aux, kind, meta, gbase, hull, transforms, desc_static,
                paint_model=None):
        """xy (Ns,T,3,2) aux (Ns,T,3,4) kind (Ns,T) meta (Ns,T,2)
        gbase (Ns,) hull (Ns,Hm,2) transforms (R,4,4) desc_static
        (n_groups, 2), all tensors on one device; paint_model (Rc,2,2)
        the model-space paint points of each cover draw, or None when
        every paint is solid.

        After the first call for a device it neither uploads a host
        value nor reads one back: every size is fixed by the spec."""
        dev = xy.device
        f32 = torch.float32
        i32 = torch.int32
        i64 = torch.int64
        k = device_constants(dev)
        mark = k["mark"]

        def arange(n, dtype=i32):
            return torch.arange(n, dtype=dtype, device=dev)

        # The frame record's stages (profiling.STAGES), each marked at its
        # start by name: "setup" is every row's triangle setup.
        mark("setup")
        # ---- per-stencil-draw triangle setup --------------------------
        sshape = k["sshape"]
        sxy = xy[sshape]                          # (Rs, T, 3, 2)
        saux = aux[sshape]
        stf = transforms[k["s_row"]]              # (Rs, 4, 4)
        clip = _transform_points(
            sxy[..., 0], sxy[..., 1], stf[:, None, None]
        )                                         # (Rs, T, 3, 4)

        # ---- flatten to rows (one row per screen triangle) ------------
        N0 = Rs * T
        clip_flat = clip.reshape(N0, 3, 4)
        aux_flat = saux.reshape(N0, 3, 4)
        kind_flat = kind[sshape].reshape(N0)
        meta_flat = meta[sshape].reshape(N0, 2)
        gbase_flat = gbase[sshape][:, None].expand(Rs, T).reshape(N0)
        cmd_flat = k["s_cmd"][:, None].expand(Rs, T).reshape(N0)

        # ---- near-plane clipping of crossing triangles -----------------
        # Sutherland-Hodgman against w > eps into a pool of E slots, each
        # giving up to two sub-triangles (the reference's hardware clip).
        E = spec.clip_pool
        w_eps = k["w_eps"]
        w_all = clip_flat[..., 3]
        win = w_all > w_eps
        n_in = win.sum(-1)
        crossing = (n_in >= 1) & (n_in <= 2)
        cross_total = crossing.sum()
        # Crossing rows in ascending order first (the reference's top_k
        # over N0 - i; only the first min(total, E) slots are used).
        corder = torch.argsort(
            torch.where(crossing, 0, 1).to(i32), stable=True
        )[:min(E, N0)]
        cidx = (
            torch.cat([corder, corder.new_zeros(E - N0)])
            if E > N0 else corder
        )
        slot_ok = arange(E) < torch.clamp(cross_total, max=E)

        attr = torch.cat([clip_flat[cidx], aux_flat[cidx]], -1)  # (E,3,8)
        rot = k["rot"]
        wa = attr[..., 3]
        a_in = wa > w_eps
        nxt = attr[:, rot, :]
        wb = wa[:, rot]
        b_in = wb > w_eps
        denom = torch.where(wb - wa != 0.0, wb - wa, 1.0)
        t_cross = (w_eps - wa) / denom
        inter = attr + t_cross[..., None] * (nxt - attr)
        # Pin the intersection w to exactly eps (see the reference).
        inter[..., 3] = w_eps
        out_v = torch.stack([attr, inter], 2).reshape(E, 6, 8)
        out_ok = torch.stack([a_in, a_in != b_in], 2).reshape(E, 6)
        rank = torch.cumsum(out_ok.to(i32), 1) - 1
        cnt = out_ok.to(i32).sum(1)
        rows_e = arange(E, i64)[:, None].expand(E, 6)
        slot = torch.where(out_ok, torch.clamp(rank, max=4), 4).to(i64)
        poly = _scatter_rows(
            E * 5, (rows_e * 5 + slot).reshape(-1), out_v.reshape(-1, 8)
        ).reshape(E, 5, 8)[:, :4]
        in_use = arange(4)[None, :] < torch.clamp(cnt, max=4)[:, None]
        poly = torch.where(in_use[..., None], poly, poly[:, 0:1])
        # Fan: (p0, p1, p2) and (p0, p2, p3); a 3-vertex polygon's second
        # triangle is degenerate and culled downstream.
        tri0 = poly[:, k["fan0"]]
        tri1 = poly[:, k["fan1"]]
        pool_attr = torch.cat([tri0, tri1], 0)          # (2E, 3, 8)
        pool_valid = slot_ok.repeat(2)
        pool_clip = torch.where(
            pool_valid[:, None, None], pool_attr[..., :4], 0.0
        )
        pool_aux = pool_attr[..., 4:]
        pool_src = torch.where(slot_ok, cidx, 0).repeat(2)

        clip_all = torch.cat([clip_flat, pool_clip])     # (N, 3, 4)
        aux_all = torch.cat([aux_flat, pool_aux])
        kind_all = torch.cat([kind_flat, kind_flat[pool_src]])
        meta_all = torch.cat([meta_flat, meta_flat[pool_src]])
        gbase_all = torch.cat([gbase_flat, gbase_flat[pool_src]])
        cmd_of = torch.cat([cmd_flat, cmd_flat[pool_src]])
        # Crossing rows are superseded by their pool sub-triangles.
        near_ok = torch.cat([
            win.all(-1),
            (pool_clip[..., 3] > 0.0).all(-1) & pool_valid,
        ])
        n_rows = N0 + 2 * E

        # ---- screen-space projection + edge setup ----------------------
        w = clip_all[..., 3]
        inv_w = torch.where(w != 0.0, 1.0 / w, 0.0)
        ndc = clip_all[..., :2] * inv_w[..., None]
        px = (ndc[..., 0] + 1.0) * (0.5 * W)
        py = (1.0 - ndc[..., 1]) * (0.5 * H)
        pix = torch.stack([px, py], -1)                  # (N, 3, 2)

        # The clip pool's rows hold the near-plane vertices: their areas
        # are taken at their nearest vertex (_from_nearest_vertex), their
        # edges' constants at the nearer endpoint (_nearer_endpoint).
        pool_pix = pix[N0:]
        pool_mag = torch.abs(pool_pix).amax(-1)
        v0, v1, v2 = torch.cat([
            pix[:N0], _from_nearest_vertex(pool_pix, pool_mag, k["cycles"])
        ]).unbind(1)
        area = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
            v1[..., 1] - v0[..., 1]
        ) * (v2[..., 0] - v0[..., 0])
        anchor = torch.cat([pix[:N0], _nearer_endpoint(
            pool_pix, pool_pix[:, rot], pool_mag, pool_mag[:, rot])])
        orient = torch.sign(area)
        finite = torch.isfinite(pix).all(-1).all(-1) & torch.isfinite(area)
        visible = finite & (area != 0.0) & near_ok

        edges = []
        tl_bits = torch.zeros(area.shape, dtype=i32, device=dev)
        for e_index, (ai, bi) in enumerate(((0, 1), (1, 2), (2, 0))):
            a_v = pix[..., ai, :]
            b_v = pix[..., bi, :]
            ea = -(b_v[..., 1] - a_v[..., 1]) * orient
            eb = (b_v[..., 0] - a_v[..., 0]) * orient
            ec = -(ea * anchor[:, ai, 0] + eb * anchor[:, ai, 1])
            aa = torch.where(orient[..., None] > 0, a_v, b_v)
            bb = torch.where(orient[..., None] > 0, b_v, a_v)
            top_left = (
                (aa[..., 1] == bb[..., 1]) & (bb[..., 0] > aa[..., 0])
            ) | (bb[..., 1] > aa[..., 1])
            tl_bits = tl_bits | (top_left.to(i32) << e_index)
            edges.append(torch.stack([ea, eb, ec], -1))
        edge = torch.stack(edges, -2)                    # (N, 3, 3)
        inv_area = torch.where(area != 0.0, 1.0 / torch.abs(area), 0.0)

        aux_w = aux_all * inv_w[..., None]
        perm = k["perm"]
        aw = aux_w[:, perm, :]                           # aw[k] pairs edge k
        iw = inv_w[:, perm]

        is_fill = kind_all <= KIND_RATIONAL_CUBIC
        contribution = torch.where(
            visible & is_fill, -orient.to(i32), 0
        ).to(i32)
        contribution = torch.where(visible & ~is_fill, 1, contribution)

        group_flags = meta_all[..., 0].to(i32)
        group = gbase_all + (group_flags & 0xFFFF)
        flags = (
            tl_bits
            | torch.where((group_flags & 0x10000) != 0, FLAG_END_CAP, 0)
            | torch.where((group_flags & 0x20000) != 0, FLAG_JOINT_TIP, 0)
        ).to(i32)

        aabb = torch.cat([pix.amin(-2), pix.amax(-2)], -1)
        live = (
            (contribution != 0)
            & (aabb[..., 0] <= W) & (aabb[..., 2] >= 0.0)
            & (aabb[..., 1] <= H) & (aabb[..., 3] >= 0.0)
        )
        contribution = torch.where(live, contribution, 0)

        rows_f = torch.cat(
            [
                edge.reshape(n_rows, 9),
                inv_area[:, None],
                aw.reshape(n_rows, 12),
                iw,
                meta_all[:, 1:2],
                aabb,
                torch.zeros((n_rows, D_F - 30), dtype=f32, device=dev),
            ],
            -1,
        )
        # Per-group dash mode (0 solid, 1 single interval, 2 general);
        # groups outside the table read 0, as the reference's one-hot.
        n_groups = desc_static.shape[0]
        mode_tbl = torch.where(
            desc_static[:, 0] == 0, 0,
            torch.where(desc_static[:, 1] == 0, 1, 2),
        ).to(i32)
        in_tbl = (group >= 0) & (group < n_groups)
        dash_mode = torch.where(
            in_tbl, mode_tbl[torch.clamp(group, 0, n_groups - 1).to(i64)], 0
        )
        clsk = torch.where(
            kind_all == KIND_STROKE_LINE, CLS_LINE_SOLID + dash_mode,
            torch.where(
                kind_all == KIND_STROKE_JOINT, CLS_JOINT_SOLID + dash_mode,
                torch.where(
                    kind_all == KIND_SOLID, CLS_FILL_SOLID,
                    torch.where(
                        (kind_all == KIND_INTEGRAL_QUADRATIC)
                        | (kind_all == KIND_RATIONAL_QUADRATIC),
                        CLS_FILL_QUAD, CLS_FILL_CUBIC,
                    ),
                ),
            ),
        )
        rows_i = torch.stack(
            [
                kind_all,
                contribution,
                group,
                flags,
                is_fill.to(i32),
                cmd_of,
                clsk,
                torch.zeros_like(kind_all),
            ],
            -1,
        ).to(i32)

        solid_flat = kind_all == KIND_SOLID
        contrib_flat = rows_i[:, RI_CONTRIB]
        class_flat = rows_i[:, RI_CLASS]
        cmd64 = cmd_of.to(i64)
        key2_flat = cmd64 * N_CLASSES + class_flat

        def tile_index(v, step, n):
            return torch.clamp(torch.floor(v / step), 0, n - 1).to(i64)

        tx0 = tile_index(aabb[:, 0], tw, ntx)
        ty0 = tile_index(aabb[:, 1], th, nty)
        tx1 = tile_index(aabb[:, 2], tw, ntx)
        ty1 = tile_index(aabb[:, 3], th, nty)
        span_ok = ((tx1 - tx0) < mx) & ((ty1 - ty0) < my)
        is_local = live & span_ok
        is_global = live & ~span_ok

        bulk = torch.zeros((n_tiles, C), dtype=i32, device=dev)

        # "slots": the local entries to their tiles.
        mark("slots")
        # ---- local slot enumeration ----------------------------------
        m = arange(M, i64)
        etx = tx0[:, None] + (m % mx)[None, :]           # (N, M)
        ety = ty0[:, None] + (m // mx)[None, :]
        in_range = (
            (etx <= tx1[:, None]) & (ety <= ty1[:, None])
            & (etx < ntx) & (ety < nty) & is_local[:, None]
        )
        ex0 = etx.to(f32) * tw
        ey0 = ety.to(f32) * th
        reject = torch.zeros(etx.shape, dtype=torch.bool, device=dev)
        accept = torch.ones(etx.shape, dtype=torch.bool, device=dev)
        for e_index in range(3):
            a = rows_f[:, 3 * e_index + 0][:, None]
            b = rows_f[:, 3 * e_index + 1][:, None]
            c = rows_f[:, 3 * e_index + 2][:, None]
            lo, hi = _corner_min_max(a, b, c, ex0, ey0, tw, th)
            reject = reject | (hi < 0.0)
            accept = accept & (lo > 0.0)
        valid = in_range & ~reject
        tile_of = ety * ntx + etx
        solid_acc = valid & accept & solid_flat[:, None]
        entry = valid & ~solid_acc

        # Trivial accepts of solid triangles fold into one winding delta
        # per (tile, command): exact integer adds, the other slots adding
        # 0 at (tile 0, command 0) so that no mask sets a size.
        bulk.view(-1).index_add_(
            0,
            torch.where(solid_acc, tile_of * C + cmd64[:, None], 0).reshape(-1),
            torch.where(solid_acc, contrib_flat[:, None], 0).reshape(-1),
        )

        # Stable sort of local entries by (tile, cmd, class).
        key = (tile_of * C + cmd64[:, None]) * N_CLASSES + class_flat[:, None]
        big = n_tiles * C * N_CLASSES
        key = torch.where(entry, key, big).reshape(-1)
        order = torch.sort(key, stable=True).indices
        srow = order // M                                # payload: row index

        # Entry counts per (tile, cmd, class); the keys of non-entries
        # (big) count in one extra slot, cut off.
        counts2 = torch.zeros(big + 1, dtype=i64, device=dev).index_add_(
            0, key, torch.ones_like(key)
        )[:big].reshape(n_tiles, N_CLASSES * C)
        off = torch.cat(
            [torch.zeros((n_tiles, 1), dtype=i64, device=dev),
             torch.cumsum(counts2, 1)],
            1,
        )
        tile_count = off[:, -1]
        tile_begin = torch.cat(
            [torch.zeros(1, dtype=i64, device=dev),
             torch.cumsum(tile_count, 0)[:-1]]
        )
        kk = arange(K + PAD, i64)
        gidx = torch.clamp(tile_begin[:, None] + kk[None, :], 0, key.shape[0] - 1)
        # Rows past a tile's entry count belong to the next segment; the
        # kernel never reads past the `off` ranges.
        tri_rows = srow[gidx]
        tri_f = rows_f[tri_rows]
        tri_i = rows_i[tri_rows]
        off = torch.clamp(off, max=K)

        mark("globals")
        # ---- globals (big triangles) via a small dense matrix ---------
        gkey = torch.where(is_global, key2_flat, C * N_CLASSES + 1)
        gsrow = torch.sort(gkey, stable=True).indices
        g_total = is_global.sum()
        g_ids = (
            gsrow[:G] if n_rows >= G
            else torch.cat([gsrow, gsrow.new_zeros(G - n_rows)])
        )
        g_valid = arange(G, i64) < torch.clamp(g_total, max=G)
        g_rows_f = rows_f[g_ids]
        g_rows_i = rows_i[g_ids]

        tile_x0 = arange(ntx).to(f32) * tw
        tile_y0 = arange(nty).to(f32) * th
        gaabb = g_rows_f[:, RF_AABB:RF_AABB + 4]
        ovx = (gaabb[:, 0:1] <= tile_x0[None, :] + tw) & (
            gaabb[:, 2:3] >= tile_x0[None, :]
        )                                                # (G, ntx)
        ovy = (gaabb[:, 1:2] <= tile_y0[None, :] + th) & (
            gaabb[:, 3:4] >= tile_y0[None, :]
        )                                                # (G, nty)
        g_reject = torch.zeros((G, nty, ntx), dtype=torch.bool, device=dev)
        g_accept = torch.ones((G, nty, ntx), dtype=torch.bool, device=dev)
        for e_index in range(3):
            a = g_rows_f[:, 3 * e_index + 0][:, None, None]
            b = g_rows_f[:, 3 * e_index + 1][:, None, None]
            c = g_rows_f[:, 3 * e_index + 2][:, None, None]
            lo, hi = _corner_min_max(
                a, b, c, tile_x0[None, None, :], tile_y0[None, :, None], tw, th
            )
            g_reject = g_reject | (hi < 0.0)
            g_accept = g_accept & (lo > 0.0)
        g_over = ovy[:, :, None] & ovx[:, None, :] & g_valid[:, None, None]
        g_solid = g_rows_i[:, RI_KIND] == KIND_SOLID
        g_acc_mask = g_over & g_accept & g_solid[:, None, None]
        g_entry = (g_over & ~g_reject & ~g_acc_mask).permute(1, 2, 0).reshape(
            n_tiles, G
        )
        g_acc_flat = g_acc_mask.permute(1, 2, 0).reshape(n_tiles, G)

        # Per-(tile, command) sums over globals: exact integer scatters
        # (the reference's one-hot matmuls).
        g_cmd = g_rows_i[:, RI_CMD].to(i64)
        bulk.index_add_(
            1, g_cmd,
            torch.where(g_acc_flat, g_rows_i[None, :, RI_CONTRIB], 0).to(i32),
        )

        # Per-tile global entry list in ascending g (already (cmd,
        # class)-sorted); slots past the tile's count are never read.
        gl_key = torch.where(g_entry, arange(G, i64)[None, :], G)
        gl_idx = torch.sort(gl_key, dim=1, stable=True).indices[:, :Kg]
        glist = torch.cat(
            [gl_idx, gl_idx.new_zeros((n_tiles, Kg + PAD - gl_idx.shape[1]))],
            1,
        )
        g_tri_f = g_rows_f[glist]                        # (n_tiles, Kg+PAD, D_F)
        g_tri_i = g_rows_i[glist]
        g_key2 = g_cmd * N_CLASSES + g_rows_i[:, RI_CLASS]
        g_counts2 = torch.zeros(
            (n_tiles, N_CLASSES * C), dtype=i64, device=dev
        ).index_add_(1, g_key2, g_entry.to(i64))
        g_off = torch.cat(
            [torch.zeros((n_tiles, 1), dtype=i64, device=dev),
             torch.cumsum(g_counts2, 1)],
            1,
        )
        tile_g_count = g_off[:, -1]
        g_off = torch.clamp(g_off, max=Kg)

        mark("covers")
        # ---- cover draws: near-plane clip + hull lines + class ---------
        # Paint points projected as the hulls are, so paints ride the
        # camera; zeros without paints, as in the reference.
        if paint_model is not None or has_depth(spec):
            ctf = transforms[k["c_row"]]                 # (Rc, 4, 4)
        if paint_model is None:
            paint_xy = torch.zeros((Rc, 4), dtype=f32, device=dev)
        else:
            paint_xy = _project_points(paint_model, ctf, W, H).reshape(Rc, 4)
        if has_depth(spec):
            zplane = _depth_planes(ctf, W, H)
        else:
            zplane = torch.zeros((Rc, 3), dtype=f32, device=dev)
        hull_lines, cls, hbits = cover_bins(
            spec, hull, transforms, k["c_shape"], k["c_row"])

        # "units": to the outputs, made contiguous.
        mark("units")
        # ---- active unit list ------------------------------------------
        # A unit is a whole stencil command or one cover draw, walked in
        # global draw order.
        start = off[:, 0:N_CLASSES * C:N_CLASSES]
        end = off[:, N_CLASSES:N_CLASSES * C + 1:N_CLASSES]
        g_start = g_off[:, 0:N_CLASSES * C:N_CLASSES]
        g_end = g_off[:, N_CLASSES:N_CLASSES * C + 1:N_CLASSES]
        stencil_active = (end > start) | (g_end > g_start) | (bulk != 0)
        cover_active = cls > 0
        act_s = stencil_active[:, k["unit_cmd"]]
        act_c = cover_active[:, k["unit_draw"]]
        active = torch.where(k["is_cover_u"][None, :], act_c, act_s)
        # ---- clip/alpha bracket gating --------------------------------
        # Drop a balanced bracket's machinery units from the tiles that
        # NO content unit of the whole frame touches: frame alpha is
        # exactly 0 there, and the complete bracket is then bit-exact
        # identity on the colour buffer (renderer._gate_spans proves the
        # static obligations).  Hull coincidence (equal opener and closer
        # transform rows) is the one runtime condition, checked here on
        # the device, with no host sync: unequal rows keep the span's
        # machinery everywhere.
        for content, other, rows_a, rows_b in k["gates"]:
            keep = other[None, :] | (active & content).any(1)[:, None]
            if len(rows_a):
                opener, closer = transforms[rows_a], transforms[rows_b]
                keep = keep | ~(opener == closer).all()
            active = active & keep
        # Compact active unit indices per tile (inactive slots key to U
        # and sink to the tail).
        aclist = torch.sort(
            torch.where(active, arange(U)[None, :], U).to(i32), dim=1
        ).values
        acount = active.to(i32).sum(1)

        overflow = torch.stack(
            [tile_count.max(), g_total, tile_g_count.max(), cross_total]
        ).to(i32)

        fields = dict(
            tri_f=tri_f,
            tri_i=tri_i,
            off=off.to(i32)[:, None, :],
            g_tri_f=g_tri_f,
            g_tri_i=g_tri_i,
            g_off=g_off.to(i32)[:, None, :],
            bulk=bulk[:, None, :],
            cls=cls[:, None, :],
            hbits=hbits[:, None, :],
            aclist=aclist[:, None, :],
            acount=acount.to(i32)[:, None, None],
            hull_lines=hull_lines,
            paint_xy=paint_xy,
            zplane=zplane,
            overflow=overflow,
        )
        prepared = PreparedFrame(
            **{k: v.contiguous() for k, v in fields.items()})
        mark(END)
        return prepared

    return prepare


def prepare_in_float64(prepare):
    """``prepare`` (a ``make_prepare`` closure) run in float64: every
    floating input cast to double, every output rounded back to its own
    dtype (float32 rows, int32 tables).  The oracle that the near-plane
    rules (_nearer_endpoint, _from_nearest_vertex) are held to, in the
    tests and in chip_smoke.py; no path of the renderer calls it."""

    def run(*args):
        out = prepare(*(
            a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args
        ))
        return PreparedFrame(*(
            o.float() if o.is_floating_point() else o.int() for o in out
        ))

    return run


# ---------------------------------------------------------------------------
# rasterize: the CUDA kernel and its plain torch version
# ---------------------------------------------------------------------------

#: The kernel's thread layout: a block of 256 threads is BLOCK_ROWS x
#: BLOCK_LANES pixels of a tile, and its warp w the BLOCK_ROWS x 8 lanes
#: from lane 8w of it (see warp_pixels).
BLOCK_ROWS, BLOCK_LANES = 4, 64


def warp_pixels(tile_h, tile_w):
    """The lane-major pixel index (row * tile_w + lane) of each thread of
    each warp of a tile, in the kernel's order: (tile_h * tile_w / 32,
    32), warp by warp and block by block."""
    blocks_x = tile_w // BLOCK_LANES
    b = torch.arange(tile_h * tile_w // 256)[:, None, None]
    w = torch.arange(8)[None, :, None]
    q = torch.arange(32)[None, None, :]
    row = (b // blocks_x) * BLOCK_ROWS + q // 8
    lane = (b % blocks_x) * BLOCK_LANES + w * 8 + q % 8
    return (row * tile_w + lane).reshape(-1, 32)


def block_rects(spec):
    """Each block's footprint as the kernel computes it (raster_item's
    slab box): (tile_h * tile_w / 256, 4) int (x_lo, y_lo, x_hi, y_hi),
    the bounding rectangle of the block's pixels relative to its tile's
    origin.  With strips narrower than the block's 64 lanes the block
    spans several strips, and the rectangle holds them all."""
    th, tw, lw = spec.tile_h, spec.tile_w, spec.screen_tile_w
    blocks_x = tw // BLOCK_LANES
    rects = []
    for slab in range(th * tw // (BLOCK_ROWS * BLOCK_LANES)):
        l0 = (slab % blocks_x) * BLOCK_LANES
        r0 = (slab // blocks_x) * BLOCK_ROWS
        x_lo = l0 % lw
        rects.append((
            x_lo,
            (l0 // lw) * th + r0,
            x_lo + min(lw, BLOCK_LANES) - 1,
            ((l0 + BLOCK_LANES - 1) // lw) * th + r0 + BLOCK_ROWS - 1,
        ))
    return torch.tensor(rects)


def warp_rects(spec):
    """Each warp's rectangle as the kernel computes it (raster_item: the
    warp min and max of its threads' pixels, each thread's pixel from its
    block and lane): (tile_h * tile_w / 32, 4) int (x_lo, y_lo, x_hi,
    y_hi) relative to its tile's origin, warp by warp as warp_pixels
    orders them.  Where a strip is 8 pixels wide or more it is the 8 x 4
    pixels from lane 0's; in a narrower strip the warp's 8 lanes span
    several strips, tile_h rows apart."""
    th, tw, lw = spec.tile_h, spec.tile_w, spec.screen_tile_w
    blocks_x = tw // BLOCK_LANES
    b = torch.arange(th * tw // 256)[:, None, None]
    w = torch.arange(8)[None, :, None]
    q = torch.arange(32)[None, None, :]
    r = (b // blocks_x) * BLOCK_ROWS + q // 8
    l = (b % blocks_x) * BLOCK_LANES + w * 8 + q % 8
    if spec.tile_strips == 1:
        ix, iy = l, r
    else:
        ix, iy = l % lw, (l // lw) * th + r
    ix, iy = (v.reshape(-1, 32) for v in torch.broadcast_tensors(ix, iy))
    return torch.stack(
        [ix.amin(1), iy.amin(1), ix.amax(1), iy.amax(1)], 1
    )


_MAX_SAMPLES = 16


class _RasterArgs(ctypes.Structure):
    """Mirror of ``struct RasterArgs`` in csrc/coverage_raster.cu."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in (
            "cmd_i", "cmd_f", "hull", "unit_cmd", "unit_draw", "acount",
            "aclist", "off", "g_off", "bulk", "cls", "hbits", "tri_f",
            "tri_i", "g_tri_f", "g_tri_i", "desc_f", "desc_i", "paint_xy",
            "zplane", "layers", "prof", "out",
        )
    ] + [
        (name, ctypes.c_int) for name in (
            "width", "height", "n_tiles", "ntx", "th", "tw", "strips", "lw", "lh",
            "n_commands", "n_draws", "n_units", "hull_rows", "draw_cols",
            "kp", "kgp", "n_groups", "samples", "winding_mask", "out_u8",
            "color_src", "color_op", "color_dst",
            "alpha_src", "alpha_op", "alpha_dst", "blend_kind",
            "has_clip", "has_alpha", "layer_mode", "n_layers",
            "layer_blocks", "has_strokes",
            "depth_compare", "depth_write",
        )
    ] + [
        ("sample_x", ctypes.c_float * _MAX_SAMPLES),
        ("sample_y", ctypes.c_float * _MAX_SAMPLES),
    ]


#: The bodies that the kernel's profiling build times, in the order of
#: its counters (coverage_raster.cu, BODY_*): tile setup and the per-unit
#: table loads; the stroke stencil; the fill stencil; the cover's hull
#: test; its depth and mask; its paint; its blend and winding reset;
#: clip and alpha ops; the resolve and write; empty tiles.
PROFILE_BODIES = (
    "setup", "stroke", "fill", "hull", "depth", "paint", "blend",
    "clip_alpha", "resolve", "empty",
)


class KernelFeatures(NamedTuple):
    """What one build of the raster kernel holds: the kernels of one
    sample count, with or without the depth body, with the paint bodies
    of ``paint_mode`` and, in mode 2, the device functions of these user
    paint sources (paint code 3 + i runs source i).  Each library holds
    six instantiations: three layer modes, with and without strokes.
    ``variant``: "" for the build that renders; "profile" for the
    profiling build (per-body clocks); "omit_<body>" for the subtractive
    build that skips one of PROFILE_BODIES (timing only)."""

    samples: int
    depth: bool = False
    paint_mode: int = 0
    user_sources: tuple = ()
    variant: str = ""

    @property
    def name(self):
        name = f"coverage_raster_s{self.samples}_d{int(self.depth)}_p{self.paint_mode}"
        return f"{name}_{self.variant}" if self.variant else name


def kernel_features(spec: FrameSpec) -> KernelFeatures:
    """The library a frame needs.  Raises ValueError for a user paint
    without a ``cuda`` source: it has no kernel, and the card never
    falls back to the plain version."""
    mode = paint_mode(spec)
    sources = []
    for paint in user_paints(spec) if mode == 2 else ():
        if getattr(paint, "cuda", None) is None:
            raise ValueError(
                "a UserPaint without a `cuda` device function cannot be "
                "rendered on a CUDA device"
            )
        sources.append(paint.cuda)
    return KernelFeatures(spec.samples, has_depth(spec), mode, tuple(sources))


def _user_paint_unit(sources):
    """The generated compile unit of a user-paint library: each source
    in a namespace of its own, a switch on the paint index, then the
    kernel source itself."""
    parts = ["// Generated by coverage.py::_user_paint_unit.",
             "#include <cuda_runtime.h>"]
    for i, src in enumerate(sources):
        parts += [f"namespace user_paint_{i} {{", src, f"}}  // namespace user_paint_{i}"]
    parts += [
        "__device__ __forceinline__ float4 user_paint(int index, float px, float py,",
        "                                             float x0, float y0, float x1,",
        "                                             float y1) {",
        "  switch (index) {",
    ]
    parts += [f"    case {i}: return user_paint_{i}::paint(px, py, x0, y0, x1, y1);"
              for i in range(len(sources))]
    parts += ["    default: return make_float4(0.0f, 0.0f, 0.0f, 0.0f);",
              "  }", "}", '#include "coverage_raster.cu"', ""]
    return "\n".join(parts)


_libraries = {}


def build_kernel(features: KernelFeatures):
    """The raster kernel's library for ``features``, typed for ctypes;
    the first call builds it with nvcc (or loads the cached build)."""
    lib = _libraries.get(features)
    if lib is None:
        defines = (
            f"RASTER_SAMPLES={features.samples}",
            f"RASTER_DEPTH={int(features.depth)}",
            f"RASTER_PAINT={features.paint_mode}",
        )
        if features.variant == "profile":
            defines += ("RASTER_PROFILE=1",)
        elif features.variant.startswith("omit_"):
            body = features.variant[len("omit_"):]
            defines += (f"RASTER_OMIT={PROFILE_BODIES.index(body)}",)
        elif features.variant:
            raise ValueError(f"unknown kernel variant {features.variant!r}")
        if features.paint_mode == 2:
            unit = cuda_build.generated_source(
                "user_paints", _user_paint_unit(features.user_sources)
            )
        else:
            unit = "coverage_raster.cu"
        lib = cuda_build.load_library(features.name, ((unit, defines),))
        lib.coverage_raster_launch.argtypes = [
            ctypes.POINTER(_RasterArgs), ctypes.c_void_p,
        ]
        lib.coverage_raster_launch.restype = ctypes.c_int
        lib.coverage_raster_layer_blocks.argtypes = [
            ctypes.POINTER(_RasterArgs), ctypes.POINTER(ctypes.c_int),
        ]
        lib.coverage_raster_layer_blocks.restype = ctypes.c_int
        _libraries[features] = lib
    return lib


def build_kernels(features):
    """Build the libraries of several feature sets at once (one nvcc
    each, all started together); returns them in order."""
    features = list(features)
    with ThreadPoolExecutor(max_workers=max(1, len(features))) as pool:
        return list(pool.map(build_kernel, features))


@functools.lru_cache(maxsize=64)
def _raster_plan(spec: FrameSpec):
    """The host work of coverage_raster that depends on the spec alone,
    done once per spec: its draw tables and the expected (shape, dtype)
    of every input."""
    draws = draw_tables(spec)
    return draws, _raster_shapes(spec, draws)


def _raster_shapes(spec: FrameSpec, draws: DrawTables):
    """Expected (shape, dtype) of every coverage_raster input; ``G``
    stands for the descriptor group count, which the spec does not fix."""
    C = spec.n_commands
    Rc = len(draws.c_cmd)
    U = len(draws.unit_cmd)
    n_tiles = spec.n_tiles
    kp = spec.capacity + spec.entry_pad
    kgp = spec.tile_global_capacity + spec.entry_pad
    i32, f32 = torch.int32, torch.float32
    return {
        "tri_f": ((n_tiles, kp, D_F), f32),
        "tri_i": ((n_tiles, kp, D_I), i32),
        "off": ((n_tiles, 1, N_CLASSES * C + 1), i32),
        "g_tri_f": ((n_tiles, kgp, D_F), f32),
        "g_tri_i": ((n_tiles, kgp, D_I), i32),
        "g_off": ((n_tiles, 1, N_CLASSES * C + 1), i32),
        "bulk": ((n_tiles, 1, C), i32),
        "cls": ((n_tiles, 1, Rc), i32),
        "hbits": ((n_tiles, 1, Rc), i32),
        "aclist": ((n_tiles, 1, U), i32),
        "acount": ((n_tiles, 1, 1), i32),
        "hull_lines": ((Rc, spec.h_max + 2, 4), f32),
        "paint_xy": ((Rc, 4), f32),
        "zplane": ((Rc, 3), f32),
        "cmd_i": ((C, 4), i32),
        "cmd_f": ((Rc, 24 if blend_uses_constant(spec.blending) else 20), f32),
        "unit_cmd": ((U,), i32),
        "unit_draw": ((U,), i32),
        "desc_f": (("G", DESC_F), f32),
        "desc_i": (("G", DESC_I), i32),
    }


def _check_inputs(expected, tensors, device):
    """Raise ValueError unless every input has its expected device, shape,
    dtype and contiguity, and desc_f/desc_i share one G >= 1."""
    n_groups = tensors["desc_f"].shape[0]
    for name, (shape, dtype) in expected.items():
        t = tensors[name]
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, tri_f on {device}")
        want = tuple(n_groups if n == "G" else n for n in shape)
        if tuple(t.shape) != want or t.dtype != dtype:
            raise ValueError(
                f"{name}: expected {want} {dtype}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_groups < 1:
        raise ValueError("desc_f/desc_i need at least one descriptor group")


def _frame_output(spec: FrameSpec, device, out=None):
    """The kernel's output: the frame, float32 (H, W, 4) or packed RGBA8
    as int32 (H, W); ``out``, where given, checked to be such a tensor
    on ``device``, contiguous and aligned to a pixel (16 or 4 bytes)."""
    if spec.out_uint8:
        shape, dtype = (spec.height, spec.width), torch.int32
    else:
        shape, dtype = (spec.height, spec.width, 4), torch.float32
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != shape or out.dtype != dtype or out.device != device
            or not out.is_contiguous()
            or out.data_ptr() % (4 if spec.out_uint8 else 16)):
        raise ValueError(
            f"out must be a contiguous, pixel-aligned {shape} {dtype} tensor "
            f"on {device}"
        )
    return out


def detile(spec: FrameSpec, tiles):
    """The frame of a tile-layout output (``rasterize_plain``'s): float
    (n_tiles, 4, th, tw) to (H, W, 4), packed int32 (n_tiles, th, tw) to
    (H, W).  Lane l of a tile's row r is screen pixel ((l // lw)·th + r,
    l % lw) of its footprint; the padding past the frame is cut off."""
    nty, ntx, th = spec.nty, spec.ntx, spec.tile_h
    strips, lw, lh = spec.tile_strips, spec.screen_tile_w, spec.screen_tile_h
    if spec.out_uint8:
        image = tiles.reshape(nty, ntx, th, strips, lw)
        image = image.permute(0, 3, 2, 1, 4).reshape(nty * lh, ntx * lw)
    else:
        image = tiles.reshape(nty, ntx, 4, th, strips, lw)
        image = image.permute(0, 4, 3, 1, 5, 2).reshape(nty * lh, ntx * lw, 4)
    return image[:spec.height, :spec.width].contiguous()


def layer_mode(spec: FrameSpec) -> int:
    """The kernel instantiation a frame needs: -1 without clip or alpha
    ops; 1 for alpha ops on one layer, held in registers; 0 for clip
    without alpha ops, or for more layers: (L, S) slots per pixel in the
    block's shared memory, or, past what a block may hold, in a global
    scratch of one slice per block that can be resident at once
    (``layer_scratch_blocks``)."""
    has_clip, has_alpha = clip_alpha_ops(spec)
    if has_alpha and max(1, spec.n_layers) == 1:
        return 1
    return 0 if has_clip or has_alpha else -1


#: layer_scratch_blocks per (kernel features, strokes, layers, device).
_layer_blocks = {}


def layer_scratch_blocks(spec: FrameSpec, device) -> int:
    """How many slices of (L, S, 256) floats the kernel's global layer
    scratch holds for frames of ``spec`` on the CUDA ``device``: 0 where
    the frame keeps its alpha layers in registers or in the block's
    shared memory (or has none), else the blocks of its instantiation
    that can be resident at once on the card, which the kernel's grid
    then holds.  Depends on the card and the instantiation, never on
    the frame's size.  Builds the frame's kernel library if needed."""
    device = torch.device(device)
    if layer_mode(spec) != 0 or not clip_alpha_ops(spec)[1]:
        return 0
    features = kernel_features(spec)
    n_layers = max(1, spec.n_layers)
    key = (features, spec.has_strokes, n_layers, device.index)
    blocks = _layer_blocks.get(key)
    if blocks is None:
        lib = build_kernel(features)
        # The entry point reads these fields alone.
        args = _RasterArgs(
            samples=spec.samples, has_alpha=1, layer_mode=0, n_layers=n_layers,
            has_strokes=int(spec.has_strokes),
        )
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.coverage_raster_layer_blocks(
                ctypes.byref(args), ctypes.byref(out)
            )
        if err != 0:
            raise RuntimeError(f"coverage_raster_layer_blocks: CUDA error {err}")
        blocks = _layer_blocks[key] = out.value
    return blocks


def coverage_raster(spec, prepared, cmd_i, cmd_f, unit_cmd, unit_draw,
                    desc_f, desc_i, *, out=None, profile=None, omit=None):
    """Rasterize one prepared frame: float (H, W, 4), or packed RGBA8 as
    int32 (H, W) when ``spec.out_uint8``; into ``out`` where given (such
    a tensor, contiguous and aligned to a pixel).  ``desc_f``/``desc_i``
    are the stroke descriptor rows, (G, DESC_F) f32 and (G, DESC_I) i32.

    CUDA tensors launch the kernel of csrc/coverage_raster.cu on the
    current stream (the build of ``kernel_features(spec)``), which
    writes each pixel at its place in the frame; CPU tensors run
    ``rasterize_plain`` and ``detile`` its tiles.

    For measurement on the card only: ``profile``, an int64 tensor of
    len(PROFILE_BODIES) on the device, launches the profiling build,
    which adds each body's warp-cycles to it; ``omit``, one of
    PROFILE_BODIES, launches the subtractive build that skips that body
    (its output is not the frame)."""
    draws, expected = _raster_plan(spec)
    tensors = dict(
        prepared._asdict(), cmd_i=cmd_i, cmd_f=cmd_f,
        unit_cmd=unit_cmd, unit_draw=unit_draw, desc_f=desc_f, desc_i=desc_i,
    )
    device = prepared.tri_f.device
    _check_inputs(expected, tensors, device)
    variant = ""
    if profile is not None or omit is not None:
        if device.type != "cuda" or (profile is not None and omit is not None):
            raise ValueError("profile or omit: one of them, on a CUDA device")
        if profile is not None and (
            profile.device != device or profile.dtype != torch.int64
            or tuple(profile.shape) != (len(PROFILE_BODIES),)
        ):
            raise ValueError(
                f"profile must be int64 ({len(PROFILE_BODIES)},) on {device}"
            )
        if omit is not None and omit not in PROFILE_BODIES:
            raise ValueError(f"omit: {omit!r} is not one of {PROFILE_BODIES}")
        variant = "profile" if profile is not None else f"omit_{omit}"
    if device.type == "cpu":
        image = detile(spec, rasterize_plain(
            spec, prepared, cmd_i, cmd_f, unit_cmd, unit_draw, desc_f, desc_i
        ))
        if out is None:
            return image
        return _frame_output(spec, device, out).copy_(image)
    if device.type != "cuda":
        raise ValueError(f"coverage_raster takes CPU or CUDA tensors, not {device}")
    lib = build_kernel(kernel_features(spec)._replace(variant=variant))
    if spec.tile_h % BLOCK_ROWS or spec.tile_w % BLOCK_LANES:
        raise ValueError(
            f"tile {spec.tile_h}x{spec.tile_w} is not a multiple of the "
            f"kernel's {BLOCK_ROWS}x{BLOCK_LANES}-pixel block"
        )
    out = _frame_output(spec, device, out)
    has_clip, has_alpha = clip_alpha_ops(spec)
    mode = layer_mode(spec)
    n_layers = max(1, spec.n_layers)
    offsets = SAMPLE_PATTERNS[spec.samples]
    codes = _blend_codes(spec.blending)
    args = _RasterArgs(
        *(tensors[name].data_ptr() for name in (
            "cmd_i", "cmd_f", "hull_lines", "unit_cmd", "unit_draw",
            "acount", "aclist", "off", "g_off", "bulk", "cls", "hbits",
            "tri_f", "tri_i", "g_tri_f", "g_tri_i", "desc_f", "desc_i",
            "paint_xy", "zplane",
        )),
        None,
        None if profile is None else profile.data_ptr(),
        out.data_ptr(),
        spec.width, spec.height, spec.n_tiles, spec.ntx, spec.tile_h,
        spec.tile_w, spec.tile_strips, spec.screen_tile_w, spec.screen_tile_h,
        spec.n_commands, len(draws.c_cmd), len(draws.unit_cmd),
        spec.h_max + 2, cmd_f.shape[1],
        expected["tri_f"][0][1], expected["g_tri_f"][0][1],
        desc_f.shape[0],
        spec.samples, (1 << spec.winding_bits) - 1, int(spec.out_uint8),
        *codes, blend_kind(spec.blending),
        int(has_clip), int(has_alpha), mode, n_layers, 0,
        int(spec.has_strokes),
        DEPTH_COMPARE_CODES[spec.depth_compare], int(spec.depth_write),
    )
    args.sample_x[:spec.samples] = offsets[:, 0].tolist()
    args.sample_y[:spec.samples] = offsets[:, 1].tolist()
    # The kernel allocates nothing: alpha layers past what a block's
    # shared memory holds go to this scratch, L*S slots per thread of
    # each block that can be resident at once; its size does not grow
    # with the frame.
    blocks = layer_scratch_blocks(spec, device)
    if blocks:
        layers = torch.empty(
            blocks * n_layers * spec.samples * BLOCK_ROWS * BLOCK_LANES,
            dtype=torch.float32, device=device,
        )
        args.layers = layers.data_ptr()
        args.layer_blocks = blocks
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.coverage_raster_launch(ctypes.byref(args), stream)
        captured = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"coverage_raster launch failed: CUDA error {err}")
    # The frame record's counters: a launch made while the stream is
    # captured into a CUDA graph runs only when the graph replays, and
    # whoever replays it adds its captured launches on every replay
    # (renderer._FrameStep).
    RECORD.count("raster_captures" if captured else "raster_launches")
    return out


#: The rounding term of the cull margin (coverage_raster.cu's note):
#: 2^-18 = 64u and 2^-20 = 16u, with u = 2^-24 the unit roundoff.
CULL_EPS = 2.0 ** -18
CULL_AREA_EPS = 2.0 ** -20


def _cull_boxes(rf, coord):
    """The boxes the kernel culls by (``cull_box``): each entry's
    RF_AABB widened by one pixel plus a rounding term and by half a
    pixel, (x0, y0, x1, y1) of shape rf.shape[:-1].  ``coord`` bounds
    every pixel coordinate of the grid (its width plus its height plus
    one).  A pixel whose centre lies outside its entry's box has no
    sample that passes the entry's three edge tests.  The kernel's
    arithmetic, step for step (a NaN keeps the entry)."""
    x0, y0, x1, y1 = (rf[..., RF_AABB + i] for i in range(4))
    w = x1 - x0
    h = y1 - y0
    n = rf[..., :8].abs()
    norm = ((n[..., 0] + n[..., 1]) + (n[..., 3] + n[..., 4])) + (n[..., 6] + n[..., 7])
    xm = torch.fmax(torch.fmax(x0.abs(), x1.abs()), torch.fmax(y0.abs(), y1.abs())) + coord
    inv_area = rf[..., RF_INV_AREA]
    slack = CULL_AREA_EPS * (w * h) * inv_area
    k = torch.where(
        (slack < 0.5) & (inv_area > 0.0), CULL_EPS * xm * norm * inv_area, math.inf
    )
    mx = 1.5 + k * w
    my = 1.5 + k * h
    return x0 - mx, y0 - my, x1 + mx, y1 + my


#: The edge reject's margin (coverage_raster.cu's note): 2^-20 = 16u of
#: the edge function's magnitude, and 2^-100 for underflow.
EDGE_EPS = 2.0 ** -20
EDGE_TINY = 2.0 ** -100


def _edge_reject(rf, rect, coord):
    """The kernel's edge reject (``edge_reject``): True where one of the
    entry's three edge functions, at the corner of a warp's sample
    footprint that maximises it, lies below minus its rounding margin, so
    that no sample of the warp passes that edge's test.  rf (..., D_F)
    rows; rect the warps' rectangles of pixel centres (x_lo, y_lo, x_hi,
    y_hi), each broadcast against rf.shape[:-1], whose footprint is
    [x_lo - 1/2, x_hi + 1/2] x [y_lo - 1/2, y_hi + 1/2]; ``coord`` as for
    _cull_boxes.  The kernel's arithmetic, step for step (a NaN rejects
    nothing)."""
    x_lo, y_lo, x_hi, y_hi = rect
    out = None
    for k in range(3):
        a, b, c = (rf[..., 3 * k + i] for i in range(3))
        x = torch.where(a > 0.0, x_hi + 0.5, x_lo - 0.5)
        y = torch.where(b > 0.0, y_hi + 0.5, y_lo - 0.5)
        e = a * x + b * y + c
        margin = EDGE_EPS * ((a.abs() + b.abs()) * coord + c.abs()) + EDGE_TINY
        rejected = e < -margin
        out = rejected if out is None else out | rejected
    return out


def _edges(rf, ri, pxc, pyc):
    """Edge coefficients a, b (each (T, B, 1)), the edge functions at the
    pixel centres e (T, B, P) and the top-left flags, of a batch of
    entries: rf (T, B, D_F), ri (T, B, D_I), pxc/pyc (T, 1, P)."""
    a = [rf[..., 3 * k:3 * k + 1] for k in range(3)]
    b = [rf[..., 3 * k + 1:3 * k + 2] for k in range(3)]
    e = [a[k] * pxc + b[k] * pyc + rf[..., 3 * k + 2:3 * k + 3] for k in range(3)]
    flags = ri[..., RI_FLAGS:RI_FLAGS + 1]
    return a, b, e, [(flags & (1 << k)) != 0 for k in range(3)]


def _inside(edges, dx, dy):
    """The three edge tests, with the top-left tie rule, at the sample
    offset (dx, dy) from each pixel centre: (T, B, P) bool."""
    a, b, e, tl = edges
    inside = None
    for k in range(3):
        nt = -(a[k] * dx + b[k] * dy)
        test = (e[k] > nt) | ((e[k] == nt) & tl[k])
        inside = test if inside is None else inside & test
    return inside


def _fill_delta(rf, ri, ok, class_code, pxc, pyc, offsets, walk=None):
    """Winding deltas (T, S, P) of a batch of fill entries: rf (T, B,
    D_F), ri (T, B, D_I), ok (T, B) marks the entries inside their
    range; pxc/pyc (T, 1, P) pixel centres; ``walk`` (T, B, P), where
    given, the pixels whose warp walks the entry (the others take no
    update).  The arithmetic and its order are the kernel's, step for
    step."""

    def cf(i):
        return rf[..., i:i + 1]                          # (T, B, 1)

    edges = _edges(rf, ri, pxc, pyc)
    (a0, a1, a2), (b0, b1, b2), (e0, e1, e2), _ = edges
    contrib = torch.where(ok, ri[..., RI_CONTRIB], 0)[..., None]
    n_ch = {CLS_FILL_SOLID: 0, CLS_FILL_QUAD: 3, CLS_FILL_CUBIC: 4}[class_code]
    if n_ch:
        inv_area = cf(RF_INV_AREA)
        l0 = e0 * inv_area
        l1 = e1 * inv_area
        l2 = e2 * inv_area
        aw = [[cf(RF_AW + 4 * k + ch) for k in range(3)] for ch in range(n_ch)]
        ch_c = [l0 * w[0] + l1 * w[1] + l2 * w[2] for w in aw]
        gx = [inv_area * (a0 * w[0] + a1 * w[1] + a2 * w[2]) for w in aw]
        gy = [inv_area * (b0 * w[0] + b1 * w[1] + b2 * w[2]) for w in aw]
    deltas = []
    for ox, oy in offsets:
        dx = float(ox) - 0.5
        dy = float(oy) - 0.5
        keep = _inside(edges, dx, dy)
        if walk is not None:
            keep = keep & walk
        if n_ch:
            xs, ys, zs = (
                ch_c[k] + (gx[k] * dx + gy[k] * dy) for k in range(3)
            )
            if n_ch == 3:
                keep = keep & (xs * xs - ys * zs <= 0.0)
            else:
                ws = ch_c[3] + (gx[3] * dx + gy[3] * dy)
                keep = keep & (xs * xs * xs - ys * zs * ws <= 0.0)
        deltas.append(torch.where(keep, contrib, 0).sum(1, dtype=torch.int32))
    return torch.stack(deltas, 1)


def _sqrt(x):
    """The correctly rounded float32 square root (the kernel's sqrtf and
    the reference's XLA sqrt): torch.sqrt on the CPU may be off by one
    ulp, so the root is taken in float64 and rounded once to float32,
    which is exact for float32 inputs."""
    return torch.sqrt(x.double()).to(x.dtype)


def _remainder(a, b):
    """jnp.remainder for floats: the truncated fmod, moved into the sign
    of ``b`` (exact, as the kernel's fmodf and sign fix)."""
    m = torch.fmod(a, b)
    return torch.where((m != 0.0) & ((m < 0.0) != (b < 0.0)), m + b, m)


def _atan2(y, x):
    """The reference's atan2: a degree-17 odd minimax polynomial on
    [0, 1] and an octant reduction, op for op (the kernel's
    ``atan2_poly``; never the library atan2)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = lo / torch.clamp(hi, min=1e-30)
    s = a * a
    r = s * 2.90188402868554e-3 - 1.62907683983662e-2
    r = r * s + 4.30330487210615e-2
    r = r * s - 7.53012846110272e-2
    r = r * s + 1.06614349190831e-1
    r = r * s - 1.42070654521002e-1
    r = r * s + 1.99934912843697e-1
    r = r * s - 3.33331017859204e-1
    r = r * s * a + a
    r = torch.where(ay > ax, 0.5 * math.pi - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def _cap_mask(cap_type, tex_x, tex_y):
    """The analytic cap predicates (shaders.wgsl:165-189) as a
    where-chain over every cap type; ``cap_type`` is per entry or per
    sample.  For one cap type this is the reference's
    ``_cap_mask_scalar`` as well: both give the case's boolean."""
    ax = torch.abs(tex_x)
    out = (cap_type == int(Cap.BUTT)) & (tex_y < 0.0)
    cases = (
        tex_y <= 0.5,                                   # SQUARE
        tex_x * tex_x + tex_y * tex_y < 0.25,           # ROUND
        0.5 - tex_y > ax,                               # OUT
        tex_y < ax,                                     # IN
        0.5 - tex_y > tex_x,                            # RIGHT
        tex_y - 0.5 < tex_x,                            # LEFT
    )
    for value, case in enumerate(cases):
        out = out | ((cap_type == value) & case)
    return out


def _dash_mask_single(df, di, tex_x, tex_y):
    """Dashed coverage for a single-interval pattern; ``df``/``di`` are
    the entries' descriptor rows (..., DESC_F) and (..., DESC_I)."""
    pattern_len = df[..., 4:5]
    position = _remainder(tex_y - df[..., 8:9], pattern_len)
    past = position - df[..., 0:1]
    in_dash = past <= 0.0
    cap_a = _cap_mask(di[..., 0:1], tex_x, past)
    cap_b = _cap_mask(di[..., 4:5], tex_x, pattern_len - position)
    return in_dash | cap_a | cap_b


def _dash_mask_general(df, di, tex_x, tex_y):
    """Dashed coverage (shaders.wgsl:205-231) at pattern position
    ``tex_y``: the interval search and per-sample cap types."""
    last = di[..., 8:9]
    phase = df[..., 8:9]
    gap_start = [df[..., i:i + 1] for i in range(MAX_DASH_INTERVALS)]
    gap_end = [df[..., 4 + i:5 + i] for i in range(MAX_DASH_INTERVALS)]
    end_caps = [di[..., i:i + 1] for i in range(MAX_DASH_INTERVALS)]
    start_caps = [di[..., 4 + i:5 + i] for i in range(MAX_DASH_INTERVALS)]
    pattern_len = gap_end[0]
    for i in range(1, MAX_DASH_INTERVALS):
        pattern_len = torch.where(last == i, gap_end[i], pattern_len)
    position = _remainder(tex_y - phase, pattern_len)
    interval = torch.zeros_like(position, dtype=torch.int32) + last
    for i in range(MAX_DASH_INTERVALS - 1, -1, -1):
        hit = (gap_end[i] - position >= 0.0) & (i <= last)
        interval = torch.where(hit, i, interval)
    g_s = torch.zeros_like(position)
    g_e = torch.zeros_like(position)
    e_cap = torch.zeros_like(interval)
    s_cap = torch.zeros_like(interval)
    for i in range(MAX_DASH_INTERVALS):
        sel = interval == i
        g_s = torch.where(sel, gap_start[i], g_s)
        g_e = torch.where(sel, gap_end[i], g_e)
        e_cap = torch.where(sel, end_caps[i], e_cap)
        s_cap = torch.where(sel, start_caps[i], s_cap)
    past = position - g_s
    in_dash = past <= 0.0
    cap_a = _cap_mask(e_cap, tex_x, past)
    cap_b = _cap_mask(s_cap, tex_x, g_e - position)
    return in_dash | cap_a | cap_b


def _stroke_keep(joint, dash_mode, df, di, flags, end_y, tex):
    """Whether each sample's texcoords lie on the stroke: the join
    predicate (joints), the dash pattern, or the start and end caps."""
    dash = (None, _dash_mask_single, _dash_mask_general)[dash_mode]
    if joint:
        radius = _sqrt(tex[0] * tex[0] + tex[1] * tex[1])
        join = di[..., 10:11]
        is_tip = (flags & FLAG_JOINT_TIP) != 0
        is_bevel = join == int(Join.BEVEL)
        is_round = join == int(Join.ROUND)
        # Miter keeps everything, bevel drops tip triangles, round keeps
        # the half-width disc (shaders.wgsl:191-203).
        keep = (
            ((~is_bevel & ~is_round) & (radius >= 0.0))
            | ((is_bevel & ~is_tip) & (radius >= 0.0))
            | (is_round & (radius <= 0.5))
        )
        if dash_mode:
            angle = _atan2(tex[1], tex[0]) * (1.0 / TAU)
            keep = keep & dash(df, di, radius, tex[2] + angle)
        return keep
    if dash_mode:
        return dash(df, di, tex[0], tex[1])
    end_cap = _cap_mask(di[..., 12:13], tex[0], tex[1] - end_y)
    start_cap = _cap_mask(di[..., 11:12], tex[0], -tex[1])
    end_flag = (flags & FLAG_END_CAP) != 0
    return (end_flag & end_cap) | (~end_flag & ((tex[1] >= 0.0) | start_cap))


def _stroke_cover(rf, ri, ok, joint, dash_mode, desc_f, desc_i, pxc, pyc,
                  offsets, walk=None):
    """Per-sample coverage (T, S, P) of a batch of stroke entries of one
    class: rf (T, B, D_F), ri (T, B, D_I), ok (T, B) marks the entries
    inside their range; pxc/pyc (T, 1, P) pixel centres; ``walk`` as
    for _fill_delta.  A sample is
    covered when any entry covers it (the stroke stencil is an OR).
    Perspective-correct texcoords as in the kernel, step for step: the
    linear numerators and 1/w at the pixel centre, shifted to each
    sample, then one divide."""

    def cf(i):
        return rf[..., i:i + 1]                          # (T, B, 1)

    edges = _edges(rf, ri, pxc, pyc)
    ea, eb, ec, _ = edges
    inv_a = cf(RF_INV_AREA)
    lc = [e * inv_a for e in ec]

    def at_centre(w):
        return lc[0] * w[0] + lc[1] * w[1] + lc[2] * w[2]

    def slope(e, w):
        return inv_a * (e[0] * w[0] + e[1] * w[1] + e[2] * w[2])

    n_ch = 3 if joint else 2
    aw = [[cf(RF_AW + 4 * k + cc) for k in range(3)] for cc in range(n_ch)]
    ch_c = [at_centre(w) for w in aw]
    gx = [slope(ea, w) for w in aw]
    gy = [slope(eb, w) for w in aw]
    iwv = [cf(RF_IW + k) for k in range(3)]
    iw_c = at_centre(iwv)
    gxw = slope(ea, iwv)
    gyw = slope(eb, iwv)
    flags = ri[..., RI_FLAGS:RI_FLAGS + 1]
    group = torch.clamp(ri[..., RI_GROUP], 0, desc_f.shape[0] - 1).long()
    df = desc_f[group]                                   # (T, B, DESC_F)
    di = desc_i[group]
    end_y = cf(RF_END_Y)
    covered = []
    for ox, oy in offsets:
        dx = float(ox) - 0.5
        dy = float(oy) - 0.5
        inside = ok[..., None] & _inside(edges, dx, dy)
        if walk is not None:
            inside = inside & walk
        iws = iw_c + (gxw * dx + gyw * dy)
        inv = 1.0 / torch.where(iws != 0.0, iws, 1.0)
        tex = [(ch_c[cc] + (gx[cc] * dx + gy[cc] * dy)) * inv
               for cc in range(n_ch)]
        keep = _stroke_keep(joint, dash_mode, df, di, flags, end_y, tex)
        covered.append((inside & keep).any(1))
    return torch.stack(covered, 1)


def _depth_pass(compare, zval, zbuf):
    """The depth test of the colour cover: where ``compare`` (a
    wgpu::CompareFunction name) passes for the fragment depth ``zval``
    against the buffer."""
    if compare == "never":
        return torch.zeros_like(zval, dtype=torch.bool)
    if compare == "always":
        return torch.ones_like(zval, dtype=torch.bool)
    return {
        "less": torch.lt, "equal": torch.eq, "less_equal": torch.le,
        "greater": torch.gt, "not_equal": torch.ne, "greater_equal": torch.ge,
    }[compare](zval, zbuf)


def _gradient(kind, row, anchor, px, py):
    """Straight RGBA of a gradient paint at the sample positions: t
    along the projected points (1 linear: start to end; 2 radial: centre
    to rim), clipped to [0, 1], through the piecewise-linear ramp of the
    MAX_STOPS stops in ``row`` (colours at columns 0:16, offsets at
    16:20; an empty segment is a hard stop, its length floored at 1e-6).
    The reference's ``_gradient_cover``, op for op."""
    pax, pay = anchor[0], anchor[1]
    pdx = anchor[2] - pax
    pdy = anchor[3] - pay
    pden = torch.clamp(pdx * pdx + pdy * pdy, min=1e-12)
    rel_x = px - pax
    rel_y = py - pay
    if kind == 2:
        t = _sqrt((rel_x * rel_x + rel_y * rel_y) / pden)
    else:
        t = (rel_x * pdx + rel_y * pdy) / pden
    t = torch.clamp(t, 0.0, 1.0)
    fs = [
        torch.clamp(
            (t - row[16 + i]) / torch.clamp(row[17 + i] - row[16 + i], min=1e-6),
            0.0, 1.0,
        )
        for i in range(MAX_STOPS - 1)
    ]
    out = []
    for ch in range(4):
        value = row[ch]
        for i in range(MAX_STOPS - 1):
            value = value + (row[4 * (i + 1) + ch] - row[4 * i + ch]) * fs[i]
        out.append(value)
    return out


#: Entries the plain version evaluates per step (bounds the size of its
#: (tiles, batch, pixels) temporaries).
PLAIN_BATCH = 8


def rasterize_plain(spec, prepared, cmd_i, cmd_f, unit_cmd, unit_draw,
                    desc_f, desc_i, work=None):
    """The plain torch version of coverage_raster (same arguments, same
    output).  Vectorised over tiles: it walks the units in draw order,
    and applies each unit to the tiles whose active list holds it, which
    is the kernel's per-tile walk over ``aclist``.

    ``work``, where given, is a dict that receives how many samples each
    part of the cover bodies needed on this frame (chip_smoke.py's bound
    counts operations from it): ``"hull"``, hull-line tests at the
    samples whose other cover conditions hold; ``"depth"``, depth tests
    at the samples inside the hull with a nonzero winding; ``"blend"``,
    blended samples; ``"paint"``, {cover draw: blended samples} for
    non-solid paints; ``"alpha"``, {op: updated samples} for alpha ops.
    It also receives what the kernel skips per block of 256 pixels
    (``block_rects``) and per warp of 32 (``warp_pixels``):
    ``"clip_skipped"``, the (warp, unit) pairs of units other than clip
    and unclip that the clip vote skips, where no sample of the warp has
    a clip counter equal to the unit's depth (frames with clip ops);
    ``"entry_blocks"``, the (block, entry) pairs of the binned stroke and
    fill entries (what a block staging every row would stage);
    ``"staged_rows"``,
    those the block's staging keeps (the entry's ``_cull_boxes`` box
    meets the block's rectangle of pixel centres); ``"entry_warps"``,
    the (warp, entry) pairs of the binned entries; ``"culled"``, those
    of warps the clip vote kept that the box test culls (the box meets
    not the warp's rectangle of pixel centres); ``"edge_rejected"``, the
    stroke pairs of warps the clip vote kept, in the box, that the edge
    reject drops (``_edge_reject``); ``"walked"``, the (warp, entry)
    pairs a warp walks; ``"stroke_pairs"``, the stroke pairs walked, and
    ``"inside_pairs"``, those with a sample that some lane of the warp
    has inside the entry; ``"stroke_samples"``, the stroke sample
    evaluations (32·S per stroke pair walked); ``"vote_skipped"``, those
    the warp vote skips (32 for each sample that no pixel of the warp
    has inside the entry); ``"keep_lanes"``, the (lane, sample) pairs of
    walked stroke pairs inside the entry, whose predicates must run;
    ``"keep_slots_sample"``, the lane slots that the kernel's walk of the
    samples some lane has inside spends on them (32 a sample);
    ``"fill_pairs"``, the quadratic and cubic
    fill pairs walked, and ``"fill_pairs_outside"``, those with no sample
    inside (their curve weights change nothing);
    ``"cover_warps"``, the (warp, colour unit) pairs that
    reach the cover vote (the unit's hull meets the tile, the clip vote
    kept the warp); ``"cover_skipped"``, those the cover vote skips, where
    no sample of the warp passes the cover mask (hull, winding, clip,
    depth).  With ``work`` the skips are modelled: a skipped warp takes
    no update of the unit, and a warp takes no update of an entry that
    its block's staging, its box test or its edge reject dropped, which
    leaves the image as it is."""
    dev = prepared.tri_f.device
    f32, i32 = torch.float32, torch.int32
    S = spec.samples
    n_tiles, th, tw = spec.n_tiles, spec.tile_h, spec.tile_w
    lw, lh, strips = spec.screen_tile_w, spec.screen_tile_h, spec.tile_strips
    P = th * tw
    U = unit_cmd.shape[0]
    offsets = SAMPLE_PATTERNS[S]
    winding_mask = (1 << spec.winding_bits) - 1
    blend_color, blend_alpha = _canonical_blend(spec.blending)
    uses_const = blend_uses_constant(spec.blending)
    has_clip, has_alpha = clip_alpha_ops(spec)
    n_layers = max(1, spec.n_layers)
    with_depth = has_depth(spec)
    user_fns = [p.fn for p in user_paints(spec)]

    # Pixel coordinates of each lane (strip layout: lane l of row r is
    # screen pixel (x0 + l % lw, y0 + (l // lw)·th + r)).
    p = torch.arange(P, device=dev)
    row_i, col_i = p // tw, p % tw
    if strips == 1:
        col, row = col_i.to(f32), row_i.to(f32)
    else:
        col = (col_i % lw).to(f32)
        row = ((col_i // lw) * th + row_i).to(f32)
    t = torch.arange(n_tiles, device=dev)
    tile_x0 = (t % spec.ntx).to(f32)[:, None] * lw
    tile_y0 = (t // spec.ntx).to(f32)[:, None] * lh
    bx = tile_x0 + col                                   # (T, P)
    by = tile_y0 + row
    pxc = (bx + 0.5)[:, None, :]
    pyc = (by + 0.5)[:, None, :]
    px = torch.stack([bx + float(ox) for ox, _ in offsets], 1)  # (T, S, P)
    py = torch.stack([by + float(oy) for _, oy in offsets], 1)
    warps = warp_pixels(th, tw).to(dev)                  # (P / 32, 32)
    coord = spec.ntx * lw + spec.nty * lh + 1

    def centres(rects):
        rects = rects.to(dev).float()
        return (
            tile_x0 + rects[:, 0] + 0.5, tile_y0 + rects[:, 1] + 0.5,
            tile_x0 + rects[:, 2] + 0.5, tile_y0 + rects[:, 3] + 0.5,
        )

    # Each warp's and each block's rectangle of pixel centres as the
    # kernel computes them, (T, W) and (T, NB); the warp of each pixel and
    # the block of each warp.
    warp_rect = centres(warp_rects(spec))
    block_rect = centres(block_rects(spec))
    n_warps = P // 32
    warp_of = torch.empty(P, dtype=torch.long, device=dev)
    warp_of[warps.reshape(-1)] = torch.arange(n_warps, device=dev).repeat_interleave(32)
    warp_block = torch.arange(n_warps, device=dev) // (BLOCK_ROWS * BLOCK_LANES // 32)
    stroke_codes = {code for code, _, _ in STROKE_CLASSES}

    # active[t, u]: unit u is in tile t's active list.
    k = torch.arange(U, device=dev)
    acount = prepared.acount.reshape(n_tiles, 1)
    listed = torch.where(
        k[None, :] < acount, prepared.aclist.reshape(n_tiles, U).long(), U
    )
    active = torch.zeros((n_tiles, U + 1), dtype=torch.bool, device=dev)
    active.scatter_(1, listed, True)
    active = active[:, :U]

    wind = torch.zeros((n_tiles, S, P), dtype=i32, device=dev)
    color = torch.zeros((4, n_tiles, S, P), dtype=f32, device=dev)
    clip = torch.zeros((n_tiles, S, P), dtype=i32, device=dev) if has_clip else None
    layer = (
        torch.zeros((n_layers, n_tiles, S, P), dtype=f32, device=dev)
        if has_alpha else None
    )
    # The reference render pass clears depth to 1.0.
    zbuf = torch.ones((n_tiles, S, P), dtype=f32, device=dev) if with_depth else None
    off = prepared.off.reshape(n_tiles, -1).long()
    g_off = prepared.g_off.reshape(n_tiles, -1).long()
    tables = (
        (prepared.tri_f, prepared.tri_i, off),
        (prepared.g_tri_f, prepared.g_tri_i, g_off),
    )

    def batches(sel, code):
        """(rows_f, rows_i, ok) of the class-``code`` entries of the
        tiles ``sel``, local then global, PLAIN_BATCH at a time."""
        for rows_f, rows_i, ranges in tables:
            lo = ranges[sel, code]
            hi = ranges[sel, code + 1]
            n = int((hi - lo).max())
            for j0 in range(0, n, PLAIN_BATCH):
                j = lo[:, None] + j0 + torch.arange(PLAIN_BATCH, device=dev)
                ok = j < hi[:, None]
                j = torch.clamp(j, max=rows_f.shape[1] - 1)
                yield rows_f[sel[:, None], j], rows_i[sel[:, None], j], ok

    def walk_mask(sel, rf, ri, ok, code, live):
        """The kernel's stencil walk on one batch of entries of class
        ``code`` (``work``'s stencil counts): the block's staging, the
        warp's box test and, for strokes, its edge reject; the warp vote
        of strokes, and the curve pairs with no sample inside.  ``live``
        (T, P / 32) marks the warps that the clip vote kept.  Returns the
        pixels whose warp walks each entry, (T, B, P)."""
        box = [v[..., None] for v in _cull_boxes(rf, coord)]  # (T, B, 1)

        def meets(rect):
            x0, y0, x1, y1 = (v[sel][:, None, :] for v in rect)
            return ~((box[2] < x0) | (box[0] > x1) | (box[3] < y0) | (box[1] > y1))

        staged = ok[..., None] & meets(block_rect)          # (T, B, NB)
        in_box = meets(warp_rect)                            # (T, B, W)
        kept = ok[..., None] & live[:, None, :]
        count("entry_blocks", ok.sum() * staged.shape[-1])
        count("staged_rows", staged.sum())
        count("entry_warps", ok.sum() * n_warps)
        count("culled", (kept & ~in_box).sum())
        walked = kept & in_box & staged[..., warp_block]
        stroke = code in stroke_codes
        if stroke:
            rejected = _edge_reject(
                rf[..., None, :], [v[sel][:, None] for v in warp_rect], coord
            )
            count("edge_rejected", (walked & rejected).sum())
            walked = walked & ~rejected
        count("walked", walked.sum())
        if stroke or code != CLS_FILL_SOLID:
            edges = _edges(rf, ri, pxc[sel], pyc[sel])
            pairs = voted = 0
            for ox, oy in offsets:
                inside = _inside(edges, float(ox) - 0.5, float(oy) - 0.5)[..., warps]
                pairs = pairs + inside.sum(-1)               # (T, B, W)
                voted = voted + inside.any(-1).long()
            n = walked.sum()
            if stroke:
                count("stroke_pairs", n)
                count("inside_pairs", (walked & (pairs > 0)).sum())
                count("stroke_samples", n * 32 * S)
                count("vote_skipped", ((S - voted) * walked).sum() * 32)
                count("keep_lanes", (pairs * walked).sum())
                count("keep_slots_sample", (voted * walked).sum() * 32)
            else:
                count("fill_pairs", n)
                count("fill_pairs_outside", (walked & (voted == 0)).sum())
        return walked[..., warp_of]

    def stencil(sel, c, w, clip_ok, live):
        base = N_CLASSES * c
        pxs, pys = pxc[sel], pyc[sel]
        for code, joint, dash_mode in STROKE_CLASSES:
            for rf, ri, ok in batches(sel, base + code):
                walk = None if work is None else walk_mask(sel, rf, ri, ok, code, live)
                cov = _stroke_cover(
                    rf, ri, ok, joint, dash_mode, desc_f, desc_i, pxs, pys,
                    offsets, walk,
                )
                if clip_ok is not None:
                    cov = cov & clip_ok
                w = torch.where(cov & (w == 0), 1, w)
        for code in FILL_CLASSES:
            for rf, ri, ok in batches(sel, base + code):
                walk = None if work is None else walk_mask(sel, rf, ri, ok, code, live)
                delta = _fill_delta(rf, ri, ok, code, pxs, pys, offsets, walk)
                if clip_ok is not None:
                    delta = torch.where(clip_ok, delta, 0)
                w = w + delta
        bulk = prepared.bulk[sel, 0, c][:, None, None]
        if clip_ok is not None:
            bulk = torch.where(clip_ok, bulk, 0)
        return w + bulk

    def hull_mask(sel, d):
        """Samples of the tiles ``sel`` inside cover draw d's hull."""
        cl = prepared.cls[sel, 0, d]
        in_hull = (cl == 2)[:, None, None].expand(len(sel), S, P)
        boundary = cl == 1
        if bool(boundary.any()):
            bits = prepared.hbits[sel, 0, d]
            lines = prepared.hull_lines[d]
            pxs, pys = px[sel], py[sel]
            ok = torch.ones((len(sel), S, P), dtype=torch.bool, device=dev)
            for h in range(lines.shape[0]):
                use = ((bits >> h) & 1) != 0
                if not bool((use & boundary).any()):
                    continue
                he = lines[h, 0] * pxs + lines[h, 1] * pys + lines[h, 2]
                ok = ok & (~use[:, None, None] | (he >= 0.0))
            in_hull = in_hull | (boundary[:, None, None] & ok)
        return in_hull

    def count(key, n, sub=None):
        if sub is None:
            work[key] = work.get(key, 0) + int(n)
        else:
            table = work.setdefault(key, {})
            table[sub] = table.get(sub, 0) + int(n)

    def count_hull(sel, d, pre):
        """Hull-line tests of the samples ``pre`` in draw d's boundary
        tiles: one per line set in the tile's ``hbits``."""
        bits = prepared.hbits[sel, 0, d].long() & 0xFFFFFFFF
        lines = sum((bits >> h) & 1 for h in range(prepared.hull_lines.shape[1]))
        lines = lines * (prepared.cls[sel, 0, d] == 1)
        if pre is None:
            count("hull", lines.sum() * S * P)
        else:
            count("hull", (lines[:, None, None] * pre).sum())

    unit_cmd_h = unit_cmd.tolist()
    unit_draw_h = unit_draw.tolist()
    cmd_i_h = cmd_i.tolist()
    for u in range(U):
        c, d = unit_cmd_h[u], unit_draw_h[u]
        op, depth, layer_ix = cmd_i_h[c][:3]
        if not has_clip and depth != 0:
            continue
        sel = torch.nonzero(active[:, u]).reshape(-1)
        if sel.numel() == 0:
            continue
        w = wind[sel]
        clip_ok = (clip[sel] == depth) if has_clip else None
        # The warps that the kernel's clip vote keeps: those with a
        # sample at the unit's clip depth (clip and unclip take no vote).
        live = None
        if work is not None:
            live = torch.ones((len(sel), P // 32), dtype=torch.bool, device=dev)
            if has_clip and op not in (OP_CLIP, OP_UNCLIP):
                live = clip_ok.any(1)[:, warps].any(-1)
                count("clip_skipped", (~live).sum())
        if op == OP_STENCIL:
            wind[sel] = stencil(sel, c, w, clip_ok, live)
            continue
        in_hull = hull_mask(sel, d)
        nonzero = (w & winding_mask) != 0
        ca = cmd_f[d, 3]
        if op == OP_COLOR:
            pre = nonzero if clip_ok is None else nonzero & clip_ok
            mask = in_hull & pre
            if work is not None:
                count_hull(sel, d, pre)
                if with_depth:
                    count("depth", mask.sum())
            if with_depth:
                zp = prepared.zplane[d]
                zval = zp[0] * px[sel] + zp[1] * py[sel] + zp[2]
                mask = mask & _depth_pass(spec.depth_compare, zval, zbuf[sel])
            if work is not None:
                # The kernel's cover vote, among the warps of the tiles
                # this draw's hull meets that the clip vote kept: a warp
                # with no sample in the mask skips paint, blend, winding
                # reset and depth write.  Modelled: such a warp takes no
                # update at all.
                reached = live & (prepared.cls[sel, 0, d] != 0)[:, None]
                voted = mask.any(1)[:, warps].any(-1)       # (T, P / 32)
                count("cover_warps", reached.sum())
                count("cover_skipped", (reached & ~voted).sum())
                kept = torch.zeros((len(sel), P), dtype=torch.bool, device=dev)
                kept[:, warps.reshape(-1)] = voted.repeat_interleave(32, 1)
                mask = mask & kept[:, None, :]
            row = cmd_f[d]
            pk = cmd_i_h[c][3]
            if work is not None:
                count("blend", mask.sum())
                if pk != 0:
                    count("paint", mask.sum(), d)
            if pk == 0:
                src, sa = (row[0] * ca, row[1] * ca, row[2] * ca, ca), ca
            else:
                anchor = tuple(prepared.paint_xy[d])
                if pk >= 3:
                    rgba = user_fns[pk - 3](px[sel], py[sel], anchor)
                else:
                    rgba = _gradient(pk, row, anchor, px[sel], py[sel])
                rgba = torch.broadcast_tensors(
                    *(torch.as_tensor(v, dtype=f32, device=dev) for v in rgba),
                    mask,
                )[:4]
                sa = rgba[3]
                src = (rgba[0] * sa, rgba[1] * sa, rgba[2] * sa, sa)
            const = tuple(row[20:24]) if uses_const else None
            dst = color[:, sel]
            color[:, sel] = torch.stack([
                torch.where(
                    mask,
                    _blend_channel(
                        blend_alpha if chan == 3 else blend_color,
                        src[chan], dst[chan], sa, dst[3], chan, const,
                    ),
                    dst[chan],
                )
                for chan in range(4)
            ])
            wind[sel] = torch.where(mask, 0, w)
            if with_depth and spec.depth_write:
                zbuf[sel] = torch.where(mask, zval, zbuf[sel])
        elif op in (OP_CLIP, OP_UNCLIP):
            # Clip promotes winding != 0 into the clip counter, unclip
            # demotes deeper samples; neither is gated by clip_ok.
            cd = clip[sel]
            pre = nonzero if op == OP_CLIP else cd > depth
            mask = in_hull & pre
            if work is not None:
                count_hull(sel, d, pre)
            clip[sel] = torch.where(mask, depth, cd)
            wind[sel] = torch.where(mask, 0, w)
        elif op in ALPHA_OPS:
            mask = in_hull if clip_ok is None else in_hull & clip_ok
            if work is not None:
                count_hull(sel, d, clip_ok)
                count("alpha", mask.sum(), op)
            # _validate bounds the layer of every alpha op; the clamp
            # keeps an unvalidated one inside the state, as the kernel.
            li = min(max(layer_ix, 0), n_layers - 1)
            a0 = color[3, sel]
            saved = layer[li, sel]
            if op in (OP_SAVE_ALPHA, OP_SAVE_SCALE):
                layer[li, sel] = torch.where(mask, a0, saved)
            if op in (OP_SCALE_ALPHA, OP_SAVE_SCALE):
                color[3, sel] = torch.where(mask, (1.0 - ca) + ca * a0, a0)
            if op == OP_RESTORE_ALPHA:
                color[3, sel] = torch.where(
                    mask, a0 - (1.0 - saved) * (1.0 - ca), a0
                )

    # Resolve: the sample mean, summed in sample order as the kernel does.
    inv_s = 1.0 / S
    resolved = []
    for chan in range(4):
        acc = torch.zeros((n_tiles, P), dtype=f32, device=dev)
        for s in range(S):
            acc = acc + color[chan, :, s]
        resolved.append(acc * inv_s)
    if spec.out_uint8:
        q = torch.stack(
            [
                torch.floor(torch.clamp(v, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
                for v in resolved
            ],
            -1,
        )                                                # (T, P, 4)
        # Little-endian RGBA8 quads reinterpreted as one int32 per pixel.
        return q.view(torch.int32).reshape(n_tiles, th, tw)
    return torch.stack(resolved, 1).reshape(n_tiles, 4, th, tw)


def make_rasterize(spec: FrameSpec):
    """``rasterize(prepared, cmd_i, cmd_f, desc_f, desc_i, out=None)``:
    the frame, float (H, W, 4) or, with ``spec.out_uint8``, uint8 (H, W,
    4); ``out`` where given (a contiguous tensor of that shape and type,
    aligned to a pixel), which the kernel then writes in place."""
    draws = _raster_plan(spec)[0]
    W, H = spec.width, spec.height
    units = {}

    def rasterize(prepared: PreparedFrame, cmd_i, cmd_f, desc_f, desc_i,
                  out=None):
        dev = prepared.tri_f.device
        if dev not in units:
            units[dev] = (
                torch.as_tensor(draws.unit_cmd, device=dev),
                torch.as_tensor(draws.unit_draw, device=dev),
            )
        if out is not None and spec.out_uint8:
            if out.dtype != torch.uint8 or tuple(out.shape) != (H, W, 4):
                raise ValueError(f"out must be uint8 {(H, W, 4)}")
            out = out.view(torch.int32).reshape(H, W)
        image = coverage_raster(
            spec, prepared, cmd_i, cmd_f, *units[dev], desc_f, desc_i, out=out
        )
        if spec.out_uint8:
            # Packed little-endian RGBA8: the bytes of each pixel.
            return image.view(torch.uint8).reshape(H, W, 4)
        return image

    return rasterize
