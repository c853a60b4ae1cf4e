"""The rendering interface of the PyTorch/CUDA port: Configuration,
Shape, DrawCommand, Renderer.

The counterpart of ``contrast_renderer_tpu/renderer.py``, with the same
names and attributes.  A frame runs in three stages:

1. *Scene packing* (host, cached per shape set): the shapes' triangle
   tables and hulls are padded, stacked and copied to the renderer's
   device once.
2. *prepare* (torch, cached per transform set): triangle setup and tile
   binning (``ops/coverage.make_prepare``).
3. *rasterize* (every frame): the CUDA kernel walks each tile's command
   list with per-sample winding and colour held in registers
   (``ops/coverage.make_rasterize``); on a CPU device its plain torch
   version runs instead.

The port renders filled and stroked paths (solid and dashed strokes,
all caps and joins) with solid colour, linear and radial gradients and
user paints, under any depth state, inside nested clips and alpha
groups.  As in the reference, the machinery of a balanced clip or
alpha bracket is dropped from the tiles that no content draw of the
frame touches (``_gate_spans``, ``FrameSpec.gate_spans``), which
changes no pixel.

``Renderer.compile_frame`` returns a ``FrameProgram``, the moving-camera
path: the transforms become a per-call input, each call bins and
rasterizes its frame, and fusable runs regroup under each frame's
transforms (or once for a whole camera path, ``plan_for_motion``).
"""

from __future__ import annotations

import enum
import gc
import hashlib
import logging
import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dynamic_stroke as ds
from . import native
from .convex_hull import andrew, outer_polygon
from .error import (
    ClipStackOverflow,
    DynamicStrokeOptionsIndexOutOfBounds,
    NumberOfStencilBitsIsUnsupported,
    TooManyNestedOpacityGroups,
    require_finite,
)
from .fill import FillBuilder
from .ops import coverage
from .path import DynamicStrokeOptions, Path, SegmentType
from .stroke import StrokeBuilder
from .utils.profiling import LAUNCH_COUNTERS, RECORD, Capture, Span
from .vertex import (
    KIND_INTEGRAL_QUADRATIC, KIND_SOLID, KIND_STROKE_LINE, TriangleTable,
)

logger = logging.getLogger("contrast_renderer_tpu_torch")


class RenderOperation(enum.IntEnum):
    """What a draw command does (reference renderer.rs:143-160)."""

    STENCIL = 0
    CLIP = 1
    UNCLIP = 2
    COLOR = 3
    SAVE_ALPHA_CONTEXT = 4
    SCALE_ALPHA_CONTEXT = 5
    RESTORE_ALPHA_CONTEXT = 6


#: The wgpu::BlendFactor set (see the reference's BLEND_FACTORS).
BLEND_FACTORS = (
    "zero",
    "one",
    "src_alpha",
    "one_minus_src_alpha",
    "dst_alpha",
    "one_minus_dst_alpha",
    "src_alpha_saturated",
    "constant",
    "one_minus_constant",
)
#: wgpu::CompareFunction names accepted by Configuration.depth_compare.
DEPTH_COMPARE_FUNCTIONS = (
    "never",
    "less",
    "equal",
    "less_equal",
    "greater",
    "not_equal",
    "greater_equal",
    "always",
)
#: Blend operations (wgpu::BlendOperation); min/max ignore the factors.
BLEND_OPERATIONS = ("add", "subtract", "reverse_subtract", "min", "max")


@dataclass(frozen=True)
class BlendComponent:
    """src/dst factor + operation for one channel group:
    ``out = op(src·src_factor, dst·dst_factor)`` on premultiplied
    values."""

    src_factor: str = "one"
    operation: str = "add"
    dst_factor: str = "one_minus_src_alpha"

    def __post_init__(self):
        if self.src_factor not in BLEND_FACTORS:
            raise ValueError(f"unknown blend factor {self.src_factor!r}")
        if self.dst_factor not in BLEND_FACTORS:
            raise ValueError(f"unknown blend factor {self.dst_factor!r}")
        if self.operation not in BLEND_OPERATIONS:
            raise ValueError(f"unknown blend operation {self.operation!r}")


@dataclass(frozen=True)
class BlendState:
    """A full wgpu-style blend state: independent color and alpha
    components."""

    color: BlendComponent = BlendComponent()
    alpha: BlendComponent = BlendComponent()

    def canonical(self):
        """Hashable static encoding carried by FrameSpec.blending."""
        c, a = self.color, self.alpha
        return (
            (c.src_factor, c.operation, c.dst_factor),
            (a.src_factor, a.operation, a.dst_factor),
        )


#: Gradient stop budget per paint (the kernel's unrolled ramp).
MAX_GRADIENT_STOPS = coverage.MAX_STOPS


def _normalize_stops(color0, color1, stops):
    """(offsets (4,), colors (4, 4)) from either the 2-color shorthand
    or an explicit ``stops`` sequence of (offset, rgba)."""
    if stops is None:
        stops = ((0.0, color0), (1.0, color1))
    if not 2 <= len(stops) <= MAX_GRADIENT_STOPS:
        raise ValueError(
            f"gradients take 2..{MAX_GRADIENT_STOPS} stops, got {len(stops)}"
        )
    offsets = np.asarray([s[0] for s in stops], np.float32)
    if np.any(np.diff(offsets) < 0.0):
        raise ValueError("gradient stop offsets must be non-decreasing")
    if offsets[0] < 0.0 or offsets[-1] > 1.0:
        # The kernel clamps t to [0, 1]; stops outside it are
        # unreachable or degenerate.
        raise ValueError("gradient stop offsets must lie in [0, 1]")
    colors = np.asarray([s[1] for s in stops], np.float32)
    if colors.shape != (len(stops), 4):
        raise ValueError("gradient stop colors must be RGBA")
    pad = MAX_GRADIENT_STOPS - len(stops)
    offsets = np.concatenate([offsets, np.repeat(offsets[-1:], pad)])
    colors = np.concatenate([colors, np.repeat(colors[-1:], pad, axis=0)])
    return offsets, colors


@dataclass(frozen=True)
class LinearGradient:
    """Linear gradient paint for COLOR covers: ``start``/``end`` are
    model-space points, projected with the draw's transform; the paint
    ramps from ``color0`` at or before ``start`` to ``color1`` at or
    after ``end``, per MSAA sample, then is premultiplied.  ``stops``
    (up to MAX_GRADIENT_STOPS ``(offset, rgba)`` pairs, offsets
    non-decreasing in [0, 1]) replaces the 2-color shorthand.  Pass as
    ``DrawCommand(color=LinearGradient(...))``."""

    start: Tuple[float, float]
    end: Tuple[float, float]
    color0: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    color1: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    stops: object = None
    kind = 1

    def __post_init__(self):
        self.stop_table()  # validate stop count and order at construction

    def points(self):
        return np.asarray([self.start, self.end], np.float32)

    def stop_table(self):
        return _normalize_stops(self.color0, self.color1, self.stops)


@dataclass(frozen=True)
class RadialGradient:
    """Radial gradient paint: ``color0`` at ``center`` ramping to
    ``color1`` at or beyond the rim point ``edge`` (model space; a rim
    point, not a radius, projects correctly under the draw transform).
    ``stops`` as in :class:`LinearGradient`, offsets centre to rim."""

    center: Tuple[float, float]
    edge: Tuple[float, float]
    color0: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    color1: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    stops: object = None
    kind = 2

    def __post_init__(self):
        self.stop_table()  # validate stop count and order at construction

    def points(self):
        return np.asarray([self.center, self.edge], np.float32)

    def stop_table(self):
        return _normalize_stops(self.color0, self.color1, self.stops)


class UserPaint:
    """A user-defined paint of screen position, for COLOR covers: the
    reference's user-defined fragment shaders, as a function evaluated
    per MSAA sample inside the colour cover.  It comes in two forms, one
    per device:

    - ``fn(px, py, anchor) -> (r, g, b, a)`` runs with the plain version
      on the CPU: ``px``/``py`` are float32 tensors of sample positions
      in pixels, ``anchor`` four scalar tensors (x0, y0, x1, y1), the two
      model-space ``points`` projected through the draw's transform per
      instance, as gradient endpoints are.  It returns straight
      (non-premultiplied) RGBA, tensors or floats broadcastable against
      ``px``, computed elementwise in float32.
    - ``cuda`` runs in the kernel on the card: the CUDA C++ source of
      ``__device__ float4 paint(float px, float py, float x0, float y0,
      float x1, float y1)`` returning the same straight RGBA, built
      with ``--fmad=false`` into the kernel (each distinct source once,
      keyed by its text).  Render it on a CUDA device only with it: a
      UserPaint without ``cuda`` raises there before anything runs.

    The two should compute the same function, step for step, for the
    card to match the CPU.  The kernel premultiplies by the returned
    alpha and feeds the active blend state.  UserPaints sharing one
    ``fn`` object share a paint code (the anchor stays per draw)."""

    kind = 3

    def __init__(self, fn, points=((0.0, 0.0), (1.0, 0.0)), cuda=None):
        self.fn = fn
        self.cuda = cuda
        self._points = np.asarray(points, np.float32)
        if self._points.shape != (2, 2):
            raise ValueError("UserPaint points must be two (x, y) pairs")

    def points(self):
        return self._points


def _paint_kind(color) -> int:
    return getattr(color, "kind", 0)


def _spec_paint(color):
    """FrameSpec.paints entry for a command color: the builtin kind
    int, or the UserPaint itself (its ``fn`` identity selects the code
    path, its ``cuda`` source the kernel build)."""
    kind = _paint_kind(color)
    return color if kind >= UserPaint.kind else kind


#: The named shorthands as BlendStates.
NAMED_BLEND_STATES = {
    "back_to_front": BlendState(
        BlendComponent("one", "add", "one_minus_src_alpha"),
        BlendComponent("one", "add", "one_minus_src_alpha"),
    ),
    "front_to_back": BlendState(
        BlendComponent("one_minus_dst_alpha", "add", "one"),
        BlendComponent("one_minus_dst_alpha", "add", "one"),
    ),
    "additive": BlendState(
        BlendComponent("one", "add", "one"),
        BlendComponent("one", "add", "one"),
    ),
}


@dataclass
class Configuration:
    """Configurable renderer parameters (reference renderer.rs:379-405);
    the same fields and checks as the JAX package's Configuration."""

    msaa_sample_count: int = 4
    clip_nesting_counter_bits: int = 4
    winding_counter_bits: int = 4
    alpha_layer_count: int = 0
    #: A named mode ("back_to_front", "front_to_back", "additive") or a
    #: :class:`BlendState`.
    blending: object = "back_to_front"
    depth_compare: str = "always"
    depth_write_enabled: bool = False

    def __post_init__(self):
        if isinstance(self.blending, str):
            if self.blending not in NAMED_BLEND_STATES:
                raise ValueError(f"unknown blending {self.blending!r}")
        elif not isinstance(self.blending, BlendState):
            raise ValueError(
                "blending must be a named mode or a BlendState, got "
                f"{self.blending!r}"
            )
        if (
            self.winding_counter_bits == 0
            or self.clip_nesting_counter_bits + self.winding_counter_bits > 8
        ):
            raise NumberOfStencilBitsIsUnsupported(
                f"clip={self.clip_nesting_counter_bits} winding={self.winding_counter_bits}"
            )
        if self.msaa_sample_count not in coverage.SAMPLE_PATTERNS:
            raise ValueError(
                "msaa_sample_count must be one of "
                f"{sorted(coverage.SAMPLE_PATTERNS)}"
            )
        if self.depth_compare not in DEPTH_COMPARE_FUNCTIONS:
            raise ValueError(
                f"depth_compare must be one of {DEPTH_COMPARE_FUNCTIONS}, "
                f"got {self.depth_compare!r}"
            )


_GLYPH_SEGMENTS = (SegmentType.LINE, SegmentType.INTEGRAL_QUADRATIC_CURVE)
#: Minimum glyph-style path count before the native batch tessellator
#: takes over from the per-path FillBuilder.
_NATIVE_FILL_THRESHOLD = 8


def _is_glyph_style(path: Path) -> bool:
    return all(st in _GLYPH_SEGMENTS for st in path.segment_types)


def _native_fill_batch(paths, proto_hull):
    """Tessellate glyph-style paths with the native C++ tessellator in
    one batched call (bit-equivalent to FillBuilder's output)."""
    offsets = [0]
    starts, kinds, points = [], [], []
    for p in paths:
        starts.append(p.start)
        for segment_type, segment in p.iter_segments():
            cps = segment.control_points
            if segment_type is SegmentType.LINE:
                kinds.append(0)
                points.append([cps[0][0], cps[0][1], 0.0, 0.0])
            else:
                kinds.append(1)
                points.append([cps[0][0], cps[0][1], cps[1][0], cps[1][1]])
        offsets.append(len(kinds))
    solid_xy, curve_xy, curve_aux, hull_pts = native.tessellate_quadratic_paths(
        np.asarray(offsets, np.int64),
        np.asarray(starts, np.float64),
        np.asarray(kinds, np.uint8),
        np.asarray(points, np.float64),
    )
    proto_hull.extend(hull_pts)
    n_solid, n_curve = len(solid_xy), len(curve_xy)
    aux = np.zeros((n_solid + n_curve, 3, 4), np.float32)
    aux[n_solid:, :, :3] = curve_aux
    return TriangleTable(
        xy=np.concatenate([solid_xy, curve_xy]).astype(np.float32),
        aux=aux,
        kind=np.concatenate(
            [
                np.full(n_solid, KIND_SOLID, np.int32),
                np.full(n_curve, KIND_INTEGRAL_QUADRATIC, np.int32),
            ]
        ),
        meta=np.zeros((n_solid + n_curve, 2), np.float32),
    )


class Shape:
    """A set of paths always rendered together (reference Shape,
    renderer.rs:163-249): one triangle table (stroke triangles first)
    and the convex hull the cover operations use.  Tessellation is this
    package's copy of the reference's FillBuilder, StrokeBuilder and
    native tessellator, so the tables equal the JAX package's bit for
    bit.  Paths must be this package's ``path.Path``: the builders
    dispatch on its segment types by identity."""

    _uid_counter = iter(range(1, 1 << 62))

    def __init__(
        self,
        paths: Sequence[Path],
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
        use_native: bool = True,
    ):
        # Unique, never-recycled identity keys the scene cache.
        self._uid = next(Shape._uid_counter)
        self._geometry_version = -1
        self.update_paths(paths, dynamic_stroke_options, use_native)

    def update_paths(
        self,
        paths: Sequence[Path],
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
        use_native: bool = True,
    ):
        """Re-tessellate this Shape in place; renderers notice via the
        geometry version and re-upload only this shape's tables."""
        for path in paths:
            if not isinstance(path, Path):
                raise TypeError(
                    "Shape takes contrast_renderer_tpu_torch.path.Path, got "
                    f"{type(path).__module__}.{type(path).__qualname__}"
                )
        proto_hull: List = []
        stroke_builder = StrokeBuilder()
        fill_builder = FillBuilder()
        fill_paths = [p for p in paths if p.stroke_options is None]
        native_fills = ()
        if (
            use_native
            and len(fill_paths) >= _NATIVE_FILL_THRESHOLD
            and native.available()
            and all(_is_glyph_style(p) for p in fill_paths)
        ):
            native_fills = fill_paths
        for path in paths:
            if path.stroke_options is not None:
                if path.stroke_options.dynamic_stroke_options_group >= len(
                    dynamic_stroke_options
                ):
                    raise DynamicStrokeOptionsIndexOutOfBounds(
                        f"group {path.stroke_options.dynamic_stroke_options_group}"
                    )
                stroke_builder.add_path(proto_hull, path)
            elif not native_fills:
                fill_builder.add_path(proto_hull, path)
        tables = [stroke_builder.build()]
        if native_fills:
            tables.append(_native_fill_batch(native_fills, proto_hull))
        tables.append(fill_builder.build())
        self.triangles = TriangleTable.concatenate(tables)
        require_finite(self.triangles.xy, "path coordinates")
        require_finite(self.triangles.aux, "curve weights")
        self.convex_hull = outer_polygon(
            andrew(
                np.asarray(proto_hull).reshape(-1, 2)
                if proto_hull
                else np.zeros((0, 2))
            )
        )
        self.dynamic_stroke_options = list(dynamic_stroke_options)
        self.descriptors = ds.StrokeDescriptorTable.from_options(
            self.dynamic_stroke_options
        )
        self._geometry_version += 1

    @classmethod
    def from_triangle_table(
        cls,
        triangles: TriangleTable,
        hull_points: np.ndarray,
        dynamic_stroke_options: Sequence[DynamicStrokeOptions] = (),
    ) -> "Shape":
        """A Shape from pre-tessellated geometry (the hull is rebuilt
        from ``hull_points``)."""
        shape = cls.__new__(cls)
        shape._uid = next(cls._uid_counter)
        shape._geometry_version = 0
        shape.triangles = triangles
        require_finite(triangles.xy, "triangle coordinates")
        require_finite(triangles.aux, "curve weights")
        pts = np.asarray(hull_points, np.float64).reshape(-1, 2)
        shape.convex_hull = outer_polygon(
            andrew(pts if len(pts) else np.zeros((0, 2)))
        )
        shape.dynamic_stroke_options = list(dynamic_stroke_options)
        shape.descriptors = ds.StrokeDescriptorTable.from_options(
            shape.dynamic_stroke_options
        )
        return shape

    def set_dynamic_stroke_options(
        self, index: int, options: DynamicStrokeOptions
    ):
        """Update one descriptor group without re-tessellating."""
        if index >= len(self.dynamic_stroke_options):
            raise DynamicStrokeOptionsIndexOutOfBounds(str(index))
        self.dynamic_stroke_options[index] = options
        self.descriptors = ds.StrokeDescriptorTable.from_options(
            self.dynamic_stroke_options
        )


@dataclass
class DrawCommand:
    """One step of a frame (the reference's Shape::render call with a
    RenderOperation and an instance range).  ``transform`` is a (4, 4)
    matrix or an (N, 4, 4) stack of instances; ``color`` is (4,) or
    (N, 4); ``shape`` is one Shape or one per instance."""

    operation: RenderOperation
    shape: object
    transform: np.ndarray  # (4, 4) or (N, 4, 4) row-major model→clip
    color: object = (0.0, 0.0, 0.0, 1.0)  # (4,) or (N, 4)
    clip_depth: int = 0
    alpha_layer: int = 0

    @property
    def n_instances(self) -> int:
        t = np.asarray(self.transform)
        return 1 if t.ndim == 2 else int(t.shape[0])

    @property
    def shapes(self):
        """The command's shapes as a list (len 1 or n_instances)."""
        return (
            list(self.shape)
            if isinstance(self.shape, (list, tuple))
            else [self.shape]
        )


def _optimize_commands(commands):
    """Fuse each SaveAlphaContext + ScaleAlphaContext pair over the
    identical single-instance cover into one pass (OP_SAVE_SCALE).

    Returns ``(optimized, keep_rows)``; ``keep_rows`` indexes the
    surviving transform rows of the original layout (None when nothing
    fused)."""
    out, keep = [], []
    row = 0
    i = 0
    while i < len(commands):
        c = commands[i]
        if (
            i + 1 < len(commands)
            and c.operation == RenderOperation.SAVE_ALPHA_CONTEXT
            and commands[i + 1].operation
            == RenderOperation.SCALE_ALPHA_CONTEXT
        ):
            s = commands[i + 1]
            if (
                c.shape is s.shape
                and c.clip_depth == s.clip_depth
                and c.alpha_layer == s.alpha_layer
                and c.n_instances == 1
                and s.n_instances == 1
                and np.array_equal(
                    np.asarray(c.transform, np.float32),
                    np.asarray(s.transform, np.float32),
                )
            ):
                out.append(replace(s, operation=coverage.OP_SAVE_SCALE))
                keep.extend(
                    range(row + c.n_instances,
                          row + c.n_instances + s.n_instances)
                )
                row += c.n_instances + s.n_instances
                i += 2
                continue
        out.append(c)
        keep.extend(range(row, row + c.n_instances))
        row += c.n_instances
        i += 1
    keep_rows = (
        None if len(keep) == row else np.asarray(keep, np.int32)
    )
    return out, keep_rows


#: Minimum clip-space w for every hull point before a cover's screen
#: box is considered well-defined (near-plane crossers never fuse).
_FUSE_W_EPS = 1e-6


def _cover_box(shape: "Shape", transform) -> Optional[Tuple[float, ...]]:
    """Screen-space AABB of a command's cover region (the decimated
    outer hull polygon projected by the command transform), or None
    when the projection is not well-defined (near-plane crossing /
    non-finite).  Triangular geometry and the per-sample cover mask are
    both contained in the hull polygon, so containment survives the
    projective map while every w stays positive."""
    hull = shape.convex_hull
    if len(hull) == 0:
        return None
    t = np.asarray(transform, np.float64)
    if t.ndim != 2:
        return None
    ones = np.ones((len(hull), 1))
    clip = np.concatenate(
        [hull, np.zeros((len(hull), 1)), ones], axis=1
    ) @ t.T
    w = clip[:, 3]
    if not np.all(w > _FUSE_W_EPS):
        return None
    ndc = clip[:, :2] / w[:, None]
    if not np.all(np.isfinite(ndc)):
        return None
    return (
        float(ndc[:, 0].min()), float(ndc[:, 1].min()),
        float(ndc[:, 0].max()), float(ndc[:, 1].max()),
    )


def _boxes_disjoint(a, b) -> bool:
    # Closed-box test: touching boxes count as overlapping (a shared
    # boundary could in principle carry the same sample point).
    return (
        a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1]
    )


def _solid_rgba(color) -> Optional[Tuple[float, ...]]:
    if _paint_kind(color):
        return None
    arr = np.asarray(color, np.float32).reshape(-1)
    return tuple(float(x) for x in arr) if arr.shape == (4,) else None


def _fusable_pair(commands, i, check_transforms=True):
    """The (STENCIL, COLOR) pair at positions ``i``, ``i+1`` if the two
    commands form a single-instance stencil-then-cover of the same
    shape under the same clip/alpha state, else None.

    ``check_transforms=False`` defers the stencil==cover transform
    equality to the caller — FrameProgram detects runs structurally at
    build time and validates the actual transform rows per call (its
    transforms are runtime inputs)."""
    if i + 1 >= len(commands):
        return None
    c, s = commands[i], commands[i + 1]
    if (
        c.operation == RenderOperation.STENCIL
        and s.operation == RenderOperation.COLOR
        and c.shape is s.shape
        and c.n_instances == 1
        and s.n_instances == 1
        and c.clip_depth == s.clip_depth
        and c.alpha_layer == s.alpha_layer
        and (
            not check_transforms
            or np.array_equal(
                np.asarray(c.transform, np.float32),
                np.asarray(s.transform, np.float32),
            )
        )
    ):
        return (c, s)
    return None


def _collect_fusable_run(commands, i, check_transforms=True):
    """Collect the maximal run of fusable (STENCIL, COLOR) pairs
    starting at ``i`` that share shape identity, clip depth, alpha
    layer, and compatible colors (all solid, or all the identical
    Paint object).  Returns ``(run, next_i)`` where ``run`` is a list
    of (stencil, color) tuples ([] when no pair starts at ``i``) and
    ``next_i`` is the index of the first command after the run."""
    first = _fusable_pair(commands, i, check_transforms)
    if first is None:
        return [], i
    key_shape = first[0].shape
    key_clip = first[0].clip_depth
    key_layer = first[0].alpha_layer
    first_solid = _solid_rgba(first[1].color)
    run = []
    while True:
        pair = _fusable_pair(commands, i, check_transforms)
        if pair is None or pair[0].shape is not key_shape:
            break
        if (
            pair[0].clip_depth != key_clip
            or pair[0].alpha_layer != key_layer
        ):
            break
        solid = _solid_rgba(pair[1].color)
        if (first_solid is None) != (solid is None):
            break
        if solid is None and pair[1].color is not first[1].color:
            break
        run.append(pair)
        i += 2
    return run, i


def _fuse_instance_runs(commands):
    """Auto-instancing: collapse consecutive single-instance
    (Stencil, Color) pairs over the same shape/clip/alpha state into
    instanced draws — the reference's ``instance_range 0..n`` draw
    (renderer.rs:267, 462-466) — wherever that is pixel-exact.

    The per-instance loop and the instanced draw differ only where
    instance covers interact: the instanced stencil accumulates ALL
    instances' winding before any cover runs, so a cover that overlaps
    a later instance's geometry would paint (and reset) winding that
    the sequential loop had not yet stamped.  Pairs therefore fuse
    under a greedy disjointness rule: walking the run in order, a pair
    joins the current group iff its projected cover box is disjoint
    from every box already in the group; otherwise it starts a new
    group.  Groups emit in walk order, covers replay in instance
    order, and all cross-group/cross-command interactions (blending,
    clip, depth, bulk winding) happen exactly where the sequential
    walk had them — the grouping changes per-tile walk length, not
    pixels.  Pairs whose projection is not well-defined (near-plane
    crossing) never fuse.

    Per-instance solid colors stack into the command's (N, 4) color;
    gradient paints fuse only when every pair shares the identical
    Paint object (its model-space endpoints broadcast per instance).

    Applied by ``Renderer.render`` per call with the current
    transforms, so the decision is always sound for the frame being
    rendered.  ``FrameProgram`` detects the same runs with
    ``check_transforms=False`` (``_structural_runs``) and re-validates
    disjointness at every call.
    """
    n = len(commands)
    out = []
    i = 0
    fused_any = False
    while i < n:
        run, next_i = _collect_fusable_run(commands, i)
        if not run:
            out.append(commands[i])
            i += 1
            continue
        i = next_i
        if len(run) < 2:
            out.extend(run[0])
            continue
        # Greedy disjoint grouping in walk order.
        boxes = [_cover_box(p[0].shape, p[0].transform) for p in run]
        groups = []
        current = []
        current_boxes = []
        for pair, box in zip(run, boxes):
            if box is not None and all(
                _boxes_disjoint(box, b) for b in current_boxes
            ):
                current.append(pair)
                current_boxes.append(box)
            else:
                if current:
                    groups.append(current)
                current = [pair]
                # A boxless (near-plane) pair may never accept
                # neighbours: poison its group with an everything-box.
                current_boxes = [
                    box if box is not None
                    else (-np.inf, -np.inf, np.inf, np.inf)
                ]
        if current:
            groups.append(current)
        for group in groups:
            if len(group) == 1:
                out.extend(group[0])
                continue
            fused_any = True
            transforms = np.ascontiguousarray(
                np.stack([
                    np.asarray(p[0].transform, np.float32)
                    for p in group
                ])
            )
            if _paint_kind(group[0][1].color):
                color = group[0][1].color
            else:
                color = np.ascontiguousarray(
                    np.stack([
                        np.asarray(p[1].color, np.float32).reshape(4)
                        for p in group
                    ])
                )
            out.append(replace(group[0][0], transform=transforms))
            out.append(
                replace(group[0][1], transform=transforms, color=color)
            )
    return out, fused_any


# ---------------------------------------------------------------------------
# FrameProgram's fusion planners: host numpy in float64, as in the reference
# (renderer.py:884-1441), operation for operation, so that boxes, polygons
# and groupings equal the reference's to the bit.
# ---------------------------------------------------------------------------


class _FusionRun:
    """One structural run of fusable (STENCIL, COLOR) pairs inside a
    FrameProgram's optimized command list (see _structural_runs)."""

    __slots__ = (
        "start", "pairs", "shape", "stencil_rows", "cover_rows", "escape",
    )


def _structural_runs(commands):
    """Maximal fusable runs of >= 2 pairs in the optimized command list,
    transform values left out of the test (a FrameProgram's transforms
    are runtime inputs).  Returns a list of _FusionRun with the
    optimized layout's row index of each pair."""
    rows_before = np.cumsum([0] + [c.n_instances for c in commands])
    runs = []
    i = 0
    n = len(commands)
    while i < n:
        run, next_i = _collect_fusable_run(
            commands, i, check_transforms=False
        )
        if len(run) < 2:
            i = next_i if run else i + 1
            continue
        r = _FusionRun()
        r.start = i
        r.pairs = run
        r.shape = run[0][0].shape
        r.stencil_rows = rows_before[np.arange(i, next_i, 2)].astype(
            np.int64
        )
        r.cover_rows = r.stencil_rows + 1
        r.escape = _run_overlap_escape(run)
        runs.append(r)
        i = next_i
    return runs


#: Near-plane eps of the host cover model.  It is no larger than either
#: of binning's: the cover hull clip (1e-5) and the stencil triangle clip
#: (w_eps = 1e-6), so the host polygon contains everything an instance
#: can touch on screen, its cover and its stencil winding alike.
#: Disjoint supersets imply disjoint regions; near-eps projections blow
#: up to huge coordinates and simply refuse to fuse.
_NEAR_CLIP_EPS = 1e-6


def _clip_poly_near(hclip):
    """Sutherland-Hodgman clip of one homogeneous polygon (h, 4) against
    ``w > _NEAR_CLIP_EPS``, projected to NDC.  Returns (k, 2), with
    k < 3 meaning an empty cover."""
    eps = _NEAR_CLIP_EPS
    out = []
    h = len(hclip)
    for i in range(h):
        a, b = hclip[i], hclip[(i + 1) % h]
        wa, wb = a[3], b[3]
        if wa > eps:
            out.append(a)
        if (wa > eps) != (wb > eps):
            t = (eps - wa) / (wb - wa)
            out.append(a + t * (b - a))
    if len(out) < 3:
        return np.zeros((0, 2))
    out = np.asarray(out)
    return out[:, :2] / out[:, 3:4]


def _run_boxes(shape: "Shape", transforms):
    """Projected covers of one shape under a stack of transforms:
    ``(boxes (m, 4) NDC min/max, ok (m,) bool, polys (m, h+1, 2))``; ok
    is False only where the transform itself is not finite.  ``polys``
    are the projected hull polygons clipped against the near plane, a
    convex superset of the cover and of the stencil winding, and the
    boxes their AABBs.  A hull wholly behind the plane touches nothing:
    its box is the empty interval (+inf mins, -inf maxes) and its
    polygon a point (orientation sign 0, which escape groups reject)."""
    hull = np.asarray(shape.convex_hull, np.float64)
    m = len(transforms)
    if len(hull) == 0:
        return np.zeros((m, 4)), np.zeros(m, bool), np.zeros((m, 1, 2))
    hom = np.concatenate(
        [hull, np.zeros((len(hull), 1)), np.ones((len(hull), 1))], axis=1
    )
    clip = np.einsum(
        "mrk,hk->mhr", np.asarray(transforms, np.float64), hom
    )
    ok = np.all(np.isfinite(clip), axis=(1, 2))
    w = clip[..., 3]
    front = w > _NEAR_CLIP_EPS
    all_front = np.all(front, axis=-1) & ok
    with np.errstate(invalid="ignore", divide="ignore"):
        ndc = clip[..., :2] / np.where(
            front[..., None], w[..., None], 1.0
        )
    # One extra slot: clipping a convex polygon against one plane adds
    # at most one vertex; unused slots repeat a vertex (degenerate edges
    # are inert in the SAT and add no signed area).
    polys = np.concatenate([ndc, ndc[:, :1]], axis=1)
    boxes = np.concatenate([ndc.min(axis=1), ndc.max(axis=1)], axis=-1)
    for i in np.nonzero(~all_front & ok)[0]:
        p = _clip_poly_near(clip[i])
        if len(p) == 0:
            boxes[i] = (np.inf, np.inf, -np.inf, -np.inf)
            polys[i] = 0.0
            continue
        boxes[i] = (*p.min(axis=0), *p.max(axis=0))
        polys[i, : len(p)] = p
        polys[i, len(p):] = p[-1]
    return boxes, ok, polys


def _convex_polys_disjoint(pa, pb) -> bool:
    """Strict separating-axis test between two convex screen polygons of
    either winding: True iff an edge line of one has the whole other
    polygon strictly outside.  Touching or degenerate polygons count as
    overlapping."""
    for first, second in ((pa, pb), (pb, pa)):
        e = np.roll(first, -1, axis=0) - first
        nx, ny = e[:, 1], -e[:, 0]
        c = -(nx * first[:, 0] + ny * first[:, 1])
        centroid = first.mean(axis=0)
        side = nx * centroid[0] + ny * centroid[1] + c
        flip = np.where(side > 0.0, -1.0, 1.0)
        nx, ny, c = nx * flip, ny * flip, c * flip
        d = (
            nx[:, None] * second[None, :, 0]
            + ny[:, None] * second[None, :, 1]
            + c[:, None]
        )
        if bool(np.any(np.all(d > 0.0, axis=1))):
            return True
    return False


def _covers_disjoint(boxes, polys, i, j) -> bool:
    """Cover disjointness of pair ``i`` and ``j``: the AABB test, then
    the polygon SAT where the boxes touch (rotated cells can have
    overlapping boxes and apart covers)."""
    if _boxes_disjoint(boxes[i], boxes[j]):
        return True
    return _convex_polys_disjoint(polys[i], polys[j])


def _poly_orientation_signs(polys):
    """Sign of the signed area of each projected hull polygon (m, h, 2):
    the orientation parity of each instance's screen mapping."""
    x, y = polys[..., 0], polys[..., 1]
    area2 = np.sum(
        x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1
    )
    return np.sign(area2)


def _idempotent_blend(blending) -> bool:
    """Whether painting one opaque colour twice at a sample equals
    painting it once: source-over back to front, or front to back (the
    precondition of the overlap escape, _run_overlap_escape)."""
    canonical = (
        blending if isinstance(blending, str) else blending.canonical()
    )
    return canonical in ("back_to_front", "front_to_back")


def _run_overlap_escape(pairs) -> bool:
    """True when every pair of a run paints the same opaque solid
    colour: the fused draw is then exact even where covers overlap,
    given an idempotent blend, no depth state and one orientation sign
    for every instance (checked per frame).  Overlap changes only which
    cover paints a shared sample and how often, which one opaque colour
    hides, and winding borrowed across instances of one orientation
    cannot cancel."""
    first = _solid_rgba(pairs[0][1].color)
    if first is None or first[3] != 1.0:
        return False
    return all(
        _solid_rgba(c.color) == first for _, c in pairs[1:]
    )


def _greedy_box_groups(boxes, ok, polys):
    """Greedy disjoint grouping in walk order: a pair joins the current
    group iff its cover is well-defined and disjoint from every cover in
    the group.  Returns a tuple of tuples of pair indices."""
    groups = []
    current = []
    for i in range(len(boxes)):
        if ok[i] and all(
            _covers_disjoint(boxes, polys, i, j) for j in current
        ):
            current.append(i)
        else:
            if current:
                groups.append(tuple(current))
            current = [i]
            if not ok[i]:
                # A pair without a box never accepts neighbours.
                groups.append(tuple(current))
                current = []
    if current:
        groups.append(tuple(current))
    return tuple(groups)


def _greedy_box_groups_multi(per_stack, ok):
    """_greedy_box_groups across a motion: a pair joins the current
    group only if its cover is disjoint from every member's in every
    frame (``per_stack``: one ``(boxes, polys)`` per frame), so one
    variant serves the whole path."""
    groups = []
    current = []
    for i in range(len(ok)):
        if ok[i] and all(
            _covers_disjoint(boxes, polys, i, j)
            for j in current
            for boxes, polys in per_stack
        ):
            current.append(i)
        else:
            if current:
                groups.append(tuple(current))
            current = [i]
            if not ok[i]:
                groups.append(tuple(current))
                current = []
    if current:
        groups.append(tuple(current))
    return tuple(groups)


class _FusionPlan:
    """A grouping of a FrameProgram's structural runs: the fused command
    list, the optimized-layout to fused-layout row gather, and per fused
    group the rows to re-validate each call."""

    __slots__ = ("commands", "gather", "groups", "signature")


def _plan_for_groups(commands, runs, groupings):
    """The fused command list for one grouping choice.

    ``groupings[k]`` is ``(groups, escape)`` for ``runs[k]``: tuples of
    pair indices (from _greedy_box_groups, or one group of all pairs
    under the overlap escape) and whether the escape's validation
    applies.  A group of two or more pairs becomes one instanced
    (STENCIL, COLOR) pair; a single pair stays as it was.  Returns None
    when no group fuses."""
    rows_before = np.cumsum([0] + [c.n_instances for c in commands])
    run_at = {r.start: (r, g) for r, g in zip(runs, groupings)}
    out = []
    gather = []
    groups_meta = []
    fused_any = False
    i = 0
    n = len(commands)
    while i < n:
        hit = run_at.get(i)
        if hit is None:
            gather.extend(range(rows_before[i], rows_before[i + 1]))
            out.append(commands[i])
            i += 1
            continue
        r, (grouping, escape) = hit
        for group in grouping:
            if len(group) < 2:
                for gi in group:
                    s, c = r.pairs[gi]
                    out.append(s)
                    out.append(c)
                    gather.append(int(r.stencil_rows[gi]))
                    gather.append(int(r.cover_rows[gi]))
                continue
            fused_any = True
            idx = list(group)
            transforms = np.ascontiguousarray(
                np.stack([
                    np.asarray(r.pairs[gi][0].transform, np.float32)
                    for gi in idx
                ])
            )
            first_color = r.pairs[0][1].color
            if _paint_kind(first_color):
                color = first_color
            else:
                color = np.ascontiguousarray(
                    np.stack([
                        np.asarray(
                            r.pairs[gi][1].color, np.float32
                        ).reshape(4)
                        for gi in idx
                    ])
                )
            out.append(replace(r.pairs[idx[0]][0], transform=transforms))
            out.append(
                replace(
                    r.pairs[idx[0]][1], transform=transforms, color=color
                )
            )
            srows = [int(r.stencil_rows[gi]) for gi in idx]
            crows = [int(r.cover_rows[gi]) for gi in idx]
            gather.extend(srows)
            gather.extend(crows)
            groups_meta.append(
                (
                    r.shape,
                    np.asarray(srows, np.int64),
                    np.asarray(crows, np.int64),
                    escape,
                )
            )
        i = r.start + 2 * len(r.pairs)
    if not fused_any:
        return None
    plan = _FusionPlan()
    plan.commands = out
    plan.gather = np.asarray(gather, np.int32)
    plan.groups = groups_meta
    plan.signature = tuple(
        (escape,) + tuple(tuple(g) for g in grouping)
        for grouping, escape in groupings
    )
    return plan


#: Clip and alpha-group ops: the machinery of a bracket (see _gate_spans).
_MACHINERY_OPS = (
    coverage.OP_CLIP, coverage.OP_UNCLIP, coverage.OP_SAVE_ALPHA,
    coverage.OP_SCALE_ALPHA, coverage.OP_RESTORE_ALPHA,
    coverage.OP_SAVE_SCALE,
)
#: The ops that open a bracket.
_OPENER_OPS = (
    coverage.OP_CLIP, coverage.OP_SAVE_ALPHA, coverage.OP_SAVE_SCALE,
)


def _is_mach_op(o) -> bool:
    """Whether op ``o`` is clip/alpha machinery (see _gate_spans)."""
    return o in _MACHINERY_OPS


def _machinery_alphas(c):
    """Per-instance opacity tuple of a machinery cover's color, or
    None when it is not a plain color."""
    if _paint_kind(c.color):
        return None
    a = np.asarray(c.color, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2 or a.shape[-1] != 4:
        return None
    try:
        return tuple(
            np.broadcast_to(a[:, 3], (c.n_instances,)).tolist()
        )
    except ValueError:
        return None


def _gate_spans(commands, spec) -> tuple:
    """Static clip/alpha bracket analysis feeding the binning's per-tile
    machinery gating (FrameSpec.gate_spans); the reference's analysis
    (contrast_renderer_tpu/renderer.py::_gate_spans), proof obligation
    for proof obligation.

    On a tile where NO content draw of the whole frame lands, frame
    alpha is exactly 0.0 under every machinery op, and a complete
    bracket — clip stencil + CLIP … UNCLIP back to the entry depth, or
    SAVE(+SCALE)/SAVE_SCALE … RESTORE on one layer — is then bit-exact
    identity on the colour buffer: the save/scale/restore chain over
    a0 = 0 computes fl(1−g) − fl((1−0)·fl(1−g)) = 0 with no rounding
    slack, and clip ops never touch colour.  So binning may drop the
    machinery from such tiles (usually leaving them on the kernel's
    empty-tile path).  Content activity is deliberately FRAME-wide, not
    span-wide: with content anywhere in the tile, frame alpha can be
    nonzero and the float composition would differ from identity by
    rounding, so those tiles keep their machinery.

    The static proof obligations:

    - depth protocol, simulated from 0: each CLIP opens at cur+1 with
      its feeding machinery stencils at cur, each UNCLIP closes at
      cur−1 on the SAME shape with the same instance count;
    - alpha protocol: SAVE/SAVE_SCALE … RESTORE pair on one layer and
      one shape with the SAME group opacity, issued at the SAME clip
      depth under the SAME open-clip state (the kernel masks every
      alpha op with its clip test); nested saves use distinct layers;
    - machinery stencils: winding consumed exclusively by machinery
      covers (so skipping both leaves nothing half-consumed).

    Hull coincidence — equal transform rows between paired commands —
    is runtime state and is returned as ``row_pairs`` for the binning's
    per-frame check on the device.  Returns () — gate nothing — on ANY
    deviation from the protocol: gating never changes the image.

    Each span is ``(content_units, machinery_units, row_pairs)``."""
    ops = spec.ops
    C = len(ops)
    if not any(o in _OPENER_OPS for o in ops):
        return ()
    draws = coverage.draw_tables(spec)
    row_base = draws.row_base

    mach = [_is_mach_op(o) for o in ops]
    for i, o in enumerate(ops):
        if o == coverage.OP_STENCIL:
            consumers = []
            j = i + 1
            while j < C and ops[j] != coverage.OP_STENCIL:
                consumers.append(j)
                j += 1
            mach[i] = bool(consumers) and all(mach[j] for j in consumers)

    def rows(i):
        return range(int(row_base[i]), int(row_base[i + 1]))

    def same_draws(j, i):
        return (
            spec.cmd_shape[j] == spec.cmd_shape[i]
            and commands[j].n_instances == commands[i].n_instances
        )

    cur = 0
    clip_stack = []
    alpha_stack = []
    spans = []
    pairs = []
    start = None
    for i, c in enumerate(commands):
        o = ops[i]
        if o == coverage.OP_STENCIL:
            if mach[i] and c.clip_depth != cur:
                return ()
            continue
        if start is None and o in _OPENER_OPS:
            s = i
            while s > 0 and ops[s - 1] == coverage.OP_STENCIL and mach[s - 1]:
                s -= 1
            start = s
            pairs = []
        if o == coverage.OP_CLIP:
            if c.clip_depth != cur + 1:
                return ()
            clip_stack.append(i)
            cur += 1
        elif o == coverage.OP_UNCLIP:
            if not clip_stack or c.clip_depth != cur - 1:
                return ()
            j = clip_stack.pop()
            if not same_draws(j, i):
                return ()
            pairs += list(zip(rows(j), rows(i)))
            cur -= 1
        elif o in (coverage.OP_SAVE_ALPHA, coverage.OP_SAVE_SCALE):
            g = _machinery_alphas(c) if o == coverage.OP_SAVE_SCALE else None
            if o == coverage.OP_SAVE_SCALE and g is None:
                return ()
            if any(top[1] == c.alpha_layer for top in alpha_stack):
                return ()
            # The issue-time clip state, so that scale and restore are
            # provably issued under the identical clip mask.
            clip_state = (c.clip_depth, tuple(clip_stack))
            alpha_stack.append([i, c.alpha_layer, g, clip_state])
        elif o == coverage.OP_SCALE_ALPHA:
            if not alpha_stack:
                return ()
            top = alpha_stack[-1]
            g = _machinery_alphas(c)
            if (
                top[2] is not None
                or g is None
                or top[3] != (c.clip_depth, tuple(clip_stack))
                or not same_draws(top[0], i)
            ):
                return ()
            top[2] = g
            pairs += list(zip(rows(top[0]), rows(i)))
        elif o == coverage.OP_RESTORE_ALPHA:
            if not alpha_stack:
                return ()
            j, layer, g, clip_state = alpha_stack.pop()
            if (
                c.alpha_layer != layer
                or g is None
                or _machinery_alphas(c) != g
                or clip_state != (c.clip_depth, tuple(clip_stack))
                or not same_draws(j, i)
            ):
                return ()
            pairs += list(zip(rows(j), rows(i)))
        elif start is None and mach[i]:
            # Machinery outside any span (a stray SCALE): bail.
            return ()
        if start is not None and not clip_stack and not alpha_stack:
            spans.append((start, i + 1, tuple(pairs)))
            start = None
            pairs = []
    if clip_stack or alpha_stack:
        return ()
    ucmd = draws.unit_cmd
    # Frame-wide content (see the bit-exactness argument above): every
    # unit of a non-machinery command, anywhere in the frame.
    content_u = tuple(
        int(u) for u in range(len(ucmd)) if not mach[ucmd[u]]
    )
    if not content_u:
        return ()
    out = []
    for s, e, rp in spans:
        mach_u = tuple(
            int(u)
            for u in range(len(ucmd))
            if s <= ucmd[u] < e and mach[ucmd[u]]
        )
        if mach_u:
            out.append((content_u, mach_u, rp))
    return tuple(out)


class _SceneArrays:
    """Padded, stacked geometry of a set of shapes, as tensors on the
    renderer's device."""

    def __init__(self, shapes: Sequence[Shape], device):
        t_max = max(1, max(len(s.triangles) for s in shapes))
        h_max = max(4, max(len(s.convex_hull) for s in shapes))

        def pad_tables(shape):
            t = shape.triangles
            pad = t_max - len(t)
            xy = np.concatenate([t.xy, np.zeros((pad, 3, 2), np.float32)])
            aux = np.concatenate([t.aux, np.zeros((pad, 3, 4), np.float32)])
            kind = np.concatenate([t.kind, np.zeros(pad, np.int32)])
            meta = np.concatenate([t.meta, np.zeros((pad, 2), np.float32)])
            hull = shape.convex_hull.astype(np.float32)
            if len(hull) == 0:
                hull = np.zeros((1, 2), np.float32)
            hull = np.concatenate(
                [hull, np.repeat(hull[-1:], h_max - len(hull), axis=0)]
            )
            return xy, aux, kind, meta, hull

        padded = [pad_tables(s) for s in shapes]
        gbase = np.cumsum(
            [0] + [len(s.descriptors.phase) for s in shapes[:-1]]
        )
        self.t_max = t_max
        self.h_max = h_max
        self.n_shapes = len(shapes)
        #: Unpadded triangle count per shape (_spec's density estimate).
        self.tri_counts = tuple(len(s.triangles) for s in shapes)
        #: Per-shape stroke rows (line/joint kinds).
        self.stroke_counts = tuple(
            int((np.asarray(s.triangles.kind) >= KIND_STROKE_LINE).sum())
            for s in shapes
        )
        #: Total stroke descriptor groups (each shape carries at least
        #: one, so this is never the test for stroke rows).
        self.n_desc = sum(len(s.descriptors.phase) for s in shapes)

        def stacked(i, dtype):
            arr = np.stack([p[i] for p in padded]).astype(dtype)
            return torch.as_tensor(arr, device=device)

        self.xy = stacked(0, np.float32)
        self.aux = stacked(1, np.float32)
        self.kind = stacked(2, np.int32)
        self.meta = stacked(3, np.float32)
        self.hull = stacked(4, np.float32)
        self.gbase = torch.as_tensor(gbase.astype(np.int32), device=device)

    @property
    def arrays(self):
        return (self.xy, self.aux, self.kind, self.meta, self.gbase, self.hull)


def _next_pow2(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


#: Shrink-to-fit headroom and floors for (tile, global, tile-global,
#: clip-pool) capacities, as in the reference.
FIT_MARGIN = 1.5
FIT_FLOORS = (32, 64, 16, 16)


def _fit_capacity(count: int, floor_: int, ceiling: int) -> int:
    """next-pow2(count · FIT_MARGIN), floored and clamped to ceiling."""
    return min(
        ceiling, max(floor_, _next_pow2(int(count * FIT_MARGIN) + 1))
    )


#: In-plane rotation (radians) of the capacity-settling probe frame: 45°
#: misaligns the scene with the tile grid the most.
SETTLE_PROBE_ANGLE = math.pi / 4


def _rotated_probe_commands(commands):
    """A copy of ``commands`` with every transform pre-rotated in clip
    space: FrameProgram's second capacity-settling frame.

    An axis-aligned scene bins optimistically: tiles a rect covers
    whole take the trivial-accept bulk winding and list no entries, so
    the natural frame under-predicts what camera motion needs.  Settling
    on the worst counters of both frames lets a program sized to fit
    survive motion without a deferred-growth rebuild on its first moving
    frame; motions the probe cannot foresee still regrow through that
    rebuild."""
    c = math.cos(SETTLE_PROBE_ANGLE)
    s = math.sin(SETTLE_PROBE_ANGLE)
    rot = np.array(
        [[c, -s, 0.0, 0.0],
         [s, c, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]],
        np.float32,
    )
    out = []
    for cmd in commands:
        t = np.asarray(cmd.transform, np.float32)
        rt = rot @ t if t.ndim == 2 else np.einsum(
            "ij,njk->nik", rot, t
        )
        out.append(replace(cmd, transform=rt))
    return out


def _copy_to_host_async(tensor):
    """``(host copy, event)``: on a CUDA device an asynchronous copy into
    pinned host memory and an event after it on the current stream, so
    that a later frame can read the copy without blocking the host; on
    the CPU the tensor itself and no event."""
    if tensor.device.type != "cuda":
        return tensor, None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return host, event


class Renderer:
    """Executes frames of draw commands on one torch device (replaces
    reference Renderer, renderer.rs:408-884).

    ``device`` is where the scene, the binning and the raster run:
    ``"cuda"`` (the default, or ``"cuda:N"``) launches the CUDA kernel
    and raises if no card is visible; nothing falls back to the CPU.
    ``"cpu"``, asked for explicitly, runs the kernel's plain torch
    version (the CPU tests do).

    ``render`` keeps the binning of its last 8 distinct frames and
    re-bins only when the spec, the shapes, the transforms, the dash
    flags or the paint points change.  On a CUDA device a re-binning
    replays a CUDA graph: one per spec and scene (``_prepare``), the
    first miss of each its warm-up, the second its capture, at most
    MAX_BIN_STEPS kept, in one graph memory pool per renderer (a new
    one after an eviction that frees a graph, ``_GraphPool``).  The
    raster kernel runs as one launch on every frame, hit or miss.  What
    ``render`` returns, and what the cache keeps, are tensors of their
    own: a caller may keep any frame."""

    def __init__(
        self,
        config: Configuration,
        width: int,
        height: int,
        tile_size=None,
        tile_capacity: int = 256,
        fill_batch=None,
        stroke_batch: int = 1,
        auto_instance: bool = True,
        tile_strips=None,
        strict_capacity: bool = True,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Renderer(device={device!r}): no CUDA device is available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        self.config = config
        self.width = int(width)
        self.height = int(height)
        #: Tile height; None = auto per scene (see _spec).
        self.tile_h = (
            None if tile_size is None else max(8, min(int(tile_size), 32))
        )
        self.tile_w = 128
        self.tile_capacity = int(tile_capacity)
        #: Fill batch: sets the entry-row padding (FrameSpec.entry_pad);
        #: None = auto per scene.
        self.fill_batch = None if fill_batch is None else int(fill_batch)
        self.stroke_batch = max(1, int(stroke_batch))
        #: Vertical strips per tile; None = auto per scene (see _spec).
        self.tile_strips = None if tile_strips is None else int(tile_strips)
        self._global_capacity = 1024
        self._tile_global_capacity = 32
        self._clip_pool = 64
        self._executors = {}
        self._scene_cache = {}
        self._prepared_cache = {}
        #: Content-keyed cache of small device tensors (command tables,
        #: descriptors, transforms).
        self._upload_cache = {}
        #: Auto-instancing (see _fuse_instance_runs): render() collapses
        #: consecutive per-instance (Stencil, Color) pairs into instanced
        #: draws wherever their cover boxes are disjoint: pixel-exact,
        #: decided per call with the current transforms.  False forces
        #: the literal sequential walk.
        self.auto_instance = bool(auto_instance)
        self._fuse_cache = {}
        #: strict_capacity=True reads the binning overflow counters back
        #: whenever the binning reruns, so no triangle is ever dropped.
        #: False defers the check: the counters copy to the host while
        #: the frame renders and are read on a later frame, so an
        #: animated scene that outgrows its buffers may show one or two
        #: under-populated frames before the capacities regrow.
        self.strict_capacity = bool(strict_capacity)
        #: Deferred counters on a CUDA device: (pinned host copy, the
        #: event after the copy, the capacities they were binned under,
        #: the frame they belong to).
        self._pending_overflow = []
        self._frame_index = 0
        #: Memoized _gate_spans results (see _spec): the analysis walks
        #: every instance row in Python, and render() derives a spec per
        #: frame.
        self._gate_cache = {}
        #: Runtime blend-constant color for the ``constant`` /
        #: ``one_minus_constant`` factors.
        self.blend_constant = (0.0, 0.0, 0.0, 0.0)
        #: Digests of transform stacks already validated finite.
        self._finite_ok = {}
        #: Per-stage counters of the last rendered frame.
        self.stats = {}
        #: Host ms of the last _prepare: the whole call (``prepare_ms``),
        #: of it the binning step's copies in and replay or eager run
        #: (``bin_ms``, 0 on a cache hit), and the capture of the step's
        #: graph on a miss that captured (``capture_ms``).
        self.timing = {}
        #: The side stream of the binning steps' warm-ups and captures
        #: (CUDA only).
        self._side = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" else None
        )
        #: The program name of this renderer's frames in the frame record.
        self._name = RECORD.name("Renderer")
        self._drop_bin_steps()

    @property
    def frame_record(self):
        """The process's frame record (``utils.profiling.FrameRecord``):
        the last frames of every renderer and program, their host spans,
        binning's device marks, and the counters."""
        return RECORD

    # ------------------------------------------------------------------

    def resize(self, width: int, height: int):
        """Change the framebuffer size; scene uploads survive."""
        if (int(width), int(height)) == (self.width, self.height):
            return
        self.width = int(width)
        self.height = int(height)
        self._executors.clear()
        self._prepared_cache.clear()
        self._drop_bin_steps()

    def set_blend_constant(self, color):
        """Set the blend-constant color read by the ``constant`` /
        ``one_minus_constant`` factors."""
        color = np.asarray(color, np.float32).reshape(-1)
        if color.shape != (4,):
            raise ValueError("blend constant must be RGBA")
        require_finite(color, "blend constant")
        self.blend_constant = tuple(float(c) for c in color)

    def _blending(self):
        b = self.config.blending
        return b if isinstance(b, str) else b.canonical()

    def _blend_constant_arg(self):
        return (
            self.blend_constant
            if coverage.blend_uses_constant(self._blending())
            else None
        )

    def _validate(self, commands):
        config = self.config
        for command in commands:
            if isinstance(command.shape, (list, tuple)) and len(
                command.shape
            ) != command.n_instances:
                raise ValueError(
                    f"multi-shape command carries {len(command.shape)} "
                    f"shapes for {command.n_instances} instances"
                )
            if command.clip_depth >= (1 << config.clip_nesting_counter_bits):
                raise ClipStackOverflow(str(command.clip_depth))
            if command.operation in (
                RenderOperation.SAVE_ALPHA_CONTEXT,
                RenderOperation.SCALE_ALPHA_CONTEXT,
                RenderOperation.RESTORE_ALPHA_CONTEXT,
            ) and command.alpha_layer >= config.alpha_layer_count:
                raise TooManyNestedOpacityGroups(str(command.alpha_layer))
            if _paint_kind(command.color):
                if command.operation != RenderOperation.COLOR:
                    raise ValueError(
                        "gradient paints apply only to Color commands"
                    )
                if (
                    self.device.type == "cuda"
                    and _paint_kind(command.color) >= UserPaint.kind
                    and command.color.cuda is None
                ):
                    raise ValueError(
                        "a UserPaint without a `cuda` device function "
                        "cannot be rendered on a CUDA device"
                    )
                continue
            color = np.asarray(command.color)
            if color.ndim == 2 and color.shape[0] not in (
                1, command.n_instances
            ):
                raise ValueError(
                    f"per-instance color count {color.shape[0]} does not "
                    f"match {command.n_instances} instances"
                )

    @staticmethod
    def _pack_transforms(commands) -> np.ndarray:
        """Stack every command's instance transforms into the (R, 4, 4)
        draw-row layout of coverage.draw_tables."""
        rows = [
            np.asarray(c.transform, np.float32).reshape(-1, 4, 4)
            for c in commands
        ]
        return np.ascontiguousarray(np.concatenate(rows))

    def _unique_shapes(self, commands):
        shapes = []
        shape_index = {}
        for command in commands:
            for shape in command.shapes:
                if id(shape) not in shape_index:
                    shape_index[id(shape)] = len(shapes)
                    shapes.append(shape)
        return shapes, shape_index

    @staticmethod
    def _cmd_shape_entry(command, shape_index):
        """FrameSpec.cmd_shape entry for one command: an int, or a
        per-instance tuple for multi-shape commands."""
        if isinstance(command.shape, (list, tuple)):
            return tuple(shape_index[id(s)] for s in command.shape)
        return shape_index[id(command.shape)]

    def _scene_arrays(self, shapes) -> Tuple[tuple, _SceneArrays]:
        key = tuple((s._uid, s._geometry_version) for s in shapes)
        scene = self._scene_cache.get(key)
        if scene is None:
            scene = _SceneArrays(shapes, self.device)
            if len(self._scene_cache) >= 8:
                self._scene_cache.pop(next(iter(self._scene_cache)))
            self._scene_cache[key] = scene
        return key, scene

    def _spec(self, ops, cmd_shape, cmd_inst, scene,
              paints=(), commands=None) -> coverage.FrameSpec:
        """The frame's FrameSpec; given ``commands`` (the optimised
        list), with the gate spans of its clip and alpha brackets."""
        # The reference's density tiers (measured on its TPU, kept so the
        # specs and the binning match it one to one; re-deriving them on
        # this card is later work).
        multi_rows = max(
            (
                sum(scene.tri_counts[s] for s in entry)
                for entry in cmd_shape
                if isinstance(entry, tuple)
            ),
            default=0,
        )
        density = max(scene.t_max, multi_rows)
        # Stroke rows over the actual (command, instance) stencil draws.
        inst = cmd_inst if cmd_inst else (1,) * len(ops)
        s_rows = t_rows = 0
        for o, entry, n in zip(ops, cmd_shape, inst):
            if o != coverage.OP_STENCIL:
                continue
            if isinstance(entry, tuple):
                s_rows += sum(scene.stroke_counts[s] for s in entry)
                t_rows += sum(scene.tri_counts[s] for s in entry)
            else:
                s_rows += n * scene.stroke_counts[entry]
                t_rows += n * scene.tri_counts[entry]
        stroke_dom = s_rows * 2 > max(1, t_rows)
        if density >= 32768:
            auto_tile, auto_batch, auto_strips = 8, 32, 2
        elif density >= 4096:
            auto_tile, auto_batch = 16, 8
            auto_strips = 2 if stroke_dom else 1
        else:
            auto_tile, auto_batch = 32, 2
            auto_strips = 2 if stroke_dom else 1
        spec = coverage.FrameSpec(
            width=self.width,
            height=self.height,
            ops=ops,
            cmd_shape=cmd_shape,
            cmd_inst=cmd_inst,
            paints=paints if any(paints) else (),
            n_shapes=scene.n_shapes,
            t_max=scene.t_max,
            h_max=scene.h_max,
            samples=self.config.msaa_sample_count,
            winding_bits=self.config.winding_counter_bits,
            n_layers=self.config.alpha_layer_count,
            blending=self._blending(),
            depth_compare=self.config.depth_compare,
            depth_write=self.config.depth_write_enabled,
            tile_h=auto_tile if self.tile_h is None else self.tile_h,
            tile_w=self.tile_w,
            tile_strips=(
                auto_strips if self.tile_strips is None else self.tile_strips
            ),
            capacity=self.tile_capacity,
            global_capacity=self._global_capacity,
            tile_global_capacity=self._tile_global_capacity,
            clip_pool=self._clip_pool,
            fill_batch=(
                auto_batch if self.fill_batch is None else self.fill_batch
            ),
            stroke_batch=self.stroke_batch,
            # Keyed on the stroke rows the stencil draws carry, not on
            # descriptor groups (every shape carries at least one).
            has_strokes=s_rows > 0,
        )
        if commands is not None and any(o in _OPENER_OPS for o in ops):
            # Memoized: the analysis is a pure function of the pre-gate
            # spec and the clip depth, layer and machinery opacities of
            # each command, which is the key.
            gkey = (
                spec,
                tuple(
                    (
                        c.clip_depth,
                        c.alpha_layer,
                        _machinery_alphas(c) if _is_mach_op(o) else None,
                    )
                    for o, c in zip(ops, commands)
                ),
            )
            gates = self._gate_cache.get(gkey)
            if gates is None:
                gates = _gate_spans(commands, spec)
                if len(self._gate_cache) >= 32:
                    self._gate_cache.pop(next(iter(self._gate_cache)))
                self._gate_cache[gkey] = gates
            if gates:
                spec = replace(spec, gate_spans=gates)
        return spec

    def _get_executors(self, spec):
        execs = self._executors.get(spec)
        if execs is None:
            execs = (coverage.make_prepare(spec), coverage.make_rasterize(spec))
            self._executors[spec] = execs
        return execs

    #: Binning steps (one per spec and scene) a renderer keeps; past
    #: this the least recently used goes, and with it its graph.  The
    #: showcase orbit's 99 frames auto-instance into 13 groupings, each
    #: a spec of its own.
    MAX_BIN_STEPS = 16

    def _drop_bin_steps(self):
        """Forget every binning step: the next misses warm up and capture
        again, into a new graph memory pool."""
        #: (spec, scene key, input shapes) -> _FrameStep, least recently
        #: used first.
        self._bin_steps = {}
        self._pool = _GraphPool(self.device)

    def _bin_step(self, spec, prepare, scene_key, scene, transforms,
                  desc_static, paint_model) -> "_FrameStep":
        """The binning step of ``spec`` over ``scene``, made on the first
        miss with these inputs, and marked most recently used."""
        key = (
            spec, scene_key, transforms.shape, desc_static.shape,
            None if paint_model is None else paint_model.shape,
        )
        step = self._bin_steps.pop(key, None)
        if step is not None and step.scene_arrays[0] is not scene.xy:
            # The scene was evicted and built anew: other arrays.
            self._pool.dropped(step)
            step = None
        if step is None:
            if len(self._bin_steps) >= self.MAX_BIN_STEPS:
                self._pool.dropped(
                    self._bin_steps.pop(next(iter(self._bin_steps))))
            step = _FrameStep(
                f"the binning of a {spec.width}x{spec.height} frame of "
                f"{spec.n_commands} commands",
                prepare, scene.arrays, transforms,
                _Staged(desc_static, self.device),
                None if paint_model is None
                else _Staged(paint_model, self.device),
                self._pool, self._side,
            )
        self._bin_steps[key] = step
        return step

    @staticmethod
    def _pack_descriptors(shapes):
        tables = [s.descriptors for s in shapes]
        n = sum(len(t.phase) for t in tables)
        desc_f = np.zeros((max(1, n), coverage.DESC_F), np.float32)
        desc_i = np.zeros((max(1, n), coverage.DESC_I), np.int32)
        base = 0
        for t in tables:
            g = len(t.phase)
            desc_f[base:base + g, 0:4] = t.gap_start
            desc_f[base:base + g, 4:8] = t.gap_end
            desc_f[base:base + g, 8] = t.phase
            desc_i[base:base + g, 0:4] = t.end_caps
            desc_i[base:base + g, 4:8] = t.start_caps
            desc_i[base:base + g, 8] = t.last_interval
            desc_i[base:base + g, 9] = t.dashed
            desc_i[base:base + g, 10] = t.join
            desc_i[base:base + g, 11] = t.solid_start_cap
            desc_i[base:base + g, 12] = t.solid_end_cap
            base += g
        return desc_f, desc_i

    @staticmethod
    def _pack_commands_runtime(commands, blend_constant=None):
        """cmd_i (C, 4) = [op, clip depth, alpha layer, paint code] per
        command; cmd_f holds one row per cover draw, in the order
        coverage.draw_tables enumerates them: up to MAX_STOPS stop colors
        (a solid color broadcast to all, so every ramp delta is zero),
        then the stop offsets, plus the blend constant in columns 20:24
        when the state reads it.

        User paints pack as code 3 + i, with i the first-appearance
        index of the paint's ``fn`` in the command walk, the order
        coverage.user_paints derives from FrameSpec.paints."""
        user_codes = {}

        def paint_code(color):
            kind = _paint_kind(color)
            if kind < UserPaint.kind:
                return kind
            return UserPaint.kind + user_codes.setdefault(
                id(color.fn), len(user_codes)
            )

        cmd_i = np.array(
            [
                [int(c.operation), c.clip_depth, c.alpha_layer,
                 paint_code(c.color)]
                for c in commands
            ],
            np.int32,
        )
        rows = []
        for c in commands:
            if c.operation == RenderOperation.STENCIL:
                continue
            if _paint_kind(c.color) >= UserPaint.kind:
                # User paints read the sample position and the anchor.
                rows.append(np.zeros((c.n_instances, 20), np.float32))
                continue
            if _paint_kind(c.color):
                offsets, colors = c.color.stop_table()
                row = np.concatenate([colors.reshape(-1), offsets])[None]
                rows.append(np.broadcast_to(row, (c.n_instances, 20)))
                continue
            color = np.asarray(c.color, np.float32).reshape(-1, 4)
            color = (
                np.broadcast_to(color, (c.n_instances, 4))
                if color.shape[0] == 1
                else color
            )
            rows.append(
                np.concatenate(
                    [
                        np.tile(color, (1, coverage.MAX_STOPS)),
                        np.zeros(
                            (len(color), coverage.MAX_STOPS), np.float32
                        ),
                    ],
                    axis=1,
                )
            )
        cmd_f = (
            np.ascontiguousarray(np.concatenate(rows), dtype=np.float32)
            if rows
            else np.zeros((1, 20), np.float32)
        )
        if blend_constant is not None:
            const = np.broadcast_to(
                np.asarray(blend_constant, np.float32), (len(cmd_f), 4)
            )
            cmd_f = np.ascontiguousarray(
                np.concatenate([cmd_f, const], axis=1)
            )
        return cmd_i, cmd_f

    @staticmethod
    def _pack_paints(commands):
        """Model-space paint points, one (2, 2) row per cover draw
        (coverage.draw_tables order), or None when every paint is
        solid."""
        if not any(_paint_kind(c.color) for c in commands):
            return None
        rows = []
        for c in commands:
            if c.operation == RenderOperation.STENCIL:
                continue
            pts = (
                c.color.points()
                if _paint_kind(c.color)
                else np.zeros((2, 2), np.float32)
            )
            rows.append(np.broadcast_to(pts[None], (c.n_instances, 2, 2)))
        return np.ascontiguousarray(np.concatenate(rows), dtype=np.float32)

    def _dev_cached(self, name: str, arr: np.ndarray, digest=None):
        """Device copy of ``arr``, re-uploaded only when its bytes
        change (keyed on a 16-byte BLAKE2 digest).  On a CUDA device the
        upload goes through pinned memory and does not wait for the
        device (a dash phase that moves every frame re-uploads
        ``desc_f`` every frame)."""
        arr = np.ascontiguousarray(arr)
        if digest is None:
            digest = hashlib.blake2b(arr, digest_size=16).digest()
        key = (name, arr.shape, arr.dtype.str, digest)
        dev = self._upload_cache.get(key)
        if dev is None:
            if len(self._upload_cache) >= 64:
                self._upload_cache.pop(next(iter(self._upload_cache)))
            dev = torch.as_tensor(arr)
            if self.device.type == "cuda":
                dev = dev.pin_memory().to(self.device, non_blocking=True)
            self._upload_cache[key] = dev
        return dev

    def _auto_instanced(self, commands):
        """Memoized _fuse_instance_runs: the grouping is a pure function
        of command structure, transforms and colors, so static frames
        pay one digest instead of re-projecting hulls every call.  The
        key captures every input the fused output embeds, transform
        values included, so a camera change re-derives the grouping."""
        # Structural pre-scan: fusion only ever collapses ADJACENT
        # single-instance (STENCIL, COLOR) pairs of one shape; frames
        # without one (e.g. a 10k-instance multi-shape text frame) skip
        # the digest and grouping entirely.
        if not any(
            commands[i].operation == RenderOperation.STENCIL
            and commands[i].n_instances == 1
            and commands[i + 1].operation == RenderOperation.COLOR
            and commands[i + 1].n_instances == 1
            and commands[i].shape is commands[i + 1].shape
            for i in range(len(commands) - 1)
        ):
            return commands
        structure = tuple(
            (
                int(c.operation),
                tuple((s._uid, s._geometry_version) for s in c.shapes),
                c.clip_depth, c.alpha_layer, c.n_instances,
                # Paints fuse by object identity; their tables are
                # re-read from the (shared) object at pack time.
                id(c.color) if _paint_kind(c.color) else None,
            )
            for c in commands
        )
        blob = hashlib.blake2b(digest_size=16)
        blob.update(self._pack_transforms(commands))
        for c in commands:
            if not _paint_kind(c.color):
                blob.update(np.asarray(c.color, np.float32).tobytes())
        key = (structure, blob.digest())
        hit = self._fuse_cache.get(key)
        if hit is None:
            fused, fused_any = _fuse_instance_runs(commands)
            hit = fused if fused_any else commands
            if len(self._fuse_cache) >= 8:
                self._fuse_cache.pop(next(iter(self._fuse_cache)))
            self._fuse_cache[key] = hit
        return hit

    def _defer_overflow(self, overflow, limits):
        """Queue a non-strict frame's binning counters for a later frame
        (see _consume_overflow) without blocking the host: on a CUDA
        device, an asynchronous copy into pinned host memory and an
        event after it on the current stream.  On the CPU the counters
        are already on the host, so they are read at once."""
        host, event = _copy_to_host_async(overflow)
        if event is None:
            if self._grow_capacities(host.numpy(), limits):
                self._prepared_cache.clear()
            return
        self._pending_overflow.append(
            (host, event, limits, self._frame_index)
        )

    def _consume_overflow(self):
        """Read the deferred counters whose copy has landed, and those two
        frames old in any case (waiting on their event, which by then
        has almost always passed), so capacities regrow within two
        frames; growth drops the binning cache."""
        grew = False
        keep = []
        for host, event, limits, born in self._pending_overflow:
            if event.query() or self._frame_index - born >= 2:
                event.synchronize()
                grew |= self._grow_capacities(host.numpy(), limits)
            else:
                keep.append((host, event, limits, born))
        self._pending_overflow = keep
        if grew:
            self._prepared_cache.clear()

    def _grow_capacities(self, overflow, limits) -> bool:
        grew = False
        if overflow[0] > limits[0]:
            self.tile_capacity = _next_pow2(int(overflow[0]))
            grew = True
        if overflow[1] > limits[1]:
            self._global_capacity = _next_pow2(int(overflow[1]))
            grew = True
        if overflow[2] > limits[2]:
            self._tile_global_capacity = _next_pow2(int(overflow[2]))
            grew = True
        if overflow[3] > limits[3]:
            self._clip_pool = _next_pow2(int(overflow[3]))
            grew = True
        if grew:
            # Every later spec carries the new capacities: the steps of
            # the old ones would never run again.
            self._drop_bin_steps()
        return grew

    # ------------------------------------------------------------------

    def _prepare(self, commands, uint8_kernel=False, graph=True):
        """Validate, pack and bin a frame: returns ``(raster_spec,
        rasterize, runtime_args)``, where ``rasterize(*runtime_args)``
        renders it.  Binning reruns only when the spec, the shapes, the
        transforms, the descriptors' static columns or the paint points
        change (a miss of ``_prepared_cache``, which keeps 8 frames).

        A miss bins through the step of its spec and scene
        (``_FrameStep``, binning only, kept in ``_bin_steps``): on a CUDA
        device the key's first miss runs it eagerly (the warm-up), its
        second captures it as a CUDA graph, and every miss after that
        copies the transforms, ``desc_static`` and the paint points in
        through pinned staging and replays the graph.  A replayed
        frame's binning sits in the step's buffers, which its next miss
        overwrites, so the cache keeps a copy of its own: nothing that
        ``_prepare`` returns or caches aliases a graph's buffer.
        ``graph=False`` bins eagerly outside every step (a settle frame
        met once).  With ``strict_capacity`` the capacities grow until
        nothing overflows, reading the counters back once per binning;
        without it they are read on a later frame (_defer_overflow) and
        a replayed miss waits for nothing on the device.  A growth
        drops every step.

        The call is a frame of the frame record, its spans
        (``Renderer.prepare.<span>`` under torch.profiler) tiling it:
        ``pack`` (validation and packing), ``lookup`` (the spec, its
        executors and the cache), ``step`` (the binning: the step's
        copies in and replay, or its eager run) and ``store`` (the
        counters' read or deferral and the cache's copy); ``timing``
        reads them."""
        frame = RECORD.begin(self._name, "Renderer.prepare",
                             "Renderer.prepare", "pack")
        self.timing = timing = {}
        try:
            return self._prepare_frame(frame, commands, uint8_kernel, graph)
        finally:
            frame.end()
            timing["bin_ms"] = frame.ms("step")
            timing["prepare_ms"] = (frame.ns[-1] - frame.ns[0]) / 1e6

    def _prepare_frame(self, frame, commands, uint8_kernel, graph):
        timing = self.timing
        self._validate(commands)
        commands, _ = _optimize_commands(commands)
        if self.auto_instance:
            commands = self._auto_instanced(commands)
        self._frame_index += 1
        if self._pending_overflow:
            self._consume_overflow()
        shapes, shape_index = self._unique_shapes(commands)
        scene_key, scene = self._scene_arrays(shapes)
        ops = tuple(int(c.operation) for c in commands)
        cmd_shape = tuple(
            self._cmd_shape_entry(c, shape_index) for c in commands
        )
        inst = tuple(c.n_instances for c in commands)
        cmd_inst = inst if any(n != 1 for n in inst) else ()
        paints = tuple(_spec_paint(c.color) for c in commands)
        paint_model = self._pack_paints(commands)
        transforms = self._pack_transforms(commands)
        tf_digest = hashlib.blake2b(transforms, digest_size=16).digest()
        if tf_digest not in self._finite_ok:
            require_finite(transforms, "command transforms")
            if len(self._finite_ok) >= 64:
                self._finite_ok.pop(next(iter(self._finite_ok)))
            self._finite_ok[tf_digest] = True
        desc_f, desc_i = self._pack_descriptors(shapes)
        desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])

        for _attempt in range(4):
            frame.span("lookup")
            spec = self._spec(
                ops, cmd_shape, cmd_inst, scene, paints, commands=commands
            )
            prepare, rasterize = self._get_executors(spec)
            raster_spec = (
                replace(spec, out_uint8=True) if uint8_kernel else spec
            )
            if uint8_kernel:
                rasterize = self._get_executors(raster_spec)[1]
            pkey = (
                spec, scene_key, tf_digest, desc_static.tobytes(),
                None if paint_model is None else paint_model.tobytes(),
            )
            cached = self._prepared_cache.get(pkey)
            if (
                cached is not None
                and self.strict_capacity
                and "max_tile_entries" not in cached[1]
            ):
                # Cached by a non-strict render, without the counters a
                # strict caller needs: recompute.
                cached = None
            if cached is not None:
                prepared, self.stats = cached
                break
            frame.span("step")
            step = None
            if graph:
                step = self._bin_step(
                    spec, prepare, scene_key, scene, transforms,
                    desc_static, paint_model,
                )
                prepared, capture_ms = step(
                    transforms, desc_static, paint_model
                )
                if capture_ms is not None:
                    timing["capture_ms"] = capture_ms
            else:
                prepared = prepare(
                    *scene.arrays,
                    self._dev_cached("transforms", transforms,
                                     digest=tf_digest),
                    self._dev_cached("desc_static", desc_static),
                    None if paint_model is None
                    else self._dev_cached("paints", paint_model),
                )
            frame.span("store")
            limits = (
                spec.capacity,
                spec.global_capacity,
                spec.tile_global_capacity,
                spec.clip_pool,
            )
            stats = {
                "commands": len(commands),
                "shapes": len(shapes),
                "triangles_per_shape": scene.t_max,
                "tiles": spec.n_tiles,
            }
            if self.strict_capacity:
                overflow = prepared.overflow.cpu().numpy()
                stats.update(
                    max_tile_entries=int(overflow[0]),
                    global_triangles=int(overflow[1]),
                    max_tile_globals=int(overflow[2]),
                    near_plane_crossings=int(overflow[3]),
                )
                self.stats = stats
                logger.debug("prepare: %s", self.stats)
                if self._grow_capacities(overflow, limits):
                    continue
            if step is not None and prepared is step.prepared:
                # The step's next call overwrites its buffers.
                prepared = coverage.PreparedFrame(
                    *(t.clone() for t in prepared)
                )
            if not self.strict_capacity:
                self.stats = stats
                self._defer_overflow(prepared.overflow, limits)
            if len(self._prepared_cache) >= 8:
                self._prepared_cache.pop(next(iter(self._prepared_cache)))
            self._prepared_cache[pkey] = (prepared, self.stats)
            break
        else:
            raise RuntimeError("tile binning capacity did not converge")

        frame.span("pack")
        cmd_i, cmd_f = self._pack_commands_runtime(
            commands, self._blend_constant_arg()
        )
        runtime_args = (
            prepared,
            self._dev_cached("cmd_i", cmd_i),
            self._dev_cached("cmd_f", cmd_f),
            self._dev_cached("desc_f", desc_f),
            self._dev_cached("desc_i", desc_i),
        )
        return raster_spec, rasterize, runtime_args

    def render(
        self,
        commands: Sequence[DrawCommand],
        background=None,
        to_host: bool = True,
        as_uint8: bool = False,
        srgb: bool = False,
        carry=None,
        uint8_kernel: bool = False,
    ):
        """Render a frame; returns (H, W, 4) premultiplied RGBA float32,
        or uint8 with ``as_uint8=True`` (quantized on the device).

        ``uint8_kernel=True`` resolves to packed RGBA8 inside the raster
        kernel (bit-identical to quantizing the float output); it does
        not compose with ``background``/``srgb``.  ``to_host=False``
        returns the device tensor instead of a numpy array.

        ``carry`` (a float or a 0-d tensor; implies ``to_host=False``):
        returns ``(image, carry + sum(image[..., 3]))``, the sum in
        float32 on the render's device and stream with no host
        synchronise: a per-frame completion probe that throughput
        harnesses chain from frame to frame.  ``image`` is the raster
        output (float, or packed RGBA8 with ``uint8_kernel``)."""
        if uint8_kernel and (background is not None or srgb):
            raise ValueError(
                "uint8_kernel does not compose with background/srgb"
            )
        _, rasterize, runtime_args = self._prepare(commands, uint8_kernel)
        image = rasterize(*runtime_args)
        if carry is not None:
            return image, self._carry(carry, image)
        if uint8_kernel:
            return image.cpu().numpy() if to_host else image
        if as_uint8:
            if srgb:
                if background is not None:
                    image = self._composite(image, self._background(background))
                image = self._quantize_srgb(image)
            elif background is not None:
                image = self._composite_quantize(
                    image, self._background(background)
                )
            else:
                image = self._quantize(image)
            return image.cpu().numpy() if to_host else image
        if not to_host:
            return image
        image = image.cpu().numpy()
        if background is not None:
            alpha = image[..., 3:4]
            image = image + np.asarray(background, np.float32) * (1.0 - alpha)
        return image

    def compile_frame(
        self, commands: Sequence[DrawCommand], uint8_output: bool = False
    ) -> "FrameProgram":
        """A frame program for this command structure, with the
        transforms as a per-call input (see :class:`FrameProgram`).
        ``uint8_output=True`` resolves to packed RGBA8 inside the kernel,
        the presentation path."""
        return FrameProgram(self, commands, uint8_output=uint8_output)

    def _carry(self, carry, image):
        """carry + the image's alpha summed in float32.  A Python or
        numpy scalar enters as a kernel argument (no host-to-device copy,
        which would synchronise); a tensor is moved to the device."""
        total = image[..., 3].to(torch.float32).sum()
        if isinstance(carry, torch.Tensor):
            return (
                carry.to(device=self.device, dtype=torch.float32) + total
            )
        return torch.add(total, float(np.float32(carry)))

    def _background(self, background):
        return torch.as_tensor(
            np.asarray(background, np.float32), device=self.device
        )

    @staticmethod
    def _quantize(image):
        return (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    @staticmethod
    def _composite(image, background):
        return image + background * (1.0 - image[..., 3:4])

    @staticmethod
    def _composite_quantize(image, background):
        alpha = image[..., 3:4]
        image = image + background * (1.0 - alpha)
        return (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    @staticmethod
    def _quantize_srgb(image):
        """uint8 with sRGB-encoded RGB (alpha stays linear)."""
        image = torch.clamp(image, 0.0, 1.0)
        rgb = image[..., :3]
        rgb = torch.where(
            rgb > 0.0031308,
            1.055 * rgb ** (1.0 / 2.4) - 0.055,
            12.92 * rgb,
        )
        image = torch.cat([rgb, image[..., 3:]], -1)
        return (image * 255.0 + 0.5).to(torch.uint8)


#: FrameSpec capacity fields, in the order of binning's overflow counters.
_CAP_NAMES = (
    "capacity", "global_capacity", "tile_global_capacity", "clip_pool",
)
#: Renderer.stats keys of those counters, in the same order.
_CAP_STATS = (
    "max_tile_entries", "global_triangles", "max_tile_globals",
    "near_plane_crossings",
)


class _ProgramVariant:
    """One command-walk variant of a FrameProgram, the sequential walk or
    a fused one: its FrameSpec, its binning and raster executors, its
    command tables and paint points on the renderer's device, and its
    captured frame step (``_FrameStep``, made by the first frame that
    needs it)."""

    __slots__ = (
        "spec", "opt_commands", "prepare", "rasterize", "paints",
        "packed_constant", "cmd_i", "cmd_f", "step",
    )


class _Staged:
    """A device tensor at a fixed address (a CUDA graph's input), written
    from host arrays through a ring of pinned staging buffers.  A write
    copies with ``non_blocking=True`` and records an event after the
    copy; the host fills a staging buffer again only once its event has
    passed, so it never rewrites one whose copy has not run.  A write of
    the values the tensor holds already is skipped.  On the CPU the
    staging buffers are plain memory and the copy is synchronous."""

    SLOTS = 2
    DTYPES = {np.dtype(np.float32): torch.float32,
              np.dtype(np.int32): torch.int32}

    def __init__(self, array: np.ndarray, device):
        dtype = self.DTYPES[array.dtype]
        self.tensor = torch.empty(array.shape, dtype=dtype, device=device)
        cuda = self.tensor.is_cuda
        self._host = [
            torch.empty(array.shape, dtype=dtype, pin_memory=cuda)
            for _ in range(self.SLOTS)
        ]
        self._events = [
            torch.cuda.Event() if cuda else None for _ in range(self.SLOTS)
        ]
        self._slot = 0
        self._held = None
        self.write(array)

    def write(self, array: np.ndarray):
        if array.shape != tuple(self.tensor.shape):
            raise ValueError(
                f"staged shape {tuple(self.tensor.shape)}, got {array.shape}"
            )
        if self._held is not None and np.array_equal(array, self._held):
            return
        slot = self._slot
        self._slot = (slot + 1) % self.SLOTS
        event = self._events[slot]
        if event is not None:
            event.synchronize()
        host = self._host[slot]
        host.numpy()[...] = array
        self.tensor.copy_(host, non_blocking=True)
        if event is not None:
            event.record(torch.cuda.current_stream(self.tensor.device))
        self._held = np.array(array, copy=True)


def _held(x):
    """The device tensor of a step input: a ``_Staged`` buffer's, or the
    tensor (or None) itself."""
    return x.tensor if isinstance(x, _Staged) else x


def _new_graph_pool(device):
    """A new CUDA graph memory pool handle on a CUDA device, else None."""
    return (
        torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    )


class _GraphPool:
    """The graph memory pool that an owner's frame steps capture into.

    A step reads ``handle`` when it captures, not when it is made.
    PyTorch's allocator gives a pool up once every graph captured into it
    is freed, and then refuses a capture into it (``use_count > 0``).  So
    an owner that drops a step and keeps others calls ``dropped``: when
    that frees a captured graph, the pool is renewed, and every step that
    captures after it, made before or after, captures into the new one.
    Graphs captured already keep the old pool alive.  On the CPU the
    handle is None."""

    __slots__ = ("device", "handle")

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = _new_graph_pool(self.device)

    def dropped(self, step):
        """Note that the owner drops ``step`` (a ``_FrameStep`` or None)."""
        if step is not None and step.graph is not None:
            self.handle = _new_graph_pool(self.device)


class _FrameStep:
    """A frame's binning, and with ``raster`` its raster too, as one CUDA
    graph: the port's counterpart of the reference's ``jax.jit`` of its
    executors (contrast_renderer_tpu/renderer.py,
    ``Renderer._get_executors`` and ``FrameProgram._build_variant``;
    parallel/mesh.py, the ``jax.jit(shard_map(...))`` of a frame).  Its
    owners: ``Renderer._prepare`` (binning only, one step per spec and
    scene), each ``FrameProgram`` variant and each rect of a sharded
    program (binning and raster).

    Every device input stays at one address: the transform stack
    (``_Staged``, written by each call); ``desc_static`` and the paint
    points (each a ``_Staged`` written by the call or by the owner, or a
    tensor fixed for the step's life); the scene arrays; and with a
    raster ``(cmd_i, cmd_f, desc_f, desc_i)``, tensors or ``_Staged``.
    The outputs are static too: ``prepared``, the ``PreparedFrame`` that
    the capture allocated, and with a raster ``frame``.  A call returns
    ``(prepared, capture ms or None)``; whatever the owner keeps past the
    step's next call it copies out first.

    On a CUDA device the first call runs the step on the owner's side
    stream (the warm-up that capture needs: it loads the kernel library
    and makes ``make_prepare``'s device constants) and returns that
    run's own ``prepared``.  The second call captures the step into a
    graph in the memory pool that the owner holds then (``pool``, a
    ``_GraphPool``), and it and every later call replay
    the graph, adding its captured kernel launches to the frame record's
    ``raster_launches`` and ``cover_bin_launches``; so a step met once
    never pays a capture.  The
    warm-up and the capture are spans of the frame record
    (``FrameStep.warm_up``, ``FrameStep.capture``), which counts the
    graph's nodes at the capture and gives each replay's binning its row
    of the device marks.  A failed capture or replay raises, naming the
    step.  On the CPU every call runs the step eagerly and copies its
    binning into ``prepared``, as a replay leaves it."""

    def __init__(self, name, prepare, scene_arrays, transforms: np.ndarray,
                 desc_static, paints, pool, side, raster=None):
        self.device = scene_arrays[0].device
        # Functions and tensors, never the owner: without a reference
        # cycle a step (and its graph) is freed when its owner drops it,
        # never by a collection.
        self._prepare = prepare
        self.scene_arrays = scene_arrays
        self.transforms = _Staged(transforms, self.device)
        self._inputs = (self.transforms, desc_static, paints)
        #: (spec, rasterize, (cmd_i, cmd_f, desc_f, desc_i)) or None.
        self._raster = raster
        self.frame = None
        if raster is not None:
            spec = raster[0]
            self.frame = torch.empty(
                (spec.height, spec.width, 4),
                dtype=torch.uint8 if spec.out_uint8 else torch.float32,
                device=self.device,
            )
        self.prepared = None
        self._warm = False
        self.graph = None
        #: The frame record's account of the capture (profiling.Capture):
        #: its binnings and the graph's nodes.
        self._captured = None
        #: Kernel launches that one replay makes, by the frame record's
        #: launch counter (profiling.LAUNCH_COUNTERS).
        self.replay_launches = dict.fromkeys(LAUNCH_COUNTERS, 0)
        #: Host ms of the capture (and the graph's instantiation).
        self.capture_ms = None
        self.name = name
        self._pool = pool
        self._side = side

    def _step(self):
        prepared = self._prepare(
            *self.scene_arrays, *(_held(x) for x in self._inputs)
        )
        if self._raster is not None:
            _, rasterize, tables = self._raster
            rasterize(prepared, *(_held(t) for t in tables), self.frame)
        return prepared

    def _warm_up(self):
        """Run the step on the side stream; returns its binning (its
        frame is in ``self.frame``)."""
        with Span("FrameStep", "warm_up"):
            stream = torch.cuda.current_stream(self.device)
            self._side.wait_stream(stream)
            with torch.cuda.stream(self._side):
                prepared = self._step()
            stream.wait_stream(self._side)
            for t in prepared:
                t.record_stream(stream)
        self._warm = True
        return prepared

    def _capture(self):
        """Capture the step into ``self.graph``; returns the host ms."""
        before = {c: RECORD.counters[c] for c in LAUNCH_COUNTERS.values()}
        graph = torch.cuda.CUDAGraph()
        # A collection during the capture could free another graph, which
        # a capture forbids (and which ends it).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with Capture() as captured:
                with torch.cuda.stream(self._side):
                    graph.capture_begin(pool=self._pool.handle)
                    try:
                        self.prepared = self._step()
                        captured.seal(self._side)
                    finally:
                        graph.capture_end()
        except RuntimeError as exc:
            raise RuntimeError(f"capturing {self.name} failed") from exc
        finally:
            if collecting:
                gc.enable()
        self.replay_launches = {
            name: RECORD.counters[captures] - before[captures]
            for name, captures in LAUNCH_COUNTERS.items()
        }
        self.graph = graph
        self._captured = captured
        self.capture_ms = captured.ms
        return self.capture_ms

    @property
    def launches(self):
        """Raster kernel launches that one replay makes."""
        return self.replay_launches["raster_launches"]

    @property
    def nodes(self):
        """Nodes of the captured graph, the frame record's marks left
        out; None before a capture (and on the CPU)."""
        return None if self._captured is None else self._captured.nodes

    @property
    def stage_nodes(self):
        """The captured graph's nodes by stage of binning
        (``profiling.STAGES``), the marks left out; None before a
        capture."""
        return None if self._captured is None else self._captured.stage_nodes

    def capture(self):
        """Warm up (a frame of the staged inputs) and capture now, on a
        CUDA device, unless captured already; nothing on the CPU."""
        if self.device.type == "cuda" and self.graph is None:
            if not self._warm:
                self._warm_up()
            self._capture()

    def __call__(self, transforms: np.ndarray, desc_static=None,
                 paints=None):
        """Write ``transforms`` (and ``desc_static`` and ``paints`` where
        given, into the step's own staged buffers) and run the step:
        ``(prepared, capture ms or None)``."""
        for staged, array in zip(self._inputs,
                                 (transforms, desc_static, paints)):
            if array is not None:
                staged.write(array)
        if self.device.type != "cuda":
            prepared = self._step()
            if self.prepared is None:
                self.prepared = prepared
            else:
                for own, new in zip(self.prepared, prepared):
                    own.copy_(new)
            return self.prepared, None
        if not self._warm:
            return self._warm_up(), None
        capture_ms = None if self.graph is not None else self._capture()
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise RuntimeError(f"replaying {self.name} failed") from exc
        RECORD.replayed(self._captured)
        for name, n in self.replay_launches.items():
            RECORD.count(name, n)
        return self.prepared, capture_ms


class FrameProgram:
    """A frame step for a fixed command structure, with the instance
    transforms as a per-call input: the moving-camera path (the camera is
    just a matrix, examples/showcase/main.rs:255-274).

    ``Renderer.render`` keys its binning cache on the transform bytes,
    which suits a still camera; a moving one bins every frame.  Here
    each call takes an (R, 4, 4) transform stack, bins it
    (``make_prepare``) and runs the raster kernel once.  On a CUDA
    device each variant's binning and raster are one CUDA graph
    (``_FrameStep``): the variant's first frame is the warm-up, its
    second captures the graph (``plan_for_motion`` captures its plan's
    ahead), and every frame from then on replays it; the variants
    of a program share one graph memory pool (a new one after
    ``plan_for_motion`` evicts a captured grouping) and replay one after
    another on the caller's stream.  On the CPU the same step runs
    eagerly.  A rebuild (capacity growth, a geometry edit, a new scene
    size) drops the graphs, and the next frames capture again.

    Runs of single-instance (STENCIL, COLOR) pairs are found once, by
    structure (``_structural_runs``); each call groups them by cover
    disjointness under its own transforms and dispatches a cached
    grouping's fused variant where one holds, or the sequential walk.
    Either gives the same pixels.  A grouping derived from a frame is
    built only once it has been derived twice among the last
    ``SIG_WINDOW`` derivations (the reference's compile hysteresis:
    continuous motion derives a new grouping nearly every frame), and
    the frames until then walk in sequence.  ``plan_for_motion`` fixes
    one grouping for a whole camera path.

    Dash phases animate through ``Shape.set_dynamic_stroke_options``
    (descriptors are packed every call) and the blend constant through
    ``Renderer.set_blend_constant``, with no rebuild.  Capacities start
    shrunk to fit two settle frames; binning overflow is read a few
    frames late (a CUDA event behind a pinned copy, forced at
    ``OVERFLOW_MAX_LAG`` frames), so a scene that outgrows them renders
    at most that many under-populated frames before the program
    rebuilds at larger capacities.
    """

    #: Distinct fused groupings kept per program.  Motion that keeps
    #: re-grouping the scene past this many variants walks in sequence.
    MAX_FUSED_VARIANTS = 8

    #: Frames an unread overflow counter may age before the host waits
    #: on it: the most under-populated frames a growing scene renders.
    OVERFLOW_MAX_LAG = 16

    #: Derived grouping signatures whose counts the hysteresis keeps.
    SIG_WINDOW = 64

    def __init__(self, renderer: Renderer, commands: Sequence[DrawCommand],
                 uint8_output: bool = False):
        self._renderer = renderer
        self._commands = list(commands)
        #: Resolve to packed RGBA8 inside the kernel: frames come back
        #: (H, W, 4) uint8, equal to Renderer._quantize of the float path.
        self._uint8 = bool(uint8_output)
        renderer._validate(self._commands)
        # The kernel walks the optimized list (SAVE+SCALE pairs fused);
        # callers' stacks keep one row per public draw and are gathered
        # through _keep_rows.
        opt, self._keep_rows = _optimize_commands(self._commands)
        self._opt_commands = opt
        self._shapes, _ = renderer._unique_shapes(opt)
        self._runs = _structural_runs(opt) if renderer.auto_instance else []
        # Settle the capacities on two strict frames, the natural one and
        # a rotated probe (see _rotated_probe_commands); the renderer's
        # stats go back to the natural frame's.
        # Binned eagerly: the renderer's binning steps are for frames a
        # caller renders.
        was_strict = renderer.strict_capacity
        renderer.strict_capacity = True
        try:
            renderer._prepare(self._commands, graph=False)
            natural_stats = dict(renderer.stats)
            stats = dict(natural_stats)
            renderer._prepare(
                _rotated_probe_commands(self._commands), graph=False
            )
            for key in _CAP_STATS:
                if key in renderer.stats:
                    stats[key] = max(stats.get(key, 0), renderer.stats[key])
            renderer.stats = natural_stats
        finally:
            renderer.strict_capacity = was_strict
        # Shrink to fit: oversized capacities cost every frame (binning
        # materialises O(tiles x K) rows), so the program runs at
        # next-pow2(count x 1.5) with floors, clamped to the renderer's.
        self._caps = {
            name: _fit_capacity(stats.get(key, ceiling), floor_, ceiling)
            for name, key, floor_, ceiling in zip(
                _CAP_NAMES, _CAP_STATS, FIT_FLOORS, self._ceilings()
            )
        }
        #: Deferred overflow counters: (host copy, event or None, frame).
        self._pending = []
        self._frame = 0
        #: Builds of the program, the first included (a capacity growth
        #: or a geometry edit rebuilds it).
        self.builds = 0
        #: The last call's host times in ms, from its spans in the frame
        #: record: choosing the variant (``plan_ms``, the ``plan`` span);
        #: packing the descriptors, the copies in and the graph's replay
        #: (``bin_ms``, ``stage`` and ``replay``); the copy out, carry and
        #: overflow upkeep (``raster_ms``, ``out``); on a frame that
        #: captured its variant's graph, the capture (``capture_ms``,
        #: within ``bin_ms``); and whether the frame was fused.  The
        #: ``upkeep`` span before them (the transforms' checks, the
        #: deferred overflow counters, geometry edits, the blend
        #: constant) is in none of them.
        self.stats = {}
        #: The program name of this program's frames in the frame record.
        self._name = RECORD.name("FrameProgram")
        #: The side stream of warm-ups and captures (CUDA only).
        self._side = (
            torch.cuda.Stream(renderer.device)
            if renderer.device.type == "cuda" else None
        )
        self._build()

    def _build(self):
        renderer = self._renderer
        _, self._scene = renderer._scene_arrays(self._shapes)
        self._seq = self._build_variant(self._opt_commands)
        #: grouping signature -> (plan, variant), emptied so that new
        #: capacities apply to every fused variant.
        self._fused_variants = {}
        #: How often each grouping not built was derived, oldest first,
        #: at most SIG_WINDOW (the hysteresis of _try_fused).
        self._sig_counts = {}
        self._drop_steps()
        self._plan = None
        self.builds += 1
        if self._runs:
            plan = self._derive_plan(
                Renderer._pack_transforms(self._opt_commands)
            )
            if plan is not None:
                self._install(plan)
                self._plan = plan

    def _variant_spec(self, opt_commands) -> coverage.FrameSpec:
        """The FrameSpec of one command-walk variant (shared by
        _build_variant and plan_for_motion's capacity scout)."""
        renderer = self._renderer
        _, shape_index = renderer._unique_shapes(opt_commands)
        ops = tuple(int(c.operation) for c in opt_commands)
        cmd_shape = tuple(
            Renderer._cmd_shape_entry(c, shape_index) for c in opt_commands
        )
        paints = tuple(_spec_paint(c.color) for c in opt_commands)
        inst = tuple(c.n_instances for c in opt_commands)
        cmd_inst = inst if any(n != 1 for n in inst) else ()
        spec = renderer._spec(
            ops, cmd_shape, cmd_inst, self._scene, paints,
            commands=opt_commands,
        )
        spec = replace(spec, **self._caps)
        if self._uint8:
            spec = replace(spec, out_uint8=True)
        return spec

    def _build_variant(self, opt_commands) -> _ProgramVariant:
        """One command-walk variant.  Its kernel library is keyed on
        features that every variant of the program shares, and is loaded
        by the first frame; on a CUDA device the second frame captures
        the variant's graph."""
        renderer = self._renderer
        spec = self._variant_spec(opt_commands)
        v = _ProgramVariant()
        v.spec = spec
        v.opt_commands = opt_commands
        v.prepare = coverage.make_prepare(spec)
        v.rasterize = coverage.make_rasterize(spec)
        v.paints = self._device_paints(opt_commands)
        # cmd_f carries the blend constant where the state reads it;
        # _ensure_constant re-packs it when it changes.
        v.packed_constant = renderer._blend_constant_arg()
        cmd_i, cmd_f = Renderer._pack_commands_runtime(
            opt_commands, v.packed_constant
        )
        v.cmd_i = torch.as_tensor(cmd_i, device=renderer.device)
        v.cmd_f = torch.as_tensor(cmd_f, device=renderer.device)
        v.step = None
        return v

    def _device_paints(self, opt_commands):
        """The paint points of the commands' cover draws on the renderer's
        device, or None when every paint is solid."""
        paint_model = Renderer._pack_paints(opt_commands)
        return (
            None if paint_model is None
            else torch.as_tensor(paint_model, device=self._renderer.device)
        )

    def _install(self, plan) -> _ProgramVariant:
        """Build ``plan``'s variant and cache it under its signature."""
        variant = self._build_variant(plan.commands)
        self._fused_variants[plan.signature] = (plan, variant)
        return variant

    def _variants(self):
        return (self._seq,) + tuple(
            v for _, v in self._fused_variants.values()
        )

    def _ensure_constant(self, v):
        """Re-pack a variant's cmd_f when the renderer's blend constant
        changed since its last pack (no rebuild: cmd_f is an input,
        written in place where the variant's graph reads it)."""
        constant = self._renderer._blend_constant_arg()
        if constant != v.packed_constant:
            v.packed_constant = constant
            _, cmd_f = Renderer._pack_commands_runtime(
                v.opt_commands, constant
            )
            v.cmd_f.copy_(torch.from_numpy(cmd_f))

    def _refresh_cmd_f(self):
        for v in self._variants():
            self._ensure_constant(v)

    def _escape_allowed(self, r) -> bool:
        """Whether the overlap escape (_run_overlap_escape) may apply to
        run ``r`` under the renderer's state: an idempotent blend, no
        depth test or write, and winding headroom for the summed
        instances."""
        config = self._renderer.config
        return (
            r.escape
            and _idempotent_blend(config.blending)
            and config.depth_compare == "always"
            and not config.depth_write_enabled
            and len(r.pairs)
            <= (1 << (config.winding_counter_bits - 1)) - 1
        )

    @staticmethod
    def _rows_equal(transforms, srows, crows) -> bool:
        return np.array_equal(transforms[srows], transforms[crows])

    def _derive_plan(self, transforms):
        """The grouping of every structural run under the given
        optimized-layout transforms, as a _FusionPlan, or None when
        nothing fuses.  Runs the overlap escape allows fuse whole where
        every projection is well-defined with one orientation sign;
        the others group greedily by cover disjointness."""
        groupings = []
        for r in self._runs:
            boxes, ok, polys = _run_boxes(
                r.shape, transforms[r.stencil_rows]
            )
            # A fused draw shares one transform row per instance: pairs
            # whose stencil and cover rows differ never fuse.
            for k, (s, c) in enumerate(
                zip(r.stencil_rows, r.cover_rows)
            ):
                if ok[k] and not np.array_equal(
                    transforms[s], transforms[c]
                ):
                    ok[k] = False
            if self._escape_allowed(r) and ok.all():
                signs = _poly_orientation_signs(polys)
                if signs[0] != 0.0 and np.all(signs == signs[0]):
                    groupings.append(
                        ((tuple(range(len(r.pairs))),), True)
                    )
                    continue
            groupings.append((_greedy_box_groups(boxes, ok, polys), False))
        return _plan_for_groups(self._opt_commands, self._runs, groupings)

    def _plan_transforms_if_valid(self, plan, transforms):
        """The fused-layout transform stack when this frame's transforms
        keep ``plan`` exact, else None.  Escape groups need equal stencil
        and cover rows, well-defined projections and one orientation
        sign; disjointness groups need pairwise disjoint covers."""
        for shape, srows, crows, escape in plan.groups:
            if not self._rows_equal(transforms, srows, crows):
                return None
            boxes, ok, polys = _run_boxes(shape, transforms[srows])
            if not ok.all():
                return None
            if escape:
                signs = _poly_orientation_signs(polys)
                if signs[0] == 0.0 or not np.all(signs == signs[0]):
                    return None
                continue
            disjoint = (
                (boxes[:, None, 2] < boxes[None, :, 0])
                | (boxes[None, :, 2] < boxes[:, None, 0])
                | (boxes[:, None, 3] < boxes[None, :, 1])
                | (boxes[None, :, 3] < boxes[:, None, 1])
            )
            np.fill_diagonal(disjoint, True)
            if not disjoint.all():
                # Boxes touch: the hull polygons may still be apart.
                for i, j in zip(*np.nonzero(~disjoint)):
                    if i < j and not _convex_polys_disjoint(
                        polys[i], polys[j]
                    ):
                        return None
        return np.ascontiguousarray(transforms[plan.gather])

    def _try_fused(self, transforms, derive=True):
        """(variant, fused-layout transforms) for this frame, or None for
        the sequential walk.

        The active plan is re-validated first, then the other cached
        groupings (host work: boxes and separating axes).  If none holds,
        a grouping is derived from the frame and counted; once it has
        been derived twice among the last SIG_WINDOW derivations its
        variant is built, room permitting (MAX_FUSED_VARIANTS).  The
        frame itself walks in sequence either way, and the grouping
        serves later frames from the cache.  The reference builds on a
        background thread, since its build is a compile of seconds; here
        a build makes a spec and two executors over kernel libraries the
        program has loaded already (chip_smoke.py times it), and the
        variant's graph is captured by its second frame.  ``derive=False``
        (eager checks of a frame, ``_bin``) chooses as a frame would, but
        derives and counts nothing."""
        if self._plan is not None:
            tf = self._plan_transforms_if_valid(self._plan, transforms)
            if tf is not None:
                return self._fused_variants[self._plan.signature][1], tf
        for plan, variant in self._fused_variants.values():
            if plan is self._plan:
                continue
            tf = self._plan_transforms_if_valid(plan, transforms)
            if tf is not None:
                self._plan = plan
                return variant, tf
        self._plan = None
        if (not derive
                or len(self._fused_variants) >= self.MAX_FUSED_VARIANTS):
            return None
        plan = self._derive_plan(transforms)
        if plan is None:
            return None
        sig = plan.signature
        count = self._sig_counts.get(sig, 0) + 1
        self._sig_counts[sig] = count
        if len(self._sig_counts) > self.SIG_WINDOW:
            self._sig_counts.pop(next(iter(self._sig_counts)))
        if count >= 2 and sig not in self._fused_variants:
            self._install(plan)
        return None

    def plan_for_motion(self, transforms_seq, wait=True,
                        timeout=600.0) -> bool:
        """Derive one fused grouping that stays exact across every
        transform stack of ``transforms_seq`` (the frames of a camera
        path, each in the public layout of ``__call__``), size the
        capacities for every one of those frames, build the grouping's
        variant, capture its graph and make it the active plan.

        Pairs fuse only where their covers are disjoint (or the overlap
        escape holds) in every frame, so one variant serves the whole
        path; each call still re-validates, so motion beyond the path
        walks in sequence, never renders a wrong frame.  Returns True
        when the plan's variant is built and active; False when nothing
        fuses across the motion, or when MAX_FUSED_VARIANTS leaves no
        room for its variant.  ``wait`` and ``timeout`` are the
        reference's, whose compile runs on a background thread; here the
        build and capture are done when the call returns, so neither
        changes anything."""
        if not self._runs:
            return False
        stacks = [self._opt_rows(t) for t in transforms_seq]
        if not stacks:
            return False
        groupings = []
        for r in self._runs:
            per = [
                _run_boxes(r.shape, t[r.stencil_rows]) for t in stacks
            ]
            ok_all = np.logical_and.reduce([ok for _, ok, _ in per])
            for k, (s, c) in enumerate(
                zip(r.stencil_rows, r.cover_rows)
            ):
                if ok_all[k] and not all(
                    np.array_equal(t[s], t[c]) for t in stacks
                ):
                    ok_all[k] = False
            if self._escape_allowed(r) and ok_all.all():
                sign_ok = True
                for _, _, polys in per:
                    signs = _poly_orientation_signs(polys)
                    if signs[0] == 0.0 or not np.all(signs == signs[0]):
                        sign_ok = False
                        break
                if sign_ok:
                    groupings.append(
                        ((tuple(range(len(r.pairs))),), True)
                    )
                    continue
            groupings.append(
                (
                    _greedy_box_groups_multi(
                        [(boxes, polys) for boxes, _, polys in per],
                        ok_all,
                    ),
                    False,
                )
            )
        plan = _plan_for_groups(self._opt_commands, self._runs, groupings)
        if plan is None:
            return False
        # Capacity scout over every frame of the path (the reference
        # samples one frame in len/128 past 128 frames and can undersize
        # the frames it skips): near-plane crossings fill the clip pool
        # and spread huge covers over many tiles, and each overflow found
        # mid-motion would cost under-populated frames and a rebuild.
        renderer = self._renderer
        paints = self._device_paints(plan.commands)
        desc_static = torch.as_tensor(
            self._descriptors()["static"], device=renderer.device
        )
        grew_any = False
        for _round in range(6):
            worst = self._scout(plan, stacks, desc_static, paints)
            grew = False
            for i, name in enumerate(_CAP_NAMES):
                if int(worst[i]) > self._caps[name]:
                    # Exact fit: the scout saw the path's true worst.
                    self._caps[name] = _next_pow2(int(worst[i]))
                    grew = True
            if not grew:
                break
            renderer._grow_capacities(worst, self._ceilings())
            grew_any = True
        if grew_any:
            self._build()
        if plan.signature not in self._fused_variants:
            if self.MAX_FUSED_VARIANTS < 1:
                return False
            # A motion plan outranks groupings cached on the way: evict
            # the oldest (the active plan is replaced just below).
            while len(self._fused_variants) >= self.MAX_FUSED_VARIANTS:
                _, evicted = self._fused_variants.pop(
                    next(iter(self._fused_variants)))
                self._pool.dropped(evicted.step)
            self._install(plan)
        self._plan, variant = self._fused_variants[plan.signature]
        # Capture the plan's graph now, so that the motion's frames
        # replay from the first.
        self._stage_descriptors()
        first = np.ascontiguousarray(stacks[0][plan.gather])
        self._frame_step(variant, first).capture()
        return True

    def _scout(self, plan, stacks, desc_static, paints):
        """One round of plan_for_motion's capacity scout: every frame of
        ``stacks`` binned under ``plan`` at the program's capacities by a
        binning-only step of that round's spec (on a CUDA device warmed
        up by the first frame, captured by the second and replayed for
        the rest, in a graph pool of its own), its overflow counters
        reduced by max on the device and read once.  Returns them."""
        spec = self._variant_spec(plan.commands)
        step = _FrameStep(
            f"the capacity scout of a {spec.width}x{spec.height} "
            f"FrameProgram",
            coverage.make_prepare(spec), self._scene.arrays,
            np.ascontiguousarray(stacks[0][plan.gather]), desc_static,
            paints, _GraphPool(self._renderer.device), self._side,
        )
        worst = None
        for t in stacks:
            overflow = step(np.ascontiguousarray(t[plan.gather]))[0].overflow
            worst = (
                overflow.clone() if worst is None
                else torch.maximum(worst, overflow)
            )
        return worst.cpu().numpy()

    def wait_fused_compiles(self, timeout=None) -> bool:
        """True: variants build and capture their graphs in the calling
        thread, so none is ever in flight (the reference's background
        compiles are waited on here, up to ``timeout`` seconds)."""
        return True

    def _ceilings(self):
        renderer = self._renderer
        return (
            renderer.tile_capacity, renderer._global_capacity,
            renderer._tile_global_capacity, renderer._clip_pool,
        )

    def _sync(self):
        """Per-call upkeep of __call__ and render_sequence: read the
        overflow counters whose copy has landed (and those
        OVERFLOW_MAX_LAG frames old in any case), growing the program's
        capacities with x2 headroom, and pick up geometry edits
        (Shape.update_paths); either may rebuild the program."""
        renderer = self._renderer
        grew = False
        keep = []
        for host, event, born in self._pending:
            if (
                event is None
                or event.query()
                or self._frame - born >= self.OVERFLOW_MAX_LAG
            ):
                if event is not None:
                    event.synchronize()
                worst = host.numpy()
                for i, name in enumerate(_CAP_NAMES):
                    if int(worst[i]) > self._caps[name]:
                        # A sweep that overflowed once tends to keep
                        # growing, and every growth is a rebuild.
                        self._caps[name] = _next_pow2(int(worst[i]) * 2)
                        grew = True
                renderer._grow_capacities(worst, self._ceilings())
            else:
                keep.append((host, event, born))
        self._pending = keep
        if grew:
            self._build()
        # A geometry edit re-enters through the scene cache; a changed
        # padded size rebuilds the program, new arrays of the same size
        # drop the graphs, which read the old ones.
        _, scene = renderer._scene_arrays(self._shapes)
        if (scene.t_max, scene.h_max) != (
            self._scene.t_max, self._scene.h_max
        ):
            self._scene = scene
            self._build()
        elif scene is not self._scene:
            self._scene = scene
            self._drop_steps()

    def _opt_rows(self, transforms):
        """One frame's public (R, 4, 4) stack, one row per command
        instance before fusion, validated and gathered to the optimized
        layout; the commands' own transforms for None."""
        if transforms is None:
            return Renderer._pack_transforms(self._opt_commands)
        transforms = np.ascontiguousarray(transforms, np.float32).reshape(
            -1, 4, 4
        )
        # Validate before the gather: a longer stack would index in range
        # and render with misattributed rows.
        expected = sum(c.n_instances for c in self._commands)
        if transforms.shape[0] != expected:
            raise ValueError(
                f"expected {expected} transform rows (one per command "
                f"instance, pre-fusion), got {transforms.shape[0]}"
            )
        if self._keep_rows is not None:
            transforms = transforms[self._keep_rows]
        return transforms

    def _descriptors(self):
        """The program's stroke descriptors, packed anew every call so
        that dash phases animate: numpy ``static`` (desc_static), ``f``
        and ``i``."""
        desc_f, desc_i = Renderer._pack_descriptors(self._shapes)
        return {
            "static": np.ascontiguousarray(desc_i[:, [9, 8]]),
            "f": desc_f,
            "i": desc_i,
        }

    def _drop_steps(self):
        """Forget every variant's frame step and the staged descriptors:
        the next frame of each variant captures again, into a new
        memory pool."""
        for v in self._variants():
            v.step = None
        self._desc = None
        self._pool = _GraphPool(self._renderer.device)

    def _stage_descriptors(self):
        """Write this call's descriptors into the staged buffers that
        every variant's step reads; a change of their shapes drops the
        steps."""
        arrays = self._descriptors()
        if self._desc is not None and any(
            tuple(self._desc[k].tensor.shape) != a.shape
            for k, a in arrays.items()
        ):
            self._drop_steps()
        if self._desc is None:
            self._desc = {
                k: _Staged(a, self._renderer.device)
                for k, a in arrays.items()
            }
        else:
            for k, a in arrays.items():
                self._desc[k].write(a)

    def _frame_step(self, variant, transforms) -> _FrameStep:
        """The variant's step, made on first use with this frame's
        transforms (after ``_stage_descriptors``)."""
        if variant.step is None:
            d, spec = self._desc, variant.spec
            variant.step = _FrameStep(
                f"the {len(variant.opt_commands)}-command variant of a "
                f"{spec.width}x{spec.height} FrameProgram",
                variant.prepare, self._scene.arrays, transforms,
                d["static"], variant.paints, self._pool, self._side,
                raster=(spec, variant.rasterize,
                        (variant.cmd_i, variant.cmd_f, d["f"], d["i"])),
            )
        return variant.step

    def _choose(self, transforms, derive=True):
        """The frame's variant and its transforms in that variant's
        layout: the fused grouping that holds, or the sequential walk
        (see _try_fused for ``derive``)."""
        if self._runs:
            fused = self._try_fused(transforms, derive)
            if fused is not None:
                return fused
        return self._seq, transforms

    def _bin(self, transforms):
        """Choose the frame's variant as a frame would (deriving and
        counting no grouping) and bin the frame eagerly with the
        variant's own ``prepare``, outside its graph, on inputs of its
        own: returns ``(variant, runtime)``, where
        ``variant.rasterize(*runtime)`` renders it.  For checks and
        measurement; frames replay the variant's step."""
        variant, transforms = self._choose(transforms, derive=False)
        dev = self._renderer.device
        d = {k: torch.as_tensor(a, device=dev)
             for k, a in self._descriptors().items()}
        prepared = variant.prepare(
            *self._scene.arrays, torch.as_tensor(transforms, device=dev),
            d["static"], variant.paints,
        )
        return variant, (prepared, variant.cmd_i, variant.cmd_f, d["f"],
                         d["i"])

    def _defer(self, overflow):
        self._pending.append((*_copy_to_host_async(overflow), self._frame))

    def __call__(self, transforms=None, carry=None):
        """Render one frame; returns the (H, W, 4) image on the device, a
        new tensor each call.  ``transforms``: an (R, 4, 4) row-major
        model-to-clip stack, one row per (command, instance) draw of the
        commands as given (the commands' own transforms for None).

        ``carry``: with it, returns ``(image, carry + sum(image[...,
        3]))``, the sum on the device with no host synchronise (see
        ``Renderer.render``).

        The call is a frame of the frame record, its five spans
        (``FrameProgram.<span>`` under torch.profiler) tiling it:
        ``upkeep``, ``plan``, ``stage``, ``replay`` and ``out``."""
        frame = RECORD.begin(self._name, "FrameProgram", "FrameProgram",
                             "upkeep")
        try:
            transforms = self._opt_rows(transforms)
            require_finite(transforms, "frame transforms")
            self._frame += 1
            self._sync()
            self._refresh_cmd_f()
            frame.span("plan")
            variant, transforms = self._choose(transforms)
            frame.span("stage")
            self._stage_descriptors()
            frame.span("replay")
            step = self._frame_step(variant, transforms)
            prepared, capture_ms = step(transforms)
            frame.span("out")
            # The step's frame is overwritten by its next replay.
            image = step.frame.clone()
            if carry is not None:
                carry = self._renderer._carry(carry, image)
            self._defer(prepared.overflow)
            fused = variant is not self._seq
        finally:
            frame.end()
        # The boundaries of upkeep, plan, stage, replay, out and the end.
        _, plan, stage, _, out, end = frame.ns
        self.stats = {
            "fused": fused,
            "plan_ms": (stage - plan) / 1e6,
            "bin_ms": (out - stage) / 1e6,
            "raster_ms": (end - out) / 1e6,
        }
        if capture_ms is not None:
            self.stats["capture_ms"] = capture_ms
        return image if carry is None else (image, carry)

    def render_sequence(self, transforms, as_uint8: bool = True):
        """Render B frames, ``transforms`` (B, R, 4, 4) in the layout of
        ``__call__``, into one (B, H, W, 4) tensor on the device, uint8
        by default (quantized per frame, or packed by the kernel with
        ``uint8_output``).  One descriptor set serves the segment.  The
        active fused plan is used only when every frame validates under
        it; each frame replays its variant's step once, and the
        segment's overflow counters are reduced by max and read as one
        frame's.  The call is one frame of the frame record, with the five
        spans of ``__call__`` (``replay`` holds every frame's replay and
        copy out)."""
        frame = RECORD.begin(self._name, "FrameProgram.render_sequence",
                             "FrameProgram", "upkeep")
        try:
            transforms = np.ascontiguousarray(transforms, np.float32)
            if transforms.ndim != 4:
                transforms = transforms.reshape(len(transforms), -1, 4, 4)
            if len(transforms) == 0:
                raise ValueError("render_sequence needs at least one frame")
            expected = sum(c.n_instances for c in self._commands)
            if transforms.shape[1] != expected:
                raise ValueError(
                    f"expected {expected} transform rows per frame (one per "
                    f"command instance, pre-fusion), got "
                    f"{transforms.shape[1]}"
                )
            if self._keep_rows is not None:
                transforms = transforms[:, self._keep_rows]
            require_finite(transforms, "sequence transforms")
            self._frame += len(transforms)
            self._sync()
            self._refresh_cmd_f()
            frame.span("plan")
            variant = self._seq
            if self._runs and self._plan is not None:
                fused_frames = [
                    self._plan_transforms_if_valid(self._plan, t)
                    for t in transforms
                ]
                if all(f is not None for f in fused_frames):
                    variant = self._fused_variants[self._plan.signature][1]
                    transforms = np.stack(fused_frames)
            transforms = np.ascontiguousarray(transforms)
            frame.span("stage")
            self._stage_descriptors()
            frame.span("replay")
            step = self._frame_step(variant, transforms[0])
            r = self._renderer
            quantize = as_uint8 and not self._uint8
            frames = torch.empty(
                (len(transforms), r.height, r.width, 4),
                dtype=torch.uint8 if as_uint8 or self._uint8 else torch.float32,
                device=r.device,
            )
            worst = None
            for b in range(len(transforms)):
                overflow = step(transforms[b])[0].overflow
                if quantize:
                    frames[b] = Renderer._quantize(step.frame)
                else:
                    frames[b].copy_(step.frame)
                worst = (
                    overflow.clone() if worst is None
                    else torch.maximum(worst, overflow)
                )
            frame.span("out")
            self._defer(worst)
        finally:
            frame.end()
        return frames
