"""The reference side of a scene: shapes tessellated by the frozen
geometry, draw commands, and a frame rendered by ``raster``.

``lib()`` gives a scene builder (``port_bench/scenes/``) the same names
that ``port_bench/harness/port_lib.py`` gives it for the port, so one
builder makes both sides' scenes from the same numbers.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from . import raster
from .geometry import path as geo_path
from .geometry import text as geo_text
from .geometry.dynamic_stroke import StrokeDescriptorTable
from .geometry.fill import FillBuilder
from .geometry.stroke import StrokeBuilder
from .geometry.vertex import TriangleTable


class RenderOperation(enum.IntEnum):
    """The draw operations a reference frame knows."""

    STENCIL = 0
    COLOR = 3


class RefShape:
    """Paths tessellated together (the upstream Shape): stroke triangles
    from the frozen StrokeBuilder, fill triangles from the frozen
    FillBuilder, and the stroke descriptor groups.  The reference's
    covers paint every sample whose winding is set, so it keeps no
    hull."""

    def __init__(self, paths, dynamic_stroke_options=()):
        proto_hull = []
        strokes, fills = StrokeBuilder(), FillBuilder()
        for p in paths:
            (strokes if p.stroke_options is not None else fills).add_path(
                proto_hull, p)
        self.triangles = TriangleTable.concatenate([strokes.build(), fills.build()])
        self.dynamic_stroke_options = list(dynamic_stroke_options)
        self._tensors = {}

    def set_dynamic_stroke_options(self, index, options):
        self.dynamic_stroke_options[index] = options

    def tensors(self, device):
        """(xy, aux, kind, meta) of the triangles on ``device``."""
        t = self._tensors.get(device)
        if t is None:
            tri = self.triangles
            t = self._tensors[device] = (
                torch.as_tensor(tri.xy, device=device),
                torch.as_tensor(tri.aux, device=device),
                torch.as_tensor(np.asarray(tri.kind, np.int64), device=device),
                torch.as_tensor(tri.meta, device=device),
            )
        return t


@dataclass
class RefCommand:
    operation: RenderOperation
    shape: RefShape
    transform: np.ndarray
    color: Sequence[float] = (0.0, 0.0, 0.0, 1.0)


def lib():
    """The names a scene builder uses, on the reference side."""
    return SimpleNamespace(
        Path=geo_path.Path,
        LineSegment=geo_path.LineSegment,
        IntegralQuadraticCurveSegment=geo_path.IntegralQuadraticCurveSegment,
        IntegralCubicCurveSegment=geo_path.IntegralCubicCurveSegment,
        StrokeOptions=geo_path.StrokeOptions,
        CurveApproximation=geo_path.CurveApproximation,
        DynamicStrokeOptions=geo_path.DynamicStrokeOptions,
        DashInterval=geo_path.DashInterval,
        Cap=geo_path.Cap,
        Join=geo_path.Join,
        Font=geo_text.Font,
        Layout=geo_text.Layout,
        Orientation=geo_text.Orientation,
        Alignment=geo_text.Alignment,
        paths_of_text=geo_text.paths_of_text,
        Shape=RefShape,
        DrawCommand=RefCommand,
        RenderOperation=RenderOperation,
    )


def descriptor_tensors(shape, dtype, device):
    """The shape's stroke descriptors as tensors, one row per group."""
    table = StrokeDescriptorTable.from_options(shape.dynamic_stroke_options)

    def as_float(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    def as_int(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return {
        "gap_start": as_float(table.gap_start),
        "gap_end": as_float(table.gap_end),
        "end_caps": as_int(table.end_caps),
        "start_caps": as_int(table.start_caps),
        "last_interval": as_int(table.last_interval),
        "dashed": torch.as_tensor(np.asarray(table.dashed, bool), device=device),
        "join": as_int(table.join),
        "phase": as_float(table.phase),
        "solid_start_cap": as_int(table.solid_start_cap),
        "solid_end_cap": as_int(table.solid_end_cap),
    }


def projected(command, width, height, dtype, device):
    """The STENCIL ``command``'s triangles clipped and in pixels
    (``raster.project_rows``)."""
    xy, aux, kind, meta = command.shape.tensors(device)
    m = torch.as_tensor(np.asarray(command.transform, np.float64), device=device)
    return raster.project_rows(xy, aux, kind, meta, m, width, height, dtype)


#: The renderer's Configuration defaults, and the values of its other
#: fields that the reference renders: it has no depth and no blend state
#: but back to front, so it refuses a configuration that asks for them.
DEFAULTS = {"msaa_sample_count": 4, "winding_counter_bits": 4,
            "clip_nesting_counter_bits": 4, "alpha_layer_count": 0}
RENDERED = {"blending": ("back_to_front",), "depth_compare": ("always",),
            "depth_write_enabled": (False,)}


def frame_options(configuration):
    """(samples, winding bits) of a configuration file's
    ``configuration`` (the renderer's Configuration fields); raises
    where it asks for what the reference does not render."""
    for key, value in configuration.items():
        if key not in DEFAULTS and value not in RENDERED.get(key, ()):
            raise ValueError(f"the reference renders no {key}={value!r}")
    c = {**DEFAULTS, **configuration}
    return c["msaa_sample_count"], c["winding_counter_bits"]


def render(commands, width, height, samples, winding_bits=4,
           dtype=torch.float64, device="cpu", on_stencil=None, work=None):
    """The packed RGBA8 frame (H, W, 4) uint8 of ``commands``, in order.
    ``work``, where given, counts the samples blended; ``on_stencil(c,
    rows, counts)`` is called after each STENCIL with its projected rows
    and their counts (``raster.stencil``'s ``work``)."""
    state = raster.FrameState(width, height, samples, winding_bits, dtype, device)
    for c in commands:
        if c.operation == RenderOperation.STENCIL:
            rows = projected(c, width, height, dtype, device)
            counts = {} if on_stencil is not None else None
            raster.stencil(state, rows, descriptor_tensors(c.shape, dtype, device),
                           counts)
            if on_stencil is not None:
                on_stencil(c, rows, counts)
        elif c.operation == RenderOperation.COLOR:
            raster.cover(state, c.color, dtype, work)
        else:
            raise ValueError(f"the reference renders no {c.operation!r}")
    return state.resolve()
