"""State carried across from the JAX package.

Turns the JAX package's objects into this package's, so that both can
compute on the same inputs.  The reference objects are taken by duck
typing (their attributes), never imported: this module loads no jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.coverage import FrameSpec, PreparedFrame
from .renderer import DrawCommand, RenderOperation, Shape


def _shape_from_reference(ref) -> Shape:
    """A Shape sharing the reference shape's triangle table, hull and
    stroke descriptor table (no re-tessellation).  Both packages pack the
    descriptor table into the same desc_f/desc_i rows; a later
    set_dynamic_stroke_options on either shape rebuilds that shape's
    table only."""
    shape = Shape.__new__(Shape)
    shape._uid = next(Shape._uid_counter)
    shape._geometry_version = 0
    shape.triangles = ref.triangles
    shape.convex_hull = ref.convex_hull
    shape.dynamic_stroke_options = list(ref.dynamic_stroke_options)
    shape.descriptors = ref.descriptors
    return shape


def scene_from_reference(commands):
    """The reference's DrawCommands (and their Shapes) as this package's.
    A reference Shape used by several commands maps to one Shape here."""
    shapes = {}

    def port(ref):
        if id(ref) not in shapes:
            shapes[id(ref)] = _shape_from_reference(ref)
        return shapes[id(ref)]

    out = []
    for c in commands:
        shape = (
            [port(s) for s in c.shape]
            if isinstance(c.shape, (list, tuple))
            else port(c.shape)
        )
        out.append(
            DrawCommand(
                operation=RenderOperation(int(c.operation)),
                shape=shape,
                transform=c.transform,
                color=c.color,
                clip_depth=c.clip_depth,
                alpha_layer=c.alpha_layer,
            )
        )
    return out


def spec_from_reference(spec) -> FrameSpec:
    """A reference FrameSpec as this package's (its TPU memory-space
    fields are dropped)."""
    names = [f.name for f in dataclasses.fields(FrameSpec)]
    return FrameSpec(**{name: getattr(spec, name) for name in names})


def prepared_from_numpy(fields, device="cpu") -> PreparedFrame:
    """A reference PreparedFrame (a NamedTuple or a mapping of its
    fields, as numpy arrays) as this package's tensors on ``device``.
    Only the parity tests call this, on the CPU, hence its default; the
    renderer's entry point defaults to the card."""
    values = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    return PreparedFrame(**{
        name: torch.as_tensor(np.array(values[name]), device=device)
        for name in PreparedFrame._fields
    })
