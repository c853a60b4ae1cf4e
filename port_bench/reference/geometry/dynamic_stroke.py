"""Dynamic stroke descriptors and per-sample stroke predicates.

Replaces the reference's GPU-side `DynamicStrokeDescriptor` storage
buffer (renderer.rs:20-60, shaders.wgsl:1-9) with a struct-of-arrays
descriptor table, and the WGSL cap/joint/dash fragment logic
(shaders.wgsl:165-300) with vectorized predicates usable both by the
numpy oracle and the jitted device rasterizer (pass ``xp=numpy`` or
``xp=jax.numpy``).

Dash-phase animation only rewrites this small table — geometry is not
re-tessellated (the reference's partial buffer write, renderer.rs:360-376).

Deviation from the reference, documented: the reference's Square cap
predicate (shaders.wgsl:167-169, ``texcoord.y > 0.5``) fills the far
side of the gap instead of the half-width rectangle its documentation
describes (path.rs:87-88); its showcase only exercises Butt caps.  This
implementation uses ``y <= 0.5`` (the documented rectangle).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .error import TooManyDashIntervals
from .path import MAX_DASH_INTERVALS, Cap, DynamicStrokeOptions, Join

TAU = 2.0 * math.pi


@dataclass
class StrokeDescriptorTable:
    """Struct-of-arrays encoding of a list of DynamicStrokeOptions.

    All arrays have leading dimension G (number of groups):
    - ``gap_start``/``gap_end`` (G, 4): dash interval bounds in width
      units (renderer.rs:44-45)
    - ``end_caps`` (G, 4): cap at the end of dash i (tested against
      ``pos - gap_start[i]``)
    - ``start_caps`` (G, 4): cap of the dash following gap i (tested
      against ``gap_end[i] - pos``) — the reference packs these two as
      nibbles of a u32 (renderer.rs:46-47)
    - ``last_interval`` (G,): index of the last dash interval
    - ``dashed`` (G,): dashed vs solid
    - ``join`` (G,): Join enum value
    - ``phase`` (G,): dash phase in width units
    - ``solid_start_cap``/``solid_end_cap`` (G,): caps for solid strokes
    """

    gap_start: np.ndarray
    gap_end: np.ndarray
    end_caps: np.ndarray
    start_caps: np.ndarray
    last_interval: np.ndarray
    dashed: np.ndarray
    join: np.ndarray
    phase: np.ndarray
    solid_start_cap: np.ndarray
    solid_end_cap: np.ndarray

    @classmethod
    def from_options(cls, options: Sequence[DynamicStrokeOptions]):
        g = max(1, len(options))
        table = cls(
            gap_start=np.zeros((g, MAX_DASH_INTERVALS), np.float32),
            gap_end=np.ones((g, MAX_DASH_INTERVALS), np.float32),
            end_caps=np.full((g, MAX_DASH_INTERVALS), int(Cap.BUTT), np.int32),
            start_caps=np.full((g, MAX_DASH_INTERVALS), int(Cap.BUTT), np.int32),
            last_interval=np.zeros(g, np.int32),
            dashed=np.zeros(g, bool),
            join=np.zeros(g, np.int32),
            phase=np.zeros(g, np.float32),
            solid_start_cap=np.full(g, int(Cap.BUTT), np.int32),
            solid_end_cap=np.full(g, int(Cap.BUTT), np.int32),
        )
        for i, opt in enumerate(options):
            table.join[i] = int(opt.join)
            if opt.dashed:
                if len(opt.pattern) > MAX_DASH_INTERVALS:
                    raise TooManyDashIntervals(
                        f"{len(opt.pattern)} > {MAX_DASH_INTERVALS}"
                    )
                n = len(opt.pattern)
                table.dashed[i] = True
                table.last_interval[i] = n - 1
                table.phase[i] = opt.phase
                for j, interval in enumerate(opt.pattern):
                    table.gap_start[i, j] = interval.gap_start
                    table.gap_end[i, j] = interval.gap_end
                    table.end_caps[i, j] = int(interval.dash_end)
                    # Cap of the dash that begins after gap j.
                    table.start_caps[i, j] = int(
                        opt.pattern[(j + 1) % n].dash_start
                    )
            else:
                table.solid_start_cap[i] = int(opt.start)
                table.solid_end_cap[i] = int(opt.end)
        return table

    def astype_device(self, jnp):
        """Mirror the table as jax arrays (for closure capture)."""
        return StrokeDescriptorTable(
            gap_start=jnp.asarray(self.gap_start),
            gap_end=jnp.asarray(self.gap_end),
            end_caps=jnp.asarray(self.end_caps),
            start_caps=jnp.asarray(self.start_caps),
            last_interval=jnp.asarray(self.last_interval),
            dashed=jnp.asarray(self.dashed),
            join=jnp.asarray(self.join),
            phase=jnp.asarray(self.phase),
            solid_start_cap=jnp.asarray(self.solid_start_cap),
            solid_end_cap=jnp.asarray(self.solid_end_cap),
        )


def cap_predicate(xp, tex_x, tex_y, cap_type):
    """Analytic cap shapes (reference shaders.wgsl:165-189).

    `tex_y` is the distance beyond the dash end; `tex_x` the side
    coordinate in [-0.5, 0.5].  All arrays broadcast; `cap_type` is an
    integer array.
    """
    ax = xp.abs(tex_x)
    results = [
        tex_y <= 0.5,  # SQUARE (see module docstring re reference bug)
        tex_x * tex_x + tex_y * tex_y < 0.25,  # ROUND
        0.5 - tex_y > ax,  # OUT
        tex_y < ax,  # IN
        0.5 - tex_y > tex_x,  # RIGHT
        tex_y - 0.5 < tex_x,  # LEFT
        tex_y < 0.0,  # BUTT
    ]
    out = results[int(Cap.BUTT)]
    for value in range(len(results) - 1):
        out = xp.where(cap_type == value, results[value], out)
    return out


def dash_predicate(xp, table, group, tex_x, tex_y):
    """Dashed coverage at pattern position `tex_y` (in width units) with
    side coordinate `tex_x` (reference shaders.wgsl:205-231).

    `group` is an integer array selecting descriptor rows; broadcasts
    with tex_x/tex_y.
    """
    shape = xp.broadcast_shapes(
        xp.shape(tex_y), xp.shape(tex_x), xp.shape(group)
    )
    gap_start = xp.broadcast_to(table.gap_start[group], shape + (MAX_DASH_INTERVALS,))
    gap_end = xp.broadcast_to(table.gap_end[group], shape + (MAX_DASH_INTERVALS,))
    end_caps = xp.broadcast_to(table.end_caps[group], shape + (MAX_DASH_INTERVALS,))
    start_caps = xp.broadcast_to(table.start_caps[group], shape + (MAX_DASH_INTERVALS,))
    last = xp.broadcast_to(table.last_interval[group], shape)
    phase = table.phase[group]
    idx4 = xp.arange(MAX_DASH_INTERVALS)
    pattern_length = xp.take_along_axis(
        gap_end, last[..., None], axis=-1
    )[..., 0]
    position = xp.broadcast_to(
        xp.remainder(tex_y - phase, pattern_length), shape
    )
    # First interval whose gap_end covers the position (else the last).
    candidates = xp.where(
        (gap_end - position[..., None] >= 0.0) & (idx4 <= last[..., None]),
        idx4,
        last[..., None],
    )
    interval = xp.min(candidates, axis=-1)
    g_start = xp.take_along_axis(gap_start, interval[..., None], axis=-1)[..., 0]
    g_end = xp.take_along_axis(gap_end, interval[..., None], axis=-1)[..., 0]
    e_cap = xp.take_along_axis(end_caps, interval[..., None], axis=-1)[..., 0]
    s_cap = xp.take_along_axis(start_caps, interval[..., None], axis=-1)[..., 0]
    past_dash = position - g_start
    in_dash = past_dash <= 0.0
    cap_a = cap_predicate(xp, tex_x, past_dash, e_cap)
    cap_b = cap_predicate(xp, tex_x, g_end - position, s_cap)
    return in_dash | cap_a | cap_b


def joint_predicate(xp, table, group, radius, is_tip):
    """Joint coverage (reference shaders.wgsl:191-203).

    `radius` is the distance from the joint center in width units;
    `is_tip` marks miter-tip triangles (beyond the bevel triangle).
    Miter: everything; Bevel: only the bevel triangle; Round: disc of
    radius 0.5.
    """
    join = table.join[group]
    miter = xp.ones(xp.shape(radius), bool)
    bevel = xp.broadcast_to(xp.logical_not(is_tip), xp.shape(radius))
    round_ = radius <= 0.5
    out = xp.where(join == int(Join.BEVEL), bevel, miter)
    return xp.where(join == int(Join.ROUND), round_, out)


def stroke_line_predicate(xp, table, group, tex_x, tex_y, end_flag, end_tex_y):
    """Stroke body/cap coverage for line triangles
    (reference shaders.wgsl:268-285)."""
    dashed = table.dashed[group]
    dash = dash_predicate(xp, table, group, tex_x, tex_y)
    end_cap = cap_predicate(
        xp, tex_x, tex_y - end_tex_y, table.solid_end_cap[group]
    )
    start_cap = cap_predicate(xp, tex_x, -tex_y, table.solid_start_cap[group])
    solid = xp.where(
        end_flag, end_cap, xp.where(tex_y < 0.0, start_cap, True)
    )
    return xp.where(dashed, dash, solid)


def stroke_joint_predicate(xp, table, group, tex_x, tex_y, tex_z, is_tip):
    """Stroke coverage for joint triangles
    (reference shaders.wgsl:287-300)."""
    radius = xp.sqrt(tex_x * tex_x + tex_y * tex_y)
    fill = joint_predicate(xp, table, group, radius, is_tip)
    dashed = table.dashed[group]
    angle = xp.arctan2(tex_y, tex_x) / TAU
    dash = dash_predicate(xp, table, group, radius, tex_z + angle)
    return fill & xp.where(dashed, dash, True)
