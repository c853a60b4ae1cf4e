"""The showcase scene of the port: dashed rounded-rect stroke + "Hello
World" glyphs, 46 instances under a perspective camera.

The counterpart of ``contrast_renderer_tpu/models/showcase.py``, built on
the port's Shape and DrawCommand; paths, text layout, the font and the
camera matrices come from this package's copies of the reference's host
modules.

Mirrors the reference's showcase example (examples/showcase/main.rs):
the same paths (main.rs:59-94), the same dashed stroke group with
animated phase (main.rs:59-68, 155-161), the same 1 + 9x5 instance grid
with per-instance color (main.rs:173-200) and the same perspective
camera (main.rs:162-172).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..assets import load_default_font
from ..path import (
    Cap,
    CurveApproximation,
    DashInterval,
    DynamicStrokeOptions,
    Join,
    Path,
    StrokeOptions,
)
from ..renderer import DrawCommand, RenderOperation, Shape
from ..text import (
    Alignment,
    Font,
    Layout,
    Orientation,
    paths_of_text,
)
from ..utils import matrix

ROWS = 9
COLUMNS = 5


def dashed_options(phase: float) -> DynamicStrokeOptions:
    """The showcase's animated dash group (main.rs:59-68, 155-161)."""
    return DynamicStrokeOptions.make_dashed(
        Join.MITER,
        [
            DashInterval(
                gap_start=3.0, gap_end=4.0, dash_start=Cap.BUTT, dash_end=Cap.BUTT
            )
        ],
        phase=phase,
    )


def build_shape(font: Optional[Font] = None, with_text: bool = True) -> Shape:
    """The showcase Shape: stroked rounded rect + reversed glyph fills
    (main.rs:70-94)."""
    paths: List[Path] = []
    rect = Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)
    rect.stroke_options = StrokeOptions(
        width=0.1,
        offset=0.0,
        miter_clip=1.0,
        closed=True,
        dynamic_stroke_options_group=0,
        curve_approximation=CurveApproximation.uniform_tangent_angle(0.1),
    )
    paths.append(rect)
    if with_text:
        if font is None:
            font = load_default_font()
        text_paths = paths_of_text(
            font.face,
            Layout(
                size=2.7,
                orientation=Orientation.LEFT_TO_RIGHT,
                major_alignment=Alignment.CENTER,
                minor_alignment=Alignment.CENTER,
            ),
            "Hello World",
        )
        for path in text_paths:
            path.reverse()
        paths.extend(text_paths)
    return Shape(paths, [dashed_options(0.0)])


def instance_transforms_and_colors(
    width: int, height: int, view_rotation=None, view_distance: float = 5.0
) -> Tuple[np.ndarray, np.ndarray]:
    """The 1 + ROWS*COLUMNS instance matrices and colors
    (main.rs:162-200)."""
    if view_rotation is None:
        view_rotation = np.array([1.0, 0.0, 0.0, 0.0])
    projection = matrix.matrix_multiplication(
        matrix.perspective_projection(
            math.pi * 0.5, width / height, 1.0, 1000.0
        ),
        matrix.motor3d_to_mat4(
            matrix.motor3d_product(
                matrix.motor3d_new(
                    [1.0, 0, 0, 0, 0, 0, 0, -0.5 * view_distance]
                ),
                matrix.rotor_to_motor3d(view_rotation),
            )
        ),
    )
    # The grid instances are pure-translation motors (dual part d,
    # translation -2d); their mat4 product with the projection is the
    # projection with a recombined last column — batched numpy instead
    # of 45 Python-loop motor conversions (this runs per frame under
    # camera animation).
    n = ROWS * COLUMNS
    x_idx = np.tile(np.arange(COLUMNS, dtype=np.float64), ROWS)
    y_idx = np.repeat(np.arange(ROWS, dtype=np.float64), COLUMNS)
    d = np.stack(
        [
            (x_idx + 0.5 - COLUMNS * 0.5) * 7.0,
            (y_idx + 0.5 - ROWS * 0.5) * 3.0,
            np.full(n, -5.0),
        ],
        axis=-1,
    )
    trans = -2.0 * d
    col3 = (
        projection[0][None] * trans[:, 0:1]
        + projection[1][None] * trans[:, 1:2]
        + projection[2][None] * trans[:, 2:3]
        + projection[3][None]
    )
    mats = np.broadcast_to(projection, (n, 4, 4)).copy()
    mats[:, 3, :] = col3
    transforms = np.concatenate([np.asarray(projection)[None], mats])
    red = x_idx / COLUMNS
    green = y_idx / ROWS
    colors = np.concatenate(
        [
            np.array([[1.0, 1.0, 1.0, 1.0]]),
            np.stack([red, green, 1.0 - red - green, np.ones(n)], axis=-1),
        ]
    )
    # Column-layout mat4 → standard row-major for the renderer.
    return transforms.transpose(0, 2, 1), colors


def showcase_commands(
    shape: Shape, width: int, height: int, instanced: bool = False, **camera
) -> List[DrawCommand]:
    """The showcase frame.

    ``instanced=False`` (default): per-instance Stencil then Color, the
    draw loop the reference showcase runs (main.rs:236-250) — each
    instance composites over the previous, which matters where the
    large center instance overlaps the grid.

    ``instanced=True``: ONE Stencil + ONE Color command carrying all 46
    instance transforms/colors — the reference's single instanced draw
    (``instance_range 0..n``, renderer.rs:267, 462-466).  As in the
    reference, all instances' winding accumulates in the shared stencil
    before any cover, so overlapping instances composite differently
    from the per-instance loop; the per-tile command walk collapses
    from 92 commands to one stencil unit plus the covering draws.
    """
    transforms, colors = instance_transforms_and_colors(width, height, **camera)
    if instanced:
        return [
            DrawCommand(RenderOperation.STENCIL, shape, transforms),
            DrawCommand(
                RenderOperation.COLOR, shape, transforms, color=colors
            ),
        ]
    commands: List[DrawCommand] = []
    for transform, color in zip(transforms, colors):
        commands.append(
            DrawCommand(RenderOperation.STENCIL, shape, transform)
        )
        commands.append(
            DrawCommand(
                RenderOperation.COLOR, shape, transform, color=tuple(color)
            )
        )
    return commands


def command_transforms(
    width: int, height: int, clip_alpha: bool = False,
    instanced: bool = False, **camera
) -> np.ndarray:
    """The per-draw (R, 4, 4) transform stack matching
    `showcase_commands` / `showcase_commands_clip_alpha` order — the
    runtime input of a fused `FrameProgram` under camera animation (the
    reference's camera is likewise just a per-frame matrix,
    examples/showcase/main.rs:255-274).  For the instanced command form
    the rows are [stencil instances..., color instances...]."""
    transforms, _ = instance_transforms_and_colors(width, height, **camera)
    if instanced:
        stack = np.concatenate([transforms, transforms])
    else:
        stack = np.repeat(transforms, 2, axis=0)
    if clip_alpha:
        eye = np.broadcast_to(np.eye(4), (1, 4, 4))
        stack = np.concatenate(
            [np.repeat(eye, 6, axis=0), stack, np.repeat(eye, 3, axis=0)]
        )
    return np.ascontiguousarray(stack, np.float32)


#: The showcase orbit (benchmarks/run_configs.py::config5_orbit, from
#: examples/showcase/main.rs:255-274): the camera turns this many radians
#: about the y axis per frame, and the dash phase advances this much.
ORBIT_STEP = 0.05
ORBIT_DASH_STEP = 0.032


def orbit_rotor(frame: int) -> np.ndarray:
    """The view rotor of the orbit's frame ``frame``."""
    angle = ORBIT_STEP * frame
    return np.array([math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0])


def orbit_transforms(frame: int, width: int, height: int, **kwargs) -> np.ndarray:
    """The (R, 4, 4) transform stack of the orbit's frame ``frame``, in
    the order of ``showcase_commands`` (``command_transforms``'s keywords
    pass through)."""
    return command_transforms(
        width, height, view_rotation=orbit_rotor(frame), **kwargs
    )


_CLIP_SHAPES = {}


def _clip_shapes():
    """Screen-space shapes for the clipped/grouped showcase variant:
    two nested clip regions plus a full-screen cover for the
    alpha-context operations (their LessEqual stencil state passes
    everywhere, renderer.rs:761-766)."""
    if not _CLIP_SHAPES:
        _CLIP_SHAPES["outer"] = Shape(
            [Path.from_rounded_rect((0.0, 0.0), (0.95, 0.92), 0.25)]
        )
        _CLIP_SHAPES["inner"] = Shape(
            [Path.from_ellipse((0.0, 0.0), (0.92, 0.85))]
        )
        _CLIP_SHAPES["cover"] = Shape(
            [Path.from_rect((0.0, 0.0), (1.0, 1.0))]
        )
    return _CLIP_SHAPES


GROUP_OPACITY = 0.6


def showcase_commands_clip_alpha(
    shape: Shape, width: int, height: int, instanced: bool = False, **camera
) -> List[DrawCommand]:
    """The showcase wrapped in two nested clip levels and one
    transparency group — BASELINE.json config 5 as written ("nested
    clipping + transparency layers").  Requires
    ``Configuration(alpha_layer_count>=1, blending="front_to_back")``
    (the reference's alpha-group algebra works in accumulated-occlusion
    alpha space, renderer.rs:756-861).

    Clip protocol per the reference doc example (renderer.rs:258-266):
    Stencil the clip shape at the current depth, Clip to depth+1, draw
    content at the new depth, UnClip back.  The clip shapes live in NDC
    (identity transform), covering most of the viewport so nearly every
    tile pays the clip-compare cost being measured.
    """
    shapes = _clip_shapes()
    identity = np.eye(4, dtype=np.float32)
    transforms, colors = instance_transforms_and_colors(width, height, **camera)
    commands: List[DrawCommand] = [
        # Nested clip level 1: rounded rect.
        DrawCommand(RenderOperation.STENCIL, shapes["outer"], identity),
        DrawCommand(
            RenderOperation.CLIP, shapes["outer"], identity, clip_depth=1
        ),
        # Nested clip level 2: ellipse, clipped by level 1.
        DrawCommand(
            RenderOperation.STENCIL, shapes["inner"], identity, clip_depth=1
        ),
        DrawCommand(
            RenderOperation.CLIP, shapes["inner"], identity, clip_depth=2
        ),
        # Transparency group around the whole instanced scene.
        DrawCommand(
            RenderOperation.SAVE_ALPHA_CONTEXT,
            shapes["cover"],
            identity,
            clip_depth=2,
            alpha_layer=0,
        ),
        DrawCommand(
            RenderOperation.SCALE_ALPHA_CONTEXT,
            shapes["cover"],
            identity,
            clip_depth=2,
            color=(0.0, 0.0, 0.0, GROUP_OPACITY),
        ),
    ]
    if instanced:
        # One Stencil + one Color carrying all instances (see
        # showcase_commands on the compositing difference).
        commands += [
            DrawCommand(
                RenderOperation.STENCIL, shape, transforms, clip_depth=2
            ),
            DrawCommand(
                RenderOperation.COLOR, shape, transforms,
                color=colors, clip_depth=2,
            ),
        ]
    else:
        for transform, color in zip(transforms, colors):
            commands.append(
                DrawCommand(
                    RenderOperation.STENCIL, shape, transform, clip_depth=2
                )
            )
            commands.append(
                DrawCommand(
                    RenderOperation.COLOR,
                    shape,
                    transform,
                    color=tuple(color),
                    clip_depth=2,
                )
            )
    commands += [
        DrawCommand(
            RenderOperation.RESTORE_ALPHA_CONTEXT,
            shapes["cover"],
            identity,
            clip_depth=2,
            color=(0.0, 0.0, 0.0, GROUP_OPACITY),
            alpha_layer=0,
        ),
        # Unwind the clip stack: 2 → 1 → 0.
        DrawCommand(
            RenderOperation.UNCLIP, shapes["inner"], identity, clip_depth=1
        ),
        DrawCommand(
            RenderOperation.UNCLIP, shapes["outer"], identity, clip_depth=0
        ),
    ]
    return commands
