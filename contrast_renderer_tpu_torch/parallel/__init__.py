"""Multi-device scaling: sharded frame rendering over a device mesh.

The port's counterpart of ``contrast_renderer_tpu/parallel``: the frame's
pixels are split over a ``Mesh`` of torch devices — 1D row bands or a 2D
row × column tile grid — each device rendering its sub-rect with a
rect-adjusted projection, and the sub-rects are gathered on the first
device.
"""

from .mesh import (  # noqa: F401
    Mesh,
    ShardedFrameProgram,
    ShardedFrameProgram2D,
    band_adjusted_transform,
    rect_adjusted_transform,
    render_sharded,
    render_sharded_2d,
)
