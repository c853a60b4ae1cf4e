"""The camera of a scene drawn in pixel space (y up): an orthographic
projection of the frame, turned about the frame's centre."""

from __future__ import annotations

import math

import numpy as np


def transforms(params, angle):
    """(2, 4, 4) float32: pixel space (y up) to clip space, turned by
    ``angle`` about the frame's centre, for the STENCIL and the COLOR."""
    w, h = params["width"], params["height"]
    ortho = np.diag([2.0 / w, 2.0 / h, 1.0, 1.0])
    ortho[0, 3] = ortho[1, 3] = -1.0
    c, s = math.cos(angle), math.sin(angle)
    turn = np.eye(4)
    turn[:2, :2] = ((c, -s), (s, c))
    turn[0, 3] = w / 2 - c * w / 2 + s * h / 2
    turn[1, 3] = h / 2 - s * w / 2 - c * h / 2
    m = (ortho @ turn).astype(np.float32)
    return np.ascontiguousarray(np.stack([m, m]))
