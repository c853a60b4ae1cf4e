"""Color space conversion (reference src/utils.rs:204-225)."""

from __future__ import annotations

import numpy as np


def srgb_to_linear(color):
    """Convert sRGB → linear; alpha (last channel) passes through."""
    color = np.asarray(color, dtype=np.float64).copy()
    rgb = color[..., :3]
    color[..., :3] = np.where(
        rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92
    )
    return color


def linear_to_srgb(color):
    """Convert linear → sRGB; alpha (last channel) passes through."""
    color = np.asarray(color, dtype=np.float64).copy()
    rgb = color[..., :3]
    color[..., :3] = np.where(
        rgb > 0.0031308, 1.055 * rgb ** (1.0 / 2.4) - 0.055, 12.92 * rgb
    )
    return color
