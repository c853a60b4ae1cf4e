"""Stroke cases that run beside test_torch_stroke.py, in a file of their
own so that the gate's workers (split by file) run them in parallel with
it: the packed-RGBA8 raster case on one strip, and dash-phase animation
through Renderer.render."""

import numpy as np
import pytest

from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from test_torch_instance import one_thread  # noqa: F401
from test_torch_stroke import check_stroke_raster


@pytest.mark.parametrize("strips, out_u8", [(1, True)], ids=["strips1-u8"])
def test_rasterize_plain_strokes_match_reference_kernel(strips, out_u8):
    """The reference's Pallas kernel (interpret mode) and the port's
    rasterize_plain on the same PreparedFrame and descriptors, packed
    RGBA8 (test_torch_stroke.check_stroke_raster states the bar)."""
    check_stroke_raster(strips, out_u8)


def test_dash_phase_animation_rebins_nothing():
    """A phase change re-uploads desc_f and nothing else: the binning
    stays cached (desc_static, the dash mode per group, is unchanged),
    and the image moves."""
    size = 256  # the scene keeps 100 px from the frame's edges
    paths, options = scenes.dashed_strokes(size, size, seed=3)
    shape = port.Shape(paths[:6], options)
    t = scenes.ortho(size, size)
    commands = [
        port.DrawCommand(port.RenderOperation.STENCIL, shape, t),
        port.DrawCommand(port.RenderOperation.COLOR, shape, t),
    ]
    renderer = port.Renderer(port.Configuration(), size, size, device="cpu")
    frame0 = renderer.render(commands)
    for group, join in enumerate(scenes.DASHED_JOINS):
        shape.set_dynamic_stroke_options(group, scenes.dashed_options(join, 2.0))
    frame1 = renderer.render(commands)
    assert len(renderer._prepared_cache) == 1
    uploads = [key[0] for key in renderer._upload_cache]
    assert uploads.count("desc_f") == 2
    assert all(uploads.count(name) == 1 for name in set(uploads) - {"desc_f"})
    assert (np.abs(frame0[..., 3] - frame1[..., 3]) > 0.4).sum() > 10
