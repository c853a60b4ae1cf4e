"""The port's whole slice: Renderer.render against the JAX package's
Renderer.render on the same scene, and against the scalar oracle."""

import numpy as np
import pytest

from contrast_renderer_tpu import oracle
from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.utils.profiling import RECORD

SIZE = 128


@pytest.fixture(scope="module")
def reference_scene():
    """Random quadratic and cubic Bézier fills (BASELINE config 2's
    construction at 128²) and a translucent circle over them, at 4×
    MSAA, rendered once by the reference (JAX on the CPU, Pallas in
    interpret mode)."""
    fills = ref.Shape(scenes.bezier_fill_paths(
        48, SIZE, SIZE, seed=1, margin=8.0, radius=(4.0, 18.0),
        geometry=ref_path,
    ))
    circle = ref.Shape([ref_path.Path.from_circle((60, 70), 40)])
    t = scenes.ortho(SIZE, SIZE)
    commands = [
        ref.DrawCommand(ref.RenderOperation.STENCIL, fills, t),
        ref.DrawCommand(
            ref.RenderOperation.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)
        ),
        ref.DrawCommand(ref.RenderOperation.STENCIL, circle, t),
        ref.DrawCommand(
            ref.RenderOperation.COLOR, circle, t, color=(0.1, 0.6, 0.8, 0.6)
        ),
    ]
    image = ref.Renderer(ref.Configuration(), SIZE, SIZE).render(
        commands, as_uint8=True
    )
    return commands, image


def test_render_matches_reference(reference_scene):
    """Packed RGBA8 equal on at least 99.9% of pixels; a pixel that
    differs is off by at most one sample's share, the mark of an edge
    tie rounded the other way (the reference's jitted binning contracts
    multiply-adds into FMAs, the port's rounds each step)."""
    commands, want = reference_scene
    renderer = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    got = renderer.render(interop.scene_from_reference(commands), as_uint8=True)
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    assert got.dtype == want.dtype == np.uint8
    assert (want[..., 3] > 0).mean() > 0.3
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3
    share = -(-255 // 4)
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share


def test_uint8_kernel_and_float_paths_agree(reference_scene):
    """The in-kernel RGBA8 resolve equals quantizing the float frame."""
    commands, _ = reference_scene
    renderer = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    scene = interop.scene_from_reference(commands)
    launches = RECORD.counters["raster_launches"]
    packed = renderer.render(scene, uint8_kernel=True)
    image = renderer.render(scene)
    quantized = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(packed, quantized)
    assert np.array_equal(renderer.render(scene, as_uint8=True), quantized)
    assert renderer.stats["tiles"] == 4
    assert RECORD.counters["raster_launches"] == launches  # CPU tensors never launch


def test_circle_coverage_against_oracle():
    """The README circle (scaled to 128²): the mean per-pixel coverage
    error against the scalar oracle is at most 1e-3 (BASELINE config
    1's bar)."""
    shape = port.Shape([port_path.Path.from_circle((64, 64), 50)])
    t = scenes.ortho(SIZE, SIZE)
    image = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu").render([
        port.DrawCommand(port.RenderOperation.STENCIL, shape, t),
        port.DrawCommand(port.RenderOperation.COLOR, shape, t, color=(1, 0, 0, 1)),
    ])
    winding = oracle.rasterize_fill_table(shape.triangles, SIZE, SIZE)
    expected = oracle.coverage_from_winding(winding).mean(-1)
    assert np.mean(np.abs(image[..., 3] - expected)) <= 1e-3
    assert np.allclose(image[64, 64], [1, 0, 0, 1])
