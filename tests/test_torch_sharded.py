"""The port's band and tile sharding (``parallel/mesh.py``) against its
single-device render and against the JAX package.

The sharded frames run on a ``Mesh`` of the CPU repeated (several bands
on one device), as tests/test_showcase.py's sharded tests run on virtual
CPU devices.  The JAX package's ``shard_map`` tests are slow; here the
port's bands are held to the JAX package directly: the band transforms
to the bit, and one band's pixels against the JAX ``Renderer`` at band
size under the JAX package's own ``band_adjusted_transform``."""

import dataclasses

import numpy as np
import pytest
import torch

from contrast_renderer_tpu import renderer as ref_renderer
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu.parallel import mesh as ref_mesh
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.parallel import (
    Mesh,
    band_adjusted_transform,
    rect_adjusted_transform,
    render_sharded,
    render_sharded_2d,
)
from contrast_renderer_tpu_torch.path import Path
from contrast_renderer_tpu_torch.renderer import (
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64
BANDS = 4
#: Sharded against single-device frames: mean |Δ| over the float image
#: (tests/test_showcase.py's bar for the JAX package).
MEAN_ABS_LIMIT = 1e-4
#: The band compared with the JAX package's render, and the share of its
#: RGBA8 pixels that may differ from the reference's (none: both walk the
#: same binning, and the port's kernel rounds every step as torch does).
BAND = 2
BAND_PIXEL_MISMATCH = 0.0
CLIP_ALPHA = dict(alpha_layer_count=1, blending="front_to_back")


def cpu_mesh(shape=(BANDS,), names=("y",)):
    return Mesh(np.full(shape, "cpu", dtype=object), names)


def renderer(config=None, width=SIZE, height=SIZE, **kw):
    return Renderer(config or Configuration(), width, height, tile_size=16,
                    device="cpu", **kw)


@pytest.fixture(scope="module")
def shape():
    return showcase.build_shape(with_text=False)


def _depth_commands():
    solid = Shape([Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)])
    transforms, _ = showcase.instance_transforms_and_colors(SIZE, SIZE)
    commands = []
    for t, color in ((transforms[0], (1.0, 1.0, 1.0, 1.0)),
                     (transforms[23], (1.0, 0.0, 0.0, 1.0))):
        t = np.ascontiguousarray(t, np.float32)
        commands += [
            DrawCommand(RenderOperation.STENCIL, solid, t),
            DrawCommand(RenderOperation.COLOR, solid, t, color=color),
        ]
    return commands


def _instanced_commands(shape):
    transforms, colors = showcase.instance_transforms_and_colors(SIZE, SIZE)
    t3 = np.ascontiguousarray(transforms[:3], np.float32)
    c3 = np.ascontiguousarray(colors[:3], np.float32)
    return [
        DrawCommand(RenderOperation.STENCIL, shape, t3),
        DrawCommand(RenderOperation.COLOR, shape, t3, color=c3),
    ]


#: tests/test_showcase.py's sharded frames: (configuration, commands).
FRAMES = {
    "showcase": lambda s: (Configuration(), showcase.showcase_commands(s, SIZE, SIZE)[:4]),
    "clip_alpha": lambda s: (
        Configuration(**CLIP_ALPHA),
        (lambda full: full[:8] + full[-3:])(
            showcase.showcase_commands_clip_alpha(s, SIZE, SIZE)),
    ),
    "instanced": lambda s: (Configuration(), _instanced_commands(s)),
    "depth": lambda s: (
        Configuration(depth_compare="less_equal", depth_write_enabled=True),
        _depth_commands(),
    ),
}


@pytest.mark.parametrize("bands", [1, 2, 4, 8])
def test_band_and_rect_transforms_equal_the_reference(bands):
    rng = np.random.default_rng(bands)
    stack = rng.normal(0.0, 3.0, (5, 4, 4)).astype(np.float32)
    before = stack.copy()
    for band in range(bands):
        want = np.asarray(ref_mesh.band_adjusted_transform(stack, band, bands))
        got = band_adjusted_transform(stack, band, bands)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        for nx in (1, 2, 3):
            for bx in range(nx):
                want = np.asarray(ref_mesh.rect_adjusted_transform(
                    stack, band, bands, bx, nx))
                got = rect_adjusted_transform(stack, band, bands, bx, nx)
                assert np.array_equal(got, want), (band, bx, nx)
    assert np.array_equal(stack, before)  # the input is not modified


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_render_sharded_matches_the_single_render(shape, frame):
    config, commands = FRAMES[frame](shape)
    sharded = render_sharded(renderer(config), commands, cpu_mesh())
    single = renderer(config).render(commands)
    assert isinstance(sharded, np.ndarray) and sharded.shape == single.shape
    assert float(np.mean(np.abs(sharded - single))) < MEAN_ABS_LIMIT
    assert (single[..., 3] > 0).any()


def test_render_sharded_2d_matches_the_single_render(shape):
    width, height = 256, 64
    commands = showcase.showcase_commands(shape, width, height)[:4]
    mesh = cpu_mesh((2, 2), ("y", "x"))
    sharded = render_sharded_2d(renderer(width=width, height=height),
                                commands, mesh)
    single = renderer(width=width, height=height).render(commands)
    assert sharded.shape == single.shape == (height, width, 4)
    assert float(np.mean(np.abs(sharded - single))) < MEAN_ABS_LIMIT
    # The same grid named the other way round: rows still follow "y".
    flipped = render_sharded_2d(renderer(width=width, height=height), commands,
                                cpu_mesh((2, 2), ("x", "y")))
    assert np.array_equal(flipped, sharded)


def test_one_band_equals_the_reference_renderer(shape):
    """Band BAND of the port's render_sharded against the JAX Renderer at
    band size, its commands under the JAX package's
    band_adjusted_transform, as RGBA8."""
    height = SIZE // BANDS
    ref_shape = ref_showcase.build_shape(with_text=False)
    ref_commands = [
        dataclasses.replace(c, transform=np.asarray(
            ref_mesh.band_adjusted_transform(c.transform, BAND, BANDS)))
        for c in ref_showcase.showcase_commands(ref_shape, SIZE, SIZE)[:4]
    ]
    want = ref_renderer.Renderer(
        ref_renderer.Configuration(), SIZE, height, tile_size=16, interpret=True
    ).render(ref_commands, as_uint8=True)
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:4]
    sharded = render_sharded(renderer(), commands, cpu_mesh())
    got = Renderer._quantize(torch.from_numpy(sharded)).numpy()
    got = got[BAND * height:(BAND + 1) * height]
    assert got.shape == want.shape == (height, SIZE, 4)
    differ = float(np.mean((got != want).any(-1)))
    assert differ <= BAND_PIXEL_MISMATCH, differ
    assert (want[..., 3] > 0).any()


def test_render_sharded_writes_back_grown_capacities(shape):
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:2]
    outer = renderer(tile_capacity=1)
    image = render_sharded(outer, commands, cpu_mesh())
    assert outer.tile_capacity > 1
    single = renderer().render(commands)
    assert float(np.mean(np.abs(image - single))) < MEAN_ABS_LIMIT


def test_mesh_checks_its_devices():
    mesh = cpu_mesh((2, 2), ("y", "x"))
    assert mesh.shape == {"y": 2, "x": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("y", "x"))
    with pytest.raises(ValueError, match="unsupported"):
        Mesh(["meta"], ("y",))
    with pytest.raises(ValueError, match="does not divide"):
        render_sharded(renderer(height=SIZE - 2), [], cpu_mesh())
    with pytest.raises(ValueError, match="no axis"):
        render_sharded(renderer(), [], cpu_mesh(), axis="x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda:0"] * 4, ("y",))
