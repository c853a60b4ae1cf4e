"""The port's clip and alpha-group bodies against the JAX package: a frame
inside two nested clips with one transparency group, and a frame with two
nested groups on layers 0 and 1 (scenes.nested_clip_commands and
nested_group_commands at 96²), each rendered by both packages; and the
showcase's clip/alpha invariants on the port alone."""

from dataclasses import replace

import numpy as np
import pytest

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_instance import one_thread  # noqa: F401

SIZE = 96


#: name: (commands builder of scenes.py, alpha layers)
FRAMES = {
    "nested_clip": (scenes.nested_clip_commands, 1),
    "nested_groups": (scenes.nested_group_commands, 2),
}


@pytest.fixture(scope="module")
def reference_images():
    """Each frame rendered once by the reference (JAX on the CPU, Pallas
    in interpret mode), front-to-back blending, as packed RGBA8."""
    return {
        name: ref.Renderer(
            ref.Configuration(alpha_layer_count=layers,
                              blending="front_to_back"),
            SIZE, SIZE,
        ).render(build(ref, SIZE, geometry=ref_path), as_uint8=True)
        for name, (build, layers) in FRAMES.items()
    }


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_matches_reference(reference_images, name):
    """Packed RGBA8 equal on at least 99.9% of pixels, each differing
    pixel off by at most one sample's share (ties in the predicates under
    XLA's FMA contraction on the CPU).  Both packages gate the clip and
    alpha brackets per tile, which by the gating's contract changes no
    pixel.  Measured: both frames equal to the bit."""
    build, layers = FRAMES[name]
    renderer = port.Renderer(
        port.Configuration(alpha_layer_count=layers, blending="front_to_back"),
        SIZE, SIZE, device="cpu",
    )
    got = renderer.render(
        interop.scene_from_reference(build(ref, SIZE, geometry=ref_path)),
        as_uint8=True,
    )
    want = reference_images[name]
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert (want[..., 3] > 0).mean() > 0.1
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.sum()
    share = -(-255 // 4)
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share


def test_layer_state_choice():
    """One layer lives in registers; more, or clip without alpha ops,
    take layer mode 0 (layers in shared memory or the scratch of resident
    blocks); a frame without either, neither."""
    spec = port_cov.FrameSpec(
        width=SIZE, height=SIZE, ops=(0, 4, 5, 6), cmd_shape=(0, 0, 0, 0),
        n_shapes=1, t_max=1, h_max=4, samples=4, winding_bits=4,
        n_layers=1, blending="front_to_back",
    )
    assert port_cov.layer_mode(spec) == 1
    assert port_cov.layer_mode(replace(spec, n_layers=2)) == 0
    assert port_cov.layer_mode(replace(spec, n_layers=5)) == 0
    assert port_cov.layer_mode(replace(spec, ops=(0, 1, 2, 3))) == 0
    assert port_cov.layer_mode(replace(spec, ops=(0, 3))) == -1


@pytest.fixture(scope="module")
def showcase_images():
    """The port's clipped/grouped showcase (prologue, centre instance,
    epilogue) and the plain centre instance, at 96² on the CPU."""
    shape = showcase.build_shape(with_text=False)
    config = port.Configuration(alpha_layer_count=1, blending="front_to_back")
    full = showcase.showcase_commands_clip_alpha(shape, SIZE, SIZE)
    image = port.Renderer(config, SIZE, SIZE, device="cpu").render(
        full[:8] + full[-3:]
    )
    plain = port.Renderer(config, SIZE, SIZE, device="cpu").render(
        showcase.showcase_commands(shape, SIZE, SIZE)[:2]
    )
    return image, plain


def test_showcase_clip_corners_are_empty(showcase_images):
    image, _ = showcase_images
    assert np.isfinite(image).all()
    assert np.abs(image[:2, :2]).max() == 0.0
    assert np.abs(image[-2:, -2:]).max() == 0.0


def test_showcase_group_scales_the_interior(showcase_images):
    """Inside the clips, the group scales the scene by its opacity (a
    transparent backdrop saves 0, so the restore leaves g × scene)."""
    image, plain = showcase_images
    center = slice(SIZE // 4, 3 * SIZE // 4)
    diff = np.abs(
        image[center, center] - showcase.GROUP_OPACITY * plain[center, center]
    )
    assert (plain[center, center, 3] > 0).sum() > 20
    assert diff.max() < 1e-5
