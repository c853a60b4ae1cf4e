"""The port's showcase scene (models/showcase.py) against the JAX
package's: the shape's tables, and the frame rendered by both packages,
plain and inside two nested clips and a transparency group."""

import os

import numpy as np
import pytest

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.assets import font_path
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase

SIZE = 96
CLIP_ALPHA = dict(alpha_layer_count=1, blending="front_to_back")


def assert_images_agree(got, want, samples=4):
    """Packed RGBA8 equal on at least 99.9% of pixels, each differing
    pixel off by at most one sample's share: the stroke and fill
    predicates are tie-sensitive comparisons, and the reference's jitted
    XLA on the CPU contracts multiply-adds into FMAs, which can move a
    sample within one rounding of a boundary.  Measured: all four
    showcase frames (loop and instanced, plain and clip/alpha) equal to
    the bit."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.sum()
    share = -(-255 // samples)
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share


def test_build_shape_tables_match_reference():
    """The port's build_shape tessellates through the shared builders:
    triangle, hull and descriptor tables equal the reference's."""
    want = ref_showcase.build_shape(with_text=False)
    got = showcase.build_shape(with_text=False)
    for name in ("xy", "aux", "kind", "meta"):
        assert np.array_equal(
            getattr(got.triangles, name), getattr(want.triangles, name)
        ), name
    assert np.array_equal(got.convex_hull, want.convex_hull)
    for name in ("gap_start", "gap_end", "phase", "end_caps", "start_caps",
                 "last_interval", "dashed", "join", "solid_start_cap",
                 "solid_end_cap"):
        assert np.array_equal(
            getattr(got.descriptors, name), getattr(want.descriptors, name)
        ), name


def test_build_shape_with_text_matches_reference():
    if not os.path.exists(font_path()):
        pytest.skip("OpenSans test font unavailable")
    want = ref_showcase.build_shape(with_text=True)
    got = showcase.build_shape(with_text=True)
    assert len(got.triangles) == len(want.triangles) > 200


@pytest.mark.parametrize("instanced", [False, True], ids=["loop", "instanced"])
@pytest.mark.parametrize("clip_alpha", [False, True], ids=["plain", "clip_alpha"])
def test_command_transforms_match_reference(clip_alpha, instanced):
    """command_transforms equals the reference's, and is the stack of the
    transforms of the commands it stands for, in their order."""
    got = showcase.command_transforms(
        SIZE, SIZE, clip_alpha=clip_alpha, instanced=instanced
    )
    want = ref_showcase.command_transforms(
        SIZE, SIZE, clip_alpha=clip_alpha, instanced=instanced
    )
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    build = (showcase.showcase_commands_clip_alpha if clip_alpha
             else showcase.showcase_commands)
    commands = build(showcase.build_shape(with_text=False), SIZE, SIZE,
                     instanced=instanced)
    stacked = np.concatenate([
        np.asarray(c.transform, np.float32).reshape(-1, 4, 4) for c in commands
    ])
    assert np.array_equal(got, stacked)


@pytest.fixture(scope="module")
def reference_frames():
    """Rendered by the reference (JAX on the CPU, Pallas in interpret
    mode): the showcase's first four instances, and the clip/alpha
    variant's prologue, centre instance and epilogue.  The instanced
    forms have a file of their own (test_torch_showcase_instanced.py),
    so that the gate's workers render them in parallel."""
    shape = ref_showcase.build_shape(with_text=False)
    plain = ref_showcase.showcase_commands(shape, SIZE, SIZE)[:8]
    full = ref_showcase.showcase_commands_clip_alpha(shape, SIZE, SIZE)
    clipped = full[:8] + full[-3:]
    return {
        "plain": ref.Renderer(ref.Configuration(), SIZE, SIZE).render(
            plain, as_uint8=True
        ),
        "clip_alpha": ref.Renderer(
            ref.Configuration(**CLIP_ALPHA), SIZE, SIZE
        ).render(clipped, as_uint8=True),
    }


def test_showcase_matches_reference(reference_frames):
    shape = showcase.build_shape(with_text=False)
    commands = showcase.showcase_commands(shape, SIZE, SIZE)[:8]
    got = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu").render(
        commands, as_uint8=True
    )
    want = reference_frames["plain"]
    assert (want[..., 3] > 25).sum() > 20  # the dashed stroke shows
    assert_images_agree(got, want)


def test_showcase_clip_alpha_matches_reference(reference_frames):
    """BASELINE config 5 as written, cut to the centre instance: the
    reference renders it with its clip/alpha bracket gating, the port
    ungated (the gating leaves the image unchanged by its contract)."""
    shape = showcase.build_shape(with_text=False)
    full = showcase.showcase_commands_clip_alpha(shape, SIZE, SIZE)
    commands = full[:8] + full[-3:]
    assert [int(c.operation) for c in commands] == [
        0, 1, 0, 1, 4, 5, 0, 3, 6, 2, 2,
    ]
    got = port.Renderer(
        port.Configuration(**CLIP_ALPHA), SIZE, SIZE, device="cpu"
    ).render(
        commands, as_uint8=True
    )
    want = reference_frames["clip_alpha"]
    assert (want[..., 3] > 0).sum() > 20
    assert_images_agree(got, want)
