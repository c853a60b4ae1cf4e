"""The showcase's instanced forms, rendered by both packages: one
stencil and one colour command carry all 46 instance transforms and
colours.  A file of its own, beside test_torch_showcase.py, so that the
gate's workers (split by file) render these reference frames in parallel
with that file's."""

import pytest

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import CLIP_ALPHA, SIZE, assert_images_agree


@pytest.mark.parametrize("variant", ["instanced", "clip_alpha_instanced"])
def test_instanced_showcase_matches_reference(variant):
    """Each variant's reference frame (JAX on the CPU, Pallas in interpret
    mode) is rendered here, once, by the case that needs it."""
    if variant == "instanced":
        config = dict()
        build, ref_build = showcase.showcase_commands, ref_showcase.showcase_commands
    else:
        config = CLIP_ALPHA
        build = showcase.showcase_commands_clip_alpha
        ref_build = ref_showcase.showcase_commands_clip_alpha
    want = ref.Renderer(ref.Configuration(**config), SIZE, SIZE).render(
        ref_build(ref_showcase.build_shape(with_text=False), SIZE, SIZE,
                  instanced=True),
        as_uint8=True,
    )
    commands = build(showcase.build_shape(with_text=False), SIZE, SIZE,
                     instanced=True)
    pair = commands if variant == "instanced" else commands[6:8]
    if variant != "instanced":
        assert len(commands) == 11
    assert [int(c.operation) for c in pair] == [0, 3]
    assert all(
        c.n_instances == 1 + showcase.ROWS * showcase.COLUMNS for c in pair
    )
    got = port.Renderer(
        port.Configuration(**config), SIZE, SIZE, device="cpu"
    ).render(
        commands, as_uint8=True
    )
    assert (want[..., 3] > 0).sum() > 20
    assert_images_agree(got, want)
