"""The fused showcase at 128² rendered by both packages: the reference's
default render (auto-instanced, JAX on the CPU, Pallas in interpret
mode) against the port's, which fuses the same runs.  A file of its own,
beside test_torch_instance.py, so that the gate's workers (split by
file) run this reference frame in parallel with the others."""

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

SIZE = 128


def test_fused_showcase_matches_reference():
    want_r = ref.Renderer(ref.Configuration(), SIZE, SIZE)
    want = want_r.render(
        ref_showcase.showcase_commands(
            ref_showcase.build_shape(with_text=False), SIZE, SIZE
        ),
        as_uint8=True,
    )
    got_r = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    got = got_r.render(
        showcase.showcase_commands(
            showcase.build_shape(with_text=False), SIZE, SIZE
        ),
        as_uint8=True,
    )
    assert got_r.stats["commands"] == want_r.stats["commands"] == 4
    assert (want[..., 3] > 0).sum() > 1000
    assert_images_agree(got, want)
