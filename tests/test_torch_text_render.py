"""Config 4's text in its monolith form (``shape_of_text``: one stencil
and one cover over one shape of every glyph instance), two lines at 128²,
rendered by both packages: the reference (JAX on the CPU, Pallas in
interpret mode) against the port.  A file of its own, so that the gate's
workers (split by file) run this reference frame beside the others."""

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu import text as ref_text
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from test_torch_showcase import assert_images_agree
from test_torch_text import SIZE, TEXT, one_thread, small_transform  # noqa: F401


def test_monolith_text_matches_reference():
    want = ref.Renderer(ref.Configuration(), SIZE, SIZE).render(
        scenes.config4_text("monolith", api=ref, text_module=ref_text,
                            text=TEXT, transform=small_transform()),
        as_uint8=True,
    )
    got = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu").render(
        scenes.config4_text("monolith", text=TEXT, transform=small_transform()),
        as_uint8=True,
    )
    assert (want[..., 3] > 0).sum() > 500
    assert_images_agree(got, want)
