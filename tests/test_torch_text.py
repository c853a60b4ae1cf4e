"""The port's text command builders against the JAX package's: glyph
triangle tables, the three forms of config 4's text (``shape_of_text``,
``text_commands_fused``, ``text_commands``), the overlap sweep, and the
caret geometry; then the three forms rendered by the port on the CPU,
equal to one another.  The reference's render is in
test_torch_text_render.py, so that another worker runs it."""

import numpy as np
import pytest

from contrast_renderer_tpu import native as ref_native
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu import text as ref_text
from contrast_renderer_tpu_torch import native as port_native
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch import text as port_text
from contrast_renderer_tpu_torch.assets import font_path
from test_torch_instance import assert_streams_equal, one_thread  # noqa: F401

PACKAGES = {"reference": (ref, ref_text), "port": (port, port_text)}
#: Two lines of config 4's pangram, set at config 4's size and scaled
#: into a 128² frame (the layout is centred on the origin).
TEXT = "the quick brown fox\njumps over the lazy dog"
SIZE = 128


def small_transform():
    return np.diag([2.0 / 180.0, 2.0 / 180.0, 1.0, 1.0]).astype(np.float32)


def perspective_transform():
    """w = x / 60 + 0.5 in layout units: the glyphs left of x = -30 lie
    behind the eye, those around it cross w = 0, the rest are in
    front."""
    t = small_transform()
    t[3] = (1.0 / 60.0, 0.0, 0.0, 0.5)
    return t


def face(text_module):
    with open(font_path(), "rb") as fh:
        return text_module.Font("OpenSans", fh.read()).face


def layout(text_module, size=16.0):
    return text_module.Layout(
        size=size,
        orientation=text_module.Orientation.LEFT_TO_RIGHT,
        major_alignment=text_module.Alignment.BEGIN,
        minor_alignment=text_module.Alignment.BEGIN,
    )


def table_fields(table, hull):
    return [table.xy, table.aux, table.kind, table.meta, np.asarray(hull)]


@pytest.mark.parametrize("route", ["native", "python"])
def test_glyph_triangle_table_matches_reference(route, monkeypatch):
    if route == "python":
        for module in (ref_native, port_native):
            monkeypatch.setattr(module, "available", lambda: False)
    elif not port_native.available():
        pytest.skip("no C++ compiler for the native tessellator")
    faces = {name: face(tm) for name, (_, tm) in PACKAGES.items()}
    glyphs = [faces["port"].glyph_index(ch) for ch in "aegkoqsw&8"]
    assert all(g is not None for g in glyphs)
    for gid in glyphs:
        got = port_text.glyph_triangle_table(faces["port"], gid)
        want = ref_text.glyph_triangle_table(faces["reference"], gid)
        assert len(got[0]) > 0
        for a, b in zip(table_fields(*got), table_fields(*want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.array_equal(a, b)
        assert port_text.glyph_triangle_table(faces["port"], gid) is got


def assert_shapes_equal(got, want):
    """Each command's shapes tessellated alike: triangle tables and hulls
    equal to the bit."""
    for c, d in zip(got, want):
        for s, r in zip(c.shapes, d.shapes):
            for a, b in zip(table_fields(s.triangles, s.convex_hull),
                            table_fields(r.triangles, r.convex_hull)):
                assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("form", scenes.CONFIG4_FORMS)
@pytest.mark.parametrize("view", ["flat", "perspective"])
def test_text_forms_match_reference(form, view):
    """The same operations, instance counts, shapes in the same places,
    transform stacks to the bit, and the same cover: equal triangle
    tables, the fused form's ink rectangle included.  Under the
    perspective view some instances cross w = 0 or lie behind the eye:
    text_commands splits them out of the instanced pairs, and the split
    must be the reference's."""
    transform = small_transform() if view == "flat" else perspective_transform()
    streams = {
        name: scenes.config4_text(form, api=api, text_module=tm, text=TEXT,
                                  transform=transform)
        for name, (api, tm) in PACKAGES.items()
    }
    assert_streams_equal(streams["port"], streams["reference"])
    assert_shapes_equal(streams["port"], streams["reference"])
    n_glyphs = sum(1 for ch in TEXT if not ch.isspace())
    stencils = [c for c in streams["port"] if int(c.operation) == 0]
    assert sum(c.n_instances for c in stencils) == n_glyphs or form == "monolith"
    if form == "per_glyph":
        assert any(c.n_instances > 1 for c in stencils)
        if view == "perspective":
            flat = scenes.config4_text(form, text=TEXT, transform=small_transform())
            assert (sum(c.n_instances == 1 for c in stencils)
                    > sum(c.n_instances == 1 for c in flat[::2]))


def test_text_commands_split_overlapping_instances():
    """Repeated f's overhang one another at size 48, so their boxes
    overlap: those instances leave the instanced pair, as the
    reference's do, while the a's and b's stay instanced."""
    streams = {}
    for name, (api, tm) in PACKAGES.items():
        streams[name] = tm.text_commands(
            face(tm), layout(tm, size=48.0), "ffff abab VVVV", small_transform(),
            color=(1.0, 0.4, 0.2, 0.5),
        )
    assert_streams_equal(streams["port"], streams["reference"])
    counts = [c.n_instances for c in streams["port"] if int(c.operation) == 0]
    assert 1 in counts and 2 in counts


def test_flag_overlapping_boxes_matches_reference():
    rng = np.random.default_rng(7)
    lo = rng.uniform(0.0, 100.0, (500, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.0, 6.0, (500, 2))], axis=1)
    got = port_text._flag_overlapping_boxes(boxes)
    want = ref_text._flag_overlapping_boxes(boxes)
    assert got.dtype == want.dtype == bool
    assert np.array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_text_geometry_and_byte_offsets_match_reference():
    text = "Hello\nWorld of\ncarets"
    geometries = {
        name: tm.TextGeometry.new(face(tm), layout(tm, 10.0), text)
        for name, (_, tm) in PACKAGES.items()
    }
    got, want = geometries["port"], geometries["reference"]
    assert got.major_axis == want.major_axis
    assert got.half_extent == want.half_extent
    assert got.lines == want.lines
    for i in range(len(text)):
        assert got.line_index_from_char_index(i) == want.line_index_from_char_index(i)
        for step in (-1, 1, 2):
            assert (got.advance_char_index_by_line_index(i, step)
                    == want.advance_char_index_by_line_index(i, step))
    for cursor in [(-20.0, 12.0), (0.0, 0.0), (7.5, -3.0), (40.0, -9.0)]:
        assert got.char_index_from_position(cursor) == want.char_index_from_position(cursor)
    for s in ("abc", "héllo wörld", "日本語のテキスト", "áb"):
        for i in range(len(s) + 2):
            assert (port_text.byte_offset_of_char_index(s, i)
                    == ref_text.byte_offset_of_char_index(s, i))


def test_text_forms_render_alike_on_the_cpu():
    """The three forms of the two-line text at 128², packed RGBA8, equal
    to the bit, and covering the text."""
    images = {}
    for form in scenes.CONFIG4_FORMS:
        commands = scenes.config4_text(form, text=TEXT, transform=small_transform())
        images[form] = port.Renderer(
            port.Configuration(), SIZE, SIZE, device="cpu"
        ).render(commands, as_uint8=True)
    assert (images["monolith"][..., 3] > 0).sum() > 500
    assert np.array_equal(images["fused"], images["monolith"])
    assert np.array_equal(images["per_glyph"], images["monolith"])


def test_config4_puts_a_quarter_of_its_glyphs_on_screen():
    """Config 4 as the benchmark builds it: 10,080 glyph instances whose
    ink spans about x −315…312 and y −894…894 layout units around the
    origin, under a transform that puts x < 0 and y > 37.5 off screen:
    2,655 pen positions (26%) land inside the frame."""
    stencil, cover = scenes.config4_text("fused")
    pens = np.asarray(stencil.transform)[:, :2, 3]
    inside = (np.abs(pens) <= 1.0).all(-1)
    assert stencil.n_instances == 10080 and int(inside.sum()) == 2655
    lo, hi = cover.shape.convex_hull.min(0), cover.shape.convex_hull.max(0)
    assert np.allclose(lo, (-315.18, -894.27), atol=0.01)
    assert np.allclose(hi, (311.68, 893.54), atol=0.01)
