"""The port's CFF outline reader (``cff.py``, reached through
``ttf.Face``) against the JAX package's, on fonts synthesized as
tests/test_cff.py synthesizes them: the same outlines, paths and
bounding boxes, and a CFF2 font refused by both."""

import pytest

pytest.importorskip("fontTools")

import numpy as np  # noqa: E402

from contrast_renderer_tpu import error as ref_error  # noqa: E402
from contrast_renderer_tpu import text as ref_text  # noqa: E402
from contrast_renderer_tpu_torch import error as port_error  # noqa: E402
from contrast_renderer_tpu_torch import text as port_text  # noqa: E402
from test_cff import RecBuilder, build_otf  # noqa: E402

PACKAGES = {"reference": (ref_text, ref_error), "port": (port_text, port_error)}


def draw_a(pen):
    pen.moveTo((100, 100))
    pen.lineTo((500, 100))
    pen.lineTo((300, 500))
    pen.closePath()


def draw_o(pen):
    """An outer contour of cubics with a hole, below the baseline too."""
    pen.moveTo((300, -120))
    pen.curveTo((480, -120), (560, 60), (560, 250))
    pen.curveTo((560, 440), (480, 620), (300, 620))
    pen.curveTo((120, 620), (40, 440), (40, 250))
    pen.curveTo((40, 60), (120, -120), (300, -120))
    pen.closePath()
    pen.moveTo((300, 40))
    pen.curveTo((200, 40), (150, 140), (150, 250))
    pen.curveTo((150, 360), (200, 460), (300, 460))
    pen.curveTo((400, 460), (450, 360), (450, 250))
    pen.curveTo((450, 140), (400, 40), (300, 40))
    pen.closePath()


def draw_s(pen):
    """Lines and a quadratic-looking cubic, two contours."""
    pen.moveTo((50, 0))
    pen.lineTo((250, 0))
    pen.curveTo((300, 100), (300, 200), (250, 300))
    pen.lineTo((50, 300))
    pen.closePath()
    pen.moveTo((350, 400))
    pen.lineTo((550, 400))
    pen.lineTo((450, 700))
    pen.closePath()


FONT = build_otf(draw_fns={"A": draw_a, "O": draw_o, "S": draw_s})


def path_values(path):
    return (
        np.asarray(path.start, np.float64),
        [int(t) for t in path.segment_types],
        [np.asarray(s.control_points, np.float64) for _, s in path.iter_segments()],
    )


@pytest.mark.parametrize("char", "AOS")
def test_cff_glyph_matches_reference(char):
    faces = {name: tm.Font("synthetic-otf", FONT).face
             for name, (tm, _) in PACKAGES.items()}
    got_face, want_face = faces["port"], faces["reference"]
    gid = got_face.glyph_index(char)
    assert gid is not None and gid == want_face.glyph_index(char)
    assert got_face.glyph_bounding_box(gid) == want_face.glyph_bounding_box(gid)
    assert got_face.glyph_hor_advance(gid) == want_face.glyph_hor_advance(gid)
    recorded = {}
    for name, face in faces.items():
        rec = RecBuilder()
        face.outline_glyph(gid, rec)
        recorded[name] = rec.ops
    assert recorded["port"] == recorded["reference"]
    got = port_text.paths_of_glyph(got_face, gid)
    want = ref_text.paths_of_glyph(want_face, gid)
    assert len(got) == len(want) > 0
    for p, q in zip(got, want):
        (ps, pt, pc), (qs, qt, qc) = path_values(p), path_values(q)
        assert np.array_equal(ps, qs) and pt == qt
        assert all(np.array_equal(a, b) for a, b in zip(pc, qc))


def test_cff2_refused_by_both():
    data = FONT.replace(b"CFF ", b"CFF2")
    for text_module, error in PACKAGES.values():
        with pytest.raises(error.UnsupportedFontFormat):
            text_module.Font("cff2", data)
