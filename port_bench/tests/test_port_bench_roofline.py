"""The raster roofline's count, on tiny scenes, against counts by hand;
and the reference geometry it is counted on."""

import numpy as np
import pytest
import torch

from port_bench.harness import roofline
from port_bench.reference import raster
from port_bench.reference import scene as ref
from port_bench.reference.geometry.dynamic_stroke import StrokeDescriptorTable
from port_bench.reference.geometry.path import Cap, DashInterval, DynamicStrokeOptions, Join
from port_bench.reference.geometry.vertex import END_CAP_FLAG, KIND_STROKE_LINE

W = H = 8


def ortho(w, h):
    m = np.diag([2.0 / w, 2.0 / h, 1.0, 1.0])
    m[0, 3] = m[1, 3] = -1.0
    return m


def square_scene():
    """A 4 x 4 pixel square, filled as two triangles, and its cover."""
    lib = ref.lib()
    p = lib.Path(start=(0.0, 0.0))
    for corner in ((4.0, 0.0), (4.0, 4.0), (0.0, 4.0)):
        p.push_line(lib.LineSegment([corner]))
    shape = lib.Shape([p])
    t = ortho(W, H)
    return shape, [lib.DrawCommand(lib.RenderOperation.STENCIL, shape, t),
                   lib.DrawCommand(lib.RenderOperation.COLOR, shape, t, color=(1, 0, 0, 1))]


def brute_counts(shape):
    """(pixels with a sample inside, samples inside), summed over the
    triangles, by a plain loop over every sample of the frame (the square
    leaves no sample on an edge, so no tie rule is needed)."""
    pixels = samples = 0
    for tri in shape.triangles.xy:
        v = [(float(x), H - float(y)) for x, y in tri]      # ortho: y down
        sign = (v[1][0] - v[0][0]) * (v[2][1] - v[0][1]) - (v[1][1] - v[0][1]) * (v[2][0] - v[0][0])
        for py in range(H):
            for px in range(W):
                hit = 0
                for ox, oy in raster.SAMPLE_OFFSETS[4]:
                    x, y = px + ox, py + oy
                    e = [((b[0] - a[0]) * (y - a[1]) - (b[1] - a[1]) * (x - a[0])) * sign
                         for a, b in ((v[0], v[1]), (v[1], v[2]), (v[2], v[0]))]
                    hit += all(k > 0 for k in e)
                samples += hit
                pixels += hit > 0
    return pixels, samples


def test_a_filled_square_and_its_cover_by_hand():
    shape, commands = square_scene()
    assert len(shape.triangles) == 2
    pixels, samples = brute_counts(shape)
    # Each triangle holds the 6 pixels on its side of the diagonal and
    # the 4 it cuts: 20 (triangle, pixel) pairs; the 64 samples of the
    # square's 16 pixels lie each in one triangle.
    assert (pixels, samples) == (20, 64)
    ops, nbytes = roofline.frame_work(commands, W, H, 4, 4, "back_to_front", "cpu")
    # Solid fill: 12 a pixel, 6 a sample; the cover blends the 64
    # samples, 8 each; the resolve: 64 pixels, 4 channels, 4 + 1 + 5.
    assert ops == pixels * 12 + samples * 6 + 64 * 8 + 64 * 4 * (4 + 1 + 5)
    assert nbytes == 64 * 4 + 2 * roofline.ROW_BYTES + roofline.HULL_BYTES
    seconds, bound = roofline.bound_seconds(ops, nbytes)
    assert bound == "bytes" and seconds == pytest.approx(nbytes / roofline.PEAK_BYTES_S)


def test_a_square_off_screen_counts_only_the_resolve():
    shape, commands = square_scene()
    far = ortho(W, H).copy()
    far[0, 3] = 10.0
    for c in commands:
        c.transform = far
    ops, nbytes = roofline.frame_work(commands, W, H, 4, 4, "back_to_front", "cpu")
    assert ops == 64 * 4 * (4 + 1 + 5)
    assert nbytes == 64 * 4 + roofline.HULL_BYTES


def test_stroke_classes_and_their_caps():
    dashed = DynamicStrokeOptions.make_dashed(
        Join.MITER, [DashInterval(3.0, 4.0, Cap.ROUND, Cap.OUT)], 0.0)
    solid = DynamicStrokeOptions.make_solid(Join.MITER, Cap.SQUARE, Cap.ROUND)
    table = StrokeDescriptorTable.from_options([dashed, solid])
    kind = torch.full((3,), KIND_STROKE_LINE)
    flags = torch.tensor([0, 1, 1 | END_CAP_FLAG])
    cls, extra = roofline._classes(kind, flags, table)
    assert cls.tolist() == [1, 0, 0]
    # Single dash: the end cap (out) and the next dash's start cap
    # (round); a solid line's start cap (square) or end cap (round).
    assert extra.tolist() == [roofline.CAP_OPS[Cap.OUT] + roofline.CAP_OPS[Cap.ROUND],
                              roofline.START_CAP_OPS + roofline.CAP_OPS[Cap.SQUARE],
                              roofline.END_CAP_OPS + roofline.CAP_OPS[Cap.ROUND]]


def test_near_plane_clipping_of_the_reference():
    # One triangle with a vertex behind the camera (w < 0): clipped to a
    # quadrilateral, two triangles whose new vertices sit at w = NEAR_W.
    xy = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]])
    aux = torch.zeros((1, 3, 4))
    m = torch.eye(4, dtype=torch.float64)
    m[3] = torch.tensor([-1.0, 2.0, 0.0, 0.5], dtype=torch.float64)  # w = 0.5 - x + 2y
    verts, inv_w, _, kind, _ = raster.project_rows(
        xy, aux, torch.zeros(1, dtype=torch.long), torch.zeros((1, 2)), m, 8, 8,
        torch.float64)
    assert len(kind) == 2
    w = 1.0 / inv_w
    # The fan (v0, a, b), (v0, b, v2) holds the two new vertices a, b three times.
    assert (w > 0).all() and torch.isclose(w, torch.tensor(raster.NEAR_W, dtype=torch.float64)).sum() == 3
