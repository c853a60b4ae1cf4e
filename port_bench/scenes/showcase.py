"""The upstream renderer's showcase (examples/showcase/main.rs): a
dashed rounded-rect stroke and "Hello World" glyph fills, one shape
drawn as 1 + rows x columns instances under a perspective camera that
orbits about the y axis.

Paths (main.rs:59-94), the dash group (main.rs:59-68, 155-161), the
instance grid and its colours (main.rs:173-200) and the camera
(main.rs:162-172, 255-274), with every number taken from ``params``.
"""

from __future__ import annotations

import math
from pathlib import Path as FilePath

import numpy as np

from ..harness.traffic import Scene
from ..reference.geometry import matrix

DATA = FilePath(__file__).resolve().parent / "data"


def _dash(params, lib, phase):
    d = params["dash"]
    return lib.DynamicStrokeOptions.make_dashed(
        lib.Join[d["join"]],
        [lib.DashInterval(gap_start=i[0], gap_end=i[1],
                          dash_start=lib.Cap[i[2]], dash_end=lib.Cap[i[3]])
         for i in d["intervals"]],
        phase=phase,
    )


def build(params, lib):
    r = params["rect"]
    rect = lib.Path.from_rounded_rect((0.0, 0.0), tuple(r["half_extent"]), r["radius"])
    rect.stroke_options = lib.StrokeOptions(
        width=r["stroke_width"], offset=0.0, miter_clip=r["miter_clip"],
        closed=True, dynamic_stroke_options_group=0,
        curve_approximation=lib.CurveApproximation.uniform_tangent_angle(
            r["tangent_angle"]),
    )
    t = params["text"]
    font = lib.Font(t["font"], (DATA / t["font_file"]).read_bytes())
    glyphs = lib.paths_of_text(
        font.face,
        lib.Layout(size=t["size"], orientation=lib.Orientation.LEFT_TO_RIGHT,
                   major_alignment=lib.Alignment.CENTER,
                   minor_alignment=lib.Alignment.CENTER),
        t["string"],
    )
    for g in glyphs:
        g.reverse()
    shape = lib.Shape([rect] + glyphs, [_dash(params, lib, 0.0)])
    _, colors = _instances(params, 0.0)
    commands = []
    for color in colors:
        commands.append(lib.DrawCommand(lib.RenderOperation.STENCIL, shape, np.eye(4)))
        commands.append(lib.DrawCommand(lib.RenderOperation.COLOR, shape, np.eye(4),
                                        color=tuple(float(c) for c in color)))

    def set_phase(phase):
        shape.set_dynamic_stroke_options(0, _dash(params, lib, phase))

    return Scene(commands, set_phase)


def _instances(params, angle):
    """The instance matrices (N, 4, 4) row-major and colours (N, 4)."""
    cam = params["camera"]
    rows, cols = params["grid"]["rows"], params["grid"]["columns"]
    rotor = np.array([math.cos(angle / 2), 0.0, math.sin(angle / 2), 0.0])
    projection = matrix.matrix_multiplication(
        matrix.perspective_projection(
            cam["fov"], params["width"] / params["height"], cam["near"], cam["far"]),
        matrix.motor3d_to_mat4(matrix.motor3d_product(
            matrix.motor3d_new([1.0, 0, 0, 0, 0, 0, 0, -0.5 * cam["distance"]]),
            matrix.rotor_to_motor3d(rotor),
        )),
    )
    sx, sy, z = params["grid"]["spacing"] + [params["grid"]["z"]]
    n = rows * cols
    xi = np.tile(np.arange(cols, dtype=np.float64), rows)
    yi = np.repeat(np.arange(rows, dtype=np.float64), cols)
    d = np.stack([(xi + 0.5 - cols * 0.5) * sx, (yi + 0.5 - rows * 0.5) * sy,
                  np.full(n, z)], -1)
    mats = []
    for k in range(n):
        motor = matrix.motor3d_new([1.0, 0, 0, 0, 0, d[k, 0], d[k, 1], d[k, 2]])
        mats.append(matrix.matrix_multiplication(
            projection, matrix.motor3d_to_mat4(motor)))
    transforms = np.concatenate([np.asarray(projection)[None], np.asarray(mats)])
    red, green = xi / cols, yi / rows
    colors = np.concatenate([
        np.array([[1.0, 1.0, 1.0, 1.0]]),
        np.stack([red, green, 1.0 - red - green, np.ones(n)], -1),
    ])
    # Column-layout mat4 to the row-major matrices the renderers take.
    return transforms.transpose(0, 2, 1), colors


def transforms(params, angle):
    """(2 (1 + rows x columns), 4, 4) float32: each instance's matrix for
    its STENCIL and its COLOR."""
    mats, _ = _instances(params, angle)
    return np.ascontiguousarray(np.repeat(mats, 2, axis=0), np.float32)
