"""The port's FrameProgram against the JAX package's, both rendering.

Three circles as in tests/test_renderer.py (TestFrameProgramFusion), at
64², through each package's ``compile_frame(uint8_output=True)``: the
settled capacities, the motion plans of the reference's sweep
(test_plan_for_motion_fuses_across_sweep) and of a motion that adds a
frame whose first circle crosses the near plane, and the packed RGBA8
images of the three frames of that motion.  The reference runs on the
CPU (its raster kernel in interpret mode); one program per package
serves the whole file."""

import numpy as np
import pytest

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

SIZE = 64
OFFSETS = ((0.0, 0.0), (24.0, 0.0), (48.0, 0.0))
#: w = 0.1 y - 0.5 over the circle's hull (y in [1, 11]): it crosses the
#: near plane (tests/test_renderer.py,
#: test_near_plane_crossing_pair_fuses_when_clipped_cover_disjoint).
CROSSING = np.array(
    [[0.02, 0.0, 0.0, 0.0],
     [0.0, 0.02, 0.0, 0.0],
     [0.0, 0.0, 0.0, 0.0],
     [0.0, 0.1, 0.0, -0.5]],
    np.float32,
)


def translate(tx, ty):
    t = scenes.ortho(SIZE, SIZE)
    t[0, 3] += 2.0 * tx / SIZE
    t[1, 3] += 2.0 * ty / SIZE
    return t


def circles(api, g, offsets=OFFSETS):
    shape = api.Shape([g.Path.from_circle((6.0, 6.0), 5.0)])
    out = []
    for k, (dx, dy) in enumerate(offsets):
        t = translate(dx, dy)
        color = (1.0 - 0.2 * k, 0.2 * k, 0.3, 0.6)
        out += [
            api.DrawCommand(api.RenderOperation.STENCIL, shape, t),
            api.DrawCommand(api.RenderOperation.COLOR, shape, t, color=color),
        ]
    return out


def swept(dy):
    """The sweep's stack: the outer circles moved up by ``dy``."""
    return port.Renderer._pack_transforms(
        circles(port, port_path, [(0.0, dy), (24.0, 0.0), (48.0, dy)])
    )


def crossing_frame():
    stack = swept(0.0).copy()
    stack[0] = stack[1] = CROSSING
    return stack


MOTION = {"sweep": [swept(dy) for dy in (0.0, 8.0, 16.0)]}
MOTION["crossing"] = [swept(0.0), swept(8.0), crossing_frame()]


@pytest.fixture(scope="module")
def programs():
    """Each package's program, and what it showed on the way: settled
    capacities, then per motion the plan_for_motion result, signature
    and capacities; then the packed frames of the crossing motion."""
    out = {}
    for name, api, g, kw in (
        ("reference", ref, ref_path, {}),
        ("port", port, port_path, {"device": "cpu"}),
    ):
        renderer = api.Renderer(api.Configuration(), SIZE, SIZE, **kw)
        program = renderer.compile_frame(circles(api, g), uint8_output=True)
        seen = {"settled": dict(program._caps)}
        for motion, stacks in MOTION.items():
            fused = program.plan_for_motion(stacks)
            seen[motion] = (fused, program._plan.signature,
                            dict(program._caps))
        seen["images"] = [np.asarray(program(t)) for t in MOTION["crossing"]]
        out[name] = seen
    return out


def test_settled_capacities_match_reference(programs):
    assert programs["port"]["settled"] == programs["reference"]["settled"]


@pytest.mark.parametrize("motion", sorted(MOTION))
def test_motion_plans_match_reference(programs, motion):
    """The same fused grouping (all three circles, as the reference's
    tests expect), and the same capacities after the scout."""
    got, want = programs["port"][motion], programs["reference"][motion]
    assert got == want
    assert got[0] is True and got[1] == ((False, (0, 1, 2)),)


def test_images_match_reference(programs):
    """The crossing motion's frames, packed RGBA8 (the parity bar of
    assert_images_agree: 99.9% of pixels equal, the others off by at
    most one sample's share; measured equal to the bit), and the
    near-plane frame draws its clipped circle."""
    got, want = programs["port"]["images"], programs["reference"]["images"]
    for g, w in zip(got, want):
        assert_images_agree(g, w)
    assert (want[2] != want[0]).any()
