"""The port's FrameProgram hysteresis against the JAX package's, both
rendering.

The three circles of tests/test_torch_frame_program_ref.py at 64²,
through each package's ``compile_frame(uint8_output=True)``, over the
reference's partial-overlap motion (tests/test_renderer.py,
test_partial_overlap_regroups_into_disjoint_groups: the second circle
slid onto the first, three frames), back to the original layout, then an
oscillation between the partial overlap and the original layout, with
one frame whose third circle meets the second (a grouping derived once,
so walked in sequence and not built).  After every frame both programs
wait for their builds (the reference's run on a background thread, the
port's are done when the frame returns); then each frame's choice (the
active plan's signature, or None for the sequential walk), the
hysteresis counts, the builds in flight (none) and the installed
groupings must be equal, and the packed frames within the parity bar.  Last, ``plan_for_motion(..., wait=False)`` and
``wait_fused_compiles()`` give the same answers and plan.  The motion
visits three groupings and builds one: each build is a compile of about
20 s for the reference, its raster kernel in interpret mode; one program
per package serves the file."""

import numpy as np
import pytest

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from test_torch_frame_program_ref import SIZE, circles
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

#: The layouts (offsets of the three circles, in pixels): as built (all
#: three fuse), the partial overlap (0,) + (1, 2), and the third circle
#: on the second, (0, 1) + (2,).
LAYOUTS = {
    "apart": ((0.0, 0.0), (24.0, 0.0), (48.0, 0.0)),
    "overlap": ((0.0, 0.0), (6.0, 4.0), (40.0, 0.0)),
    "third": ((0.0, 0.0), (24.0, 0.0), (28.0, 4.0)),
}
MOTION = ["overlap"] * 3 + ["apart", "third", "overlap", "apart", "overlap"]
SPLIT = ((False, (0,), (1, 2)),)
PACKAGES = {
    "reference": (ref, ref_path, {}),
    "port": (port, port_path, {"device": "cpu"}),
}


def stack(api, g, layout):
    return api.Renderer._pack_transforms(circles(api, g, LAYOUTS[layout]))


def state(program):
    """What the frame left: the active plan's signature, the hysteresis
    counts, the builds in flight (the port has none) and the installed
    groupings."""
    return (
        None if program._plan is None else program._plan.signature,
        dict(program._sig_counts),
        set(getattr(program, "_compiling", ())),
        set(program._fused_variants),
    )


@pytest.fixture(scope="module")
def runs():
    """Each package's program over MOTION: per frame its state after the
    builds and its packed frame; then plan_for_motion(wait=False)'s
    answer, wait_fused_compiles()'s and the plan's signature."""
    out = {}
    for name, (api, g, kw) in PACKAGES.items():
        renderer = api.Renderer(api.Configuration(), SIZE, SIZE, **kw)
        program = renderer.compile_frame(circles(api, g), uint8_output=True)
        frames, states = [], []
        for layout in MOTION:
            frames.append(np.asarray(program(stack(api, g, layout))))
            assert program.wait_fused_compiles(timeout=300.0)
            states.append(state(program))
        planned = program.plan_for_motion(
            [stack(api, g, "apart"), stack(api, g, "overlap")], wait=False)
        waited = program.wait_fused_compiles()
        out[name] = {
            "frames": frames, "states": states,
            "plan": (planned, waited, program._plan.signature,
                     set(program._fused_variants)),
        }
    return out


@pytest.mark.parametrize("frame", range(len(MOTION)))
def test_choice_and_hysteresis_match_reference(runs, frame):
    """Frame by frame: the same choice, counts and groupings.  The
    reference's own expectations hold too: the partial overlap walks in
    sequence twice (counted, then built) before it is served fused."""
    got, want = runs["port"]["states"][frame], runs["reference"]["states"][frame]
    assert got == want
    assert not got[2]
    if frame < 2:
        assert got[0] is None and got[1][SPLIT] == frame + 1
    if frame == 2:
        assert got[0] == SPLIT


def test_motion_visits_three_groupings(runs):
    """The grouping built with the program (all three circles) and the
    split are installed; the split and the third circle's grouping are
    counted; the frames walk in sequence or fused by the split."""
    states = runs["reference"]["states"]
    everything, third = ((False, (0, 1, 2)),), ((False, (0, 1), (2,)),)
    assert states[-1][3] == {everything, SPLIT}
    assert states[-1][1] == {SPLIT: 2, third: 1}
    assert [s[0] for s in states] == [None, None] + [SPLIT] * 2 + [None] + [
        SPLIT] * 3


@pytest.mark.parametrize("frame", range(len(MOTION)))
def test_frames_match_reference(runs, frame):
    """Packed RGBA8 within the parity bar of assert_images_agree."""
    assert_images_agree(runs["port"]["frames"][frame],
                        runs["reference"]["frames"][frame])


def test_plan_for_motion_without_wait_matches_reference(runs):
    """plan_for_motion(..., wait=False) and then wait_fused_compiles():
    True and True in both packages, with the same plan and groupings."""
    got, want = runs["port"]["plan"], runs["reference"]["plan"]
    assert got == want
    assert got[:2] == (True, True)
