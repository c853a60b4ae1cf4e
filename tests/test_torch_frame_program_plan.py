"""FrameProgram's fusion planners against the JAX package's, on the host.

The showcase with text, and its clip/alpha variant, are built by each
package with its own types and put under 20 frames of the showcase
orbit (models.showcase.orbit_transforms: 0.05 rad a frame about the y
axis), frames whose instances cross the near plane or lie wholly behind
it included.  Structural runs, projected cover boxes and polygons, the
greedy groupings (per frame and across the motion), the fused plans with
their row gathers, the per-frame re-validation and the rotated settle
probe must equal the reference's to the bit.

The planners read only the command lists, the runs and the renderer's
configuration, so each package's FrameProgram is made here without its
settle renders (``bare_program``); the programs themselves are held to
each other in test_torch_frame_program_ref.py."""

import numpy as np
import pytest

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase

SIZE = 128
#: Every fifth frame of the 99-frame orbit.
FRAMES = tuple(range(0, 100, 5))
STREAMS = ("showcase", "clip_alpha")
PACKAGES = {"reference": (ref, ref_showcase), "port": (port, showcase)}


def bare_program(api, commands):
    """A FrameProgram of ``api`` holding what the planners read (the
    optimized commands, their runs, the renderer's configuration),
    without the settle renders of its constructor."""
    renderer = api.Renderer(api.Configuration(), SIZE, SIZE,
                            **({"device": "cpu"} if api is port else {}))
    program = api.FrameProgram.__new__(api.FrameProgram)
    program._renderer = renderer
    program._commands = list(commands)
    program._opt_commands, program._keep_rows = api._optimize_commands(
        commands
    )
    program._runs = api._structural_runs(program._opt_commands)
    return program


def opt_rows(program, transforms):
    if program._keep_rows is None:
        return transforms
    return np.ascontiguousarray(transforms[program._keep_rows])


@pytest.fixture(scope="module")
def worlds():
    """{stream: {package: (program, {frame: optimized-layout stack})}}."""
    out = {}
    for stream in STREAMS:
        clip_alpha = stream == "clip_alpha"
        out[stream] = {}
        for name, (api, sc) in PACKAGES.items():
            shape = sc.build_shape(with_text=True)
            build = (sc.showcase_commands_clip_alpha if clip_alpha
                     else sc.showcase_commands)
            program = bare_program(api, build(shape, SIZE, SIZE))
            stacks = {
                f: opt_rows(program, sc.command_transforms(
                    SIZE, SIZE, clip_alpha=clip_alpha,
                    view_rotation=showcase.orbit_rotor(f),
                ))
                for f in FRAMES
            }
            out[stream][name] = (program, stacks)
    return out


def assert_plans_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got.signature == want.signature
    assert got.gather.dtype == want.gather.dtype
    assert np.array_equal(got.gather, want.gather)
    assert len(got.commands) == len(want.commands)
    for g, w in zip(got.commands, want.commands):
        assert int(g.operation) == int(w.operation)
        assert g.n_instances == w.n_instances
        assert (g.clip_depth, g.alpha_layer) == (w.clip_depth, w.alpha_layer)
        assert np.array_equal(np.asarray(g.transform), np.asarray(w.transform))
        assert np.array_equal(np.asarray(g.color), np.asarray(w.color))
    assert len(got.groups) == len(want.groups)
    for (_, gs, gc, ge), (_, ws, wc, we) in zip(got.groups, want.groups):
        assert np.array_equal(gs, ws) and np.array_equal(gc, wc)
        assert ge == we


def test_orbit_stacks_match_and_cross_the_near_plane(worlds):
    """The port's orbit stacks equal the reference's command_transforms
    under the same rotors, and the frames chosen hold instances that
    cross the plane w = _NEAR_CLIP_EPS and instances wholly behind it."""
    crossing = behind = 0
    for stream in STREAMS:
        (got_p, got), (_, want) = (worlds[stream]["port"],
                                   worlds[stream]["reference"])
        hull = got_p._runs[0].shape.convex_hull
        hom = np.concatenate(
            [hull, np.zeros((len(hull), 1)), np.ones((len(hull), 1))], axis=1
        )
        for f in FRAMES:
            assert got[f].dtype == want[f].dtype == np.float32
            assert np.array_equal(got[f], want[f]), f
            rows = got[f][got_p._runs[0].stencil_rows].astype(np.float64)
            front = np.einsum("mrk,hk->mhr", rows, hom)[..., 3] > (
                port._NEAR_CLIP_EPS
            )
            crossing += int((front.any(1) & ~front.all(1)).any())
            behind += int((~front).all(1).any())
    assert crossing >= 20 and behind >= 20, (crossing, behind)


@pytest.mark.parametrize("stream", STREAMS)
def test_structural_runs_match_reference(worlds, stream):
    """Start, pair positions, stencil and cover rows and the escape flag
    of every run."""
    runs = {}
    for name, (program, _) in worlds[stream].items():
        index = {id(c): i for i, c in enumerate(program._opt_commands)}
        runs[name] = [
            (r.start, [(index[id(s)], index[id(c)]) for s, c in r.pairs],
             r.stencil_rows.tolist(), r.cover_rows.tolist(), r.escape)
            for r in program._runs
        ]
    assert runs["port"] == runs["reference"]
    assert len(runs["port"]) >= 1 and len(runs["port"][0][1]) == 46


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("stream", STREAMS)
def test_planners_match_reference(worlds, stream, frame):
    """Under one orbit frame: _run_boxes (boxes, ok, polys, through
    _clip_poly_near where the hulls cross the near plane),
    _greedy_box_groups, _plan_for_groups, _derive_plan, and
    _plan_transforms_if_valid for this frame's plan and frame 0's."""
    out = {}
    for name, (program, stacks) in worlds[stream].items():
        api = PACKAGES[name][0]
        t = stacks[frame]
        boxes = [api._run_boxes(r.shape, t[r.stencil_rows])
                 for r in program._runs]
        groups = [api._greedy_box_groups(*b) for b in boxes]
        grouped = api._plan_for_groups(
            program._opt_commands, program._runs,
            [(g, False) for g in groups],
        )
        plan = program._derive_plan(t)
        first = program._derive_plan(stacks[FRAMES[0]])
        valid = [program._plan_transforms_if_valid(p, t)
                 for p in (plan, first) if p is not None]
        out[name] = boxes, groups, grouped, plan, valid
    got, want = out["port"], out["reference"]
    for (gb, gok, gp), (wb, wok, wp) in zip(got[0], want[0]):
        for g, w in ((gb, wb), (gok, wok), (gp, wp)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    assert_plans_equal(got[2], want[2])
    assert_plans_equal(got[3], want[3])
    assert len(got[4]) == len(want[4])
    for g, w in zip(got[4], want[4]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("stream", STREAMS)
def test_motion_grouping_matches_reference(worlds, stream):
    """_greedy_box_groups_multi over the whole orbit and over its first
    half, and the fused plan of each."""
    out = {}
    for name, (program, stacks) in worlds[stream].items():
        api = PACKAGES[name][0]
        out[name] = []
        for frames in (FRAMES, FRAMES[: len(FRAMES) // 2]):
            groupings = []
            for r in program._runs:
                per = [api._run_boxes(r.shape, stacks[f][r.stencil_rows])
                       for f in frames]
                ok = np.logical_and.reduce([o for _, o, _ in per])
                groupings.append((api._greedy_box_groups_multi(
                    [(b, p) for b, _, p in per], ok), False))
            out[name].append((
                groupings,
                api._plan_for_groups(program._opt_commands, program._runs,
                                     groupings),
            ))
    for (g_groups, g_plan), (w_groups, w_plan) in zip(out["port"],
                                                      out["reference"]):
        assert g_groups == w_groups
        assert_plans_equal(g_plan, w_plan)


@pytest.mark.parametrize("stream", STREAMS)
def test_rotated_probe_matches_reference(worlds, stream):
    """The settle probe's transforms, command by command."""
    got = port._rotated_probe_commands(worlds[stream]["port"][0]._commands)
    want = ref._rotated_probe_commands(
        worlds[stream]["reference"][0]._commands
    )
    assert port.SETTLE_PROBE_ANGLE == ref.SETTLE_PROBE_ANGLE
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g.transform), np.asarray(w.transform)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_polygon_predicates_match_reference():
    """_convex_polys_disjoint and _poly_orientation_signs on 300 seeded
    pairs of convex polygons of either winding, some touching, some
    degenerate."""
    rng = np.random.default_rng(11)
    polys = []
    for _ in range(600):
        n = int(rng.integers(3, 8))
        angles = np.sort(rng.uniform(0, 2 * np.pi, n))
        if rng.random() < 0.5:
            angles = angles[::-1]
        centre = rng.uniform(-2, 2, 2)
        radius = rng.uniform(0.0 if rng.random() < 0.05 else 0.2, 1.5)
        polys.append(centre + radius * np.stack(
            [np.cos(angles), np.sin(angles)], -1))
    for a, b in zip(polys[::2], polys[1::2]):
        assert (port._convex_polys_disjoint(a, b)
                == ref._convex_polys_disjoint(a, b))
    stack = np.stack([np.resize(p, (7, 2)) for p in polys])
    assert np.array_equal(port._poly_orientation_signs(stack),
                          ref._poly_orientation_signs(stack))
    square = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    assert not port._convex_polys_disjoint(square, square + [1.0, 0.0])
    assert port._convex_polys_disjoint(square, square + [1.5, 0.0])
