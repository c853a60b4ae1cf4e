"""FrameProgram's captured frame step, on the CPU.

On a CUDA device each variant's binning and raster run as one CUDA graph
(``renderer._FrameStep``); on the CPU the same step object runs the same
function eagerly on the same static buffers.  Here: ``make_prepare``
uploads nothing and reads nothing back after its first call (what a
capture needs), and its hoisted constants serve any transform stack
bit for bit like the reference run op by op (``jax.disable_jit``), but
for the near-plane rows, held to the port's binning in float64
(``float64_binning``, ``assert_binning_near_reference``; shared with
tests/test_torch_near_plane.py); the showcase orbit through the port's
``FrameProgram`` against its float64-binned frames and the JAX
package's ``FrameProgram.render_sequence`` of the same six frames,
packed RGBA8 (one reference render per file, its kernel in interpret
mode); returned images that later frames leave alone; the sequence
renderer against the calls; and a capacity growth that drops the steps
and renders right after."""

from collections import Counter
from contextlib import contextmanager
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

SIZE = 96
#: Orbit frames of run_configs.config5_orbit; 18 to 30 cross the near
#: plane (tests/test_torch_frame_program_plan.py counts them).
FRAMES = (0, 6, 12, 18, 24, 30)
PACKAGES = {
    "reference": (ref, ref_path, ref_showcase),
    "port": (port, port_path, showcase),
}


def orbit_stacks():
    return [showcase.orbit_transforms(i, SIZE, SIZE) for i in FRAMES]


def bracket(api, g):
    return scenes.bracket_commands(api, g)


def bracket_unclip_moved(api, g):
    """The bracket with its UNCLIP moved: equal rows no longer, so the
    gating turns off at run time (tests/test_torch_gate.py)."""
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 0.25
    return scenes.bracket_commands(api, g, unclip_transform=moved)


def orbit(api, g, showcase_module, frame, with_text=False):
    shape = showcase_module.build_shape(with_text=with_text)
    return showcase_module.showcase_commands(
        shape, SIZE, SIZE, view_rotation=showcase.orbit_rotor(frame)
    )


#: name: (config, {label: the commands as a function of (api, path,
#: showcase)}); the first label's spec bins every label's transforms.
BINNING = {
    "bracket": (
        dict(blending="front_to_back"),
        {"gated": lambda a, g, s: bracket(a, g),
         "ungated": lambda a, g, s: bracket_unclip_moved(a, g)},
    ),
    "orbit": (
        {},
        {"frame 0": lambda a, g, s: orbit(a, g, s, 0),
         "frame 30": lambda a, g, s: orbit(a, g, s, 30)},
    ),
}


def renderer(package, size=SIZE, **config):
    api = PACKAGES[package][0]
    if package == "reference":
        return api.Renderer(api.Configuration(**config), size, size,
                            interpret=True, auto_instance=False)
    return api.Renderer(api.Configuration(**config), size, size,
                        auto_instance=False, device="cpu")


def binning_inputs(package, commands, size=SIZE, **config):
    """The spec, scene arrays, transforms, desc_static and paint points
    that ``package``'s renderer derives for ``commands`` (sequential)."""
    api = PACKAGES[package][0]
    r = renderer(package, size, **config)
    opt, _ = api._optimize_commands(commands)
    shapes, index = r._unique_shapes(opt)
    _, scene = r._scene_arrays(shapes)
    inst = tuple(c.n_instances for c in opt)
    spec = r._spec(
        tuple(int(c.operation) for c in opt),
        tuple(r._cmd_shape_entry(c, index) for c in opt),
        inst if any(n != 1 for n in inst) else (),
        scene,
        tuple(api._spec_paint(c.color) for c in opt),
        commands=opt,
    )
    _, desc_i = r._pack_descriptors(shapes)
    return (spec, scene, r._pack_transforms(opt),
            np.ascontiguousarray(desc_i[:, [9, 8]]), r._pack_paints(opt))


def port_args(scene, transforms, desc_static, paints):
    return (*scene.arrays, torch.as_tensor(transforms),
            torch.as_tensor(desc_static),
            None if paints is None else torch.as_tensor(paints))


def bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


def rows_in_ranges(rows, ranges):
    return np.concatenate(
        [rows[t, :ranges[t, 0, -1]] for t in range(len(rows))]
    )


def assert_binning_equal(got, want):
    """Every binning output to the bit, the entry rows inside their
    ranges (rows past a tile's count are never read)."""
    for name in ("off", "g_off", "bulk", "cls", "hbits", "acount", "aclist",
                 "overflow", "hull_lines", "paint_xy", "zplane"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(bits(a), bits(b)), name
    for rows, ranges in (("tri_f", "off"), ("tri_i", "off"),
                         ("g_tri_f", "g_off"), ("g_tri_i", "g_off")):
        a = rows_in_ranges(np.asarray(getattr(want, rows)),
                           np.asarray(getattr(want, ranges)))
        b = rows_in_ranges(getattr(got, rows).numpy(),
                           getattr(got, ranges).numpy())
        assert np.array_equal(bits(a), bits(b)), rows


@contextmanager
def float64_binning():
    """A context in which the port's ``make_prepare`` bins in float64
    (``coverage.prepare_in_float64``): the oracle of near-plane
    binning, what the float32 binning should round to."""
    make_prepare = port_cov.make_prepare
    with pytest.MonkeyPatch.context() as patched:
        patched.setattr(port_cov, "make_prepare", lambda spec: (
            port_cov.prepare_in_float64(make_prepare(spec))))
        yield


#: The columns of a clip-pool row that the port computes otherwise than
#: the reference: the three edge constants (coverage._nearer_endpoint)
#: and 1 / |area| (coverage._from_nearest_vertex).
NEAR_COLUMNS = [2, 5, 8, port_cov.RF_INV_AREA]
#: A near-plane line (a clip-pool row's edge, a clipped hull's line)
#: within this many pixels of the float64 oracle's line at every corner
#: of the grid, or both beyond the grid on one side.  (A far vertex
#: rounds apart in float32 and float64, which turns the line itself:
#: ulps of c alone do not measure it.  The reference's constants miss by
#: 0.05 to 1.9 px on these frames.)
LINE_PX = 2.0 ** -6
#: A near-plane row's 1 / |area| within this share of the oracle's: the
#: area of a triangle with a vertex near 1e8 px moves with that vertex's
#: float32 rounding (5.5e-4 at most on these frames).
INV_AREA_SHARE = 2.0 ** -10


def line_gaps(got, want, width, height):
    """For lines (n, 3) and (m, 3) as (a, b, c), broadcast: the largest
    difference of their signed distances at the grid's four corners, in
    float64 pixels, or 0 where both lie beyond the grid on one side."""
    corners = np.array([[0, 0], [width, 0], [0, height], [width, height]],
                       np.float64)

    def offsets(lines):
        lines = np.asarray(lines, np.float64)
        return ((lines[..., None, :2] * corners).sum(-1) + lines[..., 2:3]
                ) / np.hypot(lines[..., 0], lines[..., 1])[..., None]

    g, w = offsets(got), offsets(want)
    beyond = ((g > 0).all(-1) & (w > 0).all(-1)) | (
        (g < 0).all(-1) & (w < 0).all(-1))
    return np.where(beyond, 0.0, np.abs(g - w).max(-1))


def entry_rows(binning):
    """The (float, int) rows of every tile's local and global entries
    inside their ranges, as numpy."""
    f, i = [], []
    for rows_f, rows_i, ranges in (("tri_f", "tri_i", "off"),
                                   ("g_tri_f", "g_tri_i", "g_off")):
        r = np.asarray(getattr(binning, ranges))
        f.append(rows_in_ranges(np.asarray(getattr(binning, rows_f)), r))
        i.append(rows_in_ranges(np.asarray(getattr(binning, rows_i)), r))
    return np.concatenate(f), np.concatenate(i)


def assert_binning_near_reference(got, want, oracle, width, height):
    """``got`` (the port's binning) against ``want`` (the reference's, op
    by op) and ``oracle`` (the port's binning in float64).

    Each table equals the reference's to the bit, or else the oracle's
    (the tile outputs that follow from the near-plane rows).  Each entry
    row equals a reference row to the bit (as a multiset: the same
    triangle in as many tiles), or it is a near-plane row: one that
    differs from a reference row in NEAR_COLUMNS only, or one that only
    the port bins (a thin clipped triangle whose area the reference's
    rounding cancels to 0).  A near-plane row is held to the oracle's
    row of equal int columns and nearest lines (the oracle's ranges may
    hold an entry more or less, so rows are matched, not indexed): its
    three lines within LINE_PX and its 1 / |area| within INV_AREA_SHARE.
    No reference row is left over.  A hull line's c such that the line
    lies within LINE_PX of the oracle's line of that draw and slot, its
    other columns the reference's.  Returns the number of near-plane
    rows and hull constants."""
    for name in ("off", "g_off", "bulk", "cls", "hbits", "acount", "aclist",
                 "overflow", "paint_xy", "zplane"):
        a, b, c = (bits(np.asarray(getattr(x, name)))
                   for x in (want, got, oracle))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b) or np.array_equal(b, c), name
    (wf, wi), (gf, gi), (of, oi) = (entry_rows(x) for x in (want, got, oracle))
    near = np.zeros(wf.shape[-1], bool)
    near[NEAR_COLUMNS] = True

    def key(f, i, r):
        return bits(f[r]).tobytes() + i[r].tobytes()

    spare = Counter(key(wf, wi, r) for r in range(len(wf)))
    pending = []
    for r in range(len(gf)):
        k = key(gf, gi, r)
        if spare[k]:
            spare[k] -= 1
        else:
            pending.append(r)
    left = []  # reference rows that no port row equals
    for r in range(len(wf)):
        k = key(wf, wi, r)
        if spare[k]:
            spare[k] -= 1
            left.append(r)
    for r in pending:
        paired = [
            w for w in left
            if np.array_equal(wi[w], gi[r])
            and np.array_equal(bits(wf[w, ~near]), bits(gf[r, ~near]))
        ]
        if paired:
            left.remove(paired[0])
        same = np.flatnonzero((oi == gi[r]).all(-1))
        assert len(same), f"row {r}: no oracle row of its int columns"
        gap = np.max([
            line_gaps(gf[r, 3 * e:3 * e + 3], of[same, 3 * e:3 * e + 3],
                      width, height)
            for e in range(3)
        ], 0)
        match = of[same[np.argmin(gap)]]
        assert gap.min() <= LINE_PX, (r, gap.min())
        inv_area = float(gf[r, port_cov.RF_INV_AREA])
        want_inv_area = float(match[port_cov.RF_INV_AREA])
        assert abs(inv_area - want_inv_area) <= (
            INV_AREA_SHARE * want_inv_area), (r, inv_area, want_inv_area)
    assert not left, f"reference rows the port does not bin: {left}"
    a, b, c = (np.asarray(x.hull_lines) for x in (want, got, oracle))
    differs = bits(a) != bits(b)
    assert not differs[..., [0, 1, 3]].any(), "hull_lines"
    d = differs[..., 2]
    gap = line_gaps(b[d][:, :3], c[d][:, :3], width, height)
    assert (gap <= LINE_PX).all(), gap.max()
    return len(pending) + int(d.sum())


class HostAccess(AssertionError):
    pass


def forbid_host_access(monkeypatch):
    """Make every way of building a tensor from host memory, and of
    reading a tensor's value on the host, raise."""
    def refuse(name):
        def call(*args, **kwargs):
            raise HostAccess(name)
        return call

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))
    for name in ("item", "tolist", "numpy", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))


#: Frames that reach every device constant of make_prepare: gate masks
#: and row gathers (clip/alpha), paint points and depth planes.
CONSTANT_SCENES = {
    "clip_alpha": (
        dict(blending="front_to_back"),
        lambda: showcase.showcase_commands_clip_alpha(
            showcase.build_shape(with_text=False), SIZE, SIZE),
    ),
    "paints_depth": (
        dict(depth_compare="less_equal", depth_write_enabled=True),
        lambda: scenes.mixed_paints(SIZE, SIZE),
    ),
}


@pytest.mark.parametrize("name", sorted(CONSTANT_SCENES))
def test_second_prepare_touches_no_host_memory(name, monkeypatch):
    """After its first call a prepare closure builds no tensor from
    host memory and reads no tensor's value on the host: each such call
    is patched to raise during the second call, which bins equal to the
    first."""
    config, build = CONSTANT_SCENES[name]
    spec, scene, transforms, desc_static, paints = binning_inputs(
        "port", build(), **config)
    if name == "clip_alpha":
        assert spec.gate_spans
    else:
        assert paints is not None and port_cov.has_depth(spec)
    args = port_args(scene, transforms, desc_static, paints)
    prepare = port_cov.make_prepare(spec)
    first = prepare(*args)
    with monkeypatch.context() as patched:
        forbid_host_access(patched)
        with pytest.raises(HostAccess):
            torch.tensor(0.0)
        second = prepare(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@lru_cache(maxsize=None)
def reference_binning(name, label):
    config, builds = BINNING[name]
    first = builds[next(iter(builds))](*PACKAGES["reference"])
    spec, scene, _, desc_static, _ = binning_inputs(
        "reference", first, **config)
    transforms = binning_inputs(
        "reference", builds[label](*PACKAGES["reference"]), **config)[2]
    with jax.disable_jit():
        return ref_cov.make_prepare(spec)(
            *scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static)
        )


@pytest.mark.parametrize("name", sorted(BINNING))
def test_one_closure_bins_each_stack_like_reference(name):
    """Two transform stacks through one prepare closure (its constants
    made by the first): each binning equals the reference's, run op by
    op, to the bit.  The bracket's second stack moves the UNCLIP, so its
    gating turns off at run time; the orbit's second frame crosses the
    near plane, where the port takes the edge constants of the clip
    pool's rows and of the clipped hulls' lines at their smaller
    endpoint (coverage._nearer_endpoint), and the pool's areas at their
    nearest vertex (coverage._from_nearest_vertex), and the reference at the
    first: those columns, and only they, differ from the reference's,
    each within the stated bounds of the float64 oracle
    (assert_binning_near_reference; at 96² no table differs)."""
    config, builds = BINNING[name]
    labels = list(builds)
    commands = {k: b(*PACKAGES["port"]) for k, b in builds.items()}
    spec, scene, _, desc_static, _ = binning_inputs(
        "port", commands[labels[0]], **config)
    prepare = port_cov.make_prepare(spec)
    with float64_binning():
        oracle = port_cov.make_prepare(spec)
    got = {}
    for label in labels:
        transforms = binning_inputs("port", commands[label], **config)[2]
        args = port_args(scene, transforms, desc_static, None)
        got[label] = prepare(*args)
        want = reference_binning(name, label)
        if int(got[label].overflow[3]) == 0:
            assert_binning_equal(got[label], want)
        else:
            assert assert_binning_near_reference(
                got[label], want, oracle(*args), SIZE, SIZE) > 0
    first, second = (got[k] for k in labels)
    if name == "bracket":
        assert int(second.acount.sum()) > int(first.acount.sum())
    else:
        assert int(first.overflow[3]) == 0 < int(second.overflow[3])


def orbit_program(package, stacks):
    """``package``'s compile_frame of the showcase (with text), planned
    for ``stacks``; the port's on the CPU, the reference's in interpret
    mode."""
    api, _, showcase_module = PACKAGES[package]
    shape = showcase_module.build_shape(with_text=True)
    kw = {"device": "cpu"} if package == "port" else {"interpret": True}
    r = api.Renderer(api.Configuration(), SIZE, SIZE,
                     strict_capacity=False, **kw)
    program = r.compile_frame(
        showcase_module.showcase_commands(shape, SIZE, SIZE),
        uint8_output=True,
    )
    assert program.plan_for_motion(stacks)
    return program


@pytest.fixture(scope="module")
def orbit_frames():
    """The showcase orbit (with text, packed RGBA8) over FRAMES through
    each package's compile_frame and plan_for_motion: the reference's
    render_sequence, and the port's program and its frames, called one
    by one; and the port's frames from a program that bins in float64
    (float64_binning), the oracle of the near-plane frames."""
    stacks = orbit_stacks()
    out = {"reference": np.asarray(
        orbit_program("reference", stacks).render_sequence(np.stack(stacks)))}
    program = out["program"] = orbit_program("port", stacks)
    out["port"] = [program(t) for t in stacks]
    with float64_binning():
        oracle = orbit_program("port", stacks)
        out["float64"] = [oracle(t).numpy() for t in stacks]
    return out


def orbit_binnings(frame):
    """Frame ``frame`` of the orbit (with text) binned four ways: the
    reference jitted, as its FrameProgram runs it, and op by op; the
    port; and the port in float64.  Holds the port's binning to the op
    by op one (assert_binning_near_reference) and returns whether the
    jitted tables equal the op-by-op ones."""
    commands = {
        package: orbit(api, g, s, frame, with_text=True)
        for package, (api, g, s) in PACKAGES.items()
    }
    spec, scene, transforms, desc_static, _ = binning_inputs(
        "reference", commands["reference"])
    prepare = ref_cov.make_prepare(spec)
    args = (*scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static))
    jitted = jax.jit(prepare)(*args)
    with jax.disable_jit():
        op_by_op = prepare(*args)
    pspec, pscene, ptransforms, pdesc, _ = binning_inputs(
        "port", commands["port"])
    pargs = port_args(pscene, ptransforms, pdesc, None)
    got = port_cov.make_prepare(pspec)(*pargs)
    with float64_binning():
        oracle = port_cov.make_prepare(pspec)(*pargs)
    if int(got.overflow[3]):
        assert_binning_near_reference(got, op_by_op, oracle, SIZE, SIZE)
    else:
        assert_binning_equal(got, op_by_op)
    return all(
        np.array_equal(np.asarray(getattr(jitted, k)),
                       np.asarray(getattr(op_by_op, k)))
        for k in ("off", "g_off", "bulk", "cls", "hbits", "acount", "aclist")
    )


def test_orbit_program_matches_reference_render_sequence(orbit_frames):
    """The port's program, one call a frame, against the frames of a
    program that bins in float64, and against the JAX package's
    render_sequence of the same six frames, packed RGBA8.  Every frame
    agrees with its float64-binned frame within the parity bar of
    assert_images_agree (at most 1e-3 of the pixels, each off by at most
    one sample's share).  A frame beyond the bar against the reference
    must be one where the reference's frame is beyond it against the
    float64-binned frame, and where the reference's jitted binning (XLA
    on the CPU contracts multiply-adds into fused ones) differs from its
    own op-by-op binning, which the port's equals but for its near-plane
    rows (assert_binning_near_reference).  Measured at 96²: frames 0 to
    12 equal to the bit on all three sides; frames 18 and 24 one pixel
    (1.1e-4 of the pixels) off their float64 frames, by one sample (a
    sample within 1e-5 px of an edge whose vertices all lie within
    1,580 px: ordinary float32 rounding, no clipped vertex); frame 18's
    reference equal to the float64 frame; frame 24 7.42% off the
    reference, whose frame is 7.43% off the float64 one; frame 30 equal
    to its float64 frame and 13.0% off the reference, whose frame is
    13.0% off the float64 one (the reference's edge constants at clipped
    vertices: its fused grouping draws a leaking stencil before another
    instance's cover)."""
    want, got = orbit_frames["reference"], orbit_frames["port"]
    assert want.shape == (len(FRAMES), SIZE, SIZE, 4)
    beyond = {}
    for frame, g, w, o in zip(FRAMES, got, want, orbit_frames["float64"]):
        g = g.numpy()
        assert_images_agree(g, o)
        try:
            assert_images_agree(g, w)
        except AssertionError:
            beyond[frame] = float((g != w).any(-1).mean())
            with pytest.raises(AssertionError):
                assert_images_agree(w, o)
    for frame, share in beyond.items():
        assert not orbit_binnings(frame), (
            f"frame {frame}: {share:.2e} of the pixels differ")
    assert len(beyond) < len(FRAMES) // 2, beyond
    assert orbit_frames["program"].stats["fused"]
    assert not np.array_equal(want[0], want[-1])


def test_returned_images_stay_after_later_frames(orbit_frames):
    """Each returned frame is a tensor of its own: rendering later
    frames leaves it as it was, while the step's frame buffer moves on."""
    program, frames = orbit_frames["program"], orbit_frames["port"]
    kept = [f.clone() for f in frames]
    for t in orbit_stacks()[2::-1]:  # frames 12, 6, then 0 again
        image = program(t)
    step = program._fused_variants[program._plan.signature][1].step
    assert all(image.data_ptr() != f.data_ptr() for f in frames)
    assert all(f.data_ptr() != step.frame.data_ptr() for f in frames)
    for f, k in zip(frames, kept):
        assert torch.equal(f, k)
    assert torch.equal(image, frames[0])


def test_render_sequence_equals_calls(orbit_frames):
    """render_sequence of the six frames replays one step and equals
    the per-frame calls."""
    program = orbit_frames["program"]
    frames = program.render_sequence(np.stack(orbit_stacks()))
    assert frames.dtype == torch.uint8
    for got, want in zip(frames, orbit_frames["port"]):
        assert torch.equal(got, want)


def test_capacity_growth_drops_steps_and_renders_right():
    """A program shrunk below what its frames bin: the deferred counters
    grow it within one call on the CPU, the rebuild drops every variant's
    step (a graph on the card) and makes new ones, and the frames after
    it equal the strict sequential render, by call and by sequence."""
    t = scenes.ortho(64, 64)
    commands = []
    for i in range(12):
        s = port.Shape([port_path.Path.from_circle((32, 32), 30 - 2 * i)])
        commands += [
            port.DrawCommand(port.RenderOperation.STENCIL, s, t),
            port.DrawCommand(port.RenderOperation.COLOR, s, t,
                             color=(i / 12, 1 - i / 12, 0.5, 1.0)),
        ]
    want = renderer("port", 64).render(commands, to_host=False)
    program = port.Renderer(port.Configuration(), 64, 64, device="cpu"
                            ).compile_frame(commands)
    program._caps["capacity"] = 8
    program._build()
    builds = program.builds
    program()
    old = program._seq.step
    assert old is not None
    program()
    assert program.builds == builds + 1 and program._caps["capacity"] > 8
    assert program._seq.step is not old
    assert torch.equal(program(), want)
    stack = np.stack([port.Renderer._pack_transforms(commands)] * 2)
    for frame in program.render_sequence(stack, as_uint8=False):
        assert torch.equal(frame, want)


def test_dropped_program_frees_its_steps_without_a_collection():
    """No reference cycle holds a frame step: dropping the program frees
    the step (on the card, its graph) at once, with the collector off,
    so that no collection frees a graph later, at a moment a capture of
    another program may be running."""
    import gc
    import weakref

    t = scenes.ortho(64, 64)
    shape = port.Shape([port_path.Path.from_circle((20, 20), 10)])
    program = port.Renderer(port.Configuration(), 64, 64, device="cpu"
                            ).compile_frame([
        port.DrawCommand(port.RenderOperation.STENCIL, shape, t),
        port.DrawCommand(port.RenderOperation.COLOR, shape, t,
                         color=(1.0, 0.0, 0.0, 1.0)),
    ])
    program()
    step = weakref.ref(program._seq.step)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del program
        assert step() is None
    finally:
        if collecting:
            gc.enable()
