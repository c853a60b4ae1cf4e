"""Binning's cover stage: the kernel of csrc/cover_bins.cu against its
plain torch version (``coverage.cover_bins_plain``).

On the card (the ``cuda`` marker; skipped without a CUDA device): the
kernel's ``hull_lines``, ``cls`` and ``hbits`` equal the plain
version's, run on the card too, to the bit, in float32 and float64
(``coverage.prepare_in_float64``), inside ``make_prepare`` on the drift
frames' scenes (config 3's dashed strokes and config 2's fills, one
stencil command and one cover draw each) at a reduced size, the 96²
orbit frame 30 (hulls
clipped at the near plane), the 128² clip/alpha showcase, a frame of
depth and paints and config 4 per glyph (10,080 covers); and called
alone on random hulls of up to 31 lines, with zero-area hulls and hulls
wholly behind the near plane, at 1, 32 and 128 strips a tile.  A
captured binning step replays the kernel's outputs, one launch a replay
(``cover_bin_launches``), its ``covers`` stage at most three nodes.

On the CPU: CPU tensors take the plain version and never load the
library nor count a launch, and ``make_prepare``'s outputs are those it
gave before the stage moved into ``cover_bins_plain`` (digests of every
field on the orbit frame 30 and the 128² showcase).

The file imports no jax: on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cover_bins.py
"""

import hashlib
import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.renderer import Configuration, Renderer
from contrast_renderer_tpu_torch.utils.profiling import RECORD

COVER_FIELDS = ("hull_lines", "cls", "hbits")

#: The drift frames' scenes cut to a reduced size: config 3's dashed
#: strokes and config 2's fills (fewer of them), each one stencil command
#: and one cover draw under 4x MSAA, as the 1080p drift frames are.
DRIFT_SIZES = {"strokes": (384, 256), "fills": (320, 192)}


def drift_shape(name):
    width, height = DRIFT_SIZES[name]
    if name == "strokes":
        return port.Shape(*scenes.dashed_strokes(width, height, seed=1)), (1.0,) * 4
    return (port.Shape(scenes.bezier_fill_paths(150, width, height, seed=0)),
            (0.9, 0.4, 0.1, 1.0))


def drift_transform(i, width, height):
    """Frame i of a drifting 2D camera over pixel space: 0.005 rad a
    frame about the centre and 2 px a frame along x."""
    a = 0.005 * i
    c, s = np.cos(a), np.sin(a)
    cx, cy = width / 2.0, height / 2.0
    m = np.eye(4)
    m[:2, :2] = ((c, -s), (s, c))
    m[0, 3] = cx - c * cx + s * cy + 2.0 * i
    m[1, 3] = cy - s * cx - c * cy
    return (scenes.ortho(width, height) @ m).astype(np.float32)


def drift_commands(shape, color, transform):
    op = port.RenderOperation
    return [port.DrawCommand(op.STENCIL, shape, transform),
            port.DrawCommand(op.COLOR, shape, transform, color=color)]


DRIFT_CONFIG = dict(msaa_sample_count=4, winding_counter_bits=4)


def drift_scene(name):
    width, height = DRIFT_SIZES[name]
    shape, color = drift_shape(name)
    commands = drift_commands(shape, color, drift_transform(3, width, height))
    return commands, (width, height), DRIFT_CONFIG


def orbit_frame_30():
    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(
        shape, 96, 96, view_rotation=showcase.orbit_rotor(30))
    return commands, (96, 96), {}


def showcase_clip_alpha():
    commands = showcase.showcase_commands_clip_alpha(
        showcase.build_shape(with_text=False), 128, 128)
    return commands, (128, 128), dict(alpha_layer_count=1,
                                      blending="front_to_back")


def depth_and_paints():
    return scenes.mixed_paints(128, 128), (128, 128), dict(
        depth_compare="less_equal", depth_write_enabled=True)


def per_glyph():
    return scenes.config4_text("per_glyph"), (256, 256), {}


SCENES = {
    "strokes": lambda: drift_scene("strokes"),
    "fills": lambda: drift_scene("fills"),
    "orbit30": orbit_frame_30,
    "showcase128": showcase_clip_alpha,
    "depth_paints": depth_and_paints,
    "per_glyph": per_glyph,
}


def binning_inputs(name, device):
    """The spec of scene ``name`` walked in sequence and the arguments
    of its ``make_prepare`` closure, on ``device``."""
    commands, (width, height), config = SCENES[name]()
    r = Renderer(Configuration(**config), width, height,
                 auto_instance=False, device=device)
    opt, _ = port._optimize_commands(commands)
    shapes, index = r._unique_shapes(opt)
    _, scene = r._scene_arrays(shapes)
    inst = tuple(c.n_instances for c in opt)
    spec = r._spec(
        tuple(int(c.operation) for c in opt),
        tuple(r._cmd_shape_entry(c, index) for c in opt),
        inst if any(n != 1 for n in inst) else (),
        scene,
        tuple(port._spec_paint(c.color) for c in opt),
        commands=opt,
    )
    _, desc_i = r._pack_descriptors(shapes)
    paints = r._pack_paints(opt)
    args = (
        *scene.arrays,
        torch.as_tensor(r._pack_transforms(opt), device=device),
        torch.as_tensor(np.ascontiguousarray(desc_i[:, [9, 8]]), device=device),
        None if paints is None else torch.as_tensor(paints, device=device),
    )
    return spec, args


def digest(t):
    t = t.detach().cpu().contiguous()
    return hashlib.sha256(
        str((t.dtype, tuple(t.shape))).encode() + t.numpy().tobytes()
    ).hexdigest()[:16]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

#: Each PreparedFrame field's digest on the CPU, as make_prepare gave it
#: before its cover stage moved into cover_bins_plain (10 of orbit frame
#: 30's 46 hulls cross the near plane, and 18 lie wholly behind it).
CPU_DIGESTS = {
    ("orbit30", "float32"): {
        "tri_f": "946ec67995a58bb8", "tri_i": "74fff036f2df2d40", "off": "f5e499efbe380317",
        "g_tri_f": "0845c61096f72bde", "g_tri_i": "86630e05be6a3401", "g_off": "ce372ebe67d85b26",
        "bulk": "5b83976a0c7bf0b9", "cls": "47b9b00a28fe8143", "hbits": "e6fcdf8b10a51ed7",
        "aclist": "f5dc341f690e9693", "acount": "22247d173b4e66de", "hull_lines": "f1eda67640864cc7",
        "paint_xy": "a431bc4f887aed7c", "zplane": "2bddaeac356d4b58", "overflow": "2c2dc290420d05d6",
    },
    ("orbit30", "float64"): {
        "tri_f": "bb040f37848f44cf", "tri_i": "52bfa7d4c6209f09", "off": "f5e499efbe380317",
        "g_tri_f": "bd4ee229059df0c4", "g_tri_i": "86630e05be6a3401", "g_off": "ce372ebe67d85b26",
        "bulk": "5b83976a0c7bf0b9", "cls": "47b9b00a28fe8143", "hbits": "e6fcdf8b10a51ed7",
        "aclist": "f5dc341f690e9693", "acount": "22247d173b4e66de", "hull_lines": "4edfab1a886d1f12",
        "paint_xy": "a431bc4f887aed7c", "zplane": "2bddaeac356d4b58", "overflow": "2c2dc290420d05d6",
    },
    ("showcase128", "float32"): {
        "tri_f": "bc74524d2f2efdd5", "tri_i": "32f7248dc9a196f4", "off": "90ce70d0ab04e45b",
        "g_tri_f": "a28b72ce41f03cca", "g_tri_i": "e4c551155990a781", "g_off": "03a4aaa18e0d5f43",
        "bulk": "d0d95f5ec8d09371", "cls": "20b35eda4b04f882", "hbits": "e425dfb35f91291a",
        "aclist": "7e735fca22dd6d81", "acount": "e6aabdf6fe24dc64", "hull_lines": "fa48ac5c7068708c",
        "paint_xy": "cf9b0a9eebb9a514", "zplane": "227af6bf5a587eea", "overflow": "2841d457cdd0b58a",
    },
    ("showcase128", "float64"): {
        "tri_f": "ddfb7b7d199e437d", "tri_i": "32f7248dc9a196f4", "off": "90ce70d0ab04e45b",
        "g_tri_f": "7c7b9eaf2adb708f", "g_tri_i": "e4c551155990a781", "g_off": "03a4aaa18e0d5f43",
        "bulk": "d0d95f5ec8d09371", "cls": "20b35eda4b04f882", "hbits": "e425dfb35f91291a",
        "aclist": "7e735fca22dd6d81", "acount": "e6aabdf6fe24dc64", "hull_lines": "8ae4fd933abdb1ad",
        "paint_xy": "cf9b0a9eebb9a514", "zplane": "227af6bf5a587eea", "overflow": "2841d457cdd0b58a",
    },
}


@pytest.mark.parametrize("name,dtype", sorted(CPU_DIGESTS))
def test_cpu_binning_unchanged_by_the_move(name, dtype):
    """make_prepare on the CPU, and in float64 (prepare_in_float64), gives
    every output as it did with the cover stage inline (digests taken
    then)."""
    spec, args = binning_inputs(name, "cpu")
    prepare = coverage.make_prepare(spec)
    if dtype == "float64":
        prepare = coverage.prepare_in_float64(prepare)
    prepared = prepare(*args)
    got = {field: digest(t) for field, t in prepared._asdict().items()}
    assert got == CPU_DIGESTS[name, dtype]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors run cover_bins_plain: the library is never loaded (its
    loader raises) and no launch is counted, in make_prepare and called
    alone."""
    def refuse(*args, **kwargs):
        raise AssertionError("the cover kernel's library was loaded")

    monkeypatch.setattr(coverage, "_cover_bins_library", refuse)
    monkeypatch.setattr(coverage.cuda_build, "load_library", refuse)
    names = ("cover_bin_launches", "cover_bin_captures")
    counts = {k: RECORD.counters[k] for k in names}
    spec, args = binning_inputs("orbit30", "cpu")
    coverage.make_prepare(spec)(*args)
    spec, *inputs = random_covers(12, 10, "cpu")
    got = coverage.cover_bins(spec, *inputs)
    want = coverage.cover_bins_plain(spec, *inputs)
    for field, a, b in zip(COVER_FIELDS, got, want):
        assert torch.equal(a, b), field
    assert {k: RECORD.counters[k] for k in names} == counts
    if not torch.cuda.is_available():
        assert counts == dict.fromkeys(names, 0)


def test_cover_bins_refuses_other_devices():
    """A device other than the CPU or a CUDA card is refused."""
    spec, hull, transforms, c_shape, c_row = random_covers(3, 6, "cpu")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        coverage.cover_bins(spec, hull.to("meta"), transforms.to("meta"),
                            c_shape.to("meta"), c_row.to("meta"))


# ---------------------------------------------------------------------------
# Random covers, for the card
# ---------------------------------------------------------------------------


def random_covers(n_covers, h_max, device, strips=1, seed=0,
                  dtype=torch.float32, width=300, height=200):
    """A spec of ``n_covers`` cover draws and hulls of ``h_max`` vertices
    under random perspective transforms, some across the near plane; with
    a zero-area hull (one point), a collinear one and one wholly behind
    the plane among them."""
    rng = np.random.default_rng(seed)
    n_shapes = max(4, n_covers // 2)
    angles = np.sort(rng.uniform(0, 2 * np.pi, (n_shapes, h_max)), -1)
    radius = rng.uniform(0.05, 0.8, (n_shapes, 1))
    hull = np.stack([radius * np.cos(angles), radius * np.sin(angles)], -1)
    hull += rng.uniform(-0.5, 0.5, (n_shapes, 1, 2))
    hull[0] = hull[0, :1]                                  # one point
    hull[1] = np.linspace(0.0, 1.0, h_max)[:, None] * [[0.3, -0.2]]  # a line
    transforms = np.tile(np.eye(4), (n_covers + 1, 1, 1))
    transforms[:, :2, :2] += rng.uniform(-0.3, 0.3, (n_covers + 1, 2, 2))
    transforms[:, :2, 3] = rng.uniform(-0.5, 0.5, (n_covers + 1, 2))
    # Perspective: w = 1 + p·(x, y) crosses 1e-5 inside some hulls.
    transforms[:, 3, :2] = rng.uniform(-2.5, 2.5, (n_covers + 1, 2))
    transforms[:, 3, 3] = rng.uniform(0.2, 1.5, n_covers + 1)
    transforms[0, 3] = [0.0, 0.0, 0.0, -1.0]              # wholly behind
    c_shape = rng.integers(0, n_shapes, n_covers)
    c_shape[:3] = [0, 1, 2]
    c_row = rng.integers(0, n_covers + 1, n_covers)
    c_row[:3] = [1, 2, 0]
    spec = coverage.FrameSpec(
        width=width, height=height, ops=(coverage.OP_COLOR,) * n_covers,
        cmd_shape=tuple(int(s) for s in c_shape), n_shapes=n_shapes,
        t_max=1, h_max=h_max, samples=4, winding_bits=4, n_layers=0,
        blending="back_to_front", tile_strips=strips)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return (spec, put(hull, dtype), put(transforms, dtype),
            put(c_shape, torch.int64), put(c_row, torch.int64))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    coverage.build_kernels([coverage.KernelFeatures(4)])
    coverage._cover_bins_library()
    return torch.device("cuda")


def assert_cover_outputs_equal(got, want):
    for field, a, b in zip(COVER_FIELDS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.is_floating_point():
            # To the bit: NaN and the sign of zero included.
            bits = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(bits), b.view(bits)
        bad = (a != b).nonzero()
        assert bad.shape[0] == 0, (field, bad[:8].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_plain_in_binning(card, name, dtype, monkeypatch):
    """make_prepare on the card with the kernel, against the same closure
    with the plain version on the card: hull_lines, cls and hbits to the
    bit, and the unit lists that follow from cls; one launch counted."""
    spec, args = binning_inputs(name, card)
    if dtype == "float64":
        # prepare_in_float64's run, without its rounding of the outputs.
        args = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                     else a for a in args)
    prepare = coverage.make_prepare(spec)
    before = RECORD.counters["cover_bin_launches"]
    got = prepare(*args)
    assert RECORD.counters["cover_bin_launches"] == before + 1
    with monkeypatch.context() as patched:
        patched.setattr(coverage, "cover_bins", coverage.cover_bins_plain)
        want = prepare(*args)
    assert RECORD.counters["cover_bin_launches"] == before + 1
    assert_cover_outputs_equal(
        [got.hull_lines, got.cls, got.hbits],
        [want.hull_lines, want.cls, want.hbits])
    assert torch.equal(got.acount, want.acount)
    assert torch.equal(got.aclist, want.aclist)
    assert int((got.cls == 1).sum()) > 0  # boundary tiles were taken


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("strips", [1, 32, 128])
@pytest.mark.parametrize("n_covers,h_max", [(3, 29), (33, 16), (100, 29),
                                            (40, 1)])
def test_kernel_matches_plain_on_random_covers(card, n_covers, h_max,
                                               strips, dtype):
    """cover_bins alone against cover_bins_plain on the card: random hulls
    up to 31 lines (h_max 29), one line-pair hulls (h_max 1), zero-area
    and wholly clipped hulls, across cover chunks of the grid, at 1, 32
    and 128 strips a tile."""
    for seed in range(3):
        spec, *inputs = random_covers(n_covers, h_max, card, strips=strips,
                                      seed=seed, dtype=dtype)
        got = coverage.cover_bins(spec, *inputs)
        want = coverage.cover_bins_plain(spec, *inputs)
        assert_cover_outputs_equal(got, want)
        # Cover 2, wholly behind the plane, is outside every tile.
        assert int(got[1][:, 2].abs().sum()) == 0


@pytest.mark.cuda
def test_kernel_refuses_more_than_31_lines(card):
    """Hull bits past one int32 word are refused before any launch, as the
    plain version refuses them."""
    spec, *inputs = random_covers(4, 30, card)
    with pytest.raises(ValueError, match="single i32 word"):
        coverage.cover_bins(spec, *inputs)


@pytest.mark.cuda
def test_captured_step_replays_the_kernel(card):
    """Renderer.render under a drifting camera on the dashed strokes:
    the binning step's first miss warms up, its second captures; each
    replay launches the kernel once (cover_bin_launches), its covers
    stage is at most three nodes, and its outputs equal an eager
    binning's."""
    width, height = DRIFT_SIZES["strokes"]
    shape, color = drift_shape("strokes")
    r, eager = (Renderer(Configuration(**DRIFT_CONFIG), width, height,
                         auto_instance=False, device=card) for _ in range(2))
    stacks = [drift_transform(i, width, height) for i in range(6)]

    def at(transform):
        return drift_commands(shape, color, transform)

    for renderer in (r, eager):
        # Grow the capacities over every stack first, so that no frame
        # below grows them and drops the step.
        renderer.strict_capacity = True
        for stack in stacks:
            renderer._prepare(at(stack), graph=False)
        renderer.strict_capacity = False
        renderer._prepared_cache.clear()
    for stack in stacks[:2]:  # the warm-up, then the capture
        r.render(at(stack), to_host=False)
    (step,) = r._bin_steps.values()
    assert step.graph is not None
    assert step.replay_launches["cover_bin_launches"] == 1
    assert 1 <= step.stage_nodes["covers"] <= 3, step.stage_nodes
    for stack in stacks[2:]:
        before = RECORD.counters["cover_bin_launches"]
        r.render(at(stack), to_host=False)
        assert RECORD.counters["cover_bin_launches"] == before + 1
        eager._prepared_cache.clear()
        _, _, runtime = eager._prepare(at(stack), graph=False)
        assert_cover_outputs_equal(
            [step.prepared.hull_lines, step.prepared.cls, step.prepared.hbits],
            [runtime[0].hull_lines, runtime[0].cls, runtime[0].hbits])
