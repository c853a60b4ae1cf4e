"""The CUDA raster kernel on the card: its frame held against its plain
torch version's de-tiled tiles across sample counts, strip layouts,
output modes, blend states and frame sizes that are not multiples of
the tile (and written into a caller's tensor); each of the six stroke
classes; clip and alpha frames with alpha layers in registers, in
shared memory and in the global scratch of resident blocks; the clip
vote on content partly outside its clips; gated against ungated clip
and alpha frames; depth under each compare function, with and without
write; linear, radial, multi-stop and degenerate gradients; a user
paint compiled into the kernel; the cap golden; the whole path on the
card against the path on the CPU; ``render_sequence`` writing its
frames in place; the stencil walk on stroke-heavy and fill-heavy frames
at S = 1, 4, 8 and 16 with and without a clip, and a command's strokes
before its fills; ``FrameProgram``'s captured frame step (its replays
against the eager binning and raster, without a synchronise, across a
capacity growth and with two alpha layers), its compile hysteresis over
an unplanned motion and its scout through a binning step; the
near-plane repro (kernel against plain, against pair 15 alone and the
float64-binned frame); captures after evictions that renew a graph pool
(``Renderer``'s binning steps, ``plan_for_motion``);
``Renderer.render``'s
binning step under a moving camera (replayed misses against the eager
binning and raster, float and packed, cached binnings and returned
frames that alias none of its buffers, no synchronise without
``strict_capacity``, one read with it, a growth, two alpha layers,
depth and paints); the
sharded programs' per-rect steps against their eager frames; the
standalone fill rasterizer, band sharding and the frame loop on the card
against the CPU, the single render and ``compile_frame``; and the frame
record's device marks (rising within each replayed frame, five stages
that sum to CUDA events around an eager binning, graph nodes that repeat
across captures of one variant).

Needs a CUDA device and the CUDA toolkit; skips without them.  The
file imports no jax, so on a machine without jax run it without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from dataclasses import replace
from pathlib import Path as FsPath

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.path import Path
from contrast_renderer_tpu_torch.utils.profiling import RECORD
from contrast_renderer_tpu_torch.renderer import (
    BlendComponent,
    BlendState,
    Configuration,
    DrawCommand,
    LinearGradient,
    RadialGradient,
    RenderOperation,
    Renderer,
    Shape,
    UserPaint,
)

pytestmark = pytest.mark.cuda
# The scene keeps to the left 256 columns, so the right tiles are empty.
SIZE = 256
WIDTH, HEIGHT = 384, 256
GOLDEN = FsPath(__file__).parent / "golden" / "cap_styles_96x72.npy"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The kernel builds this file launches, all at once.
    KF = coverage.KernelFeatures
    coverage.build_kernels(
        [KF(s) for s in (1, 2, 4, 8, 16)]
        + [KF(s, depth=True) for s in (1, 4, 16)]
        + [KF(s, paint_mode=1) for s in (1, 4)]
        + [KF(4, True, 2, (scenes.CHECKER_CUDA,))]
    )
    return torch.device("cuda")


def frame_commands():
    """Bézier fills, an instanced circle with per-instance colors, and a
    command at a nonzero clip depth (a no-op without clip commands)."""
    fills = Shape(scenes.bezier_fill_paths(
        120, SIZE, SIZE, seed=3, margin=10.0, radius=(4.0, 24.0)
    ))
    circle = Shape([Path.from_circle((0, 0), 30)])
    t = scenes.ortho(WIDTH, HEIGHT)
    moves = np.stack([t.copy() for _ in range(3)])
    for i, (x, y) in enumerate([(60, 60), (150, 90), (100, 200)]):
        moves[i, 0, 3] += 2.0 * x / WIDTH
        moves[i, 1, 3] += 2.0 * y / HEIGHT
    colors = np.array(
        [[0.1, 0.6, 0.8, 0.6], [0.8, 0.2, 0.3, 0.9], [0.3, 0.9, 0.2, 0.4]],
        np.float32,
    )
    return [
        DrawCommand(RenderOperation.STENCIL, fills, t),
        DrawCommand(RenderOperation.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)),
        DrawCommand(RenderOperation.STENCIL, circle, moves),
        DrawCommand(RenderOperation.COLOR, circle, moves, color=colors),
        DrawCommand(RenderOperation.STENCIL, fills, t, clip_depth=1),
    ]


CONSTANT_BLEND = BlendState(
    BlendComponent("constant", "add", "one_minus_src_alpha"),
    BlendComponent("src_alpha_saturated", "reverse_subtract", "one"),
)


@pytest.mark.parametrize("samples", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("strips", [1, 2])
@pytest.mark.parametrize(
    "blending", ["back_to_front", "front_to_back", "additive", CONSTANT_BLEND],
    ids=["over", "front_to_back", "additive", "constant"],
)
def test_kernel_matches_plain(card, samples, strips, blending):
    """Float output bit for bit (both round every step in the same
    order); packed RGBA8 identical."""
    renderer = Renderer(
        Configuration(msaa_sample_count=samples, blending=blending),
        WIDTH, HEIGHT, tile_strips=strips, device=card,
    )
    renderer.set_blend_constant((0.25, 0.5, 0.75, 0.5))
    spec, _, runtime = renderer._prepare(frame_commands())
    assert_kernel_matches_plain(spec, *runtime)
    assert int((runtime[0].acount == 0).sum()) > 0  # empty tiles were taken


def assert_kernel_matches_plain(spec, prepared, cmd_i, cmd_f, desc_f, desc_i):
    """The kernel's frame and rasterize_plain's tiles de-tiled
    (coverage.detile) on the same tensors, float and packed RGBA8: equal
    to the bit, and the frame is not empty."""
    draws = coverage.draw_tables(spec)
    units = (
        torch.as_tensor(draws.unit_cmd, device=prepared.tri_f.device),
        torch.as_tensor(draws.unit_draw, device=prepared.tri_f.device),
    )
    for u8 in (False, True):
        args = (replace(spec, out_uint8=u8), prepared, cmd_i, cmd_f, *units,
                desc_f, desc_i)
        before = RECORD.counters["raster_launches"]
        got = coverage.coverage_raster(*args)
        want = coverage.detile(args[0], coverage.rasterize_plain(*args))
        torch.cuda.synchronize()
        assert RECORD.counters["raster_launches"] == before + 1
        assert torch.equal(got, want), u8
        assert bool((want != 0).any())


@pytest.mark.parametrize("samples", [1, 4, 16])
@pytest.mark.parametrize("strips", [1, 2])
def test_frame_layout_matches_plain(card, samples, strips):
    """A frame whose width and height are not multiples of the tile's
    footprint: the kernel writes each pixel at its place in the (H, W)
    frame and skips the padding, float and packed RGBA8, bit for bit
    against the de-tiled plain version; into a caller's ``out`` as into
    its own tensor, and nothing past the frame is touched."""
    width, height = 300, 200
    fills = Shape(scenes.bezier_fill_paths(
        80, width, height, seed=5, margin=4.0, radius=(4.0, 30.0)
    ))
    t = scenes.ortho(width, height)
    renderer = Renderer(
        Configuration(msaa_sample_count=samples), width, height,
        tile_strips=strips, device=card,
    )
    spec, _, runtime = renderer._prepare([
        DrawCommand(RenderOperation.STENCIL, fills, t),
        DrawCommand(RenderOperation.COLOR, fills, t, color=(0.3, 0.6, 0.9, 0.8)),
    ])
    assert spec.ntx * spec.screen_tile_w > width
    assert spec.nty * spec.screen_tile_h > height
    assert_kernel_matches_plain(spec, *runtime)
    draws = coverage.draw_tables(spec)
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    units = (torch.as_tensor(draws.unit_cmd, device=card),
             torch.as_tensor(draws.unit_draw, device=card))
    for u8 in (False, True):
        sp = replace(spec, out_uint8=u8)
        args = (sp, prepared, cmd_i, cmd_f, *units, desc_f, desc_i)
        want = coverage.coverage_raster(*args)
        # A guard row past the frame stays as it was.
        buf = torch.full((height + 1,) + tuple(want.shape[1:]), 7,
                         dtype=want.dtype, device=card)
        got = coverage.coverage_raster(*args, out=buf[:height])
        torch.cuda.synchronize()
        assert got.data_ptr() == buf.data_ptr()
        assert torch.equal(got, want) and bool((buf[height] == 7).all())


def only_class(prepared, command, code):
    """``prepared`` with every local and global entry range emptied but
    class ``code`` of stencil command ``command``, and no bulk winding."""
    b = coverage.N_CLASSES * command + code

    def keep(ranges):
        return torch.clamp(ranges, ranges[..., b:b + 1], ranges[..., b + 1:b + 2])

    return prepared._replace(
        off=keep(prepared.off).contiguous(),
        g_off=keep(prepared.g_off).contiguous(),
        bulk=torch.zeros_like(prepared.bulk),
    )


@pytest.mark.parametrize("samples", [1, 4, 16])
@pytest.mark.parametrize(
    "code", [code for code, _, _ in coverage.STROKE_CLASSES],
    ids=["line", "line_dash1", "line_dashn", "joint", "joint_dash1",
         "joint_dashn"],
)
def test_stroke_class_matches_plain(card, samples, code):
    """Each stroke class alone (the other classes' ranges emptied), on
    scenes.stroke_sampler at 256², bit for bit."""
    size = 256
    shape = Shape(*scenes.stroke_sampler(size))
    t = scenes.ortho(size, size)
    renderer = Renderer(
        Configuration(msaa_sample_count=samples), size, size, device=card
    )
    spec, _, runtime = renderer._prepare([
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(0.9, 0.8, 0.2, 0.9)),
    ])
    prepared = only_class(runtime[0], 0, code)
    entries = sum(
        int((r[..., code + 1] - r[..., code]).sum())
        for r in (prepared.off, prepared.g_off)
    )
    assert entries > 0
    assert_kernel_matches_plain(spec, prepared, *runtime[1:])


@pytest.mark.parametrize(
    "build, layers, samples",
    [
        (scenes.nested_clip_commands, 1, 4),
        (scenes.nested_clip_commands, 2, 4),
        (scenes.nested_clip_commands, 5, 4),
        (scenes.nested_clip_commands, 1, 16),
        (scenes.nested_group_commands, 2, 4),
        (scenes.nested_group_commands, 5, 4),
        (scenes.nested_group_commands, 2, 16),
    ],
    ids=["clip-L1", "clip-L2", "clip-L5", "clip-L1-msaa16", "groups-L2",
         "groups-L5", "groups-L2-msaa16"],
)
def test_clip_alpha_matches_plain(card, build, layers, samples):
    """Clip and alpha frames at 256²: the layer in registers (L = 1) and
    layers in shared memory (L = 2, 5), bit for bit."""
    size = 256
    renderer = Renderer(
        Configuration(alpha_layer_count=layers, blending="front_to_back",
                      msaa_sample_count=samples),
        size, size, device=card,
    )
    spec, _, runtime = renderer._prepare(build(port, size))
    assert coverage.layer_mode(spec) == (1 if layers == 1 else 0)
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize(
    "layers, samples",
    [(2, 1), (2, 4), (2, 16), (5, 1), (5, 4), (5, 16), (16, 16)],
)
def test_layer_slots_match_plain(card, layers, samples):
    """scenes.nested_clip_commands at 256² with L alpha layers: their
    slots in the block's shared memory (L*S of 256 floats per thread fit
    in what a block may opt into), or, at S = 16 and L = 16, in a global
    scratch of one slice per block that can be resident at once, which
    does not grow with the frame; bit for bit."""
    size = 256
    renderer = Renderer(
        Configuration(alpha_layer_count=layers, blending="front_to_back",
                      msaa_sample_count=samples),
        size, size, device=card,
    )
    spec, _, runtime = renderer._prepare(scenes.nested_clip_commands(port, size))
    assert coverage.layer_mode(spec) == 0
    blocks = coverage.layer_scratch_blocks(spec, card)
    if layers * samples <= 213:  # what fits beside the static staging
        assert blocks == 0
    else:
        props = torch.cuda.get_device_properties(card)
        assert 0 < blocks <= props.multi_processor_count * 8
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize("strips", [1, 2])
@pytest.mark.parametrize("layers", [1, 2])
def test_clip_vote_matches_plain(card, strips, layers):
    """scenes.rect_clips: content partly outside two nested rectangular
    clips, so that the clip vote skips some (warp, unit) pairs and must
    keep others; bit for bit, and the plain version counts both."""
    renderer = Renderer(
        Configuration(alpha_layer_count=layers, blending="front_to_back"),
        128, 128, tile_strips=strips, device=card,
    )
    spec, _, runtime = renderer._prepare(scenes.rect_clips(128))
    assert_kernel_matches_plain(spec, *runtime)
    draws = coverage.draw_tables(spec)
    units = (torch.as_tensor(draws.unit_cmd, device=card),
             torch.as_tensor(draws.unit_draw, device=card))
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    work = {}
    image = coverage.rasterize_plain(
        spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i, work=work
    )
    assert work["clip_skipped"] > 0
    # Content shows inside the inner clip (the vote kept those warps).
    x0, y0, x1, y1 = (int(v) for v in scenes.RECT_CLIPS[1])
    alpha = renderer.render(scenes.rect_clips(128))[..., 3]
    assert alpha[y0 + 1:y1, x0 + 1:x1].max() > 0.0
    assert bool((image != 0).any())


@pytest.mark.parametrize("frame", ["bracket", "shifted_unclip", "rect_clips"])
def test_gated_matches_ungated_on_card(card, frame, monkeypatch):
    """Renderer.render on the card with the bracket gating and with
    _gate_spans returning (): packed RGBA8 identical.  The bracket frame
    empties the tiles its content misses; with the UNCLIP moved, the row
    check keeps them at run time; rect_clips has content in every tile."""
    size = 256
    config = Configuration(alpha_layer_count=1, blending="front_to_back")
    if frame == "rect_clips":
        commands = scenes.rect_clips(size)
    else:
        shifted = np.eye(4, dtype=np.float32)
        shifted[0, 3] = 0.25
        commands = scenes.bracket_commands(
            port, unclip_transform=shifted if frame == "shifted_unclip" else None
        )
    renderer = Renderer(config, size, size, device=card)
    spec, _, runtime = renderer._prepare(commands)
    assert spec.gate_spans
    gated = renderer.render(commands, as_uint8=True)
    monkeypatch.setattr(port, "_gate_spans", lambda commands, spec: ())
    plain = Renderer(config, size, size, device=card)
    ungated_spec, _, ungated_runtime = plain._prepare(commands)
    assert not ungated_spec.gate_spans
    ungated = plain.render(commands, as_uint8=True)
    assert np.array_equal(gated, ungated)
    assert gated[..., 3].any()
    dropped = int(ungated_runtime[0].acount.sum()) - int(runtime[0].acount.sum())
    assert (dropped > 0) == (frame == "bracket")


@pytest.mark.parametrize("samples", [1, 4, 16])
@pytest.mark.parametrize("strips", [1, 2, 4, 8, 32, 128])
def test_warp_boundaries_match_plain(card, samples, strips):
    """scenes.warp_boundaries: entries whose boxes end exactly on warp
    footprints and tile boundaries, vertices on sample positions and
    slivers, under every strip layout (at 8 strips a warp's 32 lanes
    span two strips; at 32 and 128 a warp's 8 lanes span 2 and 8
    strips), bit for bit."""
    renderer = Renderer(
        Configuration(msaa_sample_count=samples), *scenes.BOUNDARY_SIZE,
        tile_strips=strips, device=card,
    )
    spec, _, runtime = renderer._prepare(scenes.warp_boundaries())
    assert spec.tile_strips == strips
    assert_kernel_matches_plain(spec, *runtime)


def stencil_commands(kind, clip, size=SIZE):
    """A stroke-heavy frame (scenes.thin_strokes, and config 3's dashed
    polylines through a window) or a fill-heavy one (Bézier fills, and a
    command whose shape has stroke and fill rows over the same samples),
    inside a rectangular clip where ``clip``."""
    op = RenderOperation
    t = scenes.ortho(size, size)
    if kind == "strokes":
        dashed = Shape(*scenes.dashed_strokes(1920, 1080, seed=1))
        moved = t.copy()
        moved[0, 3] -= 2.0 * 800.0 / size
        moved[1, 3] -= 2.0 * 450.0 / size
        shapes = [(Shape(*scenes.thin_strokes(size)), t), (dashed, moved)]
    else:
        fills = Shape(scenes.bezier_fill_paths(
            150, size, size, seed=5, margin=8.0, radius=(3.0, 30.0)))
        mixed = scenes.stroke_over_fill(size)[0]
        shapes = [(fills, t), (mixed.shapes[0], mixed.transform)]
    depth = 1 if clip else 0
    body = []
    for shape, transform in shapes:
        body += [
            DrawCommand(op.STENCIL, shape, transform, clip_depth=depth),
            DrawCommand(op.COLOR, shape, transform, clip_depth=depth,
                        color=(0.9, 0.5, 0.2, 0.8)),
        ]
    if not clip:
        return body
    box = Shape([Path.from_rect((size * 0.45, size * 0.55), (size * 0.35, size * 0.3))])
    return ([DrawCommand(op.STENCIL, box, t), DrawCommand(op.CLIP, box, t, clip_depth=1)]
            + body + [DrawCommand(op.UNCLIP, box, t, clip_depth=0)])


@pytest.mark.parametrize("samples", [1, 4, 8, 16])
@pytest.mark.parametrize("kind", ["strokes", "fills"])
@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
def test_stencil_walk_matches_plain(card, samples, kind, clip):
    """The stencil walk (one staged walk per command, compacted per
    block, per-warp hit lists, the stroke edge reject, fill rows read
    through shuffles) on stroke-heavy and fill-heavy frames, with and
    without a clip, bit for bit."""
    renderer = Renderer(Configuration(msaa_sample_count=samples), SIZE, SIZE,
                        device=card)
    spec, _, runtime = renderer._prepare(stencil_commands(kind, clip))
    assert spec.has_strokes
    assert coverage.clip_alpha_ops(spec)[0] == clip
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("kind", ["strokes", "fills"])
@pytest.mark.parametrize("strips", [32, 128])
def test_stencil_walk_in_narrow_strips_matches_plain(card, samples, kind, strips):
    """The stencil walk where a strip is narrower than a warp's 8 lanes
    (4 and 1 pixels): each warp's rectangle and edge-reject footprint
    span several strips.  Stroke-heavy and fill-heavy frames inside a
    clip, bit for bit."""
    renderer = Renderer(Configuration(msaa_sample_count=samples), SIZE, SIZE,
                        tile_strips=strips, device=card)
    spec, _, runtime = renderer._prepare(stencil_commands(kind, True))
    assert spec.tile_strips == strips and spec.screen_tile_w < 8
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize("bits", [1, 4])
def test_strokes_before_fills_on_card(card, bits):
    """scenes.stroke_over_fill under a one-bit and a four-bit winding
    counter: the kernel runs a command's stroke rows before its fill
    rows, as the plain version does, bit for bit."""
    renderer = Renderer(Configuration(winding_counter_bits=bits), 64, 64,
                        device=card)
    spec, _, runtime = renderer._prepare(scenes.stroke_over_fill(64))
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize("strips", [1, 2])
def test_one_lane_stroke_matches_plain(card, strips):
    """Eight stroke dots 0.25 px long and 0.2 px wide, 8 px apart on
    pixel row 10, each around the sample at offset (0.375, 0.125) of
    pixel column 8k: at 4x MSAA each warp (4 rows x 8 lanes) that a dot
    reaches has one inside sample, in one lane, so the warp vote keeps
    one sample's predicates for that lane alone.  Bit for bit, and only
    those eight samples are covered."""
    size = 64
    g = port_path
    dots = []
    for k in range(8):
        dot = g.Path(start=(8.0 * k + 0.25, size - 10.125))
        dot.push_line(g.LineSegment([(8.0 * k + 0.5, size - 10.125)]))
        dot.stroke_options = g.StrokeOptions(
            width=0.2, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=0,
        )
        dots.append(dot)
    shape = Shape(
        dots, [g.DynamicStrokeOptions.make_solid(g.Join.BEVEL, g.Cap.BUTT, g.Cap.BUTT)]
    )
    t = scenes.ortho(size, size)
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1.0, 1.0, 1.0, 1.0)),
    ]
    renderer = Renderer(
        Configuration(), size, size, tile_strips=strips, device=card
    )
    spec, _, runtime = renderer._prepare(commands)
    assert_kernel_matches_plain(spec, *runtime)
    alpha = renderer.render(commands)[..., 3]
    rows, cols = np.nonzero(alpha)
    assert rows.tolist() == [10] * 8 and cols.tolist() == list(range(0, 64, 8))
    assert np.all(alpha[rows, cols] == 0.25)


def test_cap_sheet_on_card_matches_golden(card):
    """All seven cap styles through Renderer.render on the card, against
    the reference's golden, bit for bit."""
    w, h = scenes.CAP_SHEET_SIZE
    shape = Shape(*scenes.cap_sheet())
    t = scenes.ortho(w, h)
    image = Renderer(Configuration(), w, h, device=card).render([
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(1.0, 1.0, 1.0, 1.0)),
    ])
    assert np.array_equal(image[..., 3], np.load(GOLDEN))


@pytest.mark.parametrize("frame", ["fills", "strokes", "clip_alpha", "paints"])
def test_slice_on_card_matches_slice_on_cpu(card, frame):
    """Renderer.render on the card (torch binning on the card, CUDA
    kernel) against Renderer.render on the CPU (torch binning, plain
    rasterizer): packed RGBA8 identical."""
    config = Configuration()
    if frame == "fills":
        commands = frame_commands()
    elif frame == "strokes":
        shape = Shape(*scenes.stroke_sampler(SIZE))
        t = scenes.ortho(WIDTH, HEIGHT)
        commands = [
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(RenderOperation.COLOR, shape, t),
        ]
    elif frame == "clip_alpha":
        config = Configuration(alpha_layer_count=1, blending="front_to_back")
        commands = scenes.nested_clip_commands(port, SIZE)
    else:
        config = Configuration(depth_compare="less_equal",
                               depth_write_enabled=True)
        commands = scenes.mixed_paints(WIDTH, HEIGHT)
    want = Renderer(config, WIDTH, HEIGHT, device="cpu").render(
        commands, as_uint8=True
    )
    got = Renderer(config, WIDTH, HEIGHT, device=card).render(
        commands, as_uint8=True
    )
    assert np.array_equal(got, want)
    assert want[..., 3].any()


def test_bad_arguments_raise(card):
    renderer = Renderer(Configuration(), WIDTH, HEIGHT, device=card)
    spec, _, runtime = renderer._prepare(frame_commands())
    prepared, cmd_i, cmd_f, desc_f, desc_i = runtime
    draws = coverage.draw_tables(spec)
    units = (
        torch.as_tensor(draws.unit_cmd, device=card),
        torch.as_tensor(draws.unit_draw, device=card),
    )
    with pytest.raises(ValueError, match="cmd_f"):
        coverage.coverage_raster(
            spec, prepared, cmd_i, cmd_f[:, :4], *units, desc_f, desc_i
        )
    with pytest.raises(ValueError, match="cmd_i is on cpu"):
        coverage.coverage_raster(
            spec, prepared, cmd_i.cpu(), cmd_f, *units, desc_f, desc_i
        )
    with pytest.raises(ValueError, match="desc_i"):
        coverage.coverage_raster(
            spec, prepared, cmd_i, cmd_f, *units, desc_f, desc_i[:, :8]
        )


def ortho_z(z, size):
    """scenes.ortho with the model plane at NDC depth ``z``."""
    t = scenes.ortho(size, size)
    t[2, 3] = z
    return t


def depth_commands(size=SIZE):
    """Overlapping circles at four depths, drawn at the far plane (z = 1,
    which passes greater_equal against the cleared buffer), far, near
    and middle, then two showcase instances under its perspective
    camera."""
    s = size / 64.0
    commands = []
    for x, z, color in ((46.0, 1.0, (1.0, 1.0, 0.0, 0.7)),
                        (40.0, 0.7, (0.0, 1.0, 0.0, 1.0)),
                        (28.0, 0.3, (1.0, 0.0, 0.0, 0.8)),
                        (34.0, 0.5, (0.0, 0.0, 1.0, 0.6))):
        shape = Shape([Path.from_circle((x * s, 32.0 * s), 14.0 * s)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, shape, ortho_z(z, size)),
            DrawCommand(RenderOperation.COLOR, shape, ortho_z(z, size),
                        color=color),
        ]
    solid = Shape([Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)])
    transforms, _ = showcase.instance_transforms_and_colors(size, size)
    for i, color in ((0, (1.0, 1.0, 1.0, 0.9)), (23, (1.0, 0.5, 0.0, 1.0))):
        t = np.ascontiguousarray(transforms[i], np.float32)
        commands += [
            DrawCommand(RenderOperation.STENCIL, solid, t),
            DrawCommand(RenderOperation.COLOR, solid, t, color=color),
        ]
    return commands


@pytest.mark.parametrize("write", [True, False], ids=["write", "no_write"])
@pytest.mark.parametrize("compare", sorted(coverage.DEPTH_COMPARE_CODES))
def test_depth_compare_matches_plain(card, compare, write):
    """Each of the eight compare functions, with depth write on and off,
    at 4x MSAA, bit for bit."""
    renderer = Renderer(
        Configuration(depth_compare=compare, depth_write_enabled=write),
        SIZE, SIZE, device=card,
    )
    spec, _, runtime = renderer._prepare(depth_commands())
    assert coverage.kernel_features(spec).depth == (compare != "always" or write)
    if compare in ("never", "greater"):
        # Nothing passes (no fragment lies beyond the buffer's clear value,
        # the far plane): the frame is empty, in both versions.
        draws = coverage.draw_tables(spec)
        units = (torch.as_tensor(draws.unit_cmd, device=card),
                 torch.as_tensor(draws.unit_draw, device=card))
        args = (spec, *runtime[:3], *units, *runtime[3:])
        got = coverage.coverage_raster(*args)
        assert torch.equal(got, coverage.detile(spec, coverage.rasterize_plain(*args)))
        assert not bool((got != 0).any())
        return
    assert_kernel_matches_plain(spec, *runtime)


@pytest.mark.parametrize("samples", [1, 4, 16])
@pytest.mark.parametrize(
    "compare, write",
    [("less_equal", True), ("less", False), ("greater_equal", True),
     ("not_equal", True)],
    ids=["less_equal-write", "less", "greater_equal-write", "not_equal-write"],
)
def test_depth_matches_plain(card, samples, compare, write):
    """The depth body at three sample counts and four compare functions,
    bit for bit."""
    renderer = Renderer(
        Configuration(msaa_sample_count=samples, depth_compare=compare,
                      depth_write_enabled=write),
        SIZE, SIZE, device=card,
    )
    spec, _, runtime = renderer._prepare(depth_commands())
    assert coverage.kernel_features(spec).depth
    assert bool((runtime[0].zplane != 0).any())
    assert_kernel_matches_plain(spec, *runtime)


GRADIENTS = {
    "linear": LinearGradient(start=(40.0, 60.0), end=(200.0, 180.0),
                             color0=(1.0, 0.2, 0.0, 1.0),
                             color1=(0.0, 0.3, 1.0, 0.4)),
    "linear4-hard": LinearGradient(
        start=(30.0, 128.0), end=(220.0, 128.0),
        stops=((0.0, (1.0, 0.0, 0.0, 1.0)), (0.4, (1.0, 1.0, 0.0, 1.0)),
               (0.4, (0.0, 0.0, 1.0, 0.7)), (1.0, (0.0, 1.0, 0.5, 0.2))),
    ),
    "radial": RadialGradient(center=(128.0, 128.0), edge=(228.0, 128.0),
                             color0=(1.0, 0.85, 0.3, 0.9),
                             color1=(1.0, 0.85, 0.3, 0.0)),
    # Start on end: the axis's squared length is floored at 1e-12.
    "linear-degenerate": LinearGradient(start=(128.0, 128.0), end=(128.0, 128.0),
                                        color0=(1.0, 0.0, 0.0, 1.0),
                                        color1=(0.0, 0.0, 1.0, 1.0)),
    "radial-degenerate": RadialGradient(center=(100.0, 90.0), edge=(100.0, 90.0),
                                        color0=(0.0, 1.0, 0.0, 0.6),
                                        color1=(1.0, 0.0, 1.0, 0.9)),
}


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("kind", sorted(GRADIENTS))
def test_gradient_matches_plain(card, samples, kind):
    """Gradient covers over Bézier fills and a solid circle (solid and
    gradient covers in one frame), bit for bit."""
    fills = Shape(scenes.bezier_fill_paths(
        60, SIZE, SIZE, seed=4, margin=10.0, radius=(8.0, 30.0)
    ))
    disc = Shape([Path.from_circle((128.0, 128.0), 100.0)])
    t = scenes.ortho(SIZE, SIZE)
    renderer = Renderer(Configuration(msaa_sample_count=samples), SIZE, SIZE,
                        device=card)
    spec, _, runtime = renderer._prepare([
        DrawCommand(RenderOperation.STENCIL, disc, t),
        DrawCommand(RenderOperation.COLOR, disc, t, color=GRADIENTS[kind]),
        DrawCommand(RenderOperation.STENCIL, fills, t),
        DrawCommand(RenderOperation.COLOR, fills, t, color=(0.1, 0.1, 0.1, 0.5)),
    ])
    assert coverage.kernel_features(spec).paint_mode == 1
    assert_kernel_matches_plain(spec, *runtime)


def test_user_paint_matches_plain(card):
    """The mixed frame (gradient, instanced solid pair, checker UserPaint
    compiled into the kernel) under less_equal with depth write, bit for
    bit, and through Renderer.render with one launch."""
    config = Configuration(depth_compare="less_equal", depth_write_enabled=True)
    renderer = Renderer(config, SIZE, SIZE, device=card)
    commands = scenes.mixed_paints(SIZE, SIZE)
    spec, _, runtime = renderer._prepare(commands)
    assert coverage.kernel_features(spec).user_sources == (scenes.CHECKER_CUDA,)
    assert_kernel_matches_plain(spec, *runtime)
    before = RECORD.counters["raster_launches"]
    image = renderer.render(commands, as_uint8=True)
    assert RECORD.counters["raster_launches"] == before + 1
    for rgb in ((204, 0, 204), (0, 204, 0)):  # the checker's two colours
        assert (image[..., :3] == rgb).all(-1).any(), rgb


def test_user_paint_without_cuda_raises_on_card(card):
    """A UserPaint with only its torch function has no kernel: the card
    refuses it before anything runs, and never falls back."""
    paint = UserPaint(scenes.checker)
    commands = scenes.mixed_paints(SIZE, SIZE, user_paint=paint)
    renderer = Renderer(Configuration(), SIZE, SIZE, device=card)
    before = RECORD.counters["raster_launches"]
    with pytest.raises(ValueError, match="cuda"):
        renderer.render(commands)
    assert RECORD.counters["raster_launches"] == before
    assert not renderer._prepared_cache


def small_text_transform():
    """A short text at config 4's size, scaled into a 256² frame (the
    layout is centred on the origin)."""
    return np.diag([2.0 / 120.0, 2.0 / 120.0, 1.0, 1.0]).astype(np.float32)


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("form", ["fused", "per_glyph"])
def test_text_forms_match_plain(card, samples, form):
    """Config 4's multi-shape and per-glyph forms on a short text: the
    kernel against the plain version, and the image against the
    monolith's."""
    text = "the quick brown fox\njumps over the lazy dog\n0123456789 fffi"
    config = Configuration(msaa_sample_count=samples)
    commands = scenes.config4_text(form, text=text, transform=small_text_transform())
    renderer = Renderer(config, SIZE, SIZE, device=card)
    spec, _, runtime = renderer._prepare(commands)
    assert_kernel_matches_plain(spec, *runtime)
    monolith = scenes.config4_text("monolith", text=text,
                                   transform=small_text_transform())
    want = Renderer(config, SIZE, SIZE, device=card).render(monolith, as_uint8=True)
    assert np.array_equal(renderer.render(commands, as_uint8=True), want)


def test_fused_showcase_matches_sequential_walk_on_card(card):
    """The showcase at 256² on the default path (auto-instanced into four
    commands) against the same commands walked in sequence: the kernel
    against plain on the fused frame, and the two images equal."""
    commands = showcase.showcase_commands(
        showcase.build_shape(with_text=True), SIZE, SIZE
    )
    fused = Renderer(Configuration(), SIZE, SIZE, device=card)
    spec, _, runtime = fused._prepare(commands)
    assert spec.n_commands == 4 and max(spec.cmd_inst) > 1
    assert_kernel_matches_plain(spec, *runtime)
    walked = Renderer(Configuration(), SIZE, SIZE, auto_instance=False, device=card)
    assert np.array_equal(
        fused.render(commands, as_uint8=True), walked.render(commands, as_uint8=True)
    )


def test_carry_on_card(card):
    """render(carry=...) on the card: the image equals a render without
    carry, the sum stays on the device and chains, from a 0-d tensor and
    from a float, float and packed RGBA8."""
    commands = frame_commands()
    renderer = Renderer(Configuration(), WIDTH, HEIGHT, device=card)
    image = renderer.render(commands, to_host=False)
    acc = torch.zeros((), device=card)
    for _ in range(3):
        out, acc = renderer.render(commands, carry=acc)
    assert acc.device.type == "cuda" and acc.dtype == torch.float32
    assert torch.equal(out, image)
    alpha = float(image[..., 3].double().sum())
    assert np.isclose(float(acc), 3 * alpha, rtol=1e-5)
    packed, acc8 = renderer.render(commands, carry=0.5, uint8_kernel=True)
    assert packed.dtype == torch.uint8 and acc8.device.type == "cuda"
    assert np.isclose(float(acc8), 0.5 + float(packed[..., 3].double().sum()),
                      rtol=1e-5)


def test_deferred_capacity_grows_on_card(card):
    """strict_capacity=False on the card: the counters come back through
    pinned memory and an event, capacities grow within two frames, and
    the image then equals a strict render's."""
    shapes = [Shape([Path.from_circle((128, 128), 112 - 4 * i)]) for i in range(20)]
    t = scenes.ortho(SIZE, SIZE)
    commands = []
    for s in shapes:
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t, color=(1.0, 0.0, 0.0, 1.0)),
        ]
    renderer = Renderer(Configuration(), SIZE, SIZE, tile_capacity=8,
                        strict_capacity=False, device=card)
    images = [renderer.render(commands, as_uint8=True) for _ in range(3)]
    assert renderer.tile_capacity > 8
    strict = Renderer(Configuration(), SIZE, SIZE, tile_capacity=8, device=card)
    assert np.array_equal(images[-1], strict.render(commands, as_uint8=True))


ORBIT_W, ORBIT_H = 1920, 1080
#: An orbit frame whose instances cross the near plane, and one whose do
#: not (tests/test_torch_frame_program_plan.py counts them on the host).
ORBIT_CROSSING, ORBIT_CLEAR = 30, 0


@pytest.fixture(scope="module")
def orbit(card):
    """The showcase with text at 1920x1080 through compile_frame (packed
    RGBA8), planned over the orbit's 99 frames; the sequential walk."""
    shape = showcase.build_shape(with_text=True)
    program = Renderer(Configuration(), ORBIT_W, ORBIT_H, strict_capacity=False,
                       device=card).compile_frame(
        showcase.showcase_commands(shape, ORBIT_W, ORBIT_H), uint8_output=True
    )
    assert program.plan_for_motion(
        [showcase.orbit_transforms(i, ORBIT_W, ORBIT_H) for i in range(99)]
    )
    walk = Renderer(Configuration(), ORBIT_W, ORBIT_H, auto_instance=False,
                    device=card)
    return shape, program, walk


def orbit_walk(shape, walk, frame):
    """The sequential walk's packed frame of the orbit, and its stats."""
    image = walk.render(showcase.showcase_commands(
        shape, ORBIT_W, ORBIT_H, view_rotation=showcase.orbit_rotor(frame)
    ), as_uint8=True)
    return image, walk.stats


@pytest.mark.parametrize("frame", [ORBIT_CROSSING, ORBIT_CLEAR])
def test_orbit_program_matches_sequential_walk_on_card(orbit, frame):
    """The 1080p orbit's program frame, fused, equals the sequential
    walk's to the bit, with and without near-plane crossings; the kernel
    equals plain on the program's own binning of the frame."""
    shape, program, walk = orbit
    transforms = showcase.orbit_transforms(frame, ORBIT_W, ORBIT_H)
    image = program(transforms)
    assert program.stats["fused"] and image.dtype == torch.uint8
    want, stats = orbit_walk(shape, walk, frame)
    assert (stats["near_plane_crossings"] > 0) == (frame == ORBIT_CROSSING)
    assert np.array_equal(image.cpu().numpy(), want)
    variant, runtime = program._bin(program._opt_rows(transforms))
    assert_kernel_matches_plain(variant.spec, *runtime)


def test_orbit_render_sequence_matches_calls_on_card(orbit):
    """render_sequence over 8 orbit frames equals the per-frame calls."""
    _, program, _ = orbit
    segment = np.stack([showcase.orbit_transforms(i, ORBIT_W, ORBIT_H)
                        for i in range(24, 32)])
    before = RECORD.counters["raster_launches"]
    frames = program.render_sequence(segment)
    assert RECORD.counters["raster_launches"] == before + len(segment)
    for got, t in zip(frames, segment):
        assert torch.equal(got, program(t))


@pytest.mark.parametrize("uint8_output", [False, True], ids=["float", "packed"])
def test_render_sequence_writes_frames_in_place_on_card(card, uint8_output):
    """render_sequence at 200x72 (not a multiple of the tile), float and
    quantized frames of a float program, packed frames of a packed one:
    each frame the kernel writes in place equals the per-frame call."""
    width, height = 200, 72
    shape = showcase.build_shape(with_text=True)
    program = Renderer(Configuration(), width, height, device=card).compile_frame(
        showcase.showcase_commands(shape, width, height), uint8_output=uint8_output
    )
    segment = np.stack([showcase.orbit_transforms(i, width, height)
                        for i in range(3)])
    calls = [program(t) for t in segment]
    for as_uint8 in (False, True):
        before = RECORD.counters["raster_launches"]
        frames = program.render_sequence(segment, as_uint8=as_uint8)
        assert RECORD.counters["raster_launches"] == before + len(segment)
        quantize = as_uint8 and not uint8_output
        for got, want in zip(frames, calls):
            assert torch.equal(got, Renderer._quantize(want) if quantize else want)
        assert bool((frames[..., 3] != 0).any())


def test_frame_program_deferred_growth_on_card(card):
    """A program whose capacity is shrunk below what its frame bins: the
    counters come back through pinned memory behind a CUDA event, the
    program rebuilds within OVERFLOW_MAX_LAG frames, and its frame then
    equals a strict render's."""
    t = scenes.ortho(SIZE, SIZE)
    commands = []
    for i in range(20):
        s = Shape([Path.from_circle((128, 128), 112 - 4 * i)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t,
                        color=(i / 20, 1 - i / 20, 0.5, 1.0)),
        ]
    program = Renderer(Configuration(), SIZE, SIZE, strict_capacity=False,
                       device=card).compile_frame(commands)
    program._caps["capacity"] = 8
    program._build()
    builds = program.builds
    for _ in range(port.FrameProgram.OVERFLOW_MAX_LAG):
        program()
        if program.builds > builds:
            break
    assert program.builds == builds + 1 and program._caps["capacity"] > 8
    want = Renderer(Configuration(), SIZE, SIZE, device=card).render(
        commands, to_host=False)
    assert torch.equal(program(), want)


#: The 256² orbit's frames of the graph tests: 0 to 35 in steps of 5,
#: the later ones crossing the near plane.
GRAPH_FRAMES = tuple(range(0, 40, 5))


def orbit_program(card, **renderer_kw):
    """The showcase with text at SIZE² through compile_frame (packed
    RGBA8), planned over GRAPH_FRAMES; its shape and the frames' stacks."""
    shape = showcase.build_shape(with_text=True)
    program = Renderer(Configuration(), SIZE, SIZE, strict_capacity=False,
                       device=card, **renderer_kw).compile_frame(
        showcase.showcase_commands(shape, SIZE, SIZE), uint8_output=True
    )
    stacks = [showcase.orbit_transforms(i, SIZE, SIZE) for i in GRAPH_FRAMES]
    assert program.plan_for_motion(stacks)
    return shape, program, stacks


def eager_frame(program, transforms):
    """The frame through the variant's own prepare and rasterize, outside
    its graph."""
    variant, runtime = program._bin(program._opt_rows(transforms))
    return variant.rasterize(*runtime)


def test_frame_graph_matches_eager_on_card(card):
    """Eight orbit frames at 256², the dash phase moving, replayed back to
    back with no synchronise (each frame's transforms and descriptors go
    through the staging ring while earlier frames may still run), equal
    to the bit to the eager prepare + rasterize of each frame; every
    frame a replay of the graph plan_for_motion captured, one kernel
    launch each."""
    shape, program, stacks = orbit_program(card)
    step = program._fused_variants[program._plan.signature][1].step
    assert step.graph is not None and step.capture_ms > 0 and step.launches == 1

    def phase(i):
        shape.set_dynamic_stroke_options(0, showcase.dashed_options(0.1 * i))

    before = RECORD.counters["raster_launches"]
    graph = []
    for i, t in enumerate(stacks):
        phase(i)
        graph.append(program(t))
        assert program.stats["fused"] and "capture_ms" not in program.stats
    assert RECORD.counters["raster_launches"] == before + len(stacks)
    eager = []
    for i, t in enumerate(stacks):
        phase(i)
        eager.append(eager_frame(program, t))
    for i, (g, e) in enumerate(zip(graph, eager)):
        assert torch.equal(g, e), GRAPH_FRAMES[i]
    assert len({g.cpu().numpy().tobytes() for g in graph}) == len(graph)


def test_frame_graph_replays_without_sync_on_card(card):
    """torch.cuda.set_sync_debug_mode("error") holds around replayed
    frames, carry and render_sequence included: no call of the frame path
    waits for the device."""
    _, program, stacks = orbit_program(card)
    acc = torch.zeros((), device=card)
    for t in stacks:
        _, acc = program(t, carry=acc)
    program.render_sequence(np.stack(stacks[:2]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in stacks:
            _, acc = program(t, carry=acc)
        frames = program.render_sequence(np.stack(stacks[:2]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(acc) > 0 and bool((frames[..., 3] != 0).any())


def test_frame_graph_growth_recaptures_on_card(card):
    """A program shrunk below what its frame bins: its first frame warms
    its step up, the second captures; the deferred counters grow it, the
    rebuild drops the graphs, and the new step warms up on the frame
    that grew, captures on the next and replays after, one kernel launch
    a frame; those frames equal a strict render."""
    t = scenes.ortho(SIZE, SIZE)
    commands = []
    for i in range(20):
        s = Shape([Path.from_circle((128, 128), 112 - 4 * i)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t,
                        color=(i / 20, 1 - i / 20, 0.5, 1.0)),
        ]
    program = Renderer(Configuration(), SIZE, SIZE, strict_capacity=False,
                       device=card).compile_frame(commands)
    program._caps["capacity"] = 8
    program._build()
    builds = program.builds
    program()
    first = program._seq.step
    assert first.graph is None and "capture_ms" not in program.stats
    for _ in range(port.FrameProgram.OVERFLOW_MAX_LAG):
        program()
        if program.builds > builds:
            break
    assert program.builds == builds + 1 and program._caps["capacity"] > 8
    step = program._seq.step
    assert step is not first and step.graph is None
    want = Renderer(Configuration(), SIZE, SIZE, device=card).render(
        commands, to_host=False)
    for captures in (True, False):
        before = RECORD.counters["raster_launches"]
        assert torch.equal(program(), want)
        assert ("capture_ms" in program.stats) == captures
        assert RECORD.counters["raster_launches"] == before + 1
        assert program._seq.step is step and step.graph is not None


def test_frame_graph_clip_alpha_two_layers_on_card(card):
    """The clip/alpha showcase with two alpha layers (layer mode 0: the
    layers in shared memory, whose launch sets the kernel's dynamic
    shared-memory attribute inside the capture) at 256²: the variants of
    two stacks warmed up, then captured, then replayed, each frame equal
    to the bit to the eager prepare + rasterize.  A grouping the rotated
    stack derives is built on its second frame (the hysteresis), so its
    warm-up and capture come two rounds after the others'."""
    config = Configuration(alpha_layer_count=2, blending="front_to_back")
    commands = showcase.showcase_commands_clip_alpha(
        showcase.build_shape(with_text=False), SIZE, SIZE)
    program = Renderer(config, SIZE, SIZE, device=card).compile_frame(commands)
    assert coverage.layer_mode(program._seq.spec) == 0
    natural = Renderer._pack_transforms(commands)
    rotated = Renderer._pack_transforms(port._rotated_probe_commands(commands))
    captured = []
    for _ in range(5):  # counts and builds, warm-ups, captures, replays
        for transforms in (natural, rotated):
            image = program(transforms)
            captured.append("capture_ms" in program.stats)
            assert torch.equal(image, eager_frame(program, transforms))
            assert bool((image[..., 3] != 0).any())
    # One capture per variant (the two stacks may share one), each on its
    # variant's second frame; the last round only replays.
    steps = [v.step for v in program._variants() if v.step is not None]
    assert steps and all(step.graph is not None for step in steps)
    assert captured.count(True) == len(steps)
    assert not captured[0] and not any(captured[8:])


def test_hysteresis_motion_matches_sequential_walk_on_card(card):
    """The 256² showcase orbit's 99 frames with no plan: the hysteresis
    builds the groupings met twice, whose frames then warm up, capture
    and replay; some frames are fused and no variant captures twice
    between two builds of the program.  Every frame whose binning did not
    overflow the capacities it ran at (the deferred growth's
    under-populated frames, FrameProgram's contract) equals, to the bit,
    the eager frame of the variant it ran and then the strict sequential
    walk (``Renderer(auto_instance=False).render``)."""
    shape = showcase.build_shape(with_text=True)
    program = Renderer(Configuration(), SIZE, SIZE, strict_capacity=False,
                       device=card).compile_frame(
        showcase.showcase_commands(shape, SIZE, SIZE), uint8_output=True)
    walk = Renderer(Configuration(), SIZE, SIZE, auto_instance=False,
                    device=card)
    fused, captured, overflowed, unlike_walk = 0, [], [], []
    for i in range(99):
        t = showcase.orbit_transforms(i, SIZE, SIZE)
        caps = [program._caps[name] for name in port._CAP_NAMES]
        plan = program._plan
        image = program(t)
        fused += program.stats["fused"]
        if "capture_ms" in program.stats:
            captured.append((program.builds,
                             program._plan and program._plan.signature))
        host, event = program._pending[-1][:2]
        event.synchronize()
        if any(int(c) > cap for c, cap in zip(host.tolist(), caps)):
            overflowed.append(i)
            continue
        # The variant the frame ran: the active plan's, or the walk's.
        variant = (program._fused_variants[program._plan.signature][1]
                   if program.stats["fused"] else program._seq)
        rows = program._opt_rows(t)
        if variant is not program._seq:
            rows = rows[program._plan.gather]
        d = {k: torch.as_tensor(a, device=card)
             for k, a in program._descriptors().items()}
        prepared = variant.prepare(
            *program._scene.arrays, torch.as_tensor(rows, device=card),
            d["static"], variant.paints)
        eager = variant.rasterize(prepared, variant.cmd_i, variant.cmd_f,
                                  d["f"], d["i"])
        assert torch.equal(image, eager), (i, plan)
        want = walk.render(
            showcase.showcase_commands(shape, SIZE, SIZE,
                                       view_rotation=showcase.orbit_rotor(i)),
            to_host=False, as_uint8=True)
        if not torch.equal(image, want):
            unlike_walk.append((i, int((image != want).any(-1).sum())))
    assert fused > 0 and program._sig_counts
    assert len(overflowed) <= 2 * port.FrameProgram.OVERFLOW_MAX_LAG
    assert len(captured) == len(set(captured)), captured
    assert not unlike_walk, f"(frame, pixels) unlike the walk: {unlike_walk}"


#: The near-plane repro of tests/test_torch_near_plane.py: the showcase
#: with text at 64², orbit frame 31; pair 18's stencil, then pair 15's
#: stencil and cover, and pair 15 alone.
NEAR_SIZE, NEAR_FRAME = 64, 31
NEAR_REPRO, NEAR_ALONE = (36, 30, 31), (30, 31)


def near_plane_commands(indices):
    every = showcase.showcase_commands(
        showcase.build_shape(with_text=True), NEAR_SIZE, NEAR_SIZE,
        view_rotation=showcase.orbit_rotor(NEAR_FRAME))
    return [every[i] for i in indices]


def test_near_plane_repro_on_card(card, monkeypatch):
    """The repro on the card: the kernel equal to its plain version on
    the repro's binning, a near-plane crossing binned; the frame through
    Renderer.render equal to the bit to pair 15 rendered alone (no
    winding leaks from pair 18's clipped stencil) and to the frame
    binned in float64 (coverage.prepare_in_float64)."""
    def render(indices):
        r = Renderer(Configuration(), NEAR_SIZE, NEAR_SIZE,
                     auto_instance=False, device=card)
        return r.render(near_plane_commands(indices), to_host=False,
                        as_uint8=True)

    r = Renderer(Configuration(), NEAR_SIZE, NEAR_SIZE, auto_instance=False,
                 device=card)
    spec, _, runtime = r._prepare(near_plane_commands(NEAR_REPRO))
    assert int(runtime[0].overflow[3]) > 0
    assert_kernel_matches_plain(spec, *runtime)
    got = render(NEAR_REPRO)
    assert torch.equal(got, render(NEAR_ALONE))
    make_prepare = coverage.make_prepare
    monkeypatch.setattr(coverage, "make_prepare", lambda spec: (
        coverage.prepare_in_float64(make_prepare(spec))))
    assert torch.equal(got, render(NEAR_REPRO))


def circle_pairs(shape, offsets, size=64):
    """A stencil and colour pair of ``shape`` at each pixel offset."""
    out = []
    for i, (dx, dy) in enumerate(offsets):
        t = scenes.ortho(size, size)
        t[0, 3] += 2.0 * dx / size
        t[1, 3] += 2.0 * dy / size
        out += [
            DrawCommand(RenderOperation.STENCIL, shape, t),
            DrawCommand(RenderOperation.COLOR, shape, t,
                        color=(1.0, 0.15 * (i % 6), 0.3, 0.8)),
        ]
    return out


def test_bin_step_eviction_keeps_captures_on_card(card):
    """Renderer.render over MAX_BIN_STEPS + 1 binning keys (n circles
    for n = 1 ... MAX_BIN_STEPS + 1): key 1 captures on its second miss,
    the one graph of the renderer's pool; key 2 warms up; the last key
    evicts key 1 and frees its graph, which renews the pool; then key
    2, made before the eviction, captures on its second miss (into the
    new pool: the old one, with no graph left, refuses a capture) and
    replays.  Every frame equal to the bit to the eager frame."""
    shape = Shape([Path.from_circle((4.0, 4.0), 3.0)])
    r = Renderer(Configuration(), 64, 64, auto_instance=False, device=card)
    eager = Renderer(Configuration(), 64, 64, auto_instance=False,
                     device=card)

    def frame(n, shift=0.0):
        commands = circle_pairs(shape, [(5 * i + shift, 3 * i)
                                        for i in range(n)])
        got = r.render(commands, to_host=False, uint8_kernel=True)
        assert torch.equal(got, eager_render(eager, commands,
                                             uint8_kernel=True)), n

    frame(1)
    frame(1, 1.0)
    (first,) = r._bin_steps.values()
    assert first.graph is not None
    frame(2)
    second = list(r._bin_steps.values())[-1]
    assert second.graph is None
    handle = r._pool.handle
    for n in range(3, r.MAX_BIN_STEPS + 2):
        frame(n)
    assert all(s is not first for s in r._bin_steps.values())
    assert r._pool.handle != handle
    frame(2, 1.0)
    assert second.graph is not None and second._pool is r._pool
    frame(2, 2.0)


def test_plan_eviction_keeps_captures_on_card(card):
    """plan_for_motion over MAX_FUSED_VARIANTS + 1 plans, with room for
    one grouping: the first plan captures its grouping ahead; the second
    evicts it, freeing its graph, which renews the program's pool, and
    captures its own; the motion's frames replay it, each equal to the
    bit to the eager frame."""
    shape = Shape([Path.from_circle((8.0, 8.0), 7.0)])
    apart = circle_pairs(shape, [(0, 0), (40, 0), (20, 20)])
    moved_pairs = circle_pairs(shape, [(0, 0), (6, 4), (40, 0)])
    program = Renderer(Configuration(), 64, 64, device=card).compile_frame(
        apart)
    program.MAX_FUSED_VARIANTS = 1
    stacks = [Renderer._pack_transforms(c) for c in (apart, moved_pairs)]
    assert program.plan_for_motion(stacks[:1])
    (_, first), = program._fused_variants.values()
    assert first.step.graph is not None
    handle = program._pool.handle
    assert program.plan_for_motion(stacks[1:])
    (_, second), = program._fused_variants.values()
    assert second is not first and second.step.graph is not None
    assert program._pool.handle != handle
    for _ in range(2):
        image = program(stacks[1])
        assert program.stats["fused"]
        assert torch.equal(image, eager_frame(program, stacks[1]))


def test_step_scout_matches_eager_scout_on_card(card):
    """plan_for_motion's scout round through its binning step (warm-up,
    capture, replays) over the 256² orbit's GRAPH_FRAMES gives the
    overflow counters of the eager prepare over each frame."""
    _, program, stacks = orbit_program(card)
    plan = program._plan
    rows = [program._opt_rows(t) for t in stacks]
    desc_static = torch.as_tensor(program._descriptors()["static"],
                                  device=card)
    paints = program._device_paints(plan.commands)
    got = program._scout(plan, rows, desc_static, paints)
    prepare = coverage.make_prepare(program._variant_spec(plan.commands))
    want = np.max([
        prepare(*program._scene.arrays,
                torch.as_tensor(np.ascontiguousarray(t[plan.gather]),
                                device=card),
                desc_static, paints).overflow.cpu().numpy()
        for t in rows
    ], axis=0)
    assert np.array_equal(got, want) and want[3] > 0, (got, want)


def test_fill_rasterizer_on_card_matches_cpu(card):
    """ops/raster.py: config-2-like Bézier fills at 256² through
    make_fill_rasterizer on the card and on the CPU: the same winding to
    the bit and the same max_count, at a capacity that overflows too."""
    from contrast_renderer_tpu_torch.fill import FillBuilder
    from contrast_renderer_tpu_torch.ops import raster

    builder = FillBuilder()
    for p in scenes.bezier_fill_paths(120, SIZE, SIZE, seed=3, margin=10.0,
                                      radius=(4.0, 24.0)):
        builder.add_path([], p)
    table = builder.build()
    args = (table.xy, table.aux, table.kind, table.meta, scenes.ortho(SIZE, SIZE))
    for capacity in (256, 4):
        got, got_max = raster.make_fill_rasterizer(
            SIZE, SIZE, capacity=capacity, device=card)(*args)
        want, want_max = raster.make_fill_rasterizer(
            SIZE, SIZE, capacity=capacity, device="cpu")(*args)
        assert got.device.type == "cuda" and got_max.device.type == "cuda"
        assert torch.equal(got.cpu(), want) and int(got_max) == int(want_max)
    assert int(want_max) > 4 and (want != 0).any()


def _band_mesh(bands=4):
    from contrast_renderer_tpu_torch.parallel import Mesh

    n = torch.cuda.device_count()
    return Mesh([f"cuda:{i % n}" for i in range(bands)], ("y",))


def test_render_sharded_on_card_matches_single_render(card):
    """Four row bands of the showcase with text at 256² (on the cards
    there are, in turn) against the single-device render: mean |Δ| <
    1e-4, and one coverage_raster launch per band."""
    from contrast_renderer_tpu_torch.parallel import render_sharded

    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, SIZE, SIZE)
    before = RECORD.counters["raster_launches"]
    sharded = render_sharded(Renderer(Configuration(), SIZE, SIZE, device=card),
                             commands, _band_mesh())
    assert RECORD.counters["raster_launches"] - before >= 4
    single = Renderer(Configuration(), SIZE, SIZE, device=card).render(commands)
    assert float(np.mean(np.abs(sharded - single))) < 1e-4


def test_render_sharded_bands_on_card_match_cpu(card):
    """Four row bands of the showcase at 256², each written by the kernel
    as its band's frame and gathered, against the same bands rendered on
    the CPU: packed RGBA8 identical."""
    from contrast_renderer_tpu_torch.parallel import Mesh, render_sharded

    shape = showcase.build_shape(with_text=True)
    commands = showcase.showcase_commands(shape, SIZE, SIZE)
    got, want = (
        Renderer._quantize(torch.from_numpy(render_sharded(
            Renderer(Configuration(), SIZE, SIZE, device=dev), commands, mesh
        )))
        for dev, mesh in ((card, _band_mesh()), ("cpu", Mesh(["cpu"] * 4, ("y",))))
    )
    assert torch.equal(got, want) and bool(want[..., 3].any())


def test_frame_loop_on_card_matches_compile_frame(card):
    """The orbit example's app through FrameLoop on the card presents the
    frames a separately built FrameProgram renders, as RGBA8."""
    from contrast_renderer_tpu_torch.app import FrameLoop
    from contrast_renderer_tpu_torch.examples.orbit_camera import ShowcaseOrbitApp

    app = ShowcaseOrbitApp(with_text=True)
    loop = FrameLoop(app, SIZE, SIZE)
    assert loop.renderer.device.type == "cuda"
    reference = Renderer(Configuration(), SIZE, SIZE, device=card)
    program = reference.compile_frame(
        showcase.showcase_commands(app._shape, SIZE, SIZE))
    loop.send_button(True)
    for index in range(3):
        loop.send_pointer(20.0 * index, 5.0 * index)
        presented = loop.step()
        want = Renderer._quantize(program(app.transforms(reference)))
        assert np.array_equal(presented, want.cpu().numpy()), index
        assert (presented[..., 3] > 0).any()


def moved(commands, stack):
    """The commands under one frame's transform stack."""
    return [replace(c, transform=np.ascontiguousarray(t))
            for c, t in zip(commands, stack)]


def eager_render(renderer, commands, **kw):
    """``commands`` binned eagerly outside every binning step (on a
    renderer of their own), then rasterized: the frame without graphs."""
    renderer._prepared_cache.clear()
    _, rasterize, runtime = renderer._prepare(
        commands, uint8_kernel=kw.get("uint8_kernel", False), graph=False)
    return rasterize(*runtime)


def showcase_orbit(card, config=None, clip_alpha=False, **renderer_kw):
    """The showcase (with text) at SIZE² and its GRAPH_FRAMES orbit
    stacks; a renderer for the graph path and one for the eager path,
    neither auto-instanced (one binning step serves every frame)."""
    config = config or Configuration()
    build = (showcase.showcase_commands_clip_alpha if clip_alpha
             else showcase.showcase_commands)
    commands = build(showcase.build_shape(with_text=not clip_alpha), SIZE, SIZE)
    stacks = [showcase.command_transforms(
        SIZE, SIZE, clip_alpha=clip_alpha, view_rotation=showcase.orbit_rotor(i))
        for i in GRAPH_FRAMES]
    graph, eager = (
        Renderer(config, SIZE, SIZE, auto_instance=False, device=card,
                 **renderer_kw)
        for _ in range(2)
    )
    for r in (graph, eager):
        # Grow the capacities over every stack first (eagerly), so that
        # no frame below grows them and drops the step.
        strict, r.strict_capacity = r.strict_capacity, True
        for t in stacks:
            r._prepare(moved(commands, t), graph=False)
        r.strict_capacity = strict
        r._prepared_cache.clear()
    return commands, stacks, graph, eager


@pytest.mark.parametrize("uint8_kernel", [False, True], ids=["float", "packed"])
def test_render_graph_matches_eager_on_card(card, uint8_kernel):
    """Renderer.render of the moved showcase, a cache miss a frame: the
    first frame warms the binning step up, the second captures it, the
    rest replay it; every frame equals the eager binning + raster to the
    bit, one kernel launch each; the cached binnings and the returned
    frames alias no buffer of the step and stay as they were."""
    commands, stacks, r, e = showcase_orbit(card, strict_capacity=False)
    frames, captured = [], []
    for t in stacks:
        before = RECORD.counters["raster_launches"]
        frames.append(r.render(moved(commands, t), to_host=False,
                               uint8_kernel=uint8_kernel))
        assert RECORD.counters["raster_launches"] == before + 1
        captured.append("capture_ms" in r.timing)
    assert captured == [False, True] + [False] * (len(stacks) - 2)
    (step,) = r._bin_steps.values()
    assert step.graph is not None and step.launches == 0
    kept = [f.clone() for f in frames]
    entries = [p for p, _ in r._prepared_cache.values()]
    cached = [[t.clone() for t in p] for p in entries]
    for t in stacks[::-1]:
        r.render(moved(commands, t), to_host=False, uint8_kernel=uint8_kernel)
    own = {t.data_ptr() for t in step.prepared}
    for p, c in zip(entries, cached):
        assert not own & {t.data_ptr() for t in p}
        assert all(torch.equal(a, b) for a, b in zip(p, c))
    for i, (f, k, t) in enumerate(zip(frames, kept, stacks)):
        assert torch.equal(f, k), i
        want = eager_render(e, moved(commands, t), uint8_kernel=uint8_kernel)
        assert torch.equal(f, want), GRAPH_FRAMES[i]
    assert len({f.cpu().numpy().tobytes() for f in frames}) == len(frames)


def test_render_graph_miss_without_sync_on_card(card):
    """At strict_capacity=False a replayed miss, the dash phase moving
    (desc_f uploads every frame), waits for nothing on the device:
    torch.cuda.set_sync_debug_mode("error") holds around it."""
    commands, stacks, r, _ = showcase_orbit(card, strict_capacity=False)
    shape = commands[0].shape

    def frame(phase, t):
        shape.set_dynamic_stroke_options(0, showcase.dashed_options(phase))
        return r.render(moved(commands, t), to_host=False, uint8_kernel=True)

    for i, t in enumerate(stacks):
        frame(0.1 * i, t)
    r._prepared_cache.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        images = [frame(0.1 * i + 0.05, t) for i, t in enumerate(stacks)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (step,) = r._bin_steps.values()
    assert step.graph is not None
    assert all(bool((image[..., 3] != 0).any()) for image in images)


def test_render_graph_reads_overflow_once_per_miss_on_card(card):
    """At strict_capacity=True a replayed miss reads the overflow
    counters back once, its only synchronising call; a cache hit makes
    none."""
    import warnings

    commands, stacks, r, _ = showcase_orbit(card)
    for t in stacks[:2]:  # the warm-up and the capture
        r.render(moved(commands, t), to_host=False)
    torch.cuda.synchronize()

    def syncs(t):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r.render(moved(commands, t), to_host=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in caught)

    for t in stacks[2:]:
        assert syncs(t) == 1
        assert r.timing["bin_ms"] > 0 and "max_tile_entries" in r.stats
        assert syncs(t) == 0 and r.timing["bin_ms"] == 0.0


def test_render_graph_growth_recaptures_on_card(card):
    """A renderer whose tile capacity is below what its frames bin, at
    strict_capacity=False: the deferred counters grow it within two
    frames, the growth drops the binning step, and a new step warms up,
    captures and replays; the frames after the growth equal a strict
    render's."""
    t = scenes.ortho(SIZE, SIZE)
    commands = []
    for i in range(20):
        s = Shape([Path.from_circle((128, 128), 112 - 4 * i)])
        commands += [
            DrawCommand(RenderOperation.STENCIL, s, t),
            DrawCommand(RenderOperation.COLOR, s, t,
                        color=(i / 20, 1 - i / 20, 0.5, 1.0)),
        ]
    r = Renderer(Configuration(), SIZE, SIZE, tile_capacity=8,
                 strict_capacity=False, auto_instance=False, device=card)
    strict = Renderer(Configuration(), SIZE, SIZE, auto_instance=False,
                      device=card)

    def frame(k):
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = 0.002 * k
        return [replace(c, transform=shift @ c.transform) for c in commands]

    r.render(frame(0), to_host=False)
    (first,) = r._bin_steps.values()
    k = 0
    while r.tile_capacity == 8:
        k += 1
        r.render(frame(k), to_host=False)
        assert k <= 3
    # The frame that read the counters grew the capacity, dropped the
    # step and warmed up a new one.
    (grown,) = r._bin_steps.values()
    assert grown is not first and grown.graph is None
    captures = []
    for _ in range(3):
        k += 1
        got = r.render(frame(k), to_host=False)
        captures.append("capture_ms" in r.timing)
        assert torch.equal(got, strict.render(frame(k), to_host=False))
    assert captures == [True, False, False]
    assert list(r._bin_steps.values()) == [grown] and grown.graph is not None


def test_render_graph_clip_alpha_two_layers_on_card(card):
    """The moved clip/alpha showcase with two alpha layers (layer mode 0,
    whose launch sets the kernel's dynamic shared-memory attribute) at
    SIZE²: its binning step captured and replayed, each frame equal to
    the eager binning + raster to the bit."""
    config = Configuration(alpha_layer_count=2, blending="front_to_back")
    commands, stacks, r, e = showcase_orbit(card, config, clip_alpha=True)
    for t in stacks:
        got = r.render(moved(commands, t), to_host=False)
        assert torch.equal(got, eager_render(e, moved(commands, t)))
        assert bool((got[..., 3] != 0).any())
    (step,) = r._bin_steps.values()
    assert step.graph is not None


def test_render_graph_depth_and_paints_on_card(card):
    """The mixed-paints frame (gradient, instanced solid pair, checker
    UserPaint) under less_equal with depth write, panned a little each
    frame: its binning step (depth planes and paint points projected
    inside the graph) captured and replayed, each frame equal to the
    eager binning + raster to the bit."""
    config = Configuration(depth_compare="less_equal", depth_write_enabled=True)
    commands = scenes.mixed_paints(SIZE, SIZE)
    r, e = (Renderer(config, SIZE, SIZE, device=card) for _ in range(2))
    for k in range(5):
        pan = np.eye(4, dtype=np.float32)
        pan[0, 3] = 0.01 * k
        frame = [replace(c, transform=pan @ np.asarray(c.transform, np.float32))
                 for c in commands]
        got = r.render(frame, to_host=False)
        assert torch.equal(got, eager_render(e, frame)), k
    steps = list(r._bin_steps.values())
    assert steps and all(step.graph is not None for step in steps)


@pytest.mark.parametrize("grid", ["bands", "2x2"])
def test_sharded_program_graph_matches_eager_on_card(card, grid):
    """ShardedFrameProgram over 4 row bands and ShardedFrameProgram2D over
    2x2 rects (on the cards there are, in turn) of the moved showcase at
    SIZE²: each rect's step warms up on the first frame, captures on the
    second and replays after, one kernel launch a rect a frame; every
    frame equals the eager sharded frame to the bit and is a tensor of
    its own."""
    from contrast_renderer_tpu_torch.parallel import (
        Mesh, ShardedFrameProgram, ShardedFrameProgram2D,
    )
    from contrast_renderer_tpu_torch.parallel import mesh as mesh_module

    commands = showcase.showcase_commands(
        showcase.build_shape(with_text=True), SIZE, SIZE)
    r = Renderer(Configuration(), SIZE, SIZE, device=card)
    if grid == "bands":
        program = ShardedFrameProgram(r, commands, _band_mesh())
    else:
        n = torch.cuda.device_count()
        mesh = Mesh(np.array([f"cuda:{i % n}" for i in range(4)]).reshape(2, 2),
                    ("y", "x"))
        program = ShardedFrameProgram2D(r, commands, mesh)
    stacks = [showcase.orbit_transforms(g, SIZE, SIZE) for g in GRAPH_FRAMES[:5]]
    for stack in stacks:  # a pass that may grow and rebuild
        program(stack)
    frames = []
    for stack in stacks:
        before = RECORD.counters["raster_launches"]
        frames.append(program(stack))
        assert RECORD.counters["raster_launches"] == before + 4
        want, _ = mesh_module._run_grid(
            program._pipeline, program._grid, program._rows(stack))
        assert torch.equal(frames[-1], want)
    own = {s.frame.data_ptr() for s in program._steps.values()}
    assert len(own) == 4
    assert all(s.graph is not None for s in program._steps.values())
    assert not own & {f.data_ptr() for f in frames}
    assert len({f.cpu().numpy().tobytes() for f in frames}) == len(frames)


@pytest.fixture(scope="module")
def record_card():
    """The card with the S = 4 library alone, for the frame record's
    cases (``-k frame_record`` runs them without the other builds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    coverage.build_kernels([coverage.KernelFeatures(4)])
    return torch.device("cuda")


def record_rows(program):
    return [r for r in RECORD.rows() if r["program"] == program._name]


def test_frame_record_marks_are_monotone_on_card(record_card):
    """The orbit's planned frames at SIZE² replayed back to back: each
    frame's six device marks (captured with the graph) rise, its five
    stages are positive, and it counts its graph's nodes, the marks left
    out, equal to the step's count at the capture."""
    _, program, stacks = orbit_program(record_card)
    for t in stacks:
        program(t)
    rows = record_rows(program)[-len(stacks):]
    step = program._fused_variants[program._plan.signature][1].step
    assert step.nodes > sum(step.stage_nodes.values()) > 0
    for row in rows:
        assert row["kind"] == "FrameProgram" and len(row["marks_ns"]) == 1
        marks = row["marks_ns"][0]
        assert all(a < b for a, b in zip(marks, marks[1:])), marks
        assert all(v > 0 for v in row["stages_ms"].values())
        assert row["graph_nodes"] == step.nodes
        assert row["stage_nodes"] == step.stage_nodes


def test_frame_record_stages_match_events_on_card(record_card):
    """An eager binning of each of three orbit frames at 1080p: its five
    stages sum to within 5% of CUDA events recorded around it."""
    shape = showcase.build_shape(with_text=True)
    program = Renderer(Configuration(), ORBIT_W, ORBIT_H, strict_capacity=False,
                       device=record_card).compile_frame(
        showcase.showcase_commands(shape, ORBIT_W, ORBIT_H), uint8_output=True)
    dev = record_card
    for frame in (0, 15, ORBIT_CROSSING):
        t = program._opt_rows(showcase.orbit_transforms(frame, ORBIT_W, ORBIT_H))
        variant, transforms = program._choose(t, derive=False)
        d = {k: torch.as_tensor(a, device=dev)
             for k, a in program._descriptors().items()}
        args = (*program._scene.arrays, torch.as_tensor(transforms, device=dev),
                d["static"], variant.paints)
        variant.prepare(*args)  # its constants made, its kernels loaded
        torch.cuda.synchronize()
        record = RECORD.begin("eager binning", "test", "test", "bin")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        variant.prepare(*args)
        end.record()
        record.end()
        torch.cuda.synchronize()
        row = [r for r in RECORD.rows() if r["frame"] == record.index][0]
        stages = sum(row["stages_ms"].values())
        events = start.elapsed_time(end)
        assert abs(stages - events) <= 0.05 * events, (
            frame, row["stages_ms"], events)


def test_frame_record_node_counts_repeat_on_card(record_card):
    """Captures of one variant, after its steps are dropped and in a
    second program of the same commands, count the same nodes in all and
    per stage."""
    counts = []
    for _ in range(2):
        _, program, stacks = orbit_program(record_card)
        for _ in range(2):
            step = program._fused_variants[program._plan.signature][1].step
            counts.append((step.nodes, step.stage_nodes))
            program._drop_steps()
            for t in stacks[:2]:  # a warm-up, then a capture
                program(t)
    assert counts[0][0] > 0 and all(c == counts[0] for c in counts), counts
