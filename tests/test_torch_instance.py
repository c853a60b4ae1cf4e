"""Auto-instancing, the deferred capacity check and the ``carry`` probe of
the port's Renderer, against the JAX package's.

Each stream is built by both packages with their own types; the port's
``_fuse_instance_runs`` must give the reference's output: the same
operations, instance counts, clip depths and layers, the same shapes
and paint objects in the same places, and transform stacks and colours
equal to the bit.  The renders here are the port's alone, on the CPU;
the reference's render of the fused showcase is in
test_torch_instance_render.py, so that another worker runs it."""

import dataclasses

import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase

SIZE = 128
CLIP_ALPHA = dict(alpha_layer_count=1, blending="front_to_back")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Render on one intra-op thread: the plain rasterizer's many small
    elementwise ops gain nothing from more, and under the gate's
    parallel workers their threads oversubscribe the cores (a 5 s render
    took 1,300 s there).  Imported by the other files of this slice."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

PACKAGES = {
    "reference": (ref, ref_path, ref_showcase),
    "port": (port, port_path, showcase),
}


def shift(dx, dy=0.0):
    """scenes.ortho(SIZE, SIZE) moved by (dx, dy) pixels."""
    t = scenes.ortho(SIZE, SIZE)
    t[0, 3] += 2.0 * dx / SIZE
    t[1, 3] += 2.0 * dy / SIZE
    return t


def pairs(api, shape, transforms, colors, clip_depths=None):
    """(STENCIL, COLOR) pairs of one shape, one per transform."""
    op = api.RenderOperation
    clip_depths = clip_depths or [0] * len(transforms)
    out = []
    for t, color, depth in zip(transforms, colors, clip_depths):
        out += [
            api.DrawCommand(op.STENCIL, shape, t, clip_depth=depth),
            api.DrawCommand(op.COLOR, shape, t, color=color, clip_depth=depth),
        ]
    return out


def disc(api, g, radius=8.0):
    return api.Shape([g.Path.from_circle((16.0, 16.0), radius)])


def showcase_stream(api, g, sc):
    return sc.showcase_commands(sc.build_shape(with_text=False), SIZE, SIZE)


def clip_alpha_stream(api, g, sc):
    return sc.showcase_commands_clip_alpha(
        sc.build_shape(with_text=False), SIZE, SIZE
    )


def overlapping(api, g, sc):
    """Six pairs of one disc of radius 8; the second overlaps the first,
    the fourth the third: the greedy grouping starts new groups there."""
    xs = (0, 10, 40, 45, 80, 100)
    colors = [(0.1 * i, 0.5, 1.0 - 0.1 * i, 0.8) for i in range(len(xs))]
    return pairs(api, disc(api, g), [shift(x) for x in xs], colors)


def near_plane(api, g, sc):
    """Five pairs; the middle one's hull crosses w = 0 (it never fuses and
    splits the run)."""
    ts = [shift(x) for x in (0, 20, 40, 60, 80)]
    crossing = shift(40)
    crossing[3] = (2.0 / SIZE, 0.0, 0.0, -0.25)  # w = (x - 16) / 64
    ts[2] = crossing
    return pairs(api, disc(api, g), ts, [(1.0, 0.0, 0.0, 1.0)] * 5)


def shared_gradient(api, g, sc):
    """Four pairs painted by one LinearGradient object: they fuse, the
    paint broadcast per instance."""
    paint = api.LinearGradient(start=(8.0, 16.0), end=(24.0, 16.0))
    return pairs(api, disc(api, g), [shift(x) for x in (0, 24, 48, 72)],
                 [paint] * 4)


def distinct_gradients(api, g, sc):
    """Four pairs painted by four equal but distinct gradient objects, then
    two solid pairs: the gradients never fuse, the solid pairs do."""
    paints = [
        api.LinearGradient(start=(8.0, 16.0), end=(24.0, 16.0))
        for _ in range(4)
    ]
    shape = disc(api, g)
    return (
        pairs(api, shape, [shift(x) for x in (0, 24, 48, 72)], paints)
        + pairs(api, shape, [shift(x, 40) for x in (0, 24)],
                [(0.0, 1.0, 0.0, 1.0), (0.0, 0.0, 1.0, 1.0)])
    )


def clip_depth_change(api, g, sc):
    """Six pairs inside a clip, the run's clip depth changing from 1 to 2
    after its third pair: two runs."""
    op = api.RenderOperation
    outer = api.Shape([g.Path.from_rect((64.0, 64.0), (60.0, 60.0))])
    inner = api.Shape([g.Path.from_rect((64.0, 64.0), (50.0, 50.0))])
    t = scenes.ortho(SIZE, SIZE)
    head = [
        api.DrawCommand(op.STENCIL, outer, t),
        api.DrawCommand(op.CLIP, outer, t, clip_depth=1),
        api.DrawCommand(op.STENCIL, inner, t, clip_depth=1),
        api.DrawCommand(op.CLIP, inner, t, clip_depth=2),
    ]
    body = pairs(
        api, disc(api, g), [shift(x, 40) for x in range(0, 120, 20)],
        [(1.0, 0.5, 0.0, 1.0)] * 6, clip_depths=[1, 1, 1, 2, 2, 2],
    )
    return head + body


STREAMS = {
    "showcase": showcase_stream,
    "showcase_clip_alpha": clip_alpha_stream,
    "overlapping": overlapping,
    "near_plane": near_plane,
    "shared_gradient": shared_gradient,
    "distinct_gradients": distinct_gradients,
    "clip_depth_change": clip_depth_change,
}
#: Each stream's fused command count (the reference's).
FUSED_COMMANDS = {
    "showcase": 4,
    "showcase_clip_alpha": 12,
    "overlapping": 6,
    "near_plane": 6,
    "shared_gradient": 2,
    "distinct_gradients": 10,
    "clip_depth_change": 8,
}


def build(name, package):
    api, g, sc = PACKAGES[package]
    return STREAMS[name](api, g, sc)


def summary(commands):
    """The stream as comparable values: shapes and paint objects by their
    order of first appearance, transforms and solid colours as float32
    arrays."""
    ids = {}

    def ordinal(obj):
        return ids.setdefault(id(obj), len(ids))

    out = []
    for c in commands:
        paint = getattr(c.color, "kind", 0)
        out.append((
            int(c.operation), c.n_instances, c.clip_depth, c.alpha_layer,
            tuple(ordinal(s) for s in c.shapes),
            np.asarray(c.transform, np.float32),
            (paint, ordinal(c.color)) if paint
            else np.asarray(c.color, np.float32),
        ))
    return out


def assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(summary(got), summary(want)):
        assert g[:5] == w[:5]
        assert g[5].shape == w[5].shape and np.array_equal(g[5], w[5])
        if isinstance(w[6], tuple):
            assert g[6] == w[6]
        else:
            assert g[6].shape == w[6].shape and np.array_equal(g[6], w[6])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_fuse_instance_runs_matches_reference(name):
    fused = {}
    for package, (api, _, _) in PACKAGES.items():
        opt, _ = api._optimize_commands(build(name, package))
        fused[package] = api._fuse_instance_runs(opt)
    got, got_any = fused["port"]
    want, want_any = fused["reference"]
    assert got_any == want_any
    assert_streams_equal(got, want)
    assert len(got) == FUSED_COMMANDS[name]


def spec_of(api, renderer, commands):
    """The FrameSpec, gate spans and all, that ``renderer`` derives for
    the optimised, auto-instanced ``commands``."""
    opt, _ = api._optimize_commands(commands)
    opt = renderer._auto_instanced(opt)
    shapes, index = renderer._unique_shapes(opt)
    _, scene = renderer._scene_arrays(shapes)
    inst = tuple(c.n_instances for c in opt)
    return renderer._spec(
        tuple(int(c.operation) for c in opt),
        tuple(renderer._cmd_shape_entry(c, index) for c in opt),
        inst if any(n != 1 for n in inst) else (),
        scene,
        tuple(api._spec_paint(c.color) for c in opt),
        commands=opt,
    )


def test_gate_spans_of_fused_clip_alpha_match_reference():
    specs = {}
    for package, (api, _, _) in PACKAGES.items():
        kwargs = {"device": "cpu"} if package == "port" else {"interpret": True}
        r = api.Renderer(api.Configuration(**CLIP_ALPHA), SIZE, SIZE, **kwargs)
        specs[package] = spec_of(api, r, build("showcase_clip_alpha", package))
    assert specs["port"].cmd_inst == specs["reference"].cmd_inst
    assert max(specs["port"].cmd_inst) == 24
    assert specs["port"].gate_spans
    assert specs["port"].gate_spans == specs["reference"].gate_spans


def test_fuse_cache_hits_on_an_unchanged_frame():
    r = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    opt, _ = port._optimize_commands(build("overlapping", "port"))
    first = r._auto_instanced(opt)
    assert len(first) == FUSED_COMMANDS["overlapping"]
    assert r._auto_instanced(opt) is first
    assert len(r._fuse_cache) == 1
    # A moved instance is another key, and its grouping is re-derived.
    moved = list(opt)
    moved[2] = dataclasses.replace(opt[2], transform=shift(70, 70))
    moved[3] = dataclasses.replace(opt[3], transform=shift(70, 70))
    again = r._auto_instanced(moved)
    assert len(r._fuse_cache) == 2 and again is not first
    assert len(again) == 4
    # A frame with no single-instance pair skips the cache.
    text = scenes.config4_text("fused", text="ab")
    assert r._auto_instanced(text) is text
    assert len(r._fuse_cache) == 2


@pytest.fixture(scope="module")
def showcase_renders():
    """The showcase at 128², packed RGBA8, rendered by the port on the
    CPU fused (the default) and walked in sequence."""
    commands = build("showcase", "port")
    images = {}
    for fused in (True, False):
        r = port.Renderer(port.Configuration(), SIZE, SIZE,
                          auto_instance=fused, device="cpu")
        images[fused] = r.render(commands, as_uint8=True)
        images[fused, "commands"] = r.stats["commands"]
    return images


def test_fused_showcase_equals_sequential_walk(showcase_renders):
    assert showcase_renders[True, "commands"] == 4
    assert showcase_renders[False, "commands"] == 92
    assert (showcase_renders[True][..., 3] > 0).sum() > 1000
    assert np.array_equal(showcase_renders[True], showcase_renders[False])


def nested_circles(api, g):
    """tests/test_coverage_exec.py's 20 nested circles at 64²: every
    central tile holds far more entries than a capacity of 8."""
    shapes = [api.Shape([g.Path.from_circle((32, 32), 28 - i)]) for i in range(20)]
    t = scenes.ortho(64, 64)
    return sum(
        (pairs(api, s, [t], [(1.0, 0.0, 0.0, 1.0)]) for s in shapes), []
    )


def test_deferred_capacity_converges_within_two_frames():
    commands = nested_circles(port, port_path)
    r = port.Renderer(port.Configuration(), 64, 64, tile_capacity=8,
                      strict_capacity=False, device="cpu")
    r.render(commands)                     # may drop triangles
    assert "max_tile_entries" not in r.stats
    image = r.render(commands)
    if r.tile_capacity <= 8:               # counters not read yet
        image = r.render(commands)
    assert r.tile_capacity > 8
    strict = port.Renderer(port.Configuration(), 64, 64, tile_capacity=8,
                           device="cpu")
    want = strict.render(commands)
    assert strict.tile_capacity == r.tile_capacity
    assert np.array_equal(image, want)
    assert np.allclose(image[32, 32], [1, 0, 0, 1], atol=1e-5)
    # A strict render recomputes an entry cached without the counters.
    r.strict_capacity = True
    assert np.array_equal(r.render(commands), want)
    assert r.stats["max_tile_entries"] <= r.tile_capacity


def test_carry_returns_the_alpha_sum_and_chains():
    shape = port.Shape([port_path.Path.from_circle((32.0, 32.0), 16.0)])
    commands = pairs(port, shape, [scenes.ortho(64, 64)], [(1.0, 0.0, 0.0, 1.0)])
    r = port.Renderer(port.Configuration(), 64, 64, device="cpu")
    image = r.render(commands)
    out, acc = r.render(commands, carry=1.5)
    assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), image)
    assert acc.dtype == torch.float32 and acc.dim() == 0
    alpha = image[..., 3].astype(np.float64).sum()
    assert np.isclose(float(acc), 1.5 + alpha, rtol=1e-5)
    _, acc2 = r.render(commands, carry=acc)
    assert np.isclose(float(acc2), 1.5 + 2 * alpha, rtol=1e-5)
    # A 0-d tensor, and the packed RGBA8 output's alpha cast to float32.
    packed, acc8 = r.render(commands, carry=torch.zeros(()), uint8_kernel=True)
    want = (np.clip(image, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), want)
    assert np.isclose(
        float(acc8), want[..., 3].astype(np.float64).sum(), rtol=1e-5
    )
