"""``Renderer.render``'s binning step, on the CPU.

On a CUDA device a cache miss of ``Renderer._prepare`` bins through the
step of its spec and scene (``renderer._FrameStep``, binning only): the
key's first miss warms it up, its second captures it as a CUDA graph,
and later misses replay it; on the CPU the same step object runs eagerly
and leaves its binning in its own buffers, as a replay does.  Here: the
showcase under six orbit stacks through the port's ``Renderer.render``
against the JAX package's ``Renderer.render`` of the same stacks, packed
RGBA8 (one reference render per frame, shared by the file, its kernel
in interpret mode); cached binnings that later moved frames leave alone;
``carry`` and ``uint8_kernel`` on the same step; a capacity growth that
drops the steps and renders right, strict and deferred; and a dropped
renderer that frees its steps without a collection."""

from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.models import showcase as ref_showcase
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.models import showcase
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

SIZE = 64
#: Orbit frames of run_configs.config5_orbit, as
#: tests/test_torch_frame_graph.py renders them.
FRAMES = (0, 6, 12, 18, 24, 30)
#: The showcase's first commands (four instances, stencil and colour).
COMMANDS = 8
#: Frames that cross the near plane, where the reference's jitted raster
#: (XLA on the CPU contracts multiply-adds into fused ones) differs from
#: its own raster run op by op, in 12 and 41 of the 4,096 pixels
#: (measured); tests/test_torch_render_graph_ref.py holds the port's
#: frames to the frames it bins in float64, to the bit, and to the
#: op-by-op run.
REFERENCE_FMA_FRAMES = (24, 30)
PACKAGES = {"reference": (ref, ref_showcase), "port": (port, showcase)}


@lru_cache(maxsize=None)
def orbit_shape(package):
    return PACKAGES[package][1].build_shape(with_text=False)


def orbit_commands(package, frame):
    """The first COMMANDS showcase commands (no text, one shape per
    package) under the orbit's frame ``frame``."""
    _, showcase_module = PACKAGES[package]
    shape = orbit_shape(package)
    commands = showcase_module.showcase_commands(shape, SIZE, SIZE)[:COMMANDS]
    stack = showcase_module.command_transforms(
        SIZE, SIZE, view_rotation=showcase.orbit_rotor(frame))[:COMMANDS]
    return [replace(c, transform=np.ascontiguousarray(t))
            for c, t in zip(commands, stack)]


def port_renderer(**kw):
    return port.Renderer(port.Configuration(), SIZE, SIZE,
                         auto_instance=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def moved():
    """Each package's Renderer.render of the six orbit frames, packed
    RGBA8, and the port's renderer (one binning step serves them all)."""
    want = ref.Renderer(ref.Configuration(), SIZE, SIZE, interpret=True,
                        auto_instance=False)
    r = port_renderer()
    commands = [orbit_commands("port", f) for f in FRAMES]
    return {
        "reference": [
            want.render(orbit_commands("reference", f), uint8_kernel=True)
            for f in FRAMES
        ],
        "port": [r.render(c, uint8_kernel=True, to_host=False)
                 for c in commands],
        "renderer": r,
        "commands": commands,
    }


def test_moved_frames_match_reference_render(moved):
    """Six moved frames, each a cache miss of the same step, against the
    JAX package's render of the same stacks, packed RGBA8: within the
    parity bar of assert_images_agree, but for REFERENCE_FMA_FRAMES, and
    different from one another."""
    r = moved["renderer"]
    assert len(r._bin_steps) == 1 and len(r._prepared_cache) == len(FRAMES)
    for frame, got, want in zip(FRAMES, moved["port"], moved["reference"]):
        assert got.dtype == torch.uint8, frame
        if frame not in REFERENCE_FMA_FRAMES:
            assert_images_agree(got.numpy(), want)
    assert not torch.equal(moved["port"][0], moved["port"][-1])
    assert (moved["reference"][0][..., 3] > 0).any()


def test_cached_binnings_stay_after_later_frames(moved):
    """No cache entry aliases the step's buffers: entries kept from the
    six frames are unchanged by later moved frames (each a miss through
    the same step), and a cache hit renders its frame as before."""
    r, commands = moved["renderer"], moved["commands"]
    entries = [prepared for prepared, _ in r._prepared_cache.values()]
    kept = [[t.clone() for t in p] for p in entries]
    (step,) = r._bin_steps.values()
    for frame in (3, 9):
        r.render(orbit_commands("port", frame), uint8_kernel=True)
    assert len(r._bin_steps) == 1 and step.prepared is not None
    own = {t.data_ptr() for t in step.prepared}
    for p, k in zip(entries, kept):
        assert not own & {t.data_ptr() for t in p}
        for a, b in zip(p, k):
            assert torch.equal(a, b)
    hits = len(r._prepared_cache)
    again = r.render(commands[-1], uint8_kernel=True, to_host=False)
    assert r.timing["bin_ms"] == 0.0 and len(r._prepared_cache) == hits
    assert torch.equal(again, moved["port"][-1])


def test_carry_and_float_frames_share_the_step(moved):
    """A float frame and a carry frame of moved stacks bin through the
    same step as the packed frames, equal to the packed frame quantized
    and to the image's alpha sum."""
    r = moved["renderer"]
    (step,) = r._bin_steps.values()
    image = r.render(orbit_commands("port", 15), to_host=False)
    packed = r.render(orbit_commands("port", 15), uint8_kernel=True,
                      to_host=False)
    assert torch.equal(packed, port.Renderer._quantize(image))
    again, total = r.render(orbit_commands("port", 21), carry=1.5)
    assert list(r._bin_steps.values()) == [step]
    assert float(total) == pytest.approx(
        1.5 + float(again[..., 3].sum()), rel=1e-6)


def circles(n=4):
    """n concentric circles at SIZE²: more entries a tile than a
    capacity of 8 holds."""
    t = scenes.ortho(SIZE, SIZE)
    commands = []
    for i in range(n):
        s = port.Shape([port_path.Path.from_circle((32, 32), 30 - 2 * i)])
        commands += [
            port.DrawCommand(port.RenderOperation.STENCIL, s, t),
            port.DrawCommand(port.RenderOperation.COLOR, s, t,
                             color=(i / n, 1 - i / n, 0.5, 1.0)),
        ]
    return commands


def shifted(commands, dx):
    move = np.eye(4, dtype=np.float32)
    move[0, 3] = dx
    return [replace(c, transform=move @ c.transform) for c in commands]


@pytest.mark.parametrize("strict", [True, False])
def test_capacity_growth_drops_steps_and_renders_right(strict):
    """A renderer whose tile capacity is below what its frames bin: the
    growth (at once when strict, from the counters read back on the
    CPU otherwise) drops every binning step, and the moved frames after
    it, through new steps, equal a renderer's that never overflowed."""
    commands = circles()
    r = port_renderer(tile_capacity=8, strict_capacity=strict)
    big = port_renderer()
    r.render(commands)
    assert r.tile_capacity > 8
    assert all(key[0].capacity == r.tile_capacity for key in r._bin_steps)
    for k in range(3):
        moved = shifted(commands, 0.01 * (k + 1))
        got = r.render(moved, to_host=False)
        assert torch.equal(got, big.render(moved, to_host=False))
    assert len(r._bin_steps) == 1
    step = next(iter(r._bin_steps.values()))
    r._grow_capacities(np.array([r.tile_capacity + 1, 0, 0, 0]),
                       (r.tile_capacity, 1 << 30, 1 << 30, 1 << 30))
    assert not r._bin_steps
    moved = shifted(commands, 0.05)
    assert torch.equal(r.render(moved, to_host=False),
                       big.render(moved, to_host=False))
    assert next(iter(r._bin_steps.values())) is not step


def test_dropped_renderer_frees_its_steps_without_a_collection():
    """No reference cycle holds a binning step: dropping the renderer
    frees the step (on the card, its graph) at once, with the collector
    off."""
    import gc
    import weakref

    commands = circles(1)
    r = port_renderer()
    r.render(commands)
    r.render(shifted(commands, 0.1))
    step = weakref.ref(next(iter(r._bin_steps.values())))
    collecting = gc.isenabled()
    gc.disable()
    try:
        del r
        assert step() is None
    finally:
        if collecting:
            gc.enable()
