"""The port's binning and its plain rasterizer against the JAX package,
on one scene of random quadratic and cubic Bézier fills (BASELINE config
2's construction at 128²) under a translucent circle, at 4× MSAA."""

from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu.path import Path
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from contrast_renderer_tpu_torch.utils.profiling import RECORD
from test_torch_instance import one_thread  # noqa: F401

SIZE = 128


def reference_commands():
    fills = ref.Shape(scenes.bezier_fill_paths(
        40, SIZE, SIZE, seed=0, margin=8.0, radius=(4.0, 16.0),
        geometry=ref_path,
    ))
    circle = ref.Shape([Path.from_circle((64, 64), 45)])
    t = scenes.ortho(SIZE, SIZE)
    return [
        ref.DrawCommand(ref.RenderOperation.STENCIL, circle, t),
        ref.DrawCommand(
            ref.RenderOperation.COLOR, circle, t, color=(0.2, 0.5, 0.9, 0.7)
        ),
        ref.DrawCommand(ref.RenderOperation.STENCIL, fills, t),
        ref.DrawCommand(
            ref.RenderOperation.COLOR, fills, t, color=(0.9, 0.4, 0.1, 1.0)
        ),
    ]


@lru_cache(maxsize=None)
def frame(strips):
    """Both packages' spec and scene tensors for one tile layout."""
    commands = reference_commands()
    r = ref.Renderer(
        ref.Configuration(), SIZE, SIZE, interpret=True, tile_strips=strips
    )
    shapes, index = r._unique_shapes(commands)
    _, scene = r._scene_arrays(shapes)
    ops = tuple(int(c.operation) for c in commands)
    cmd_shape = tuple(r._cmd_shape_entry(c, index) for c in commands)
    # The reference sets has_strokes from descriptor groups, which every
    # shape carries, so it is always True; the port keys it on stroke
    # rows.  A fill-only scene renders the same either way.
    spec = replace(r._spec(ops, cmd_shape, (), scene), has_strokes=False)

    pcommands = interop.scene_from_reference(commands)
    p = port.Renderer(
        port.Configuration(), SIZE, SIZE, tile_strips=strips, device="cpu"
    )
    pshapes, pindex = p._unique_shapes(pcommands)
    _, pscene = p._scene_arrays(pshapes)
    pspec = p._spec(
        ops, tuple(p._cmd_shape_entry(c, pindex) for c in pcommands), (),
        pscene,
    )
    transforms = r._pack_transforms(commands)
    desc_f, desc_i = r._pack_descriptors(shapes)
    cmd_i, cmd_f = r._pack_commands_runtime(commands)
    return dict(
        spec=spec, scene=scene, pspec=pspec, pscene=pscene,
        transforms=transforms, desc_static=np.ascontiguousarray(desc_i[:, [9, 8]]),
        desc_f=desc_f, desc_i=desc_i, cmd_i=cmd_i, cmd_f=cmd_f,
    )


def reference_prepare(f, jit):
    prepare = ref_cov.make_prepare(f["spec"])
    args = (*f["scene"].arrays, jnp.asarray(f["transforms"]),
            jnp.asarray(f["desc_static"]))
    if jit:
        out = jax.jit(prepare)(*args)
    else:
        with jax.disable_jit():
            out = prepare(*args)
    return ref_cov.PreparedFrame(*(np.asarray(a) for a in out))


@lru_cache(maxsize=None)
def jitted_reference_prepare(strips):
    return reference_prepare(frame(strips), jit=True)


def port_prepare(f):
    out = port_cov.make_prepare(f["pspec"])(
        *f["pscene"].arrays, torch.as_tensor(f["transforms"]),
        torch.as_tensor(f["desc_static"]),
    )
    return port_cov.PreparedFrame(*(t.numpy() for t in out))


def rows_in_ranges(rows, ranges):
    """Concatenated rows [0, end of the last range) of every tile."""
    return np.concatenate([rows[t, :ranges[t, 0, -1]] for t in range(len(rows))])


def bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_specs_match():
    f = frame(1)
    assert interop.spec_from_reference(f["spec"]) == f["pspec"]
    assert f["pspec"].n_tiles == 4 and f["pspec"].tile_h == 32


def test_binning_matches_reference_bit_for_bit():
    """Every output of the port's make_prepare equals the reference's
    to the bit, entry rows inside the off/g_off ranges included.

    The reference runs op by op (jax.disable_jit): XLA then rounds each
    multiply and add on its own, as torch does.  Jitted, XLA's CPU
    compiler contracts a·b + c into fused multiply-adds, which moves a
    tile-corner test that lies within one rounding of an edge line; see
    the next test for what that changes."""
    f = frame(1)
    want = reference_prepare(f, jit=False)
    got = port_prepare(f)
    for name in ("off", "g_off", "bulk", "cls", "hbits", "acount",
                 "aclist", "overflow", "hull_lines", "paint_xy", "zplane"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(bits(a), bits(b)), name
    for rows, ranges in (("tri_f", "off"), ("tri_i", "off"),
                         ("g_tri_f", "g_off"), ("g_tri_i", "g_off")):
        a = rows_in_ranges(getattr(want, rows), getattr(want, ranges))
        b = rows_in_ranges(getattr(got, rows), getattr(got, ranges))
        assert len(a) > 0, rows
        assert np.array_equal(bits(a), bits(b)), rows


def test_binning_against_jitted_reference():
    """Against the jitted reference (FMA-contracted on the CPU), the
    cover classes, hull bits, bulk winding and active lists still agree
    exactly; local entry counts differ by at most one per (tile,
    command, class) range, where a tile corner lies within one rounding
    of a triangle edge (such an entry covers no sample of the tile); the
    hull lines agree to 1e-6 of their magnitude."""
    f = frame(1)
    want = jitted_reference_prepare(1)
    got = port_prepare(f)
    for name in ("g_off", "bulk", "cls", "hbits", "acount", "aclist"):
        assert np.array_equal(getattr(want, name), getattr(got, name)), name
    counts_want = np.diff(want.off[:, 0], axis=1)
    counts_got = np.diff(got.off[:, 0], axis=1)
    assert np.abs(counts_want - counts_got).max() <= 1
    assert np.array_equal(want.overflow[1:], got.overflow[1:])
    scale = np.abs(want.hull_lines).max()
    assert np.abs(want.hull_lines - got.hull_lines).max() <= 1e-6 * scale


CONSTANT_BLEND = (
    ("constant", "add", "one_minus_src_alpha"),
    ("src_alpha_saturated", "reverse_subtract", "one"),
)
BLEND_CONSTANT = (0.25, 0.5, 0.75, 0.5)


@pytest.mark.parametrize(
    "strips, out_u8, samples, blending",
    [
        (1, False, 4, "back_to_front"),
        (1, True, 4, "back_to_front"),
        (2, False, 4, "back_to_front"),
        (2, True, 4, "back_to_front"),
        (1, False, 1, "front_to_back"),
        (1, True, 8, "additive"),
        (2, False, 16, CONSTANT_BLEND),
    ],
    ids=["strips1-float", "strips1-u8", "strips2-float", "strips2-u8",
         "msaa1-front_to_back", "msaa8-additive-u8", "msaa16-constant"],
)
def test_rasterize_plain_matches_reference_kernel(strips, out_u8, samples,
                                                  blending):
    """The reference's Pallas kernel (interpret mode) and the port's
    rasterize_plain on the same PreparedFrame (the binning does not
    depend on the sample count or the blend state).  Float output within
    1e-6; packed RGBA8 equal on at least 99.9% of pixels, each differing
    pixel off by at most one sample's share (an edge tie rounded the
    other way).  Measured on this scene: equal to the bit in six cases;
    with the front-to-back blend, 998 of 65,536 float values differ by
    at most 6e-8 (one rounding: the interpreted reference fuses the
    blend's multiply-add) and the RGBA8 quantization is equal."""
    f = frame(strips)
    prepared = jitted_reference_prepare(strips)
    spec = replace(
        f["spec"], out_uint8=out_u8, interpret=True, samples=samples,
        blending=blending,
    )
    constant = (
        BLEND_CONSTANT if ref_cov.blend_uses_constant(blending) else None
    )
    cmd_i, cmd_f = ref.Renderer._pack_commands_runtime(
        reference_commands(), constant
    )
    want = np.asarray(jax.jit(ref_cov.make_rasterize(spec))(
        ref_cov.PreparedFrame(*(jnp.asarray(a) for a in prepared)),
        cmd_i, cmd_f, f["desc_f"], f["desc_i"],
    ))
    rasterize = port_cov.make_rasterize(interop.spec_from_reference(spec))
    got = rasterize(
        interop.prepared_from_numpy(prepared),
        *(torch.as_tensor(a) for a in (cmd_i, cmd_f, f["desc_f"], f["desc_i"])),
    ).numpy()
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    assert got.dtype == want.dtype
    assert np.abs(want.astype(np.float32)).max() > 0.1  # the frame is not empty
    if out_u8:
        differs = (got != want).any(-1)
        assert differs.mean() <= 1e-3
        share = -(-255 // samples)
        assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share
    else:
        assert np.abs(got - want).max() <= 1e-6


def test_plain_rasterizer_is_the_cpu_path():
    """On CPU tensors coverage_raster runs rasterize_plain, de-tiles its
    output into the frame, and launches nothing."""
    f = frame(1)
    prepared = interop.prepared_from_numpy(jitted_reference_prepare(1))
    spec = interop.spec_from_reference(f["spec"])
    draws = port_cov.draw_tables(spec)
    args = (
        spec, prepared, torch.as_tensor(f["cmd_i"]), torch.as_tensor(f["cmd_f"]),
        torch.as_tensor(draws.unit_cmd), torch.as_tensor(draws.unit_draw),
        torch.as_tensor(f["desc_f"]), torch.as_tensor(f["desc_i"]),
    )
    before = RECORD.counters["raster_launches"]
    image = port_cov.coverage_raster(*args)
    assert RECORD.counters["raster_launches"] == before
    tiles = port_cov.rasterize_plain(*args)
    assert tiles.shape == (spec.n_tiles, 4, spec.tile_h, spec.tile_w)
    assert torch.equal(image, port_cov.detile(spec, tiles))
    assert image.shape == (spec.height, spec.width, 4)
