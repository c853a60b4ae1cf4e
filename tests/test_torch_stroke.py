"""The port's stroke stencil against the JAX package: binning of stroke
rows, the plain rasterizer's stroke bodies against the reference kernel
(interpret mode) and the cap golden.  One raster case and the dash-phase
animation run in test_torch_stroke_phase.py, so that the gate's workers
(split by file) run them in parallel with this file.

The scene (scenes.stroke_sampler at 128², 4× MSAA): open polylines
with mitre, bevel and round joins and several cap styles, in one solid
group, one single-interval dash group and one two-interval dash group,
plus a curve stroke flattened by uniform tangent angle."""

from dataclasses import replace
from functools import lru_cache
from pathlib import Path as FsPath

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_instance import one_thread  # noqa: F401

SIZE = 128
GOLDEN = FsPath(__file__).parent / "golden" / "cap_styles_96x72.npy"


def reference_commands():
    shape = ref.Shape(*scenes.stroke_sampler(SIZE, geometry=ref_path))
    t = scenes.ortho(SIZE, SIZE)
    return [
        ref.DrawCommand(ref.RenderOperation.STENCIL, shape, t),
        ref.DrawCommand(
            ref.RenderOperation.COLOR, shape, t, color=(0.9, 0.8, 0.2, 0.9)
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
    # A frame without clip or alpha brackets has no gate spans.
    spec = replace(r._spec(ops, cmd_shape, (), scene), gate_spans=())

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
    desc_f, desc_i = r._pack_descriptors(shapes)
    return dict(
        spec=spec, scene=scene, pspec=pspec, pscene=pscene,
        transforms=r._pack_transforms(commands),
        desc_static=np.ascontiguousarray(desc_i[:, [9, 8]]),
        desc_f=desc_f, desc_i=desc_i,
    )


@lru_cache(maxsize=None)
def reference_prepared(strips, jit):
    f = frame(strips)
    prepare = ref_cov.make_prepare(f["spec"])
    args = (*f["scene"].arrays, jnp.asarray(f["transforms"]),
            jnp.asarray(f["desc_static"]))
    if jit:
        out = jax.jit(prepare)(*args)
    else:
        with jax.disable_jit():
            out = prepare(*args)
    return ref_cov.PreparedFrame(*(np.asarray(a) for a in out))


def port_prepared(f):
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


def test_stroke_binning_matches_reference_bit_for_bit():
    """Every binning output of a stroke frame equals the reference's to
    the bit, run op by op (jax.disable_jit, so that XLA rounds each
    multiply and add as torch does), including the stroke rows inside
    the ranges: 1/w (RF_IW), the end-cap y (RF_END_Y), the group, the
    end-cap and joint-tip flags and the dash-mode class.

    The spec is the reference's own (it has strokes), without gate
    spans."""
    f = frame(1)
    assert f["spec"].has_strokes
    assert interop.spec_from_reference(f["spec"]) == f["pspec"]
    want = reference_prepared(1, jit=False)
    got = port_prepared(f)
    for name in ("off", "g_off", "bulk", "cls", "hbits", "acount",
                 "aclist", "overflow", "hull_lines"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(bits(a), bits(b)), name
    for rows, ranges in (("tri_f", "off"), ("tri_i", "off"),
                         ("g_tri_f", "g_off"), ("g_tri_i", "g_off")):
        a = rows_in_ranges(getattr(want, rows), getattr(want, ranges))
        b = rows_in_ranges(getattr(got, rows), getattr(got, ranges))
        assert np.array_equal(bits(a), bits(b)), rows
    # The scene reaches every stroke class the kernel walks, end caps
    # and joint tips included.
    tri_i = rows_in_ranges(got.tri_i, got.off)
    classes = set(np.unique(tri_i[:, port_cov.RI_CLASS]).tolist())
    assert {c for c, _, _ in port_cov.STROKE_CLASSES} <= classes
    flags = tri_i[:, port_cov.RI_FLAGS]
    assert (flags & port_cov.FLAG_END_CAP).any()
    assert (flags & port_cov.FLAG_JOINT_TIP).any()
    assert set(np.unique(tri_i[:, port_cov.RI_GROUP]).tolist()) == {0, 1, 2}


@pytest.mark.parametrize(
    "strips, out_u8",
    [(1, False), (2, False), (2, True)],
    ids=["strips1-float", "strips2-float", "strips2-u8"],
)
def test_rasterize_plain_strokes_match_reference_kernel(strips, out_u8):
    """The reference's Pallas kernel (interpret mode) and the port's
    rasterize_plain on the same PreparedFrame and descriptors; the
    strips1-u8 case runs in test_torch_stroke_phase.py."""
    check_stroke_raster(strips, out_u8)


def check_stroke_raster(strips, out_u8):
    """Float output within 1e-6; packed RGBA8 equal on at least 99.9% of
    pixels, each differing pixel off by at most one sample's share: the
    stroke predicates are tie-sensitive comparisons, and XLA's CPU
    compiler contracts the reference's multiply-adds into FMAs, which can
    move a sample that lies within one rounding of a boundary.  Measured
    on this scene: equal to the bit in all four cases."""
    f = frame(strips)
    prepared = reference_prepared(strips, jit=True)
    spec = replace(f["spec"], out_uint8=out_u8, interpret=True)
    cmd_i, cmd_f = ref.Renderer._pack_commands_runtime(reference_commands())
    want = np.asarray(jax.jit(ref_cov.make_rasterize(spec))(
        ref_cov.PreparedFrame(*(jnp.asarray(a) for a in prepared)),
        cmd_i, cmd_f, f["desc_f"], f["desc_i"],
    ))
    got = port_cov.make_rasterize(interop.spec_from_reference(spec))(
        interop.prepared_from_numpy(prepared),
        *(torch.as_tensor(a) for a in (cmd_i, cmd_f, f["desc_f"], f["desc_i"])),
    ).numpy()
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    assert got.dtype == want.dtype
    assert (want[..., 3] > 0).mean() > 0.05  # the strokes cover the frame
    if out_u8:
        differs = (got != want).any(-1)
        assert differs.mean() <= 1e-3
        share = -(-255 // spec.samples)
        assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share
    else:
        assert np.abs(got - want).max() <= 1e-6


def render_cap_sheet(renderer):
    w, h = scenes.CAP_SHEET_SIZE
    shape = port.Shape(*scenes.cap_sheet())
    t = scenes.ortho(w, h)
    return renderer.render([
        port.DrawCommand(port.RenderOperation.STENCIL, shape, t),
        port.DrawCommand(
            port.RenderOperation.COLOR, shape, t, color=(1.0, 1.0, 1.0, 1.0)
        ),
    ])[..., 3]


def test_cap_sheet_matches_golden():
    """All seven cap styles against the reference's committed golden,
    bit for bit, as the reference's own test demands."""
    w, h = scenes.CAP_SHEET_SIZE
    alpha = render_cap_sheet(
        port.Renderer(port.Configuration(), w, h, device="cpu")
    )
    want = np.load(GOLDEN)
    assert alpha.shape == want.shape
    assert np.array_equal(alpha, want)
