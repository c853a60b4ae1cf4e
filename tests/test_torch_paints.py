"""The port's paint bodies against the JAX package: linear and radial
gradients (two and four stops, a hard stop, on a stroke, instanced under
the showcase's perspective camera), the paint points that ``make_prepare``
projects, the mixed frame of every paint kind with a user paint under
depth, and a user paint that re-implements the linear ramp.

Each package renders the scene built with its own ``Path`` and paint
types; the user paint is written in jax.numpy for the reference and in
torch for the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64
RED, BLUE = (1.0, 0.0, 0.0, 1.0), (0.0, 0.0, 1.0, 0.5)


def assert_images_agree(got, want, samples=4):
    """Packed RGBA8 equal on at least 99.9% of pixels, each differing
    pixel off by at most one sample's share (an edge tie that the
    reference's jitted binning, FMA-contracted on the CPU, rounds the
    other way)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.sum()
    share = -(-255 // samples)
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share


def perspective_pair():
    """Two showcase instance transforms (its perspective camera), stacked
    for one instanced command."""
    transforms, _ = showcase.instance_transforms_and_colors(SIZE, SIZE)
    return np.ascontiguousarray(np.stack([transforms[0], transforms[1]]), np.float32)


def gradient_commands(case, api, g):
    """One stencil and colour pair of the gradient ``case``, built with
    ``api``'s Shape and paint types and ``g``'s Path."""
    op = api.RenderOperation
    t = scenes.ortho(SIZE, SIZE)
    disc = api.Shape([g.Path.from_circle((32.0, 32.0), 26.0)])
    if case == "linear2":
        shape, paint = disc, api.LinearGradient(
            start=(10.0, 20.0), end=(54.0, 44.0), color0=RED, color1=BLUE)
    elif case == "linear4":
        shape = api.Shape([g.Path.from_rect((32.0, 32.0), (28.0, 20.0))])
        paint = api.LinearGradient(start=(4.0, 32.0), end=(60.0, 32.0), stops=(
            (0.0, (1.0, 0.0, 0.0, 1.0)), (0.3, (1.0, 1.0, 0.0, 0.9)),
            (0.7, (0.0, 1.0, 1.0, 0.6)), (1.0, (0.2, 0.0, 1.0, 0.3)),
        ))
    elif case == "hard_stop":
        shape, paint = disc, api.LinearGradient(
            start=(6.0, 32.0), end=(58.0, 32.0),
            stops=((0.0, RED), (0.5, RED), (0.5, BLUE), (1.0, BLUE)))
    elif case == "radial":
        shape, paint = disc, api.RadialGradient(
            center=(26.0, 36.0), edge=(58.0, 36.0),
            color0=(1.0, 0.85, 0.3, 0.9), color1=(1.0, 0.85, 0.3, 0.0))
    elif case == "stroke":
        zigzag = g.Path(start=(6.0, 16.0))
        for i in range(1, 6):
            zigzag.push_line(g.LineSegment([(6.0 + 10.4 * i, 16.0 + 32.0 * (i % 2))]))
        zigzag.stroke_options = g.StrokeOptions(
            width=6.0, offset=0.0, miter_clip=2.0, closed=False,
            dynamic_stroke_options_group=0,
        )
        shape = api.Shape(
            [zigzag],
            [g.DynamicStrokeOptions.make_solid(g.Join.ROUND, g.Cap.ROUND, g.Cap.SQUARE)],
        )
        paint = api.LinearGradient(start=(6.0, 0.0), end=(58.0, 0.0),
                                   color0=RED, color1=(0.0, 0.8, 0.2, 1.0))
    else:  # instanced: two showcase instances, one gradient in model space
        shape = api.Shape([g.Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)])
        paint = api.LinearGradient(start=(-5.8, 0.0), end=(5.8, 0.0),
                                   color0=RED, color1=BLUE)
        t = perspective_pair()
    return [
        api.DrawCommand(op.STENCIL, shape, t),
        api.DrawCommand(op.COLOR, shape, t, color=paint),
    ]


@pytest.mark.parametrize(
    "case", ["linear2", "linear4", "hard_stop", "radial", "stroke", "instanced"]
)
def test_gradient_matches_reference(case):
    """Each package renders the case through Renderer.render at 64², 4×
    MSAA, packed RGBA8.  Measured: equal to the bit in all six cases."""
    want = ref.Renderer(ref.Configuration(), SIZE, SIZE).render(
        gradient_commands(case, ref, ref_path), as_uint8=True
    )
    got = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu").render(
        gradient_commands(case, port, port_path), as_uint8=True
    )
    covered = want[want[..., 3] > 0]
    assert len(covered) > 40
    # More colours than the two ends and their edge shades (measured
    # 8 for the hard stop, 56-470 for the ramps).
    assert len(np.unique(covered, axis=0)) > 4
    assert_images_agree(got, want)


def test_paint_points_match_reference_bit_for_bit():
    """make_prepare's paint points (the model-space gradient endpoints
    through each instance's perspective transform, divided by w and
    mapped to pixels) equal the reference's to the bit, the reference
    run op by op (jax.disable_jit)."""
    commands = gradient_commands("instanced", ref, ref_path)
    r = ref.Renderer(ref.Configuration(), SIZE, SIZE, interpret=True)
    shapes, index = r._unique_shapes(commands)
    _, scene = r._scene_arrays(shapes)
    ops = tuple(int(c.operation) for c in commands)
    cmd_shape = tuple(r._cmd_shape_entry(c, index) for c in commands)
    cmd_inst = tuple(c.n_instances for c in commands)
    paints = tuple(ref._spec_paint(c.color) for c in commands)
    spec = r._spec(ops, cmd_shape, cmd_inst, scene, paints)
    transforms = r._pack_transforms(commands)
    _, desc_i = r._pack_descriptors(shapes)
    desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
    paint_model = r._pack_paints(commands)
    assert np.array_equal(port.Renderer._pack_paints(commands), paint_model)
    with jax.disable_jit():
        want = ref_cov.make_prepare(spec)(
            *scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static),
            jnp.asarray(paint_model),
        )
    p = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    pshapes, _ = p._unique_shapes(interop.scene_from_reference(commands))
    _, pscene = p._scene_arrays(pshapes)
    got = port_cov.make_prepare(interop.spec_from_reference(spec))(
        *pscene.arrays, torch.as_tensor(transforms),
        torch.as_tensor(desc_static), torch.as_tensor(paint_model),
    )
    want_xy = np.asarray(want.paint_xy)
    got_xy = got.paint_xy.numpy()
    assert got_xy.shape == want_xy.shape == (2, 4)
    assert np.array_equal(got_xy.view(np.uint32), want_xy.view(np.uint32))
    # Perspective: the two instances' endpoints land apart on screen.
    assert not np.allclose(got_xy[0], got_xy[1])


def jnp_checker(px, py, anchor):
    """The checker of tests/test_coverage_exec.py, in jax.numpy."""
    c = ((px // 4).astype(jnp.int32) + (py // 4).astype(jnp.int32)) % 2
    c = c.astype(jnp.float32)
    return c, 1.0 - c, c, jnp.full_like(c, 0.8)


def test_mixed_paints_with_depth_match_reference():
    """The mixed frame of tests/test_coverage_exec.py at 64² (a gradient
    disc, an instanced solid pair, a checker UserPaint) under LessEqual
    with depth write: the reference's checker in jax.numpy, the port's in
    torch (scenes.checker).  Measured: equal to the bit.  Both checker
    colours show."""
    config = dict(depth_compare="less_equal", depth_write_enabled=True)
    want = ref.Renderer(ref.Configuration(**config), SIZE, SIZE).render(
        scenes.mixed_paints(SIZE, SIZE, api=ref, geometry=ref_path,
                            user_paint=ref.UserPaint(jnp_checker)),
        as_uint8=True,
    )
    got = port.Renderer(
        port.Configuration(**config), SIZE, SIZE, device="cpu"
    ).render(
        scenes.mixed_paints(SIZE, SIZE), as_uint8=True
    )
    assert_images_agree(got, want)
    for rgb in ((204, 0, 204), (0, 204, 0)):  # 0.8-alpha checker colours
        assert (got[..., :3] == rgb).all(-1).any(), rgb


def test_user_ramp_matches_linear_gradient():
    """A UserPaint that re-implements the two-stop linear ramp through its
    anchor points renders as LinearGradient does (the reference's
    test_user_linear_ramp_matches_builtin_gradient, in the port).
    Measured: equal to the bit."""

    def ramp(px, py, anchor):
        x0, y0, x1, y1 = anchor
        dx, dy = x1 - x0, y1 - y0
        den = torch.clamp(dx * dx + dy * dy, min=1e-12)
        t = torch.clamp(((px - x0) * dx + (py - y0) * dy) / den, 0.0, 1.0)
        return tuple(RED[i] + (BLUE[i] - RED[i]) * t for i in range(4))

    rect = port.Shape([port_path.Path.from_rect((32, 32), (24, 24))])
    t = scenes.ortho(SIZE, SIZE)
    renderer = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")

    def render_with(paint):
        return renderer.render([
            port.DrawCommand(port.RenderOperation.STENCIL, rect, t),
            port.DrawCommand(port.RenderOperation.COLOR, rect, t, color=paint),
        ])

    user = render_with(port.UserPaint(ramp, points=((16.0, 32.0), (48.0, 32.0))))
    builtin = render_with(port.LinearGradient(
        start=(16.0, 32.0), end=(48.0, 32.0), color0=RED, color1=BLUE
    ))
    assert np.abs(user - builtin).max() < 1e-5
    assert np.array_equal(user, builtin)
    assert builtin[..., 3].max() > 0.9
