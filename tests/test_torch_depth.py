"""The port's depth body against the JAX package: the NDC-z planes that
``make_prepare`` solves per cover draw, the plain rasterizer's depth test
and write against the reference kernel (Pallas in interpret mode) for
every compare function, and the reference showcase's depth state on two
of its perspective instances through ``Renderer.render``."""

from dataclasses import replace
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
from contrast_renderer_tpu_torch import interop, scenes
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64
COMPARES = ("never", "less", "equal", "less_equal", "greater", "not_equal",
            "greater_equal", "always")
#: The showcase instances of the zplane test: the centre, a middle one
#: (whose ink overlaps the centre's) and two at the grid's corners.
INSTANCES = (0, 1, 23, 45)


def ortho_z(z, size=SIZE):
    """scenes.ortho with the model plane at NDC depth ``z``."""
    t = scenes.ortho(size, size)
    t[2, 3] = z
    return t


def depth_scene(api, geometry):
    """The reference's TestDepth._depth_scene (tests/test_renderer.py): a
    near red circle at z = 0.3 drawn before a far green one at z = 0.7
    that overlaps it."""
    op = api.RenderOperation
    commands = []
    for x, z, color in ((28.0, 0.3, (1.0, 0.0, 0.0, 1.0)),
                        (40.0, 0.7, (0.0, 1.0, 0.0, 1.0))):
        shape = api.Shape([geometry.Path.from_circle((x, 32.0), 14.0)])
        commands += [
            api.DrawCommand(op.STENCIL, shape, ortho_z(z)),
            api.DrawCommand(op.COLOR, shape, ortho_z(z), color=color),
        ]
    return commands


def tilted(transform, angle=0.5):
    """``transform`` after a turn of the model plane about its y axis:
    its depth then varies across the screen."""
    c, s = np.cos(angle), np.sin(angle)
    turn = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])
    return (np.asarray(transform, np.float64) @ turn).astype(np.float32)


def instance_commands(api, geometry, instances, size=SIZE, tilt=False):
    """The showcase's solid rounded rect under the transforms of
    ``instances`` (perspective camera, each instance parallel to the
    screen), one stencil and colour pair each, as tests/test_showcase.py
    builds them; with ``tilt``, the first instance once more, turned."""
    op = api.RenderOperation
    solid = api.Shape([geometry.Path.from_rounded_rect((0.0, 0.0), (5.8, 1.3), 0.5)])
    transforms, _ = showcase.instance_transforms_and_colors(size, size)
    chosen = [transforms[i] for i in instances]
    if tilt:
        chosen.append(tilted(transforms[instances[0]]))
    colors = ((1.0, 1.0, 1.0, 1.0), (1.0, 0.0, 0.0, 1.0),
              (0.2, 0.6, 1.0, 0.8), (0.9, 0.9, 0.1, 0.7), (0.5, 0.5, 0.5, 1.0))
    commands = []
    for transform, color in zip(chosen, colors):
        t = np.ascontiguousarray(transform, np.float32)
        commands += [
            api.DrawCommand(op.STENCIL, solid, t),
            api.DrawCommand(op.COLOR, solid, t, color=color),
        ]
    return commands


def frame(commands, config):
    """The reference's spec and prepared frame (jitted binning) for
    reference ``commands`` under ``config``, the port's prepared frame
    for the same scene (its triangle tables carried across), and the
    runtime tables both rasterizers take."""
    r = ref.Renderer(config, SIZE, SIZE, interpret=True)
    shapes, index = r._unique_shapes(commands)
    _, scene = r._scene_arrays(shapes)
    ops = tuple(int(c.operation) for c in commands)
    cmd_shape = tuple(r._cmd_shape_entry(c, index) for c in commands)
    spec = replace(r._spec(ops, cmd_shape, (), scene), has_strokes=False)
    transforms = r._pack_transforms(commands)
    desc_f, desc_i = r._pack_descriptors(shapes)
    desc_static = np.ascontiguousarray(desc_i[:, [9, 8]])
    want = jax.jit(ref_cov.make_prepare(spec))(
        *scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static)
    )
    p = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu")
    pshapes, _ = p._unique_shapes(interop.scene_from_reference(commands))
    _, pscene = p._scene_arrays(pshapes)
    got = port_cov.make_prepare(interop.spec_from_reference(spec))(
        *pscene.arrays, torch.as_tensor(transforms),
        torch.as_tensor(desc_static),
    )
    cmd_i, cmd_f = r._pack_commands_runtime(commands)
    return dict(
        spec=spec,
        ref_prepared=ref_cov.PreparedFrame(*(np.asarray(a) for a in want)),
        port_prepared=port_cov.PreparedFrame(*(t.numpy() for t in got)),
        runtime=(cmd_i, cmd_f, desc_f, desc_i),
    )


def ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def test_zplanes_match_reference():
    """The per-cover-draw planes z = a·px + b·py + c on four showcase
    instances under its perspective camera, and the centre one turned
    about its y axis: within 2 ulp of the reference's (XLA's LAPACK solve
    and the port's elementwise LU need not round alike).  Measured: equal
    to the bit on all five rows, signed zeros included."""
    config = ref.Configuration(depth_compare="less_equal",
                               depth_write_enabled=True)
    f = frame(instance_commands(ref, ref_path, INSTANCES, tilt=True), config)
    want = f["ref_prepared"].zplane
    got = f["port_prepared"].zplane
    assert got.shape == want.shape == (len(INSTANCES) + 1, 3)
    # The instances lie at two depths; the turned one tilts across x.
    assert len(np.unique(want[:4, 2])) >= 2
    assert abs(want[4, 0]) > 1e-6
    assert ulps(got, want).max() <= 2, (got, want)


def test_zplanes_are_zero_without_depth():
    f = frame(instance_commands(ref, ref_path, INSTANCES[:2]), ref.Configuration())
    assert not f["port_prepared"].zplane.any()
    assert not f["ref_prepared"].zplane.any()


@lru_cache(maxsize=None)
def depth_frame():
    """The depth scene prepared once: the binning does not depend on the
    compare function or the write, and the planes are the same for every
    depth state that computes them."""
    config = ref.Configuration(depth_compare="less_equal",
                               depth_write_enabled=True)
    return frame(depth_scene(ref, ref_path), config)


@pytest.mark.parametrize("write", [False, True], ids=["read", "write"])
@pytest.mark.parametrize("compare", COMPARES)
def test_rasterize_plain_depth_matches_reference_kernel(compare, write):
    """The reference's Pallas kernel (interpret mode) and the port's
    rasterize_plain on the same PreparedFrame, for every compare function
    with and without depth write: packed RGBA8 equal on at least 99.9% of
    pixels, each differing pixel off by at most one sample's share.
    Measured: equal to the bit in all sixteen cases."""
    f = depth_frame()
    spec = replace(f["spec"], depth_compare=compare, depth_write=write,
                   out_uint8=True, interpret=True)
    cmd_i, cmd_f, desc_f, desc_i = f["runtime"]
    want = np.asarray(jax.jit(ref_cov.make_rasterize(spec))(
        ref_cov.PreparedFrame(*(jnp.asarray(a) for a in f["ref_prepared"])),
        cmd_i, cmd_f, desc_f, desc_i,
    ))
    got = port_cov.make_rasterize(interop.spec_from_reference(spec))(
        interop.prepared_from_numpy(f["ref_prepared"]),
        *(torch.as_tensor(a) for a in (cmd_i, cmd_f, desc_f, desc_i)),
    ).numpy()
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    assert got.dtype == want.dtype == np.uint8
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.sum()
    share = -(-255 // spec.samples)
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= share
    if compare in ("less", "less_equal", "not_equal", "always"):
        assert (want[..., 3] > 0).sum() > 500  # both circles show
    if compare == "less_equal" and write:
        # The near circle wins the overlap (tests/test_renderer.py's
        # TestDepth: red at x = 34, green alone at x = 48).
        assert tuple(want[SIZE - 1 - 32, 34]) == (255, 0, 0, 255)
        assert tuple(want[SIZE - 1 - 32, 48]) == (0, 255, 0, 255)


def test_showcase_instances_depth_match_reference():
    """The centre and a middle showcase instance (whose inks overlap)
    under the reference showcase's own depth state, LessEqual with write,
    through each package's Renderer.render with its own Path: packed
    RGBA8 equal on at least 99.9% of pixels, each differing pixel off by
    at most one sample's share.  Measured: equal to the bit.  The depth
    state fired: the port's frame without it differs."""
    config = dict(depth_compare="less_equal", depth_write_enabled=True)
    want = ref.Renderer(ref.Configuration(**config), SIZE, SIZE).render(
        instance_commands(ref, ref_path, (0, 23)), as_uint8=True
    )
    commands = instance_commands(port, port_path, (0, 23))
    got = port.Renderer(
        port.Configuration(**config), SIZE, SIZE, device="cpu"
    ).render(
        commands, as_uint8=True
    )
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    differs = (got != want).any(-1)
    assert differs.mean() <= 1e-3, differs.sum()
    assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= 64
    assert (want[..., 3] > 0).sum() > 20
    plain = port.Renderer(port.Configuration(), SIZE, SIZE, device="cpu").render(
        commands, as_uint8=True
    )
    assert (plain != got).any(-1).sum() > 0


def test_reference_showcase_module_is_the_ports():
    """The instance transforms the depth tests use are the reference
    showcase's own."""
    a, _ = showcase.instance_transforms_and_colors(SIZE, SIZE)
    b, _ = ref_showcase.instance_transforms_and_colors(SIZE, SIZE)
    assert np.array_equal(np.asarray(a), np.asarray(b))
