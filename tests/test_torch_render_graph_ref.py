"""The moved frames of tests/test_torch_render_graph.py that cross the
near plane, through the port's ``Renderer.render`` (its binning step),
against the frame that the port's binning gives in float64
(``float64_binning``), to the bit, and against the JAX package run op by
op (``jax.disable_jit``: binning and the raster kernel in interpret
mode), packed RGBA8.  There the reference's jitted render differs in a
few pixels, because XLA on the CPU contracts its multiply-adds into
fused ones; the port rounds every step, as the reference does op by op,
but for the edge constants and areas of its near-plane rows
(tests/test_torch_near_plane.py).  A file of its own: each op-by-op
frame takes 20-40 s."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from contrast_renderer_tpu import renderer as ref
from contrast_renderer_tpu.ops import coverage as ref_cov
from test_torch_frame_graph import binning_inputs, float64_binning
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree
from test_torch_render_graph import (
    REFERENCE_FMA_FRAMES, SIZE, orbit_commands, port_renderer,
)


def reference_op_by_op(frame):
    """The reference's packed RGBA8 frame, binned and rasterized op by
    op."""
    commands = orbit_commands("reference", frame)
    spec, scene, transforms, desc_static, _ = binning_inputs(
        "reference", commands, size=SIZE)
    r = ref.Renderer(ref.Configuration(), SIZE, SIZE, interpret=True,
                     auto_instance=False)
    opt, _ = ref._optimize_commands(commands)
    shapes, _ = r._unique_shapes(opt)
    cmd_i, cmd_f = r._pack_commands_runtime(opt)
    desc_f, desc_i = r._pack_descriptors(shapes)
    with jax.disable_jit():
        prepared = ref_cov.make_prepare(spec)(
            *scene.arrays, jnp.asarray(transforms), jnp.asarray(desc_static))
        image = ref_cov.make_rasterize(replace(spec, out_uint8=True))(
            prepared, *(jnp.asarray(a) for a in (cmd_i, cmd_f, desc_f, desc_i)))
    return np.asarray(image)


def moved_frame(frame):
    """The port's frame, rendered after a first moved frame so that it
    bins through the step (CPU: its own buffers)."""
    r = port_renderer()
    r.render(orbit_commands("port", 0), uint8_kernel=True)
    got = r.render(orbit_commands("port", frame), uint8_kernel=True)
    assert len(r._bin_steps) == 1 and r.stats["near_plane_crossings"] > 0
    return got


@pytest.mark.parametrize("frame", REFERENCE_FMA_FRAMES)
def test_crossing_frame_equals_reference_op_by_op(frame):
    """The frame equals the frame binned in float64 to the bit, and the
    reference run op by op within the parity bar of assert_images_agree;
    or, beyond it, where the op-by-op frame is the one beyond the bar
    against the float64 frame.  Measured: frame 24 equal to both to the
    bit; frame 30 equal to its float64 frame, the op-by-op frame 46
    pixels (1.1%) off it, by up to two samples (the reference's edge
    constants at clipped vertices)."""
    got = moved_frame(frame)
    with float64_binning():
        oracle = moved_frame(frame)
    want = reference_op_by_op(frame)
    assert got.shape == want.shape == oracle.shape == (SIZE, SIZE, 4)
    assert np.array_equal(got, oracle)
    try:
        assert_images_agree(got, want)
    except AssertionError:
        with pytest.raises(AssertionError):
            assert_images_agree(want, oracle)
    assert (want[..., 3] > 0).any()
