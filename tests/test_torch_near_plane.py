"""Triangles clipped at the near plane, on the CPU.

The near-plane clip pins a clipped vertex at w = 1e-6, which projects to
about 1e8 px, where a float32 is 8 px apart.  The reference takes each
edge's constant c = -(a·x + b·y) at the edge's first vertex; when that
is the far one, c misses the line by pixels, two sub-triangles that
share an edge disagree on it, and a sliver of stencil winding lies
outside the instance's cover hull, where no cover resets it.  The port
takes the constants of the clip pool's rows, and of a clipped hull's
lines, at the edge's endpoint of smaller magnitude
(``coverage._nearer_endpoint``), and a clip-pool triangle's area from
its vertex of smaller magnitude (``coverage._from_nearest_vertex``:
taken at the far vertex, a thin triangle's area cancels to 0 and the
triangle is dropped); every other row keeps the reference's rounding.

The repro: the showcase with text at 64², orbit frame 31, drawing the
stencil of pair 18, then the stencil and cover of pair 15, through
``Renderer(auto_instance=False)``.  Pair 18's stencil leaves no winding
that pair 15's cover can reach, so the frame is pair 15's alone; and it
is the frame that the port's own binning gives in float64
(tests/test_torch_frame_graph.py, ``float64_binning``).  Before the
rule, 5 pixels held 2-4 samples of leaked winding.  The reference's
render (one per file, its kernel in interpret mode) agrees within the
parity bar."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrast_renderer_tpu.ops import coverage as ref_cov
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.ops import coverage as port_cov
from test_torch_frame_graph import (
    PACKAGES,
    assert_binning_near_reference,
    binning_inputs,
    float64_binning,
    port_args,
)
from test_torch_instance import one_thread  # noqa: F401
from test_torch_showcase import assert_images_agree

SIZE = 64
FRAME = 31
#: Pair 18's stencil, then pair 15's stencil and cover.
REPRO = (36, 30, 31)
#: Pair 15 alone.
ALONE = (30, 31)
#: Tile capacity of the binning checks: the repro's entries all fit.
CAPACITY = 512


def commands(package, indices):
    api, _, showcase_module = PACKAGES[package]
    shape = showcase_module.build_shape(with_text=True)
    every = showcase_module.showcase_commands(
        shape, SIZE, SIZE, view_rotation=showcase.orbit_rotor(FRAME))
    return [every[i] for i in indices]


def render(package, indices, **kw):
    api = PACKAGES[package][0]
    if package == "port":
        kw["device"] = "cpu"
    r = api.Renderer(api.Configuration(), SIZE, SIZE, auto_instance=False,
                     **kw)
    return np.asarray(r.render(commands(package, indices), as_uint8=True))


@pytest.fixture(scope="module")
def frames():
    """The repro through the port (as it bins, and binned in float64),
    pair 15 alone through the port, and the repro through the
    reference's Renderer.render as the reference renders (jitted)."""
    with float64_binning():
        oracle = render("port", REPRO)
    return {
        "port": render("port", REPRO),
        "float64": oracle,
        "alone": render("port", ALONE),
        "reference": render("reference", REPRO, interpret=True),
    }


@pytest.mark.parametrize("other", ["alone", "float64"])
def test_repro_frame_equals_pair_alone_and_float64_binning(frames, other):
    """The repro frame equals pair 15 rendered alone, and the frame that
    the port's binning gives in float64, to the bit: no winding leaks
    from pair 18's clipped stencil."""
    got = frames["port"]
    assert (got[..., 3] > 0).any()
    assert np.array_equal(got, frames[other]), np.argwhere(
        (got != frames[other]).any(-1))


def test_repro_frame_agrees_with_reference_render(frames):
    """The reference's jitted render of the repro agrees within the
    parity bar of assert_images_agree."""
    assert_images_agree(frames["port"], frames["reference"])


def test_repro_binning_differs_from_reference_only_near_the_plane():
    """The repro's binning against the reference's run op by op: equal
    to the bit but for the clip pool's rows (their edge constants and
    areas, and a thin triangle that only the port bins, with the tables
    that follow from it) and the clipped hulls' line constants, each
    within the stated bound of the float64 oracle
    (assert_binning_near_reference); a crossing is binned."""
    spec, scene, transforms, desc_static, _ = binning_inputs(
        "port", commands("port", REPRO), size=SIZE)
    # Room for every entry of the frame's one tile (397 at most).
    spec = replace(spec, capacity=CAPACITY)
    args = port_args(scene, transforms, desc_static, None)
    got = port_cov.make_prepare(spec)(*args)
    with float64_binning():
        oracle = port_cov.make_prepare(spec)(*args)
    rspec, rscene, rtransforms, rdesc, _ = binning_inputs(
        "reference", commands("reference", REPRO), size=SIZE)
    with jax.disable_jit():
        want = ref_cov.make_prepare(replace(rspec, capacity=CAPACITY))(
            *rscene.arrays, jnp.asarray(rtransforms), jnp.asarray(rdesc))
    assert int(got.overflow[3]) > 0 and int(got.overflow[0]) <= CAPACITY
    assert assert_binning_near_reference(got, want, oracle, SIZE, SIZE) > 0


def far_points(seed):
    """Endpoints at pixel and at near-plane magnitudes, some tied."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(0, 9, size=(256, 1))
    p = (rng.standard_normal((256, 2)) * scale).astype(np.float32)
    q = (rng.standard_normal((256, 2)) * scale[::-1]).astype(np.float32)
    q[:16] = p[:16]                                       # one point
    q[16:32] = np.stack([-p[16:32, 1], p[16:32, 0]], -1)  # tied magnitudes
    q[32:48, 0] = p[32:48, 0]                             # tied x too
    q[32:48, 1] = np.where(np.abs(p[32:48, 1]) < np.abs(p[32:48, 0]),
                           -p[32:48, 1], p[32:48, 1])
    return torch.as_tensor(p), torch.as_tensor(q)


def magnitude(points):
    return torch.abs(points).amax(-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_nearer_endpoint_is_symmetric_in_its_endpoints(seed):
    """The endpoint an edge's constant is taken at is the same whichever
    way the edge runs, and of the smaller magnitude; so the edge walked
    either way, with its (a, b) negated as the other triangle of the
    edge has it, gets exactly the negated constant."""
    p, q = far_points(seed)
    forward = port_cov._nearer_endpoint(p, q, magnitude(p), magnitude(q))
    backward = port_cov._nearer_endpoint(q, p, magnitude(q), magnitude(p))
    assert torch.equal(forward, backward)
    assert torch.equal(magnitude(forward),
                       torch.minimum(magnitude(p), magnitude(q)))
    a = -(q[:, 1] - p[:, 1])
    b = q[:, 0] - p[:, 0]
    c = -(a * forward[:, 0] + b * forward[:, 1])
    assert torch.equal(-(-a * backward[:, 0] + -b * backward[:, 1]), -c)


def thin_far_triangles(seed):
    """Triangles with v0 near the near plane's 1e8 px and a short edge
    v1 v2 on the grid, a third of them with v1 and v2 on one column."""
    rng = np.random.default_rng(seed)
    n = 192
    far = rng.standard_normal((n, 2)) * 10.0 ** rng.uniform(6, 8, (n, 1))
    v1 = rng.uniform(0, 64, (n, 2))
    step = rng.uniform(-0.5, 0.5, (n, 2))
    step[: n // 3, 0] = 0.0
    pix = np.stack([far, v1, v1 + step], 1).astype(np.float32)
    return torch.as_tensor(pix)


def doubled_area(pix):
    """(v1 - v0) × (v2 - v0), as the reference takes it."""
    v0, v1, v2 = pix.unbind(1)
    return (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1]) - (
        v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])


CYCLES = torch.tensor([[0, 1, 2], [1, 2, 0], [2, 0, 1]])


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_vertex_area_keeps_thin_far_triangles(seed):
    """The area taken from each triangle's nearest vertex is the same for
    every cyclic rotation of its vertices and has the sign of the area
    in float64; it keeps the thin triangles whose area the reference's
    rounding (at v0, here the far vertex) cancels to 0."""
    pix = thin_far_triangles(seed)

    def nearest_area(p):
        return doubled_area(
            port_cov._from_nearest_vertex(p, magnitude(p), CYCLES))

    area = nearest_area(pix)
    for shift in (1, 2):
        assert torch.equal(nearest_area(torch.roll(pix, shift, 1)), area)
    assert torch.equal(torch.sign(area), torch.sign(doubled_area(pix.double())))
    assert (doubled_area(pix) == 0).any()
