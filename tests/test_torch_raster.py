"""The port's standalone fill rasterizer (``ops/raster.py``) against the
JAX package's and against the port's scalar oracle.

Each package builds its table with its own ``FillBuilder``; the tables
must be equal before anything else is compared.  The JAX functions run
op by op (``jax.disable_jit``): jitted on the CPU, XLA contracts a·b+c
into FMAs, which the port (and the JAX package's own eager ops) round
in two steps.  Setup, binning and winding are then equal to the bit.
Scenes are 128² under an orthographic transform whose products are
exact, so the order of the 4×4 product's terms cannot show either."""

import jax
import numpy as np
import pytest
import torch

from contrast_renderer_tpu.fill import FillBuilder as RefFillBuilder
from contrast_renderer_tpu.ops import raster as ref_raster
from contrast_renderer_tpu.path import (
    IntegralCubicCurveSegment as RefCubic,
    LineSegment as RefLine,
    Path as RefPath,
)
from contrast_renderer_tpu_torch import oracle
from contrast_renderer_tpu_torch.fill import FillBuilder
from contrast_renderer_tpu_torch.ops import raster
from contrast_renderer_tpu_torch.path import (
    IntegralCubicCurveSegment,
    LineSegment,
    Path,
)
from test_torch_instance import one_thread  # noqa: F401

SIZE = 128
#: Port against the oracle: the share of samples whose winding may
#: differ (tests/test_raster.py's bar for the JAX package).
ORACLE_MISMATCH = 5e-4
#: composite_color's tolerance against the JAX function.
COMPOSITE_ATOL = 1e-6
TABLE_FIELDS = ("xy", "aux", "kind", "meta")


def ortho(width=SIZE, height=SIZE):
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def _cubic(P, Cubic, Line):
    p = P(start=(16, 40))
    p.push_integral_cubic_curve(Cubic([(40, 120), (90, 120), (112, 40)]))
    p.push_line(Line([(16, 40)]))
    return p


#: Scenes by name: each builds its paths from one package's Path types.
SCENES = {
    "rect": lambda P, C, L: [P.from_rect((64, 64), (40, 30))],
    "circle": lambda P, C, L: [P.from_circle((64, 64), 45)],
    "rounded_rect": lambda P, C, L: [P.from_rounded_rect((64, 64), (45, 30), 12)],
    "cubic": lambda P, C, L: [_cubic(P, C, L)],
    "concentric": lambda P, C, L: [P.from_circle((64, 64), 50),
                                   P.from_circle((64, 64), 25)],
    "nested20": lambda P, C, L: [P.from_circle((64, 64), 40 - i) for i in range(20)],
    # The scene of the one JAX-side winding: both orientations and a
    # cubic, overlapping.
    "mixed": lambda P, C, L: [P.from_circle((44, 44), 30),
                              P.from_circle((84, 84), 30),
                              _cubic(P, C, L)],
}


def _table(builder_cls, paths, reverse=()):
    builder = builder_cls()
    hull = []
    for i, p in enumerate(paths):
        if i in reverse:
            p.reverse()
        builder.add_path(hull, p)
    return builder.build()


def tables(name, reverse=()):
    """(reference table, port table) of a scene, checked equal."""
    ref = _table(RefFillBuilder, SCENES[name](RefPath, RefCubic, RefLine), reverse)
    port = _table(FillBuilder, SCENES[name](Path, IntegralCubicCurveSegment,
                                            LineSegment), reverse)
    for field in TABLE_FIELDS:
        a, b = np.asarray(getattr(ref, field)), np.asarray(getattr(port, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    return ref, port


def _args(table):
    return table.xy, table.aux, table.kind, table.meta, ortho()


def port_winding(table, width=SIZE, height=SIZE, **kw):
    rasterize = raster.make_fill_rasterizer(width, height, device="cpu", **kw)
    winding, max_count = rasterize(table.xy, table.aux, table.kind, table.meta,
                                   ortho(width, height))
    assert winding.dtype == torch.int32 and max_count.dim() == 0
    return winding.numpy(), int(max_count)


@pytest.fixture(scope="module")
def mixed():
    """The mixed scene's tables, and the JAX package's winding of it,
    run op by op."""
    ref, port = tables("mixed", reverse=(1,))
    with jax.disable_jit():
        winding, max_count = ref_raster.make_fill_rasterizer(SIZE, SIZE)(*_args(ref))
    return ref, port, np.asarray(winding), int(max_count)


def test_setup_triangles_equals_the_reference(mixed):
    ref, port = mixed[:2]
    with jax.disable_jit():
        want = ref_raster.setup_triangles(*_args(ref), SIZE, SIZE)
    got = raster.setup_triangles(*_args(port), SIZE, SIZE)
    assert got._fields == want._fields
    for field in want._fields:
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    # Reversed and forward circles contribute opposite windings.
    assert {-1, 1} <= set(np.unique(got.contribution.numpy()).tolist())


@pytest.mark.parametrize("capacity", [8, 256])
def test_bin_triangles_equals_the_reference(capacity):
    """Indices, valid slots and max_count, with the nested circles
    overflowing the smaller capacity."""
    ref, port = tables("nested20")
    tiles = -(-SIZE // 32)
    with jax.disable_jit():
        setup = ref_raster.setup_triangles(*_args(ref), SIZE, SIZE)
        want = ref_raster.bin_triangles(setup.aabb, setup.contribution, tiles,
                                        tiles, 32, capacity)
    setup = raster.setup_triangles(*_args(port), SIZE, SIZE)
    got = raster.bin_triangles(setup.aabb, setup.contribution, tiles, tiles,
                               32, capacity)
    for name, a, b in zip(("indices", "valid", "max_count"), want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (int(got[2]) > capacity) == (capacity == 8)


def test_winding_equals_the_reference(mixed):
    ref, port, want, want_max = mixed
    got, got_max = port_winding(port)
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    assert np.array_equal(got, want)
    assert got_max == want_max
    assert got.min() < 0 < got.max()


@pytest.mark.parametrize("orient", ["forward", "reverse"])
@pytest.mark.parametrize("name", ["rect", "circle", "rounded_rect", "cubic"])
def test_winding_matches_the_oracle(name, orient):
    _, table = tables(name, reverse=(0,) if orient == "reverse" else ())
    got, max_count = port_winding(table)
    assert max_count <= 256
    want = oracle.rasterize_fill_table(table, SIZE, SIZE)
    assert np.mean(got != want) < ORACLE_MISMATCH
    assert (got != 0).any()


def test_config1_circle_is_exact():
    """BASELINE config 1: the circle at 256², against the oracle."""
    size = 256
    builder = FillBuilder()
    builder.add_path([], Path.from_circle((128, 128), 90))
    table = builder.build()
    got, _ = port_winding(table, size, size)
    assert np.mean(got != oracle.rasterize_fill_table(table, size, size)) == 0.0


def test_even_odd_winding():
    # Two concentric circles of one orientation: even-odd (1 winding
    # bit) punches a hole; nonzero with 4 bits does not.
    _, table = tables("concentric")
    got, _ = port_winding(table)
    cov_eo = raster.resolve_coverage(torch.from_numpy(got), 1).numpy()
    cov_nz = raster.resolve_coverage(torch.from_numpy(got), 4).numpy()
    assert np.array_equal(cov_eo, oracle.coverage_from_winding(got, winding_bits=1))
    assert not cov_eo[64, 64].any() and cov_nz[64, 64].all()
    assert cov_eo[64, 25].all() and cov_nz[64, 25].all()


def test_overflow_is_reported_as_the_reference_reports_it():
    ref, port = tables("nested20")
    _, got = port_winding(port, capacity=8)
    with jax.disable_jit():
        setup = ref_raster.setup_triangles(*_args(ref), SIZE, SIZE)
        _, _, want = ref_raster.bin_triangles(
            setup.aabb, setup.contribution, 4, 4, 32, 8
        )
    assert got == int(want) > 8


def test_resolve_and_composite_equal_the_reference(mixed):
    winding = mixed[2]
    for bits in (1, 4):
        want = np.asarray(ref_raster.resolve_coverage(winding, bits))
        got = raster.resolve_coverage(torch.from_numpy(winding.copy()), bits)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    coverage = np.asarray(ref_raster.resolve_coverage(winding))
    color = np.array([1.0, 0.2, 0.0, 0.5], np.float32)
    background = np.array([0.1, 0.2, 0.3, 1.0], np.float32)
    for bg in (None, background):
        want = np.asarray(ref_raster.composite_color(coverage, color, bg))
        got = raster.composite_color(torch.from_numpy(coverage), color, bg)
        assert got.shape == (SIZE, SIZE, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COMPOSITE_ATOL)


def test_empty_table_and_tile_chunks():
    """No triangles: an empty winding and max_count 0; and a chunk size
    smaller than the frame's tile count renders the same winding."""
    rasterize = raster.make_fill_rasterizer(64, 64, device="cpu")
    winding, max_count = rasterize(
        np.zeros((0, 3, 2), np.float32), np.zeros((0, 3, 4), np.float32),
        np.zeros(0, np.int32), np.zeros((0, 2), np.float32), ortho(64, 64),
    )
    assert winding.shape == (64, 64, 4) and not winding.any()
    assert int(max_count) == 0
    _, table = tables("circle")
    whole, _ = port_winding(table)
    chunk_bytes = raster.CHUNK_BYTES
    try:
        raster.CHUNK_BYTES = 1
        assert raster.tile_chunk(32, 4, 64) == 1
        chunked, _ = port_winding(table)
    finally:
        raster.CHUNK_BYTES = chunk_bytes
    assert np.array_equal(chunked, whole)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raster.make_fill_rasterizer(SIZE, SIZE)
