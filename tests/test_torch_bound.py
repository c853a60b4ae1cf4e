"""The counts behind chip_smoke.py's kernel bound: each entry's samples
are those in its bounding box clipped to its tile, and the plain
version's ``work`` counts the samples its cover masks passed without
changing what it renders."""

import importlib.util
from pathlib import Path as FsPath

import pytest
import torch

from contrast_renderer_tpu_torch import scenes
from contrast_renderer_tpu_torch.ops import coverage
from contrast_renderer_tpu_torch.renderer import (
    Configuration,
    DrawCommand,
    RenderOperation,
    Renderer,
    Shape,
)

REPO = FsPath(__file__).resolve().parents[1]
W, H = 256, 128


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def frame():
    """A config-2 style frame of 40 opaque fills, binned on the CPU."""
    shape = Shape(scenes.bezier_fill_paths(40, W, H, seed=0))
    t = scenes.ortho(W, H)
    commands = [
        DrawCommand(RenderOperation.STENCIL, shape, t),
        DrawCommand(RenderOperation.COLOR, shape, t, color=(0.9, 0.4, 0.1, 1.0)),
    ]
    spec, _, runtime = Renderer(Configuration(), W, H, device="cpu")._prepare(commands)
    return spec, runtime


def test_entry_ops_count_the_samples_in_each_bounding_box(frame):
    smoke = _chip_smoke()
    spec, runtime = frame
    prepared, desc_i = runtime[0], runtime[4]
    want = 0
    for t in range(spec.n_tiles):
        x0 = (t % spec.ntx) * spec.screen_tile_w
        y0 = (t // spec.ntx) * spec.screen_tile_h
        xs = torch.arange(x0, x0 + spec.screen_tile_w).double()
        ys = torch.arange(y0, y0 + spec.screen_tile_h).double()
        for rows_f, rows_i, off in (
            (prepared.tri_f, prepared.tri_i, prepared.off),
            (prepared.g_tri_f, prepared.g_tri_i, prepared.g_off),
        ):
            for j in range(int(off[t, 0, -1])):
                box = rows_f[t, j, coverage.RF_AABB:coverage.RF_AABB + 4].double()
                cls = int(rows_i[t, j, coverage.RI_CLASS])
                assert cls in coverage.FILL_CLASSES
                any_x = torch.zeros_like(xs, dtype=torch.bool)
                any_y = torch.zeros_like(ys, dtype=torch.bool)
                for ox, oy in coverage.SAMPLE_PATTERNS[spec.samples]:
                    in_x = (xs + ox >= box[0]) & (xs + ox <= box[2])
                    in_y = (ys + oy >= box[1]) & (ys + oy <= box[3])
                    want += int(in_x.sum() * in_y.sum()) * smoke.ENTRY_SAMPLE_OPS[cls]
                    any_x |= in_x
                    any_y |= in_y
                want += int(any_x.sum() * any_y.sum()) * smoke.ENTRY_PIXEL_OPS[cls]
    assert want > 0
    assert smoke.entry_ops(coverage, spec, prepared, desc_i) == want


def test_plain_work_counts_the_blended_samples(frame):
    smoke = _chip_smoke()
    spec, runtime = frame
    args = smoke.raster_args(coverage, spec, runtime)
    work = {}
    counted = coverage.rasterize_plain(*args, work=work)
    assert torch.equal(counted, coverage.rasterize_plain(*args))
    # One opaque cover draw blends each covered sample once: the resolved
    # alpha times S is the number of blended samples.
    blended = float(counted[:, 3].sum()) * spec.samples
    assert work["blend"] == pytest.approx(blended, rel=1e-6)
    assert work["blend"] > 0
    assert "depth" not in work and "paint" not in work
    bound_ms, bound_by, nbytes, ops = smoke.kernel_bound(coverage, spec, runtime)
    assert bound_by in ("bytes", "operations") and nbytes > 0 and ops > 0
    assert bound_ms == pytest.approx(
        max(nbytes / smoke.PEAK_BYTES_S, ops / smoke.PEAK_F32_OPS_S) * 1e3
    )


def test_plain_work_counts_depth_and_paints():
    smoke = _chip_smoke()
    size = 64
    renderer = Renderer(
        Configuration(depth_compare="less_equal", depth_write_enabled=True),
        size, size, device="cpu",
    )
    spec, _, runtime = renderer._prepare(scenes.mixed_paints(size, size))
    args = smoke.raster_args(coverage, spec, runtime)
    work = {}
    coverage.rasterize_plain(*args, work=work)
    # Depth is tested at every sample that reaches the compare; the
    # samples that pass are blended, the gradient's and the checker's
    # among them.
    assert work["depth"] >= work["blend"] > 0
    draws = coverage.draw_tables(spec)
    codes = {int(runtime[1][int(draws.c_cmd[d]), 3]) for d in work["paint"]}
    assert codes == {1, 3}
    assert sum(work["paint"].values()) < work["blend"]
    solid_only = dict(work, paint={})
    assert smoke.cover_ops(coverage, spec, runtime, draws, work) > smoke.cover_ops(
        coverage, spec, runtime, draws, solid_only
    )
