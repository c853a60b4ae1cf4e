"""The graph memory pools of the port's frame steps, on the CPU, with a
stubbed pool factory.

PyTorch's allocator gives a CUDA graph pool up once every graph captured
into it is freed, and then refuses a capture into it.  So an owner that
evicts a step whose graph was captured starts a new pool
(``renderer._GraphPool``), and a step reads its owner's pool when it
captures, not when it was made.  Here ``renderer._new_graph_pool`` hands
out numbered pools, and a step stands for a captured one by holding a
graph: the pool is renewed exactly when an eviction drops such a step,
by ``Renderer``'s binning steps (least recently used) and by
``FrameProgram.plan_for_motion`` (the oldest grouping).  The captures
themselves run on the card (tests/test_torch_cuda.py)."""

import itertools

import pytest

from contrast_renderer_tpu_torch import renderer as port
from test_torch_frame_program import circle, pairs, renderer, stack
from test_torch_instance import one_thread  # noqa: F401
from test_torch_frame_program_hysteresis import APART, MOVED, THIRD

CAPTURED = object()
SHAPE = circle(3.0)


@pytest.fixture(autouse=True)
def numbered_pools(monkeypatch):
    """Every new pool a number of its own."""
    counter = itertools.count(1)
    monkeypatch.setattr(port, "_new_graph_pool", lambda device: next(counter))


def circles(n, shift=0.0):
    """``n`` circles in a row: a spec (and so a binning key) per ``n``."""
    return pairs(SHAPE, [(8 * i + shift, 8 * i) for i in range(n)])


def test_bin_step_eviction_renews_the_pool_when_it_frees_a_graph():
    """With room for two binning steps: evicting a step that captured
    renews the renderer's pool, evicting one that only warmed up does
    not, and every step (the one made before the renewal too) holds the
    renderer's pool object, whose handle it reads when it captures."""
    r = renderer(auto_instance=False)
    r.MAX_BIN_STEPS = 2
    pool = r._pool
    r.render(circles(1))
    r.render(circles(2))
    steps = list(r._bin_steps.values())
    assert len(steps) == 2 and all(s._pool is pool for s in steps)
    steps[0].graph = CAPTURED           # key 1 captured, key 2 warmed up
    handle = pool.handle
    r.render(circles(3))                # evicts key 1: its graph goes
    assert r._pool is pool and pool.handle != handle
    handle = pool.handle
    assert next(iter(r._bin_steps.values())) is steps[1]
    assert steps[1]._pool.handle == handle
    r.render(circles(4))                # evicts key 2: no graph
    r.render(circles(1, shift=1.0))     # evicts key 3: no graph
    assert pool.handle == handle
    assert all(s._pool is pool for s in r._bin_steps.values())


def test_rebuilt_scene_drops_its_step_like_an_eviction():
    """A key whose scene was built anew drops its old step: a captured
    one renews the pool as an eviction does."""
    r = renderer(auto_instance=False)
    r.render(circles(2))
    (step,) = r._bin_steps.values()
    step.graph = CAPTURED
    step.scene_arrays = (object(),) + tuple(step.scene_arrays[1:])
    handle = r._pool.handle
    r.render(circles(2, shift=1.0))
    assert r._pool.handle != handle
    (new,) = r._bin_steps.values()
    assert new is not step and new.graph is None


def test_plan_eviction_renews_the_pool_when_it_frees_a_graph():
    """plan_for_motion over MAX_FUSED_VARIANTS + 1 plans, with room for
    two groupings: the third plan evicts the oldest grouping; the pool
    is renewed when that grouping's step had captured, and not when it
    had no step or no graph.  Steps made before the renewal hold the
    program's pool object."""
    program = renderer().compile_frame(APART)
    program.MAX_FUSED_VARIANTS = 2
    pool = program._pool
    plans = ([stack(APART)], [stack(MOVED)], [stack(THIRD)])
    assert all(program.plan_for_motion(p) for p in plans[:2])
    variants = [v for _, v in program._fused_variants.values()]
    assert len(variants) == 2 and all(v.step is not None for v in variants)
    assert all(v.step._pool is pool for v in variants)
    variants[0].step.graph = CAPTURED
    handle = pool.handle
    assert program.plan_for_motion(plans[2])
    assert program._pool is pool and pool.handle != handle
    handle = pool.handle
    assert variants[1].step._pool.handle == handle
    # The next eviction drops a step that never captured (the capacity
    # scouts' pools of their own leave the program's alone).
    assert program.plan_for_motion(plans[0])
    assert pool.handle == handle
    assert len(program._fused_variants) == 2
