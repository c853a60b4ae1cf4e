"""The window's arithmetic on synthetic clocks: the rate is taken over the
whole window, the tail over all of its intervals, so that one stall
shows; the traffic's schedule and sample are fixed by the seed."""

import itertools
import statistics

import numpy as np
import pytest

from port_bench.harness import traffic, window


class FakeClock:
    """A device whose frames complete at given times; waiting on a frame
    moves the host clock past its completion."""

    cuda = False

    def __init__(self, completions):
        self.completions = iter(completions)
        self.marks = []

    def mark(self):
        t = next(self.completions)
        self.marks.append(t)
        return t

    def start(self):
        # A frame that starts at once: no time between the frame before's
        # completion and its start.
        return self.marks[-1] if self.marks else 0.0

    def wait(self, mark):
        pass

    def sync(self):
        pass

    def interval_ms(self, a, b):
        return (b - a) * 1e3


def test_tail_over_all_intervals_shows_one_stall(monkeypatch):
    # 1,000 frames 5 ms apart, one of them stalled by 50 ms, then more
    # stalls: the p99 over all intervals sees the stalls that a median of
    # 99-frame windows would hide.
    gaps = [0.005] * 1000
    for i in range(0, 1000, 90):
        gaps[i] = 0.050
    times = list(itertools.accumulate(gaps))
    clock = FakeClock(times)
    host = iter(np.arange(0.0, 10.0, 0.001))
    monkeypatch.setattr(window.time, "perf_counter", lambda: float(next(host)))
    w = window.run(lambda n: None, 0.999, clock, in_flight=2)
    assert w.frames == len(w.intervals_ms) + 1
    p99 = window.percentile(w.intervals_ms, 99)
    assert p99 == pytest.approx(50.0)
    chunks = [statistics.median(w.intervals_ms[i:i + 99])
              for i in range(0, len(w.intervals_ms) - 98, 99)]
    assert max(chunks) == pytest.approx(5.0)


def test_rate_is_frames_over_the_whole_window(monkeypatch):
    ticks = iter([0.0] + [0.1 * k for k in range(1, 200)])
    monkeypatch.setattr(window.time, "perf_counter", lambda: next(ticks))
    w = window.run(lambda n: None, 1.0, FakeClock(itertools.count()), in_flight=2)
    # The loop reads the clock at 0.1, ..., 0.9 and issues a frame after
    # each (nine frames); at 1.0 the window is over, and the closing
    # synchronise reads 1.1 s: the rate counts that tail too.
    assert w.frames == 9
    assert w.seconds == pytest.approx(1.1)
    assert w.frames / w.seconds == pytest.approx(9 / 1.1)


def test_two_frames_in_flight():
    waited = []

    class Clock(FakeClock):
        def wait(self, mark):
            waited.append(mark)

    clock = Clock(itertools.count())
    issued = []
    window.run(lambda n: issued.append(n), 0.05, clock, in_flight=2)
    # Frame n waits for frame n - 2's completion mark before it issues.
    assert waited == list(range(len(issued) - 2))


def test_device_idle_counts_the_waits_for_the_host(monkeypatch):
    """Frames of 2 ms on the device; from frame 50 on, the host reaches
    each next frame 0.5 ms after the frame before has completed.  The
    traced stretch (frames 20-29) is left out."""
    from port_bench.harness import cell as cell_mod

    done, starts = [], []

    class Clock(FakeClock):
        def mark(self):
            n = len(done)
            t = (done[-1] if done else 0.0) + (0.0005 if n >= 50 else 0.0) + 0.002
            done.append(t)
            return t

        def start(self):
            n = len(done)
            s = (done[-1] if done else 0.0) + (0.0005 if n >= 50 else 0.0)
            starts.append(s)
            return s

    ticks = itertools.count()
    monkeypatch.setattr(window.time, "perf_counter", lambda: float(next(ticks)))
    w = window.run(lambda n: None, 100.5, Clock(()), in_flight=2)
    assert w.frames == 100 and len(w.gaps_ms) == len(w.intervals_ms) == 99
    assert w.gaps_ms[:49] == pytest.approx([0.0] * 49)
    assert w.gaps_ms[49:] == pytest.approx([0.5] * 50)
    w.traced = list(range(20, 30))
    run = type("Run", (), {"window": w})()
    reader = cell_mod.load_module(cell_mod.BENCH_DIR / "metrics" / "device_idle.py", "idle")
    kept = [k for k in range(99) if not {k, k + 1} & set(w.traced)]
    idle = sum(w.gaps_ms[k] for k in kept) / sum(w.intervals_ms[k] for k in kept)
    assert reader.read(run) == pytest.approx(100.0 * idle)
    # 38 untraced intervals of 2 ms with no wait, 50 of 2.5 ms with 0.5.
    assert reader.read(run) == pytest.approx(100.0 * 50 * 0.5 / (38 * 2.0 + 50 * 2.5))


def test_percentile_interpolates_between_order_statistics():
    assert window.percentile(range(101), 99) == pytest.approx(99.0)
    assert window.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


@pytest.mark.parametrize("path", ["loop", "bounce"])
def test_schedule_is_fixed_by_the_seed_and_covers_the_path(path):
    t = {"path_frames": 99, "path": path, "turn_per_frame": 0.05,
         "dash_per_frame": {"uniform": [0.01, 0.05]}}
    a, b = traffic.Schedule(t, 2**33 + 7, 4.0), traffic.Schedule(t, 2**33 + 7, 4.0)
    c = traffic.Schedule(t, 11, 4.0)
    assert [a.phase(n) for n in range(50)] == [b.phase(n) for n in range(50)]
    assert [a.phase(n) for n in range(50)] != [c.phase(n) for n in range(50)]
    assert all(0.0 <= a.phase(n) < 4.0 for n in range(500))
    # Every seed shows the same set of positions, in another order.
    cycle = 99 if path == "loop" else 196
    seen = [a.position(n) for n in range(cycle)]
    assert sorted(set(seen)) == list(range(99))
    assert sorted(seen) == sorted(c.position(n) for n in range(cycle))
    steps = {abs(p - q) for p, q in zip(seen, seen[1:])}
    # A bounce never jumps: each frame moves one position or turns back.
    assert steps == ({1} if path == "bounce" else {1, 98})


def test_camera_stack_turns_then_pans_on_screen():
    """pan_per_frame moves the picture by that many pixels a position, under
    the pixel-space camera and under the showcase's perspective one."""
    from port_bench.scenes import pixel_space, showcase

    traffic_file = {"turn_per_frame": 0.0, "pan_per_frame": [2.0, -1.0]}
    flat = {"width": 320.0, "height": 200.0}
    deep = {**flat, "camera": {"fov": 1.5, "near": 1.0, "far": 100.0, "distance": 5.0},
            "grid": {"rows": 1, "columns": 1, "spacing": [1.0, 1.0], "z": -5.0}}
    for scene, params, row, point in ((pixel_space, flat, 0, (10.0, 20.0, 0.0, 1.0)),
                                      (showcase, deep, 2, (0.3, -0.2, 0.0, 1.0))):
        base = traffic.camera_stack(scene, params, traffic_file, 0)[row].astype(np.float64)
        moved = traffic.camera_stack(scene, params, traffic_file, 3)[row].astype(np.float64)
        a, b = base @ np.array(point), moved @ np.array(point)
        shift = (b[:2] / b[3] - a[:2] / a[3]) * np.array([160.0, 100.0])
        assert shift == pytest.approx([6.0, -3.0], abs=1e-3)


def test_reservoir_keeps_a_uniform_sample_fixed_by_the_seed():
    def sample(seed, n=1000, k=4):
        r = traffic.Reservoir(k, seed)
        for i in range(n):
            r.offer(i, i)
        assert sorted(r.kept) == r.frames() and len(r.kept) == k
        assert all(r.kept[i] == i for i in r.kept)
        return r.frames()

    assert sample(5) == sample(5)
    firsts = np.concatenate([sample(s) for s in range(300)])
    # Each quarter of the window holds about a quarter of the sample.
    counts = np.histogram(firsts, bins=4, range=(0, 1000))[0]
    assert counts.min() > 0.8 * len(firsts) / 4
