"""The port's frame loop (``app.py``), PNG sink and frame timer against the
JAX package's.

tests/test_app.py's MovingRectApp is built in each package's own types;
one scripted run (pointer and button events, a resize, the background
composite, a CollectSink) must present the same RGBA8 frames through
both packages' ``FrameLoop``.  The port renders on the CPU, through a
renderer passed in with ``device="cpu"``."""

import numpy as np
import pytest
import torch

from contrast_renderer_tpu import app as ref_app
from contrast_renderer_tpu import path as ref_path
from contrast_renderer_tpu import renderer as ref_renderer
from contrast_renderer_tpu.utils import png as ref_png
from contrast_renderer_tpu.utils import profiling as ref_profiling
from contrast_renderer_tpu_torch import app
from contrast_renderer_tpu_torch import path as port_path
from contrast_renderer_tpu_torch import renderer as port_renderer
from contrast_renderer_tpu_torch.utils import png, profiling
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64
WHITE = (1.0, 1.0, 1.0, 1.0)


def ortho(width, height):
    t = np.diag([2.0 / width, 2.0 / height, 1.0, 1.0]).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0
    return t


def moving_rect_app(app_module, path_module, api):
    """tests/test_app.py's MovingRectApp in one package's types: a rect
    whose x position follows the pointer, red while the button is held,
    green otherwise."""

    class MovingRectApp(app_module.Application):
        def __init__(self):
            self.x = 16.0
            self.pressed = False
            self.created = 0
            self.resized = 0
            self.shape = api.Shape([path_module.Path.from_rect((0.0, 0.0), (8.0, 8.0))])

        def create(self, renderer):
            self.created += 1

        def resize(self, renderer):
            self.resized += 1

        def pointer_moved(self, x, y):
            self.x = x

        def pointer_button(self, pressed):
            self.pressed = pressed

        def render(self, renderer, frame_index, time_s):
            t = ortho(renderer.width, renderer.height)
            t[0, 3] += 2.0 * self.x / renderer.width
            t[1, 3] += 1.0  # vertical center
            color = (1.0, 0.0, 0.0, 1.0) if self.pressed else (0.0, 1.0, 0.0, 1.0)
            return renderer.render(
                [
                    api.DrawCommand(api.RenderOperation.STENCIL, self.shape, t),
                    api.DrawCommand(api.RenderOperation.COLOR, self.shape, t,
                                    color=color),
                ],
                to_host=False,
            )

    return MovingRectApp()


def script(loop):
    """Three frames: as built; after a pointer move and a button press;
    after a resize to 64x32."""
    frames = [loop.step()]
    loop.send_pointer(48.0, 32.0)
    loop.send_button(True)
    frames.append(loop.step())
    loop.request_resize(SIZE, SIZE // 2)
    frames.append(loop.step())
    return frames


def port_loop(**kw):
    the_app = moving_rect_app(app, port_path, port_renderer)
    renderer = port_renderer.Renderer(
        port_renderer.Configuration(), SIZE, SIZE, device="cpu"
    )
    return the_app, app.FrameLoop(the_app, SIZE, SIZE, renderer=renderer, **kw)


def test_frames_equal_the_reference_loop():
    """Events, the resize, the background composite and the CollectSink:
    the presented RGBA8 frames equal the JAX package's, to the bit."""
    ref_sink, sink = ref_app.CollectSink(), app.CollectSink()
    ref_the_app = moving_rect_app(ref_app, ref_path, ref_renderer)
    want = script(ref_app.FrameLoop(ref_the_app, SIZE, SIZE, sink=ref_sink,
                                    background=WHITE))
    the_app, loop = port_loop(sink=sink, background=WHITE)
    got = script(loop)
    assert loop.background.device == loop.renderer.device
    for index, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, index
        assert np.array_equal(a, b), index
    assert [f.shape for f in sink.frames] == [(SIZE, SIZE, 4)] * 2 + [(SIZE // 2, SIZE, 4)]
    for a, b in zip(ref_sink.frames, sink.frames):
        assert np.array_equal(a, b)
    assert (the_app.created, the_app.resized) == (ref_the_app.created,
                                                  ref_the_app.resized) == (1, 1)
    # Over white: the background outside the rect, red inside it.
    assert tuple(got[0][2, 60]) == (255, 255, 255, 255)
    assert tuple(got[1][32, 48]) == (255, 0, 0, 255)


def test_events_resize_and_sink_without_background():
    """tests/test_app.py::test_events_resize_and_sink, on the port."""
    sink = app.CollectSink()
    the_app, loop = port_loop(sink=sink)
    assert the_app.created == 1
    frame0, frame1, frame2 = script(loop)
    assert frame0.shape == (SIZE, SIZE, 4) and frame0.dtype == np.uint8
    assert frame0[32, 16, 1] == 255 and frame0[32, 16, 3] == 255
    assert frame0[32, 48, 3] == 0
    assert frame1[32, 48, 0] == 255 and frame1[32, 16, 3] == 0
    assert the_app.resized == 1 and frame2.shape == (SIZE // 2, SIZE, 4)
    assert frame2[16, 48, 0] == 255
    assert len(sink.frames) == 3
    assert loop.timer.frame_index == 3 and loop.timer.average_s > 0


def test_png_sink_files_read_back(tmp_path):
    sink = app.PngSink(str(tmp_path), every=2)
    collect = app.CollectSink()

    def both(image, index):
        sink(image, index)
        collect(image, index)

    _, loop = port_loop(sink=both)
    loop.run(5)
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]
    for name in written:
        index = int(name[6:11])
        back = png.read_png(str(tmp_path / name))
        assert np.array_equal(back, collect.frames[index])
        assert np.array_equal(back, ref_png.read_png(str(tmp_path / name)))


def test_frame_timer_matches_the_reference(monkeypatch):
    """The same scripted clock through both timers: the rolling window
    of 64 frames, the average and the fps."""
    durations = [0.001 * (1 + (i % 7)) for i in range(80)]

    def run(module):
        ticks = iter(np.cumsum([[0.0, d] for d in durations]).tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.FrameTimer()
        for _ in durations:
            with timer.frame():
                pass
        return timer

    want, got = run(ref_profiling), run(profiling)
    assert got.frame_index == want.frame_index == 80
    assert got.last_s == want.last_s
    assert got.average_s == pytest.approx(np.mean(durations[-64:]), rel=1e-12)
    assert (got.average_s, got.fps) == (want.average_s, want.fps)
    assert profiling.FrameTimer().fps == 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    trace = tmp_path / profiling.TRACE_FILE
    assert trace.exists() and trace.stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_frame_loop_builds_its_renderer_on_the_card():
    """With no renderer passed, FrameLoop builds one on the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal needs none")
    the_app = moving_rect_app(app, port_path, port_renderer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.FrameLoop(the_app, SIZE, SIZE)
