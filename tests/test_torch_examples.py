"""The port's examples (``contrast_renderer_tpu_torch.examples``) on the
CPU: the HTTP viewer, the orbit app through ``FrameLoop``, and the
showcase and gradient scripts writing PNGs."""

import math
import threading
import urllib.request

import numpy as np
import pytest
import torch

from contrast_renderer_tpu_torch.app import CollectSink, FrameLoop
from contrast_renderer_tpu_torch.examples import (
    gradients,
    orbit_camera,
    render_showcase,
    viewer_server,
)
from contrast_renderer_tpu_torch.models import showcase
from contrast_renderer_tpu_torch.renderer import Configuration, Renderer
from contrast_renderer_tpu_torch.utils.png import read_png
from test_torch_instance import one_thread  # noqa: F401

SIZE = 64


def test_viewer_serves_page_and_frames_on_localhost():
    session = viewer_server.ShowcaseSession(
        SIZE, SIZE, with_text=False, scout_frames=2, device="cpu"
    )
    server = viewer_server.make_server(session, port=0)
    host, port = server.server_address[:2]
    assert host == "127.0.0.1"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(base + "/", timeout=60).read().decode()
        assert "<canvas" in page and str(SIZE) in page
        frames = []
        for query in ("yaw=0.3&pitch=0.1&dist=5&t=0.5",
                      "yaw=1.1&pitch=0.4&dist=7&t=1.0"):
            raw = urllib.request.urlopen(
                f"{base}/frame?{query}", timeout=300).read()
            assert len(raw) == SIZE * SIZE * 4
            frame = np.frombuffer(raw, np.uint8).reshape(SIZE, SIZE, 4)
            assert (frame[..., 3] == 255).all()  # composited over white
            assert frame[..., :3].min() < 250  # some ink rendered
            frames.append(raw)
        assert frames[0] != frames[1]  # another camera, another frame
        meta = urllib.request.urlopen(base + "/meta", timeout=60).read()
        assert b'"width": 64' in meta
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_orbit_app_frames_equal_frame_program_renders():
    """The orbit app through FrameLoop (a drag, a wheel event, a resize)
    presents the frames a separately built FrameProgram renders under
    the same camera and dash phase, as RGBA8."""
    app = orbit_camera.ShowcaseOrbitApp(with_text=False)
    sink = CollectSink()
    loop = FrameLoop(app, SIZE, SIZE, sink=sink,
                     renderer=Renderer(Configuration(), SIZE, SIZE, device="cpu"))
    loop.send_button(True)
    loop.send_pointer(0.0, 0.0)
    reference = Renderer(Configuration(), SIZE, SIZE, device="cpu")
    program = None
    yaws = []
    for index in range(3):
        loop.send_pointer(12.0 * (index + 1), 4.0 * math.sin(index))
        if index == 1:
            loop.send_wheel(-2.0)
            loop.request_resize(SIZE, SIZE // 2)
            reference.resize(SIZE, SIZE // 2)
            program = None
        presented = loop.step()
        yaws.append(app.yaw)
        if program is None:
            program = reference.compile_frame(showcase.showcase_commands(
                app._shape, reference.width, reference.height))
        # The app set the frame's dash phase on its shape; the program
        # renders with it.
        want = Renderer._quantize(program(app.transforms(reference))).numpy()
        assert presented.shape == (reference.height, SIZE, 4)
        assert np.array_equal(presented, want), index
        assert (presented[..., 3] > 0).any()
    assert len(sink.frames) == 3 and yaws[0] < yaws[-1]
    assert app.distance > 5.0


def test_render_showcase_writes_pngs(tmp_path):
    render_showcase.main(["--device", "cpu", "--size", "64x64", "--frames", "2",
                          "--no-text", "--out", str(tmp_path)])
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == ["frame_0000.png", "frame_0001.png"]
    first = read_png(str(tmp_path / written[0]))
    assert first.shape == (SIZE, SIZE, 4) and (first[..., 3] > 0).any()


def test_gradients_writes_its_card(tmp_path):
    out = tmp_path / "card.png"
    gradients.main(["--device", "cpu", "--size", "64x64", "--out", str(out)])
    image = read_png(str(out))
    assert image.shape == (SIZE, SIZE, 4)
    assert (image[..., 3] == 255).all()  # over white
    assert (image[..., :3] < 200).any()  # the card's dark end


def test_examples_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gradients.main(["--size", "64x64", "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer_server.ShowcaseSession(SIZE, SIZE, with_text=False, scout_frames=0)
