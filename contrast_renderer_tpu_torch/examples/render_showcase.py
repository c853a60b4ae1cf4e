"""Render the showcase scene to PNG frames, with the
reference's rolling-average frame timing.

The port's counterpart of examples/render_showcase.py: instead of
presenting to a surface, frames are written as PNGs, and the per-frame
time plus a 64-frame rolling average is logged as
application_framework.rs:251-259 does.

Usage:
    python -m contrast_renderer_tpu_torch.examples.render_showcase \\
        [--size WxH] [--frames N] [--out DIR] [--no-text] [--depth] \\
        [--save-every N] [--device cuda|cpu]
"""

import argparse
import logging
import os
import tempfile

from ..models import showcase
from ..renderer import Configuration, Renderer
from ..utils.png import write_png
from ..utils.profiling import FrameTimer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="1920x1080")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "showcase_frames")
    )
    parser.add_argument("--no-text", action="store_true")
    parser.add_argument("--depth", action="store_true",
                        help="the reference showcase's depth state "
                             "(LessEqual + write, main.rs:46-49)")
    parser.add_argument("--save-every", type=int, default=1,
                        help="write every Nth frame as PNG")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s %(name)s: %(message)s"
    )
    log = logging.getLogger("showcase")

    width, height = (int(x) for x in args.size.split("x"))
    os.makedirs(args.out, exist_ok=True)

    config = (
        Configuration(depth_compare="less_equal", depth_write_enabled=True)
        if args.depth
        else Configuration()
    )
    renderer = Renderer(config, width, height, device=args.device)
    shape = showcase.build_shape(with_text=not args.no_text)
    commands = showcase.showcase_commands(shape, width, height)

    timer = FrameTimer(log=True)
    for index in range(args.frames):
        with timer.frame():
            # Dash-phase animation (main.rs:155-161): only the
            # descriptor table changes — geometry and binning are reused.
            shape.set_dynamic_stroke_options(
                0, showcase.dashed_options(index * 0.032)
            )
            # uint8 quantization on the device: 4x less to fetch.
            image = renderer.render(commands, as_uint8=True)
        if index == 0:
            log.info("scene stats: %s", renderer.stats)
        if index % args.save_every == 0:
            path = os.path.join(args.out, f"frame_{index:04d}.png")
            write_png(path, image)
    log.info("wrote frames to %s", args.out)


if __name__ == "__main__":
    main()
