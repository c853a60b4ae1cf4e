"""Gradient paints demo: a card with a linear-gradient fill, a radial
glow and gradient text, written to PNG.

The port's counterpart of examples/gradients.py; its frame is
``scenes.gradient_card``'s (renderer.LinearGradient / RadialGradient,
the paint extension over the reference's solid-only colour cover,
shaders.wgsl:304-309), composited over white.

Usage:
    python -m contrast_renderer_tpu_torch.examples.gradients \\
        [--size WxH] [--out PATH] [--no-text] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

from .. import scenes
from ..renderer import Configuration, Renderer
from ..utils.png import write_png


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="480x270")
    parser.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "gradients.png")
    )
    parser.add_argument("--no-text", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)
    width, height = (int(x) for x in args.size.split("x"))

    commands, _ = scenes.gradient_card(
        width, height, with_text=not args.no_text
    )
    renderer = Renderer(Configuration(), width, height, device=args.device)
    image = renderer.render(
        commands, background=(1.0, 1.0, 1.0, 1.0), as_uint8=True
    )
    write_png(args.out, image)
    print(f"wrote {args.out} ({width}x{height})")


if __name__ == "__main__":
    main()
