"""contrast_renderer_tpu_torch — the PyTorch/CUDA port of
``contrast_renderer_tpu``.

The JAX package stays the reference.  This package reproduces its
rendering path in PyTorch, with the coverage kernel written by hand in
CUDA C++ for Hopper (``csrc/``).  It imports torch and never jax, and
nothing of the JAX package: the host modules it needs (``path``,
``curve``, ``fill``, ``stroke``, ``vertex``, ``convex_hull``,
``dynamic_stroke``, ``error``, ``oracle``, ``native``, ``text``,
``ttf``, ``cff``, ``assets``, ``utils``) are its own copies.

Ported so far: filled and stroked paths with solid, gradient and user
paints, clips, alpha groups and depth, instanced and multi-shape draws
with auto-instancing, text as shapes and draw commands, the deferred
capacity check and the ``carry`` probe, through ``Renderer.render``; and
the moving camera through ``Renderer.compile_frame`` (``FrameProgram``,
with its fusion planners, ``plan_for_motion`` and ``render_sequence``);
the frame loop (``app``), PNG output and frame timing (``utils.png``,
``utils.profiling``), the standalone fill rasterizer (``ops.raster``),
row-band and tile sharding over several devices (``parallel``) and the
examples (``examples``).
"""

__version__ = "0.1.0"

from .error import (  # noqa: F401
    ERROR_MARGIN,
    ClipStackOverflow,
    ContrastError,
    DynamicStrokeOptionsIndexOutOfBounds,
    FrameTooComplex,
    NumberOfStencilBitsIsUnsupported,
    TooManyDashIntervals,
    TooManyNestedOpacityGroups,
)

_RENDERER_NAMES = {
    "BlendComponent", "BlendState", "Configuration", "DrawCommand",
    "FrameProgram", "LinearGradient", "RadialGradient", "RenderOperation", "Renderer",
    "Shape", "UserPaint",
}

_TEXT_NAMES = {
    "Alignment", "Font", "Layout", "Orientation", "TextGeometry",
    "paths_of_text", "shape_of_text", "text_commands",
    "text_commands_fused",
}

_APP_NAMES = {"Application", "FrameLoop", "PngSink", "CollectSink"}


def __getattr__(name):
    # Renderer names load torch on first use, not at package import.
    if name in _RENDERER_NAMES:
        from . import renderer

        return getattr(renderer, name)
    if name in _TEXT_NAMES:
        from . import text

        return getattr(text, name)
    if name in _APP_NAMES:
        from . import app

        return getattr(app, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
