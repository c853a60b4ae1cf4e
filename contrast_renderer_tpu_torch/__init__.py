"""contrast_renderer_tpu_torch — the PyTorch/CUDA port of
``contrast_renderer_tpu``.

The JAX package stays the reference.  This package reproduces its
rendering path in PyTorch, with the coverage kernel written by hand in
CUDA C++ for Hopper (``csrc/``).  It imports torch and never jax; the
host modules that never import jax (``path``, ``curve``, ``fill``,
``stroke``, ``vertex``, ``convex_hull``, ``dynamic_stroke``, ``error``,
``oracle``, ``assets``, ``native``, ``utils``) are shared from
``contrast_renderer_tpu`` rather than copied.

Ported so far: filled paths with solid colour through
``Renderer.render`` (see ROADMAP.md for what follows).
"""

__version__ = "0.1.0"

from contrast_renderer_tpu.error import (  # noqa: F401
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
    "RenderOperation", "Renderer", "Shape",
}


def __getattr__(name):
    # Renderer names load torch on first use, not at package import.
    if name in _RENDERER_NAMES:
        from . import renderer

        return getattr(renderer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
