"""Native (C++) geometry kernels with ctypes bindings.

The reference's geometry layer is native Rust; this package provides the
equivalent native runtime for this renderer's hot host-side loops, built
on demand with g++ (no pip dependencies).  Falls back to the pure-Python
implementations transparently when no compiler is available.
"""

from .bindings import (  # noqa: F401
    available,
    convex_hull,
    eval_rational_cubic,
    eval_rational_quadratic,
    polyline_arc_length,
    tessellate_quadratic_paths,
)
