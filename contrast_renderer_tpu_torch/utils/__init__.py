"""Foundation math: projective geometric algebra, polynomial solvers,
matrices, color conversion.

Replaces the reference's external `geometric_algebra` crate (Cargo.toml:18)
with small vectorizable numpy modules, re-derived from projective geometric
algebra; no code is shared with the reference.
"""

from . import color, ga2d, ga3d, matrix, polynomial  # noqa: F401
