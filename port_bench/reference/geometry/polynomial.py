"""Closed-form polynomial solvers with homogeneous roots.

Replaces `geometric_algebra::polynomial::{Root, solve_linear,
solve_quadratic, solve_cubic, solve_quartic}` (used by the reference at
src/curve.rs:8, src/fill.rs:12).

All solvers take coefficients in ascending power order
(``c[0] + c[1]*t + c[2]*t² + ...``) and return ``(discriminant, roots)``;
:func:`solve_cubic` additionally returns the index of a root guaranteed to
be real.  Roots are homogeneous: the parameter value is
``numerator.real / denominator``; a zero denominator encodes a root at
infinity (produced when leading coefficients vanish), which callers skip.

Discriminant sign conventions (relied on by the cubic-curve classifier,
reference src/curve.rs:151-226 and src/fill.rs:14-32):

- quadratic: ``c1² - 4·c0·c2`` — positive ⇔ two distinct real roots.
- cubic: the standard algebraic discriminant — positive ⇔ three distinct
  real roots (serpentine), negative ⇔ one real root (loop), zero ⇔
  repeated root (cusp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Root:
    """A homogeneous, possibly complex polynomial root."""

    numerator: complex
    denominator: float

    @property
    def real(self) -> float:
        """The real parameter value (callers check denominator != 0)."""
        return self.numerator.real / self.denominator

    @property
    def is_finite(self) -> bool:
        return self.denominator != 0.0


#: A root at infinity (denominator zero); used to pad fixed-size root lists.
ROOT_AT_INFINITY = Root(complex(1.0, 0.0), 0.0)


def solve_linear(coefficients, tolerance):
    """Roots of c0 + c1·t = 0."""
    c0, c1 = coefficients
    if abs(c1) <= tolerance:
        return (0.0, [])
    return (1.0, [Root(complex(-c0, 0.0), c1)])


def solve_quadratic(coefficients, tolerance):
    """Roots of c0 + c1·t + c2·t² = 0.

    Returns 2 roots when the discriminant is positive beyond `tolerance`,
    1 root for a (near-)double root, a complex-conjugate pair when
    negative, and degrades to linear when the leading coefficient
    vanishes.
    """
    c0, c1, c2 = coefficients
    if abs(c2) <= tolerance:
        return solve_linear((c0, c1), tolerance)
    discriminant = c1 * c1 - 4.0 * c0 * c2
    if abs(discriminant) <= tolerance:
        return (discriminant, [Root(complex(-c1, 0.0), 2.0 * c2)])
    if discriminant > 0.0:
        sq = math.sqrt(discriminant)
        # Numerically stable split: q has the sign that avoids cancellation.
        q = -0.5 * (c1 + math.copysign(sq, c1))
        if q == 0.0:
            roots = [Root(complex(-c1 + sq, 0.0), 2.0 * c2),
                     Root(complex(-c1 - sq, 0.0), 2.0 * c2)]
        else:
            roots = [Root(complex(q, 0.0), c2), Root(complex(c0, 0.0), q)]
        return (discriminant, roots)
    sq = math.sqrt(-discriminant)
    return (
        discriminant,
        [Root(complex(-c1, sq), 2.0 * c2), Root(complex(-c1, -sq), 2.0 * c2)],
    )


def _poly_roots(coefficients):
    """All complex roots of a polynomial given ascending coefficients,
    via the companion matrix (numpy)."""
    return np.roots(list(reversed(coefficients)))


def solve_cubic(coefficients, tolerance):
    """Roots of c0 + c1·t + c2·t² + c3·t³ = 0.

    Returns ``(discriminant, [Root; 3], real_root_index)``.  When the
    leading coefficient vanishes the missing root is at infinity.
    """
    c0, c1, c2, c3 = coefficients
    if abs(c3) <= tolerance:
        discriminant, roots = solve_quadratic((c0, c1, c2), tolerance)
        roots = list(roots) + [ROOT_AT_INFINITY] * (3 - len(roots))
        return (discriminant, roots, 0)
    # Standard algebraic discriminant (a=c3, b=c2, c=c1, d=c0).
    a, b, c, d = c3, c2, c1, c0
    discriminant = (
        18.0 * a * b * c * d
        - 4.0 * b**3 * d
        + b**2 * c**2
        - 4.0 * a * c**3
        - 27.0 * a**2 * d**2
    )
    raw = _poly_roots(coefficients)
    # Order: most-real first so `real_root_index` can point at a root that
    # is genuinely real when the discriminant is negative.
    order = np.argsort(np.abs(raw.imag))
    raw = raw[order]
    roots = [Root(complex(r.real, r.imag), 1.0) for r in raw]
    return (discriminant, roots, 0)


def solve_quartic(coefficients, tolerance):
    """Roots of c0 + ... + c4·t⁴ = 0.

    Returns ``(discriminant_sign_proxy, roots)``; roots at infinity pad
    the list when leading coefficients vanish.  Near-real roots are
    ordered first (callers scan for the first real root in [0, 1],
    reference src/curve.rs:239-248).
    """
    c0, c1, c2, c3, c4 = coefficients
    if abs(c4) <= tolerance:
        discriminant, roots, _ = solve_cubic((c0, c1, c2, c3), tolerance)
        return (discriminant, list(roots) + [ROOT_AT_INFINITY])
    raw = _poly_roots(coefficients)
    order = np.argsort(np.abs(raw.imag))
    raw = raw[order]
    roots = [Root(complex(r.real, r.imag), 1.0) for r in raw]
    return (1.0, roots)


def real_roots_in_unit_interval(roots, tolerance=1e-7):
    """Finite near-real roots with parameter in [0, 1], as plain floats."""
    out = []
    for root in roots:
        if root.denominator == 0.0:
            continue
        if abs(root.numerator.imag) > tolerance * max(1.0, abs(root.numerator.real)):
            continue
        t = root.numerator.real / root.denominator
        if 0.0 <= t <= 1.0:
            out.append(t)
    return out
