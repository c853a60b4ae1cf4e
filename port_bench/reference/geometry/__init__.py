"""Frozen plain geometry for the benchmark's reference renderer.

A copy of the port's host modules that derive triangles from paths:
paths and their segments (``path``), Bezier algebra (``curve``,
``polynomial``), the fill and stroke tessellators (``fill``,
``stroke``, ``vertex``), stroke descriptors (``dynamic_stroke``),
2D/3D algebra and camera matrices (``ga2d``, ``ga3d``, ``matrix``), and
TrueType outlines with text layout (``ttf``, ``text``).  Pure Python and numpy; nothing here imports the
port, so a change to the port's tessellation cannot move the reference.
"""
