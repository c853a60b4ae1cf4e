"""The benchmark's plain reference: a frozen copy of the geometry
(``geometry/``), the reference's shapes and commands (``scene``) and the
renderer (``raster``).  It imports nothing of the port and nothing of
JAX or the JAX package."""
