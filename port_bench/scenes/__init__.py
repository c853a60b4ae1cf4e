"""Scene builders: one module per kind of scene, named by a
configuration's ``"scene"`` key.

A builder module defines

- ``build(params, lib)``: a :class:`port_bench.harness.traffic.Scene`
  (the draw commands, and ``set_phase(phase)`` animating the dash phase)
  made with ``lib``'s types, the port's or the reference's, from the
  configuration's ``params``;
- ``transforms(params, angle)``: the (R, 4, 4) float32 stack of the
  commands' transforms (one row per command instance, in order) under
  the camera turned by ``angle`` radians;
- ``DASH_PERIOD``-like numbers are read from ``params``.

A builder imports nothing of the port: the harness hands it the port's
names (``harness/port_lib.py``) or the reference's
(``reference/scene.lib``), so both sides are built from one recipe.
"""
