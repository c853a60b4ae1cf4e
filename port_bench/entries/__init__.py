"""The port's entry points that a window drives, one module per traffic
``entry`` (``port_bench/entries/<entry>.py``), found by name.

A module defines ``Entry(config, scene, stacks, schedule, device)``: it
sets up its renderer from the configuration (``harness.port_lib.
renderer``) and the scene, and has

- ``warm(cycles)``: plays every camera position of the path ``cycles``
  times (set-up);
- ``__call__(n)``: issues frame n of the window and returns its packed
  RGBA8 (H, W, 4) uint8 tensor on the device (the presentation path);
- ``spans()``: the program's own host spans of the last frame (ms);
- ``captured()``: whether the last frame captured a CUDA graph;
- ``describe()``: one line on its state, for the log.
"""
