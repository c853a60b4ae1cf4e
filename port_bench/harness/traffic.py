"""The general traffic generator: which camera position and dash phase
each frame of a window shows, from a traffic file's parameters and the
run's seed.

A traffic file (``port_bench/traffic/<name>.json``) holds:

- ``entry``: the port's call that renders a frame, a module of
  ``port_bench/entries`` by name: ``"frame_program"``
  (``FrameProgram.__call__`` of a program planned over the camera path)
  or ``"render"`` (``Renderer.render``);
- ``path_frames``, ``turn_per_frame`` and ``pan_per_frame``: the camera
  path, that many positions; position k turns the scene's camera by
  k x ``turn_per_frame`` radians (the scene builder says about what) and
  then moves the picture on screen by k x ``pan_per_frame`` pixels
  ([x, y], default none);
- ``path``: ``"loop"`` (the default; frame n shows position
  (k0 + n) mod path_frames) or ``"bounce"`` (forward to the last
  position and back, so that the camera never jumps); k0 is drawn from
  the seed, so every seed shows the same positions in another order;
- ``dash_per_frame``: the dash phase's step a frame, a number or
  ``{"uniform": [lo, hi]}`` drawn per frame from the seed; the phase is
  kept modulo the scene's dash period (a scene without dashes ignores
  it);
- ``frames_in_flight``: frame n is issued once frame n - that many has
  completed;
- ``warm_cycles``: how many times set-up plays every path position;
- ``check_frames``: frames of the window kept for the comparison, drawn
  from the seed (reservoir sampling);
- ``trace_frames`` and ``trace_at``: the traced run profiles that many
  frames, from that share of the window on;
- ``roofline_frames``: the first that many traced frames are counted for
  the raster roofline (the reference renders each camera position among
  them once).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, List

import numpy as np


@dataclass
class Scene:
    """A scene built by a builder of ``port_bench/scenes``: its draw
    commands and the callable that sets its dash phase."""

    commands: List
    set_phase: Callable[[float], None]


def load(path):
    with open(path) as fh:
        return json.load(fh)


class Schedule:
    """Frame n's camera position and dash phase under one traffic mix and
    seed.  Phases are drawn as frames are asked for, in order, and kept,
    so that a frame can be shown again after the window."""

    def __init__(self, traffic, seed, dash_period):
        self.traffic = traffic
        self.rng = np.random.default_rng([seed, 0x7261666669])
        self.path_frames = int(traffic["path_frames"])
        self.bounce = traffic.get("path", "loop") == "bounce" and self.path_frames > 1
        self.cycle = 2 * (self.path_frames - 1) if self.bounce else self.path_frames
        self.k0 = int(self.rng.integers(0, self.cycle))
        # A scene without dashes has no period: its phase stays 0.
        self.dash_period = float(dash_period or 1.0)
        self.phases = [float(self.rng.uniform(0.0, self.dash_period))]
        step = traffic["dash_per_frame"]
        if isinstance(step, dict):
            lo, hi = step["uniform"]
            self._step = lambda: self.rng.uniform(lo, hi)
        else:
            self._step = lambda: float(step)

    def position(self, n):
        k = (self.k0 + n) % self.cycle
        return k if k < self.path_frames else self.cycle - k

    def phase(self, n):
        while len(self.phases) <= n:
            self.phases.append(math.fmod(self.phases[-1] + self._step(), self.dash_period))
        return self.phases[n]


def camera_stack(scene, params, traffic, position):
    """The (R, 4, 4) float32 transform stack of path position
    ``position``: the scene builder's ``transforms`` under its camera
    turned by position x ``turn_per_frame``, then the picture moved on
    screen by position x ``pan_per_frame`` pixels (a clip-space
    translation, scaled by w so that it holds under perspective)."""
    stack = np.asarray(scene.transforms(params, float(traffic["turn_per_frame"]) * position),
                       np.float64)
    px, py = (float(v) * position for v in traffic.get("pan_per_frame", (0.0, 0.0)))
    if px or py:
        pan = np.eye(4)
        pan[0, 3] = 2.0 * px / params["width"]
        pan[1, 3] = 2.0 * py / params["height"]
        stack = pan @ stack
    return np.ascontiguousarray(stack, np.float32)


class Reservoir:
    """A uniform sample of ``k`` of the frames offered, drawn from the
    seed: frame n replaces a kept one with probability k / (n + 1)."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = np.random.default_rng([seed, 0x636865636b])
        self.kept = {}
        self._slots = []

    def offer(self, n, frame):
        if len(self._slots) < self.k:
            self._slots.append(n)
            self.kept[n] = frame
            return
        j = int(self.rng.integers(0, n + 1))
        if j < self.k:
            del self.kept[self._slots[j]]
            self._slots[j] = n
            self.kept[n] = frame

    def frames(self):
        return sorted(self.kept)
