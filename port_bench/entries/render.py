"""``Renderer.render(commands, to_host=False, uint8_kernel=True)`` with
each path position's commands made in set-up.  Spans:
``renderer.timing``'s ``prepare_ms``."""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from port_bench.harness import port_lib


class Entry:
    def __init__(self, config, scene, stacks, schedule, device):
        self.renderer = port_lib.renderer(config, device)
        self.scene, self.schedule = scene, schedule
        self.frames = [
            [replace(c, transform=np.ascontiguousarray(t))
             for c, t in zip(scene.commands, stack)]
            for stack in stacks
        ]

    def warm(self, cycles):
        for _ in range(cycles):
            for i, commands in enumerate(self.frames):
                self.scene.set_phase(self.schedule.phase(i))
                self.renderer.render(commands, to_host=False, uint8_kernel=True)

    def __call__(self, n):
        self.scene.set_phase(self.schedule.phase(n))
        return self.renderer.render(
            self.frames[self.schedule.position(n)], to_host=False,
            uint8_kernel=True)

    def spans(self):
        t = self.renderer.timing
        return {"prepare_ms": t["prepare_ms"]} if "prepare_ms" in t else {}

    def captured(self):
        return "capture_ms" in self.renderer.timing

    def describe(self):
        return f"binning steps {len(self.renderer._bin_steps)}"
