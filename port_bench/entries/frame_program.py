"""``Renderer.compile_frame(commands, uint8_output=True)``, planned over
the traffic's camera path (``plan_for_motion``); a frame is
``program(transforms)``.  Spans: ``program.stats``' ``plan_ms``,
``bin_ms`` and ``raster_ms``."""

from __future__ import annotations

from port_bench.harness import port_lib

SPANS = ("plan_ms", "bin_ms", "raster_ms")


class Entry:
    def __init__(self, config, scene, stacks, schedule, device):
        self.renderer = port_lib.renderer(config, device)
        self.program = self.renderer.compile_frame(scene.commands, uint8_output=True)
        self.scene, self.stacks, self.schedule = scene, stacks, schedule
        self.program.plan_for_motion(list(stacks))

    def warm(self, cycles):
        for _ in range(cycles):
            for t in self.stacks:
                self.program(t)

    def __call__(self, n):
        self.scene.set_phase(self.schedule.phase(n))
        return self.program(self.stacks[self.schedule.position(n)])

    def spans(self):
        stats = self.program.stats
        return {k: stats[k] for k in SPANS if k in stats}

    def captured(self):
        return "capture_ms" in self.program.stats

    def describe(self):
        plan = self.program._plan
        return (f"plan {None if plan is None else plan.signature}; "
                f"builds {self.program.builds}")
