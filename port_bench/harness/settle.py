"""Set-up's last step on the card: wait until it has left its slow
launch mode.

On the H100 machines this benchmark was built on, the card has a mode in
which every small kernel takes longer: a CUDA graph of 800 kernels that
each add 1 to 1,024 floats replays in 0.92-0.94 ms instead of 0.78-0.79
ms, and a drift frame, ~2 ms of small binning kernels, takes 15-20%
longer.  The SM clock reads 1,980 MHz in both modes.  The port's set-up
(its first FrameProgram, or its first frames) put the card into that
mode in nearly every process, and it lasted from under a second to more
than 40 seconds; a process that only held the probe and allocated 1 GiB
did not enter it, one that held 30 GB stayed in it until ~9 s after
freeing them, and another process's allocations did not touch it.

A window that started in that mode would read slow for a part of its
length that varies from run to run.  So set-up ends once that graph, the
probe, replays fast: under ``FAST_MS`` for the card's kind, or on a card
not in the table 10% under its first reading; at most ``MAX_WAIT_S``.
The probe is captured at the start of set-up, so that its own allocation
comes first.  The wait is the harness's and not the program's set-up:
``setup_s`` leaves it out, and the result line's ``setup`` reports it as
``settle_s``, beside the probe's first and last readings.
"""

from __future__ import annotations

import time

import torch

#: Milliseconds a replay of the probe takes at most in the fast mode,
#: by ``torch.cuda.get_device_name()``: between the two modes' readings
#: (0.78-0.79 ms fast, 0.92-0.94 slow on the H100 80GB HBM3).
FAST_MS = {"NVIDIA H100 80GB HBM3": 0.85}
MAX_WAIT_S = 90.0
KERNELS = 800
REPLAYS = 100


class Probe:
    def __init__(self, device):
        self.x = torch.zeros(1024, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(KERNELS):
                self.x.add_(1.0)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(KERNELS):
                self.x.add_(1.0)
        self.fast_ms = FAST_MS.get(torch.cuda.get_device_name(device))

    def replay_ms(self):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPLAYS):
            self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / REPLAYS

    def wait(self):
        """Replay until the probe reads fast; returns (first reading,
        last reading, seconds waited)."""
        start = time.perf_counter()
        first = last = self.replay_ms()
        fast = self.fast_ms if self.fast_ms is not None else 0.9 * first
        while last > fast and time.perf_counter() - start < MAX_WAIT_S:
            last = self.replay_ms()
        return first, last, time.perf_counter() - start
