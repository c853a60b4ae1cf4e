"""The comparison that decides ``correct``: the packed RGBA8 frames that
the timed entry produced, each against the reference's frame of the same
inputs.

A pixel is off where a channel differs by more than the configuration's
``channel_tolerance`` (the float32 resolve of the port and the float64
one of the reference may round a channel one step apart).  The number
compared is the largest share of off pixels over the frames kept; a
frame that never came counts as wholly off.
"""

from __future__ import annotations

import torch


def off_share(frame, reference, tolerance):
    """The share of pixels of ``frame`` (H, W, 4) uint8 with a channel
    more than ``tolerance`` away from ``reference``."""
    if frame is None or tuple(frame.shape) != tuple(reference.shape):
        return 1.0
    diff = (frame.to(reference.device).int() - reference.int()).abs().amax(-1)
    return float((diff > tolerance).double().mean())


def judge(shares, limit, expected):
    """The checks of a run: the worst frame's off share against its
    limit, and the frames compared against the frames kept."""
    worst = max(shares) if shares else 1.0
    checks = {
        "off_share": {"value": worst, "limit": limit},
        "frames_compared": {"value": len(shares), "limit": expected},
    }
    ok = bool(shares) and worst <= limit and len(shares) == expected
    return ok, checks, sum(1 for s in shares if s > limit)


def lines(checks):
    """The checks as plain lines: name, number and limit."""
    out = []
    for name, c in checks.items():
        out.append(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return out


def free_device_memory():
    """Collect what is no longer reachable, set-up's frozen objects too,
    and hand the card's cached blocks back."""
    import gc

    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
