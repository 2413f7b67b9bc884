"""What the per-layer readers share.  A reader takes the traced slice's
summary (``run.py``): ``window_s`` and ``busy_s`` (the union of device
operations' intervals) of the slice, ``device_ops``, ``units`` and the
work of the slice from ``work.py`` (``ops``, ``bytes``, ``least_s``),
``unit_s``, a unit's wall seconds in the window outside the slice, and the
whole window's program counters (``window_counters``).  The profiler slows
the host's side of a unit, so a share of wall time takes the slice's
units at ``unit_s`` each, not the slice's own wall time.  A reader that
finds nothing to read returns None."""

from __future__ import annotations


def traced(s: dict) -> bool:
    return s["busy_s"] > 0 and s["units"] > 0


def untraced_s(s: dict) -> float:
    """The slice's units' wall seconds, as the untraced window runs them."""
    return s["units"] * s["unit_s"]


def kernels_roofline(s: dict):
    """Percent: the slice's least time on the chip over its busy time."""
    return 100.0 * s["least_s"] / s["busy_s"] if traced(s) else None


def device_idle(s: dict):
    """Percent of the slice's units' wall time in which no device operation
    ran."""
    if not traced(s) or not s["unit_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / untraced_s(s))


def mfu(s: dict):
    """Percent of the chip's peak operations the slice's work reaches over
    its units' wall time."""
    if not traced(s) or not s["unit_s"]:
        return None
    return 100.0 * s["ops"] / (untraced_s(s) * s["peak_ops_per_s"])


def per_unit_ops(s: dict):
    """Device operations a unit."""
    return s["device_ops"] / s["units"] if traced(s) else None
