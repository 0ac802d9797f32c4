"""The program's own spans and counters of a traced window, for the
per-layer readers: ``jaderaytracerendering_tpu_torch/utils/logging.py``
records them while torch.profiler runs, and the clients' reset of the
launch counters at the window's start clears them. This module opens
the program's recorder and nothing else of it. A run without a device
trace (untraced, or on the CPU), a program without the recorder, or a
window in which it recorded nothing reads as nothing, as the profile's
other readers do."""

from __future__ import annotations


def _recorder(run):
    if run.trace is None:
        return None
    from jaderaytracerendering_tpu_torch.utils import logging as recorder

    if not (hasattr(recorder, "spans") and hasattr(recorder, "counters")):
        return None  # a program from before the recorder
    return recorder


def seconds(run, name: str) -> list:
    """The seconds of each span named ``name``, in the order they opened."""
    rec = _recorder(run)
    if rec is None:
        return []
    return [s.end - s.start for s in rec.spans() if s.name == name]


def self_seconds(run, name: str, child: str) -> list:
    """The seconds of each span named ``name`` less those of its direct
    children named ``child``."""
    rec = _recorder(run)
    if rec is None:
        return []
    found = rec.spans()
    out = {i: s.end - s.start for i, s in enumerate(found) if s.name == name}
    for s in found:
        if s.name == child and s.parent in out:
            out[s.parent] -= s.end - s.start
    return list(out.values())


def counter(run, name: str):
    """The counter ``name`` over the window, or None where it was never
    counted."""
    rec = _recorder(run)
    if rec is None:
        return None
    return rec.counters().get(name)
