"""Stage logging, throughput counters and profiler capture.

The JAX package's utils/logging.py: the reference's stage banners
(PathTrace.cpp:677-681, PathTrace.cu:1536-1714) through one logger, a
rays-per-second counter, and a profiler capture around a hot region,
here through ``torch.profiler`` written as a Chrome trace. Under
``torch.distributed`` with more than one rank every stage line carries
its rank.
"""

from __future__ import annotations

import contextlib
import logging as _logging
import os
import time

logger = _logging.getLogger("jaderaytracerendering_tpu_torch")


def _rank_prefix() -> str:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return f"[rank {dist.get_rank()}/{dist.get_world_size()}] "
    return ""


def stage(msg: str) -> None:
    """Stage banner (the reference's 'Model load done' style lines)."""
    if not logger.handlers:
        h = _logging.StreamHandler()
        h.setFormatter(_logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(_logging.INFO)
    logger.info(_rank_prefix() + msg)


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    yield
    stage(f"{name} took {time.perf_counter() - t0:.3f}s")


class RayCounter:
    """Accumulates traced-ray counts and reports Mrays/sec."""

    def __init__(self) -> None:
        self.rays = 0
        self.seconds = 0.0

    def add(self, rays: int, seconds: float) -> None:
        self.rays += rays
        self.seconds += seconds

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """torch.profiler capture around a hot region, written as a Chrome
    trace ``log_dir/trace_rank<r>.json`` (r = 0 outside torch.distributed);
    does nothing when ``log_dir`` is None. Traces the card's kernels
    where CUDA is available."""
    if log_dir is None:
        yield
        return
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}.json"))
