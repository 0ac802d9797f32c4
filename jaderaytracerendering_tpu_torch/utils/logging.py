"""Stage logging, and the spans and counters of a profiled run.

The JAX package's utils/logging.py: the reference's stage banners
(PathTrace.cpp:677-681, PathTrace.cu:1536-1714) through one logger.
Under ``torch.distributed`` with more than one rank every stage line
carries its rank.

The program's spans and counters (``span``, ``count``) are recorded only
while a ``torch.profiler`` session is active; otherwise a span costs one
test of the profiler's flag and a counter the same. While recording,
each span is also a profiler range (a ``RecordFunction``, as
``torch.profiler.record_function`` opens), so it sits in the profiler's
timeline on the kernels' clock, and is kept in memory
(``spans()``, ``counters()``) until ``reset()``, which
``ops/kernels.reset_launches`` calls. Nothing is written to disk.

The megakernel's counters (ops/mega.py, integrator/mega.py):
``ops.mega.launches``, ``ops.mega.launch_us`` and ``ops.mega.tail_us``
(its launches and their %globaltimer time and tail), ``ops.mega.bounces``
(every bounce its paths resolved), ``ops.mega.sss_bounces`` (those
whose branch was SSS entry or exit), ``ops.mega.refract_bounces`` (those
whose branch was direct refraction) and ``ops.mega.march_steps`` (the
traces of their refraction marches, each one walk).

Each span carries the number of its request (``Span.item``) and the
index of its parent in ``spans()``. A top-level span opened with
``request=True`` (an image of ``render_film``, a preview frame) starts
the next request; every other span carries the number of the request
open or last opened, so an image's host tone map, a top-level span of
its own, joins the image's ``render_film``. Spans before any request
carry -1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging as _logging
import time

import torch
from torch.autograd import profiler as _profiler

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


@dataclasses.dataclass
class Span:
    """One recorded span: host clock (``time.perf_counter``) seconds."""

    name: str
    start: float
    end: float = float("nan")  # NaN while the span is open
    parent: int = -1           # index of the parent span in ``spans()``; -1 at the top
    item: int = -1             # the number of its request


class Recorder:
    """Spans and counters of one process (see the module docstring)."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._item = -1  # the latest request's number

    def reset(self) -> None:
        self.spans, self.counters, self._open, self._item = [], {}, [], -1

    def record(self, name: str, request: bool = False) -> "_Recording":
        """Context manager: the span ``name``, recorded."""
        return _Recording(self, name, request)

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)


class _Recording:
    """One span while it is open. Its profiler range is a
    ``_RecordFunctionFast``: ``torch.profiler.record_function`` goes
    through the dispatcher, which costs several times as much a range
    under the profiler, and a pool image opens ~430 spans."""

    __slots__ = ("rec", "name", "request", "span", "idx", "range")

    def __init__(self, rec: Recorder, name: str, request: bool) -> None:
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self) -> None:
        rec = self.rec
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        parent = rec._open[-1] if rec._open else -1
        if self.request and parent < 0:
            rec._item += 1
        self.idx = len(rec.spans)
        self.span = Span(self.name, 0.0, parent=parent, item=rec._item)
        rec.spans.append(self.span)
        rec._open.append(self.idx)
        self.span.start = time.perf_counter()

    def __exit__(self, *exc) -> None:
        self.span.end = time.perf_counter()
        rec = self.rec
        if rec._open and rec._open[-1] == self.idx:  # reset() may have cleared it
            rec._open.pop()
        self.range.__exit__(*exc)


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def span(name: str, request: bool = False):
    """Context manager: a span named ``name`` while recording, else
    nothing; ``request``: at the top level it starts the next request."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return RECORDER.record(name, request)


def recording() -> bool:
    """Whether spans and counters are recorded now (a profiler is on)."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if _profiler._is_profiler_enabled:
        RECORDER.count(name, n)


def spans() -> list[Span]:
    return RECORDER.spans


def counters() -> dict[str, int]:
    return RECORDER.counters


def reset() -> None:
    RECORDER.reset()
