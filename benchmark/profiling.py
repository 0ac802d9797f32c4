"""Reading a torch.profiler trace of the measured window.

The client loops mark the window with a span (``WINDOW``) and their host
steps with spans of their own; this module turns the profile into a
``Trace``: the device's activities (kernels, copies, fills) inside the
window, the seconds in which any of them ran (``busy_s``), and the host
span that was open in each of the device's idle gaps. The idle-share
arithmetic is ``chip_smoke.py``'s ``device_idle_share``, clipped to the
window span instead of a kernel's launches."""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

WINDOW = "benchmark.window"
GAPS_NAMED = 400  # the longest idle gaps whose host activity is looked up
SCAN_BACK = 20000  # host events looked back at from a gap for a covering one


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list      # (name, seconds) of every device kernel in the window
    copies_s: float    # seconds of copies and fills
    gaps: list         # (host activity, seconds) of the longest idle gaps

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    @property
    def kernel_s(self) -> float:
        return sum(s for _, s in self.kernels)

    def top_kernels(self, n: int = 10) -> list:
        tot = collections.Counter()
        for name, s in self.kernels:
            tot[name] += s
        return [[k, v] for k, v in tot.most_common(n)]

    def top_gaps(self, n: int = 10) -> list:
        tot = collections.Counter()
        for name, s in self.gaps:
            tot[name] += s
        return [[k, v] for k, v in tot.most_common(n)]


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block when ``enabled`` -> yields the
    profile (or None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def read(prof) -> Trace | None:
    """The window's ``Trace`` from a profile; None where the profile holds
    no window span or no device activity in it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, win = [], [], None
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # the host's record_function spans come back as device-side
            # annotations too: they are no device work
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("benchmark.")):
                dev.append((lo, hi, e.name))
        elif e.name == WINDOW:
            win = (lo, hi)
        else:
            host.append((lo, hi, e.name))
    if win is None:
        return None
    w0, w1 = win
    dev = sorted((max(lo, w0), min(hi, w1), n) for lo, hi, n in dev if hi > w0 and lo < w1)
    if not dev:
        return None
    busy, covered, gaps = 0.0, w0, []
    for lo, hi, _ in dev:
        if lo > covered:
            gaps.append((covered, lo))
        a = max(lo, covered)
        if hi > a:
            busy += hi - a
        covered = max(covered, hi)
    if w1 > covered:
        gaps.append((covered, w1))
    kernels = [(n, (hi - lo) / 1e6) for lo, hi, n in dev
               if not n.startswith(("Memcpy", "Memset"))]
    copies = sum(hi - lo for lo, hi, n in dev if n.startswith(("Memcpy", "Memset"))) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernels=kernels,
                 copies_s=copies, gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> list:
    """(host activity, seconds) of the longest gaps: the innermost host
    span or op open at each gap's midpoint ("idle host" where none is)."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (lo + hi) / 2
        name = "idle host"
        # the latest-starting span that still covers mid is the innermost
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SCAN_BACK, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out.append((name, (hi - lo) / 1e6))
    return out
