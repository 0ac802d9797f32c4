"""The pool's bounce front: the CUDA kernel ``front_bounce``
(csrc/pool.cu) and its plain version.

Replaces the JAX package's ops/pallas/bounce_front.py ``front_bounce``
(-> ``_kernel``). For every active lane: the bounce's draws from its
counters (pixel, sample, bounce + 1, site, seed), the hit's rows, then
``wavefront.bounce_front`` (branch masks, SSS exit pick, the NEE light,
HDR and continuation directions), emitted as stacked segment rays: o, d
[E+2, 3, M] f32 (light i, the HDR ray, the continuation; masked lanes get
zero rays) and the excluded triangle x [E+2, M] i32. The resolve step
recomputes the rest of the front from the same state, so nothing else is
emitted.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vstack
from . import kernels
from .kernels import LAUNCHES
from .lanes import F_DIR, F_SRC, I_ACTIVE, I_BOUNCE, I_HIT, I_PIX, I_SMP, PoolState


def lane_front(st: PoolState):
    """The lanes' path state and ``wavefront.front_step`` on it ->
    (state, Front, seg_o, seg_d)."""
    from ..integrator import wavefront

    fs, is_ = st.fs, st.is_
    state = (is_[I_ACTIVE] != 0, V3(*fs[F_SRC:F_SRC + 3]), V3(*fs[F_DIR:F_DIR + 3]),
             is_[I_HIT])
    f, seg_o, seg_d = wavefront.front_step(state, is_[I_BOUNCE], is_[I_PIX],
                                           is_[I_SMP], st.sd, st.cfg)
    return state, f, seg_o, seg_d


def front_bounce_plain(st: PoolState):
    """The plain version -> (o, d [E+2, 3, M] f32, x [E+2, M] i32)."""
    _, f, seg_o, seg_d = lane_front(st)
    o = torch.stack([vstack(v).T for v in seg_o])
    d = torch.stack([vstack(v).T for v in seg_d])
    x = f.nee_excl.to(torch.int32).expand(len(seg_o), -1).contiguous()
    return o, d, x


def front_bounce(st: PoolState):
    """Segment rays of every lane's next bounce (see the module
    docstring). CUDA state launches the kernel; CPU state runs the plain
    version."""
    if st.fs.device.type == "cpu":
        return front_bounce_plain(st)
    s, r, q = st.args()
    n_seg, m, dev = st.sd.n_emit + 2, st.m, st.sd.device
    o = torch.empty((n_seg, 3, m), dtype=torch.float32, device=dev)
    d = torch.empty((n_seg, 3, m), dtype=torch.float32, device=dev)
    x = torch.empty((n_seg, m), dtype=torch.int32, device=dev)
    p = kernels.ptr
    rc = kernels.library().front_bounce(s, r, q, p(o), p(d), p(x), kernels.stream(dev))
    kernels.check_rc(rc, "front_bounce")
    LAUNCHES["front_bounce"] += 1
    return o, d, x
