"""The pool's bounce resolve: the CUDA kernel ``resolve_bounce``
(csrc/pool.cu) and its plain version.

Replaces the JAX package's ops/pallas/bounce_resolve.py
``resolve_bounce2`` (and ``resolve_bounce``; -> ``_kernel``) together with
the env lookups between the trace and that kernel (pool.py:207-223). For
every active lane, from the raw trace rows t, id [E+2, M] of its
segments (and the front's march results in ``rf``/``ri``): light
visibility (``id == emit_idx[i]``), the env radiance of the HDR and
continuation directions, ``wavefront.resolve_tail``, then the pool's
forward composite ``L += T * dir; T *= rate`` with the depth-cap term
(the reference's fold seeds from its top entry, PathTrace.cu:
1410-1415). A finished path adds ``L + le0`` to its film slot (``le0``
alone when its march escaped: the kill) and frees its lane; a continuing
one moves to its continuation hit. The counters
gain E + 2 useful rays per active lane and one finished sample per
finished path.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vstack, vwhere
from . import kernels
from .bounce_front import lane_front, lane_refr
from .kernels import INF, LAUNCHES
from .lanes import (C_DONE, C_RAYS, F_DIR, F_L, F_LE0, F_SRC, F_T, I_ACTIVE,
                    I_BOUNCE, I_HIT, I_SLOT, PoolState)


def resolve_bounce_plain(st: PoolState, bt: torch.Tensor, bi: torch.Tensor) -> None:
    """The plain version: ``wavefront.resolve_step`` on the recomputed
    front, then the pool's accumulation, in place."""
    from ..integrator import wavefront

    sd, cfg = st.sd, st.cfg
    state, f, *_ = lane_front(st, lane_refr(st) if sd.has_refract else None)
    active = state[0]
    n_seg = sd.n_emit + 2
    (accept, src2, out2, hit2, killed), (dir_b, rate_b) = wavefront.resolve_step(
        f, state, [bt[s] < INF for s in range(n_seg)], [bi[s] for s in range(n_seg)],
        [bt[s] for s in range(n_seg)], sd, cfg)
    fs, is_ = st.fs, st.is_
    t_put = V3(*fs[F_T:F_T + 3])
    l_acc = V3(*fs[F_L:F_L + 3])
    l_acc = l_acc + t_put * dir_b
    t_put = t_put * rate_b
    b = is_[I_BOUNCE]
    b2 = torch.where(active, b + 1, b)
    capped = accept & (b2 >= cfg.max_depth)
    l_acc = l_acc + vwhere(capped, t_put * dir_b, 0.0)
    finished = (active & ~accept) | capped
    still = accept & ~capped

    l_final = vwhere(killed, 0.0, l_acc) + V3(*fs[F_LE0:F_LE0 + 3])
    st.film.index_add_(0, is_[I_SLOT][finished].long(), vstack(l_final)[finished])
    st.cnt[C_DONE] += finished.sum()
    st.cnt[C_RAYS] += active.sum() * n_seg

    new = fs.clone()
    for row, v in ((F_SRC, src2), (F_DIR, out2), (F_T, t_put), (F_L, l_acc)):
        new[row:row + 3] = vstack(v).T
    fs.copy_(torch.where(still, new, fs))
    is_[I_HIT] = torch.where(still, hit2, is_[I_HIT])
    is_[I_BOUNCE] = torch.where(still, b2, b)
    is_[I_ACTIVE] = still.to(torch.int32)


def resolve_bounce(st: PoolState, bt: torch.Tensor, bi: torch.Tensor) -> None:
    """Resolve every active lane's bounce from its segments' trace rows
    (see the module docstring), in place. CUDA state launches the kernel;
    CPU state runs the plain version."""
    if st.fs.device.type == "cpu":
        return resolve_bounce_plain(st, bt, bi)
    s, r, q = st.args()
    shape, dev = (st.sd.n_emit + 2, st.m), st.sd.device
    kernels.check_tensor("bt", bt, torch.float32, shape, dev)
    kernels.check_tensor("bi", bi, torch.int32, shape, dev)
    p = kernels.ptr
    rc = kernels.library().resolve_bounce(s, r, q, p(bt), p(bi), kernels.stream(dev))
    kernels.check_rc(rc, "resolve_bounce")
    LAUNCHES["resolve_bounce"] += 1
