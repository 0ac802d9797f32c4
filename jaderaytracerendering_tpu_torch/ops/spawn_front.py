"""One spawn round of the pool: the CUDA kernel ``spawn_primary``
(csrc/pool.cu) and its plain version.

Replaces the JAX package's ops/pallas/spawn_front.py ``spawn_primary``
(-> ``_kernel``) and the primary trace after it (pool.py:316-352). Fresh
lanes (not active) take the next queue samples in lane order:
``k`` = inclusive count of fresh lanes up to the lane, ``index = next + k
- 1``, ``got = fresh & index < total``, ``slot = index % n_px``, ``pix =
pix0 + slot`` (the state's pixel window, ops/lanes.py), ``smp = index //
n_px + sample_base``; the queue advances by
``min(fresh, total - next)``. A lane that got a sample traces its
jittered camera ray: a hit starts its path (bounce 0, T = 1, L = 0, le0 =
the hit's emission), a miss adds the sky to the film, finishes the sample
and leaves the lane fresh for the next round. The counters gain one
useful ray per sample taken and one finished sample per miss.
"""

from __future__ import annotations

import torch

from ..core import camera as camera_mod
from ..core.vecmath import V3, vnormalize, vrows, vstack, vwhere
from ..scene import envmap
from . import kernels, scanops, trace
from .kernels import INF, LAUNCHES
from .lanes import (C_DONE, C_NEXT, C_RAYS, F_DIR, F_L, F_LE0, F_SRC, F_T, I_ACTIVE,
                    I_BOUNCE, I_HIT, I_PIX, I_SLOT, I_SMP, PoolState)


def spawn_primary_plain(st: PoolState, aux: torch.Tensor | None = None) -> None:
    """The plain version. ``aux`` [8, M] f32, when given, receives each
    lane's d_u (rows 0-2), hit t (3), sky (4-6) and got (7) where it took
    a sample, zeros elsewhere."""
    sd, cfg = st.sd, st.cfg
    fresh = st.is_[I_ACTIVE] == 0
    k = scanops.cumsum_indicator(fresh)
    nxt = st.cnt[C_NEXT]
    index = nxt + k - 1
    got = fresh & (index < st.total)
    new_slot = torch.remainder(index, st.n_px)
    slot = torch.where(got, new_slot, st.is_[I_SLOT].long())
    pix = torch.where(got, new_slot + st.pix0, st.is_[I_PIX].long())
    smp = torch.where(got, torch.div(index, st.n_px, rounding_mode="floor")
                      + st.sample_base, st.is_[I_SMP].long())
    st.is_[I_SLOT] = slot.to(torch.int32)
    st.is_[I_PIX] = pix.to(torch.int32)
    st.is_[I_SMP] = smp.to(torch.int32)
    fresh_n = k[-1] if k.numel() else torch.zeros_like(nxt)
    st.cnt[C_NEXT] = nxt + torch.minimum(fresh_n, st.total - nxt)

    o, d = camera_mod.generate_rays_p(st.eye, st.rot, cfg.width, cfg.height, pix,
                                      smp, cfg.seed, cfg.jitter)
    d_u = vnormalize(vwhere(got, d, 0.0), eps=1e-30)
    excl = torch.full_like(st.is_[I_HIT], -1)
    bt, bi = trace.trace_segments_plain(
        sd, vstack(o).T.unsqueeze(0), vstack(d_u).T.unsqueeze(0), excl.unsqueeze(0),
        -1, cfg.bvh_stack_size)
    t, tri = bt[0], bi[0]
    hit = t < INF
    sky = envmap.sample_env(sd.env_map, d_u, cfg.hdr_clamp)
    miss = got & ~hit
    start = got & hit
    st.film.index_add_(0, slot[miss], vstack(sky)[miss])
    st.cnt[C_DONE] += miss.sum()
    st.cnt[C_RAYS] += got.sum()

    src = o + d_u * t
    le0 = vrows(sd.mat_emissive[sd.tri_obj[torch.where(start, tri, 0)].long()])
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    new = torch.empty_like(st.fs)
    for row, v in ((F_SRC, src), (F_DIR, -d_u), (F_T, V3(one, one, one)),
                   (F_L, V3(zero, zero, zero)), (F_LE0, le0)):
        new[row:row + 3] = vstack(v).T
    st.fs.copy_(torch.where(start, new, st.fs))
    st.is_[I_ACTIVE] = torch.where(start, 1, st.is_[I_ACTIVE])
    st.is_[I_HIT] = torch.where(start, tri, st.is_[I_HIT])
    st.is_[I_BOUNCE] = torch.where(start, 0, st.is_[I_BOUNCE])
    if aux is not None:
        rows = torch.stack([d_u.x, d_u.y, d_u.z, t, sky.x, sky.y, sky.z,
                            torch.ones_like(t)])
        aux.copy_(torch.where(got, rows, 0.0))


def spawn_primary(st: PoolState, aux: torch.Tensor | None = None) -> None:
    """One spawn round on ``st`` in place (see the module docstring). CUDA
    state launches the kernel, one launch a round; CPU state runs the plain
    version."""
    if st.fs.device.type == "cpu":
        return spawn_primary_plain(st, aux)
    s, r, q = st.args()
    dev = st.sd.device
    lib = kernels.library()
    if st.spawn_scan is None:  # zeroed once; the kernel keeps it across rounds
        st.spawn_scan = torch.zeros((lib.spawn_scratch_words(st.m),), dtype=torch.int64,
                                    device=dev)
    if aux is not None:
        kernels.check_tensor("aux", aux, torch.float32, (8, st.m), dev)
    p = kernels.ptr
    rc = lib.spawn_primary(s, r, q, p(st.spawn_scan), None if aux is None else p(aux),
                           kernels.stream(dev))
    kernels.check_rc(rc, "spawn_primary")
    LAUNCHES["spawn_primary"] += 1
