"""Nearest hit of stacked ray segments: the CUDA kernel ``trace_segments``
(csrc/pool.cu) and its plain version.

Replaces the JAX package's Pallas sweep kernels, which all compute this
function: ops/pallas/cluster_sweep_fused.py ``nearest_hit_sweep_fused_
feats_jnp`` and ``_stacked_jnp`` (-> ``_fused_kernel``),
cluster_sweep_stream.py (``_stream_kernel``), cluster_sweep.py
(``_sweep_kernel``) and cluster_sweep_mxu.py (``_sweep_mxu_kernel``). Rays
come as ``S`` segments of ``M`` lanes: origins and raw directions
[S, 3, M], excluded triangle ids [S, M]. Each direction is made unit
(zero stays zero: a miss) and the BVH walk normalizes it again, as the
integrator's ray query does (wavefront.nearest_planes). Output: t [S, M]
(``INF`` on a miss) and the hit triangle [S, M] (0 on a miss); on equal t
the minimum id wins. Segment ``anyhit_seg`` stops at its first hit: only
its hit/miss boolean is meaningful.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.vecmath import V3, vnormalize, vstack
from . import kernels, traverse
from .kernels import INF, LAUNCHES


def trace_segments_plain(sd, o, d, x, anyhit_seg: int = -1, stack_size: int = 128):
    """The plain version: the plain BVH walk per segment (any-hit segments
    walk to the nearest hit)."""
    bt = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    bi = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for s in range(x.shape[0]):
        d_u = vnormalize(V3(d[s, 0], d[s, 1], d[s, 2]), eps=1e-30)
        _, bi[s], bt[s] = traverse.nearest_hit_bvh(o[s].T, vstack(d_u), x[s], sd,
                                                   stack_size)
    return bt, bi


def trace_segments(sd, o: torch.Tensor, d: torch.Tensor, x: torch.Tensor,
                   anyhit_seg: int = -1, stack_size: int = 128):
    """[S, 3, M] origins and directions, [S, M] excluded ids -> (t [S, M]
    f32, id [S, M] i32). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    if x.device.type == "cpu":
        return trace_segments_plain(sd, o, d, x, anyhit_seg, stack_size)
    s = kernels.scene_args(sd, stack_size)
    n_seg, m = x.shape
    kernels.check_tensor("o", o, torch.float32, (n_seg, 3, m), sd.device)
    kernels.check_tensor("d", d, torch.float32, (n_seg, 3, m), sd.device)
    kernels.check_tensor("x", x, torch.int32, (n_seg, m), sd.device)
    bt = torch.empty((n_seg, m), dtype=torch.float32, device=sd.device)
    bi = torch.empty((n_seg, m), dtype=torch.int32, device=sd.device)
    p = kernels.ptr
    rc = kernels.library().trace_segments(
        ctypes.byref(s), p(o), p(d), p(x), n_seg, m, int(anyhit_seg), p(bt), p(bi),
        kernels.stream(sd.device))
    kernels.check_rc(rc, "trace_segments")
    LAUNCHES["trace_segments"] += 1
    return bt, bi


def nearest(segments, sd, o: V3, d: V3, excl, stack_size: int = 128):
    """One segment of plane-form rays through ``segments`` (``trace_segments``
    or ``trace_segments_plain``) -> (hit, idx, t)."""
    x = excl.to(torch.int32).reshape(1, -1).contiguous()
    o3 = vstack(o).T.unsqueeze(0).contiguous()
    d3 = vstack(d).T.unsqueeze(0).contiguous()
    bt, bi = segments(sd, o3, d3, x, -1, stack_size)
    return bt[0] < INF, bi[0], bt[0]
