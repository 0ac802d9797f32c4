"""Brute-force nearest hit: every ray against every triangle.

The reference's hitArray (PathTrace.cu:776-792) over the whole scene —
the traversal oracle the tests hold the BVH walks against. Same return
convention as ops/traverse.py; on equal t the minimum id wins.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vnormalize, vrows
from .intersect import INF, ray_triangle


def nearest_hit(origins: torch.Tensor, dirs: torch.Tensor,
                exclude: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                p3: torch.Tensor, chunk: int = 4096):
    m = origins.shape[0]
    o = vrows(origins.to(torch.float32))
    d = vnormalize(vrows(dirs.to(torch.float32)))
    o = V3(o.x[:, None], o.y[:, None], o.z[:, None])
    d = V3(d.x[:, None], d.y[:, None], d.z[:, None])
    best_t = torch.full((m,), INF, dtype=torch.float32, device=origins.device)
    best_i = torch.zeros((m,), dtype=torch.int32, device=origins.device)
    for c0 in range(0, p1.shape[0], chunk):
        c1 = min(c0 + chunk, p1.shape[0])
        hit, t = ray_triangle(o, d, vrows(p1[None, c0:c1]),
                              vrows(p2[None, c0:c1]), vrows(p3[None, c0:c1]))
        ids = torch.arange(c0, c1, dtype=torch.int32, device=origins.device)
        t = torch.where(hit & (ids[None, :] != exclude[:, None]), t, INF)
        j = torch.argmin(t, dim=1, keepdim=True)
        tc = t.gather(1, j)[:, 0]
        better = tc < best_t  # ascending chunks keep the lowest id on ties
        best_t = torch.where(better, tc, best_t)
        best_i = torch.where(better, ids[j[:, 0]], best_i)
    return best_t < INF, best_i, best_t
