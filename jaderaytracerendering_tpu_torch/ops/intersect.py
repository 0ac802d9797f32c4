"""Ray-triangle (Moller-Trumbore) and ray-AABB slab tests, plane form.

The JAX package's ops/intersect.py ('mt' method): no epsilon culling —
a parallel ray gives a = 0 and an inf/NaN that the comparisons reject
(IEEE semantics, as the JAX package intends) — and index exclusion
instead of a t-epsilon against self-intersection. The CUDA kernel's
``ray_triangle``/``ray_aabb`` device functions evaluate the same
operations in the same order.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vcross, vdot

INF = 2147483647.0  # PathTrace.cu:23


def ray_triangle(o: V3, d: V3, p1: V3, p2: V3, p3: V3):
    """Intersect rays with triangles (components broadcast). ``d`` must be
    unit. Returns (hit, t) with t = INF where hit is False."""
    e1 = p2 - p1
    e2 = p3 - p1
    h = vcross(d, e2)
    a = vdot(e1, h)
    f = torch.reciprocal(a)
    s = o - p1
    u = f * vdot(s, h)
    q = vcross(s, e1)
    v = f * vdot(d, q)
    t = f * vdot(e2, q)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, torch.where(hit, t, INF)


def ray_aabb(o: V3, invdir: V3, aa: V3, bb: V3):
    """Slab test (PathTrace.cu:758-771) -> (enter, dist). ``dist`` is the
    reference's return (entry t, exit t if inside, -1 on miss) and
    ``enter = max(t0, 0)`` feeds ordered pruning. A NaN slab (0 * inf)
    drops out of the reductions as the reference's fminf/fmaxf drop it."""
    tmax, tmin = [], []
    for oc, ic, ac, bc in zip(o, invdir, aa, bb):
        f = (bc - oc) * ic
        n = (ac - oc) * ic
        tmax.append(torch.where(f > n, f, n))
        tmin.append(torch.where(f < n, f, n))
    inf = float("inf")
    t1 = torch.where(torch.isnan(tmax[0]), inf, tmax[0])
    t0 = torch.where(torch.isnan(tmin[0]), -inf, tmin[0])
    for k in (1, 2):
        a = torch.where(torch.isnan(tmax[k]), inf, tmax[k])
        b = torch.where(torch.isnan(tmin[k]), -inf, tmin[k])
        t1 = torch.minimum(t1, a)
        t0 = torch.maximum(t0, b)
    dist = torch.where(t1 >= t0, torch.where(t0 > 0.0, t0, t1), -1.0)
    return torch.clamp_min(t0, 0.0), dist
