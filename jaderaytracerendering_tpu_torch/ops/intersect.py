"""Ray-triangle and ray-AABB slab tests, plane form.

The JAX package's ops/intersect.py. Two ray-triangle tests:

- ``'mt'``: Moller-Trumbore, the renderer's: no epsilon culling — a
  parallel ray gives a = 0 and an inf/NaN that the comparisons reject
  (IEEE semantics, as the JAX package intends). The CUDA kernels'
  ``ray_triangle``/``ray_aabb`` device functions evaluate the same
  operations in the same order.
- ``'shadow'``: the reference's projection test (PathTrace.cu:705-754,
  fshader_render.fsh:175-224): project the triangle onto the plane
  through the origin perpendicular to the ray, test containment by the
  signs of scalar triple products, then recover the hit by a 2D (x, y)
  barycentric solve, singular for rays with d.z ~ 0 (a limitation of the
  reference). For parity studies; no kernel uses it.

Both use index exclusion instead of a t-epsilon against
self-intersection.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vcross, vdot

INF = 2147483647.0  # PathTrace.cu:23


def ray_triangle(o: V3, d: V3, p1: V3, p2: V3, p3: V3, method: str = "mt"):
    """Intersect rays with triangles (components broadcast). ``d`` must be
    unit. Returns (hit, t) with t = INF where hit is False."""
    if method == "shadow":
        return _ray_triangle_shadow(o, d, p1, p2, p3)
    if method != "mt":
        raise ValueError(f"unknown intersector {method!r}")
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


def _mixed(a: V3, b: V3, c: V3):
    """a . (b x c) (PathTrace.cu:261-266)."""
    return vdot(a, vcross(b, c))


def _ray_triangle_shadow(o: V3, d: V3, p1: V3, p2: V3, p3: V3):
    sa = p1 - d * vdot(d, p1 - o)
    sb = p2 - d * vdot(d, p2 - o)
    sc = p3 - d * vdot(d, p3 - o)
    pa, pb, pc = sa - o, sb - o, sc - o
    papb, pbpc, pcpa = _mixed(d, pa, pb), _mixed(d, pb, pc), _mixed(d, pc, pa)
    inside = (((papb > 0) & (pbpc > 0) & (pcpa > 0))
              | ((papb < 0) & (pbpc < 0) & (pcpa < 0)))
    b = sb - sa
    c = sc - sa
    av = o - sa
    inv = torch.reciprocal(b.x * c.y - b.y * c.x)
    rate_a = (c.y * av.x - c.x * av.y) * inv
    rate_b = (-b.y * av.x + b.x * av.y) * inv
    hitp = p1 + (p2 - p1) * rate_a + (p3 - p1) * rate_b
    t = vdot(hitp - o, d)
    hit = inside & (t > 0.0)
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
