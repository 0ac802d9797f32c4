"""Sampling primitives of the NEE integrator (plane form).

The JAX package's integrator/sampling.py, each helper one sampling idiom
of the reference megakernel (PathTrace.cu:905-1416) with its quirks: the
exit-form Schlick Fresnel R0 - (1-R0)(1-c)^5, the dipole-style BSSRDF,
and the per-object area-CDF bisection for BSSRDF exit points. The CUDA
kernel (csrc/mega.cu) has one device function for each, in the same
operation order.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, div, sqrt, vdot, vwhere

PI = 3.1415926  # the reference's PI (PathTrace.cu:36)
TWO_PI = 2.0 * PI
EIGHT_PI = 8.0 * PI


def uniform_sphere_p(u_cos, u_phi) -> V3:
    """Unit direction from two U[0,1) draws (PathTrace.cu:968-971)."""
    cos_t = 2.0 * (u_cos - 0.5)
    sin_t = sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u_phi
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def fold_same_hemisphere_p(d: V3, normal: V3, reference: V3) -> V3:
    """Flip d so sign(d.n) == sign(reference.n) (PathTrace.cu:972-974)."""
    flip = vdot(d, normal) * vdot(reference, normal) < 0
    return vwhere(flip, -d, d)


def fold_opposite_hemisphere_p(d: V3, normal: V3, reference: V3) -> V3:
    """Flip d so sign(d.n) != sign(reference.n) (PathTrace.cu:1140-1142)."""
    flip = vdot(d, normal) * vdot(reference, normal) > 0
    return vwhere(flip, -d, d)


def triangle_point_p(p1: V3, p2: V3, p3: V3, u, v) -> V3:
    """Uniform point via folded barycentrics (PathTrace.cu:936-945)."""
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    return V3(p1.x + (p2.x - p1.x) * u + (p3.x - p1.x) * v,
              p1.y + (p2.y - p1.y) * u + (p3.y - p1.y) * v,
              p1.z + (p2.z - p1.z) * u + (p3.z - p1.z) * v)


def schlick_r0(ior):
    """R0 = ((ior-1)/(ior+1))^2 (PathTrace.cu:1066, 1184)."""
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


def fresnel_entry(r0, cos_abs):
    """R0 + (1-R0)(1-|c|)^5 (PathTrace.cu:1067-1069)."""
    oc = 1.0 - cos_abs
    oc2 = oc * oc
    return r0 + (1.0 - r0) * oc2 * oc2 * oc


def fresnel_exit(r0, cos_abs):
    """R0 - (1-R0)(1-|c|)^5 — the reference's sign (PathTrace.cu:1100-1102)."""
    oc = 1.0 - cos_abs
    oc2 = oc * oc
    return r0 - (1.0 - r0) * oc2 * oc2 * oc


def refract_dir_p(d_in: V3, normal: V3, eta):
    """Cg-style refraction (gen_refract_ray, PathTrace.cu:876-894):
    ``d_in`` points into the surface -> (dir V3, full_reflex). On total
    internal reflection the reference returns ``d_in`` unchanged and sets
    the flag."""
    cosi = vdot(d_in, normal)
    n = vwhere(cosi > 0, -normal, normal)
    cosi = torch.abs(cosi)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    full_reflex = cost2 <= 0
    safe = sqrt(torch.clamp_min(cost2, 0.0))
    refracted = d_in * eta + n * (eta * cosi - safe)
    return vwhere(full_reflex, d_in, refracted), full_reflex


def bssrdf_p(dist, sigma: V3) -> V3:
    """(e^{-d/s} + e^{-(d/3)/s}) / (s * 8 pi d) per channel
    (PathTrace.cu:1062-1063); ``dist`` is a plane."""
    third = div(dist, 3.0)

    def chan(s):
        return (torch.exp(-dist / s) + torch.exp(-third / s)) / (s * EIGHT_PI * dist)

    return V3(chan(sigma.x), chan(sigma.y), chan(sigma.z))


def area_cdf_pick(u, obj_id, prefix_area, obj_total_area, seg_begin, seg_end,
                  mapping):
    """Pick an exit triangle on the object by area (PathTrace.cu:1031-1048).

    The reference bisection over the load-order prefix sums: left/right
    start at the object's segment bounds and move while left < right - 1;
    the *final middle* (0 if the loop never runs) is translated through
    ``mapping`` to the BVH-sorted id. Equal to the JAX package's table-
    driven ``area_cdf_pick_fast``, which reproduces this search exactly.
    """
    obj_id = obj_id.long()
    target = u * obj_total_area[obj_id]
    left = seg_begin[obj_id].long()
    right = seg_end[obj_id].long()
    middle = torch.zeros_like(left)
    go = left < right - 1
    while bool(go.any()):
        m = torch.div(left + right, 2, rounding_mode="floor")
        middle = torch.where(go, m, middle)
        le = target <= prefix_area[m]
        # the reference's `else if (>=)`: on equality the first branch wins
        right = torch.where(go & le, m, right)
        left = torch.where(go & ~le, m, left)
        go = left < right - 1
    return mapping[middle]
