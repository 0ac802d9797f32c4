"""The interactive preview's integrator, written out plainly: the
preview shader's pathTracing_ (fshader_preview.fsh:332-375) for many
paths at once. Two bounces of uniform-sphere directions with pdf 1/2pi,
folded away from the view direction, a multiplicative throughput, the
emission and the sky met along the way, and no shadow rays."""

from __future__ import annotations

import torch

from . import rng
from .camera import primary_rays
from .pathtrace import PI, nearest, sky, sphere_dir
from .vec import V3, dot, normalize, rows, stack, take, where


def _unit(v: V3) -> V3:
    return normalize(v, eps=1e-30)


def trace_preview(t, cfg, o: V3, d: V3, pixel, sample, seed) -> torch.Tensor:
    """Radiance of each primary ray -> [n, 3]."""
    n = pixel.shape[0]
    dev = pixel.device
    d_unit = _unit(d)
    hit0, idx0, t0 = nearest(t, o, d_unit, torch.full((n,), -1, dtype=torch.int64, device=dev))
    sky0 = sky(t, d_unit, cfg["hdr_clamp"])
    tri = torch.where(hit0, idx0, 0)
    le0 = rows(t.emissive[t.obj[tri]])
    zero = torch.zeros(n, dtype=t.dtype, device=dev)
    lo = V3(zero, zero, zero)
    hist = V3(zero + 1, zero + 1, zero + 1)
    active = hit0
    point = o + d_unit * t0
    view = d_unit
    for b in range(cfg["preview_bounces"]):
        nrm = rows(t.norm[tri])
        brdf = rows(t.brdf[t.obj[tri]])
        u = rng.uniform_sites(pixel, sample, b + 1, [rng.CONT_COS, rng.CONT_PHI], seed)
        u = u.to(t.dtype)
        wi = sphere_dir(u[0], u[1])
        s = dot(wi, nrm) * dot(view, nrm)
        wi = where(s > 0, -wi, wi)
        a = torch.nonzero(active)[:, 0]
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        idx = torch.zeros(n, dtype=torch.int64, device=dev)
        tt = torch.zeros(n, dtype=t.dtype, device=dev)
        if a.numel():
            h, i, tv = nearest(t, take(point, a), _unit(take(wi, a)), tri[a])
            hit[a], idx[a], tt[a] = h, i, tv
        wi = where(active, wi, 0.0)
        n_emis = rows(t.emissive[t.obj[torch.where(hit, idx, 0)]])
        cos_i = torch.abs(dot(wi, nrm))
        weight = brdf * (1.0 / PI) * cos_i * (2.0 * PI)
        wi_u = _unit(wi)
        sk = sky(t, wi_u, cfg["hdr_clamp"])
        miss = active & ~hit
        lo = lo + where(miss, hist * sk * weight, 0.0)
        lo = lo + where(active & hit, hist * n_emis * weight, 0.0)
        cont = active & hit
        hist = where(cont, hist * weight, hist)
        point = where(cont, point + wi_u * tt, point)
        view = where(cont, wi_u, view)
        tri = torch.where(cont, idx, tri)
        active = cont
    out = where(hit0, le0 + lo, sky0)
    return stack(out)


def render_pixels(t, cfg, cam, pixels: torch.Tensor, counts: torch.Tensor, seed: int,
                  block: int = 1 << 16) -> torch.Tensor:
    """Preview radiance sums of ``pixels`` over their samples 0 ..
    counts[i]-1 -> [P, 3], added in sample order (a pixel with no sample
    sums to 0). ``cfg``: width, height, preview_bounces, hdr_clamp."""
    dev = pixels.device
    p = pixels.shape[0]
    spp = int(counts.max()) if p else 0
    pix_all = pixels.repeat(spp)
    smp_all = torch.arange(spp, device=dev).repeat_interleave(p)
    keep = smp_all < counts.repeat(spp)
    rad = torch.zeros((spp * p, 3), dtype=t.dtype, device=dev)
    sel = torch.nonzero(keep)[:, 0]
    for b0 in range(0, sel.numel(), block):
        s = sel[b0:b0 + block]
        o, d = primary_rays(cam, cfg["width"], cfg["height"], pix_all[s], smp_all[s], seed,
                            t.dtype)
        rad[s] = trace_preview(t, cfg, o, d, pix_all[s], smp_all[s], seed)
    rad = rad.view(spp, p, 3)
    acc = torch.zeros((p, 3), dtype=t.dtype, device=dev)
    for k in range(spp):
        acc = torch.where((k < counts)[:, None], acc + rad[k], acc)
    return acc
