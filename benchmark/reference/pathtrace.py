"""The full integrator, written out plainly: PathTrace.cu's pathTracing
(:905-1416) for many paths at once.

Each path runs the reference's branches (emissive stop, SSS entry, SSS
exit random walk, direct refraction march, diffuse, mirror) with next
event estimation towards every light triangle and the sky, Russian
roulette, and the (dir, rate) stack folded backward at the end
(:1410-1415). The paths of a bounce are grouped by branch; every ray
query finds the nearest of all triangles (``nearest``). The
faithfulness quirks are the reference's: a primary hit on a light counts
its emission twice, a refractive material takes k = 2, SSS divides by its
branch's share, a mirror takes k / (RR / pi), a direct refraction that
escapes the scene kills its path.
"""

from __future__ import annotations

import itertools

import torch

from . import envmap, rng
from .camera import primary_rays
from .vec import V3, cross, div, dot, normalize, put, rows, sqrt, stack, take, where

PI = 3.1415926            # PathTrace.cu:36
INF = 2147483647.0        # a miss (PathTrace.cu:23)
EMISSIVE_STOP = 1.4e-5    # a path that meets a light stops (PathTrace.cu:916-919)
EMISSIVE_SKIP = 1.5e-4    # a continuation onto a light ends the path (:1005)
BOX_RAYS = 1024           # rays of a block of ``nearest``'s box tests
PAIR_BLOCK = 1 << 16      # (ray, cluster) pairs whose triangles are tested at once


def _box_pairs(t, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(ray, cluster) pairs [P, 2] of the rays ``o``, ``d`` ([R, 3],
    float32) whose paths from t = 0 on meet the cluster's box (slab test;
    an axis that a ray runs along, in its slab, bounds nothing)."""
    inv = torch.reciprocal(d)
    near = torch.full((o.shape[0], t.box_lo.shape[0]), -torch.inf, device=o.device)
    far = torch.full_like(near, torch.inf)
    for k in range(3):
        a = (t.box_lo[None, :, k] - o[:, k, None]) * inv[:, k, None]
        b = (t.box_hi[None, :, k] - o[:, k, None]) * inv[:, k, None]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        near = torch.maximum(near, torch.where(torch.isnan(lo), -torch.inf, lo))
        far = torch.minimum(far, torch.where(torch.isnan(hi), torch.inf, hi))
    ok = (far >= near) & (far >= 0.0) & torch.isfinite(d).all(dim=1)[:, None]
    return ok.nonzero()


def nearest(t, o: V3, d: V3, exclude: torch.Tensor):
    """Nearest hit of each ray (``d`` need not be unit; it is normalised)
    against every triangle but ``exclude`` (Moller-Trumbore, no epsilon:
    a parallel ray's inf or NaN fails the tests) -> (hit, load-order id
    (0 on a miss), t (INF on a miss)). On equal t the lowest id wins.

    A triangle that a ray meets lies in a cluster whose box the ray
    meets, so only those clusters' triangles are tested: the answer is
    that of testing every triangle."""
    n = o.x.shape[0]
    d = normalize(d)
    dev, dt = o.x.device, t.dtype
    best_t = torch.full((n,), INF, dtype=dt, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    o32, d32 = stack(o).float(), stack(d).float()
    big = torch.iinfo(torch.int64).max
    for r0 in range(0, n, BOX_RAYS):
        r1 = min(r0 + BOX_RAYS, n)
        pairs = _box_pairs(t, o32[r0:r1], d32[r0:r1])
        bt = torch.full((r1 - r0,), INF, dtype=dt, device=dev)
        bi = torch.full((r1 - r0,), big, dtype=torch.int64, device=dev)
        pair_t, pair_i = [], []
        for p0 in range(0, pairs.shape[0], PAIR_BLOCK):
            ray, cl = pairs[p0:p0 + PAIR_BLOCK].unbind(1)
            tri = t.cluster[cl]
            ids = tri.clamp_min(0)
            oc = V3(*(c[r0:r1][ray, None] for c in o))
            dc = V3(*(c[r0:r1][ray, None] for c in d))
            p1 = V3(*(c[ids] for c in t.p1))
            e1 = V3(*(c[ids] for c in t.e1))
            e2 = V3(*(c[ids] for c in t.e2))
            h = cross(dc, e2)
            f = torch.reciprocal(dot(e1, h))
            s = oc - p1
            u = f * dot(s, h)
            q = cross(s, e1)
            v = f * dot(dc, q)
            tt = f * dot(e2, q)
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > 0.0) & (tri >= 0)
                  & (tri != exclude[r0:r1][ray, None]))
            tt = torch.where(ok, tt, INF)
            tc = tt.amin(dim=1)
            # the lowest id among a pair's triangles at its nearest t
            pair_t.append((ray, tc))
            pair_i.append(torch.where(tt == tc[:, None], tri, big).amin(dim=1))
            bt = bt.scatter_reduce(0, ray, tc, "amin")
        for (ray, tc), ic in zip(pair_t, pair_i):
            at_best = (tc == bt[ray]) & (tc < INF)
            bi = bi.scatter_reduce(0, ray[at_best], ic[at_best], "amin")
        best_t[r0:r1] = bt
        best_i[r0:r1] = torch.where(bt < INF, bi, 0)
    return best_t < INF, best_i, best_t


def sky(t, d: V3, clamp: float) -> V3:
    return envmap.sample(t.env, normalize(d), clamp)


def sphere_dir(u_cos, u_phi) -> V3:
    """Uniform unit direction (PathTrace.cu:968-971)."""
    cos_t = 2.0 * (u_cos - 0.5)
    sin_t = sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = (2.0 * PI) * u_phi
    return V3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def tri_point(t, tri, u, v) -> V3:
    """A uniform point by folded barycentrics (PathTrace.cu:936-945)."""
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    p = t.tri_p[tri]
    p1, p2, p3 = rows(p[:, 0]), rows(p[:, 1]), rows(p[:, 2])
    return V3(p1.x + (p2.x - p1.x) * u + (p3.x - p1.x) * v,
              p1.y + (p2.y - p1.y) * u + (p3.y - p1.y) * v,
              p1.z + (p2.z - p1.z) * u + (p3.z - p1.z) * v)


def schlick_r0(ior):
    r = (ior - 1.0) / (ior + 1.0)
    return r * r


def fresnel_entry(r0, c):
    oc = 1.0 - c
    oc2 = oc * oc
    return r0 + (1.0 - r0) * oc2 * oc2 * oc


def fresnel_exit(r0, c):
    """R0 - (1-R0)(1-c)^5: the reference's sign (PathTrace.cu:1100-1102)."""
    oc = 1.0 - c
    oc2 = oc * oc
    return r0 - (1.0 - r0) * oc2 * oc2 * oc


def refract_dir(d_in: V3, n: V3, eta):
    """gen_refract_ray (PathTrace.cu:876-894) -> (dir, total internal
    reflection); on total internal reflection ``d_in`` comes back."""
    cosi = dot(d_in, n)
    n = where(cosi > 0, -n, n)
    cosi = torch.abs(cosi)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    full = cost2 <= 0
    out = d_in * eta + n * (eta * cosi - sqrt(torch.clamp_min(cost2, 0.0)))
    return where(full, d_in, out), full


def area_pick(t, u, obj):
    """The exit triangle by area (PathTrace.cu:1031-1048): the reference's
    bisection over the object's load-order prefix sums; its final middle
    (0 if the loop never runs)."""
    target = u * t.obj_total_area[obj]
    left, right = t.seg_begin[obj].clone(), t.seg_end[obj].clone()
    middle = torch.zeros_like(left)
    go = left < right - 1
    while bool(go.any()):
        m = torch.div(left + right, 2, rounding_mode="floor")
        middle = torch.where(go, m, middle)
        le = target <= t.prefix_area[m]
        right = torch.where(go & le, m, right)
        left = torch.where(go & ~le, m, left)
        go = left < right - 1
    return middle


def _col(x):
    return x[:, None]


class _Draws:
    """The draws of one bounce for a group of paths, by site."""

    BASE = [rng.SELECT_REFRACT, rng.SELECT_SSS, rng.HDR_COS, rng.HDR_PHI, rng.RR,
            rng.CONT_COS, rng.CONT_PHI, rng.AREA_CDF, rng.EXIT_U, rng.EXIT_V]

    def __init__(self, pixel, sample, bounce, seed, n_lights, dtype):
        self.key = (pixel, sample, bounce + 1, seed)
        self.dtype = dtype
        sites = self.BASE + [rng.LIGHT_BASE + j for j in range(2 * n_lights)]
        u = rng.uniform_sites(*self.key[:3], sites, seed).to(dtype)
        self.rows = {s: u[k] for k, s in enumerate(sites)}

    def __call__(self, site, idx=None):
        if site not in self.rows:
            p, s, b, seed = self.key
            self.rows[site] = rng.uniform(p, s, b, site, seed).to(self.dtype)
        r = self.rows[site]
        return r if idx is None else r[idx]


def _nee(t, cfg, order, u, sel, src: V3, nrm: V3, out: V3, exclude, f_term=None,
         gate=True, r0=None, bss=None, total_area=None) -> torch.Tensor:
    """Next event estimation towards each light (PathTrace.cu:934-963; the
    exit form :1074-1107 with ``r0``, ``bss``, ``total_area``) for the
    paths ``sel`` of the bounce's group -> radiance [n, 3]."""
    n = src.x.shape[0]
    acc = torch.zeros((n, 3), dtype=t.dtype, device=src.x.device)
    for i, light in enumerate(order):
        tri = t.lights[light].expand(n)
        lp = tri_point(t, tri, u(rng.LIGHT_BASE + 2 * i, sel), u(rng.LIGHT_BASE + 2 * i + 1, sel))
        ldir = lp - src
        ok = torch.ones(n, dtype=torch.bool, device=src.x.device)
        if gate:
            ok = ~(dot(ldir, nrm) * dot(out, nrm) < 0)
        k = torch.nonzero(ok)[:, 0]
        if k.numel() == 0:
            continue
        hit, idx, _ = nearest(t, take(src, k), take(ldir, k), exclude[k])
        k = k[hit & (idx == t.lights[light])]
        if k.numel() == 0:
            continue
        ld = take(ldir, k)
        nk = take(nrm, k)
        le = t.emissive[t.obj[t.lights[light]]]
        ln = rows(t.norm[t.lights[light]])
        d2 = dot(ld, ld)
        pp = t.tri_p[t.lights[light]]
        c = torch.linalg.cross(pp[1] - pp[0], pp[2] - pp[0])
        area = 0.5 * sqrt(dot(rows(c), rows(c)))
        geom = torch.abs(dot(nk, ld) * dot(ln, ld)) / d2 / d2 * area
        if r0 is None:
            acc[k] += le * f_term[k] * _col(geom)
        else:
            lu = ld * torch.reciprocal(sqrt(d2))
            fo = fresnel_exit(r0[k], torch.abs(dot(lu, nk)))
            acc[k] += div(le * _col(fo) * bss[k] * _col(geom), PI) * _col(total_area[k])
    return acc


def _continue(t, src: V3, c: V3, exclude):
    """A continuation ray: (goes on, hit id, t): it must hit, and not a light."""
    h2, i2, t2 = nearest(t, src, c, exclude)
    goes = h2 & ~(t.emissive[t.obj[i2]] >= EMISSIVE_SKIP).any(-1)
    return goes, i2, t2


def _fold_hemisphere(d: V3, n: V3, ref: V3, opposite: bool) -> V3:
    s = dot(d, n) * dot(ref, n)
    return where(s > 0 if opposite else s < 0, -d, d)


def trace_paths(t, cfg, order, pixel, sample, seed, tri0, src0: V3, out0: V3):
    """Radiance after the primary hit of each path (PathTrace.cu's
    pathTracing from its first hit ``tri0`` at ``src0``, looking back
    along ``out0``; ``seed`` a render seed a path) -> [n, 3]."""
    n = pixel.shape[0]
    dev, dt = pixel.device, t.dtype
    final = torch.zeros((n, 3), dtype=dt, device=dev)
    killed = torch.zeros(n, dtype=torch.bool, device=dev)
    pushes = []  # per bounce: (path ids, dir [m, 3], rate [m, 3])
    act = torch.arange(n, device=dev)
    src, out, tri = src0, out0, tri0
    last = torch.zeros((n, 3), dtype=dt, device=dev)
    for b in range(cfg["max_depth"]):
        if act.numel() == 0:
            break
        u = _Draws(pixel[act], sample[act], b, seed[act], len(order), dt)
        obj = t.obj[tri]
        emis = t.emissive[obj]
        stop = (emis > EMISSIVE_STOP).any(-1)
        final[act[stop]] = emis[stop]
        m = act.numel()
        l_dir = torch.zeros((m, 3), dtype=dt, device=dev)
        rate = torch.zeros((m, 3), dtype=dt, device=dev)
        goes = torch.zeros(m, dtype=torch.bool, device=dev)
        n_src, n_out, n_tri = src, out, tri.clone()
        nrm = rows(t.norm[tri])
        fr = div(t.brdf[obj], PI)
        mode = t.refract[obj]
        k = torch.where(mode != 0, 2.0, 1.0).to(dt)
        refr = (u(rng.SELECT_REFRACT) < 0.5) & (mode != 0) & ~stop
        sss = refr & (mode == 1)
        sss_in = sss & (u(rng.SELECT_SSS) < cfg["sss_rate"])
        groups = {
            "sss_in": sss_in,
            "sss_out": sss & ~sss_in,
            "refract": refr & (mode != 1),
            "diffuse": ~refr & ~stop & (t.reflex[obj] == 0),
            "mirror": ~refr & ~stop & (t.reflex[obj] != 0),
        }
        rr = u(rng.RR) < cfg["rr_rate"]
        for name, mask in groups.items():
            g = torch.nonzero(mask)[:, 0]
            if g.numel() == 0:
                continue
            gs, go_, gn, gt = take(src, g), take(out, g), take(nrm, g), tri[g]
            if name in ("sss_in", "diffuse"):
                f_term = div(t.refract_albedo[obj[g]], PI) if name == "sss_in" else fr[g]
                scale = _col(div(k[g], cfg["sss_rate"]) if name == "sss_in" else k[g])
                ld = _nee(t, cfg, order, u, g, gs, gn, go_, gt, f_term=f_term)
                hd = _fold_hemisphere(sphere_dir(u(rng.HDR_COS, g), u(rng.HDR_PHI, g)), gn, go_,
                                      False)
                hh, _, _ = nearest(t, gs, hd, gt)
                sk = stack(sky(t, hd, cfg["hdr_clamp"]))
                add = sk * f_term * _col(torch.abs(dot(gn, hd))) * 2 * PI
                ld = torch.where(_col(hh), ld, ld + add) * scale
                c = _fold_hemisphere(sphere_dir(u(rng.CONT_COS, g), u(rng.CONT_PHI, g)), gn, go_,
                                     False)
                cont, i2, t2 = _continue(t, gs, c, gt)
                cont &= rr[g]
                r = div(fr[g] * _col(torch.abs(dot(-c, gn))), cfg["rr_rate"]) * scale
                ns = gs + c * t2
                no = -c
            elif name == "sss_out":
                ex = area_pick(t, u(rng.AREA_CDF, g), obj[g])
                ep = tri_point(t, ex, u(rng.EXIT_U, g), u(rng.EXIT_V, g))
                en = rows(t.norm[ex])
                inner = ep - gs
                dist = sqrt(dot(inner, inner))
                sigma = t.refract_rate[t.obj[ex]]
                d_ = _col(torch.clamp_min(dist, 1e-12))
                bss = ((torch.exp(-d_ / sigma) + torch.exp(-div(d_, 3.0) / sigma))
                       / (sigma * (8.0 * PI) * d_))
                r0 = schlick_r0(t.refract_index[obj[g]])
                bss = bss * _col(fresnel_entry(r0, torch.abs(dot(gn, go_))))
                tot = t.obj_total_area[t.obj[ex]]
                ld = _nee(t, cfg, order, u, g, ep, en, go_, ex, gate=False, r0=r0, bss=bss,
                          total_area=tot)
                hd = _fold_hemisphere(sphere_dir(u(rng.HDR_COS, g), u(rng.HDR_PHI, g)), en,
                                      inner, False)
                hh, _, _ = nearest(t, ep, hd, ex)
                fo = fresnel_exit(r0, torch.abs(dot(hd, en)))
                sk = stack(sky(t, hd, cfg["hdr_clamp"]))
                add = sk * _col(fo) * bss * _col(torch.abs(dot(en, hd))) * 2
                scale = _col(div(k[g], 1 - cfg["sss_rate"]))
                ld = torch.where(_col(hh), ld, ld + add) * scale
                c = _fold_hemisphere(sphere_dir(u(rng.CONT_COS, g), u(rng.CONT_PHI, g)), en,
                                     inner, True)
                cont, i2, t2 = _continue(t, ep, c, ex)
                cont &= rr[g]
                back = -c
                fo2 = fresnel_exit(r0, torch.abs(dot(back, en)))
                r = div(bss * _col(fo2) * _col(torch.abs(dot(back, en))) * _col(tot) * 2,
                        cfg["rr_rate"]) * scale
                ns = ep + c * t2
                no = back
            elif name == "mirror":
                refl = gn * (2 * dot(go_, gn)) - go_
                h2, i2, t2 = nearest(t, gs, refl, gt)
                cu = normalize(refl)
                kr = _col(div(k[g], cfg["rr_rate"] / PI))
                w = fr[g] * kr
                sk = stack(sky(t, refl, cfg["hdr_clamp"]))
                ld = torch.where(_col(rr[g] & ~h2), sk * fr[g] * kr, torch.zeros_like(w))
                cont = rr[g] & h2
                r = w
                ns = gs + cu * t2
                no = -cu
            else:
                ld, cont, r, ns, no, i2, dead = _refract(t, cfg, u, g, gs, go_, gn, gt, obj[g],
                                                         k[g], rr[g])
                killed[act[g[dead]]] = True
            l_dir[g] = ld
            rate[g] = r
            goes[g] = cont
            n_src, n_out = put(n_src, g, ns), put(n_out, g, no)
            n_tri[g] = i2
        ended = ~goes & ~stop
        final[act[ended]] = l_dir[ended]
        pushes.append((act[goes], l_dir[goes], rate[goes]))
        last[act[goes]] = l_dir[goes]
        act = act[goes]
        src, out, tri = take(n_src, goes), take(n_out, goes), n_tri[goes]
    final[act] = last[act]  # the depth cap: the last bounce's dir, as pushed
    for ids, d, r in reversed(pushes):
        final[ids] = final[ids] * r + d
    return torch.where(_col(killed), torch.zeros_like(final), final)


def _refract(t, cfg, u, g, src: V3, out: V3, nrm: V3, tri, obj, k, rr):
    """Direct refraction (PathTrace.cu:1180-1262): the march through the
    medium, then Russian roulette and the continuation -> (dir, goes,
    rate, new src, new out, new tri, killed)."""
    m = g.numel()
    dev, dt = src.x.device, t.dtype
    miu = t.refract_index[obj]
    r0 = schlick_r0(miu)
    fi = fresnel_entry(r0, torch.abs(dot(nrm, out)))
    rdir, _ = refract_dir(-out, nrm, 1.0 / miu)
    rate = (1.0 - fi)[:, None].expand(m, 3).clone()
    excl = tri.clone()
    escaped = torch.zeros(m, dtype=torch.bool, device=dev)
    marching = torch.ones(m, dtype=torch.bool, device=dev)
    for i in range(cfg["max_refract_bounces"]):
        a = torch.nonzero(marching)[:, 0]
        if a.numel() == 0:
            break
        ra = take(rdir, a)
        hh, ii, tt = nearest(t, take(src, a), ra, excl[a])
        escaped[a[~hh]] = True
        a, ii, tt, ra = a[hh], ii[hh], tt[hh], take(ra, hh)
        marching[torch.nonzero(marching)[:, 0]] = False
        if a.numel() == 0:
            break
        n_i = rows(t.norm[ii])
        new_dir, full = refract_dir(normalize(ra), n_i, miu[a])
        rt = rate[a] * t.refract_rate[t.obj[ii]] ** _col(tt)
        src = put(src, a, take(src, a) + normalize(ra) * tt)
        fo = fresnel_exit(r0[a], torch.abs(dot(new_dir, n_i)))
        excl[a] = ii
        reflect = full | (u(rng.REFRACT_BASE + i, g[a]) < cfg["internal_reflect_rate"])
        refl_dir = new_dir - n_i * (2 * dot(new_dir, n_i))
        rt = torch.where(_col(reflect & ~full), rt * _col(fo) * 5.0, rt)
        rt = torch.where(_col(reflect), rt, rt * _col(1.0 - fo) * 1.25)
        rate[a] = rt
        rdir = put(rdir, a, where(reflect, refl_dir, new_dir))
        marching[a[reflect]] = True
    h2, i2, t2 = nearest(t, src, rdir, excl)
    cu = normalize(rdir)
    kr = _col(div(k, cfg["rr_rate"]))
    w = rate * kr
    sk = stack(sky(t, rdir, cfg["hdr_clamp"]))
    ld = torch.where(_col(rr & ~h2 & ~escaped), sk * rate * kr, torch.zeros_like(w))
    goes = rr & h2 & ~escaped
    return ld, goes, w, src + cu * t2, -cu, i2, escaped


def light_orders(t):
    """Every order of the light triangles over the light slots."""
    return list(itertools.permutations(range(int(t.lights.shape[0]))))


def render_pixels(t, cfg, cam, pixels: torch.Tensor, spp: int, seed, order,
                  block: int = 1 << 18) -> torch.Tensor:
    """Radiance sums over samples 0 .. spp-1 of ``pixels`` (flat film ids,
    row 0 at the bottom) -> [P, 3] in ``t.dtype``, added in sample order.
    ``seed``: the render seed, one for all or a tensor of one a pixel
    (pixels of several images in one batch, so that the long tail of
    paths is walked once). ``cfg``: width, height, max_depth, rr_rate,
    sss_rate, hdr_clamp, max_refract_bounces, internal_reflect_rate.
    ``order``: the light triangle of each light slot (``light_orders``)."""
    dev = pixels.device
    p = pixels.shape[0]
    seeds = torch.as_tensor(seed, dtype=torch.int64, device=dev).expand(p)
    out = torch.zeros((spp, p, 3), dtype=t.dtype, device=dev)
    pix_all = pixels.repeat(spp)
    seed_all = seeds.repeat(spp)
    smp_all = torch.arange(spp, device=dev).repeat_interleave(p)
    for b0 in range(0, pix_all.numel(), block):
        pix, smp = pix_all[b0:b0 + block], smp_all[b0:b0 + block]
        sd = seed_all[b0:b0 + block]
        o, d = primary_rays(cam, cfg["width"], cfg["height"], pix, smp, sd, t.dtype)
        hit, idx, tt = nearest(t, o, d, torch.full_like(pix, -1))
        rad = stack(sky(t, d, cfg["hdr_clamp"]))
        h = torch.nonzero(hit)[:, 0]
        if h.numel():
            le = t.emissive[t.obj[idx[h]]]
            dh = take(d, h)
            li = trace_paths(t, cfg, order, pix[h], smp[h], sd[h], idx[h],
                             take(o, h) + dh * tt[h], -dh)
            rad[h] = le + li
        flat = out.view(-1, 3)
        flat[b0:b0 + pix.numel()] = rad
    acc = torch.zeros((p, 3), dtype=t.dtype, device=dev)
    for s in range(spp):
        acc = acc + out[s]
    return acc
