"""CPU reference integrator: the correctness oracle.

The JAX package's cpuref/integrator.py in torch: a deliberately *branchy,
per-path* transcription of the CUDA megakernel's control flow
(pathTracing, PathTrace.cu:905-1416) — real if/else per bounce, a real
Python replay stack folded backward at the end — sharing nothing with
integrator/wavefront.py, the kernels or their plain versions except the
sampling primitives (integrator/sampling.py, scene/envmap.py,
core/camera.py), the keyed RNG (core/rng.py) and the brute-force nearest
hit (ops/bruteforce.py). Draws are keyed by (pixel, sample, bounce, site),
so the oracle consumes the engines' random streams and must agree with
them to float precision (tests/test_torch_cpuref.py, cli/rmse_gate.py).

Vectors are [3] float32 CPU tensors; the helpers run on one-element
tensors. Slow by design: small films only, on a scene built with
``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..core import camera as camera_mod, rng
from ..core.vecmath import vnormalize, vrows, vstack
from ..integrator import sampling
from ..integrator.sampling import PI
from ..ops import bruteforce
from ..scene import envmap

S = rng.DrawSites
_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def _normalize(v):
    return vstack(vnormalize(vrows(v)))


def _nearest1(o, d, exclude, sd):
    h, i, t = bruteforce.nearest_hit(o[None], d[None],
                                     torch.tensor([exclude], dtype=torch.int32),
                                     sd.tri_p1, sd.tri_p2, sd.tri_p3)
    return bool(h[0]), int(i[0]), float(t[0])


def _sky(d, sd, cfg):
    return vstack(envmap.sample_env(sd.env_map, vnormalize(vrows(d)), clamp=cfg.hdr_clamp))


class _Draws:
    """One path's U[0, 1) draws by (bounce, site), the sites of a bounce
    hashed together on their first use: row k of ``rng.uniform_sites``
    equals ``rng.uniform(pixel, sample, bounce + 1, sites[k], seed)``."""

    def __init__(self, pixel, sample, sd, cfg):
        self.sites = ([S.SELECT_REFRACT, S.SELECT_SSS, S.HDR_COS, S.HDR_PHI, S.RR,
                       S.CONT_COS, S.CONT_PHI, S.AREA_CDF, S.EXIT_U, S.EXIT_V]
                      + [S.REFRACT_BASE + i for i in range(cfg.max_refract_bounces)]
                      + [S.LIGHT_BASE + j for j in range(2 * sd.n_emit)])
        self.row = {site: k for k, site in enumerate(self.sites)}
        self.key = (pixel, sample, cfg.seed)
        self.bounces = {}

    def __call__(self, b, site) -> float:
        draws = self.bounces.get(b)
        if draws is None:
            pixel, sample, seed = self.key
            draws = rng.uniform_sites(pixel, sample, b + 1, self.sites, seed).tolist()
            self.bounces[b] = draws
        return draws[self.row[site]]


def _sphere_dir(u1, u2):
    return vstack(sampling.uniform_sphere_p(_f32(u1), _f32(u2)))


def _tri_point(sd, tri, u, v):
    return vstack(sampling.triangle_point_p(vrows(sd.tri_p1[tri]), vrows(sd.tri_p2[tri]),
                                            vrows(sd.tri_p3[tri]), _f32(u), _f32(v)))


def _tri_area(sd, tri) -> float:
    """0.5 * |(p2-p1) x (p3-p1)| (PathTrace.cu:897-903)."""
    c = torch.linalg.cross(sd.tri_p2[tri] - sd.tri_p1[tri], sd.tri_p3[tri] - sd.tri_p1[tri])
    return 0.5 * float(torch.linalg.vector_norm(c))


def _nee_lights(sd, src, src_norm, out_dir, exclude, f_term, u, b, gate,
                exit_mode=False, r0=0.0, bss=None, total_area=0.0):
    """NEE loop over emissive triangles (PathTrace.cu:934-963 diffuse form,
    1074-1107 exit form). Returns the radiance sum."""
    acc = torch.zeros(3, dtype=_F32)
    for i in range(sd.n_emit):
        uu = u(b, S.LIGHT_BASE + 2 * i)
        vv = u(b, S.LIGHT_BASE + 2 * i + 1)
        emit_tri = int(sd.emit_idx[i])
        lp = _tri_point(sd, emit_tri, uu, vv)
        ldir = lp - src
        if gate and _dot(ldir, src_norm) * _dot(out_dir, src_norm) < 0:
            continue
        hit, idx, _ = _nearest1(src, ldir, exclude, sd)
        if not (hit and idx == emit_tri):
            continue
        le = sd.mat_emissive[sd.tri_obj[emit_tri]]
        ln = sd.tri_norm[emit_tri]
        d2 = _dot(ldir, ldir)
        area = _tri_area(sd, emit_tri)
        geom = abs(_dot(src_norm, ldir) * _dot(ln, ldir)) / d2 / d2 * area
        if exit_mode:
            lu = ldir / d2 ** 0.5
            fo = sampling.fresnel_exit(r0, abs(_dot(lu, src_norm)))
            acc = acc + le * fo * bss * geom / PI * total_area
        else:
            acc = acc + le * f_term * geom
    return acc


def trace_path(first_idx, first_point, out_dir, pixel, sample, sd, cfg):
    """Transcription of pathTracing for one path. Returns Li [3]."""
    stack = []  # (l_dir, rate) pairs
    ray_src = first_point.to(_F32)
    out_direction = out_dir.to(_F32)
    obj_hit = int(first_idx)
    l_dir = torch.zeros(3, dtype=_F32)
    u = _Draws(pixel, sample, sd, cfg)

    for b in range(cfg.max_depth):
        tri = obj_hit
        obj = int(sd.tri_obj[tri])
        normal = sd.tri_norm[tri]
        emissive = sd.mat_emissive[obj]
        if bool((emissive > 1.4e-5).any()):  # cu:916-919
            l_dir = emissive.clone()
            break
        l_dir = torch.zeros(3, dtype=_F32)
        fr = sd.mat_brdf[obj] / PI
        refract_mode = int(sd.mat_refract[obj])
        k = 2.0 if refract_mode != 0 else 1.0
        u_sel = u(b, S.SELECT_REFRACT)

        if u_sel < 0.5 and refract_mode != 0:
            if refract_mode == 1:  # SUB_SURFACE
                u_sss = u(b, S.SELECT_SSS)
                if u_sss < cfg.sss_rate:
                    # ---- SSS entry (cu:927-1028) ----
                    fr_alb = sd.mat_refract_albedo[obj] / PI
                    l_dir = l_dir + _nee_lights(
                        sd, ray_src, normal, out_direction, tri, fr_alb, u, b, gate=True,
                    )
                    hdir = _sphere_dir(u(b, S.HDR_COS), u(b, S.HDR_PHI))
                    if _dot(hdir, normal) * _dot(out_direction, normal) < 0:
                        hdir = -hdir
                    hh, _, _ = _nearest1(ray_src, hdir, tri, sd)
                    if not hh:
                        l_dir = l_dir + _sky(hdir, sd, cfg) * fr_alb * abs(
                            _dot(normal, hdir)) * 2 * PI
                    l_dir = l_dir * (k / cfg.sss_rate)
                    if u(b, S.RR) < cfg.rr_rate:
                        c = _sphere_dir(u(b, S.CONT_COS), u(b, S.CONT_PHI))
                        if _dot(c, normal) * _dot(out_direction, normal) < 0:
                            c = -c
                        h2, i2, t2 = _nearest1(ray_src, c, tri, sd)
                        em2 = sd.mat_emissive[sd.tri_obj[i2]]
                        if h2 and bool((em2 < 1.5e-4).all()):
                            rate = fr * abs(_dot(-c, normal)) / cfg.rr_rate
                            stack.append((l_dir, rate * (k / cfg.sss_rate)))
                            ray_src = ray_src + c * t2
                            out_direction = -c
                            obj_hit = i2
                        else:
                            break
                    else:
                        break
                else:
                    # ---- SSS exit random walk (cu:1029-1178) ----
                    exit_tri = int(sampling.area_cdf_pick(
                        _f32(u(b, S.AREA_CDF)), torch.tensor(obj),
                        sd.prefix_area, sd.obj_total_area, sd.seg_begin,
                        sd.seg_end, sd.mapping,
                    ))
                    ep = _tri_point(sd, exit_tri, u(b, S.EXIT_U), u(b, S.EXIT_V))
                    en = sd.tri_norm[exit_tri]
                    inner = ep - ray_src
                    dist = float(torch.linalg.vector_norm(inner))
                    sigma = sd.mat_refract_rate[sd.tri_obj[exit_tri]]
                    bss = vstack(sampling.bssrdf_p(_f32(max(dist, 1e-12)), vrows(sigma)))
                    r0 = sampling.schlick_r0(float(sd.mat_refract_index[obj]))
                    bss = bss * sampling.fresnel_entry(r0, abs(_dot(normal, out_direction)))
                    total_area = float(sd.obj_total_area[sd.tri_obj[exit_tri]])
                    l_dir = l_dir + _nee_lights(
                        sd, ep, en, out_direction, exit_tri, None, u, b, gate=False,
                        exit_mode=True, r0=r0, bss=bss, total_area=total_area,
                    )
                    hdir = _sphere_dir(u(b, S.HDR_COS), u(b, S.HDR_PHI))
                    if _dot(hdir, en) * _dot(inner, en) < 0:
                        hdir = -hdir
                    hh, _, _ = _nearest1(ep, hdir, exit_tri, sd)
                    if not hh:
                        fo = sampling.fresnel_exit(r0, abs(_dot(hdir, en)))
                        l_dir = l_dir + _sky(hdir, sd, cfg) * fo * bss * abs(
                            _dot(en, hdir)) * 2  # cu:1130
                    l_dir = l_dir * (k / (1 - cfg.sss_rate))
                    c = _sphere_dir(u(b, S.CONT_COS), u(b, S.CONT_PHI))
                    if _dot(c, en) * _dot(inner, en) > 0:
                        c = -c  # cu:1140-1142
                    if u(b, S.RR) < cfg.rr_rate:
                        h2, i2, t2 = _nearest1(ep, c, exit_tri, sd)
                        em2 = sd.mat_emissive[sd.tri_obj[i2]]
                        if h2 and bool((em2 < 1.5e-4).all()):
                            back = -c
                            fo = sampling.fresnel_exit(r0, abs(_dot(back, en)))
                            rate = bss * fo * abs(_dot(back, en)) \
                                * total_area * 2 / cfg.rr_rate
                            stack.append((l_dir, rate * (k / (1 - cfg.sss_rate))))
                            ray_src = ep + c * t2
                            out_direction = back
                            obj_hit = i2
                        else:
                            break
                    else:
                        break
            else:
                # ---- direct refraction (cu:1180-1262) ----
                miu = float(sd.mat_refract_index[obj])
                r0 = sampling.schlick_r0(miu)
                fi = sampling.fresnel_entry(r0, abs(_dot(normal, out_direction)))
                rdir, _ = sampling.refract_dir_p(vrows(-out_direction), vrows(normal), 1.0 / miu)
                rdir = vstack(rdir)
                rate = torch.full((3,), 1.0 - fi, dtype=_F32)
                src = ray_src
                excl = tri
                escaped = False
                for i in range(cfg.max_refract_bounces):
                    hh, ii, tt = _nearest1(src, rdir, excl, sd)
                    if not hh:
                        escaped = True
                        break
                    n_i = sd.tri_norm[ii]
                    new_rdir, full_reflex = sampling.refract_dir_p(
                        vnormalize(vrows(rdir)), vrows(n_i), miu)
                    new_rdir = vstack(new_rdir)
                    full_reflex = bool(full_reflex)
                    rate = rate * sd.mat_refract_rate[sd.tri_obj[ii]] ** tt
                    src = src + _normalize(rdir) * tt
                    fo = sampling.fresnel_exit(r0, abs(_dot(new_rdir, n_i)))
                    excl = ii
                    if full_reflex or u(b, S.REFRACT_BASE + i) < cfg.internal_reflect_rate:
                        rdir = new_rdir - n_i * (2 * _dot(new_rdir, n_i))
                        if not full_reflex:
                            rate = rate * fo * 5.0
                    else:
                        rate = rate * (1.0 - fo) * 1.25
                        rdir = new_rdir
                        break
                if escaped:
                    return torch.zeros(3, dtype=_F32)  # cu:1231 kills the path
                if u(b, S.RR) < cfg.rr_rate:
                    h2, i2, t2 = _nearest1(src, rdir, excl, sd)
                    if h2:
                        cu = _normalize(rdir)
                        stack.append((torch.zeros(3, dtype=_F32), rate * (k / cfg.rr_rate)))
                        ray_src = src + cu * t2
                        out_direction = -cu
                        obj_hit = i2
                    else:
                        l_dir = _sky(rdir, sd, cfg) * rate * (k / cfg.rr_rate)
                        break
                else:
                    break
        else:
            if int(sd.mat_reflex[obj]) == 0:
                # ---- diffuse (cu:1266-1363) ----
                l_dir = l_dir + _nee_lights(
                    sd, ray_src, normal, out_direction, tri, fr, u, b, gate=True,
                )
                hdir = _sphere_dir(u(b, S.HDR_COS), u(b, S.HDR_PHI))
                if _dot(hdir, normal) * _dot(out_direction, normal) < 0:
                    hdir = -hdir
                hh, _, _ = _nearest1(ray_src, hdir, tri, sd)
                if not hh:
                    l_dir = l_dir + _sky(hdir, sd, cfg) * fr * abs(
                        _dot(normal, hdir)) * 2 * PI
                l_dir = l_dir * k
                if u(b, S.RR) < cfg.rr_rate:
                    c = _sphere_dir(u(b, S.CONT_COS), u(b, S.CONT_PHI))
                    if _dot(c, normal) * _dot(out_direction, normal) < 0:
                        c = -c
                    h2, i2, t2 = _nearest1(ray_src, c, tri, sd)
                    em2 = sd.mat_emissive[sd.tri_obj[i2]]
                    if h2 and bool((em2 < 1.5e-4).all()):
                        rate = fr * abs(_dot(-c, normal)) / cfg.rr_rate
                        stack.append((l_dir, rate * k))
                        ray_src = ray_src + c * t2
                        out_direction = -c
                        obj_hit = i2
                    else:
                        break
                else:
                    break
            else:
                # ---- mirror (cu:1365-1405) ----
                if u(b, S.RR) < cfg.rr_rate:
                    refl = normal * (2 * _dot(out_direction, normal)) - out_direction
                    h2, i2, t2 = _nearest1(ray_src, refl, tri, sd)
                    if h2:
                        cu = _normalize(refl)
                        stack.append((torch.zeros(3, dtype=_F32),
                                      fr * (k / (cfg.rr_rate / PI))))
                        ray_src = ray_src + cu * t2
                        out_direction = -cu
                        obj_hit = i2
                    else:
                        l_dir = _sky(refl, sd, cfg) * fr * (k / (cfg.rr_rate / PI))
                        break
                else:
                    break

    for d, r in reversed(stack):  # cu:1410-1415
        l_dir = l_dir * r + d
    return l_dir


def render_radiance(sd, cam, cfg) -> torch.Tensor:
    """Per-path oracle render -> [H, W, 3] float32 mean radiance on the CPU
    (small films only). ``sd`` is a scene built with ``device="cpu"``; a
    scene elsewhere is refused, never moved."""
    if sd.device.type != "cpu":
        raise ValueError(f"cpuref renders on the CPU, one path at a time; the scene is on "
                         f"{sd.device}: build its CPU copy with assemble(..., device='cpu')")
    eye, rot = camera_mod.camera_tensors(cam, "cpu")
    npix = cfg.width * cfg.height
    out = torch.zeros((npix, 3), dtype=_F32)
    for pix in range(npix):
        for s in range(cfg.spp):
            o, d = camera_mod.generate_rays(
                eye, rot, cfg.width, cfg.height, torch.tensor([pix]), s,
                cfg.seed, cfg.jitter,
            )
            o, d = o[0], d[0]
            hit, idx, t = _nearest1(o, d, -1, sd)
            if not hit:
                out[pix] += _sky(d, sd, cfg)
                continue
            le = sd.mat_emissive[sd.tri_obj[idx]]
            li = trace_path(idx, o + d * t, -d, pix, s, sd, cfg)
            out[pix] += le + li
    return (out / cfg.spp).reshape(cfg.height, cfg.width, 3)
