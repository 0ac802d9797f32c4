"""Wavefront NEE path integrator on plane-form tensors — the plain
PyTorch version of the CUDA megakernel (csrc/mega.cu).

The JAX package's integrator/wavefront.py: every bounce computes all
material branches for all lanes and selects by mask (diffuse, mirror,
SSS entry, SSS exit), traces one batch of [E light + HDR + continuation]
rays, resolves Russian roulette, Fresnel, the BSSRDF and the throughput,
and the per-bounce (dir, rate) stack is folded backward at the end
(``composite_p``, PathTrace.cu:1410-1415). Faithfulness notes (a primary
light hit counts Le twice, pdf factors k = 2 for refractive materials,
1/SSS_RATE and 1/(1-SSS_RATE), mirror k/(RR/pi), the unnormalized NEE
light vector) are those of the JAX module.

One bounce is split at its trace, as the JAX package's pool splits it
into its front and resolve kernels: ``front_step`` (rows, RNG,
``bounce_front``, the segment rays) and ``resolve_step`` (``resolve_tail``
on the trace results). ``bounce_step`` runs both with one trace between;
the pool engine's plain route runs them on its own lane state.

Ray queries go through ``nearest_planes``: the trace kernel
(ops/trace.py) for CUDA tensors, the plain BVH walk for CPU tensors.
``nearest_planes_plain`` walks the plain BVH on any device; the plain
version of the megakernel passes it as the ``query`` of
``trace_radiance_p``.

Direct refraction (DIR_REFRACT materials): ``refract_march`` follows the
refracted ray through the medium before the bounce's trace (the JAX
package's ``_refract_march``, PathTrace.cu:1180-1234); its exit ray is
the bounce's continuation, and a path whose march escapes the scene is
killed (its radiance after the primary hit is zeroed). The path state is
(active, ray_src, out_dir, hit_idx, killed).
"""

from __future__ import annotations

import typing as _t

import torch

from ..core import rng
from ..core.vecmath import (V3, div, vcat, vdiv, vdot, vnorm, vnormalize, vreflect, vrows,
                            vwhere)
from ..ops import trace
from ..scene import envmap
from . import sampling
from .sampling import PI

S = rng.DrawSites

EMIT_BREAK_EPS = 1.4e-5   # PathTrace.cu:917
EMIT_SKIP_EPS = 1.5e-4    # PathTrace.cu:1005

# per-bounce draw sites, in the JAX package's row order (us[0..9]); the
# per-light sites follow: LIGHT_BASE + 2i (rows 10..10+E-1), then
# LIGHT_BASE + 2i + 1
BASE_SITES = [S.SELECT_REFRACT, S.SELECT_SSS, S.AREA_CDF, S.EXIT_U,
              S.EXIT_V, S.HDR_COS, S.HDR_PHI, S.CONT_COS, S.CONT_PHI,
              S.RR]


def _unit_p(v: V3) -> V3:
    return vnormalize(v, eps=1e-30)


def nearest_planes(o: V3, d: V3, excl, sd, stack_size: int = 128):
    """Nearest hit for plane-form rays -> (hit, idx, t). ``d`` is made
    unit (zero stays zero, i.e. a miss) and the walk normalizes it
    again, as the JAX package's ``_nearest_planes`` does. CUDA tensors
    launch the trace kernel."""
    return trace.nearest(trace.trace_segments, sd, o, d, excl, stack_size)


def nearest_planes_plain(o: V3, d: V3, excl, sd, stack_size: int = 128):
    """``nearest_planes`` through the plain BVH walk on any device."""
    return trace.nearest(trace.trace_segments_plain, sd, o, d, excl, stack_size)


class Surface(_t.NamedTuple):
    """Per-lane surface rows gathered for a triangle id plane."""

    normal: V3
    obj: torch.Tensor
    emissive: V3
    brdf: V3
    reflex: torch.Tensor
    refract: torch.Tensor
    refract_rate: V3
    refract_albedo: V3
    refract_index: torch.Tensor


def gather_rows(sd, tri) -> Surface:
    obj = sd.tri_obj[tri].long()
    return Surface(vrows(sd.tri_norm[tri]), obj, vrows(sd.mat_emissive[obj]),
                    vrows(sd.mat_brdf[obj]), sd.mat_reflex[obj],
                    sd.mat_refract[obj], vrows(sd.mat_refract_rate[obj]),
                    vrows(sd.mat_refract_albedo[obj]),
                    sd.mat_refract_index[obj])


def branch_masks(active, u_sel, u_sss, refract_mode, reflex_mode, emissive: V3,
                 sss_rate: float):
    """Branch selection (PathTrace.cu:923-931) -> (emit_break, alive,
    sss_entry, sss_exit, is_diffuse, is_mirror, is_dirref)."""
    emit_break = active & ((emissive.x > EMIT_BREAK_EPS)
                           | (emissive.y > EMIT_BREAK_EPS)
                           | (emissive.z > EMIT_BREAK_EPS))
    alive = active & ~emit_break
    take_refract = alive & (u_sel < 0.5) & (refract_mode != 0)
    is_sss = take_refract & (refract_mode == 1)
    sss_entry = is_sss & (u_sss < sss_rate)
    sss_exit = is_sss & ~(u_sss < sss_rate)
    is_diffuse = alive & ~take_refract & (reflex_mode == 0)
    is_mirror = alive & ~take_refract & (reflex_mode == 1)
    is_dirref = take_refract & (refract_mode == 2)
    return emit_break, alive, sss_entry, sss_exit, is_diffuse, is_mirror, is_dirref


class Refr(_t.NamedTuple):
    """``refract_march`` results per lane (meaningful where the lane takes
    direct refraction this bounce)."""

    dir: V3        # exit direction (raw), the bounce's continuation
    rate: V3       # throughput through the medium
    escaped: _t.Any  # the march left the scene: the path is killed
    last: _t.Any   # the last triangle hit, the continuation's exclusion
    src: V3        # the exit point, the continuation's origin


def refract_march(alive_ref, tri, miu, normal: V3, ray_src: V3, out_dir: V3, sd, cfg,
                  u_site, query, counts: _t.Optional[dict] = None) -> Refr:
    """DIR_REFRACT internal march (PathTrace.cu:1180-1234; the JAX
    package's ``_refract_march``): refract into the medium, then up to
    ``cfg.max_refract_bounces`` steps: trace to the next surface,
    absorb ``rate ** t``, refract out (Fresnel-weighted, x1.25) or
    reflect inside (total internal reflection, or a draw below
    ``internal_reflect_rate``: x Fresnel x5). ``u_site(site)`` draws the
    bounce's uniform for a site; ``query`` is the ray query. Lanes stop
    once they exit or escape; the loop ends when none is left. ``counts``,
    a dict, gets each step's tracing lanes added to ``"march_steps"``."""
    r0 = sampling.schlick_r0(miu)
    fres_i = sampling.fresnel_entry(r0, torch.abs(vdot(normal, out_dir)))
    rdir, _ = sampling.refract_dir_p(-out_dir, normal, torch.reciprocal(miu))
    rdir = vwhere(alive_ref, rdir, 0.0)
    one_m = 1.0 - fres_i
    rate = V3(one_m, one_m, one_m)
    src = ray_src
    exclude = tri
    escaped = torch.zeros_like(alive_ref)
    exited = torch.zeros_like(alive_ref)
    for i in range(cfg.max_refract_bounces):
        live = alive_ref & ~exited & ~escaped
        if not bool(live.any()):
            break
        if counts is not None:
            counts["march_steps"] = counts.get("march_steps", 0) + live.sum()
        # lanes that are not live trace a zero direction: a miss
        hit, idx, t = query(src, vwhere(live, rdir, 0.0), torch.where(live, exclude, -2), sd,
                            cfg.bvh_stack_size)
        escaped = escaped | (live & ~hit)
        step_ok = live & hit
        rdir_u = _unit_p(rdir)
        hp = src + rdir_u * t
        n_i = vrows(sd.tri_norm[idx])
        new_rdir, full_reflex = sampling.refract_dir_p(rdir_u, n_i, miu)
        rr8 = vrows(sd.mat_refract_rate[sd.tri_obj[idx].long()])
        absorb = V3(torch.pow(rr8.x, t), torch.pow(rr8.y, t), torch.pow(rr8.z, t))
        rate = vwhere(step_ok, rate * absorb, rate)
        src = vwhere(step_ok, hp, src)
        exclude = torch.where(step_ok, idx.to(exclude.dtype), exclude)
        fres_o = sampling.fresnel_exit(r0, torch.abs(vdot(new_rdir, n_i)))
        reflect_pick = full_reflex | (u_site(S.REFRACT_BASE + i) < cfg.internal_reflect_rate)
        reflected = vreflect(new_rdir, n_i)
        # exit via refraction: x1.25 compensates the 0.8 continue pdf
        rate = vwhere(step_ok & ~reflect_pick, rate * (1.0 - fres_o) * 1.25, rate)
        # internal (non-total) reflection: x fresnel_o x5 (PathTrace.cu:1220)
        rate = vwhere(step_ok & reflect_pick & ~full_reflex, rate * fres_o * 5.0, rate)
        rdir = vwhere(step_ok, vwhere(reflect_pick, reflected, new_rdir), rdir)
        exited = exited | (step_ok & ~reflect_pick)
    return Refr(rdir, rate, escaped, exclude, src)


class Front(_t.NamedTuple):
    """bounce_front results: masks, shading values and ray pieces."""

    alive: _t.Any
    emit_break: _t.Any
    needs_nee: _t.Any
    sss_entry: _t.Any
    sss_exit: _t.Any
    is_mirror: _t.Any
    is_dirref: _t.Any
    ref_escaped: _t.Any
    k: _t.Any
    u_rr: _t.Any
    fr: V3
    fr_alb: V3
    emissive: V3
    bss: V3
    r0_sss: _t.Any
    total_area: _t.Any
    nee_norm: V3
    exit_norm: V3
    nee_src: V3
    cont_src: V3
    hdir: V3
    cdir: V3
    nee_excl: _t.Any
    cont_excl: _t.Any
    ldirs: list
    l_gates: list
    ref_rate: V3


def bounce_front(active, ray_src: V3, out_dir: V3, tri, mat: Surface, us,
                 sd, cfg, refr: _t.Optional[Refr] = None) -> Front:
    """The bounce's pre-trace computation (PathTrace.cu:905-1070): branch
    selection, the SSS exit point and its shading values, and the NEE,
    HDR and continuation directions. ``us`` holds the bounce's draws in
    ``BASE_SITES`` + light order; ``refr`` the march results (needed when
    ``sd.has_refract``): a direct-refraction lane continues from the
    march's exit point along its exit direction."""
    e_cnt = sd.n_emit
    normal = mat.normal
    emit_break, alive, sss_entry, sss_exit, is_diffuse, is_mirror, is_dirref = \
        branch_masks(active, us[0], us[1], mat.refract, mat.reflex,
                     mat.emissive, cfg.sss_rate)
    k = torch.where(mat.refract != 0, 2.0, 1.0)
    fr = mat.brdf * (1.0 / PI)
    fr_alb = mat.refract_albedo * (1.0 / PI)

    if sd.has_sss:
        # BSSRDF exit point (PathTrace.cu:1029-1070): the pick is gated on
        # sss_exit; other lanes read triangle 0 and never use it
        pick = sampling.area_cdf_pick(us[2], mat.obj, sd.prefix_area,
                                      sd.obj_total_area, sd.seg_begin,
                                      sd.seg_end, sd.mapping)
        exit_tri = torch.where(sss_exit, pick, 0)
        emat = gather_rows(sd, exit_tri)
        exit_point = sampling.triangle_point_p(
            vrows(sd.tri_p1[exit_tri]), vrows(sd.tri_p2[exit_tri]),
            vrows(sd.tri_p3[exit_tri]), us[3], us[4])
        exit_norm = emat.normal
        inner_dir = exit_point - ray_src
        inner_dist = vnorm(inner_dir)
        r0_sss = sampling.schlick_r0(mat.refract_index)
        fres_i = sampling.fresnel_entry(r0_sss, torch.abs(vdot(normal, out_dir)))
        bss = sampling.bssrdf_p(torch.clamp_min(inner_dist, 1e-12),
                                emat.refract_rate) * fres_i
        total_area = sd.obj_total_area[emat.obj]
    else:
        exit_tri = torch.zeros_like(tri)
        exit_point = ray_src
        exit_norm = normal
        inner_dir = out_dir
        zero = torch.zeros_like(ray_src.x)
        bss = V3(zero, zero, zero)
        r0_sss = zero
        total_area = torch.ones_like(zero)

    # NEE origin/normal/exclusion: exit lanes shade from the exit point
    nee_src = vwhere(sss_exit, exit_point, ray_src)
    nee_norm = vwhere(sss_exit, exit_norm, normal)
    nee_excl = torch.where(sss_exit, exit_tri.to(tri.dtype), tri)

    # HDR NEE direction (PathTrace.cu:968-974 / 1111-1117)
    hdir_raw = sampling.uniform_sphere_p(us[5], us[6])
    hdir = vwhere(sss_exit,
                  sampling.fold_same_hemisphere_p(hdir_raw, exit_norm, inner_dir),
                  sampling.fold_same_hemisphere_p(hdir_raw, normal, out_dir))
    # continuation direction
    cdir_raw = sampling.uniform_sphere_p(us[7], us[8])
    cdir = vwhere(sss_exit,
                  sampling.fold_opposite_hemisphere_p(cdir_raw, exit_norm,
                                                      inner_dir),
                  sampling.fold_same_hemisphere_p(cdir_raw, normal, out_dir))
    cdir_mirror = normal * (2.0 * vdot(out_dir, normal)) - out_dir  # cu:1378
    cdir = vwhere(is_mirror, cdir_mirror, cdir)
    if sd.has_refract:
        cdir = vwhere(is_dirref, refr.dir, cdir)
        cont_src = vwhere(is_dirref, refr.src, nee_src)
        cont_excl = torch.where(is_dirref, refr.last.to(tri.dtype), nee_excl)
        ref_rate, ref_escaped = refr.rate, refr.escaped
    else:
        cont_src, cont_excl = nee_src, nee_excl
        zero = torch.zeros_like(ray_src.x)
        ref_rate, ref_escaped = V3(zero, zero, zero), torch.zeros_like(active)

    needs_nee = is_diffuse | sss_entry | sss_exit
    ldirs, l_gates = [], []
    dot_on = vdot(out_dir, normal)
    for i in range(e_cnt):
        lpoint = sampling.triangle_point_p(
            vrows(sd.light_p1[i]), vrows(sd.light_p2[i]), vrows(sd.light_p3[i]),
            us[10 + i], us[10 + e_cnt + i])
        ldir = lpoint - nee_src
        # entry-type hemisphere gate (PathTrace.cu:950-952); exit has none
        same_hemi = vdot(ldir, nee_norm) * dot_on >= 0
        ldirs.append(ldir)
        l_gates.append(needs_nee & (same_hemi | sss_exit))

    return Front(alive, emit_break, needs_nee, sss_entry, sss_exit, is_mirror,
                 is_dirref, ref_escaped, k, us[9], fr, fr_alb, mat.emissive, bss, r0_sss,
                 total_area, nee_norm, exit_norm, nee_src, cont_src, hdir, cdir, nee_excl,
                 cont_excl, ldirs, l_gates, ref_rate)


def resolve_tail(f: Front, sd, cfg, active, l_oks, sky: V3, sky_c: V3,
                 cdir_u: V3, c_obj_em: V3, c_t, c_hit, h_hit):
    """Post-trace resolve (PathTrace.cu:941-1416 epilogue): NEE light and
    env contributions, branch scales, Russian roulette, continuation
    rates and break values -> (dir_out, rate_out, new_src, accept, kill);
    ``kill`` marks the direct-refraction lanes whose march escaped (None
    without refraction)."""
    zero = torch.zeros_like(f.u_rr)
    zeros3 = V3(zero, zero, zero)
    rr = cfg.rr_rate
    f_entry = vwhere(f.sss_entry, f.fr_alb, f.fr)
    l_dir = zeros3
    for i in range(sd.n_emit):
        ldir = f.ldirs[i]
        l_norm = vrows(sd.light_norm[i])
        l_emis = vrows(sd.light_emis[i])
        d2 = vdot(ldir, ldir)
        geom = torch.abs(vdot(f.nee_norm, ldir) * vdot(l_norm, ldir)) \
            / d2 / d2 * sd.light_area[i]
        contrib = l_emis * f_entry * geom
        if sd.has_sss:
            fres_o = sampling.fresnel_exit(
                f.r0_sss, torch.abs(vdot(_unit_p(ldir), f.exit_norm)))
            contrib_exit = vdiv(l_emis * fres_o * f.bss * geom, PI) \
                * f.total_area
            contrib = vwhere(f.sss_exit, contrib_exit, contrib)
        l_dir = l_dir + vwhere(l_oks[i], contrib, 0.0)

    # NEE environment (cu:968-980 / 1111-1130)
    cos_h = torch.abs(vdot(f.hdir, f.nee_norm))
    env_c = sky * f_entry * cos_h * (2.0 * PI)
    if sd.has_sss:
        fres_oh = sampling.fresnel_exit(f.r0_sss,
                                        torch.abs(vdot(f.hdir, f.exit_norm)))
        env_exit = sky * fres_oh * f.bss * cos_h * 2.0  # cu:1130
        env_c = vwhere(f.sss_exit, env_exit, env_c)
    l_dir = l_dir + vwhere(f.needs_nee & ~h_hit, env_c, 0.0)

    # branch scale on l_dir (cu:986, 1133, 1322)
    k_entry = div(f.k, cfg.sss_rate)
    k_exit = div(f.k, 1.0 - cfg.sss_rate)
    scale = torch.where(f.sss_entry, k_entry, torch.where(f.sss_exit, k_exit, f.k))
    l_dir = vwhere(f.needs_nee, l_dir * scale, 0.0)

    # Russian roulette + continuation acceptance
    rr_ok = f.u_rr < cfg.rr_rate
    c_nonemit = torch.maximum(torch.maximum(c_obj_em.x, c_obj_em.y),
                              c_obj_em.z) < EMIT_SKIP_EPS
    accept = f.alive & rr_ok & c_hit & (f.is_mirror | f.is_dirref | c_nonemit)
    kill = None
    if sd.has_refract:  # an escaped march kills the path (cu:1254)
        accept = accept & ~(f.is_dirref & f.ref_escaped)
        kill = f.alive & f.is_dirref & f.ref_escaped

    cos_c = torch.abs(vdot(cdir_u, f.nee_norm))
    rate = vwhere(f.sss_entry, vdiv(f.fr * cos_c, rr) * k_entry,  # cu:1008
                  vdiv(f.fr * cos_c, rr) * f.k)                    # cu:1344
    if sd.has_sss:
        cos_e = torch.abs(vdot(cdir_u, f.exit_norm))
        fres_oc = sampling.fresnel_exit(f.r0_sss, cos_e)
        rate_exit = vdiv(f.bss * fres_oc * cos_e * f.total_area * 2.0, rr) \
            * k_exit  # cu:1160, 1166
        rate = vwhere(f.sss_exit, rate_exit, rate)
    rate_mirror = f.fr * div(f.k, rr / PI)  # cu:1391
    rate = vwhere(f.is_mirror, rate_mirror, rate)
    if sd.has_refract:
        rate_dirref = f.ref_rate * div(f.k, rr)
        rate = vwhere(f.is_dirref, rate_dirref, rate)

    # break values (cu:1396, 1254)
    break_val = vwhere(f.is_mirror & rr_ok & ~c_hit, sky_c * rate_mirror,
                       vwhere(f.is_mirror, zeros3, l_dir))
    if sd.has_refract:
        break_val = vwhere(f.is_dirref & rr_ok & ~c_hit & ~f.ref_escaped,
                           sky_c * f.ref_rate * div(f.k, rr),
                           vwhere(f.is_dirref, zeros3, break_val))
    break_val = vwhere(f.emit_break, f.emissive, break_val)

    # the (dir_b, rate_b) stack entry (cu:1410-1415)
    dir_out = vwhere(accept, vwhere(f.is_mirror | f.is_dirref, zeros3, l_dir),
                     vwhere(active, break_val, 0.0))
    rate_out = vwhere(accept, rate, vwhere(active, 0.0, 1.0))
    new_src = f.cont_src + cdir_u * c_t
    return dir_out, rate_out, new_src, accept, kill


def front_step(state, b, pixel_id, sample_id, sd, cfg, query=nearest_planes,
               refr: _t.Optional[Refr] = None, counts: _t.Optional[dict] = None):
    """The bounce up to its trace: rows, RNG, the refraction march (when
    ``sd.has_refract`` and no ``refr`` is given; ``query`` is its ray
    query, ``counts`` gets its steps), ``bounce_front`` and the segment
    rays. ``state`` = (active,
    ray_src V3, out_dir V3, hit_idx, killed); ``b`` is the bounce (an int,
    or a tensor of per-lane bounces). Returns (Front, seg_o, seg_d,
    seg_x): E + 2 segments (light i, then the HDR ray, then the
    continuation) and their excluded triangles; masked lanes get zero
    rays, which every walk treats as a miss."""
    active, ray_src, out_dir, hit_idx, _ = state
    e_cnt = sd.n_emit
    tri = torch.where(active, hit_idx, 0)
    mat = gather_rows(sd, tri)
    sites = (BASE_SITES + [S.LIGHT_BASE + 2 * i for i in range(e_cnt)]
             + [S.LIGHT_BASE + 2 * i + 1 for i in range(e_cnt)])
    us = rng.uniform_sites(pixel_id, sample_id, b + 1, sites, cfg.seed)
    if sd.has_refract and refr is None:
        is_dirref = branch_masks(active, us[0], us[1], mat.refract, mat.reflex,
                                 mat.emissive, cfg.sss_rate)[-1]
        refr = refract_march(
            is_dirref, tri, mat.refract_index, mat.normal, ray_src, out_dir, sd, cfg,
            lambda site: rng.uniform(pixel_id, sample_id, b + 1, site, cfg.seed), query,
            counts)
    f = bounce_front(active, ray_src, out_dir, tri, mat, us, sd, cfg, refr)
    nee_o = vwhere(f.needs_nee, f.nee_src, 0.0)
    seg_o = [nee_o] * (e_cnt + 1) + [vwhere(f.alive, f.cont_src, 0.0)]
    seg_d = ([vwhere(f.needs_nee, ld, 0.0) for ld in f.ldirs]
             + [vwhere(f.needs_nee, f.hdir, 0.0), vwhere(f.alive, f.cdir, 0.0)])
    seg_x = [f.nee_excl] * (e_cnt + 1) + [f.cont_excl]
    return f, seg_o, seg_d, seg_x


def resolve_step(f: Front, state, hits, idxs, ts, sd, cfg):
    """The bounce after its trace: per-segment hit/idx/t lists (the
    ``front_step`` segment order; only the HDR segment's hit is read) ->
    ((accept, ray_src, out_dir, hit_idx, killed), (dir_b V3, rate_b V3))."""
    active, ray_src, out_dir, hit_idx, killed = state
    e_cnt = sd.n_emit
    h_hit = hits[e_cnt]
    c_hit, c_idx, c_t = hits[e_cnt + 1], idxs[e_cnt + 1], ts[e_cnt + 1]

    m = c_t.shape[0]
    cdir_u = _unit_p(f.cdir)
    hdir_u = _unit_p(f.hdir)
    env2 = envmap.sample_env(sd.env_map, vcat([hdir_u, cdir_u]), cfg.hdr_clamp)
    sky = V3(env2.x[:m], env2.y[:m], env2.z[:m])
    sky_c = V3(env2.x[m:], env2.y[m:], env2.z[m:])
    c_obj_em = vrows(sd.mat_emissive[sd.tri_obj[torch.where(c_hit, c_idx, 0)].long()])
    # per-light visibility: exact-index test against the nearest hit
    l_oks = [f.l_gates[i] & hits[i] & (idxs[i] == sd.emit_idx[i])
             for i in range(e_cnt)]

    dir_out, rate_out, new_src, accept, kill = resolve_tail(
        f, sd, cfg, active, l_oks, sky, sky_c, cdir_u, c_obj_em, c_t, c_hit,
        h_hit)
    ray_src = vwhere(accept, new_src, ray_src)
    out_dir = vwhere(accept, -cdir_u, out_dir)
    hit_idx = torch.where(accept, c_idx.to(hit_idx.dtype), hit_idx)
    if kill is not None:
        killed = killed | kill
    return (accept, ray_src, out_dir, hit_idx, killed), (dir_out, rate_out)


def bounce_step(state, b: int, pixel_id, sample_id, sd, cfg, query=nearest_planes,
                counts: _t.Optional[dict] = None):
    """One masked bounce. ``state`` = (active, ray_src V3, out_dir V3,
    hit_idx, killed); ``query`` is the ray query (of the march too).
    ``counts``, a dict, gets the bounce's active lanes added to
    ``"bounces"``, those whose branch is SSS entry or exit to
    ``"sss_bounces"``, those whose branch is direct refraction to
    ``"refract_bounces"`` and their march's traces to ``"march_steps"``
    (0-d int64 tensors). Returns (state, (dir_b V3, rate_b V3))."""
    m = state[1].x.shape[0]
    f, seg_o, seg_d, seg_x = front_step(state, b, pixel_id, sample_id, sd, cfg, query,
                                        counts=counts)
    if counts is not None:
        counts["bounces"] = counts.get("bounces", 0) + state[0].sum()
        counts["sss_bounces"] = counts.get("sss_bounces", 0) + (f.sss_entry | f.sss_exit).sum()
        counts["refract_bounces"] = counts.get("refract_bounces", 0) + f.is_dirref.sum()
    # one nearest-hit batch of all segments
    bhit, bidx, bt = query(vcat(seg_o), vcat(seg_d), torch.cat(seg_x), sd,
                           cfg.bvh_stack_size)
    rows = [slice(s * m, (s + 1) * m) for s in range(len(seg_o))]
    return resolve_step(f, state, [bhit[r] for r in rows], [bidx[r] for r in rows],
                        [bt[r] for r in rows], sd, cfg)


def composite_p(dirs: list, rates: list) -> V3:
    """Backward replay-stack fold (PathTrace.cu:1410-1415), seeded from
    the top entry itself (for lanes alive at the depth cap the reference
    starts the fold from the last pushed l_dir)."""
    acc = dirs[-1]
    for d, r in zip(reversed(dirs), reversed(rates)):
        acc = acc * r + d
    return acc


def trace_radiance_p(origins: V3, dirs: V3, pixel_id, sample_id, sd, cfg,
                     with_stats: bool = False, query=nearest_planes,
                     counts: _t.Optional[dict] = None):
    """Primary rays -> radiance V3 (render_pixel body, cu:1426-1455).

    ``with_stats=True`` also returns each lane's count of useful rays
    (the primary plus E + 2 per bounce the lane entered alive). ``query``
    is the ray query of every trace; ``counts`` as in ``bounce_step``."""
    m = origins.x.shape[0]
    d_unit = _unit_p(dirs)
    ex0 = torch.full((m,), -1, dtype=torch.int32, device=origins.x.device)
    hit0, idx0, t0 = query(origins, d_unit, ex0, sd, cfg.bvh_stack_size)
    sky0 = envmap.sample_env(sd.env_map, d_unit, cfg.hdr_clamp)
    first = torch.where(hit0, idx0, 0)
    le0 = vrows(sd.mat_emissive[sd.tri_obj[first].long()])
    state = (hit0, origins + d_unit * t0, -d_unit, first, torch.zeros_like(hit0))
    rays = torch.ones((m,), dtype=torch.float32, device=origins.x.device)
    dir_list, rate_list = [], []
    for b in range(cfg.max_depth):
        rays = rays + state[0].to(torch.float32) * float(sd.n_emit + 2)
        state, (d_b, r_b) = bounce_step(state, b, pixel_id, sample_id, sd, cfg, query,
                                        counts)
        dir_list.append(d_b)
        rate_list.append(r_b)
    li = vwhere(state[4], 0.0, composite_p(dir_list, rate_list))  # escape kill
    radiance = vwhere(hit0, le0 + li, sky0)
    return (radiance, rays) if with_stats else radiance
