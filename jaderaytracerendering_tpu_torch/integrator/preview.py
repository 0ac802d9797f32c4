"""Preview integrator: the cheap 2-bounce path tracer (plane form) — the
plain PyTorch version of the CUDA preview kernel (csrc/preview.cu).

The JAX package's integrator/preview.py: the interactive preview
shader's ``pathTracing_`` (fshader_preview.fsh:332-375), uniform-sphere
bounces with pdf 1/2pi folded away from the view direction,
multiplicative ``history`` throughput, emission and sky along the way,
and no NEE shadow rays. The preview CLI renders its progressive frames
with it; the full integrator (wavefront.py) renders the offline image.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.vecmath import V3, vdot, vrows, vwhere
from ..scene import envmap
from . import sampling
from .sampling import PI
from .wavefront import _unit_p, nearest_planes

S = rng.DrawSites


def trace_preview_p(origins: V3, dirs: V3, pixel_id, sample_id, sd, cfg,
                    query=nearest_planes, max_bounce: int = 2) -> V3:
    """Primary rays (planes) -> radiance V3 at preview quality. ``query``
    is the ray query of every trace."""
    m = origins.x.shape[0]
    d_unit = _unit_p(dirs)
    ex0 = torch.full((m,), -1, dtype=torch.int32, device=origins.x.device)
    hit0, idx0, t0 = query(origins, d_unit, ex0, sd, cfg.bvh_stack_size)
    sky0 = envmap.sample_env(sd.env_map, d_unit, cfg.hdr_clamp)
    tri = torch.where(hit0, idx0, 0)
    le0 = vrows(sd.mat_emissive[sd.tri_obj[tri].long()])

    zero = torch.zeros((m,), dtype=torch.float32, device=origins.x.device)
    one = torch.ones_like(zero)
    lo = V3(zero, zero, zero)
    history = V3(one, one, one)
    active = hit0
    point = origins + d_unit * t0
    view_dir = d_unit  # incoming direction (toward the surface)

    for b in range(max_bounce):
        normal = vrows(sd.tri_norm[tri])
        brdf = vrows(sd.mat_brdf[sd.tri_obj[tri].long()])
        u = rng.uniform_sites(pixel_id, sample_id, b + 1, [S.CONT_COS, S.CONT_PHI], cfg.seed)
        wi = sampling.uniform_sphere_p(u[0], u[1])
        # fold away from the view direction (fshader_preview.fsh:343-345)
        wi = sampling.fold_opposite_hemisphere_p(wi, normal, view_dir)
        wi = vwhere(active, wi, 0.0)

        hit, idx, t = query(point, wi, torch.where(active, tri, -2), sd, cfg.bvh_stack_size)
        n_emis = vrows(sd.mat_emissive[sd.tri_obj[torch.where(hit, idx, 0)].long()])
        cos_i = torch.abs(vdot(wi, normal))
        f_r = brdf * (1.0 / PI)
        weight = f_r * cos_i * (2.0 * PI)  # / pdf = * 2pi

        wi_u = _unit_p(wi)
        sky = envmap.sample_env(sd.env_map, wi_u, cfg.hdr_clamp)
        miss = active & ~hit
        lo = lo + vwhere(miss, history * sky * weight, 0.0)
        lo = lo + vwhere(active & hit, history * n_emis * weight, 0.0)

        cont = active & hit
        history = vwhere(cont, history * weight, history)
        point = vwhere(cont, point + wi_u * t, point)
        view_dir = vwhere(cont, wi_u, view_dir)
        tri = torch.where(cont, idx, tri)
        active = cont

    return vwhere(hit0, le0 + lo, sky0)
