"""Render orchestration: (pixel, sample) lanes -> Film.

``render_film`` routes by engine: ``mega`` launches the CUDA megakernel
(integrator/mega.py), ``pool`` runs the wavefront pool engine
(integrator/pool.py: spawn, trace, front and resolve kernels), ``scan``
runs the torch integrator (integrator/wavefront.py) over fixed-size
chunks, its ray queries through the trace kernel. On CPU tensors every
kernel wrapper runs its plain version. The JAX package's preview
integrator is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import camera as camera_mod
from ..core.film import Film
from ..utils.config import RenderConfig
from . import wavefront

# lanes (pixels x samples) per plain-integrator call; bounds the memory
# of the batched per-bounce traces
SCAN_LANES = 1 << 16


def render_batch(sd, eye, rot, pixel_ids: torch.Tensor, sample_base: int,
                 cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes):
    """Radiance sums over ``sppb`` samples per pixel id (samples
    ``sample_base ..``, ascending) -> ([P, 3] f32, useful rays [P] f32).
    ``query`` is the ray query (``wavefront.nearest_planes_plain`` walks
    the plain BVH on any device)."""
    p = pixel_ids.shape[0]
    pid = pixel_ids.repeat(sppb)
    sid = (torch.arange(sppb, dtype=torch.int64, device=pixel_ids.device)
           .repeat_interleave(p) + int(sample_base))
    o, d = camera_mod.generate_rays_p(eye, rot, cfg.width, cfg.height, pid,
                                      sid, cfg.seed, cfg.jitter)
    rad, rays = wavefront.trace_radiance_p(o, d, pid, sid, sd, cfg,
                                           with_stats=True, query=query)
    rad = torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(sppb, p, 3)
    rays = rays.reshape(sppb, p)
    out, n = rad[0], rays[0]
    for s in range(1, sppb):  # ascending sample order, as the kernel sums
        out = out + rad[s]
        n = n + rays[s]
    return out, n


def render_film(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                progress: Optional[Callable[[int, int], None]] = None,
                stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples into a Film on the scene's device.

    ``stats``, when given, receives ``rays``: the useful rays traced (and
    ``iterations`` from the pool engine)."""
    if cfg.integrator != "full":
        raise NotImplementedError("the preview integrator is not ported yet")
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    if cfg.engine == "mega":
        from . import mega as mega_mod

        film = mega_mod.render_film_mega(sd, cam, cfg, film, stats)
        if progress:
            progress(cfg.spp, cfg.spp)
        return film
    if cfg.engine == "pool":
        from . import pool as pool_mod

        film = pool_mod.render_film_pool(sd, cam, cfg, film, stats)
        if progress:
            progress(cfg.spp, cfg.spp)
        return film
    if cfg.engine != "scan":
        raise ValueError(f"unknown engine {cfg.engine!r}")

    npix = cfg.width * cfg.height
    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    sppb = max(1, min(cfg.spp_batch, cfg.spp))
    chunk_px = max(1, min(npix, SCAN_LANES // sppb))
    accum = film.accum.reshape(-1, 3).clone()
    rays = 0.0
    done = 0
    while done < cfg.spp:
        step = min(sppb, cfg.spp - done)
        for c0 in range(0, npix, chunk_px):
            ids = torch.arange(c0, min(c0 + chunk_px, npix), dtype=torch.int64,
                               device=sd.device)
            out, n = render_batch(sd, eye, rot, ids, film.count + done, cfg, step)
            accum[c0:c0 + ids.shape[0]] += out
            rays += float(n.sum())
        done += step
        if progress:
            progress(done, cfg.spp)
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + rays
    return Film(accum.reshape(cfg.height, cfg.width, 3), film.count + done)

