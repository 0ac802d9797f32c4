"""Render orchestration: (pixel, sample) lanes -> Film -> display image.

``render_film`` routes by engine: ``mega`` launches the CUDA megakernel
(integrator/mega.py), ``pool`` runs the wavefront pool engine
(integrator/pool.py: spawn, trace, front and resolve kernels), ``scan``
runs the torch integrator (integrator/wavefront.py) over fixed-size
chunks, its ray queries through the trace kernel. ``integrator="preview"``
renders the 2-bounce preview (``render_film_preview``): engine ``mega``
through the preview kernel, any other through the torch preview
integrator (integrator/preview.py) in chunks; its display frames go
through the postfx kernel (ops/postfx.py). On CPU tensors every kernel
wrapper runs its plain version.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core.film import Film
from ..ops import mega as megak
from ..ops import postfx
from ..utils.config import RenderConfig, check_traversal
from . import wavefront

# lanes (pixels x samples) per plain-integrator call; bounds the memory
# of the batched per-bounce traces
SCAN_LANES = 1 << 16


def render_batch(sd, eye, rot, pixel_ids: torch.Tensor, sample_base: int,
                 cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes):
    """Radiance sums over ``sppb`` samples per pixel id (samples
    ``sample_base ..``, ascending) -> ([P, 3] f32, useful rays [P] f32,
    or None for the preview integrator, which counts none). ``query`` is
    the ray query (``wavefront.nearest_planes_plain`` walks the plain BVH
    on any device)."""
    p = pixel_ids.shape[0]
    pid = pixel_ids.repeat(sppb)
    sid = (torch.arange(sppb, dtype=torch.int64, device=pixel_ids.device)
           .repeat_interleave(p) + int(sample_base))
    o, d = camera_mod.generate_rays_p(eye, rot, cfg.width, cfg.height, pid,
                                      sid, cfg.seed, cfg.jitter)
    if cfg.integrator == "preview":
        from . import preview

        rad = preview.trace_preview_p(o, d, pid, sid, sd, cfg, query,
                                      max_bounce=cfg.preview_bounces)
        rays = None
    else:
        rad, rays = wavefront.trace_radiance_p(o, d, pid, sid, sd, cfg,
                                               with_stats=True, query=query)
        rays = rays.reshape(sppb, p)
    rad = torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(sppb, p, 3)
    out = rad[0]
    n = None if rays is None else rays[0]
    for s in range(1, sppb):  # ascending sample order, as the kernels sum
        out = out + rad[s]
        if rays is not None:
            n = n + rays[s]
    return out, n


def render_film(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                progress: Optional[Callable[[int, int], None]] = None,
                stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples into a Film on the scene's device.

    ``stats``, when given, receives ``rays``: the useful rays traced (and
    ``iterations`` from the pool engine); the preview integrator counts
    none."""
    check_traversal(cfg.traversal)
    if cfg.integrator == "preview":
        film = render_film_preview(sd, cam, cfg, film)
        if progress:
            progress(cfg.spp, cfg.spp)
        return film
    if cfg.integrator != "full":
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
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

    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    sppb = max(1, min(cfg.spp_batch, cfg.spp))
    accum = film.accum.reshape(-1, 3).clone()
    rays = 0.0
    done = 0
    while done < cfg.spp:
        step = min(sppb, cfg.spp - done)
        rays += render_window(sd, eye, rot, accum, 0, film.count + done, cfg, step)
        done += step
        if progress:
            progress(done, cfg.spp)
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + rays
    return Film(accum.reshape(cfg.height, cfg.width, 3), film.count + done)


def render_image(sd, cam, cfg: RenderConfig) -> np.ndarray:
    """The whole pipeline -> display u8 RGB [H, W, 3], row 0 at the top
    (the film's row 0 is the bottom of the scene, PathTrace.cu:1431), as
    the render CLI writes it: ``render_film``, the film's mean, then
    ``post/tonemap.finalize``."""
    from ..post import tonemap

    film = render_film(sd, cam, cfg)
    return tonemap.finalize(film.mean().cpu().numpy()[::-1], cfg.tonemap)


def display_frame(accum: torch.Tensor, count, mode: str) -> torch.Tensor:
    """Film -> tonemapped u8 display image [H, W, 3], flipped (film row 0
    is the bottom of the scene), on the film's device: one postfx call."""
    return postfx.postfx(accum, count, mode, flip=True)


def display_banded(accum: torch.Tensor, frame_idx: int, bands: int, spp: int,
                   mode: str) -> torch.Tensor:
    """The display of a banded film (``render_film_preview_banded``): each
    pixel divided by its own sample count, which the frame counter gives.
    The bands up to this frame's have had one more rotation than the
    rest and form a prefix of the flat film, so the display is one postfx
    call with two counts, split where that prefix ends."""
    npix = accum.shape[0] * accum.shape[1]
    band, rot = frame_idx % bands, frame_idx // bands
    return postfx.postfx(accum, (rot + 1) * spp, mode, flip=True,
                         split=(band + 1) * (npix // bands), count_hi=rot * spp)


def render_window(sd, eye, rot, out: torch.Tensor, p0: int, sample_base: int,
                  cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes) -> float:
    """The torch integrator of ``cfg`` over the pixels p0 .. p0+len(out)-1,
    chunked by ``SCAN_LANES``: adds their radiance sums over ``sppb``
    samples from ``sample_base`` into ``out`` [n, 3] in place -> the
    useful rays traced (0 for the preview integrator, which counts none).
    ``query`` as in ``render_batch``."""
    n = out.shape[0]
    chunk_px = max(1, SCAN_LANES // sppb)
    rays = 0.0
    for c0 in range(0, n, chunk_px):
        ids = torch.arange(p0 + c0, p0 + min(c0 + chunk_px, n), dtype=torch.int64,
                           device=sd.device)
        rad, n_rays = render_batch(sd, eye, rot, ids, sample_base, cfg, sppb, query=query)
        out[c0:c0 + ids.shape[0]] += rad
        if n_rays is not None:
            rays += float(n_rays.sum())
    return rays


def _preview_window(sd, cam, cfg: RenderConfig, out: torch.Tensor, p0: int,
                    sample_base: int, sppb: int) -> None:
    """Adds the preview radiance sums over ``sppb`` samples from
    ``sample_base`` of the pixels p0 .. p0+len(out)-1 into ``out`` [n, 3]
    in place: engine ``mega`` in one launch of the preview kernel, which
    adds into ``out`` itself, any other through the torch preview
    integrator (``render_window``)."""
    if cfg.engine == "mega":
        from . import mega as mega_mod

        eye, rot = mega_mod.host_camera(cam)
        megak.render_preview_mega(sd, eye, rot, cfg, sample_base, sppb, out, p0)
    else:
        eye, rot = camera_mod.camera_tensors(cam, sd.device)
        render_window(sd, eye, rot, out, p0, sample_base, cfg, sppb)


def render_film_preview_banded(sd, cam, cfg: RenderConfig, film: Optional[Film],
                               frame_idx: int):
    """Banded progressive preview: one display frame that gives band
    ``frame_idx % cfg.preview_bands`` ``cfg.spp`` new samples at sample
    base ``(frame_idx // bands) * cfg.spp`` -> (film, u8 display). Bands
    only have to divide the pixel count. The band is added to the film's
    sums in place. ``film.count`` is the largest per-pixel count (bands
    not visited yet this rotation trail by ``cfg.spp``); a whole rotation
    gives every pixel the samples of one full frame."""
    check_traversal(cfg.traversal)
    npix = cfg.width * cfg.height
    bands = cfg.preview_bands
    if npix % bands:
        raise ValueError(f"preview_bands={bands} must divide the {npix} pixels")
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    band_px = npix // bands
    off = (frame_idx % bands) * band_px
    flat = film.accum.view(-1, 3)  # a view: the band's add lands in the film
    _preview_window(sd, cam, cfg, flat[off:off + band_px], off,
                    (frame_idx // bands) * cfg.spp, cfg.spp)
    disp = display_banded(film.accum, frame_idx, bands, cfg.spp, cfg.tonemap)
    return Film(film.accum, (frame_idx // bands + 1) * cfg.spp), disp


def render_film_preview(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                        display: bool = False, frame_idx: Optional[int] = None):
    """Preview-integrator film accumulation of ``cfg.spp`` samples (engine
    ``mega``: one launch of the preview kernel; any other: ``spp_batch``
    samples at a time through the torch preview integrator).

    With ``display`` returns ``(film, u8 frame)``, the frame from
    ``display_frame``. With ``cfg.preview_bands > 1``, a ``frame_idx``
    and ``display``, renders one banded frame
    (``render_film_preview_banded``)."""
    check_traversal(cfg.traversal)
    if cfg.preview_bands > 1 and frame_idx is not None and display:
        return render_film_preview_banded(sd, cam, cfg, film, frame_idx)
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    flat = film.accum.reshape(-1, 3).clone()
    sppb = cfg.spp if cfg.engine == "mega" else max(1, min(cfg.spp_batch, cfg.spp))
    done = 0
    while done < cfg.spp:
        step = min(sppb, cfg.spp - done)
        _preview_window(sd, cam, cfg, flat, 0, film.count + done, step)
        done += step
    film = Film(flat.reshape(cfg.height, cfg.width, 3), film.count + done)
    if not display:
        return film
    return film, display_frame(film.accum, film.count, cfg.tonemap)
