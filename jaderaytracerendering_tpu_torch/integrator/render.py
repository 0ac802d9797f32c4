"""Render orchestration: (pixel, sample) lanes -> Film -> display image.

``render_film`` looks the engine up in ``ENGINES``, the one table of
engines, and runs its window function over the whole film: ``mega``
launches the CUDA megakernel (integrator/mega.py), ``pool`` runs the
wavefront pool engine (integrator/pool.py: spawn, trace, front and
resolve kernels), ``scan`` runs the torch integrator
(integrator/wavefront.py) over fixed-size chunks, its ray queries through
the trace kernel. The multi-device render (parallel/sharding.py) runs the
same window functions over each tile rank's dealt rows.
``integrator="preview"`` renders the 2-bounce preview
(``render_film_preview``): engine ``mega`` through the preview kernel,
any other through the torch preview integrator (integrator/preview.py)
in chunks; its display frames go through the postfx kernel
(ops/postfx.py). On CPU tensors every kernel wrapper runs its plain
version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core.film import Film, window_pixels
from ..ops import mega as megak
from ..ops import postfx
from ..utils.config import RenderConfig, check_traversal
from ..utils.logging import span
from . import mega, pool, wavefront

# lanes (pixels x samples) per plain-integrator call; bounds the memory
# of the batched per-bounce traces
SCAN_LANES = 1 << 16


def render_batch(sd, eye, rot, pixel_ids: torch.Tensor, sample_base: int,
                 cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes,
                 counts: Optional[dict] = None):
    """Radiance sums over ``sppb`` samples per pixel id (samples
    ``sample_base ..``, ascending) -> ([P, 3] f32, useful rays [P] f32,
    or None for the preview integrator, which counts none). ``query`` is
    the ray query (``wavefront.nearest_planes_plain`` walks the plain BVH
    on any device); ``counts`` gets the full integrator's bounces
    (``wavefront.bounce_step``)."""
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
                                               with_stats=True, query=query, counts=counts)
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
                stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples into a Film on the scene's device.

    ``stats``, when given, receives ``rays``: the useful rays traced (and
    ``iterations`` from the pool engine); the preview integrator counts
    none. Under a profiler the call is the span
    ``integrator.render.render_film`` (utils/logging.py), a request: the
    parent of the pool's iteration spans, and the request whose number
    the image's tone map carries."""
    with span("integrator.render.render_film", request=True):
        return _render_film(sd, cam, cfg, film, stats)


def _render_film(sd, cam, cfg: RenderConfig, film: Optional[Film],
                 stats: Optional[dict]) -> Film:
    check_traversal(cfg.traversal)
    if cfg.integrator == "preview":
        return render_film_preview(sd, cam, cfg, film)
    if cfg.integrator != "full":
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    return render_film_window(window_fn(cfg.engine), sd, cam, cfg, film, stats)


def render_film_window(window, sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                       stats: Optional[dict] = None) -> Film:
    """cfg.spp samples (``film.count ..``) of every pixel through the window
    function ``window`` (``ENGINES``) over the whole film -> Film.
    ``stats``, when given, receives ``rays`` and the window's own counts."""
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    acc = film.accum.reshape(-1, 3).clone()
    rays = window(sd, cam, cfg, acc, 0, film.count, cfg.spp, stats)
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + rays
    return Film(acc.reshape(cfg.height, cfg.width, 3), film.count + cfg.spp)


def render_image(sd, cam, cfg: RenderConfig) -> np.ndarray:
    """The whole pipeline -> display u8 RGB [H, W, 3], row 0 at the top
    (the film's row 0 is the bottom of the scene, PathTrace.cu:1431), as
    the render CLI writes it: ``render_film``, the film's mean, then
    ``post/tonemap.finalize`` where the film is (on the card for a CUDA
    film)."""
    from ..post import tonemap

    film = render_film(sd, cam, cfg)
    return tonemap.finalize(film.mean(), cfg.tonemap, flip=True)


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


def render_ids(sd, eye, rot, ids: torch.Tensor, out: torch.Tensor, sample_base: int,
               cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes) -> float:
    """The torch integrator of ``cfg`` over the pixel ids ``ids`` (int64,
    on the scene's device), chunked by ``SCAN_LANES``: adds their radiance
    sums over ``sppb`` samples from ``sample_base`` into ``out`` [n, 3] in
    place -> the useful rays traced (0 for the preview integrator, which
    counts none). ``query`` as in ``render_batch``."""
    chunk_px = max(1, SCAN_LANES // sppb)
    rays = 0.0
    for c0 in range(0, ids.shape[0], chunk_px):
        rad, n_rays = render_batch(sd, eye, rot, ids[c0:c0 + chunk_px], sample_base, cfg, sppb,
                                   query=query)
        out[c0:c0 + rad.shape[0]] += rad
        if n_rays is not None:
            rays += float(n_rays.sum())
    return rays


def render_window(sd, eye, rot, out: torch.Tensor, p0: int, sample_base: int,
                  cfg: RenderConfig, sppb: int, query=wavefront.nearest_planes,
                  row_step: int = 1) -> float:
    """``render_ids`` over the slots of the pixel window from p0 at
    ``row_step`` (core/film.window_pixels: p0 .. p0+len(out)-1 at step 1)."""
    slots = torch.arange(out.shape[0], dtype=torch.int64, device=sd.device)
    ids = window_pixels(p0, slots, row_step, cfg.width)
    return render_ids(sd, eye, rot, ids, out, sample_base, cfg, sppb, query=query)


def render_window_scan(sd, cam, cfg: RenderConfig, acc: torch.Tensor, pix0: int,
                       sample_base: int, spp: int, stats: Optional[dict] = None,
                       row_step: int = 1) -> float:
    """The scan engine's window function (``ENGINES``): ``render_window``
    in steps of ``cfg.spp_batch`` samples (the last one shorter) -> the
    useful rays traced. It has no count of its own for ``stats``."""
    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    sppb = max(1, cfg.spp_batch)
    rays = 0.0
    for done in range(0, spp, sppb):
        rays += render_window(sd, eye, rot, acc, pix0, sample_base + done, cfg,
                              min(sppb, spp - done), row_step=row_step)
    return rays


# The engines: cfg.engine -> its window function fn(sd, cam, cfg, acc, pix0,
# sample_base, spp, stats=None, row_step=1) -> useful rays. It adds the
# radiance sums of spp samples from sample_base of the pixel window's
# len(acc) slots into acc [n_px, 3] in place, and any count of its own into
# stats when given. Slot j of the window is the pixel
# core/film.window_pixels(pix0, j, row_step, width): pix0 + j at row_step 1,
# else the window holds whole film rows row_step apart (a tile rank's dealt
# rows, parallel/sharding.py).
ENGINES = {"mega": mega.render_window_mega, "pool": pool.render_window_pool,
           "scan": render_window_scan}


def window_fn(engine: str):
    """The window function of ``engine`` (``ENGINES``); an unknown name
    raises ``ValueError``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return ENGINES[engine]


def _preview_window(sd, cam, cfg: RenderConfig, out: torch.Tensor, p0: int,
                    sample_base: int, sppb: int) -> None:
    """Adds the preview radiance sums over ``sppb`` samples from
    ``sample_base`` of the pixels p0 .. p0+len(out)-1 into ``out`` [n, 3]
    in place: engine ``mega`` in one launch of the preview kernel, which
    adds into ``out`` itself, any other through the torch preview
    integrator (``render_window``)."""
    if cfg.engine == "mega":
        eye, rot = mega.host_camera(cam)
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
    (``render_film_preview_banded``).

    Under a profiler each call is the span
    ``integrator.render.render_film_preview`` (utils/logging.py), one a
    frame: the frame's host path, which ``preview_host_ms`` reads; its
    children are the host camera, the preview kernel's wrapper and the
    postfx wrapper."""
    with span("integrator.render.render_film_preview", request=True):
        return _render_film_preview(sd, cam, cfg, film, display, frame_idx)


def _render_film_preview(sd, cam, cfg: RenderConfig, film: Optional[Film], display: bool,
                         frame_idx: Optional[int]):
    check_traversal(cfg.traversal)
    if cfg.preview_bands > 1 and frame_idx is not None and display:
        return render_film_preview_banded(sd, cam, cfg, film, frame_idx)
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    flat = film.accum.reshape(-1, 3).clone()
    if cfg.engine == "mega":  # one launch of the preview kernel
        _preview_window(sd, cam, cfg, flat, 0, film.count, cfg.spp)
    else:  # the torch preview integrator in spp_batch steps
        render_window_scan(sd, cam, cfg, flat, 0, film.count, cfg.spp)
    film = Film(flat.reshape(cfg.height, cfg.width, 3), film.count + cfg.spp)
    if not display:
        return film
    return film, display_frame(film.accum, film.count, cfg.tonemap)
