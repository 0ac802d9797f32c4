"""Megakernel render engine: the film in one kernel launch per
``mega_spp_batch`` samples.

The JAX package's integrator/mega.py ``render_film_mega`` without its TPU
eligibility and VMEM-budget logic and table packing: any scene on the
card runs here. Each launch renders samples ``film.count + done ..`` of
every pixel (ops/mega.py ``mega_render``) and its radiance sums are
folded into the Film. ``render_window_mega`` does the same for a pixel
window, the tile shard of a multi-device render (parallel/sharding.py).
The preview's frames through the preview kernel are routed in
integrator/render.py (``render_film_preview``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import camera as camera_mod
from ..core.film import Film
from ..ops import mega as megak
from ..utils.config import RenderConfig


def host_camera(cam):
    """(eye, rot) on the host: a kernel takes the camera by value in its
    launch arguments, so host tensors spare each launch a copy back from
    the card, which would wait for the work queued before it. (A scene on
    the CPU runs the plain versions, which take them as they are.)"""
    return camera_mod.camera_tensors(cam, "cpu")


def render_window_mega(sd, cam, cfg: RenderConfig, acc, pix0: int, sample_base: int,
                       spp: int) -> float:
    """Add the radiance sums of ``spp`` samples from ``sample_base`` of the
    pixels pix0 .. pix0+len(acc)-1 into ``acc`` [n_px, 3] in place, one
    launch per ``mega_spp_batch`` samples -> the useful rays traced."""
    eye, rot = host_camera(cam)
    n_px = acc.shape[0]
    rays = torch.zeros((), dtype=torch.float64, device=acc.device)
    done = 0
    while done < spp and n_px:
        step = min(max(1, cfg.mega_spp_batch), spp - done)
        out = megak.mega_render(sd, eye, rot, cfg, sample_base + done, step, pix0, n_px)
        acc += out[0:3].T
        rays += out[3].sum(dtype=torch.float64)
        done += step
    return float(rays)


def render_film_mega(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                     stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples through the megakernel -> Film.
    ``stats``, when given, receives ``rays``: the useful rays traced."""
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    acc = film.accum.reshape(-1, 3).clone()
    rays = render_window_mega(sd, cam, cfg, acc, 0, film.count, cfg.spp)
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + rays
    return Film(acc.reshape(cfg.height, cfg.width, 3), film.count + cfg.spp)
