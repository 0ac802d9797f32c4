"""Megakernel render engine: the film in one kernel launch per
``mega_spp_batch`` samples.

The JAX package's integrator/mega.py ``render_film_mega`` without its TPU
eligibility and VMEM-budget logic and table packing: any scene on the
card runs here. Each launch renders samples ``film.count + done ..`` of
every pixel (ops/mega.py ``mega_render``) and its radiance sums are
folded into the Film. The preview's frames through the preview kernel
are routed in integrator/render.py (``render_film_preview``).
"""

from __future__ import annotations

from typing import Optional

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


def render_film_mega(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                     stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples through the megakernel -> Film.
    ``stats``, when given, receives ``rays``: the useful rays traced."""
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    eye, rot = host_camera(cam)
    accum = film.accum
    rays = 0.0
    done = 0
    while done < cfg.spp:
        step = min(max(1, cfg.mega_spp_batch), cfg.spp - done)
        out = megak.mega_render(sd, eye, rot, cfg, film.count + done, step)
        accum = accum + out[0:3].T.reshape(cfg.height, cfg.width, 3)
        if stats is not None:
            rays += float(out[3].sum(dtype=float))
        done += step
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + rays
    return Film(accum, film.count + done)

