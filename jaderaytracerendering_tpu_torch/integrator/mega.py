"""Megakernel render engine: the film in one ``mega_render`` call for all
of its samples.

The JAX package's integrator/mega.py ``render_film_mega`` without its TPU
eligibility and VMEM-budget logic and table packing: any scene on the
card runs here. One call renders samples ``film.count ..`` of every pixel
(ops/mega.py ``mega_render``, which splits it into launches of pixel
windows of at most ``MAX_ITEMS`` work items), and its radiance sums are
folded into the Film. ``cfg.mega_spp_batch`` is not read: each launch
ends in the tail of its longest paths, so only the scratch's bound splits
a window's work. ``render_window_mega``, the engine's window function
(integrator/render.py ``ENGINES``), does it for a pixel window:
the whole film, or a tile rank's dealt rows in a multi-device render
(parallel/sharding.py). The preview's frames through the preview kernel
are routed in integrator/render.py (``render_film_preview``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import camera as camera_mod
from ..core.film import Film
from ..ops import mega as megak
from ..utils.config import RenderConfig
from ..utils.logging import recording, span


def host_camera(cam):
    """(eye, rot) on the host: a kernel takes the camera by value in its
    launch arguments, so host tensors spare each launch a copy back from
    the card, which would wait for the work queued before it. (A scene on
    the CPU runs the plain versions, which take them as they are.) The
    span ``integrator.mega.host_camera`` names the device's idle gaps it
    leaves in a preview frame."""
    with span("integrator.mega.host_camera"):
        return camera_mod.camera_tensors(cam, "cpu")


def render_window_mega(sd, cam, cfg: RenderConfig, acc, pix0: int, sample_base: int,
                       spp: int, stats: Optional[dict] = None, row_step: int = 1) -> float:
    """Add the radiance sums of ``spp`` samples from ``sample_base`` of the
    pixel window's slots (``pix0``, ``row_step``: core/film.window_pixels)
    into ``acc`` [n_px, 3] in place, one call of ``mega_render`` for all
    of them (in steps of ``MAX_ITEMS`` samples only where one pixel's
    items alone would overflow the scratch) -> the useful rays traced;
    nothing goes into ``stats``. While
    spans are recorded the launches' stamps are read after the rays' sync
    into the counters ``ops.mega.launch_us``, ``ops.mega.tail_us``,
    ``ops.mega.bounces``, ``ops.mega.sss_bounces``,
    ``ops.mega.refract_bounces`` and ``ops.mega.march_steps``."""
    eye, rot = host_camera(cam)
    n_px = acc.shape[0]
    rays = torch.zeros((), dtype=torch.float64, device=acc.device)
    stamps = [] if recording() else None
    done = 0
    while done < spp and n_px:
        step = min(megak.MAX_ITEMS, spp - done)
        out = megak.mega_render(sd, eye, rot, cfg, sample_base + done, step, pix0, n_px,
                                stamps=stamps, row_step=row_step)
        acc += out[0:3].T
        rays += out[3].sum(dtype=torch.float64)
        done += step
    rays = float(rays)
    if stamps:
        megak.count_stamps(stamps)
    return rays


def render_film_mega(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                     stats: Optional[dict] = None) -> Film:
    """Accumulate cfg.spp samples through the megakernel -> Film.
    ``stats``, when given, receives ``rays``: the useful rays traced."""
    from .render import render_film_window

    return render_film_window(render_window_mega, sd, cam, cfg, film, stats)
