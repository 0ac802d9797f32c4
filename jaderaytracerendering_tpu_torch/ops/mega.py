"""Wrappers of the CUDA megakernel (csrc/mega.cu) and the preview kernel
(csrc/preview.cu), and their plain versions.

``mega_render`` replaces the JAX package's ops/pallas/mega.py
``render_mega`` (-> ``_mega_kernel``), ``render_preview_mega`` its
``render_preview_mega`` (-> ``_preview_kernel``). Each launches its kernel
for a scene on a CUDA device and runs its plain PyTorch version for a
scene on the CPU; anything else raises. ``LAUNCHES`` (ops/kernels.py)
counts kernel launches, so a caller can show that a run went through the
kernels: ``mega_render`` the megakernel's, ``mega_fold`` the fold's;
while spans are recorded the counter ``ops.mega.launches`` counts the
megakernel's launches too, ``ops.mega.bounces`` and
``ops.mega.sss_bounces`` the bounces its paths resolved, and
``ops.mega.refract_bounces`` and ``ops.mega.march_steps`` those that took
direct refraction and their march's traces (on the card from each
launch's stamps, ``count_stamps``; the plain version as it renders).

The megakernel's work items are (pixel, sample) pairs, ``spp`` a pixel;
each item leaves a float4 partial in a scratch buffer that the fold
kernel sums per pixel in sample order. ``launch_windows`` splits a call
into launches of at most ``MAX_ITEMS`` items, which bounds the scratch.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.film import check_window, window_pixels
from ..utils import logging
from ..utils.logging import span
from . import kernels
from .kernels import LAUNCHES

MAX_ITEMS = 1 << 26  # work items of one launch: 1 GiB of float4 partials
_NEVER = (1 << 63) - 1  # a stamp's start before atomicMin


def launch_windows(n_px: int, spp: int) -> list[tuple[int, int]]:
    """(first slot, slots) of each launch of a window of ``n_px`` slots: as
    many slots as ``MAX_ITEMS`` items (``spp`` a slot) hold, at least one,
    the last window shorter. A pixel's sum does not depend on the launch
    that holds it."""
    per = max(1, MAX_ITEMS // max(1, int(spp)))
    return [(a, min(per, n_px - a)) for a in range(0, n_px, per)]


def scratch_shape(n_px: int, spp: int) -> tuple[int, int]:
    """The partials' shape, [items of the largest launch, 4] f32 (one
    float4 an item: three radiance sums, the useful rays' int bits)."""
    wins = launch_windows(n_px, spp)
    return (max((n for _, n in wins), default=0) * max(0, int(spp)), 4)


def _window(cfg, pix0: int, n_px, row_step: int = 1) -> int:
    """The window's slot count (the rest of the film by default), checked
    (core/film.check_window)."""
    n_px = cfg.width * cfg.height - pix0 if n_px is None else int(n_px)
    check_window(cfg.width, cfg.height, pix0, n_px, row_step)
    return n_px


def mega_render_plain(sd, eye, rot, cfg, sample_base: int, spp: int, pix0: int = 0,
                      n_px: int | None = None, row_step: int = 1) -> torch.Tensor:
    """The plain PyTorch version: [4, n_px] f32, rows 0-2 the radiance
    sums over samples sample_base .. sample_base+spp-1 of the window's
    slots (``mega_render``), row 3 the useful rays
    (integrator/wavefront.trace_radiance_p, with the plain BVH walk on any
    device). While spans are recorded it adds its bounces to the counters
    ``ops.mega.bounces``, ``ops.mega.sss_bounces``,
    ``ops.mega.refract_bounces`` and ``ops.mega.march_steps``, as the
    kernel's stamps do."""
    from ..integrator.render import SCAN_LANES, render_batch
    from ..integrator.wavefront import nearest_planes_plain

    n_px = _window(cfg, pix0, n_px, row_step)
    out = torch.empty((4, n_px), dtype=torch.float32, device=sd.device)
    chunk = max(1, SCAN_LANES // max(spp, 1))
    counts = {} if logging.recording() else None
    for c0 in range(0, n_px, chunk):
        slots = torch.arange(c0, min(c0 + chunk, n_px), dtype=torch.int64, device=sd.device)
        ids = window_pixels(pix0, slots, row_step, cfg.width)
        rad, rays = render_batch(sd, eye, rot, ids, sample_base, cfg, spp,
                                 query=nearest_planes_plain, counts=counts)
        out[0:3, c0:c0 + ids.shape[0]] = rad.T
        out[3, c0:c0 + ids.shape[0]] = rays
    if counts:
        for name in ("bounces", "sss_bounces", "refract_bounces", "march_steps"):
            logging.count(f"ops.mega.{name}", int(counts.get(name, 0)))
    return out


def mega_render(sd, eye: torch.Tensor, rot: torch.Tensor, cfg, sample_base: int, spp: int,
                pix0: int = 0, n_px: int | None = None, stamps: list | None = None,
                row_step: int = 1) -> torch.Tensor:
    """Render ``spp`` samples of the pixel window of ``n_px`` slots from
    pixel ``pix0`` at ``row_step`` (core/film.window_pixels: pix0 .. pix0 +
    n_px - 1 at step 1; the whole film by default) -> [4, n_px] f32
    (radiance sums, useful rays), column j for the window's slot j.
    ``eye`` [3] and ``rot`` [4, 4] are the camera. ``stamps``, a list,
    receives one int64 [7] device tensor a launch (start, dry counter,
    end: %globaltimer ns; then the bounces, the SSS bounces, the direct
    refraction bounces and their march steps; ``count_stamps``)."""
    if sd.device.type == "cpu":
        return mega_render_plain(sd, eye, rot, cfg, sample_base, spp, pix0, n_px, row_step)
    n_px = _window(cfg, pix0, n_px, row_step)
    s = kernels.scene_args(sd, int(cfg.bvh_stack_size))
    r = kernels.render_args(eye, rot, cfg, sample_base, spp, row_step)
    lib = kernels.library()
    out = torch.empty((4, n_px), dtype=torch.float32, device=sd.device)
    wins = launch_windows(n_px, spp)
    part = torch.empty(scratch_shape(n_px, spp), dtype=torch.float32, device=sd.device)
    next_item = torch.zeros(len(wins), dtype=torch.int32, device=sd.device)  # work counters
    for i, (a, n) in enumerate(wins):
        st = None
        if stamps is not None and spp > 0:  # no samples: no megakernel to stamp
            st = torch.full((7,), _NEVER, dtype=torch.int64, device=sd.device)
            st[2:] = 0
            stamps.append(st)
        rc = lib.mega_render(ctypes.byref(s), ctypes.byref(r), int(pix0), a, n,
                             ctypes.c_void_p(out.data_ptr() + 4 * a), n_px, kernels.ptr(part),
                             ctypes.c_void_p(next_item.data_ptr() + 4 * i),
                             None if st is None else kernels.ptr(st), kernels.stream(sd.device))
        kernels.check_rc(rc, "mega_render")
        LAUNCHES["mega_render"] += int(spp > 0)  # no samples: no items, the fold alone
        LAUNCHES["mega_fold"] += 1
        logging.count("ops.mega.launches", int(spp > 0))
    return out


def count_stamps(stamps: list) -> None:
    """Add the launches' times, tails, bounces and marches
    (``mega_render``'s ``stamps``, read once the work is done) to the
    counters ``ops.mega.launch_us`` (end less start) and
    ``ops.mega.tail_us`` (end less the first handout that found the
    counter dry), rounded to whole us over the list, ``ops.mega.bounces``,
    ``ops.mega.sss_bounces``, ``ops.mega.refract_bounces`` and
    ``ops.mega.march_steps``."""
    if not stamps:
        return
    t = torch.stack(stamps).cpu()
    logging.count("ops.mega.launch_us", round(int((t[:, 2] - t[:, 0]).sum()) / 1e3))
    logging.count("ops.mega.tail_us", round(int((t[:, 2] - t[:, 1]).sum()) / 1e3))
    for i, name in enumerate(("bounces", "sss_bounces", "refract_bounces", "march_steps"), 3):
        logging.count(f"ops.mega.{name}", int(t[:, i].sum()))


def render_preview_mega_plain(sd, eye, rot, cfg, sample_base: int, spp: int,
                              band: torch.Tensor, pix_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version: adds the preview radiance sums over
    samples sample_base .. sample_base+spp-1 of pixels pix_offset ..
    pix_offset+len(band)-1 into ``band`` [n_px, 3] f32 in place and returns
    it (integrator/preview.trace_preview_p with ``cfg.preview_bounces``
    bounces, the plain BVH walk on any device)."""
    from ..integrator.render import render_window
    from ..integrator.wavefront import nearest_planes_plain

    if spp > 0:
        render_window(sd, eye, rot, band, pix_offset, sample_base,
                      cfg.replace(integrator="preview"), spp, query=nearest_planes_plain)
    return band


def render_preview_mega(sd, eye: torch.Tensor, rot: torch.Tensor, cfg, sample_base: int,
                        spp: int, band: torch.Tensor, pix_offset: int = 0) -> torch.Tensor:
    """One progressive preview frame over the pixel window [pix_offset,
    pix_offset + len(band)): adds the radiance sums of ``spp`` samples from
    ``sample_base`` into ``band`` [n_px, 3] f32 (the window's rows of a
    film) in place and returns it. ``eye`` [3] and ``rot`` [4, 4] are the
    camera. Under a profiler the call is the span
    ``ops.mega.render_preview_mega`` (utils/logging.py): the argument
    structures and the launch, a child of a preview frame's span."""
    with span("ops.mega.render_preview_mega"):
        n_px = _window(cfg, pix_offset, int(band.shape[0]))
        if sd.device.type == "cpu":
            return render_preview_mega_plain(sd, eye, rot, cfg, sample_base, spp, band,
                                             pix_offset)
        kernels.check_tensor("band", band, torch.float32, (n_px, 3), sd.device)
        if spp <= 0 or n_px == 0:
            return band
        s = kernels.scene_args(sd, int(cfg.bvh_stack_size))
        r = kernels.render_args(eye, rot, cfg, sample_base, spp)
        rc = kernels.library().preview_render(ctypes.byref(s), ctypes.byref(r),
                                              int(pix_offset), n_px, int(cfg.preview_bounces),
                                              kernels.ptr(band), kernels.stream(sd.device))
        kernels.check_rc(rc, "render_preview_mega")
        LAUNCHES["render_preview_mega"] += 1
        return band
