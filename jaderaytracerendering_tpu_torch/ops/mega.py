"""Wrappers of the CUDA megakernel (csrc/mega.cu) and the preview kernel
(csrc/preview.cu), and their plain versions.

``mega_render`` replaces the JAX package's ops/pallas/mega.py
``render_mega`` (-> ``_mega_kernel``), ``render_preview_mega`` its
``render_preview_mega`` (-> ``_preview_kernel``). Each launches its kernel
for a scene on a CUDA device and runs its plain PyTorch version for a
scene on the CPU; anything else raises. ``LAUNCHES`` (ops/kernels.py)
counts kernel launches, so a caller can show that a run went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .kernels import LAUNCHES


def _window(cfg, pix0: int, n_px) -> int:
    """The window's pixel count (the rest of the film by default), checked."""
    npix = cfg.width * cfg.height
    n_px = npix - pix0 if n_px is None else int(n_px)
    if not (0 <= pix0 and 0 <= n_px and pix0 + n_px <= npix):
        raise ValueError(f"pixel window [{pix0}, {pix0 + n_px}) outside the film's "
                         f"{npix} pixels")
    return n_px


def mega_render_plain(sd, eye, rot, cfg, sample_base: int, spp: int, pix0: int = 0,
                      n_px: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: [4, n_px] f32, rows 0-2 the radiance
    sums over samples sample_base .. sample_base+spp-1 of the pixels pix0
    .. pix0+n_px-1, row 3 the useful rays (integrator/wavefront.trace_radiance_p,
    with the plain BVH walk on any device)."""
    from ..integrator.render import SCAN_LANES, render_batch
    from ..integrator.wavefront import nearest_planes_plain

    n_px = _window(cfg, pix0, n_px)
    out = torch.empty((4, n_px), dtype=torch.float32, device=sd.device)
    chunk = max(1, SCAN_LANES // max(spp, 1))
    for c0 in range(0, n_px, chunk):
        ids = torch.arange(pix0 + c0, pix0 + min(c0 + chunk, n_px), dtype=torch.int64,
                           device=sd.device)
        rad, rays = render_batch(sd, eye, rot, ids, sample_base, cfg, spp,
                                 query=nearest_planes_plain)
        out[0:3, c0:c0 + ids.shape[0]] = rad.T
        out[3, c0:c0 + ids.shape[0]] = rays
    return out


def mega_render(sd, eye: torch.Tensor, rot: torch.Tensor, cfg, sample_base: int, spp: int,
                pix0: int = 0, n_px: int | None = None) -> torch.Tensor:
    """Render ``spp`` samples of the pixel window pix0 .. pix0+n_px-1 (the
    whole film by default) -> [4, n_px] f32 (radiance sums, useful rays),
    column j for pixel pix0 + j. ``eye`` [3] and ``rot`` [4, 4] are the
    camera."""
    if sd.device.type == "cpu":
        return mega_render_plain(sd, eye, rot, cfg, sample_base, spp, pix0, n_px)
    n_px = _window(cfg, pix0, n_px)
    s = kernels.scene_args(sd, int(cfg.bvh_stack_size))
    r = kernels.render_args(eye, rot, cfg, sample_base, spp)
    out = torch.empty((4, n_px), dtype=torch.float32, device=sd.device)
    next_pixel = torch.zeros(1, dtype=torch.int32, device=sd.device)  # the work counter
    rc = kernels.library().mega_render(ctypes.byref(s), ctypes.byref(r), int(pix0), n_px,
                                       kernels.ptr(out), kernels.ptr(next_pixel),
                                       kernels.stream(sd.device))
    kernels.check_rc(rc, "mega_render")
    LAUNCHES["mega_render"] += 1
    return out


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
    camera."""
    n_px = _window(cfg, pix_offset, int(band.shape[0]))
    if sd.device.type == "cpu":
        return render_preview_mega_plain(sd, eye, rot, cfg, sample_base, spp, band, pix_offset)
    kernels.check_tensor("band", band, torch.float32, (n_px, 3), sd.device)
    if spp <= 0 or n_px == 0:
        return band
    s = kernels.scene_args(sd, int(cfg.bvh_stack_size))
    r = kernels.render_args(eye, rot, cfg, sample_base, spp)
    rc = kernels.library().preview_render(ctypes.byref(s), ctypes.byref(r), int(pix_offset),
                                          n_px, int(cfg.preview_bounces), kernels.ptr(band),
                                          kernels.stream(sd.device))
    kernels.check_rc(rc, "render_preview_mega")
    LAUNCHES["render_preview_mega"] += 1
    return band
