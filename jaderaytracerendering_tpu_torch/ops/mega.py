"""Wrapper of the CUDA megakernel (csrc/mega.cu) and its plain version.

``mega_render`` replaces the JAX package's ops/pallas/mega.py
``render_mega`` (-> ``_mega_kernel``). It launches its kernel for a scene
on a CUDA device and runs its plain PyTorch version for a scene on the
CPU; anything else raises. ``LAUNCHES`` (ops/kernels.py) counts kernel
launches, so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .kernels import LAUNCHES


def mega_render_plain(sd, eye, rot, cfg, sample_base: int, spp: int) -> torch.Tensor:
    """The plain PyTorch version: [4, npix] f32, rows 0-2 the radiance
    sums over samples sample_base .. sample_base+spp-1 of every pixel,
    row 3 the useful rays (integrator/wavefront.trace_radiance_p, with the
    plain BVH walk on any device)."""
    from ..integrator.render import SCAN_LANES, render_batch
    from ..integrator.wavefront import nearest_planes_plain

    npix = cfg.width * cfg.height
    out = torch.empty((4, npix), dtype=torch.float32, device=sd.device)
    chunk = max(1, SCAN_LANES // max(spp, 1))
    for c0 in range(0, npix, chunk):
        ids = torch.arange(c0, min(c0 + chunk, npix), dtype=torch.int64,
                           device=sd.device)
        rad, rays = render_batch(sd, eye, rot, ids, sample_base, cfg, spp,
                                 query=nearest_planes_plain)
        out[0:3, c0:c0 + ids.shape[0]] = rad.T
        out[3, c0:c0 + ids.shape[0]] = rays
    return out


def mega_render(sd, eye: torch.Tensor, rot: torch.Tensor, cfg,
                sample_base: int, spp: int) -> torch.Tensor:
    """Render ``spp`` samples of every pixel -> [4, npix] f32 (radiance
    sums, useful rays). ``eye`` [3] and ``rot`` [4, 4] are the camera."""
    if sd.device.type == "cpu":
        return mega_render_plain(sd, eye, rot, cfg, sample_base, spp)
    s = kernels.scene_args(sd, int(cfg.bvh_stack_size))
    r = kernels.render_args(eye, rot, cfg, sample_base, spp)
    out = torch.empty((4, cfg.width * cfg.height), dtype=torch.float32,
                      device=sd.device)
    rc = kernels.library().mega_render(ctypes.byref(s), ctypes.byref(r),
                                       kernels.ptr(out), kernels.stream(sd.device))
    kernels.check_rc(rc, "mega_render")
    LAUNCHES["mega_render"] += 1
    return out
