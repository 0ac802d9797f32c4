"""Wrappers of the CUDA megakernel (csrc/mega.cu) and their plain versions.

``mega_render`` replaces the JAX package's ops/pallas/mega.py
``render_mega`` (-> ``_mega_kernel``); ``bvh_nearest`` exposes the same
kernel's BVH walk on its own. Each wrapper launches its kernel for a
scene on a CUDA device and runs its plain PyTorch version for a scene on
the CPU; anything else raises. ``LAUNCHES`` counts kernel launches, so a
caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..scene.scene import TABLES
from . import build

LAUNCHES = {"mega_render": 0, "bvh_nearest": 0}
MAX_STACK = 128  # the kernel's per-thread traversal stack (entries)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _SceneArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in TABLES]
                + [(k, ctypes.c_int) for k in ("env_h", "env_w", "n_emit",
                                               "n_nodes", "has_sss",
                                               "stack_size")])


class _RenderArgs(ctypes.Structure):
    _fields_ = [("rot", ctypes.c_float * 16), ("eye", ctypes.c_float * 3)] \
        + [(k, ctypes.c_int) for k in ("width", "height", "npix", "spp",
                                       "max_depth", "jitter_gl")] \
        + [("sample_base", ctypes.c_uint32), ("seed", ctypes.c_uint32)] \
        + [(k, ctypes.c_float) for k in ("ndc_sx", "ndc_sy", "rr_rate",
                                         "sss_rate", "one_m_sss", "rr_over_pi",
                                         "hdr_clamp")]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use, keyed by the sources' hash) and load csrc/mega.cu."""
    lib = build.load_library("mega", ["mega.cu"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_render.argtypes = [vp, vp, vp, vp]
    lib.mega_render.restype = ci
    lib.bvh_nearest.argtypes = [vp, vp, vp, vp, ci, vp, vp, vp]
    lib.bvh_nearest.restype = ci
    return lib


def _check_scene(sd, stack_size: int) -> None:
    if sd.device.type != "cuda":
        raise ValueError(f"scene tables on {sd.device}, kernel needs CUDA")
    if sd.has_refract:
        raise NotImplementedError(
            "the megakernel does not handle direct refraction (DIR_REFRACT)")
    if stack_size > MAX_STACK or sd.bvh_depth + 1 > stack_size:
        raise ValueError(f"BVH depth {sd.bvh_depth} + 1 must fit a stack of "
                         f"{stack_size} <= {MAX_STACK} entries")
    for k, dt in TABLES.items():
        t = getattr(sd, k)
        if t.device != sd.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"scene table {k}: want contiguous {dt} on "
                             f"{sd.device}, got {t.dtype} on {t.device}")


def _scene_args(sd, stack_size: int) -> _SceneArgs:
    return _SceneArgs(
        *[getattr(sd, k).data_ptr() for k in TABLES],
        int(sd.env_map.shape[0]), int(sd.env_map.shape[1]), sd.n_emit,
        sd.n_nodes, int(sd.has_sss), stack_size)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def mega_render_plain(sd, eye, rot, cfg, sample_base: int, spp: int) -> torch.Tensor:
    """The plain PyTorch version: [4, npix] f32, rows 0-2 the radiance
    sums over samples sample_base .. sample_base+spp-1 of every pixel,
    row 3 the useful rays (integrator/wavefront.trace_radiance_p)."""
    from ..integrator.render import SCAN_LANES, render_batch

    npix = cfg.width * cfg.height
    out = torch.empty((4, npix), dtype=torch.float32, device=sd.device)
    chunk = max(1, SCAN_LANES // max(spp, 1))
    for c0 in range(0, npix, chunk):
        ids = torch.arange(c0, min(c0 + chunk, npix), dtype=torch.int64,
                           device=sd.device)
        rad, rays = render_batch(sd, eye, rot, ids, sample_base, cfg, spp)
        out[0:3, c0:c0 + ids.shape[0]] = rad.T
        out[3, c0:c0 + ids.shape[0]] = rays
    return out


def mega_render(sd, eye: torch.Tensor, rot: torch.Tensor, cfg,
                sample_base: int, spp: int) -> torch.Tensor:
    """Render ``spp`` samples of every pixel -> [4, npix] f32 (radiance
    sums, useful rays). ``eye`` [3] and ``rot`` [4, 4] are the camera."""
    if sd.device.type == "cpu":
        return mega_render_plain(sd, eye, rot, cfg, sample_base, spp)
    stack = int(cfg.bvh_stack_size)
    _check_scene(sd, stack)
    if cfg.jitter not in ("cuda", "gl"):
        raise ValueError(f"unknown jitter mode {cfg.jitter!r}")
    npix = cfg.width * cfg.height
    r = _RenderArgs()
    r.rot[:] = [float(v) for v in rot.detach().to("cpu", torch.float32).reshape(-1)]
    r.eye[:] = [float(v) for v in eye.detach().to("cpu", torch.float32)]
    r.width, r.height, r.npix = cfg.width, cfg.height, npix
    r.spp, r.max_depth = int(spp), int(cfg.max_depth)
    r.jitter_gl = int(cfg.jitter == "gl")
    r.sample_base = int(sample_base) & 0xFFFFFFFF
    r.seed = int(cfg.seed) & 0xFFFFFFFF
    # the scalar operands of the plain version, computed in double and
    # rounded to f32 as torch and JAX round a Python scalar operand
    r.ndc_sx, r.ndc_sy = 2.0 / cfg.width, 2.0 / cfg.height
    r.rr_rate, r.sss_rate = cfg.rr_rate, cfg.sss_rate
    r.one_m_sss = 1.0 - cfg.sss_rate
    r.rr_over_pi = cfg.rr_rate / 3.1415926
    r.hdr_clamp = cfg.hdr_clamp
    s = _scene_args(sd, stack)
    out = torch.empty((4, npix), dtype=torch.float32, device=sd.device)
    rc = library().mega_render(ctypes.byref(s), ctypes.byref(r),
                               ctypes.c_void_p(out.data_ptr()), _stream(sd.device))
    _check_rc(rc, "mega_render")
    LAUNCHES["mega_render"] += 1
    return out


def bvh_nearest(sd, origins: torch.Tensor, dirs: torch.Tensor,
                exclude: torch.Tensor, stack_size: int = 128):
    """Nearest hit of [M, 3] rays skipping ``exclude`` [M] -> (hit [M]
    bool, index [M] int32, t [M] f32), as ops/traverse.nearest_hit_bvh."""
    if sd.device.type == "cpu":
        from .traverse import nearest_hit_bvh

        return nearest_hit_bvh(origins, dirs, exclude, sd, stack_size)
    _check_scene(sd, stack_size)
    m = origins.shape[0]
    for name, t, dt, shape in (("origins", origins, torch.float32, (m, 3)),
                               ("dirs", dirs, torch.float32, (m, 3)),
                               ("exclude", exclude, torch.int32, (m,))):
        if (t.device != sd.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {dt} {shape} on "
                             f"{sd.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    idx = torch.empty((m,), dtype=torch.int32, device=sd.device)
    t = torch.empty((m,), dtype=torch.float32, device=sd.device)
    s = _scene_args(sd, stack_size)
    vp = ctypes.c_void_p
    rc = library().bvh_nearest(ctypes.byref(s), vp(origins.data_ptr()),
                               vp(dirs.data_ptr()), vp(exclude.data_ptr()), m,
                               vp(idx.data_ptr()), vp(t.data_ptr()),
                               _stream(sd.device))
    _check_rc(rc, "bvh_nearest")
    LAUNCHES["bvh_nearest"] += 1
    return t < 2147483647.0, idx, t
