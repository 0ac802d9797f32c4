"""The CUDA library of the port: its build, its ctypes argument structures,
the checks every wrapper makes, and the launch counters.

``csrc/mega.cu`` (the megakernel), ``csrc/pool.cu`` (the pool engine's
spawn, trace, front and resolve kernels) and ``csrc/preview.cu`` (the
preview kernel) share the device functions of ``csrc/path.cuh``;
``csrc/postfx.cu`` (the display kernel) stands alone. All four build into
one library. Each wrapper (ops/mega.py, ops/trace.py, ops/spawn_front.py,
ops/bounce_front.py, ops/bounce_resolve.py, ops/postfx.py) adds one to
its entry of ``LAUNCHES`` for each launch of its kernel and nowhere else
(``mega_render`` also to ``mega_fold`` for the fold that follows each
megakernel launch), so a caller can show that a run went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..scene.scene import PACKED, TABLES
from ..utils import logging
from . import build
from .intersect import INF  # noqa: F401  (a miss's t, as the kernels write it)

SOURCES = ["mega.cu", "pool.cu", "preview.cu", "postfx.cu"]
LAUNCHES = {"mega_render": 0, "mega_fold": 0, "trace_segments": 0, "spawn_primary": 0,
            "front_bounce": 0, "resolve_bounce": 0, "render_preview_mega": 0,
            "postfx": 0}
MAX_STACK = 128  # the largest cfg.bvh_stack_size (entries) the kernels accept


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and clear the spans and counters of
    utils/logging.py: one reset of every counter the program keeps."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    logging.reset()


class SceneArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in (*TABLES, *PACKED)]
                + [(k, ctypes.c_int) for k in ("env_h", "env_w", "n_emit",
                                               "n_nodes", "has_sss",
                                               "stack_size", "has_refract",
                                               "bvh_root")])


class RenderArgs(ctypes.Structure):
    _fields_ = [("rot", ctypes.c_float * 16), ("eye", ctypes.c_float * 3)] \
        + [(k, ctypes.c_int) for k in ("width", "height", "npix", "spp",
                                       "max_depth", "jitter_gl")] \
        + [("sample_base", ctypes.c_uint32), ("seed", ctypes.c_uint32)] \
        + [(k, ctypes.c_float) for k in ("ndc_sx", "ndc_sy", "rr_rate",
                                         "sss_rate", "one_m_sss", "rr_over_pi",
                                         "hdr_clamp")] \
        + [("max_refract", ctypes.c_int), ("internal_reflect_rate", ctypes.c_float),
           ("row_step", ctypes.c_int)]


class PoolArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in ("fs", "is", "film", "cnt")] \
        + [("total", ctypes.c_longlong)] \
        + [(k, ctypes.c_int) for k in ("m", "n_px", "pix0")] \
        + [(k, ctypes.c_void_p) for k in ("rf", "ri")]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use, keyed by the sources' hash) and load csrc/*.cu."""
    return bind(build.load_library("kernels", SOURCES))


_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {  # entry point of csrc/*.cu -> its ctypes argument types; each returns int
    "mega_render": [_vp, _vp, _ci, _ci, _ci, _vp, _ci, _vp, _vp, _vp, _vp],
    "preview_render": [_vp, _vp, _ci, _ci, _ci, _vp, _vp],
    "postfx": [_vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _cf, _ci, _cf, _cf, _ci, _vp],
    "spawn_scratch_words": [_ci],
    "spawn_primary": [_vp, _vp, _vp, _vp, _vp, _vp],
    "front_bounce": [_vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "trace_segments": [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp, _vp, _vp],
    "resolve_bounce": [_vp, _vp, _vp, _vp, _vp, _vp]}


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Give the entry points ``names`` of ``lib`` (default: every one of
    csrc/*.cu) their ctypes argument and return types; returns ``lib``.
    An entry point that ``lib`` lacks raises AttributeError naming it."""
    for name in SIGNATURES if names is None else names:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise AttributeError(f"{lib._name} has no entry point {name!r}") from None
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def check_scene(sd, stack_size: int) -> None:
    """The scene a kernel can walk: its packed walk tables present, on
    CUDA, a ``stack_size`` (cfg.bvh_stack_size) of at most ``MAX_STACK``
    entries that holds the tree's depth + 1."""
    missing = [k for k in PACKED if getattr(sd, k) is None]
    if missing:
        raise ValueError(f"scene has no packed walk tables {missing}: build it with "
                         f"scene.assemble or scene.scene_from_numpy")
    if stack_size > MAX_STACK or sd.bvh_depth + 1 > stack_size:
        raise ValueError(f"BVH depth {sd.bvh_depth} + 1 must fit a stack of "
                         f"{stack_size} <= {MAX_STACK} entries")
    if sd.device.type != "cuda":
        raise ValueError(f"scene tables on {sd.device}, kernel needs CUDA")
    for k, dt in (*TABLES.items(), *PACKED.items()):
        t = getattr(sd, k)
        if t.device != sd.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"scene table {k}: want contiguous {dt} on "
                             f"{sd.device}, got {t.dtype} on {t.device}")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def scene_args(sd, stack_size: int) -> SceneArgs:
    """Checked ctypes view of the scene's tables. The kernels' walk stack
    holds depth + 1 entries, all a walk can occupy (``accel.bvh.tree_depth``),
    so a ``stack_size`` that passes the check never drops a child in the
    kernels or in the plain walk."""
    check_scene(sd, stack_size)
    return SceneArgs(
        *[getattr(sd, k).data_ptr() for k in (*TABLES, *PACKED)],
        int(sd.env_map.shape[0]), int(sd.env_map.shape[1]), sd.n_emit,
        sd.n_nodes, int(sd.has_sss), sd.bvh_depth + 1, int(sd.has_refract),
        sd.bvh_root)


def render_args(eye, rot, cfg, sample_base: int, spp: int, row_step: int = 1) -> RenderArgs:
    """Camera and integrator scalars; ``eye`` [3], ``rot`` [4, 4];
    ``row_step``: the pixel window's row stride (core/film.window_pixels)."""
    if cfg.jitter not in ("cuda", "gl"):
        raise ValueError(f"unknown jitter mode {cfg.jitter!r}")
    r = RenderArgs()
    r.rot[:] = [float(v) for v in rot.detach().to("cpu", torch.float32).reshape(-1)]
    r.eye[:] = [float(v) for v in eye.detach().to("cpu", torch.float32)]
    r.width, r.height, r.npix = cfg.width, cfg.height, cfg.width * cfg.height
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
    r.max_refract = int(cfg.max_refract_bounces)
    r.internal_reflect_rate = cfg.internal_reflect_rate
    r.row_step = int(row_step)
    return r


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
