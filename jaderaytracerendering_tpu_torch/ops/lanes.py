"""The pool engine's lane state, shared by its kernels (csrc/pool.cu) and
their plain versions.

``M`` lanes each carry one path: ``fs`` f32 [15, M] (hit point ``src``
rows 0-2, ``out_dir`` 3-5, throughput ``T`` 6-8, radiance ``L`` 9-11,
primary emission ``le0`` 12-14) and ``is_`` i32 [6, M] (``active``,
``hit_idx``, ``bounce``, ``slot``, ``pix``, ``smp``). Beside them: the
film of this queue ``film`` f32 [n_px, 3], and ``cnt`` i64 [4] (next
queue sample, finished samples, useful rays, unused). Scenes with direct
refraction also carry the bounce's march results from the front step to
the resolve step: ``rf`` f32 [9, M] (exit direction rows 0-2, exit point
3-5, rate 6-8) and ``ri`` i32 [2, M] (escaped, last triangle), written
for the lanes that take direct refraction this bounce and zero
elsewhere (None without refraction). ``spawn_scan`` is the spawn kernel's
scratch (a ticket counter and one status word per tile of its scan).
The queue runs over a pixel window of ``n_px`` slots from ``pix0`` at
``row_step`` (the whole film by default): ``index`` = 0 .. ``total``-1
takes ``slot = index % n_px`` (the film's row), ``pix =
window_pixels(pix0, slot, row_step, width)`` (core/film.py: ``pix0 +
slot`` at step 1; the camera ray and every draw key) and sample ``smp =
index // n_px + sample_base``. The JAX package's pool takes a
``pixel_ids`` table instead, but every caller passes a contiguous range
there (parallel/sharding.py, padded with pixel 0, whose padded samples
are discarded), so a window covers every caller.
The kernels and the plain versions update the state in place.

The JAX package packs the same carry into five TPU buffers with [16, M]
triangle and material rows (integrator/pool.py); here the rows are
gathered where they are needed.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.film import check_window
from . import kernels

F_SRC, F_DIR, F_T, F_L, F_LE0 = 0, 3, 6, 9, 12
I_ACTIVE, I_HIT, I_BOUNCE, I_SLOT, I_PIX, I_SMP = range(6)
C_NEXT, C_DONE, C_RAYS = range(3)
R_DIR, R_SRC, R_RATE = 0, 3, 6      # rows of rf
R_ESCAPED, R_LAST = 0, 1            # rows of ri


@dataclasses.dataclass
class PoolState:
    sd: object
    cfg: object
    eye: torch.Tensor        # [3]
    rot: torch.Tensor        # [4, 4]
    pix0: int                # the window's first pixel
    n_px: int                # the window's slots: the film's rows
    total: int               # queued samples (< 2^31)
    sample_base: int
    fs: torch.Tensor
    is_: torch.Tensor
    film: torch.Tensor
    cnt: torch.Tensor
    rf: torch.Tensor | None = None
    ri: torch.Tensor | None = None
    # the spawn kernel's scan scratch (ops/spawn_front.py), made at its first
    # round on the card; no lane state, so a clone shares it (its rounds run
    # one after another on the stream, at the same M)
    spawn_scan: torch.Tensor | None = None
    row_step: int = 1        # the window's row stride (core/film.window_pixels)
    _args: tuple | None = None

    @staticmethod
    def create(sd, cfg, eye, rot, m: int, total: int, sample_base: int, pix0: int = 0,
               n_px: int | None = None, row_step: int = 1) -> "PoolState":
        dev = sd.device
        n_px = cfg.width * cfg.height - pix0 if n_px is None else int(n_px)
        check_window(cfg.width, cfg.height, pix0, n_px, row_step)
        if n_px < 1:
            raise ValueError("pixel window of no slots: a queue needs one")
        fs = torch.zeros((15, m), dtype=torch.float32, device=dev)
        fs[F_T:F_T + 3] = 1.0
        rf = ri = None
        if sd.has_refract:
            rf = torch.zeros((9, m), dtype=torch.float32, device=dev)
            ri = torch.zeros((2, m), dtype=torch.int32, device=dev)
        return PoolState(
            sd, cfg, eye, rot, int(pix0), n_px, int(total), int(sample_base), fs,
            torch.zeros((6, m), dtype=torch.int32, device=dev),
            torch.zeros((n_px, 3), dtype=torch.float32, device=dev),
            torch.zeros((4,), dtype=torch.int64, device=dev), rf, ri, row_step=int(row_step))

    @property
    def m(self) -> int:
        return self.fs.shape[1]

    def clone(self) -> "PoolState":
        return dataclasses.replace(self, fs=self.fs.clone(), is_=self.is_.clone(),
                                   film=self.film.clone(), cnt=self.cnt.clone(),
                                   rf=None if self.rf is None else self.rf.clone(),
                                   ri=None if self.ri is None else self.ri.clone(),
                                   _args=None)

    def args(self):
        """(SceneArgs, RenderArgs, PoolArgs) of this state for the kernels,
        built once and checked then (the tensors are updated in place, so
        their addresses hold)."""
        if self._args is None:
            dev = self.sd.device
            m = self.m
            kernels.check_tensor("fs", self.fs, torch.float32, (15, m), dev)
            kernels.check_tensor("is_", self.is_, torch.int32, (6, m), dev)
            kernels.check_tensor("film", self.film, torch.float32, (self.n_px, 3), dev)
            kernels.check_tensor("cnt", self.cnt, torch.int64, (4,), dev)
            if self.sd.has_refract:
                kernels.check_tensor("rf", self.rf, torch.float32, (9, m), dev)
                kernels.check_tensor("ri", self.ri, torch.int32, (2, m), dev)
            if not 0 < self.total < 2 ** 31:
                raise ValueError(f"queue of {self.total} samples: want 1 .. 2^31-1")
            s = kernels.scene_args(self.sd, int(self.cfg.bvh_stack_size))
            r = kernels.render_args(self.eye, self.rot, self.cfg, self.sample_base, 0,
                                    self.row_step)
            q = kernels.PoolArgs(self.fs.data_ptr(), self.is_.data_ptr(),
                                 self.film.data_ptr(), self.cnt.data_ptr(),
                                 self.total, m, self.n_px, self.pix0,
                                 self.rf.data_ptr() if self.sd.has_refract else None,
                                 self.ri.data_ptr() if self.sd.has_refract else None)
            self._args = (s, r, q)
        return tuple(ctypes.byref(a) for a in self._args)
