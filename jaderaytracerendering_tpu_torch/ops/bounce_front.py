"""The pool's bounce front: the CUDA kernel ``front_bounce``
(csrc/pool.cu) and its plain version.

Replaces the JAX package's ops/pallas/bounce_front.py ``front_bounce``
(-> ``_kernel``), with the refraction march of ``front_precompute`` that
feeds it (integrator/pool.py:185-205). For every active lane: the
bounce's draws from its counters (pixel, sample, bounce + 1, site,
seed), the hit's rows, the march of a lane that takes direct refraction,
then ``wavefront.bounce_front`` (branch masks, SSS exit pick, the NEE
light, HDR and continuation directions), emitted as stacked segment
rays: o, d [E+2, 3, M] f32 (light i, the HDR ray, the continuation;
masked lanes get zero rays) and the excluded triangle x [E+2, M] i32.
The march's results go to the state's ``rf``/``ri`` rows for the
resolve step, which recomputes the rest of the front from the same
state, so nothing else is emitted.
"""

from __future__ import annotations

import torch

from ..core.vecmath import V3, vstack, vwhere
from . import kernels
from .kernels import LAUNCHES
from .lanes import (F_DIR, F_SRC, I_ACTIVE, I_BOUNCE, I_HIT, I_PIX, I_SMP, R_DIR,
                    R_ESCAPED, R_LAST, R_RATE, R_SRC, PoolState)


def lane_front(st: PoolState, refr=None):
    """The lanes' path state and ``wavefront.front_step`` on it (the march
    through the plain walk unless ``refr`` gives its results) -> (state,
    Front, seg_o, seg_d, seg_x)."""
    from ..integrator import wavefront

    fs, is_ = st.fs, st.is_
    active = is_[I_ACTIVE] != 0
    state = (active, V3(*fs[F_SRC:F_SRC + 3]), V3(*fs[F_DIR:F_DIR + 3]), is_[I_HIT],
             torch.zeros_like(active))
    return (state,) + wavefront.front_step(state, is_[I_BOUNCE], is_[I_PIX], is_[I_SMP],
                                           st.sd, st.cfg, wavefront.nearest_planes_plain,
                                           refr)


def lane_refr(st: PoolState):
    """The march results the front step left in ``rf``/``ri``."""
    from ..integrator import wavefront

    rf, ri = st.rf, st.ri
    return wavefront.Refr(V3(*rf[R_DIR:R_DIR + 3]), V3(*rf[R_RATE:R_RATE + 3]),
                          ri[R_ESCAPED] != 0, ri[R_LAST], V3(*rf[R_SRC:R_SRC + 3]))


def front_bounce_plain(st: PoolState):
    """The plain version -> (o, d [E+2, 3, M] f32, x [E+2, M] i32); writes
    ``rf``/``ri`` on scenes with direct refraction."""
    _, f, seg_o, seg_d, seg_x = lane_front(st)
    if st.sd.has_refract:
        rows = [f.cdir, f.cont_src, f.ref_rate]
        st.rf.copy_(torch.cat([vstack(vwhere(f.is_dirref, v, 0.0)).T for v in rows]))
        st.ri.copy_(torch.stack([f.ref_escaped.to(torch.int32), f.cont_excl.to(torch.int32)])
                    * f.is_dirref)
    o = torch.stack([vstack(v).T for v in seg_o])
    d = torch.stack([vstack(v).T for v in seg_d])
    x = torch.stack([v.to(torch.int32) for v in seg_x])
    return o, d, x


def front_bounce(st: PoolState):
    """Segment rays of every lane's next bounce (see the module
    docstring). CUDA state launches the kernel; CPU state runs the plain
    version."""
    if st.fs.device.type == "cpu":
        return front_bounce_plain(st)
    s, r, q = st.args()
    n_seg, m, dev = st.sd.n_emit + 2, st.m, st.sd.device
    o = torch.empty((n_seg, 3, m), dtype=torch.float32, device=dev)
    d = torch.empty((n_seg, 3, m), dtype=torch.float32, device=dev)
    x = torch.empty((n_seg, m), dtype=torch.int32, device=dev)
    p = kernels.ptr
    rc = kernels.library().front_bounce(s, r, q, p(o), p(d), p(x), kernels.stream(dev))
    kernels.check_rc(rc, "front_bounce")
    LAUNCHES["front_bounce"] += 1
    return o, d, x
