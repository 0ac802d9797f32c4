"""Persistent ray-pool renderer: a wavefront engine with respawn.

The JAX package's integrator/pool.py ``_pool_render_impl``: a pool of M
lanes, each carrying one path. Every iteration advances each live path
one bounce and lets freed lanes take the next (pixel, sample) of a work
queue of ``npix * spp`` samples, until every sample has finished:

  1. ``front_bounce``   the bounce up to its trace, as E + 2 stacked
                        segment rays per lane (ops/bounce_front.py);
  2. ``trace_segments`` their nearest hits, the HDR segment any-hit
                        (ops/trace.py);
  3. ``resolve_bounce`` the bounce's resolve, the forward composite
                        ``L += T * dir; T *= rate`` with the depth-cap
                        term, finished paths into the film
                        (ops/bounce_resolve.py);
  4. ``spawn_primary``  ``cfg.spawn_rounds`` times: fresh lanes take queue
                        samples and trace their camera rays; a miss adds
                        the sky and leaves its lane fresh for the next
                        round (ops/spawn_front.py).

CUDA tensors launch the four kernels of csrc/pool.cu, CPU tensors run
their plain versions (``run_pool(st, PLAIN)`` runs the plain versions on
any device). Every draw is keyed by (pixel, sample, bounce, site), so a pool
render equals the megakernel's and the scan engine's sample for sample;
only the order of the sums within a pixel differs. The host reads the
finished-sample counter once per iteration.

Not carried over, because they exist for the TPU: ``FILM_TILE`` (the
whole film runs as one queue; spp is split only where ``npix * spp``
would reach 2^31), the 5-buffer packed carry and the [16, M] row tables.
The film-shard path (``pixel_ids``) waits for the multi-device port.
"""

from __future__ import annotations

from typing import Optional

from ..core import camera as camera_mod
from ..core.film import Film
from ..ops import bounce_front, bounce_resolve, spawn_front, trace
from ..ops.lanes import C_DONE, C_RAYS, PoolState
from ..utils.config import RenderConfig

# lanes of the pool when the caller gives none (capped at npix * spp):
# the fastest of 2^18 .. 2^21 at the main path on the H100 (PERF.md,
# cli/pool_sweep.py)
POOL_LANES = 1 << 21
MAX_ITERS = 1_000_000
QUEUE_LIMIT = 2 ** 31 - 1  # samples of one queue (the kernels' int32 ids)

# the loop's steps (spawn, front, trace, resolve)
KERNELS = (spawn_front.spawn_primary, bounce_front.front_bounce,
           trace.trace_segments, bounce_resolve.resolve_bounce)
PLAIN = (spawn_front.spawn_primary_plain, bounce_front.front_bounce_plain,
         trace.trace_segments_plain, bounce_resolve.resolve_bounce_plain)


def run_pool(st: PoolState, steps=KERNELS, max_iters: int = MAX_ITERS) -> int:
    """Run the pool loop on ``st`` until its queue has finished (or
    ``max_iters``) -> loop iterations."""
    spawn, front, trace_fn, resolve = steps
    it = 0
    while it < max_iters:
        if it:  # no lane is active before the first spawn
            o, d, x = front(st)
            bt, bi = trace_fn(st.sd, o, d, x, st.sd.n_emit, st.cfg.bvh_stack_size)
            resolve(st, bt, bi)
        for _ in range(max(1, st.cfg.spawn_rounds)):
            spawn(st)
        it += 1
        if int(st.cnt[C_DONE]) >= st.total:
            break
    return it


def render_film_pool(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                     stats: Optional[dict] = None, pool_m: Optional[int] = None) -> Film:
    """Pool render of cfg.spp samples per pixel (samples ``film.count ..``)
    -> Film. ``pool_m`` lanes (default ``POOL_LANES``, capped at the queue
    length). ``stats``, when given, receives ``rays`` (useful rays,
    counted exactly) and ``iterations``."""
    npix = cfg.width * cfg.height
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    lanes = POOL_LANES if pool_m is None else int(pool_m)
    spp_chunk = max(1, min(cfg.spp, QUEUE_LIMIT // npix))
    accum = film.accum
    rays = iters = done = 0
    while done < cfg.spp:
        step = min(spp_chunk, cfg.spp - done)
        total = npix * step
        st = PoolState.create(sd, cfg, eye, rot, min(lanes, total), total,
                              film.count + done)
        iters += run_pool(st)
        accum = accum + st.film.reshape(cfg.height, cfg.width, 3)
        rays += int(st.cnt[C_RAYS])
        done += step
    if stats is not None:
        stats["rays"] = stats.get("rays", 0.0) + float(rays)
        stats["iterations"] = stats.get("iterations", 0) + iters
    return Film(accum, film.count + done)
