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
queue's counters once per iteration.

A queue runs over a pixel window (``render_window_pool``, the engine's
window function in integrator/render.py ``ENGINES``): the whole film, or
a tile rank's dealt rows in a multi-device render (parallel/sharding.py);
the JAX package gives its tile shard as ``pixel_ids`` (ops/lanes.py).

Not carried over, because they exist for the TPU: ``FILM_TILE`` (the
whole film runs as one queue; spp is split only where ``npix * spp``
would reach 2^31), the 5-buffer packed carry and the [16, M] row tables.
"""

from __future__ import annotations

import functools
from typing import Optional

from ..core import camera as camera_mod
from ..core.film import Film
from ..ops import bounce_front, bounce_resolve, spawn_front, trace
from ..ops.lanes import C_DONE, C_NEXT, C_RAYS, PoolState
from ..utils.config import RenderConfig
from ..utils.logging import count, span

# lanes of the pool when the caller gives none (capped at npix * spp):
# the fastest of 2^18 .. 2^21 at the render CLI's defaults on the H100
# (PERF.md §6, the pool sweep)
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
    ``max_iters``) -> loop iterations.

    Under a profiler (utils/logging.py) each iteration is the span
    ``integrator.pool.iteration`` and its read of ``st.cnt``, which waits
    for the device, the child span ``integrator.pool.sync``: the iteration
    less its sync is the host's launch path (``pool_host_us``). The same
    read gives the counters ``pool.live_lanes`` (the samples taken and not
    finished after the spawn rounds: lanes that carry a live path) and
    ``pool.lane_slots`` (M), whose ratio is ``pool_lane_use_pct``."""
    spawn, front, trace_fn, resolve = steps
    it = 0
    while it < max_iters:
        with span("integrator.pool.iteration"):
            if it:  # no lane is active before the first spawn
                o, d, x = front(st)
                bt, bi = trace_fn(st.sd, o, d, x, st.sd.n_emit, st.cfg.bvh_stack_size)
                resolve(st, bt, bi)
            for _ in range(max(1, st.cfg.spawn_rounds)):
                spawn(st)
            it += 1
            with span("integrator.pool.sync"):
                cnt = st.cnt.tolist()
            count("pool.live_lanes", min(cnt[C_NEXT], st.total) - cnt[C_DONE])
            count("pool.lane_slots", st.m)
        if cnt[C_DONE] >= st.total:
            break
    return it


def render_window_pool(sd, cam, cfg: RenderConfig, acc, pix0: int, sample_base: int,
                       spp: int, stats: Optional[dict] = None,
                       pool_m: Optional[int] = None, row_step: int = 1) -> float:
    """Pool render of ``spp`` samples from ``sample_base`` of the pixel
    window's slots (``pix0``, ``row_step``: core/film.window_pixels; one
    private queue; spp split only where the queue would reach 2^31
    samples), their radiance sums added into ``acc`` [n_px, 3] in place
    -> the useful rays, counted exactly. The loop iterations are added to
    ``stats["iterations"]`` when ``stats`` is given. ``pool_m`` lanes
    (default ``POOL_LANES``, capped at the queue length)."""
    n_px = acc.shape[0]
    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    lanes = POOL_LANES if pool_m is None else int(pool_m)
    spp_chunk = max(1, min(spp, QUEUE_LIMIT // max(n_px, 1)))
    rays = iters = done = 0
    while done < spp and n_px:
        step = min(spp_chunk, spp - done)
        total = n_px * step
        st = PoolState.create(sd, cfg, eye, rot, min(lanes, total), total,
                              sample_base + done, pix0, n_px, row_step)
        iters += run_pool(st)
        acc += st.film
        rays += int(st.cnt[C_RAYS])
        done += step
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + iters
    return float(rays)


def render_film_pool(sd, cam, cfg: RenderConfig, film: Optional[Film] = None,
                     stats: Optional[dict] = None, pool_m: Optional[int] = None) -> Film:
    """Pool render of cfg.spp samples per pixel (samples ``film.count ..``)
    -> Film, through ``render_window_pool`` over the whole film. ``stats``,
    when given, receives ``rays`` (useful rays, counted exactly) and
    ``iterations``."""
    from .render import render_film_window

    window = functools.partial(render_window_pool, pool_m=pool_m)
    return render_film_window(window, sd, cam, cfg, film, stats)
