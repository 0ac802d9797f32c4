"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (``jaderaytracerendering_tpu_torch``) on the
card and checks its CUDA kernels against their plain PyTorch versions:

  0. environment: a CUDA device; the card's name and power limit;
  1. build: compiles csrc/{mega,pool,preview,postfx}.cu with nvcc (timed)
     and prints ptxas' registers, stack and spills of every kernel;
  2. traversal: 2^16 random rays through ``trace_segments`` (one segment)
     and the plain torch walk on the jade scene: the same hits, ids and t
     bit for bit;
  3. megakernel vs plain: jade, 96x96, 4 spp, depth 6, the whole image:
     useful rays exact, every pixel within MEGA_RTOL / MEGA_ATOL_FRAC;
  4. main path: the render CLI at its defaults (jade, 20k statue
     triangles, 1024x1024, 16 spp, depth 16) through the megakernel, with
     the launch counter, the film and the BMP checked, its scene built by
     the native SAH builder (asserted; its seconds beside those of the
     NumPy builder on the same scene), and the film held
     against the plain version on a random subset of 4096 pixels (as in
     phase 3); the main path's bound (the subset's box, triangle and shading
     operations scaled to the film; the tables and the output) and the
     megakernel's device time;
  5. trace kernel: 2^16 random rays x 4 stacked segments (random
     exclusions, segment 2 any-hit) against the plain per-segment walk,
     ids and t bit for bit;
  6. spawn kernel: one ``spawn_primary`` at 2^16 lanes with a random fresh
     mask, the queue running out inside the call, against the plain one;
  7. pool vs plain: jade, 96x96, 4 spp, depth 6, 8192 lanes, the whole
     image through the kernel route and the plain route, and one
     iteration's front and resolve against their plain versions;
  8. pool main path: the render CLI with ``--engine pool`` at its
     defaults, held against phase 4's megakernel film (same samples,
     other summation order) and its useful-ray total (equal); then each
     pool kernel at the main path's shapes (the pool state after a few
     iterations) against its plain version, timed by device time (each
     mutating call on its own copy of the state) beside CUDA events
     around the call; then one more pool render under torch.profiler for
     each pool kernel's launches and device total over the render (one
     spawn launch a round);
  9. scan on the card: ``render_film(engine="scan")`` at phase 7's size
     through the trace kernel, against phase 7's plain film;
 10. refraction: the jade scene with the statue made DIR_REFRACT (index
     1.5, rate 0.9, 32 march steps) at phase 3's size: the megakernel's
     refraction instance against its plain version, the pool's kernel
     route against its plain route and against the megakernel's film
     (equal useful rays), one pool iteration's kernels against their
     plain versions; the megakernel's instance as in phase 3; ptxas
     registers of both instances of each kernel;
 11. preview kernel vs plain: jade 96x96, 4 spp, the whole image, both
     adding into a film of ones, asserted bit for bit; then a 4-band
     rotation through the kernel equal to one full frame through it, bit
     for bit;
 12. postfx vs plain, byte for byte (0 u8 steps asserted): phase 4's
     1024^2 film and ragged films (7x1021, 5x13) seen through views at
     float offsets 0-3 (a data pointer not 16-byte aligned), in the modes
     aces, reinhard and none, both flips, odd spans, one and two counts,
     and displays at byte offsets 0 and 1, and every float in [0, 2] as
     a channel's sum (count 1, no tone map: the power and quantisation on
     every value below the clamp); the kernel timed at 1024^2
     (aces, flipped; and a banded display's split) beside its bound;
 13. the preview main path: the preview CLI at its defaults (jade 20k,
     1024x1024, 1 spp a frame, 2 bounces, 4 bands) for 8 headless frames,
     with the launch counters, the film against the plain preview on
     random pixels, the last frame shown and the banded display of each
     frame of a rotation (one postfx launch over two spans, two counts)
     against the plain postfx band by band (0 u8 steps), and the written image
     checked; kernel ms per banded frame, its bound (the walks of a random
     subset of the band's pixels counted and scaled) and postfx ms; then 64
     frames for the steady frames per second, and 64 more under
     torch.profiler for the device's idle share in the steady frames and
     the kernels they ran (one preview and one postfx launch a frame,
     nothing else);
 14. multi-device: (a) the three tile windows of a 3x1 mesh at the main
     path (the middle one starts off a block edge, the last is shorter)
     through the megakernel, each equal bit for bit to its columns of
     phase 4's film, and through the pool, within ``compare_images`` of
     them with equal useful rays; (b) the render CLI at its defaults in
     fresh processes: on one device (the yardstick), then with ``--mesh
     2x1`` (film bit for bit phase 4's) and ``--mesh 1x2 --engine pool``
     (within MESH_RTOL / MESH_ATOL_FRAC of it, equal useful rays), the
     CLI spawning 2 ranks that share card 0 over gloo (and, with two
     cards or more, ``--mesh 2x1`` over NCCL): every rank's film equal,
     each rank's launches, render seconds and time in ``all_reduce``
     (CUDA events); a ``multi_device`` JSON line.
 15. the oracle gate: the RMSE gate's jade scene (300 statue triangles,
     r 2.0) at 8x8, 64 spp, depth 4 through ``render_film`` with engines
     mega, pool and scan on the card, each film within relative RMSE 1e-3
     of the port's CPU oracle (cpuref/integrator.py, ``rmse_gate.check_rmse``)
     with equal useful rays; then, the camera on the statue (which the
     r 2.0 view's primary rays miss at 8x8), the jade statue at 16 spp
     through the three engines and the DIR_REFRACT statue (200 triangles,
     depth 3, 8 march steps) at 16 spp through mega and pool; each
     engine's launches read;
 16. the bench (``python -m jaderaytracerendering_tpu_torch.bench``) at
     its defaults with ``--engine mega`` and ``--engine pool``, each a
     subprocess with a timeout: 8 rep lines, a positive rate, the engine's
     kernels launched, equal useful rays; both JSON lines printed.

A kernel's device time comes from CUDA events around calls queued behind
a spin kernel (``device_ms_each``), not from torch.profiler: on the
H100 machine a trace at times lost device events, all of a window's (in
phases 8, 10 and 12) or some of them, which a time per call then
understates. The profiler traces whole runs (phase 8's pool render,
phase 13's steady frames), traced again until the trace holds what it
is read for.

Every phase prints one line; any failure raises (exit code != 0), a
failed or hung rank or bench too (each CLI run of phase 14 and each bench
of phase 16 is a subprocess with a timeout). The line before the last is
the kernels' JSON record, the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MAIN_TRIS = 20_000
RTOL, ATOL_FRAC = 1e-3, 1e-4     # per pixel: |a-b| <= ATOL_FRAC*max + RTOL*|b|
MAX_OUTLIER_FRAC = 1e-3          # share of pixels allowed outside that bound
MEGA_RTOL, MEGA_ATOL_FRAC = 1e-5, 1e-6  # megakernel vs plain, every pixel (the JAX
                                 # package's mega-vs-scan bound): the kernel
                                 # composites a path forward, the plain version
                                 # folds its (dir, rate) stack backward as the
                                 # reference does, the same sum rounded in
                                 # another order
MEAN_RTOL = 1e-4                 # image mean, relative
TRAV_T_SAME_RTOL = 1e-6          # the spawn's primary hit t (phase 6)
STATE_RTOL = 1e-5                # one pool step, kernel vs plain: each group of
                                 # float rows (src, dir, T, L, le0; segment
                                 # origins, directions) within this share of
                                 # the group's own max

# roofline of one H100 SXM (published peak rates)
PEAK_BYTES = 3.35e12             # HBM bytes/s
PEAK_F32 = 67e12                 # FP32 operations/s outside the tensor cores
# float operations per test, counted from csrc/path.cuh: ray_aabb (3 slabs
# of 2 sub, 2 mul, min, max; 2 fmin, 2 fmax, 3 compares) and ray_triangle
# (Moller-Trumbore: 2 edges, 2 crosses, 4 dots, a reciprocal, 4 compares)
BOX_OPS, TRI_OPS = 25, 57
# float operations per active lane outside the walks, counted from the
# device functions (bounce_front_dev + the segment rays; the resolve
# recomputes the front, then lights, env lookups, RR and the composite);
# the camera ray and env lookup of a spawned sample
FRONT_OPS, RESOLVE_OPS, SPAWN_OPS = 150, 300, 80
# the preview kernel's shading per sample outside its walks (camera ray,
# two bounces of sampling, fold and weights, the env lookups), and the
# postfx kernel's per pixel, counted from its SASS on the H100: per
# channel the scale, ACES with its IEEE division (~17), powf's log2 and
# exp2 in extended precision (~69, an FFMA counted as two) and the
# quantisation (~4)
PREVIEW_OPS, POSTFX_OPS = 150, 270
TIMED_CALLS = 5                  # timed calls of a pool kernel that mutates its
                                 # state, each on its own copy
SPIN_CYCLES = 100_000_000        # device_ms_each: ~50 ms of spin at the H100's clock,
                                 # far longer than the host takes to queue the calls
PREVIEW_MAIN_FRAMES = 8          # phase 13: two rotations of 4 bands
PREVIEW_STEADY_FRAMES = 64       # phase 13: frames of the steady-state runs,
PREVIEW_WARM_FRAMES = 8          # of which the first 8 (first launches,
                                 # pinned buffers) are left out


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(fns) -> float:
    """Median ms of single calls (each on its own prepared input)."""
    return float(np.median([cuda_ms(f) for f in fns]))


def device_ms_each(fns) -> float:
    """Device time of one call, each of ``fns[1:]`` on its own prepared
    input (``fns[0]`` a warm-up): CUDA events around the calls, queued
    behind a spin kernel so that the device runs them back to back without
    waiting on the host (their kernels and the gaps between launches). A
    call that waits on the device (a read back) is refused."""
    fns[0]()
    torch.cuda.synchronize()
    start, spun, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda._sleep(SPIN_CYCLES)
    spun.record()
    start.record()
    for fn in fns[1:]:
        fn()
    end.record()
    if spun.query():
        raise AssertionError("device_ms_each: the device caught up with the host; "
                             "raise SPIN_CYCLES")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(fns) - 1)


def device_ms(fn, reps: int = 20) -> float:
    """``device_ms_each`` over ``reps`` calls of ``fn``."""
    return device_ms_each([fn] * (reps + 1))


def traced(run, kernel: str, tries: int = 3):
    """torch.profiler over ``run()`` -> (its result, the profile), traced
    again, up to ``tries`` times, while the trace holds no device event of
    ``kernel``: on this machine a trace at times came back without any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
               for e in prof.events()):
            return out, prof
    raise AssertionError(f"the profiler saw no device event of {kernel!r} in {tries} traces")


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what binds): the larger of bytes / HBM rate and FP32
    operations / FP32 peak."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def scene_bytes(sd, keys) -> int:
    return sum(getattr(sd, k).numel() * getattr(sd, k).element_size() for k in keys)


# the kernels' walk reads the packed tables, not the SoA BVH tables
WALK_TABLES = ("bvh_nodes", "tri_packed")
SOA_WALK = ("bvh_left", "bvh_right", "bvh_n", "bvh_index", "bvh_aa", "bvh_bb")
# the tables the preview kernel reads: the walks', the hit's normal and
# material (emission, albedo) and the sky
PREVIEW_TABLES = WALK_TABLES + ("tri_norm", "tri_obj", "mat_emissive", "mat_brdf", "env_map")


def mega_tables() -> list:
    """The tables the megakernel reads: the walk's and every shading table."""
    from jaderaytracerendering_tpu_torch.scene.scene import TABLES

    return [k for k in TABLES if k not in SOA_WALK] + list(WALK_TABLES)


def device_idle_share(prof, kernel: str, first: int) -> tuple[float, float]:
    """From a torch.profiler trace: the window from the start of launch
    ``first`` (counting from 0) of ``kernel`` (a substring of its name) to
    the start of its last launch, and the share of it in which the device
    ran nothing (no kernel, copy or fill) -> (idle share, window ms)."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    starts = sorted(e.time_range.start for e in dev if kernel in e.name)
    if len(starts) <= first + 1:
        raise AssertionError(f"the profiler saw {len(starts)} launches of {kernel!r}")
    t0, t1 = starts[first], starts[-1]
    busy, covered = 0.0, t0
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in dev):
        a, b = max(lo, covered), min(hi, t1)
        if b > a:
            busy += b - a
        covered = max(covered, hi)
    return 1.0 - busy / (t1 - t0), (t1 - t0) / 1e3


def device_kernels(prof, kernel: str, first: int) -> dict:
    """From a torch.profiler trace: {name: launches} of every device kernel
    (copies left out) that starts in the window of ``device_idle_share``,
    from launch ``first`` of ``kernel`` to its last launch."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    starts = sorted(e.time_range.start for e in dev if kernel in e.name)
    out = {}
    for e in dev:
        if starts[first] <= e.time_range.start <= starts[-1] and \
                not e.name.startswith(("Memcpy", "Memset")):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def banded_display_plain(accum, frame_idx: int, bands: int, spp: int, mode: str):
    """The banded preview's display by the plain postfx, band by band,
    each band with its own count: bands up to ``frame_idx % bands`` have
    had ``frame_idx // bands + 1`` rotations of ``spp`` samples, the rest
    one fewer."""
    from jaderaytracerendering_tpu_torch.ops import postfx

    h, w, _ = accum.shape
    band_px = h * w // bands
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=accum.device)
    for b in range(bands):
        n = (frame_idx // bands + int(b <= frame_idx % bands)) * spp
        postfx.postfx_plain(accum, n, mode, flip=True, span=(b * band_px, (b + 1) * band_px),
                            out=out)
    return out


def postfx_cases(h: int, w: int) -> list:
    """(flip, span, split) cases of the postfx check on an h x w film:
    the whole film both ways, odd spans, and a split (two counts) inside a
    row, on a row's edge and at a span's start."""
    n = h * w
    return [(False, None, None), (True, None, None), (True, (3, n - 5), None),
            (True, None, w + 3), (False, (w - 1, n - 2), 2 * w + 1), (True, (5, 9), 5)]


def u8_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest difference between two u8 tensors, in steps."""
    return int((torch.maximum(a, b) - torch.minimum(a, b)).max())


def ptxas_registers(log_text: str) -> dict:
    """{kernel: registers} from a build's ptxas log; the instances of a
    template on HR (direct refraction) are named <false> and <true>."""
    regs, entry = {}, None
    for line in log_text.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"([a-z_]+_kernel)(ILb([01])E)?", line)
            entry = m.group(1) + ("" if m.group(2) is None
                                  else ("<false>", "<true>")[int(m.group(3))])
        elif "Used" in line and entry:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
            entry = None
    return regs


def compare_images(kernel: torch.Tensor, plain: torch.Tensor, what: str):
    """kernel/plain [3, P] radiance sums -> (max_abs_err, n_outside)."""
    a, b = kernel.double().cpu(), plain.double().cpu()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (a - b).abs()
    bound_ = ATOL_FRAC * float(b.abs().max()) + RTOL * b.abs()
    outside = int((err > bound_).any(dim=0).sum())
    n = a.shape[1]
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-30)
    if outside > MAX_OUTLIER_FRAC * n or mean_rel > MEAN_RTOL:
        raise AssertionError(
            f"{what}: {outside}/{n} pixels outside rtol={RTOL} "
            f"atol={ATOL_FRAC}*max (allowed {MAX_OUTLIER_FRAC * n:.1f}); "
            f"image mean rel diff {mean_rel:.3e} (allowed {MEAN_RTOL})")
    return float(err.max()), outside, mean_rel


def compare_mega(kernel: torch.Tensor, plain: torch.Tensor, what: str):
    """The megakernel's radiance sums [3, P] against the plain version's:
    every pixel within MEGA_RTOL * |plain| + MEGA_ATOL_FRAC * max|plain| ->
    (max abs err, pixels not equal bit for bit)."""
    a, b = kernel.double(), plain.double()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (a - b).abs()
    outside = int((err > MEGA_ATOL_FRAC * float(b.abs().max()) + MEGA_RTOL * b.abs())
                  .any(dim=0).sum())
    if outside:
        raise AssertionError(f"{what}: {outside}/{a.shape[1]} pixels outside rtol={MEGA_RTOL} "
                             f"atol={MEGA_ATOL_FRAC}*max (max abs err {float(err.max()):.3e})")
    return float(err.max()), int((kernel != plain).any(dim=0).sum())


def compare_hits(bt_k, bi_k, bt_p, bi_p, anyhit_seg: int, what: str):
    """Segment trace rows, kernel vs plain: hit booleans equal everywhere;
    on the nearest-hit rays the ids and t equal bit for bit (the kernels
    walk the plain walk's nodes in its order with its arithmetic) ->
    (ids differing, t differing), both 0."""
    from jaderaytracerendering_tpu_torch.ops.kernels import INF

    hk, hp = bt_k < INF, bt_p < INF
    if bool((hk != hp).any()):
        raise AssertionError(f"{what}: {int((hk != hp).sum())} rays differ in hit/miss")
    near = torch.ones(hk.shape[0], dtype=torch.bool, device=hk.device)
    if 0 <= anyhit_seg < hk.shape[0]:
        near[anyhit_seg] = False
    n_diff = int((bi_k[near] != bi_p[near]).sum())
    t_diff = int((bt_k[near].view(torch.int32) != bt_p[near].view(torch.int32)).sum())
    if n_diff or t_diff:
        raise AssertionError(f"{what}: {n_diff} ids and {t_diff} t differ from the plain walk")
    return n_diff, t_diff


def compare_rows(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """One group of float rows, kernel vs plain: finite, and within
    STATE_RTOL of the group's own max -> max abs err."""
    if not a.numel():
        return 0.0
    e = float((a - b).abs().max())
    scale = float(b.abs().max())
    if not bool(torch.isfinite(a).all()) or e > STATE_RTOL * scale:
        raise AssertionError(f"{what}: max abs err {e:.3e} (group max {scale:.3e}, "
                             f"allowed {STATE_RTOL} of it)")
    return e


def compare_states(k, p, what: str) -> float:
    """Two pool states after the same step: integers and counters equal,
    each group of lane floats (src, dir, T, L, le0) by ``compare_rows``,
    the film per pixel by ``compare_images`` -> max abs err of the floats."""
    from jaderaytracerendering_tpu_torch.ops.lanes import F_DIR, F_L, F_LE0, F_SRC, F_T

    bad = int((k.is_ != p.is_).sum())
    if bad or not torch.equal(k.cnt, p.cnt):
        raise AssertionError(f"{what}: {bad} lane ints differ; counters "
                             f"{k.cnt.tolist()} vs {p.cnt.tolist()}")
    err = max(compare_rows(k.fs[r:r + 3], p.fs[r:r + 3], f"{what} {name}")
              for name, r in (("src", F_SRC), ("dir", F_DIR), ("T", F_T), ("L", F_L),
                              ("le0", F_LE0)))
    film_err, _, _ = compare_images(k.film.T, p.film.T, f"{what} film")
    return max(err, film_err)


def hold_pool_kernels(sd, cam, cfg, m: int, iters: int, what: str):
    """The pool state after ``iters`` iterations at ``m`` lanes, then each
    pool kernel once on it against its plain version on the same input.
    Returns {kernel: {max_abs_err, ms, call_ms, plain_ms, bound_ms,
    bound_by}}: ``ms`` is the device time of one call (``device_ms_each``),
    ``call_ms`` CUDA events around one call from Python (the wrapper's host
    work included)."""
    from jaderaytracerendering_tpu_torch.core import camera as camera_mod
    from jaderaytracerendering_tpu_torch.integrator import pool
    from jaderaytracerendering_tpu_torch.ops import (bounce_front, bounce_resolve, kernels,
                                                     spawn_front, trace, traverse)
    from jaderaytracerendering_tpu_torch.ops.lanes import I_ACTIVE, PoolState

    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    npix = cfg.width * cfg.height
    st = PoolState.create(sd, cfg, eye, rot, m, npix * cfg.spp, 0)
    pool.run_pool(st, pool.KERNELS, iters)
    torch.cuda.synchronize()
    n_seg, e_cnt = sd.n_emit + 2, sd.n_emit
    n_active = int((st.is_[I_ACTIVE] != 0).sum())
    lane_in = 4 * m  # every lane reads its active flag
    out = {}

    # front: a pure function of the state
    o, d, x = bounce_front.front_bounce(st)
    refr_k = None if st.rf is None else (st.rf.clone(), st.ri.clone())
    op, dp, xp = bounce_front.front_bounce_plain(st)
    if not torch.equal(x, xp):
        raise AssertionError(f"{what} front: {int((x != xp).sum())} exclusion ids differ")
    err = max(compare_rows(o, op, f"{what} front origins"),
              compare_rows(d, dp, f"{what} front directions"))
    if refr_k is not None:  # the march's results, for the resolve step
        if not torch.equal(refr_k[1], st.ri):
            raise AssertionError(f"{what} front: march escaped/last rows differ on "
                                 f"{int((refr_k[1] != st.ri).sum())} entries")
        err = max([err] + [compare_rows(refr_k[0][r:r + 3], st.rf[r:r + 3],
                                        f"{what} front march rows {r}-{r + 2}")
                           for r in (0, 3, 6)])
    b = bound(lane_in + n_active * 40 + n_seg * m * 28 + scene_bytes(sd, ("tri_norm",)),
              n_active * FRONT_OPS)
    call_ms = cuda_ms(lambda: bounce_front.front_bounce(st), reps=5)
    out["front_bounce"] = dict(
        max_abs_err=err, call_ms=call_ms,
        ms=device_ms(lambda: bounce_front.front_bounce(st), reps=5),
        plain_ms=host_ms(lambda: bounce_front.front_bounce_plain(st)),
        bound_ms=b[0], bound_by=b[1])

    # trace: the kernel's segments through both walks
    bt, bi = trace.trace_segments(sd, o, d, x, e_cnt)
    t0 = time.perf_counter()
    with traverse.count_work() as work:
        btp, bip = trace.trace_segments_plain(sd, o, d, x, e_cnt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_diff, t_diff = compare_hits(bt, bi, btp, bip, e_cnt, f"{what} trace")
    hit = bt < kernels.INF
    hit[e_cnt] = False
    t_err = float((bt[hit] - btp[hit]).abs().max()) if bool(hit.any()) else 0.0
    # bytes: every item's direction and result; a nonzero ray's origin and
    # exclusion (a zero ray is a miss without them)
    n_rays = int((d != 0).any(dim=1).sum())
    b = bound(n_seg * m * 20 + n_rays * 16 + scene_bytes(sd, WALK_TABLES),
              work["boxes"] * BOX_OPS + work["tris"] * TRI_OPS)
    trace_call = lambda: trace.trace_segments(sd, o, d, x, e_cnt)  # noqa: E731
    call_ms = cuda_ms(trace_call, reps=3)
    out["trace_segments"] = dict(
        max_abs_err=t_err, call_ms=call_ms,
        ms=device_ms(trace_call, reps=3),
        plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], ids_differ=n_diff,
        t_differ=t_diff, work=work)

    # resolve: in place, so each call gets its own copy of the state
    ks = [st.clone() for _ in range(1 + 3 + 1 + TIMED_CALLS)]
    for k in ks:  # launch arguments built (the camera read back) before any timing
        k.args()
    ps = st.clone()
    bounce_resolve.resolve_bounce(ks[0], bt, bi)
    plain_ms = host_ms(lambda: bounce_resolve.resolve_bounce_plain(ps, bt, bi))
    err = compare_states(ks[0], ps, f"{what} resolve")
    calls = [lambda s=s: bounce_resolve.resolve_bounce(s, bt, bi) for s in ks[1:]]
    call_ms = cuda_ms_each(calls[:3])
    ms = device_ms_each(calls[3:])
    b = bound(lane_in + n_active * (80 + n_seg * 8) + n_active * 72 + 2 * npix * 12
              + scene_bytes(sd, ("tri_norm", "tri_obj", "env_map")),
              n_active * RESOLVE_OPS)
    out["resolve_bounce"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                 bound_ms=b[0], bound_by=b[1])

    # spawn on the resolved state: queue cut, lane ints and counters equal
    after = ks[0]
    del ks, calls
    ks = [after.clone() for _ in range(1 + 3 + 1 + TIMED_CALLS)]
    for k in ks:
        k.args()
    ps = after.clone()
    aux_k = torch.empty((8, m), dtype=torch.float32, device=sd.device)
    aux_p = torch.empty_like(aux_k)
    spawn_front.spawn_primary(ks[0], aux_k)
    with traverse.count_work() as work:
        plain_ms = host_ms(lambda: spawn_front.spawn_primary_plain(ps, aux_p))
    got = aux_p[7] != 0
    if not torch.equal(aux_k[7] != 0, got):
        raise AssertionError(f"{what} spawn: got differs on "
                             f"{int(((aux_k[7] != 0) != got).sum())} lanes")
    err = compare_states(ks[0], ps, f"{what} spawn")
    n_got = int(got.sum())
    calls = [lambda s=s: spawn_front.spawn_primary(s) for s in ks[1:]]
    call_ms = cuda_ms_each(calls[:3])
    ms = device_ms_each(calls[3:])
    b = bound(lane_in + n_got * 96 + 2 * npix * 12 + scene_bytes(sd, WALK_TABLES),
              work["boxes"] * BOX_OPS + work["tris"] * TRI_OPS + n_got * SPAWN_OPS)
    out["spawn_primary"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                bound_ms=b[0], bound_by=b[1], got=n_got)
    out["_state"] = dict(lanes=m, active=n_active, iterations=iters)
    return out


ORACLE_TRIS = 300                # phase 15: the RMSE gate's jade scene (cli/rmse_gate.py)
ORACLE_REFRACT_TRIS = 200        # phase 15: the DIR_REFRACT statue (tests/test_integrator.py)
BENCH_TIMEOUT_S = 300            # phase 16: one bench run (a fresh process, scene, 9 renders)
BENCH_REPS = 8                   # phase 16: the bench's default --reps
MESH_TIMEOUT_S = 300             # phase 14: a CLI run over a mesh (rendezvous, scene, render)
MESH_RTOL, MESH_ATOL_FRAC = 1e-4, 1e-5  # phase 14: an spp split against one device (the
                                 # JAX package's tests/test_parallel.py tolerance)
_MESH_CLI = (
    "import json, sys\n"
    "from jaderaytracerendering_tpu_torch.cli import render\n"
    "film, stats = render.main(sys.argv[1:])\n"
    "print('MESH_STATS ' + json.dumps(stats))\n")


def mesh_cli(args: list, tmp: str, name: str, visible: str | None) -> dict:
    """The render CLI at its defaults plus ``args`` (a ``--mesh``), started
    plainly in a subprocess with a timeout, so that it spawns its ranks
    itself; ``visible``: CUDA_VISIBLE_DEVICES for it (None: every card)
    -> rank 0's stats with every rank's under ``ranks``, the saved film
    and the wall time of the whole command."""
    film_path = os.path.join(tmp, f"{name}.npz")
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    cmd = [sys.executable, "-c", _MESH_CLI, *args, "--out", os.path.join(tmp, f"{name}.bmp"),
           "--save-film", film_path]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"phase 14 {name}: no result in {MESH_TIMEOUT_S} s "
                             f"(stderr: {(e.stderr or b'')[-2000:]!r})") from None
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 14 {name}: exit code {res.returncode}\n{res.stderr[-4000:]}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("MESH_STATS ")]
    stats = json.loads(line[-1][len("MESH_STATS "):])
    data = np.load(film_path)
    stats.update(film=torch.from_numpy(data["accum"]), count=int(data["count"]),
                 command_s=wall, log=res.stderr)
    return stats


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    from jaderaytracerendering_tpu_torch.cli import pool_sweep
    from jaderaytracerendering_tpu_torch.cli import preview as cli_preview
    from jaderaytracerendering_tpu_torch.cli import render as cli_render
    from jaderaytracerendering_tpu_torch.cli import rmse_gate
    from jaderaytracerendering_tpu_torch.cli.common import card
    from jaderaytracerendering_tpu_torch.core import camera as camera_mod
    from jaderaytracerendering_tpu_torch.core.film import Film
    from jaderaytracerendering_tpu_torch.cpuref import integrator as oracle
    from jaderaytracerendering_tpu_torch.integrator import mega as mega_mod
    from jaderaytracerendering_tpu_torch.integrator import pool, wavefront
    from jaderaytracerendering_tpu_torch.integrator import render as trender
    from jaderaytracerendering_tpu_torch.integrator.render import render_batch
    from jaderaytracerendering_tpu_torch.models import demo
    from jaderaytracerendering_tpu_torch.ops import (build, kernels, mega as megak, postfx,
                                                     spawn_front, trace, traverse)
    from jaderaytracerendering_tpu_torch.ops.lanes import (C_DONE, C_NEXT, C_RAYS,
                                                           I_ACTIVE, I_PIX, I_SLOT, I_SMP,
                                                           PoolState)
    from jaderaytracerendering_tpu_torch.scene import material
    from jaderaytracerendering_tpu_torch.scene.scene import assemble
    from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

    dev = torch.device("cuda")
    gpu = card()
    log(f"phase 0 env: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kernels.library()
    log(f"phase 1 build: csrc/{' + csrc/'.join(kernels.SOURCES)} with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f}s")
    for line in build.library_path("kernels", kernels.SOURCES).with_suffix(".log") \
            .read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.split("ptxas info    : ")[-1].strip())

    # ---- phase 2: traversal ----------------------------------------------
    ds = demo.jade_scene(n_buddha_tris=MAIN_TRIS)
    sd = assemble(ds.objects, ds.env_map, device=dev)
    rng = np.random.default_rng(0)
    n = 1 << 16
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    ex = rng.integers(-1, sd.n_triangles, n).astype(np.int32)
    o_t = torch.tensor(o.T[None].copy(), device=dev)
    d_t = torch.tensor(d.T[None].copy(), device=dev)
    ex_t = torch.tensor(ex[None], device=dev)
    tk, ik = trace.trace_segments(sd, o_t, d_t, ex_t)
    tp, ip = trace.trace_segments_plain(sd, o_t, d_t, ex_t)
    torch.cuda.synchronize()
    trav_ms = cuda_ms(lambda: trace.trace_segments(sd, o_t, d_t, ex_t), reps=5)
    trav_plain_ms = host_ms(lambda: trace.trace_segments_plain(sd, o_t, d_t, ex_t))
    n_diff, t_diff = compare_hits(tk, ik, tp, ip, -1, "phase 2 traversal")
    log(f"phase 2 traversal: {n} rays, jade {sd.n_triangles} tris, {sd.n_nodes} nodes, depth "
        f"{sd.bvh_depth}, {float((tk < kernels.INF).float().mean()):.3f} hit; ids differ "
        f"{n_diff}, t differ {t_diff}; trace_segments {trav_ms:.3f} ms, plain torch "
        f"{trav_plain_ms:.1f} ms [{gpu}]")

    # ---- phase 3: megakernel vs plain on one whole image -------------------
    cfg3 = RenderConfig(width=96, height=96, spp=4, max_depth=6)
    eye, rot = camera_mod.camera_tensors(ds.camera, dev)
    # the camera on the host for timed calls, as the render and preview
    # paths pass it: a camera on the card is read back at each launch
    eye_h, rot_h = mega_mod.host_camera(ds.camera)
    out_k = megak.mega_render(sd, eye, rot, cfg3, 0, cfg3.spp)
    torch.cuda.synchronize()
    ms3 = cuda_ms(lambda: megak.mega_render(sd, eye, rot, cfg3, 0, cfg3.spp), reps=5)
    t_plain = time.perf_counter()
    with traverse.count_work() as work3:
        out_p = megak.mega_render_plain(sd, eye, rot, cfg3, 0, cfg3.spp)
    torch.cuda.synchronize()
    plain_ms3 = (time.perf_counter() - t_plain) * 1e3
    if not torch.equal(out_k[3], out_p[3]):
        raise AssertionError("phase 3: mega ray counts differ from the plain version")
    err3, ne3 = compare_mega(out_k[:3], out_p[:3], "phase 3")
    npix3 = cfg3.width * cfg3.height
    rays3 = float(out_p[3].sum())
    # ops: the walks' tests plus the shading of each bounce (front + resolve)
    bound3 = bound(scene_bytes(sd, mega_tables()) + 16 * npix3,
                   work3["boxes"] * BOX_OPS + work3["tris"] * TRI_OPS
                   + rays3 / (sd.n_emit + 2) * (FRONT_OPS + RESOLVE_OPS))
    log(f"phase 3 mega vs plain: jade 96x96 4spp depth 6: ray counts equal; max abs err "
        f"{err3:.3e} (max {float(out_p[:3].abs().max()):.3e}), {ne3}/{npix3} pixels not "
        f"bit-equal; kernel {ms3:.2f} ms, plain torch {plain_ms3:.0f} ms, bound {bound3[0]:.4f} ms "
        f"({bound3[1]}; {work3['boxes']} box, {work3['tris']} triangle tests) [{gpu}]")

    # ---- phase 4: the main path through the CLI ----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        bmp = os.path.join(tmp, "main.bmp")
        kernels.reset_launches()
        film, stats = cli_render.main(["--out", bmp])
        launches = dict(kernels.LAUNCHES)
        cfg4 = RenderConfig()
        if launches["mega_render"] < 1:
            raise AssertionError(f"main path did not launch mega_render: {launches}")
        acc = film.accum
        # a few channel sums may be negative: the reference's exit Fresnel
        # R0 - (1-R0)(1-c)^5 goes below 0 at grazing angles (sampling.py);
        # the subset check below holds them against the plain version
        n_neg = int((acc < 0).sum())
        if not (bool(torch.isfinite(acc).all()) and float(acc.mean()) > 0
                and n_neg <= 1e-4 * acc.numel()):
            raise AssertionError(f"main path film: finite {bool(torch.isfinite(acc).all())}, "
                                 f"mean {float(acc.mean())}, {n_neg} negative values")
        size = os.path.getsize(bmp)
        want = 54 + cfg4.height * (cfg4.width * 3 + (-cfg4.width * 3) % 4)
        if size != want or film.accum.shape != (cfg4.height, cfg4.width, 3):
            raise AssertionError(f"main path BMP {size} bytes (want {want}), "
                                 f"film {tuple(film.accum.shape)}")
    if stats["bvh_builder"] != "native":
        raise AssertionError(f"main path: the render CLI built its BVH with the "
                             f"{stats['bvh_builder']!r} builder, not the native one")
    # the scene build (the CLI's seconds) beside each builder's on the same scene
    build_ms4 = {b: host_ms(lambda b=b: assemble(ds.objects, ds.env_map, bvh_backend=b,
                                                 device=dev)) for b in ("native", "numpy")}
    secs = stats["seconds"]
    samples = cfg4.width * cfg4.height * cfg4.spp
    mega_film, mega_rays, mega_secs = film.accum, stats["rays"], secs
    log(f"phase 4 main path: jade {MAIN_TRIS} statue tris ({sd.n_triangles} total) "
        f"{cfg4.width}x{cfg4.height} {cfg4.spp}spp depth {cfg4.max_depth}: "
        f"{secs:.3f} s, {samples / secs / 1e6:.3f} Msamples/s, "
        f"{stats['rays'] / secs / 1e6:.3f} useful Mrays/s, launches {launches}, {n_neg} "
        f"negative channel sums, BMP {size} bytes; scene built by the {stats['bvh_builder']} "
        f"BVH builder in {stats['scene_build_s']:.3f} s (assemble again: native "
        f"{build_ms4['native'] / 1e3:.3f} s, numpy {build_ms4['numpy'] / 1e3:.3f} s) [{gpu}]")

    # the main path's film against the plain version on random pixels
    npix = cfg4.width * cfg4.height
    ids = torch.tensor(np.sort(rng.choice(npix, 4096, replace=False)), device=dev)
    t_plain = time.perf_counter()
    with traverse.count_work() as work4:
        rad_p, rays_p = render_batch(sd, eye, rot, ids, 0, cfg4, cfg4.spp,
                                     query=wavefront.nearest_planes_plain)
    torch.cuda.synchronize()
    plain_sub_s = time.perf_counter() - t_plain
    rad_k = film.accum.reshape(-1, 3)[ids]
    err4, ne4 = compare_mega(rad_k.T, rad_p.T, "phase 4 subset")
    main_ms = cuda_ms(lambda: megak.mega_render(sd, eye, rot, cfg4, 0, cfg4.spp))
    main_dev_ms = device_ms(lambda: megak.mega_render(sd, eye_h, rot_h, cfg4, 0, cfg4.spp),
                            reps=5)
    # the subset's work scaled to the film: the walks' tests and the
    # shading of each bounce; the tables once and 16 bytes out a pixel
    scale4 = npix / ids.numel()
    bound4 = bound(scene_bytes(sd, mega_tables()) + 16 * npix,
                   scale4 * (work4["boxes"] * BOX_OPS + work4["tris"] * TRI_OPS
                             + float(rays_p.sum()) / (sd.n_emit + 2)
                             * (FRONT_OPS + RESOLVE_OPS)))
    log(f"phase 4 check: film vs plain torch on {ids.numel()} random pixels: max abs err "
        f"{err4:.3e} (max {float(rad_p.abs().max()):.3e}), {ne4} not bit-equal (plain {plain_sub_s:.1f} s); one mega_render at the main-path shape {main_ms:.2f} ms "
        f"(CUDA events), {main_dev_ms:.3f} ms device time; main-path bound "
        f"{bound4[0]:.4f} ms ({bound4[1]}; the subset's {work4['boxes']} box, {work4['tris']} "
        f"triangle tests and {float(rays_p.sum()):.0f} useful rays x {scale4:.0f}) [{gpu}]")

    # ---- phase 5: trace kernel, stacked segments ---------------------------
    n_seg, e_cnt = sd.n_emit + 2, sd.n_emit
    o5 = torch.tensor(rng.uniform(-1.5, 1.5, (n_seg, 3, n)).astype(np.float32), device=dev)
    d5 = torch.tensor(rng.uniform(-0.6, 0.6, (n_seg, 3, n)).astype(np.float32),
                      device=dev) - o5
    x5 = torch.tensor(rng.integers(-1, sd.n_triangles, (n_seg, n)).astype(np.int32),
                      device=dev)
    bt5, bi5 = trace.trace_segments(sd, o5, d5, x5, e_cnt)
    t_plain = time.perf_counter()
    with traverse.count_work() as work5:
        btp5, bip5 = trace.trace_segments_plain(sd, o5, d5, x5, e_cnt)
    torch.cuda.synchronize()
    plain_ms5 = (time.perf_counter() - t_plain) * 1e3
    n_diff5, t_diff5 = compare_hits(bt5, bi5, btp5, bip5, e_cnt, "phase 5")
    ms5 = cuda_ms(lambda: trace.trace_segments(sd, o5, d5, x5, e_cnt), reps=5)
    bound5 = bound(n_seg * n * 20 + int((d5 != 0).any(dim=1).sum()) * 16
                   + scene_bytes(sd, WALK_TABLES),
                   work5["boxes"] * BOX_OPS + work5["tris"] * TRI_OPS)
    log(f"phase 5 trace: {n} rays x {n_seg} segments (segment {e_cnt} any-hit), "
        f"{float((bt5 < kernels.INF).float().mean()):.3f} hit; hit flags equal; ids differ "
        f"{n_diff5}, t differ {t_diff5}; kernel {ms5:.3f} ms, plain torch "
        f"{plain_ms5:.0f} ms, bound {bound5[0]:.4f} ms ({bound5[1]}) [{gpu}]")

    # ---- phase 6: spawn kernel, the queue running out inside the call -----
    st6 = PoolState.create(sd, cfg4, eye, rot, n, npix * cfg4.spp, 0)
    st6.is_[I_ACTIVE] = torch.tensor(rng.integers(0, 2, n).astype(np.int32), device=dev)
    for row in (I_SLOT, I_PIX, I_SMP):
        st6.is_[row] = torch.tensor(rng.integers(0, npix, n).astype(np.int32), device=dev)
    n_fresh = int((st6.is_[I_ACTIVE] == 0).sum())
    st6.cnt[C_NEXT] = st6.total - n_fresh // 2
    k6, p6 = st6.clone(), st6.clone()
    aux_k, aux_p = (torch.empty((8, n), dtype=torch.float32, device=dev) for _ in range(2))
    spawn_front.spawn_primary(k6, aux_k)
    spawn_front.spawn_primary_plain(p6, aux_p)
    torch.cuda.synchronize()
    got = aux_p[7] != 0
    consumed = int(k6.cnt[C_NEXT] - st6.cnt[C_NEXT])
    if not (torch.equal(aux_k[7] != 0, got) and torch.equal(k6.is_[I_SLOT:], p6.is_[I_SLOT:])
            and torch.equal(k6.cnt, p6.cnt) and consumed == n_fresh // 2):
        raise AssertionError(f"phase 6: got/slot/pix/smp/counters differ (consumed "
                             f"{consumed}, want {n_fresh // 2}; {k6.cnt.tolist()} vs "
                             f"{p6.cnt.tolist()})")
    err6 = compare_states(k6, p6, "phase 6 state")  # hit ids equal: the I_HIT row
    hit6 = got & (aux_p[3] < kernels.INF)
    dir_err6 = compare_rows(aux_k[0:3][:, got], aux_p[0:3][:, got], "phase 6 direction")
    sky_err6 = compare_rows(aux_k[4:7][:, got], aux_p[4:7][:, got], "phase 6 sky")
    if not torch.equal(aux_k[3] < kernels.INF, aux_p[3] < kernels.INF):
        raise AssertionError("phase 6: primary hit flags differ")
    t_err6 = float((aux_k[3][hit6] - aux_p[3][hit6]).abs().max())
    t_rel6 = float(((aux_k[3][hit6] - aux_p[3][hit6]).abs() / aux_p[3][hit6]).max())
    if t_rel6 > TRAV_T_SAME_RTOL:
        raise AssertionError(f"phase 6: primary hit t rel err {t_rel6:.3e}")
    log(f"phase 6 spawn: {n} lanes, {n_fresh} fresh, queue of {n_fresh // 2} left: got "
        f"{int(got.sum())}, consumed {consumed}; got/slot/pix/smp/counters equal; max abs "
        f"err direction {dir_err6:.3e}, hit t {t_err6:.3e}, sky {sky_err6:.3e}, "
        f"state {err6:.3e} [{gpu}]")
    if k6.cnt[C_DONE] != p6.cnt[C_DONE]:
        raise AssertionError("phase 6: finished-sample counters differ")

    # ---- phase 7: pool vs plain, whole image -------------------------------
    m7 = 8192
    s7k, s7p = {}, {}
    kernels.reset_launches()
    f7k = pool.render_film_pool(sd, ds.camera, cfg3, stats=s7k, pool_m=m7)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    st7 = PoolState.create(sd, cfg3, eye, rot, m7, npix3 * cfg3.spp, 0)
    s7p["iterations"] = pool.run_pool(st7, pool.PLAIN)
    s7p["rays"] = float(st7.cnt[C_RAYS])
    f7p = Film(st7.film.reshape(cfg3.height, cfg3.width, 3), cfg3.spp)
    torch.cuda.synchronize()
    plain_s7 = time.perf_counter() - t_plain
    ms7 = cuda_ms(lambda: pool.render_film_pool(sd, ds.camera, cfg3, pool_m=m7))
    err7, outside7, mean7 = compare_images(f7k.accum.reshape(-1, 3).T,
                                           f7p.accum.reshape(-1, 3).T, "phase 7")
    if s7k["rays"] != s7p["rays"] or s7k["iterations"] != s7p["iterations"]:
        raise AssertionError(f"phase 7: kernel route {s7k} vs plain route {s7p}")
    it7 = hold_pool_kernels(sd, ds.camera, cfg3, m7, 3, "phase 7")
    log(f"phase 7 pool vs plain: jade 96x96 4spp depth 6, {m7} lanes: max abs err "
        f"{err7:.3e} (max {float(f7p.accum.abs().max()):.3e}), {outside7}/{npix3} outside, "
        f"mean rel diff {mean7:.3e}; useful rays {s7k['rays']:.0f} equal, iterations "
        f"{s7k['iterations']}; kernel route {ms7:.2f} ms, plain route {plain_s7:.1f} s; "
        f"one iteration: front err {it7['front_bounce']['max_abs_err']:.3e}, resolve err "
        f"{it7['resolve_bounce']['max_abs_err']:.3e}, spawn err "
        f"{it7['spawn_primary']['max_abs_err']:.3e} [{gpu}]")

    # ---- phase 8: the pool main path through the CLI -----------------------
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        film8, stats8 = cli_render.main(["--engine", "pool",
                                         "--out", os.path.join(tmp, "pool.bmp")])
        launches8 = dict(kernels.LAUNCHES)
    pool_names = ("spawn_primary", "trace_segments", "front_bounce", "resolve_bounce")
    if min(launches8[k] for k in pool_names) < 1 or launches8["mega_render"]:
        raise AssertionError(f"pool main path launches {launches8}")
    err8, outside8, mean8 = compare_images(film8.accum.reshape(-1, 3).T,
                                           mega_film.reshape(-1, 3).T, "phase 8 vs mega")
    if stats8["rays"] != mega_rays:
        raise AssertionError(f"phase 8: useful rays {stats8['rays']} vs mega {mega_rays}")
    secs8 = stats8["seconds"]
    log(f"phase 8 pool main path: jade {MAIN_TRIS} {cfg4.width}x{cfg4.height} "
        f"{cfg4.spp}spp depth {cfg4.max_depth}, {min(pool.POOL_LANES, samples)} lanes: "
        f"{secs8:.3f} s ({secs8 / mega_secs:.2f}x mega), {samples / secs8 / 1e6:.3f} "
        f"Msamples/s, {stats8['rays'] / secs8 / 1e6:.3f} useful Mrays/s, "
        f"{stats8['iterations']} iterations, launches {launches8}; vs mega film: max abs "
        f"err {err8:.3e}, {outside8} outside, mean rel diff {mean8:.3e}; useful rays "
        f"{stats8['rays']:.0f} equal [{gpu}]")
    it8 = hold_pool_kernels(sd, ds.camera, cfg4, min(pool.POOL_LANES, samples), 3,
                            "phase 8")
    log("phase 8 kernels at the main path's shapes ("
        + ", ".join(f"{k} {v}" for k, v in it8["_state"].items()) + "): "
        + "; ".join(f"{k} {v['ms']:.4f} ms device ({v['call_ms']:.3f} ms a call from Python; "
                    f"plain {v['plain_ms']:.0f} ms, bound {v['bound_ms']:.4f} ms by "
                    f"{v['bound_by']}, err {v['max_abs_err']:.2e})"
                    for k, v in it8.items() if not k.startswith("_"))
        + f"; trace ids differ {it8['trace_segments']['ids_differ']}, t differ "
        f"{it8['trace_segments']['t_differ']}; trace work {it8['trace_segments']['work']} "
        f"[{gpu}]")
    # one more pool main-path render under the profiler (cli/pool_sweep.py's
    # trace): each pool kernel's launches and device total over the render.
    # The trace must hold every launch the render made (one spawn launch a
    # round): the profiler at times loses device events, so it is traced
    # again until it does
    for _ in range(3):
        tr8 = pool_sweep.trace_render(
            lambda s, c, f, stats=None: pool.render_film_pool(s, c, f.replace(engine="pool"),
                                                              stats=stats),
            sd, ds.camera, cfg4)
        seen8 = {k: v["launches"] for k, v in tr8["wrappers"].items()}
        if seen8 == {k: launches8[k] for k in pool_names}:
            break
    else:
        raise AssertionError(f"phase 8 trace: launches seen {seen8}, made "
                             f"{ {k: launches8[k] for k in pool_names} }")
    log("phase 8 pool main path traced: wall " f"{tr8['wall_ms']:.3f} ms, device busy "
        f"{tr8['busy_ms']:.3f} ms, idle {100 * tr8['idle_share']:.1f}%; "
        + ", ".join(f"{k} {v['device_ms']:.3f} ms in {v['launches']} launches"
                    for k, v in tr8["wrappers"].items()) + f" [{gpu}]")

    # ---- phase 9: the scan engine on the card -----------------------------
    kernels.reset_launches()
    s9 = {}
    f9 = trender.render_film(sd, ds.camera, cfg3.replace(engine="scan"), stats=s9)
    torch.cuda.synchronize()
    launches9 = dict(kernels.LAUNCHES)
    if launches9["trace_segments"] < 1 or launches9["mega_render"]:
        raise AssertionError(f"scan engine launches {launches9}")
    err9, outside9, mean9 = compare_images(f9.accum.reshape(-1, 3).T,
                                           f7p.accum.reshape(-1, 3).T, "phase 9")
    if s9["rays"] != s7p["rays"]:
        raise AssertionError(f"phase 9: useful rays {s9['rays']} vs {s7p['rays']}")
    log(f"phase 9 scan on the card: jade 96x96 4spp depth 6, trace_segments launches "
        f"{launches9['trace_segments']}; vs the plain pool film: max abs err {err9:.3e}, "
        f"{outside9} outside, mean rel diff {mean9:.3e}; useful rays equal [{gpu}]")

    # ---- phase 10: direct refraction in the three kernel paths -------------
    regs = ptxas_registers(build.library_path("kernels", kernels.SOURCES)
                           .with_suffix(".log").read_text())
    ds10 = demo.jade_scene(n_buddha_tris=MAIN_TRIS)
    glass = dataclasses.replace(ds10.objects[0].material, refract_mode=material.DIR_REFRACT,
                                refract_index=1.5, refract_rate=(0.9, 0.9, 0.9))
    ds10.objects[0] = dataclasses.replace(ds10.objects[0], material=glass)
    sd10 = assemble(ds10.objects, ds10.env_map, device=dev)
    cfg10 = cfg3.replace(max_refract_bounces=32)
    if not sd10.has_refract:
        raise AssertionError("phase 10: the scene has no DIR_REFRACT material")
    kernels.reset_launches()
    out10k = megak.mega_render(sd10, eye, rot, cfg10, 0, cfg10.spp)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    out10p = megak.mega_render_plain(sd10, eye, rot, cfg10, 0, cfg10.spp)
    torch.cuda.synchronize()
    plain_ms10 = (time.perf_counter() - t_plain) * 1e3
    ms10 = cuda_ms(lambda: megak.mega_render(sd10, eye, rot, cfg10, 0, cfg10.spp), reps=3)
    if not torch.equal(out10k[3], out10p[3]):
        raise AssertionError("phase 10: mega ray counts differ from the plain version")
    err10, ne10 = compare_mega(out10k[:3], out10p[:3], "phase 10 mega")
    s10k, s10p = {}, {}
    f10k = pool.render_film_pool(sd10, ds.camera, cfg10, stats=s10k, pool_m=m7)
    launches10 = dict(kernels.LAUNCHES)
    st10 = PoolState.create(sd10, cfg10, eye, rot, m7, npix3 * cfg10.spp, 0)
    s10p["iterations"] = pool.run_pool(st10, pool.PLAIN)
    s10p["rays"] = float(st10.cnt[C_RAYS])
    torch.cuda.synchronize()
    err10p, outside10p, mean10p = compare_images(f10k.accum.reshape(-1, 3).T, st10.film.T,
                                                 "phase 10 pool vs plain")
    if s10k != s10p:
        raise AssertionError(f"phase 10: pool kernel route {s10k} vs plain route {s10p}")
    err10m, outside10m, mean10m = compare_images(f10k.accum.reshape(-1, 3).T, out10k[:3],
                                                 "phase 10 pool vs mega")
    mega_rays10 = float(out10k[3].sum(dtype=torch.float64))
    if s10k["rays"] != mega_rays10:
        raise AssertionError(f"phase 10: pool useful rays {s10k['rays']} vs mega {mega_rays10}")
    if min(launches10[k] for k in ("mega_render", "front_bounce", "resolve_bounce")) < 1:
        raise AssertionError(f"phase 10 launches {launches10}")
    it10 = hold_pool_kernels(sd10, ds.camera, cfg10, m7, 3, "phase 10")
    reg_line = ", ".join(f"{k} {v}" for k, v in sorted(regs.items())
                         if k.endswith(("<false>", "<true>")))
    log(f"phase 10 refraction: jade {MAIN_TRIS} with a DIR_REFRACT statue, 96x96 4spp depth "
        f"6, 32 march steps: mega vs plain max abs err {err10:.3e} (max "
        f"{float(out10p[:3].abs().max()):.3e}), {ne10} pixels not bit-equal, ray counts "
        f"equal; kernel {ms10:.2f} ms, plain torch {plain_ms10:.0f} ms; pool "
        f"({m7} lanes) vs its plain route max abs err {err10p:.3e}, {outside10p} outside, "
        f"rays {s10k['rays']:.0f} and iterations {s10k['iterations']} equal; pool vs mega "
        f"max abs err {err10m:.3e}, {outside10m} outside, mean rel diff {mean10m:.3e}, "
        f"useful rays equal; one iteration: front err "
        f"{it10['front_bounce']['max_abs_err']:.3e} (march rows included), resolve err "
        f"{it10['resolve_bounce']['max_abs_err']:.3e}; ptxas registers: {reg_line} [{gpu}]")

    # ---- phase 11: the preview kernel against its plain version -----------
    cfg11 = cfg3.replace(integrator="preview")
    kernels.reset_launches()
    # both add into a film of ones: the kernel's add into the band is held too
    out11k = megak.render_preview_mega(sd, eye, rot, cfg11, 0, cfg11.spp,
                                       torch.ones((npix3, 3), device=dev))
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    with traverse.count_work() as work11:
        out11p = megak.render_preview_mega_plain(sd, eye, rot, cfg11, 0, cfg11.spp,
                                                 torch.ones((npix3, 3), device=dev))
    torch.cuda.synchronize()
    plain_ms11 = (time.perf_counter() - t_plain) * 1e3
    band11 = torch.zeros((npix3, 3), device=dev)
    ms11 = device_ms(lambda: megak.render_preview_mega(sd, eye_h, rot_h, cfg11, 0, cfg11.spp,
                                                       band11), reps=5)
    if not torch.equal(out11k, out11p):
        raise AssertionError(f"phase 11: the preview kernel differs from its plain version on "
                             f"{int((out11k != out11p).any(dim=1).sum())} pixels")
    err11, outside11, mean11 = compare_images(out11k.T, out11p.T, "phase 11")
    bound11 = bound(scene_bytes(sd, PREVIEW_TABLES) + 24 * npix3,
                    work11["boxes"] * BOX_OPS + work11["tris"] * TRI_OPS
                    + npix3 * cfg11.spp * PREVIEW_OPS)
    pcfg = cfg11.replace(spp=1, preview_bands=4)
    full11 = trender.render_film_preview(sd, ds.camera, pcfg.replace(preview_bands=1))
    band11 = None
    for f in range(4):
        band11, _ = trender.render_film_preview(sd, ds.camera, pcfg, film=band11,
                                                display=True, frame_idx=f)
    if not torch.equal(band11.accum, full11.accum) or band11.count != full11.count:
        raise AssertionError("phase 11: a 4-band rotation differs from one full frame")
    log(f"phase 11 preview kernel vs plain: jade 96x96 4spp 2 bounces: max abs err "
        f"{err11:.3e} (max {float(out11p.abs().max()):.3e}), {outside11}/{npix3} outside, "
        f"mean rel diff {mean11:.3e}, bit-equal (asserted); kernel "
        f"{ms11:.3f} ms (device time), plain torch {plain_ms11:.0f} ms, bound {bound11[0]:.4f} ms "
        f"({bound11[1]}); 4-band rotation equal to one full frame bit for bit [{gpu}]")

    # ---- phase 12: postfx against its plain version ------------------------
    film12 = mega_film.contiguous()
    g12 = np.random.default_rng(12)
    n12 = err12 = 0  # err12: the largest u8 step between kernel and plain over every case
    for h, w in ((cfg4.height, cfg4.width), (7, 1021), (5, 13)):
        for offset in (0, 1, 2, 3):  # float offsets: only 0 is 16-byte aligned
            buf = torch.empty(3 * h * w + 4, device=dev)
            if (h, w) == film12.shape[:2]:
                buf[offset:offset + film12.numel()] = film12.reshape(-1)
            else:
                buf[:] = torch.tensor(g12.uniform(-1, 60, buf.numel()).astype(np.float32),
                                      device=dev)
            accum = buf[offset:offset + 3 * h * w].view(h, w, 3)
            for mode, (flip, span, split), out_off in itertools.product(
                    ("aces", "reinhard", "none"), postfx_cases(h, w), (0, 1)):
                kw = dict(flip=flip, span=span, split=split,
                          count_hi=None if split is None else cfg4.spp - 1)
                outs = [torch.full((3 * h * w + 1,), 7, dtype=torch.uint8, device=dev)
                        for _ in range(2)]
                for fn, o in zip((postfx.postfx, postfx.postfx_plain), outs):
                    fn(accum, cfg4.spp, mode, out=o[out_off:out_off + 3 * h * w].view(h, w, 3),
                       **kw)
                err12 = max(err12, u8_steps(*outs))
                if not torch.equal(*outs):
                    raise AssertionError(
                        f"phase 12 postfx {h}x{w} offset {offset} {mode} flip={flip} span={span} "
                        f"split={split} display offset {out_off}: "
                        f"{int((outs[0] != outs[1]).sum())} bytes differ from the plain version")
                n12 += 1
    # every float in [0, 2] as a channel's sum, count 1, no tone map: the
    # kernel's power and quantisation against the plain version's on every
    # value they can take below the clamp (above 2 both give 255)
    n_vals12 = (1 << 30) + 1  # the bit patterns of 0.0 .. 2.0
    chunk12 = 3 << 26
    for lo in range(0, n_vals12, chunk12):
        bits = torch.arange(lo, lo + chunk12, dtype=torch.int32, device=dev).clamp_(max=1 << 30)
        vals = bits.view(torch.float32).view(1, chunk12 // 3, 3)
        k12, p12 = postfx.postfx(vals, 1, "none"), postfx.postfx_plain(vals, 1, "none")
        err12 = max(err12, u8_steps(k12, p12))
        if not torch.equal(k12, p12):
            bad = (k12 != p12).reshape(-1).nonzero()[:4].reshape(-1)
            raise AssertionError(f"phase 12 postfx: channel values {vals.reshape(-1)[bad].tolist()}"
                                 f" give {k12.reshape(-1)[bad].tolist()}, the plain version "
                                 f"{p12.reshape(-1)[bad].tolist()}")
    del bits, vals, k12, p12
    out12 = torch.empty(film12.shape, dtype=torch.uint8, device=dev)
    npix4 = cfg4.width * cfg4.height
    split12 = npix4 * 3 // 4  # a banded frame's display: the fourth band trails
    ms12 = device_ms(lambda: postfx.postfx(film12, cfg4.spp, "aces", flip=True, out=out12))
    banded_ms12 = device_ms(lambda: postfx.postfx(film12, cfg4.spp, "aces", flip=True, out=out12,
                                                  split=split12, count_hi=cfg4.spp - 1))
    call_ms12 = cuda_ms(lambda: postfx.postfx(film12, cfg4.spp, "aces", flip=True, out=out12),
                        reps=20)
    plain_ms12 = host_ms(lambda: postfx.postfx_plain(film12, cfg4.spp, "aces", flip=True))
    bound12 = bound(npix4 * 15, npix4 * POSTFX_OPS)
    log(f"phase 12 postfx vs plain: {n12} cases ({cfg4.width}x{cfg4.height} main-path film, "
        f"7x1021 and 5x13 random films; views at float offsets 0-3; aces/reinhard/none; both "
        f"flips, odd spans, one and two counts; displays at byte offsets 0 and 1; and every "
        f"float in [0, 2] as a channel, {n_vals12} values, count 1, no tone map): equal byte "
        f"for byte, largest step {err12}; kernel at {cfg4.width}x{cfg4.height}, aces, flipped: {ms12:.5f} ms device "
        f"time ({call_ms12:.4f} ms a call from Python), with a split and two counts "
        f"{banded_ms12:.5f} ms; plain torch {plain_ms12:.2f} ms, bound {bound12[0]:.5f} ms "
        f"({bound12[1]}) [{gpu}]")

    # ---- phase 13: the preview main path through the CLI -------------------
    with tempfile.TemporaryDirectory() as tmp:
        out13 = os.path.join(tmp, "preview.bmp")
        kernels.reset_launches()
        film13, info13 = cli_preview.main(["--frames", str(PREVIEW_MAIN_FRAMES), "--out", out13])
        launches13 = dict(kernels.LAUNCHES)
        size13 = os.path.getsize(out13)
    if (launches13["render_preview_mega"] != PREVIEW_MAIN_FRAMES
            or launches13["postfx"] != PREVIEW_MAIN_FRAMES or launches13["mega_render"]):
        raise AssertionError(f"preview main path launches {launches13}")
    if size13 != want or film13.count != PREVIEW_MAIN_FRAMES // 4:
        raise AssertionError(f"preview main path: BMP {size13} bytes (want {want}), film "
                             f"count {film13.count}")
    pmain = RenderConfig(integrator="preview", spp=1)
    rad13, _ = render_batch(sd, eye, rot, ids, 0, pmain, film13.count,
                            query=wavefront.nearest_planes_plain)
    err13, outside13, mean13 = compare_images(film13.accum.reshape(-1, 3)[ids].T, rad13.T,
                                              "phase 13 subset")
    band_px = npix4 // 4
    band13 = torch.zeros((band_px, 3), device=dev)
    frame_ms13 = device_ms(lambda: megak.render_preview_mega(sd, eye_h, rot_h, pmain, 0, 1,
                                                             band13), reps=10)
    # the band's bound: the walks' tests and the shading of a random subset
    # of its pixels scaled to the band; the tables once, the band's sums
    # read and written (12 bytes each way a pixel)
    ids13 = torch.tensor(np.sort(rng.choice(band_px, 4096, replace=False)), device=dev)
    with traverse.count_work() as work13:
        render_batch(sd, eye, rot, ids13, 0, pmain, 1, query=wavefront.nearest_planes_plain)
    scale13 = band_px / ids13.numel()
    bound13 = bound(scene_bytes(sd, PREVIEW_TABLES) + 24 * band_px,
                    scale13 * (work13["boxes"] * BOX_OPS + work13["tris"] * TRI_OPS)
                    + band_px * PREVIEW_OPS)
    fps13 = info13["frames"] / info13["seconds"]
    # the frame the CLI showed last (a whole rotation: one count), and the
    # banded display of every frame of a rotation, against the plain postfx
    # band by band (the kernel's spans and counts held independently)
    want13 = postfx.postfx_plain(film13.accum, film13.count, pmain.tonemap, flip=True)
    disp_err13 = int((info13["display"].int() - want13.cpu().int()).abs().max())
    for f in range(PREVIEW_MAIN_FRAMES):
        disp_k = trender.display_banded(film13.accum, f, 4, pmain.spp, pmain.tonemap)
        disp_p = banded_display_plain(film13.accum, f, 4, pmain.spp, pmain.tonemap)
        disp_err13 = max(disp_err13, int((disp_k.int() - disp_p.int()).abs().max()))
    if disp_err13:
        raise AssertionError(f"phase 13: the banded display differs from the plain postfx "
                             f"by {disp_err13} u8 steps")
    # the steady state: 64 frames, then 64 more traced; the first frames
    # (first launches, pinned buffers) are left out of both
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        argv = ["--frames", str(PREVIEW_STEADY_FRAMES), "--out", os.path.join(tmp, "p.bmp")]
        _, steady13 = cli_preview.main(argv)
        traced13, prof13 = traced(lambda: cli_preview.main(argv)[1], "preview_render_kernel")
    warm = PREVIEW_WARM_FRAMES
    fps_steady13, fps_traced13 = ((len(i["frame_s"]) - warm) / sum(i["frame_s"][warm:])
                                  for i in (steady13, traced13))
    idle13, window13 = device_idle_share(prof13, "preview_render_kernel", warm)
    # a steady banded frame: one preview launch, one postfx, no other kernel
    # (the window ends where the last frame's preview launch starts, so it
    # holds one postfx launch fewer than preview launches)
    ran13 = device_kernels(prof13, "preview_render_kernel", warm)
    n_prev13 = sum(v for k, v in ran13.items() if "preview_render_kernel" in k)
    n_post13 = sum(v for k, v in ran13.items() if "postfx_kernel" in k)
    if (n_prev13 != PREVIEW_STEADY_FRAMES - warm or n_post13 != n_prev13 - 1
            or n_prev13 + n_post13 != sum(ran13.values())):
        raise AssertionError(f"phase 13: the steady frames ran {ran13}")
    log(f"phase 13 preview main path: jade {MAIN_TRIS} {cfg4.width}x{cfg4.height}, 1 spp a "
        f"frame, 2 bounces, 4 bands, {info13['frames']} frames in {info13['seconds']:.3f} s: "
        f"{fps13:.1f} frames/s (CLI wall clock, warm-up included); launches {launches13}; "
        f"film vs plain torch on {ids.numel()} random pixels: max abs err {err13:.3e}, "
        f"{outside13} outside, mean rel diff {mean13:.3e}; the last frame shown and the banded "
        f"display of frames 0-{PREVIEW_MAIN_FRAMES - 1} vs the plain postfx band by band: max "
        f"u8 diff {disp_err13}; render_preview_mega {frame_ms13:.4f} ms per banded frame "
        f"({band_px} pixels; bound {bound13[0]:.5f} ms by {bound13[1]}: the "
        f"{ids13.numel()}-pixel subset's {work13['boxes']} box and {work13['tris']} "
        f"triangle tests x {scale13:.0f}) and postfx {banded_ms12:.5f} ms per banded display "
        f"(one launch, two counts; device time); BMP {size13} bytes [{gpu}]")
    log(f"phase 13 steady state: {PREVIEW_STEADY_FRAMES} frames, frames {warm + 1}-"
        f"{PREVIEW_STEADY_FRAMES}: {fps_steady13:.1f} frames/s (CLI wall clock); traced run: "
        f"{fps_traced13:.1f} frames/s under torch.profiler, device idle {100 * idle13:.1f}% of "
        f"the {window13:.2f} ms from its frame {warm + 1}'s preview launch to its last, in which "
        f"the device ran {n_prev13} preview and {n_post13} postfx launches and no other "
        f"kernel [{gpu}]")

    # ---- phase 14: multi-device ------------------------------------------
    # (a) windows in-process: the three tile windows of a 3x1 mesh (the
    # middle one starts off a block edge, the last is shorter) through the
    # megakernel, each equal to its columns of phase 4's film bit for bit;
    # the pool over the same windows within compare_images of them, with
    # equal useful rays
    shard14 = -(-npix // 3)
    windows14 = [(t * shard14, min(shard14, npix - t * shard14)) for t in range(3)]
    flat4 = mega_film.reshape(-1, 3)
    win14 = []
    rays14 = 0.0
    for p0, n_px in windows14:
        kernels.reset_launches()
        t_w = time.perf_counter()
        out_w = megak.mega_render(sd, eye_h, rot_h, cfg4, 0, cfg4.spp, p0, n_px)
        torch.cuda.synchronize()
        mega_w_ms = (time.perf_counter() - t_w) * 1e3
        if not torch.equal(out_w[0:3].T, flat4[p0:p0 + n_px]):
            n_bad = int((out_w[0:3].T != flat4[p0:p0 + n_px]).any(dim=1).sum())
            raise AssertionError(f"phase 14 window [{p0}, {p0 + n_px}): {n_bad} pixels differ "
                                 f"from phase 4's film")
        acc_w = torch.zeros((n_px, 3), device=dev)
        t_w = time.perf_counter()
        pool_rays_w, _ = pool.render_window_pool(sd, ds.camera, cfg4, acc_w, p0, 0, cfg4.spp)
        torch.cuda.synchronize()
        pool_w_ms = (time.perf_counter() - t_w) * 1e3
        mega_rays_w = float(out_w[3].sum(dtype=torch.float64))
        err_w, outside_w, _ = compare_images(acc_w.T, out_w[0:3], f"phase 14 pool window {p0}")
        if pool_rays_w != mega_rays_w:
            raise AssertionError(f"phase 14 window {p0}: pool rays {pool_rays_w} vs mega "
                                 f"{mega_rays_w}")
        launches_w = dict(kernels.LAUNCHES)
        if launches_w["mega_render"] != 1 or min(
                launches_w[k] for k in ("spawn_primary", "trace_segments", "front_bounce",
                                        "resolve_bounce")) < 1:
            raise AssertionError(f"phase 14 window {p0}: launches {launches_w}")
        rays14 += mega_rays_w
        win14.append({"pix0": p0, "n_px": n_px, "mega_ms": mega_w_ms, "pool_ms": pool_w_ms,
                      "pool_max_abs_err": err_w, "pool_outside": outside_w,
                      "useful_rays": mega_rays_w})
    if rays14 != mega_rays:
        raise AssertionError(f"phase 14: the windows' useful rays {rays14} vs the film's "
                             f"{mega_rays}")
    log("phase 14 windows: " + "; ".join(
        f"[{w['pix0']}, {w['pix0'] + w['n_px']}) mega {w['mega_ms']:.2f} ms bit-equal to phase "
        f"4's columns, pool {w['pool_ms']:.2f} ms max abs err {w['pool_max_abs_err']:.3e} "
        f"({w['pool_outside']} outside), rays equal" for w in win14) + f" [{gpu}]")

    # (b) the render CLI over a mesh, its ranks spawned by the CLI: 2x1
    # (mega) bit for bit against phase 4's film, 1x2 --engine pool within
    # MESH_RTOL / MESH_ATOL_FRAC of it; both ranks on one card over gloo
    # (CUDA_VISIBLE_DEVICES=0), and, with two cards or more, 2x1 over NCCL
    runs14 = [("2x1-gloo", ["--mesh", "2x1"], "0", "gloo"),
              ("1x2-pool-gloo", ["--mesh", "1x2", "--engine", "pool"], "0", "gloo")]
    if torch.cuda.device_count() >= 2:
        runs14.append(("2x1-nccl", ["--mesh", "2x1"], None, "nccl"))
    mesh14 = []
    film4_cpu = mega_film.cpu()
    scale14 = float(film4_cpu.abs().max())
    with tempfile.TemporaryDirectory() as tmp:
        # the yardstick: the CLI on one device in a fresh process, as each
        # rank is one (its first launches load the kernel library)
        one14 = mesh_cli([], tmp, "one-device", "0")
        if not torch.equal(one14["film"], film4_cpu):
            raise AssertionError("phase 14: the one-device CLI's film differs from phase 4's")
        log(f"phase 14 CLI one device, a fresh process: render {one14['seconds']:.3f} s, "
            f"command {one14['command_s']:.1f} s [{gpu}]")
        for name, args, visible, backend in runs14:
            st = mesh_cli(args, tmp, name, visible)
            ranks = st["ranks"]
            if st["count"] != cfg4.spp or len(ranks) != 2:
                raise AssertionError(f"phase 14 {name}: count {st['count']}, {len(ranks)} ranks")
            if {r["backend"] for r in ranks} != {backend}:
                raise AssertionError(f"phase 14 {name}: backends {[r['backend'] for r in ranks]}")
            if len({r["film_sha256"] for r in ranks}) != 1:
                raise AssertionError(f"phase 14 {name}: the ranks' films differ")
            names = (("spawn_primary", "trace_segments", "front_bounce", "resolve_bounce")
                     if "pool" in name else ("mega_render",))
            for r in ranks:
                if min(r["launches"][k] for k in names) < 1:
                    raise AssertionError(f"phase 14 {name}: rank {r['rank']} launches "
                                         f"{r['launches']}")
            if st["rays"] != mega_rays:
                raise AssertionError(f"phase 14 {name}: useful rays {st['rays']} vs phase 4's "
                                     f"{mega_rays}")
            if "pool" in name:
                err = (st["film"].double() - film4_cpu.double()).abs()
                over = err > MESH_RTOL * film4_cpu.double().abs() + MESH_ATOL_FRAC * scale14
                if bool(over.any()):
                    raise AssertionError(f"phase 14 {name}: {int(over.sum())} values outside "
                                         f"rtol {MESH_RTOL} + atol {MESH_ATOL_FRAC} x max")
                max_err = float(err.max())
            else:
                if not torch.equal(st["film"], film4_cpu):
                    raise AssertionError(f"phase 14 {name}: film differs from phase 4's")
                max_err = 0.0
            row = {"run": name, "backend": backend,
                   "devices": [f"{r['device']} {r['rank_device']}" for r in ranks],
                   "seconds": st["seconds"], "command_s": st["command_s"],
                   "allreduce_ms": [r["allreduce_ms"] for r in ranks],
                   "allreduce_calls": ranks[0]["allreduce_calls"],
                   "allreduce_bytes": ranks[0]["allreduce_bytes"],
                   "launches": [r["launches"] for r in ranks], "max_abs_err": max_err,
                   "useful_rays": st["rays"]}
            mesh14.append(row)
            log(f"phase 14 CLI {' '.join(args)}: 2 ranks ({backend}, "
                f"{', '.join(row['devices'])}) "
                f"render {st['seconds']:.3f} s ({st['seconds'] / one14['seconds']:.2f}x one "
                f"device in a fresh process), "
                f"command {st['command_s']:.1f} s; all_reduce "
                f"{', '.join(f'{v:.3f}' for v in row['allreduce_ms'])} ms a rank in "
                f"{row['allreduce_calls']} calls of {row['allreduce_bytes']} bytes; film "
                f"{'bit-equal to' if not max_err else f'max abs err {max_err:.3e} against'} "
                f"phase 4's, every rank's equal, useful rays equal; launches "
                f"{row['launches'][0]} [{gpu}]")
    log("phase 14 note: ranks that share one card measure the mesh's overhead, not scaling")
    print(json.dumps({"multi_device": {"windows": win14, "one_device_seconds": one14["seconds"],
                                       "cli": mesh14, "card": gpu}}))

    # ---- phase 15: the kernels against the CPU oracle ----------------------
    # one oracle film per scene (cpuref, path by path on the CPU), each
    # engine's film on the card held to it by the gate's own comparison;
    # the gate's view (r 2.0) shows the statue to no primary ray at 8x8,
    # the statue views do (SSS, mirror; the DIR_REFRACT march)
    engine_kernels = {"mega": ("mega_render",), "pool": pool_names, "scan": ("trace_segments",)}
    ds15r = demo.jade_scene(n_buddha_tris=ORACLE_REFRACT_TRIS, env_shape=(16, 32))
    ds15r.objects[0] = dataclasses.replace(ds15r.objects[0], material=dataclasses.replace(
        ds15r.objects[0].material, refract_mode=material.DIR_REFRACT, refract_index=1.5,
        refract_rate=(0.9, 0.9, 0.9)))
    rmse_gate.statue_view(ds15r.camera)
    gate15 = {}
    for scene15, ds15, cfg15, engines15 in (
            ("jade", rmse_gate.gate_scene(ORACLE_TRIS),
             RenderConfig(width=8, height=8, spp=64, max_depth=4), ("mega", "pool", "scan")),
            ("statue", rmse_gate.gate_scene(ORACLE_TRIS, statue=True),
             RenderConfig(width=8, height=8, spp=16, max_depth=4), ("mega", "pool", "scan")),
            ("dir_refract", ds15r,
             RenderConfig(width=8, height=8, spp=16, max_depth=3, max_refract_bounces=8),
             ("mega", "pool"))):
        sd15c = assemble(ds15.objects, ds15.env_map, device="cpu")
        sd15 = assemble(ds15.objects, ds15.env_map, device=dev)
        t0 = time.perf_counter()
        ref15 = oracle.render_radiance(sd15c, ds15.camera, cfg15)
        oracle_s = time.perf_counter() - t0
        rays15 = {}
        for engine in engines15:
            kernels.reset_launches()
            st15 = {}
            got15 = trender.render_film(sd15, ds15.camera, cfg15.replace(engine=engine),
                                        stats=st15).mean().cpu()
            launched15 = dict(kernels.LAUNCHES)
            if min(launched15[k] for k in engine_kernels[engine]) < 1:
                raise AssertionError(f"phase 15 {scene15} {engine}: launches {launched15}")
            r15, m15 = rmse_gate.check_rmse(got15, ref15, f"phase 15 {scene15} {engine}")
            rays15[engine] = st15["rays"]
            gate15[scene15, engine] = {"rmse_rel": r15, "max_rel": m15, "rays": st15["rays"],
                                       "oracle_s": oracle_s}
        if len(set(rays15.values())) != 1:
            raise AssertionError(f"phase 15 {scene15}: useful rays differ {rays15}")
        log(f"phase 15 oracle gate, {scene15} ({sd15.n_triangles} tris) {cfg15.width}x"
            f"{cfg15.height} {cfg15.spp}spp depth {cfg15.max_depth}: " + "; ".join(
                f"{e} relative RMSE {gate15[scene15, e]['rmse_rel']:.4e}, max rel err "
                f"{gate15[scene15, e]['max_rel']:.4e}" for e in engines15)
            + f" (gate < {rmse_gate.GATE:g}); useful rays equal ({rays15[engines15[0]]:.0f}); "
            f"oracle {oracle_s:.3f} s on the CPU [{gpu}]")

    # ---- phase 16: the bench at its defaults, mega and pool ---------------
    bench16 = {}
    for engine in ("mega", "pool"):
        cmd = [sys.executable, "-m", "jaderaytracerendering_tpu_torch.bench", "--engine", engine]
        try:
            res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                                 timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"phase 16 bench {engine}: no result in {BENCH_TIMEOUT_S} s "
                                 f"(stderr: {(e.stderr or b'')[-2000:]!r})") from None
        if res.returncode != 0:
            raise AssertionError(f"phase 16 bench {engine}: exit code {res.returncode}\n"
                                 f"{res.stderr[-4000:]}")
        out16 = res.stdout.strip().splitlines()
        line16 = json.loads(out16[-1])
        reps16 = [ln for ln in out16 if ln.startswith("rep ")]
        if line16["reps"] != BENCH_REPS or len(reps16) != BENCH_REPS:
            raise AssertionError(f"phase 16 bench {engine}: {len(reps16)} rep lines, reps "
                                 f"{line16['reps']}")
        if not line16["value"] > 0 or line16["engine"] != engine:
            raise AssertionError(f"phase 16 bench {engine}: {line16}")
        if min(line16["launches"].get(k, 0) for k in engine_kernels[engine]) < 1:
            raise AssertionError(f"phase 16 bench {engine}: launches {line16['launches']}")
        bench16[engine] = line16
        print(json.dumps(line16), flush=True)
        log(f"phase 16 bench --engine {engine} (defaults, a fresh process): "
            f"{line16['value']:.3f} Mrays/s sustained over {line16['reps']} renders, single "
            f"{line16['single_ms']['min']:.3f} / {line16['single_ms']['median']:.3f} / "
            f"{line16['single_ms']['max']:.3f} ms (min / median / max), "
            f"{line16['rays']:.0f} useful rays a render; " + "; ".join(
                ln for ln in out16 if ln.startswith("scene:")) + f" [{gpu}]")
    if bench16["mega"]["rays"] != bench16["pool"]["rays"]:
        raise AssertionError(f"phase 16: useful rays mega {bench16['mega']['rays']} vs pool "
                             f"{bench16['pool']['rays']}")

    lib_note = "no single PyTorch call computes this function"
    main_shape = (f"jade 20k, 1024x1024 16 spp depth 16, {it8['_state']['lanes']} lanes "
                  f"after {it8['_state']['iterations']} iterations")
    src = "jaderaytracerendering_tpu_torch/csrc/"
    kernels_out = [{
        "name": "mega_render", "route": "cuda", "source": src + "mega.cu",
        "replaces": "jaderaytracerendering_tpu/ops/pallas/mega.py:782",
        "launches": launches["mega_render"], "max_abs_err": err3, "ms": ms3,
        "plain_ms": plain_ms3, "bound_ms": bound3[0], "bound_by": bound3[1],
        "library_ms": None, "library_note": lib_note,
        "shape": "jade 20k, 96x96, 4 spp, depth 6 (ms, plain_ms, max_abs_err, bound_ms)",
        "main_path_ms": main_ms, "main_path_device_ms": main_dev_ms,
        "main_path_bound_ms": bound4[0], "main_path_bound_by": bound4[1],
        "main_path_max_abs_err": err4,
        "refract_ms": ms10, "refract_max_abs_err": err10,
        "oracle_rmse_rel": gate15["jade", "mega"]["rmse_rel"],
        "oracle_rmse_rel_statue": gate15["statue", "mega"]["rmse_rel"],
        "oracle_rmse_rel_refract": gate15["dir_refract", "mega"]["rmse_rel"],
        "registers": {k: v for k, v in regs.items() if k.startswith("mega_render")},
    }]
    for name, replaces in (
            ("spawn_primary", "ops/pallas/spawn_front.py:63"),
            ("trace_segments", "ops/pallas/cluster_sweep_fused.py:49"),
            ("front_bounce", "ops/pallas/bounce_front.py:77"),
            ("resolve_bounce", "ops/pallas/bounce_resolve.py:47")):
        v = it8[name]
        kernels_out.append({
            "name": name, "route": "cuda", "source": src + "pool.cu",
            "replaces": "jaderaytracerendering_tpu/" + replaces,
            "launches": launches8[name], "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "library_note": lib_note, "call_ms": v["call_ms"],
            "main_path_device_ms": tr8["wrappers"][name]["device_ms"],
            "main_path_launches": tr8["wrappers"][name]["launches"],
            "shape": main_shape + " (ms: device time of one call, CUDA events around calls "
                                  "queued behind a spin kernel; call_ms: CUDA events around "
                                  "a call from Python; main_path_*: over one pool render "
                                  "under torch.profiler)"})
    for k in kernels_out[1:]:
        k["oracle_rmse_rel"] = gate15["jade", "pool"]["rmse_rel"]
        k["oracle_rmse_rel_statue"] = gate15["statue", "pool"]["rmse_rel"]
        k["oracle_rmse_rel_refract"] = gate15["dir_refract", "pool"]["rmse_rel"]
        if k["name"] == "trace_segments":
            k["oracle_rmse_rel_scan"] = gate15["jade", "scan"]["rmse_rel"]
        if k["name"] in ("front_bounce", "resolve_bounce"):
            k["refract_max_abs_err"] = it10[k["name"]]["max_abs_err"]
            k["refract_ms"] = it10[k["name"]]["ms"]
    kernels_out.append({
        "name": "render_preview_mega", "route": "cuda", "source": src + "preview.cu",
        "replaces": "jaderaytracerendering_tpu/ops/pallas/mega.py:1895",
        "launches": launches13["render_preview_mega"], "max_abs_err": err11, "ms": ms11,
        "plain_ms": plain_ms11, "bound_ms": bound11[0], "bound_by": bound11[1],
        "library_ms": None, "library_note": lib_note,
        "shape": "jade 20k, 96x96, 4 spp, 2 bounces (ms: device time, CUDA events around "
                 "calls queued behind a spin kernel; plain_ms, max_abs_err, bound_ms)",
        "main_path_ms": frame_ms13, "main_path_max_abs_err": err13,
        "main_path_bound_ms": bound13[0], "main_path_bound_by": bound13[1],
        "main_path_frames_per_s": fps_steady13, "main_path_frames_per_s_traced": fps_traced13,
        "main_path_device_idle_share": idle13})
    kernels_out.append({
        "name": "postfx", "route": "cuda", "source": src + "postfx.cu",
        "replaces": "jaderaytracerendering_tpu/ops/pallas/postfx.py:22",
        "launches": launches13["postfx"], "max_abs_err": err12, "ms": ms12,
        "plain_ms": plain_ms12, "bound_ms": bound12[0], "bound_by": bound12[1],
        "library_ms": None, "library_note": lib_note, "call_ms": call_ms12,
        "banded_ms": banded_ms12, "cases_equal": n12,
        "main_path_display_max_abs_err": disp_err13,
        "shape": "1024x1024 film, aces, flipped (max_abs_err in u8 steps; ms: device time, "
                 "CUDA events around calls queued behind a spin kernel; call_ms: CUDA "
                 "events around a call from Python)"})
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
