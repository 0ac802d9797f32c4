"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs. Marked ``cuda``; each test skips (with the
reason) where there is no CUDA device or no nvcc. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: BVH ids and t exact (the kernels' walk visits the plain
walk's nodes in its order with its arithmetic, built with --fmad=false);
the megakernel's useful rays exact and its radiance sums per pixel
within MEGA_RTOL * |plain| + MEGA_ATOL_FRAC * max|plain| (it composites
each path forward, the plain version folds the (dir, rate) stack
backward as the reference does: the same sum, rounded in another order,
on paths of three or more terms); a window's samples in one launch
and the same samples as 64-sample launches added in turn each within
the recursive-summation bound of their exact sum (two f32 sums of one
set of terms in two orders); radiance sums of the other kernels per
pixel atol = 1e-4 * max, rtol = 1e-3 (they match the plain versions to a
few ulps; the pool's film adds are float atomics, so its sums within a
pixel change order); lane integers and counters of one pool step exact,
its floats within 1e-5 of their max; display u8 exact (postfx built with
--fmad=false, powf as the plain version's); ``post/tonemap.finalize`` on
the card against its NumPy path (a CPU tensor's) byte for byte but where
the card's ``powf`` and NumPy's ``pow`` round a value x255 that lies
within a few ulps of a whole number to either side (one level apart,
~1 in 10^6 channels of an HDR film)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jaderaytracerendering_tpu_torch.core import camera as camera_mod
from jaderaytracerendering_tpu_torch.integrator import pool as tpool
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.ops import (bounce_front, bounce_resolve, kernels,
                                                 mega as megak, postfx, spawn_front, trace)
from jaderaytracerendering_tpu_torch.ops.lanes import (C_RAYS, F_DIR, F_L, F_LE0, F_SRC, F_T,
                                                       PoolState)
from jaderaytracerendering_tpu_torch.post import tonemap as ttm
from jaderaytracerendering_tpu_torch.scene.scene import assemble
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda

MEGA_RTOL, MEGA_ATOL_FRAC = 1e-5, 1e-6  # the JAX package's mega-vs-scan bound


@pytest.fixture(scope="module")
def jade_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        kernels.build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    ds = demo.jade_scene(n_buddha_tris=2000, env_shape=(32, 64))
    ds.camera.r = 2.0
    return ds, assemble(ds.objects, ds.env_map, device="cuda")


def _rays(sd, n_seg, n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-1.5, 1.5, (n_seg, 3, n)).astype(np.float32)
    d = (g.uniform(-0.6, 0.6, (n_seg, 3, n)).astype(np.float32) - o)
    ex = g.integers(-1, sd.n_triangles, (n_seg, n)).astype(np.int32)
    return (torch.tensor(a, device="cuda") for a in (o, d, ex))


def test_bvh_nearest_kernel_matches_plain(jade_cuda):
    """The BVH walk alone: trace_segments with one segment."""
    _, sd = jade_cuda
    o, d, ex = _rays(sd, 1, 8192, 0)
    tk, ik = trace.trace_segments(sd, o, d, ex)
    tp, ip = trace.trace_segments_plain(sd, o, d, ex)
    assert torch.equal(ik, ip) and torch.equal(tk, tp)


def test_trace_segments_kernel_matches_plain(jade_cuda):
    _, sd = jade_cuda
    o, d, ex = _rays(sd, 4, 4096, 1)
    before = kernels.LAUNCHES["trace_segments"]
    tk, ik = trace.trace_segments(sd, o, d, ex, anyhit_seg=2)
    assert kernels.LAUNCHES["trace_segments"] == before + 1
    tp, ip = trace.trace_segments_plain(sd, o, d, ex, anyhit_seg=2)
    assert torch.equal(tk < kernels.INF, tp < kernels.INF)
    near = [0, 1, 3]  # segment 2 is any-hit: its hit flag only
    assert torch.equal(ik[near], ip[near]) and torch.equal(tk[near], tp[near])


def test_cuda_scene_without_packed_tables_is_refused(jade_cuda):
    ds, sd = jade_cuda
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    o, d, ex = _rays(sd, 1, 64, 6)
    for k in ("bvh_nodes", "tri_packed"):
        bare = dataclasses.replace(sd, **{k: None})
        with pytest.raises(ValueError, match="packed walk tables"):
            trace.trace_segments(bare, o, d, ex)
        with pytest.raises(ValueError, match="packed walk tables"):
            megak.mega_render(bare, eye, rot, RenderConfig(width=8, height=8), 0, 1)


def _mega_close(k, p):
    """The megakernel's [4, npix] against the plain version's."""
    assert torch.equal(k[3], p[3])
    torch.testing.assert_close(k[:3], p[:3], rtol=MEGA_RTOL,
                               atol=MEGA_ATOL_FRAC * float(p[:3].abs().max()))


@pytest.fixture(scope="module")
def pool_state(jade_cuda):
    """A pool state on the card after three iterations (live paths,
    fresh lanes and a partly drained queue)."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    st = PoolState.create(sd, cfg, eye, rot, 1024, 32 * 32 * 4, 0)
    tpool.run_pool(st, max_iters=3)
    return st


def _same_state(k, p):
    """Lane ints and counters equal; each 3-row group of the lane floats
    (src, dir, T, L, le0) within 1e-5 of its own max; the film per pixel."""
    assert torch.equal(k.is_, p.is_) and torch.equal(k.cnt, p.cnt)
    for r in (F_SRC, F_DIR, F_T, F_L, F_LE0):
        a, b = k.fs[r:r + 3], p.fs[r:r + 3]
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(float(b.abs().max()), 1e-30))
    torch.testing.assert_close(k.film, p.film, rtol=1e-5,
                               atol=1e-5 * max(float(p.film.abs().max()), 1e-30))


def test_front_bounce_kernel_matches_plain(pool_state):
    o, d, x = bounce_front.front_bounce(pool_state)
    op, dp, xp = bounce_front.front_bounce_plain(pool_state)
    assert torch.equal(x, xp)
    torch.testing.assert_close(o, op, rtol=0, atol=1e-6)
    torch.testing.assert_close(d, dp, rtol=0, atol=1e-6)


def test_resolve_bounce_kernel_matches_plain(pool_state):
    o, d, x = bounce_front.front_bounce(pool_state)
    bt, bi = trace.trace_segments(pool_state.sd, o, d, x, pool_state.sd.n_emit)
    k, p = pool_state.clone(), pool_state.clone()
    bounce_resolve.resolve_bounce(k, bt, bi)
    bounce_resolve.resolve_bounce_plain(p, bt, bi)
    _same_state(k, p)


def test_spawn_primary_kernel_matches_plain(pool_state):
    k, p = pool_state.clone(), pool_state.clone()
    k.is_[0, ::3] = 0  # free a third of the lanes
    p.is_[0, ::3] = 0
    aux_k = torch.empty((8, k.m), device="cuda")
    aux_p = torch.empty_like(aux_k)
    spawn_front.spawn_primary(k, aux_k)
    spawn_front.spawn_primary_plain(p, aux_p)
    assert torch.equal(aux_k[7], aux_p[7]) and bool((aux_k[7] != 0).any())
    _same_state(k, p)
    got = aux_p[7] != 0
    torch.testing.assert_close(aux_k[:3, got], aux_p[:3, got], rtol=0, atol=1e-6)


@pytest.mark.parametrize("m,share,queue", [
    pytest.param(4096, 0.05, "plenty", id="sparse"),
    pytest.param(4096, 1.0, "plenty", id="dense"),
    pytest.param(4096, 0.5, 1000, id="queue_out_in_a_tile"),
    pytest.param(1000, 0.5, "half", id="m_not_a_multiple_of_the_tile"),
])
def test_spawn_kernel_matches_plain_over_two_rounds(jade_cuda, m, share, queue):
    """Two spawn rounds back to back (the scan's scratch carried from one
    to the next) against the plain spawn: fresh lanes scattered (5%) or
    all fresh, the queue running out at lane 1000 (inside a tile) or
    halfway through the fresh lanes, M = 1000 (a partial last tile)."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=64, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    total = 32 * 32 * 64
    g = np.random.default_rng(7)
    fresh = g.uniform(size=m) < share
    st = PoolState.create(sd, cfg, eye, rot, m, total, 0)
    st.is_[0] = torch.tensor((~fresh).astype(np.int32), device="cuda")
    for row in (3, 4, 5):  # slot, pix, smp of the live lanes
        st.is_[row] = torch.tensor(g.integers(0, 32 * 32, m).astype(np.int32), device="cuda")
    if queue == "plenty":
        st.cnt[0] = 5
    elif queue == "half":
        st.cnt[0] = total - int(fresh.sum()) // 2
    else:
        st.cnt[0] = total - int(fresh[:queue].sum())
    k, p = st.clone(), st.clone()
    for _ in range(2):
        aux_k = torch.empty((8, m), device="cuda")
        aux_p = torch.empty_like(aux_k)
        before = kernels.LAUNCHES["spawn_primary"]
        spawn_front.spawn_primary(k, aux_k)
        assert kernels.LAUNCHES["spawn_primary"] == before + 1
        spawn_front.spawn_primary_plain(p, aux_p)
        assert torch.equal(aux_k[7], aux_p[7])
        _same_state(k, p)
        got = aux_p[7] != 0
        torch.testing.assert_close(aux_k[:3, got], aux_p[:3, got], rtol=0, atol=1e-6)
    assert int(k.cnt[0]) == (total if queue != "plenty" else 5 + int(k.cnt[2]))


def test_render_film_pool_on_cuda_uses_the_kernels(jade_cuda):
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=3, max_depth=5)
    kernels.reset_launches()
    s_k, s_p = {}, {}
    k = tpool.render_film_pool(sd, ds.camera, cfg, stats=s_k, pool_m=700)
    assert min(kernels.LAUNCHES[n] for n in ("spawn_primary", "trace_segments",
                                              "front_bounce", "resolve_bounce")) > 0
    assert kernels.LAUNCHES["mega_render"] == 0
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    p = PoolState.create(sd, cfg, eye, rot, 700, 32 * 32 * 3, 0)
    iters = tpool.run_pool(p, tpool.PLAIN)
    assert s_k == {"rays": float(p.cnt[C_RAYS]), "iterations": iters} and k.count == 3
    plain = p.film.reshape(k.accum.shape)
    torch.testing.assert_close(k.accum, plain, rtol=1e-3,
                               atol=1e-4 * float(plain.abs().max()))


def test_scan_engine_on_cuda_uses_the_trace_kernel(jade_cuda):
    """The scan engine's ray queries go through the trace kernel on the
    card (before the pool port they ran the plain torch walk there)."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=4, engine="scan")
    kernels.reset_launches()
    s_k, s_m = {}, {}
    film = trender.render_film(sd, ds.camera, cfg, stats=s_k)
    assert kernels.LAUNCHES["trace_segments"] > 0
    mega = trender.render_film(sd, ds.camera, cfg.replace(engine="mega"), stats=s_m)
    assert s_k["rays"] == s_m["rays"]
    torch.testing.assert_close(film.accum, mega.accum, rtol=1e-3,
                               atol=1e-4 * float(mega.accum.abs().max()))


def test_mega_render_kernel_matches_plain(jade_cuda):
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    before = kernels.LAUNCHES["mega_render"]
    k = megak.mega_render(sd, eye, rot, cfg, 3, cfg.spp)
    assert kernels.LAUNCHES["mega_render"] == before + 1
    p = megak.mega_render_plain(sd, eye, rot, cfg, 3, cfg.spp)
    torch.cuda.synchronize()
    _mega_close(k, p)


def test_mega_render_matches_plain_over_several_grid_passes(jade_cuda):
    """A film of more pixels than the persistent grid holds threads (at
    most 2048 a multiprocessor), so its warps take items again and again."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=640, height=480, spp=1, max_depth=4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cfg.width * cfg.height > sms * 2048
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    k = megak.mega_render(sd, eye, rot, cfg, 2, cfg.spp)
    p = megak.mega_render_plain(sd, eye, rot, cfg, 2, cfg.spp)
    _mega_close(k, p)


def test_mega_render_matches_plain_at_another_bvh_depth(jade_cuda):
    """Jade with 100k statue triangles: a deeper tree, so a taller stack."""
    ds, sd2k = jade_cuda
    big = demo.jade_scene(n_buddha_tris=100_000, env_shape=(32, 64))
    big.camera.r = 2.0
    sd = assemble(big.objects, big.env_map, device="cuda")
    assert sd.bvh_depth > sd2k.bvh_depth
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=5)
    eye, rot = camera_mod.camera_tensors(big.camera, "cuda")
    k = megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp)
    p = megak.mega_render_plain(sd, eye, rot, cfg, 0, cfg.spp)
    _mega_close(k, p)


def test_render_film_mega_on_cuda_uses_the_kernel(jade_cuda):
    """One launch for the film's 3 samples: ``mega_spp_batch`` is not read."""
    ds, sd = jade_cuda
    kernels.reset_launches()
    stats = {}
    film = trender.render_film(sd, ds.camera,
                               RenderConfig(width=16, height=16, spp=3,
                                            mega_spp_batch=2), stats=stats)
    assert kernels.LAUNCHES["mega_render"] == 1 and film.count == 3
    assert bool(torch.isfinite(film.accum).all()) and stats["rays"] > 0


@pytest.fixture(scope="module")
def glass_cuda(jade_cuda):
    """The jade scene with the statue made DIR_REFRACT (index 1.5, rate 0.9)."""
    import dataclasses

    from jaderaytracerendering_tpu_torch.scene import material

    ds = demo.jade_scene(n_buddha_tris=2000, env_shape=(32, 64))
    ds.camera.r = 2.0
    glass = dataclasses.replace(ds.objects[0].material, refract_mode=material.DIR_REFRACT,
                                refract_index=1.5, refract_rate=(0.9, 0.9, 0.9))
    ds.objects[0] = dataclasses.replace(ds.objects[0], material=glass)
    sd = assemble(ds.objects, ds.env_map, device="cuda")
    assert sd.has_refract
    return ds, sd


def test_mega_render_refract_kernel_matches_plain(glass_cuda):
    ds, sd = glass_cuda
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5, max_refract_bounces=16)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    before = kernels.LAUNCHES["mega_render"]
    k = megak.mega_render(sd, eye, rot, cfg, 1, cfg.spp)
    assert kernels.LAUNCHES["mega_render"] == before + 1
    p = megak.mega_render_plain(sd, eye, rot, cfg, 1, cfg.spp)
    torch.cuda.synchronize()
    _mega_close(k, p)


def test_pool_refract_kernels_match_plain(glass_cuda):
    """One pool iteration on a refraction scene: the front kernel's segments
    and march rows, then the resolve kernel, against the plain versions."""
    ds, sd = glass_cuda
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=5, max_refract_bounces=16)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    st = PoolState.create(sd, cfg, eye, rot, 1024, 32 * 32 * 4, 0)
    tpool.run_pool(st, max_iters=3)
    o, d, x = bounce_front.front_bounce(st)
    rf, ri = st.rf.clone(), st.ri.clone()
    assert bool((ri[1] != 0).any())  # some lanes take direct refraction
    op, dp, xp = bounce_front.front_bounce_plain(st)
    assert torch.equal(x, xp) and torch.equal(ri, st.ri)
    torch.testing.assert_close(o, op, rtol=0, atol=1e-5 * float(op.abs().max()))
    torch.testing.assert_close(d, dp, rtol=0, atol=1e-5 * float(dp.abs().max()))
    torch.testing.assert_close(rf, st.rf, rtol=0, atol=1e-5 * float(st.rf.abs().max()))
    bt, bi = trace.trace_segments(sd, o, d, x, sd.n_emit)
    k, p = st.clone(), st.clone()
    bounce_resolve.resolve_bounce(k, bt, bi)
    bounce_resolve.resolve_bounce_plain(p, bt, bi)
    _same_state(k, p)


def test_refract_pool_equals_mega_on_cuda(glass_cuda):
    ds, sd = glass_cuda
    cfg = RenderConfig(width=32, height=32, spp=3, max_depth=5, max_refract_bounces=16)
    s_p, s_m = {}, {}
    a = tpool.render_film_pool(sd, ds.camera, cfg, stats=s_p, pool_m=700)
    b = trender.render_film(sd, ds.camera, cfg, stats=s_m)
    assert s_p["rays"] == s_m["rays"]
    torch.testing.assert_close(a.accum, b.accum, rtol=1e-3,
                               atol=1e-4 * float(b.accum.abs().max()))


def test_preview_kernel_matches_plain(jade_cuda):
    """The preview kernel adds its sums into the band it is given, bit for
    bit as the plain version does, over the whole film and a window."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=2, integrator="preview")
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    g = np.random.default_rng(5)
    for p0, n_px in ((0, 32 * 32), (256, 300)):
        base = torch.tensor(g.uniform(0, 2, (n_px, 3)).astype(np.float32), device="cuda")
        before = kernels.LAUNCHES["render_preview_mega"]
        band = base.clone()
        assert megak.render_preview_mega(sd, eye, rot, cfg, 5, cfg.spp, band, p0) is band
        assert kernels.LAUNCHES["render_preview_mega"] == before + 1
        p = megak.render_preview_mega_plain(sd, eye, rot, cfg, 5, cfg.spp, base.clone(), p0)
        torch.cuda.synchronize()
        assert torch.equal(band, p) and not torch.equal(band, base)


@pytest.mark.parametrize("width,height,spp,p0,n_px", [
    pytest.param(640, 480, 1, 0, 640 * 480, id="several_block_waves"),
    pytest.param(32, 32, 3, 0, 32 * 32, id="spp_3"),
    pytest.param(32, 32, 2, 101, 333, id="odd_window"),
])
def test_preview_kernel_matches_plain_bit_for_bit(jade_cuda, width, height, spp, p0, n_px):
    """A window of more pixels than the card runs threads at once (640x480:
    blocks run in several waves), several samples a pixel summed in order
    (spp 3), a window that is not a multiple of the block at an odd
    offset; each added into a band of ones."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=width, height=height, spp=spp, integrator="preview")
    if n_px == width * height > 1024:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert n_px > sms * 2048
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    p = megak.render_preview_mega_plain(sd, eye, rot, cfg, 2, spp,
                                        torch.ones((n_px, 3), device="cuda"), p0)
    k = megak.render_preview_mega(sd, eye, rot, cfg, 2, spp,
                                  torch.ones((n_px, 3), device="cuda"), p0)
    assert torch.equal(k, p)


def test_preview_banded_rotation_on_cuda(jade_cuda):
    """Four banded frames through the preview kernel equal one full frame
    through it, bit for bit; each frame's display is one postfx launch."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=1, integrator="preview", preview_bands=4)
    full = trender.render_film_preview(sd, ds.camera, cfg.replace(preview_bands=1))
    kernels.reset_launches()
    film = disp = None
    for f in range(4):
        film, disp = trender.render_film_preview(sd, ds.camera, cfg, film=film, display=True,
                                                 frame_idx=f)
    assert kernels.LAUNCHES["render_preview_mega"] == 4
    assert kernels.LAUNCHES["postfx"] == 4  # one a frame, two counts or one
    assert torch.equal(film.accum, full.accum) and disp.dtype == torch.uint8


def _film_view(g, h, w, offset):
    """A contiguous [h, w, 3] float32 view ``offset`` floats into a larger
    buffer: its data pointer is 16-byte aligned only at offset 0."""
    buf = torch.tensor(g.uniform(-1, 60, 3 * h * w + 4).astype(np.float32), device="cuda")
    return buf[offset:offset + 3 * h * w].view(h, w, 3)


@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
def test_postfx_kernel_matches_plain(jade_cuda, mode):
    """The postfx kernel equals its plain version byte for byte over both
    flips, ragged widths, odd spans, one and two counts, and films and
    displays whose data pointers are not aligned."""
    g = np.random.default_rng(3)
    for h, w in ((96, 80), (7, 1021), (5, 13)):
        n = h * w
        for offset in (0, 1, 2, 3):
            accum = _film_view(g, h, w, offset)
            assert (accum.data_ptr() % 16 == 0) == (offset == 0)
            for flip, span, split in ((False, None, None), (True, None, None),
                                      (True, (3, n - 5), None), (True, None, w + 3),
                                      (False, (w - 1, n - 2), 2 * w + 1), (True, (5, 9), 5)):
                out_k = torch.full((3 * n + 1,), 7, dtype=torch.uint8, device="cuda")
                out_p = out_k.clone()
                kw = dict(flip=flip, span=span, split=split, count_hi=None if split is None else 4)
                before = kernels.LAUNCHES["postfx"]
                postfx.postfx(accum, 7, mode, out=out_k[offset % 2:][:3 * n].view(h, w, 3), **kw)
                assert kernels.LAUNCHES["postfx"] == before + 1
                postfx.postfx_plain(accum, 7, mode, out=out_p[offset % 2:][:3 * n].view(h, w, 3),
                                    **kw)
                assert torch.equal(out_k, out_p), (h, w, offset, flip, span, split)


def test_banded_display_kernel_matches_plain(jade_cuda):
    """The banded display (one postfx launch: two spans, two counts) of
    each frame of a rotation against the plain postfx band by band."""
    g = np.random.default_rng(4)
    accum = torch.tensor(g.uniform(0, 9, (64, 48, 3)).astype(np.float32), device="cuda")
    band_px = 64 * 48 // 4
    for f in range(8):
        kernels.reset_launches()
        k = trender.display_banded(accum, f, 4, 2, "aces")
        assert kernels.LAUNCHES["postfx"] == 1
        p = torch.empty_like(k)
        for b in range(4):
            n = (f // 4 + int(b <= f % 4)) * 2
            postfx.postfx_plain(accum, n, "aces", flip=True,
                                span=(b * band_px, (b + 1) * band_px), out=p)
        assert torch.equal(k, p)


@pytest.fixture(scope="module")
def mean_film(jade_cuda):
    """A rendered 1024^2 film's mean on the card (HDR: the light and the
    sky), and a ragged 7 x 1021 one with the extremes, on the card."""
    ds, sd = jade_cuda
    film = trender.render_film(sd, ds.camera, RenderConfig(spp=4, max_depth=8))
    g = np.random.default_rng(6)
    ragged = (g.gamma(0.6, 2.0, (7, 1021, 3)) * g.choice([0.05, 1.0, 30.0], (7, 1021, 1)))
    ragged = ragged.astype(np.float32)
    ragged[0, :4] = [[0.0, 1e-8, 5000.0], [-1e-8, -0.5, -3e4], [1.0, 0.18, 1e6], [2.0, 7.3, 1e-4]]
    return {"film": film.mean(), "ragged": torch.tensor(ragged, device="cuda")}


def _equal_but_for_pow_rounding(got, want, mean, mode, g=2.2) -> int:
    """``got`` equals ``want`` byte for byte but at channels whose value
    x255 lies within 4 float32 ulps of a whole number (``mean``: the
    radiance in the images' row order), where the card's ``powf`` and
    NumPy's ``pow`` may round to either side: there one level apart.
    Returns the number of such channels."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    apart = diff != 0
    if apart.any():
        c = ttm.tonemap(np.asarray(mean, np.float32), mode)[apart].astype(np.float64)
        x = np.maximum(c, 0.0) ** np.float64(np.float32(1.0 / g)) * 255.0
        assert np.abs(diff[apart]).max() == 1
        near = np.abs(x - np.round(x)) <= 4 * 2.0 ** -23 * x
        assert near.all(), list(zip(x[~near][:4], want[apart][~near][:4], got[apart][~near][:4]))
    return int(apart.sum())


@pytest.mark.parametrize("which", ["film", "ragged"])
@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
def test_finalize_on_card_equals_numpy(mean_film, which, mode):
    """The card path, from the client's flipped host view and from the
    CUDA film with ``flip``, gives the NumPy path's bytes but where the
    two ``pow`` round a value apart (``_equal_but_for_pow_rounding``);
    both card routes give the same bytes."""
    mean = mean_film[which]
    rad = mean.cpu().numpy()
    want = ttm.finalize(torch.from_numpy(rad), mode, flip=True)  # a CPU tensor: NumPy
    assert 0 < int((want > 0).sum()) and int((want == 255).sum()) > 0
    kernels.reset_launches()
    from_host = ttm.finalize(rad[::-1], mode)
    from_card = ttm.finalize(mean, mode, flip=True)
    assert kernels.LAUNCHES["postfx"] == 2
    np.testing.assert_array_equal(from_host, from_card)
    apart = _equal_but_for_pow_rounding(from_card, want, rad[::-1], mode)
    assert apart <= 1e-5 * want.size, apart


def test_finalize_on_card_returns_arrays_of_their_own(mean_film):
    """Two calls in a row on one shape: the first image is its own array
    and the second call leaves it as it was."""
    mean = mean_film["film"]
    for a, b in (((mean * 0.5).cpu().numpy()[::-1], mean.cpu().numpy()[::-1]),
                 (mean * 0.5, mean)):
        first = ttm.finalize(a)
        kept = first.copy()
        second = ttm.finalize(b)
        assert not np.shares_memory(first, second)
        np.testing.assert_array_equal(first, kept)
        assert (first != second).any()


def test_finalize_on_card_counts_one_launch_and_one_card_image(mean_film):
    """Under the profiler each image finished on the card is one postfx
    launch, one ``post.tonemap.card_images`` and one span."""
    mean = mean_film["ragged"]
    tlog.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.reset_launches()
        for i, rad in enumerate((mean.cpu().numpy()[::-1], mean, mean.cpu().numpy())):
            ttm.finalize(rad, flip=i == 1)
            assert kernels.LAUNCHES["postfx"] == i + 1
            assert tlog.counters()["post.tonemap.card_images"] == i + 1
        names = [s.name for s in tlog.spans()]
    tlog.reset()
    assert names == ["post.tonemap.finalize", "ops.postfx.postfx"] * 3


@pytest.mark.parametrize("shape", [(16, 3), (4, 5, 4), (2, 4, 5, 3)])
def test_finalize_on_card_refuses_a_shape_not_hw3(jade_cuda, shape):
    """A CUDA tensor, or a host array in a process with a card, whose shape
    is not [H, W, 3] is refused by postfx, not finished in NumPy."""
    rad = torch.rand(shape, device="cuda")
    kernels.reset_launches()
    for x in (rad, rad.cpu().numpy()):
        with pytest.raises(ValueError):
            ttm.finalize(x)
    assert kernels.LAUNCHES["postfx"] == 0


def test_native_jade_scene_renders_through_the_megakernel(jade_cuda):
    """The render CLI's default scene build (the native SAH builder) on the
    jade 20k scene, rendered by the megakernel against its plain version."""
    ds = demo.jade_scene(n_buddha_tris=20_000, env_shape=(32, 64))
    sd = assemble(ds.objects, ds.env_map, bvh_backend="native", device="cuda")
    assert sd.bvh_builder == "native"
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    before = kernels.LAUNCHES["mega_render"]
    k = megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp)
    assert kernels.LAUNCHES["mega_render"] == before + 1
    p = megak.mega_render_plain(sd, eye, rot, cfg, 0, cfg.spp)
    torch.cuda.synchronize()
    _mega_close(k, p)


# pixel windows of a 64x48 film (3072 pixels): the first, one that starts
# off a 128-thread block edge, the last and shorter one
WINDOWS = [(0, 1024), (1111, 1024), (2135, 937)]


def test_mega_windows_are_bit_equal_to_the_whole_film(jade_cuda):
    """The megakernel over a pixel window (counter slots, pix = pix0 +
    slot, output by slot) renders the whole film's columns bit for bit,
    useful rays included, over several grid passes of one window."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=3, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cpu")
    whole = megak.mega_render(sd, eye, rot, cfg, 2, cfg.spp)
    for pix0, n_px in WINDOWS + [(5, 1), (3071, 1)]:
        win = megak.mega_render(sd, eye, rot, cfg, 2, cfg.spp, pix0, n_px)
        assert win.shape == (4, n_px)
        assert torch.equal(win, whole[:, pix0:pix0 + n_px]), (pix0, n_px)
    big = RenderConfig(width=640, height=480, spp=1, max_depth=3)
    whole = megak.mega_render(sd, eye, rot, big, 0, 1)
    win = megak.mega_render(sd, eye, rot, big, 0, 1, 1001, 300_000)
    assert torch.equal(win, whole[:, 1001:301_001])


@pytest.mark.parametrize("spp", [8, 7])
def test_mega_call_split_into_launches_is_bit_equal(jade_cuda, monkeypatch, spp):
    """A call of more items than MAX_ITEMS splits into launches of whole
    slots (each writes ``out`` from its first slot at the window's row
    stride, with a counter of its own and the one scratch): film and
    useful rays equal one launch's bit for bit, over the whole film and a
    window; each launch counts one megakernel, one fold and one stamp."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=spp, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cpu")
    whole = megak.mega_render(sd, eye, rot, cfg, 3, spp)
    monkeypatch.setattr(megak, "MAX_ITEMS", 4096)
    for pix0, n_px in ((0, 64 * 48), (1001, 1500)):
        wins = megak.launch_windows(n_px, spp)
        assert len(wins) > 2
        kernels.reset_launches()
        stamps = []
        split = megak.mega_render(sd, eye, rot, cfg, 3, spp, pix0, n_px, stamps=stamps)
        assert kernels.LAUNCHES["mega_render"] == kernels.LAUNCHES["mega_fold"] == len(wins)
        assert len(stamps) == len(wins)
        assert torch.equal(split, whole[:, pix0:pix0 + n_px]), (pix0, n_px)


@pytest.mark.parametrize("spp", [8, 7])
def test_mega_launch_is_the_ascending_fold_of_its_samples(jade_cuda, spp):
    """One launch of ``spp`` samples equals, bit for bit, the ascending f32
    sum from zero of launches of one sample at sample_base + j, each one
    item a pixel; useful rays equal. So the fold adds each pixel's samples
    in sample order."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=48, height=40, spp=spp, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cpu")
    whole = megak.mega_render(sd, eye, rot, cfg, 5, spp)
    acc = torch.zeros((3, 48 * 40), device="cuda")
    rays = torch.zeros(48 * 40, device="cuda")
    for j in range(spp):
        part = megak.mega_render(sd, eye, rot, cfg, 5 + j, 1)
        acc = acc + part[:3]
        rays = rays + part[3]
    assert torch.equal(whole[:3], acc) and torch.equal(whole[3], rays)


def test_mega_launches_of_the_same_arguments_are_bit_equal(jade_cuda):
    """Lanes take items in another order each launch; the film does not
    follow them."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=16, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cpu")
    a = megak.mega_render(sd, eye, rot, cfg, 1, cfg.spp)
    b = megak.mega_render(sd, eye, rot, cfg, 1, cfg.spp)
    assert torch.equal(a, b)


def test_statue_heavy_mega_windows_are_bit_equal_to_the_whole_film(jade_cuda):
    """The jade statue close up (orbit r 1.2) at 64 spp, where a few
    pixels' samples take most of a launch: each window renders the whole
    film's columns bit for bit."""
    ds, sd = jade_cuda
    cam = dataclasses.replace(ds.camera, r=1.2)
    cfg = RenderConfig(width=64, height=48, spp=64, max_depth=5)
    eye, rot = camera_mod.camera_tensors(cam, "cpu")
    whole = megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp)
    for pix0, n_px in WINDOWS + [(1500, 1)]:
        win = megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp, pix0, n_px)
        assert torch.equal(win, whole[:, pix0:pix0 + n_px]), (pix0, n_px)


def test_mega_stamps_count_the_launch_and_its_tail(jade_cuda):
    """Under the recorder each image's launches add their time and their
    tail (from the first handout that found the counter dry) in us:
    0 < tail <= launch. Without it nothing is counted."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=128, max_depth=5)
    tlog.reset()
    trender.render_film(sd, ds.camera, cfg)
    assert "ops.mega.launch_us" not in tlog.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.reset_launches()
        trender.render_film(sd, ds.camera, cfg)
        got = dict(tlog.counters())
    tlog.reset()
    assert kernels.LAUNCHES["mega_render"] == kernels.LAUNCHES["mega_fold"] == 1
    assert got["ops.mega.launches"] == 1
    assert 0 < got["ops.mega.tail_us"] <= got["ops.mega.launch_us"]


def _closeup_camera():
    """The framing of the benchmark's close-up configuration."""
    import json
    import pathlib

    f = pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "configs"
    c = json.loads((f / "jade_offline_closeup.json").read_text())["camera"]
    return camera_mod.OrbitCamera(up_angle=c["up_deg"], rotate_angle=c["rotate_deg"], r=c["r"],
                                  eye_center=np.asarray(c["center"], np.float64))


@pytest.mark.parametrize("glass", [None, "floor", "buddha"],
                         ids=["HR-false", "HR-true", "statue-refract"])
def test_mega_bounce_counts_equal_the_plain_paths(jade_cuda, glass):
    """At the close-up framing of a 2,000-triangle statue, the kernel's
    stamps count as many bounces, SSS bounces, direct refraction bounces
    and march steps as the plain version resolves. HR-false: the jade
    scene, whose ``<false>`` instance leaves the last two words at 0;
    HR-true: the floor made DIR_REFRACT, the statue still jade;
    statue-refract: the statue made DIR_REFRACT, its other fields the
    jade's (the benchmark's refracting statue)."""
    from jaderaytracerendering_tpu_torch.scene import material

    ds = demo.jade_scene(n_buddha_tris=2000, env_shape=(32, 64))
    if glass is not None:
        i = next(i for i, o in enumerate(ds.objects) if o.name == glass)
        fields = {"refract_index": 1.5, "refract_rate": (0.9, 0.9, 0.9)} if glass == "floor" else {}
        mat = dataclasses.replace(ds.objects[i].material, refract_mode=material.DIR_REFRACT,
                                  **fields)
        ds.objects[i] = dataclasses.replace(ds.objects[i], material=mat)
    sd = assemble(ds.objects, ds.env_map, device="cuda")
    assert sd.has_refract == (glass is not None)
    # the plain version's ops under the profiler are the test's cost: the
    # refracting statue marches on most paths, so its paths are cut shorter
    cfg = RenderConfig(width=48, height=48, spp=4, max_depth=4 if glass == "buddha" else 8,
                       max_refract_bounces=16)
    eye, rot = camera_mod.camera_tensors(_closeup_camera(), "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        tlog.reset()
        stamps = []
        k = megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp, stamps=stamps)
        megak.count_stamps(stamps)
        got_k = dict(tlog.counters())
        tlog.reset()
        p = megak.mega_render_plain(sd, eye.cuda(), rot.cuda(), cfg, 0, cfg.spp)
        got_p = dict(tlog.counters())
    tlog.reset()
    for name in ("bounces", "sss_bounces", "refract_bounces", "march_steps"):
        assert got_k[f"ops.mega.{name}"] == got_p[f"ops.mega.{name}"], name
    assert got_k["ops.mega.bounces"] > 0
    assert (got_k["ops.mega.sss_bounces"] > 0) == (glass != "buddha")
    refract, steps = got_k["ops.mega.refract_bounces"], got_k["ops.mega.march_steps"]
    if glass is None:
        assert all(int(st[5]) == int(st[6]) == 0 for st in stamps)
    if glass == "buddha":
        assert 0 < refract <= steps <= cfg.max_refract_bounces * refract
    assert refract <= steps <= cfg.max_refract_bounces * refract
    assert torch.equal(k[3], p[3])  # the useful rays: 1 + (E + 2) a bounce


def _mega_window(sd, cam, cfg, pix0, n_px, sample_base, spp):
    """``render_window_mega`` into a fresh window -> (sums [n_px, 3], rays)."""
    from jaderaytracerendering_tpu_torch.integrator import mega as tmega

    acc = torch.zeros((n_px, 3), device="cuda")
    return acc, tmega.render_window_mega(sd, cam, cfg, acc, pix0, sample_base, spp)


def _calls_of_64(sd, cam, cfg, pix0, n_px, sample_base, spp):
    """The window as calls of 64 samples added in turn (the plan of the
    engine while it read ``mega_spp_batch`` = 64) -> (sums, rays)."""
    eye, rot = camera_mod.camera_tensors(cam, "cpu")
    acc = torch.zeros((n_px, 3), device="cuda")
    rays = torch.zeros((), dtype=torch.float64, device="cuda")
    for done in range(0, spp, 64):
        out = megak.mega_render(sd, eye, rot, cfg, sample_base + done, min(64, spp - done),
                                pix0, n_px)
        acc += out[0:3].T
        rays += out[3].sum(dtype=torch.float64)
    return acc, float(rays)


@pytest.mark.parametrize("pix0,n_px", [(0, 64 * 48), (1001, 1500)])
def test_a_256_spp_window_split_by_pixels_is_bit_equal(jade_cuda, monkeypatch, pix0, n_px):
    """A window's 256 samples in one launch, or split into pixel windows
    (MAX_ITEMS set to 700 pixels' items): sums and useful rays bit for
    bit, since a pixel's sum depends on spp alone (so a mesh's tiles
    render the one-card film)."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=256, max_depth=5)
    kernels.reset_launches()
    one, rays_one = _mega_window(sd, ds.camera, cfg, pix0, n_px, 9, 256)
    assert kernels.LAUNCHES["mega_render"] == 1
    monkeypatch.setattr(megak, "MAX_ITEMS", 700 * 256)
    kernels.reset_launches()
    split, rays_split = _mega_window(sd, ds.camera, cfg, pix0, n_px, 9, 256)
    assert kernels.LAUNCHES["mega_render"] == len(megak.launch_windows(n_px, 256)) > 1
    assert rays_split == rays_one
    assert torch.equal(split, one)


def test_a_256_spp_window_is_four_64_spp_calls_within_rounding(jade_cuda):
    """One ascending sum of a window's 256 samples against four 64-sample
    sums added in turn: useful rays exact, and the same samples summed in
    another order. Each sample's value is a one-sample launch's: the
    window is their ascending f32 fold bit for bit, and each of the two
    sums lies within the recursive-summation bound gamma_k x sum|x| of
    their exact (float64) sum, k the most adds on one sample's way into
    the sum (255 for one sum, 63 + 3 for four), u = 2^-24. A relative
    bound such as 1e-6 does not hold: the sums of a few pixels whose 256
    samples are near equal round the same way at each add (up to 1.8e-6
    of the sum apart on an H100)."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=256, max_depth=5)
    one, rays_one = _mega_window(sd, ds.camera, cfg, 0, 64 * 48, 3, 256)
    four, rays_four = _calls_of_64(sd, ds.camera, cfg, 0, 64 * 48, 3, 256)
    assert rays_one == rays_four
    eye, rot = camera_mod.camera_tensors(ds.camera, "cpu")
    x = torch.stack([megak.mega_render(sd, eye, rot, cfg, 3 + j, 1)[0:3].T
                     for j in range(256)])
    fold = torch.zeros_like(one)
    for j in range(256):
        fold = fold + x[j]
    assert torch.equal(one, fold)
    exact, size = x.double().sum(0), x.double().abs().sum(0)

    def gamma(k):
        return k * 2.0 ** -24 / (1 - k * 2.0 ** -24)

    assert bool(((one.double() - exact).abs() <= gamma(255) * size).all())
    assert bool(((four.double() - exact).abs() <= gamma(66) * size).all())
    assert not torch.equal(one, four)  # the two plans are two sums


def test_a_64_spp_window_is_one_64_spp_call_bit_for_bit(jade_cuda):
    """At 64 samples the window is one call, as it was while the engine
    split by ``mega_spp_batch`` = 64: the film bit for bit, rays equal."""
    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=64, max_depth=5)
    for pix0, n_px in WINDOWS:
        one, rays_one = _mega_window(sd, ds.camera, cfg, pix0, n_px, 64, 64)
        old, rays_old = _calls_of_64(sd, ds.camera, cfg, pix0, n_px, 64, 64)
        assert rays_one == rays_old
        assert torch.equal(one, old), (pix0, n_px)


def test_pool_window_matches_the_mega_window(jade_cuda):
    """The pool's kernels over a pixel window (the spawn's pix = pix0 +
    slot; front, trace and resolve unchanged) against the megakernel's
    window: radiance within 1e-3 + 1e-4 x max, useful rays equal."""
    from jaderaytracerendering_tpu_torch.integrator import mega as tmega

    ds, sd = jade_cuda
    cfg = RenderConfig(width=64, height=48, spp=3, max_depth=5)
    for pix0, n_px in WINDOWS:
        kernels.reset_launches()
        acc_p = torch.zeros((n_px, 3), device="cuda")
        stats = {}
        rays_p = tpool.render_window_pool(sd, ds.camera, cfg, acc_p, pix0, 4, cfg.spp, stats,
                                          pool_m=700)
        assert stats["iterations"] > 0
        assert min(kernels.LAUNCHES[k] for k in ("spawn_primary", "trace_segments",
                                                 "front_bounce", "resolve_bounce")) > 0
        acc_m = torch.zeros((n_px, 3), device="cuda")
        rays_m = tmega.render_window_mega(sd, ds.camera, cfg, acc_m, pix0, 4, cfg.spp)
        assert rays_p == rays_m
        torch.testing.assert_close(acc_p, acc_m, rtol=1e-3,
                                   atol=1e-4 * float(acc_m.abs().max()))


@pytest.mark.parametrize("part", ["mega", "spawn"])
def test_rows_dealt_four_apart_are_bit_equal_to_the_whole_film(jade_cuda, part):
    """The windows of a --mesh 4x1's tile ranks (film rows t, t + 4, ..;
    row_step 4) at 64^2 x 16 spp on the statue view: the megakernel's sums
    and useful rays bit for bit the stride-1 whole film's dealt pixels;
    the pool's spawn over a dealt window's queue gives each of its samples
    the camera ray, hit, sky and lane state of the same (pixel, sample) in
    a stride-1 whole-film queue, and the windows together its useful rays
    and misses."""
    from jaderaytracerendering_tpu_torch.cli.rmse_gate import statue_view
    from jaderaytracerendering_tpu_torch.core.film import window_pixels
    from jaderaytracerendering_tpu_torch.ops.lanes import C_DONE, I_ACTIVE, I_HIT, I_PIX, I_SMP

    ds, sd = jade_cuda
    cam = dataclasses.replace(ds.camera)
    statue_view(cam)
    w, h, spp, step = 64, 64, 16, 4
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=5)
    if part == "mega":
        eye, rot = camera_mod.camera_tensors(cam, "cpu")
        whole = megak.mega_render(sd, eye, rot, cfg, 3, spp)
    else:
        eye, rot = camera_mod.camera_tensors(cam, "cuda")
        whole = PoolState.create(sd, cfg, eye, rot, w * h * spp, w * h * spp, 3)
        aux_whole = torch.empty((8, whole.m), device="cuda")
        spawn_front.spawn_primary(whole, aux_whole)
        rays = misses = 0
    for t in range(step):
        n_px = len(range(t, h, step)) * w
        ids = window_pixels(t * w, torch.arange(n_px, device="cuda"), step, w)
        if part == "mega":
            win = megak.mega_render(sd, eye, rot, cfg, 3, spp, t * w, n_px, row_step=step)
            assert torch.equal(win, whole[:, ids]), t
            continue
        st = PoolState.create(sd, cfg, eye, rot, n_px * spp, n_px * spp, 3, t * w, n_px, step)
        aux = torch.empty((8, st.m), device="cuda")
        spawn_front.spawn_primary(st, aux)
        lane = torch.arange(st.m, device="cuda")
        same = (lane // n_px) * (w * h) + ids[lane % n_px]  # its whole-film queue lane
        assert torch.equal(st.is_[I_PIX].long(), ids[lane % n_px]), t
        assert torch.equal(aux, aux_whole[:, same]), t
        for row in (I_ACTIVE, I_HIT, I_PIX, I_SMP):
            assert torch.equal(st.is_[row], whole.is_[row, same]), (t, row)
        assert torch.equal(st.fs, whole.fs[:, same]), t
        rays += int(st.cnt[C_RAYS])
        misses += int(st.cnt[C_DONE])
    if part == "spawn":
        assert (rays, misses) == (int(whole.cnt[C_RAYS]), int(whole.cnt[C_DONE]))
        assert 0 < misses < rays  # the view holds sky and the statue's hits


@pytest.mark.parametrize("mesh,engine", [("2x1", "mega"), ("1x2", "mega"), ("2x1", "pool")])
def test_two_ranks_on_one_card_over_gloo(jade_cuda, tmp_path, mesh, engine):
    """The render CLI with --mesh, its 2 ranks sharing card 0 over gloo,
    against the single-device CLI: a tile-only mega mesh bit for bit, the
    rest within rtol 1e-4 + atol 1e-5 x max (the spp split sums two
    halves; the pool's film adds run in another order); equal useful
    rays; every rank's film equal."""
    import json
    import os
    import subprocess
    import sys

    from jaderaytracerendering_tpu_torch.cli import render

    args = ["--tris", "2000", "--width", "64", "--height", "48", "--spp", "4",
            "--max-depth", "5", "--engine", engine]
    one, s_one = render.main(args + ["--out", str(tmp_path / "one.bmp")])
    code = ("import json, sys\n"
            "from jaderaytracerendering_tpu_torch.cli import render\n"
            "film, stats = render.main(sys.argv[1:])\n"
            "print('STATS ' + json.dumps(stats))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    repo = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code, *args, "--mesh", mesh, "--out",
                          str(tmp_path / "mesh.bmp"), "--save-film", str(tmp_path / "m.npz")],
                         cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    stats = json.loads([ln for ln in res.stdout.splitlines()
                        if ln.startswith("STATS ")][-1][len("STATS "):])
    assert [r["backend"] for r in stats["ranks"]] == ["gloo", "gloo"]
    assert len({r["film_sha256"] for r in stats["ranks"]}) == 1
    assert stats["rays"] == s_one["rays"]
    film = torch.from_numpy(np.load(tmp_path / "m.npz")["accum"])
    want = one.accum.cpu()
    if (mesh, engine) == ("2x1", "mega"):
        assert torch.equal(film, want)
    else:
        torch.testing.assert_close(film, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
