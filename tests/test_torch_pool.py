"""Port parity: the pool engine (``render_film_pool``; on CPU tensors every
kernel wrapper runs its plain version) against the JAX package's
``pool.render_film_pool`` on the jade scene (300 statue triangles, camera
r = 2, 8x8, 4 spp, depth 4), both scenes built with the NumPy SAH BVH so
that light order and RNG sites agree. JAX runs its XLA route
(``traversal='bvh'``) and its all-Pallas route (``traversal='sweep'``:
spawn, fused-sweep trace, front and resolve kernels in interpret mode),
at the port's ``pool_m`` = the JAX ``rays_per_launch``.

Tolerance: atol = 1e-4 * max|film|, rtol = 1e-3 (tests/test_pool.py:28-29;
the fused sweep also carries its bf16x3 error in t). Useful-ray totals of
the port's engines are exact and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.integrator import pool as jpool
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.integrator import mega as tmega
from jaderaytracerendering_tpu_torch.integrator import pool as tpool
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=8, height=8, spp=4, spp_batch=4, max_depth=4)


@pytest.fixture(scope="module")
def scenes():
    j = jdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    t = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    j.camera.r = t.camera.r = 2.0
    return (j, jassemble(j.objects, j.env_map, xp=jnp, bvh_backend="numpy"),
            t, tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu"))


def _close(want, got):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-3)


def _pair(scenes, traversal, lanes, **kw):
    j, sdj, t, st = scenes
    want = np.asarray(jpool.render_film_pool(
        sdj, j.camera, JConfig(**SIZE, **kw, traversal=traversal,
                               rays_per_launch=lanes)).mean())
    stats = {}
    film = tpool.render_film_pool(st, t.camera, TConfig(**SIZE, **kw), stats=stats,
                                  pool_m=lanes)
    assert film.count == SIZE["spp"] and film.accum.dtype == torch.float32
    return want, film, stats


@pytest.mark.parametrize("traversal,lanes", [("bvh", 64), ("sweep", 256)])
def test_pool_matches_jax_pool(scenes, traversal, lanes):
    kernels.reset_launches()
    want, film, stats = _pair(scenes, traversal, lanes)
    _close(want, film.mean().numpy())
    assert set(kernels.LAUNCHES.values()) == {0}  # CPU: the plain versions
    assert stats["iterations"] > SIZE["max_depth"]


def test_pool_spawn_rounds_matches_jax(scenes):
    want, film, stats = _pair(scenes, "bvh", 64, spawn_rounds=2)
    _close(want, film.mean().numpy())


def test_pool_queue_runs_out_mid_round(scenes):
    """48 lanes do not divide the 256 samples: the last spawn takes a
    partial batch and the queue cut must match the JAX spawn."""
    want, film, stats = _pair(scenes, "bvh", 48)
    _close(want, film.mean().numpy())


def test_pool_resume_equals_one_run(scenes):
    *_, t, st = scenes
    cfg = TConfig(**SIZE).replace(spp=2)
    f1 = tpool.render_film_pool(st, t.camera, cfg, pool_m=48)
    f2 = tpool.render_film_pool(st, t.camera, cfg, film=f1, pool_m=48)
    f4 = tpool.render_film_pool(st, t.camera, cfg.replace(spp=4), pool_m=48)
    assert f2.count == 4
    np.testing.assert_allclose(f2.mean().numpy(), f4.mean().numpy(), rtol=1e-5,
                               atol=1e-6 * float(f4.accum.abs().max()))


def test_pool_equals_scan_and_mega(scenes):
    """The same samples through three engines: equal films up to the sum
    order within a pixel, and equal useful-ray totals."""
    *_, t, st = scenes
    cfg = TConfig(**SIZE)
    s_pool, s_scan, s_mega = {}, {}, {}
    a = trender.render_film(st, t.camera, cfg.replace(engine="pool"), stats=s_pool)
    b = trender.render_film(st, t.camera, cfg.replace(engine="scan"), stats=s_scan)
    c = trender.render_film(st, t.camera, cfg.replace(engine="mega"), stats=s_mega)
    for other in (b, c):
        np.testing.assert_allclose(a.accum.numpy(), other.accum.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(other.accum.abs().max()))
    assert s_pool["rays"] == s_scan["rays"] == s_mega["rays"]


def test_pool_splits_spp_below_the_queue_limit(scenes, monkeypatch):
    """A queue holds fewer than 2^31 samples: spp is split into passes,
    each a queue of its own, and the film equals one pass."""
    *_, t, st = scenes
    cfg = TConfig(**SIZE)
    one = tpool.render_film_pool(st, t.camera, cfg, pool_m=64)
    calls = []
    real = tpool.PoolState.create

    def create(*a, **kw):
        calls.append(a[5])  # total
        return real(*a, **kw)

    monkeypatch.setattr(tpool.PoolState, "create", staticmethod(create))
    monkeypatch.setattr(tpool, "QUEUE_LIMIT", 2 * 64)
    two = tpool.render_film_pool(st, t.camera, cfg, pool_m=64)
    assert calls == [128, 128] and two.count == 4
    np.testing.assert_allclose(two.accum.numpy(), one.accum.numpy(), rtol=1e-5,
                               atol=1e-6 * float(one.accum.abs().max()))


@pytest.mark.parametrize("pix0,n_px", [(0, 16), (21, 19), (50, 14)],
                         ids=["first", "ragged", "last"])
def test_pool_window_equals_the_whole_film(scenes, pix0, n_px):
    """A pool queue over a pixel window (``render_window_pool``: the spawn
    maps slot -> pix0 + slot, the front and resolve read the lane's pixel
    and slot) equals the window's rows of the whole-film pool render and
    the megakernel's window; the window's useful rays equal the mega
    window's. Tolerance: the pool's film adds run in another order within
    a pixel (rtol 1e-5, atol 1e-6 x max)."""
    *_, t, st = scenes
    cfg = TConfig(**SIZE)
    whole = tpool.render_film_pool(st, t.camera, cfg, pool_m=48).accum.reshape(-1, 3)
    acc = torch.zeros((n_px, 3))
    rays, iters = tpool.render_window_pool(st, t.camera, cfg, acc, pix0, 0, cfg.spp, pool_m=48)
    acc_m = torch.zeros((n_px, 3))
    rays_m = tmega.render_window_mega(st, t.camera, cfg, acc_m, pix0, 0, cfg.spp)
    scale = float(whole.abs().max())
    for want in (whole[pix0:pix0 + n_px], acc_m):
        np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-5, atol=1e-6 * scale)
    assert rays == rays_m and iters > 0
