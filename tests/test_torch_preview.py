"""Port parity of the preview path: the plain preview integrator
(``trace_preview_p``) against the JAX package's on the same seeded rays,
``render_film_preview`` (engines ``scan`` and ``mega``; on CPU tensors the
preview kernel's wrapper runs its plain version) against the JAX
``render_film_preview(engine='scan', traversal='bvh')`` (the JAX mega
preview equals it, tests/test_mega.py:117-130), the banded frames (a
rotation equals one full frame bit for bit; a partial rotation's display
divides each band by its own count, tests/test_preview_bands.py), and the
u8 display against the JAX display.

Scene: jade, 300 statue triangles, camera r = 2, 16x16, both built with
the NumPy SAH BVH. Tolerances: radiance atol 1e-5 * max, rtol 1e-4 (torch
and XLA libm cos/sin/atan2 differ by an ulp, carried through two
bounces); display u8 within 1 (the port's postfx multiplies by 1/count
where the JAX display divides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core.vecmath import V3 as JV3
from jaderaytracerendering_tpu.integrator import preview as jpreview
from jaderaytracerendering_tpu.integrator import render as jrender
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.core import camera as tcamera
from jaderaytracerendering_tpu_torch.core.vecmath import V3
from jaderaytracerendering_tpu_torch.integrator import preview as tpreview
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.integrator import wavefront as twf
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels
from jaderaytracerendering_tpu_torch.ops import mega as tmega
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=16, height=16, spp=2, spp_batch=2, integrator="preview")


@pytest.fixture(scope="module")
def scenes():
    j = jdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    t = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    j.camera.r = t.camera.r = 2.0
    sdj = jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy")
    return j, sdj, t, tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")


@pytest.fixture(scope="module")
def jax_preview(scenes):
    j, sdj, _, _ = scenes
    cfg = JConfig(**SIZE, engine="scan", traversal="bvh")
    film, disp = jrender.render_film_preview(jax.tree.map(jnp.asarray, sdj), j.camera, cfg,
                                             display=True)
    return np.asarray(film.accum), np.asarray(disp)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("bounces", [1, 2, 3])
def test_trace_preview_matches_jax(scenes, bounces):
    _, sdj, _, st = scenes
    g = np.random.default_rng(bounces)
    m = 512
    o = g.uniform(-1.5, 1.5, (3, m)).astype(np.float32)
    o[2] = 2.5
    d = (g.uniform(-0.6, 0.6, (3, m)).astype(np.float32) - o).astype(np.float32)
    pix = g.integers(0, 256, m).astype(np.uint32)
    smp = g.integers(0, 8, m).astype(np.uint32)
    jcfg = JConfig(**SIZE, traversal="bvh", seed=2)
    want = jpreview.trace_preview_p(JV3(*o), JV3(*d), pix, smp, sdj, jcfg, np,
                                    jrender.make_nearest(sdj, jcfg, np), max_bounce=bounces)
    got = tpreview.trace_preview_p(
        V3(*torch.from_numpy(o)), V3(*torch.from_numpy(d)),
        torch.from_numpy(pix.astype(np.int64)), torch.from_numpy(smp.astype(np.int64)), st,
        TConfig(**SIZE, seed=2), twf.nearest_planes_plain, max_bounce=bounces)
    want = np.stack(want).astype(np.float32)
    assert (want > 0).any() and (want.max(0) > 10 * np.median(want.max(0))).any()
    _close(np.stack([v.numpy() for v in got]), want)


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_render_film_preview_matches_jax(scenes, jax_preview, engine):
    _, _, t, st = scenes
    kernels.reset_launches()
    film, disp = trender.render_film_preview(st, t.camera, TConfig(**SIZE, engine=engine),
                                             display=True)
    assert set(kernels.LAUNCHES.values()) == {0}  # CPU: the plain versions
    want, want_disp = jax_preview
    assert film.count == SIZE["spp"] and disp.dtype == torch.uint8
    _close(film.accum.numpy(), want)
    assert np.abs(disp.numpy().astype(int) - want_disp.astype(int)).max() <= 1


def test_render_film_routes_the_preview(scenes, jax_preview):
    _, _, t, st = scenes
    film = trender.render_film(st, t.camera, TConfig(**SIZE, engine="pool"))
    _close(film.accum.numpy(), jax_preview[0])


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_banded_rotation_equals_full_frame(scenes, engine):
    _, _, t, st = scenes
    cfg = TConfig(**SIZE, engine=engine, preview_bands=4)
    full, full_disp = trender.render_film_preview(st, t.camera, cfg.replace(preview_bands=1),
                                                  display=True)
    film = disp = None
    for f in range(4):
        film, disp = trender.render_film_preview(st, t.camera, cfg, film=film, display=True,
                                                 frame_idx=f)
    assert film.count == full.count
    np.testing.assert_array_equal(film.accum.numpy(), full.accum.numpy())
    np.testing.assert_array_equal(disp.numpy(), full_disp.numpy())


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_partial_rotation_display_counts(scenes, engine):
    """After the first two frames of a rotation, bands 0-1 hold 2 spp and
    bands 2-3 none; the display maps each by its own count, and it is
    flipped: band 0 (flat pixels 0..63) is the display's bottom rows."""
    _, _, t, st = scenes
    cfg = TConfig(**SIZE, engine=engine, preview_bands=4)
    film, disp = None, None
    for f in range(2):
        film, disp = trender.render_film_preview(st, t.camera, cfg, film=film, display=True,
                                                 frame_idx=f)
    a = film.accum.reshape(-1, 3).numpy()
    band_px = 16 * 16 // 4
    assert np.abs(a[2 * band_px:]).max() == 0.0 and np.abs(a[:2 * band_px]).sum() > 0
    d = disp.reshape(-1, 3).numpy()
    assert d[-2 * band_px:].sum() > 0 and d[:2 * band_px].max() == 0
    full = trender.display_frame(film.accum, film.count, cfg.tonemap)
    np.testing.assert_array_equal(disp.numpy(), full.numpy())  # one count: equal to one call
    # one more frame: band 2 gets its samples; bands 0-1 and 2 share a count
    film, disp = trender.render_film_preview(st, t.camera, cfg, film=film, display=True,
                                             frame_idx=2)
    d = disp.reshape(-1, 3).numpy()
    assert d[:band_px].max() == 0 and d[band_px:].sum() > 0


def test_banded_display_matches_jax(scenes):
    """One banded frame after a whole rotation (counts differ by band)
    against the JAX banded frame, u8 within 1."""
    j, sdj, t, st = scenes
    jcfg = JConfig(**SIZE, engine="scan", traversal="bvh", preview_bands=4)
    sdj = jax.tree.map(jnp.asarray, sdj)
    jf = tf = None
    for f in range(6):
        jf, jdisp = jrender.render_film_preview(sdj, j.camera, jcfg, film=jf, display=True,
                                                frame_idx=f)
        tf, tdisp = trender.render_film_preview(st, t.camera,
                                                TConfig(**SIZE, preview_bands=4), film=tf,
                                                display=True, frame_idx=f)
    assert int(jf.count) == tf.count == 4
    _close(tf.accum.numpy(), np.asarray(jf.accum))
    assert np.abs(tdisp.numpy().astype(int) - np.asarray(jdisp).astype(int)).max() <= 1


def test_banded_frame_adds_in_place_and_windows_agree(scenes):
    """A banded frame adds its band to the film passed in (no copy of the
    film); the preview kernel's wrapper (its plain version on CPU tensors)
    adds a window's sums into the band it is given, in place, and those
    sums equal the same rows of the whole film's (to the file's tolerance:
    the CPU's vector math rounds a lane by its place in the batch); a
    window past the film's end is refused."""
    _, _, t, st = scenes
    cfg = TConfig(**SIZE, engine="mega", preview_bands=4)
    film = trender.render_film_preview(st, t.camera, cfg.replace(preview_bands=1))
    before = film.accum.clone()
    film2, _ = trender.render_film_preview(st, t.camera, cfg, film=film, display=True,
                                           frame_idx=6)
    assert film2.accum.data_ptr() == film.accum.data_ptr()
    band = film.accum.reshape(-1, 3)[128:192] - before.reshape(-1, 3)[128:192]
    assert band.abs().sum() > 0 and torch.equal(film.accum.reshape(-1, 3)[:128],
                                                before.reshape(-1, 3)[:128])
    eye, rot = tcamera.camera_tensors(t.camera, "cpu")
    whole = tmega.render_preview_mega(st, eye, rot, cfg, 3, 2, torch.zeros((256, 3)))
    base = torch.full((37, 3), 0.5)
    band = base.clone()
    kernels.reset_launches()
    assert tmega.render_preview_mega(st, eye, rot, cfg, 3, 2, band, 100) is band
    assert kernels.LAUNCHES["render_preview_mega"] == 0  # CPU: the plain version
    _close((band - base).numpy(), whole[100:137].numpy())
    plain = tmega.render_preview_mega_plain(st, eye, rot, cfg, 3, 2, base.clone(), 100)
    assert torch.equal(plain, band)
    with pytest.raises(ValueError, match="outside"):
        tmega.render_preview_mega(st, eye, rot, cfg, 3, 2, torch.zeros((37, 3)), 250)
