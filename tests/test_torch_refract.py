"""Port parity of direct refraction (DIR_REFRACT): the plain torch march
against the JAX package's ``wavefront._refract_march``, and the port's
three engines (scan, pool through its plain route, mega through its
plain version; CPU tensors) against the JAX scan engine
(``render_film(engine='scan', traversal='bvh')``) on the jade scene with
the statue made DIR_REFRACT (index 1.5, rate 0.9; tests/test_integrator.py
:46-54), 200 statue triangles, 16x16, spp 2, depth 3,
``max_refract_bounces`` 8.

Tolerances: the films per pixel atol 1e-6 * max|film|, rtol 1e-5 (the
JAX package's own mega-vs-scan bound, tests/test_mega.py:102-103). The
march: its masks, triangle ids, exit directions and exit points exact
(every operation on them is an IEEE-rounded +, -, *, / or square root,
``vecmath.sqrt`` rounding correctly on every machine); its rates rtol
1e-5, atol 1e-5 * scale: each of the at most 8 steps multiplies by
``pow(rate, t)``, where torch's and NumPy's libm may differ by an ulp
(6e-8 relative), so a lane's rate differs by at most ~8 such ulps and a
few rounding ulps, under 1e-6 relative. Useful-ray totals of the port's
engines are exact and equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import rng as jrng
from jaderaytracerendering_tpu.core.vecmath import V3 as JV3
from jaderaytracerendering_tpu.integrator import render as jrender
from jaderaytracerendering_tpu.integrator import wavefront as jwf
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene import material as jmaterial
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.core import rng as trng
from jaderaytracerendering_tpu_torch.core.vecmath import V3
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.integrator import wavefront as twf
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels
from jaderaytracerendering_tpu_torch.scene import material as tmaterial
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=16, height=16, spp=2, spp_batch=2, max_depth=3,
            max_refract_bounces=8)


def _glass(ds, mat_mod):
    glass = dataclasses.replace(ds.objects[0].material, refract_mode=mat_mod.DIR_REFRACT,
                                refract_index=1.5, refract_rate=(0.9, 0.9, 0.9))
    ds.objects[0] = dataclasses.replace(ds.objects[0], material=glass)
    ds.camera.r = 2.0
    return ds


@pytest.fixture(scope="module")
def scenes():
    j = _glass(jdemo.jade_scene(n_buddha_tris=200, env_shape=(16, 32)), jmaterial)
    t = _glass(tdemo.jade_scene(n_buddha_tris=200, env_shape=(16, 32)), tmaterial)
    sdj = jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy")
    st = tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")
    assert st.has_refract and sdj.has_refract
    return j, sdj, t, st


@pytest.fixture(scope="module")
def jax_film(scenes):
    j, sdj, _, _ = scenes
    cfg = JConfig(**SIZE, engine="scan", traversal="bvh")
    return np.asarray(jrender.render_film(jax.tree.map(jnp.asarray, sdj), j.camera,
                                          cfg).accum)


def test_refract_march_matches_jax(scenes):
    _, sdj, _, st = scenes
    g = np.random.default_rng(7)
    m, b, seed = 512, 1, 4
    statue = np.nonzero(sdj.tri_obj == 0)[0]
    tri = g.choice(statue, m).astype(np.int32)
    uv = g.uniform(0.05, 0.45, (2, m)).astype(np.float32)
    p1, p2, p3 = (np.asarray(getattr(sdj, k))[tri] for k in ("tri_p1", "tri_p2", "tri_p3"))
    src = (p1 + (p2 - p1) * uv[0][:, None] + (p3 - p1) * uv[1][:, None]).astype(np.float32)
    nrm = np.asarray(sdj.tri_norm)[tri]
    # both sides of the surface: lanes that refract outward mostly escape
    out = g.normal(size=(m, 3)).astype(np.float32)
    out = (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)
    alive = g.uniform(size=m) < 0.9
    pix = g.integers(0, 256, m).astype(np.uint32)
    smp = g.integers(0, 8, m).astype(np.uint32)
    miu = np.full(m, 1.5, np.float32)
    jcfg = JConfig(**SIZE, traversal="bvh", seed=seed)
    want = jwf._refract_march(
        alive, tri, miu, JV3(*nrm.T), JV3(*src.T), JV3(*out.T), sdj, jcfg, np,
        jrender.make_nearest(sdj, jcfg, np),
        lambda site: jrng.uniform(np, pix, smp, np.uint32(b + 1), site, seed))

    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pix_t, smp_t = tt(pix.astype(np.int64)), tt(smp.astype(np.int64))
    got = twf.refract_march(
        tt(alive), tt(tri), tt(miu), V3(*tt(nrm.T)), V3(*tt(src.T)), V3(*tt(out.T)), st,
        TConfig(**SIZE, seed=seed),
        lambda site: trng.uniform(pix_t, smp_t, b + 1, site, seed),
        twf.nearest_planes_plain)

    w_dir, w_rate, w_esc, w_last, w_src = want
    np.testing.assert_array_equal(got.escaped.numpy(), w_esc)
    np.testing.assert_array_equal(got.last.numpy(), w_last)
    assert w_esc.any() and (alive & ~w_esc).any() and (w_last != tri).any()
    for a, w in ((got.dir, w_dir), (got.src, w_src)):
        np.testing.assert_array_equal(np.stack([v.numpy() for v in a]),
                                      np.stack(w).astype(np.float32))
    w = np.stack(w_rate).astype(np.float32)
    np.testing.assert_allclose(np.stack([v.numpy() for v in got.rate]), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


def test_sqrt_rounds_correctly():
    """The port's square root equals NumPy's (IEEE, correctly rounded) bit
    for bit, also where torch's own float32 sqrt is an ulp off on some x86
    builds (the march's exit directions parted from JAX that way)."""
    from jaderaytracerendering_tpu_torch.core import vecmath

    x = np.random.default_rng(3).uniform(0, 4, 1 << 20).astype(np.float32)
    x[:3] = (0.0, 0.8649341, 1e-30)
    got = vecmath.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.sqrt(x).view(np.int32))


@pytest.mark.parametrize("engine", ["scan", "pool", "mega"])
def test_engines_match_jax_scan(scenes, jax_film, engine):
    _, _, t, st = scenes
    kernels.reset_launches()
    stats = {}
    film = trender.render_film(st, t.camera, TConfig(**SIZE, engine=engine), stats=stats)
    assert set(kernels.LAUNCHES.values()) == {0}  # CPU: the plain versions
    assert film.count == SIZE["spp"]
    got = film.accum.numpy()
    scale = max(np.abs(jax_film).max(), 1.0)
    np.testing.assert_allclose(got, jax_film, atol=1e-6 * scale, rtol=1e-5)


def test_useful_rays_equal_across_engines(scenes):
    _, _, t, st = scenes
    rays = {}
    for engine in ("scan", "pool", "mega"):
        stats = {}
        trender.render_film(st, t.camera, TConfig(**SIZE, engine=engine), stats=stats)
        rays[engine] = stats["rays"]
    assert rays["scan"] == rays["pool"] == rays["mega"] > 16 * 16 * 2


def test_escaped_march_kills_the_path():
    """An open glass quad facing the camera in front of the sky: a path
    that takes direct refraction at its first hit refracts into the quad,
    finds no surface behind it (the march escapes), and is killed down to
    its primary emission, 0; a path that takes the diffuse lobe sees the
    sky through NEE. So a pixel is dark exactly where its first bounce
    drew refraction, in every engine and in the JAX scan engine."""
    from jaderaytracerendering_tpu.scene import objloader as jobj, procedural as jproc
    from jaderaytracerendering_tpu.scene import scene as jscene
    from jaderaytracerendering_tpu_torch.scene import objloader as tobj, procedural as tproc
    from jaderaytracerendering_tpu_torch.scene import hdr, transforms

    xf = transforms.transform_matrix(scale=(8.0, 8.0, 1.0))
    kw = dict(brdf=(0.5, 0.5, 0.5), refract_mode=2, refract_index=1.5,
              refract_rate=(0.9, 0.9, 0.9))
    env = hdr.procedural_sky(16, 32)
    t_obj = [tscene.SceneObject(tobj.mesh_from_arrays(*tproc.quad(), transform=xf),
                                tmaterial.Material(**kw))]
    j_obj = [jscene.SceneObject(jobj.mesh_from_arrays(*jproc.quad(), transform=xf),
                                jmaterial.Material(**kw))]
    cam = tdemo.OrbitCamera()
    cfg = dict(width=8, height=8, spp=1, max_depth=2, max_refract_bounces=4)
    st = tscene.assemble(t_obj, env, bvh_backend="numpy", device="cpu")
    sdj = jassemble(j_obj, env, xp=np, bvh_backend="numpy")
    want = np.asarray(jrender.render_film(jax.tree.map(jnp.asarray, sdj), cam, JConfig(
        **cfg, engine="scan", traversal="bvh")).accum).reshape(-1, 3)
    pix = torch.arange(64)
    refracts = (trng.uniform(pix, 0, 1, trng.DrawSites.SELECT_REFRACT) < 0.5).numpy()
    assert refracts.any() and not refracts.all()
    for engine in ("scan", "pool", "mega"):
        got = trender.render_film(st, cam, TConfig(**cfg, engine=engine)).accum
        got = got.reshape(-1, 3).numpy()
        np.testing.assert_array_equal(got[refracts], 0.0)
        assert (got[~refracts].sum(1) > 0).all()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=1e-5)
