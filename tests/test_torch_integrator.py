"""Port parity: the plain torch integrator (``render_film`` engine
'scan') against the JAX package's ``render_film(engine='scan',
traversal='bvh')`` (and its 'clusters' and 'gemm' routes) — same scenes,
same counter-RNG streams, pixel for pixel.

Tolerance: atol = 1e-4 * max|film|, rtol = 1e-3 — the precedent of
tests/test_integrator.py:56-65 (NumPy vs XLA): libm ulps (exp, cos, sin,
atan2) differ between the backends and are carried through the bounces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.integrator import render as jrender
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.core.film import Film
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import TRAVERSALS
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=8, height=8, spp=2, spp_batch=2, max_depth=4)
SCENES = {
    "jade": (dict(n_buddha_tris=300, env_shape=(16, 32)), 2.0),
    "tiny": ({}, None),
    "cornell": ({}, None),
}


def _films(name, traversal="bvh", **cfg_kw):
    kw, r = SCENES[name]
    j = getattr(jdemo, f"{name}_scene")(**kw)
    t = getattr(tdemo, f"{name}_scene")(**kw)
    if r is not None:
        j.camera.r = t.camera.r = r
    sdj = jax.tree.map(jnp.asarray,
                       jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy"))
    jcfg = JConfig(**SIZE, **cfg_kw, engine="scan", traversal=traversal)
    a = np.asarray(jrender.render_film(sdj, j.camera, jcfg).mean())
    st = tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")
    stats = {}
    film = trender.render_film(st, t.camera, TConfig(**SIZE, **cfg_kw, engine="scan",
                                                      traversal=traversal), stats=stats)
    return a, film, stats


def _close(a, b):
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scan_matches_jax_scan(name):
    a, film, stats = _films(name)
    assert film.count == 2 and film.accum.dtype == torch.float32
    assert stats["rays"] >= 8 * 8 * 2  # at least the primaries
    _close(a, film.mean().numpy())


@pytest.mark.parametrize("traversal", ["clusters", "gemm"])
def test_scan_matches_jax_traversal_routes(traversal):
    """The JAX package's cluster and tri_gemm routes (their NumPy/XLA
    versions) compute the nearest hit the port's BVH walk computes."""
    a, film, _ = _films("tiny", traversal=traversal)
    _close(a, film.mean().numpy())


def test_unknown_traversal_raises():
    """A name outside the JAX make_nearest's nine raises ValueError where
    the film and the preview routes start; the nine are the port's."""
    assert TRAVERSALS == ("sweep", "sweep_vpu", "sweep_mxu", "sweep_fused", "sweep_stream",
                          "clusters", "gemm", "bvh", "brute")
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE, traversal="octree")
    for call in (lambda: trender.render_film(st, ds.camera, cfg),
                 lambda: trender.render_film(st, ds.camera, cfg.replace(integrator="preview")),
                 lambda: trender.render_film_preview(st, ds.camera, cfg),
                 lambda: trender.render_film_preview_banded(
                     st, ds.camera, cfg.replace(preview_bands=4), None, 0)):
        with pytest.raises(ValueError, match="unknown traversal 'octree'"):
            call()


def test_gl_jitter_and_seed_match_jax():
    a, film, _ = _films("tiny", jitter="gl", seed=5, tonemap="reinhard")
    _close(a, film.mean().numpy())


def test_film_resume_equals_one_run():
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE, engine="scan")
    f1 = trender.render_film(st, ds.camera, cfg)
    f2 = trender.render_film(st, ds.camera, cfg, film=f1)
    f4 = trender.render_film(st, ds.camera, cfg.replace(spp=4))
    assert f2.count == 4
    np.testing.assert_allclose(f2.mean().numpy(), f4.mean().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_film_file_crosses_packages(tmp_path):
    from jaderaytracerendering_tpu.core.film import Film as JFilm

    g = np.random.default_rng(0)
    film = Film(torch.from_numpy(g.uniform(size=(4, 5, 3)).astype(np.float32)), 7)
    path = str(tmp_path / "film.npz")
    film.save(path)
    back = JFilm.load(path)
    assert int(back.count) == 7
    np.testing.assert_array_equal(np.asarray(back.accum), film.accum.numpy())
    np.testing.assert_array_equal(Film.load(path).accum.numpy(), film.accum.numpy())


def test_unported_engines_raise():
    """Every engine and integrator of the JAX package is ported: the pool
    engine (tests/test_torch_pool.py) and the preview integrator
    (tests/test_torch_preview.py) render; a name the port does not know
    raises."""
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    film = trender.render_film(st, ds.camera, TConfig(**SIZE, engine="pool"))
    assert film.count == SIZE["spp"] and bool(torch.isfinite(film.accum).all())
    film = trender.render_film(st, ds.camera, TConfig(**SIZE, integrator="preview"))
    assert film.count == SIZE["spp"] and float(film.accum.sum()) > 0
    for bad in (dict(engine="wavefront"), dict(integrator="bdpt")):
        with pytest.raises(ValueError):
            trender.render_film(st, ds.camera, TConfig(**SIZE, **bad))


def test_one_engine_table():
    """The engines are the keys of ``render.ENGINES``, each a window
    function: the CLIs' ``--engine`` choices read them, and a name outside
    them raises ``ValueError`` from ``render_film`` and from the mesh
    render."""
    import argparse

    from jaderaytracerendering_tpu_torch.cli import common
    from jaderaytracerendering_tpu_torch.parallel import sharding as tsh

    assert set(trender.ENGINES) == {"mega", "pool", "scan"}
    assert all(callable(fn) for fn in trender.ENGINES.values())
    ap = argparse.ArgumentParser()
    common.add_common_args(ap)
    engine = next(a for a in ap._actions if a.dest == "engine")
    assert list(engine.choices) == list(trender.ENGINES)
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    for render in (lambda c: trender.render_film(st, ds.camera, c),
                   lambda c: tsh.render_film_distributed(st, ds.camera, c, tsh.make_mesh())):
        with pytest.raises(ValueError, match="unknown engine 'wavefront'"):
            render(TConfig(**SIZE, engine="wavefront"))


def test_assemble_defaults_to_cuda(monkeypatch):
    """The scene goes to the card unless the caller asks for the CPU; no
    CUDA device is an error, never a quiet fall back."""
    ds = tdemo.tiny_scene()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.assemble(ds.objects, ds.env_map)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.scene_from_numpy(tscene.assemble_numpy(ds.objects, ds.env_map))
    assert tscene.assemble(ds.objects, ds.env_map, device="cpu").device.type == "cpu"
