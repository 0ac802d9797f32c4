"""Golden images through the port: the pool engine (plain versions on the
CPU) reproduces the committed jade goldens that pin the JAX package's
pool engine (tests/test_goldens.py:38-43, 63-68), at that file's
tolerance (atol = 2e-4 * max, rtol = 2e-3). The goldens were rendered
from the JAX ``assemble``'s default BVH backend; the port's NumPy SAH
build orders this scene's triangles, and so its lights and their RNG
sites, the same way.
"""

import os

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("name,size,lanes", [("jade_10x10_4spp.npy", 10, 64),
                                             ("jade_64x64_4spp.npy", 64, 4096)])
def test_pool_reproduces_jade_golden(name, size, lanes):
    from jaderaytracerendering_tpu_torch.integrator import pool

    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = RenderConfig(width=size, height=size, spp=4, spp_batch=4, max_depth=5,
                       seed=5, engine="pool")
    want = np.load(os.path.join(GOLDENS, name))
    got = pool.render_film_pool(st, ds.camera, cfg, pool_m=lanes).mean().numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3)
    if size == 10:  # and through render_film's routing
        film = trender.render_film(st, ds.camera, cfg)
        np.testing.assert_allclose(film.mean().numpy(), want, atol=2e-4 * scale,
                                   rtol=2e-3)
