"""Port parity: the SSS exit pick (reference bisection) equals the JAX
package's table-driven ``area_cdf_pick_fast``, the sampling helpers
match the JAX plane forms, and ``sample_env`` matches
``envmap.sample_env``.

Tolerances: the pick exact (integer ids); the sampling helpers within
1e-6; the env lookup within 1e-6 (absolute, on radiance of order 1-10)
given the same (u, v). End to end, from directions, within 1e-4: torch
and NumPy take atan2/asin from different libm implementations that
differ by an ulp (~4e-8 in u), which the bilinear filter scales by the
map width times the steepest texel step (the sun disc)."""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.integrator import sampling as jsamp
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene import envmap as jenv
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu_torch.core.vecmath import V3
from jaderaytracerendering_tpu_torch.integrator import sampling as tsamp
from jaderaytracerendering_tpu_torch.scene import envmap as tenv
from jaderaytracerendering_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

ENV_ATOL = 1e-6
ENV_DIR_ATOL = 1e-4


@pytest.mark.parametrize("n_tris", [300, 2000])
def test_area_cdf_pick_equals_fast_tables(n_tris):
    ds = jdemo.jade_scene(n_buddha_tris=n_tris, env_shape=(8, 16))
    sj = jassemble(ds.objects, ds.env_map, xp=np, bvh_backend="numpy")
    assert sj.sss_nb > 0
    st = tscene.scene_from_numpy({k: getattr(sj, k) for k in [*tscene.TABLES, "leaf_size"]},
                                 device="cpu")
    g = np.random.default_rng(n_tris)
    u = g.uniform(size=20000).astype(np.float32)
    u[:4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 1e-7]
    obj = g.integers(0, sj.n_objects, 20000).astype(np.int32)
    want = np.asarray(jsamp.area_cdf_pick_fast(u, obj, sj, np))
    got = tsamp.area_cdf_pick(torch.from_numpy(u), torch.from_numpy(obj),
                              st.prefix_area, st.obj_total_area, st.seg_begin,
                              st.seg_end, st.mapping)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_helpers_match():
    g = np.random.default_rng(3)
    u = [g.uniform(size=4000).astype(np.float32) for _ in range(2)]
    tu = [torch.from_numpy(a) for a in u]

    def v3(a):
        return np.stack([a.x.numpy(), a.y.numpy(), a.z.numpy()], -1)

    def jv3(a):
        return np.stack([np.asarray(a.x), np.asarray(a.y), np.asarray(a.z)], -1)

    np.testing.assert_allclose(v3(tsamp.uniform_sphere_p(*tu)),
                               jv3(jsamp.uniform_sphere_p(*u, np)), atol=1e-6)
    dist = g.uniform(0.01, 2.0, 4000).astype(np.float32)
    sig = [g.uniform(0.05, 1.0, 4000).astype(np.float32) for _ in range(3)]
    from jaderaytracerendering_tpu.core.vecmath import V3 as JV3

    want = jv3(jsamp.bssrdf_p(dist, JV3(*sig), np))
    got = v3(tsamp.bssrdf_p(torch.from_numpy(dist), V3(*map(torch.from_numpy, sig))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    c = torch.from_numpy(u[0])
    np.testing.assert_allclose(tsamp.fresnel_exit(0.2, c).numpy(),
                               jsamp.fresnel_exit(0.2, u[0]), atol=1e-7)
    np.testing.assert_allclose(tsamp.fresnel_entry(0.2, c).numpy(),
                               jsamp.fresnel_entry(0.2, u[0]), atol=1e-7)


@pytest.mark.parametrize("shape", [(16, 32), (64, 128)])
def test_sample_env_matches(shape):
    from jaderaytracerendering_tpu.scene import hdr

    img = hdr.procedural_sky(*shape)
    g = np.random.default_rng(shape[0])
    d = g.normal(size=(5000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]]
    want = jenv.sample_env(img, d, np, clamp=10.0)
    assert want.max() == 10.0  # the clamp is exercised
    td = V3(*(torch.from_numpy(d[:, k].copy()) for k in range(3)))

    def rows(v):
        return np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], -1)

    u, v = jenv.spherical_uv(d, np)
    tu, tv = tenv.spherical_uv(td)
    np.testing.assert_allclose(tu.numpy(), u, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), v, atol=1e-6, rtol=0)
    got_uv = tenv.sample_env_uv(torch.from_numpy(img), torch.from_numpy(u),
                                torch.from_numpy(v), clamp=10.0)
    np.testing.assert_allclose(rows(got_uv), want, atol=ENV_ATOL, rtol=0)
    got = tenv.sample_env(torch.from_numpy(img), td, clamp=10.0)
    np.testing.assert_allclose(rows(got), want, atol=ENV_DIR_ATOL, rtol=0)
