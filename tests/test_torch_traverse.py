"""Port parity: nearest-hit t and triangle id of the torch BVH walk and
brute-force sweep against the JAX package's ``traverse.nearest_hit_bvh_np``
and ``bruteforce.nearest_hit_np``, with exclusion ids and with
constructed exact ties (duplicated triangles in different BVH leaves:
the minimum id must win).

Tolerance: ids and hit flags exact; t within 1e-6 relative (the port
spells each dot product as (x*x' + y*y') + z*z', NumPy's sum may round
the last place differently)."""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.ops import bruteforce as jbrute, traverse as jtrav
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import bruteforce as tbrute
from jaderaytracerendering_tpu_torch.core.vecmath import V3, vnormalize, vstack
from jaderaytracerendering_tpu_torch.ops import kernels, trace
from jaderaytracerendering_tpu_torch.ops import traverse as ttrav
from jaderaytracerendering_tpu_torch.scene import material, scene as tscene
from jaderaytracerendering_tpu_torch.scene.objloader import MeshData

torch.set_num_threads(1)

T_RTOL = 1e-6


def _rays(n, seed, n_tri):
    g = np.random.default_rng(seed)
    o = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = (g.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) - o).astype(np.float32)
    ex = g.integers(-1, n_tri, n).astype(np.int32)
    d[:7] = 0.0  # zero directions are misses
    return o, d, ex


def _check(want, got):
    hit, idx, t = (x.numpy() for x in got)
    np.testing.assert_array_equal(hit, want[0])
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_allclose(t, want[2], rtol=T_RTOL)


@pytest.fixture(scope="module")
def jade():
    j = jdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    t = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    return (jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy"),
            tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_bvh_walk_matches_jax(jade, seed):
    sj, st = jade
    o, d, ex = _rays(1500, seed, st.n_triangles)
    want = jtrav.nearest_hit_bvh_np(o, d, ex, sj, stack_size=128)
    assert want[0].mean() > 0.5  # the rays mostly hit
    _check(want, ttrav.nearest_hit_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(ex), st))


def test_bruteforce_matches_jax(jade):
    sj, st = jade
    o, d, ex = _rays(800, 2, st.n_triangles)
    want = jbrute.nearest_hit_np(o, d, ex, sj.tri_p1, sj.tri_p2, sj.tri_p3)
    _check(want, tbrute.nearest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(ex), st.tri_p1, st.tri_p2,
                                    st.tri_p3))


def test_wrapper_runs_plain_walk_on_cpu(jade):
    """The trace kernel's wrapper (one segment) runs the plain walk on CPU
    tensors, on the eps-unit direction, and counts no launch."""
    _, st = jade
    o, d, ex = (torch.from_numpy(a) for a in _rays(200, 3, st.n_triangles))
    kernels.reset_launches()
    bt, bi = trace.trace_segments(st, o.T[None].contiguous(), d.T[None].contiguous(),
                                  ex[None])
    d_u = vstack(vnormalize(V3(d[:, 0], d[:, 1], d[:, 2]), eps=1e-30))
    hit, idx, t = ttrav.nearest_hit_bvh(o, d_u, ex, st)
    assert torch.equal(bi[0], idx) and torch.equal(bt[0], t)
    assert torch.equal(bt[0] < kernels.INF, hit)
    assert kernels.LAUNCHES["trace_segments"] == 0


def test_ties_go_to_the_minimum_id():
    g = np.random.default_rng(5)
    c = g.uniform(-1, 1, (60, 3))
    p1 = (c + g.uniform(-0.1, 0.1, (60, 3))).astype(np.float32)
    p2 = (c + g.uniform(-0.1, 0.1, (60, 3))).astype(np.float32)
    p3 = (c + g.uniform(-0.1, 0.1, (60, 3))).astype(np.float32)
    dup = slice(0, 20)  # a second object repeats 20 triangles exactly

    def mesh(sl):
        e1, e2 = p2[sl] - p1[sl], p3[sl] - p1[sl]
        n = np.cross(e1, e2)
        n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
        return MeshData(p1[sl], p2[sl], p3[sl], n)

    objs = [tscene.SceneObject(mesh(slice(0, 60)), material.Material()),
            tscene.SceneObject(mesh(dup), material.Material())]
    st = tscene.assemble(objs, np.ones((4, 8, 3), np.float32), device="cpu")
    centroid = (p1[dup] + p2[dup] + p3[dup]) / 3.0
    o = np.repeat(np.array([[0.0, 0.0, 3.0]], np.float32), 20, axis=0)
    d = (centroid - o).astype(np.float32)
    ex = np.full(20, -1, np.int32)
    sp = [getattr(st, k).numpy() for k in ("tri_p1", "tri_p2", "tri_p3")]
    want = jbrute.nearest_hit_np(o, d, ex, *sp)
    got = ttrav.nearest_hit_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(ex), st)
    _check(want, got)
    # the brute-force sweep keeps the lowest id of each duplicated pair
    ties = 0
    for i, tri in enumerate(got[1].numpy()):
        same = np.nonzero((sp[0] == sp[0][tri]).all(1) & (sp[1] == sp[1][tri]).all(1)
                          & (sp[2] == sp[2][tri]).all(1))[0]
        ties += len(same) > 1
        assert tri == same.min()
    assert ties >= 10
