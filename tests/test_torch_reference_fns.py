"""Port parity of the reference functions off the render paths, against
the JAX package: ``core/rng.wang_hash`` and ``glsl_seed``, the row-vector
``core/camera.generate_rays``, the shadow-projection intersector
``ops/intersect.ray_triangle(method="shadow")``, ``scene/objloader.write_obj``,
``integrator/render.render_image``; and the port's ``utils/logging.py``
(``RayCounter``, ``profiler_trace``, rank-tagged stage lines) and
``entry.py`` (``entry``, ``dryrun_multichip(2, device="cpu")``).

Tolerances: hashes, seeds, hit flags and OBJ bytes exact; rays and
intersection t within 1e-6 (the same float32 operations in the same
order); ``render_image`` within one u8 step (tests/test_torch_integrator.py:
the two packages' films agree to libm ulps, which can move a value across
a quantisation step).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import camera as jcamera, rng as jrng
from jaderaytracerendering_tpu.integrator import render as jrender
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.ops import intersect as jintersect
from jaderaytracerendering_tpu.scene import objloader as jobj, procedural as jproc
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.core import camera as tcamera, rng as trng
from jaderaytracerendering_tpu_torch.core.vecmath import V3
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import intersect as tintersect
from jaderaytracerendering_tpu_torch.scene import objloader as tobj
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_wang_hash_matches_jax():
    seeds = np.concatenate([np.arange(4096), [0xDEADBEEF, 0xFFFFFFFF, 2 ** 31, 1973]])
    seeds = np.concatenate([seeds, np.random.default_rng(0).integers(0, 2 ** 32, 4096)])
    want = jrng.wang_hash(seeds.astype(np.uint32), np)
    got = trng.wang_hash(torch.tensor(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(trng.wang_hash(42)) == int(jrng.wang_hash(np.uint32(42), np))


def test_glsl_seed_matches_jax():
    g = np.random.default_rng(1)
    x = g.uniform(-1, 1, 2000).astype(np.float32)
    y = g.uniform(-1, 1, 2000).astype(np.float32)
    for w, h, frame in ((1024, 1024, 7), (640, 480, 123456), (33, 17, 2 ** 31 + 5)):
        want = jrng.glsl_seed(x, y, w, h, frame, np)
        got = trng.glsl_seed(torch.from_numpy(x), torch.from_numpy(y), w, h, frame)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert bool((got % 2 == 1).all())


@pytest.mark.parametrize("jitter", ["cuda", "gl"])
def test_generate_rays_matches_jax(jitter):
    cam = jcamera.OrbitCamera(up_angle=12.0, rotate_angle=30.0, r=3.0)
    ids = np.arange(0, 24 * 16, 5)
    o_j, d_j = jcamera.generate_rays(jnp, jnp.asarray(cam.eye, jnp.float32),
                                     jnp.asarray(cam.camera_rotate, jnp.float32), 24, 16,
                                     jnp.asarray(ids, jnp.uint32), jnp.uint32(3), 9, jitter)
    o_t, d_t = tcamera.generate_rays(np.asarray(cam.eye, np.float32),
                                     np.asarray(cam.camera_rotate, np.float32), 24, 16,
                                     torch.tensor(ids), 3, 9, jitter)
    assert o_t.shape == d_t.shape == (len(ids), 3)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


def _v3(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return V3(t[..., 0], t[..., 1], t[..., 2])


@pytest.mark.parametrize("o,d,p1,p2,p3", [
    ([0, 0, 5], [0, 0, -1], [-1, -1, 0], [2, -1, 0], [-1, 2, 0]),    # direct hit
    ([5, 5, 5], [0, 0, -1], [-1, -1, 0], [1, -1, 0], [0, 1, 0]),     # outside
    ([0, 0, -5], [0, 0, -1], [-1, -1, 0], [2, -1, 0], [-1, 2, 0]),   # behind the origin
], ids=["hit", "miss", "behind"])
def test_shadow_intersector_analytic_cases(o, d, p1, p2, p3):
    args = [np.asarray([v], np.float32) for v in (o, d, p1, p2, p3)]
    hit_j, t_j = jintersect.ray_triangle(*args, np, "shadow")
    hit_t, t_t = tintersect.ray_triangle(*[_v3(a) for a in args], method="shadow")
    assert hit_t.tolist() == hit_j.tolist()
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=1e-6)


def test_shadow_intersector_matches_jax_on_random_rays():
    """tests/test_intersect.py's random rays (the dir.z ~ 0 singularity left
    out) through both packages' shadow test, and the port's two methods
    agreeing where both hit."""
    g = np.random.default_rng(0)
    n = 3000
    o = g.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    keep = np.abs(d[:, 2]) > 0.05
    o, d = o[keep], d[keep]
    tri = [np.tile(np.array([p], np.float32), (len(o), 1))
           for p in ([-1, -1, 0], [1, -1, 0], [0, 1, 0])]
    hit_j, t_j = jintersect.ray_triangle(o, d, *tri, np, "shadow")
    hit_t, t_t = tintersect.ray_triangle(_v3(o), _v3(d), *[_v3(p) for p in tri],
                                         method="shadow")
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=1e-6)
    hit_m, t_m = tintersect.ray_triangle(_v3(o), _v3(d), *[_v3(p) for p in tri])
    both = hit_m.numpy() & hit_t.numpy()
    assert both.sum() > 50
    np.testing.assert_allclose(t_m.numpy()[both], t_t.numpy()[both], rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="unknown intersector"):
        tintersect.ray_triangle(_v3(o), _v3(d), *[_v3(p) for p in tri], method="plucker")


def test_write_obj_matches_jax_and_reads_back(tmp_path):
    v, f = jproc.uv_sphere(8, 12)
    jobj.write_obj(str(tmp_path / "jax.obj"), v, f)
    tobj.write_obj(str(tmp_path / "torch.obj"), v, f)
    assert (tmp_path / "jax.obj").read_bytes() == (tmp_path / "torch.obj").read_bytes()
    mj = jobj.read_obj(str(tmp_path / "torch.obj"))
    mt = tobj.read_obj(str(tmp_path / "jax.obj"))
    assert mj.n_triangles == mt.n_triangles == len(f)
    for k in ("p1", "p2", "p3"):
        np.testing.assert_array_equal(np.asarray(getattr(mt, k)), np.asarray(getattr(mj, k)))


def test_render_image_matches_jax():
    cfg = dict(width=8, height=8, spp=2, spp_batch=2, max_depth=3, engine="scan",
               traversal="bvh")
    j = jdemo.tiny_scene()
    want = jrender.render_image(jassemble(j.objects, j.env_map, xp=jnp, bvh_backend="numpy"),
                                j.camera, JConfig(**cfg))
    t = tdemo.tiny_scene()
    got = trender.render_image(tscene.assemble(t.objects, t.env_map, bvh_backend="numpy",
                                               device="cpu"), t.camera, TConfig(**cfg))
    assert got.dtype == np.uint8 and got.shape == want.shape == (8, 8, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_ray_counter_and_timed(caplog):
    c = tlog.RayCounter()
    assert c.mrays_per_sec == 0.0
    c.add(3_000_000, 1.5)
    c.add(1_000_000, 0.5)
    assert c.rays == 4_000_000 and c.mrays_per_sec == pytest.approx(2.0)
    with caplog.at_level("INFO", logger="jaderaytracerendering_tpu_torch"):
        with tlog.timed("a step"):
            pass
        tlog.stage("a stage")
    assert any("a step took" in r.getMessage() for r in caplog.records)
    assert any(r.getMessage() == "a stage" for r in caplog.records)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with tlog.profiler_trace(None):  # nothing without a directory
        pass
    with tlog.profiler_trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    assert trace["traceEvents"]


def test_entry_and_dryrun_multichip_on_cpu(tmp_path):
    """``entry()`` renders one step; ``dryrun_multichip(2, device="cpu")`` runs the three
    engines over a (1, 2) mesh of 2 gloo ranks on the CPU (a subprocess:
    the ranks are spawned processes)."""
    code = """
from jaderaytracerendering_tpu_torch import entry
fn, args = entry.entry("cpu")
rad, rays = fn(*args)
assert rad.shape == (64, 3) and float(rays.sum()) > 0
out = entry.dryrun_multichip(2, device="cpu")
assert [r["rank"] for r in out] == [0, 1], out
assert all(r["counts"] == {"scan": 4, "pool": 4, "mega": 4} and r["backend"] == "gloo"
           for r in out), out
print("RANKS", [r["mesh"] for r in out])
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip OK: 2 ranks" in res.stdout
    assert "RANKS [{'tile': 1, 'spp': 2}, {'tile': 1, 'spp': 2}]" in res.stdout
