"""The port's CPU oracle (``cpuref/integrator.py``) and its RMSE gate
(``cli/rmse_gate.py``).

1. The port's oracle against the JAX package's oracle on the same scenes
   (the tiny scene; jade with 300 statue triangles at r 2.0; the
   DIR_REFRACT statue of tests/test_integrator.py:46-54; the three fuzz
   scenes of tests/test_fuzz_parity.py:68; the jade and the DIR_REFRACT
   statue seen from 0.25 away, since at 8x8 the r 2.0 view's primary
   rays miss the statue and only the fuzz scenes reach its SSS and
   refraction branches otherwise), both scenes built with the
   NumPy BVH builder so that triangle ids agree. Tolerance:
   tests/test_integrator.py::_parity's (atol 1e-4 x max(max|film|, 1),
   rtol 1e-3) and a relative RMSE below 1e-5: the two oracles take the
   same branches on the same draws, and differ only by libm ulps (float32
   ``atan2``/``asin`` of the env lookup, ``cos``/``sin``/``exp``/``pow``)
   and the order of a dot product's sum.
2. The port's three engines (their plain versions on CPU tensors)
   against the port's oracle: relative RMSE below 1e-3 (``rmse_rel``,
   BASELINE.md:31) at tests/test_milestones.py's config 1 and 2 shapes
   and on the two statue views, and tests/test_fuzz_parity.py:76's tolerance (atol 2e-4 x scale, rtol
   2e-3) on the fuzz scenes. The engines composite a path forward, the
   oracle folds it backward, so they round apart.
3. The oracle refuses a scene that is not on the CPU.
4. ``rmse_rel``'s check fails on a film off by 2%.
5. ``cli/rmse_gate.py --device cpu --size 4 --spp 4`` passes, per engine.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import vecmath as jvm
from jaderaytracerendering_tpu.core.camera import OrbitCamera as JOrbit
from jaderaytracerendering_tpu.cpuref import integrator as joracle
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene import hdr as jhdr, material as jmaterial
from jaderaytracerendering_tpu.scene.objloader import MeshData as JMesh
from jaderaytracerendering_tpu.scene.scene import SceneObject as JObject
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.cli import rmse_gate
from jaderaytracerendering_tpu_torch.core.camera import OrbitCamera as TOrbit
from jaderaytracerendering_tpu_torch.cpuref import integrator as toracle
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.scene import material as tmaterial
from jaderaytracerendering_tpu_torch.scene.objloader import MeshData as TMesh
from jaderaytracerendering_tpu_torch.scene.scene import SceneObject as TObject
from jaderaytracerendering_tpu_torch.scene.scene import assemble as tassemble
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

ORACLE_ATOL, ORACLE_RTOL, ORACLE_RMSE = 1e-4, 1e-3, 1e-5
FUZZ_ATOL, FUZZ_RTOL = 2e-4, 2e-3
BRUTE = dict(traversal="brute")


def _glass(ds, mat_mod):
    glass = dataclasses.replace(ds.objects[0].material, refract_mode=mat_mod.DIR_REFRACT,
                                refract_index=1.5, refract_rate=(0.9, 0.9, 0.9))
    ds.objects[0] = dataclasses.replace(ds.objects[0], material=glass)
    ds.camera.r = 2.0
    return ds


def _demo(name, r=None, glass=False, statue=False, **kw):
    """(JAX objects, env, camera), (port objects, env, camera) of a demo
    scene; ``statue``: the camera on the statue (``rmse_gate.statue_view``)."""
    pair = []
    for demo, mat in ((jdemo, jmaterial), (tdemo, tmaterial)):
        ds = getattr(demo, f"{name}_scene")(**kw)
        if r is not None:
            ds.camera.r = r
        if glass:
            ds = _glass(ds, mat)
        if statue:
            rmse_gate.statue_view(ds.camera)
        pair.append((ds.objects, ds.env_map, ds.camera))
    return pair


def _fuzz(seed):
    """tests/test_fuzz_parity.py's random scene, built in both packages
    from the same arrays."""
    rng = np.random.default_rng(seed)
    mats = [
        dict(brdf=tuple(rng.uniform(0.1, 0.9, 3))),
        dict(brdf=tuple(rng.uniform(0.05, 0.5, 3)), reflex_mode=jmaterial.MIRROR),
        dict(brdf=(0.02, 0.02, 0.02), reflex_mode=jmaterial.MIRROR,
             refract_mode=jmaterial.SUB_SURFACE,
             refract_rate=tuple(rng.uniform(0.05, 0.3, 3)),
             refract_albedo=tuple(rng.uniform(0.1, 0.5, 3)),
             refract_index=float(rng.uniform(1.2, 2.8))),
        dict(reflex_mode=jmaterial.DIFFUSE, refract_mode=jmaterial.DIR_REFRACT,
             refract_rate=tuple(rng.uniform(0.5, 0.95, 3)),
             refract_index=float(rng.uniform(1.1, 1.8))),
        dict(emissive=tuple(rng.uniform(5, 50, 3))),
    ]
    meshes = []
    for _ in mats:
        n_tris = int(rng.integers(6, 40))
        c = rng.uniform(-1.2, 1.2, (n_tris, 1, 3))
        tri = c + rng.normal(scale=0.25, size=(n_tris, 3, 3))
        p1, p2, p3 = (tri[:, i].astype(np.float32) for i in range(3))
        norm = jvm.face_normal(p1.astype(np.float64), p2.astype(np.float64),
                               p3.astype(np.float64), np).astype(np.float32)
        meshes.append((p1, p2, p3, norm))
    env = jhdr.procedural_sky(16, 32, sun_intensity=float(rng.uniform(5, 40)))
    cam = dict(up_angle=float(rng.uniform(-30, 40)), rotate_angle=float(rng.uniform(0, 360)),
               r=float(rng.uniform(2.0, 5.0)))
    j = [JObject(mesh=JMesh(*m), material=jmaterial.Material(**k)) for m, k in zip(meshes, mats)]
    t = [TObject(mesh=TMesh(*m), material=tmaterial.Material(**k)) for m, k in zip(meshes, mats)]
    return [(j, env, JOrbit(**cam)), (t, env, TOrbit(**cam))]


def _fuzz_cfg(seed):
    return dict(width=6, height=6, spp=3, spp_batch=3, max_depth=4, max_refract_bounces=6,
                seed=seed, **BRUTE)


SMALL = dict(width=8, height=8, spp=2, spp_batch=2, **BRUTE)
CASES = {
    "tiny": (lambda: _demo("tiny"), dict(SMALL, max_depth=3)),
    "jade300": (lambda: _demo("jade", r=2.0, n_buddha_tris=300, env_shape=(16, 32)),
                dict(width=10, height=10, spp=4, spp_batch=4, max_depth=4, **BRUTE)),
    "dir_refract": (lambda: _demo("jade", glass=True, n_buddha_tris=200, env_shape=(16, 32)),
                    dict(SMALL, max_depth=3, max_refract_bounces=8)),
    # the views above show the statue to no primary ray; these two do
    # (its SSS entry and exit, mirror and refraction branches)
    "statue": (lambda: _demo("jade", statue=True, n_buddha_tris=300, env_shape=(16, 32)),
               dict(SMALL, max_depth=4)),
    "statue_glass": (lambda: _demo("jade", glass=True, statue=True, n_buddha_tris=200,
                                   env_shape=(16, 32)),
                     dict(SMALL, max_depth=3, max_refract_bounces=8)),
    # tests/test_milestones.py configs 1 and 2
    "config1": (lambda: _demo("diffuse", n_buddha_tris=400, env_shape=(16, 32)),
                dict(width=12, height=12, spp=4, spp_batch=4, max_depth=4, **BRUTE)),
    "config2": (lambda: _demo("jade", r=2.0, n_buddha_tris=300, env_shape=(16, 32)),
                dict(width=10, height=10, spp=4, spp_batch=4, max_depth=5, **BRUTE)),
}
for _seed in (11, 23, 47):
    CASES[f"fuzz{_seed}"] = (functools.partial(_fuzz, _seed), _fuzz_cfg(_seed))
ORACLE_CASES = ["tiny", "jade300", "dir_refract", "statue", "statue_glass", "fuzz11", "fuzz23",
                "fuzz47"]
ENGINE_CASES = ["config1", "config2", "statue", "statue_glass", "fuzz11", "fuzz23", "fuzz47"]


@functools.cache
def _port_scene(name):
    (_, (objs, env, cam)), cfg = CASES[name][0](), CASES[name][1]
    return tassemble(objs, env, bvh_backend="numpy", device="cpu"), cam, TConfig(**cfg)


@functools.cache
def _port_oracle(name) -> np.ndarray:
    sd, cam, cfg = _port_scene(name)
    return toracle.render_radiance(sd, cam, cfg).numpy()


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_oracle_matches_jax_oracle(name):
    ((objs, env, cam), _), cfg = CASES[name][0](), CASES[name][1]
    sd = jassemble(objs, env, xp=np, bvh_backend="numpy")
    ref = joracle.render_radiance(sd, cam, JConfig(**cfg))
    got = _port_oracle(name)
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, atol=ORACLE_ATOL * scale, rtol=ORACLE_RTOL)
    assert rmse_gate.rmse_rel(got, ref)[0] < ORACLE_RMSE
    if name == "dir_refract":
        assert _port_scene(name)[0].has_refract


@pytest.mark.parametrize("engine", ["mega", "pool", "scan"])
@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engines_match_port_oracle(name, engine):
    sd, cam, cfg = _port_scene(name)
    ref = _port_oracle(name)
    stats = {}
    film = trender.render_film(sd, cam, cfg.replace(engine=engine), stats=stats)
    got = film.mean().numpy()
    assert film.count == cfg.spp and stats["rays"] >= cfg.width * cfg.height * cfg.spp
    if name.startswith("fuzz"):
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got, ref, atol=FUZZ_ATOL * scale, rtol=FUZZ_RTOL)
    else:
        rmse_gate.check_rmse(got, ref, f"{engine} on {name}")


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_oracle_refuses_a_scene_off_the_cpu(device):
    """A CUDA scene (a stand-in here: no card) or any other non-CPU scene is
    refused with a message naming the CPU copy, never moved."""
    if device == "cuda":
        sd = type("CudaScene", (), {"device": torch.device("cuda")})()
    else:
        sd = _port_scene("tiny")[0].to("meta")
    _, cam, cfg = _port_scene("tiny")
    with pytest.raises(ValueError, match="device='cpu'"):
        toracle.render_radiance(sd, cam, cfg)


def test_rmse_check_fails_on_a_film_two_percent_off():
    ref = _port_oracle("jade300")
    r, m = rmse_gate.rmse_rel(ref * 1.02, ref)
    assert r > rmse_gate.GATE and m == pytest.approx(0.02, rel=1e-3)
    with pytest.raises(AssertionError, match="FAILED"):
        rmse_gate.check_rmse(ref * 1.02, ref)
    assert rmse_gate.check_rmse(ref, ref) == (0.0, 0.0)


@pytest.mark.parametrize("engine", ["mega", "pool", "scan"])
def test_rmse_gate_cli_passes_on_cpu(engine, capsys):
    out = rmse_gate.main(["--device", "cpu", "--size", "4", "--spp", "4", "--engine", engine])
    text = capsys.readouterr().out
    assert text.splitlines()[-1] == "PASS"
    assert f"4x4 @ 4 spp depth 4 (300 tris, {engine}+sweep, device=cpu)" in text
    assert out["rmse_rel"] < rmse_gate.GATE and out["rays"] > 0


@pytest.mark.parametrize("statue,want", [
    (False, {"sky": 31, "statue": 0, "light": 1, "floor": 32}),
    (True, {"sky": 3, "statue": 10, "light": 0, "floor": 51}),
])
def test_statue_view_sees_the_statue(statue, want):
    """What the gate scene's 8x8 primary rays (sample 0) hit: the gate's
    r 2.0 view (tools/rmse_gate.py) meets the statue with none, the
    statue view (``rmse_gate.statue_view``) with 10."""
    from jaderaytracerendering_tpu_torch.core import camera as tcamera
    from jaderaytracerendering_tpu_torch.ops import bruteforce

    ds = rmse_gate.gate_scene(300, statue=statue)
    sd = tassemble(ds.objects, ds.env_map, device="cpu")
    eye, rot = tcamera.camera_tensors(ds.camera, "cpu")
    o, d = tcamera.generate_rays(eye, rot, 8, 8, torch.arange(64), 0)
    hit, idx, _ = bruteforce.nearest_hit(o, d, torch.full((64,), -1, dtype=torch.int32),
                                         sd.tri_p1, sd.tri_p2, sd.tri_p3)
    obj = torch.where(hit, sd.tri_obj[idx.long()], -1)
    got = {name: int((obj == k).sum()) for k, name in
           ((-1, "sky"), (0, "statue"), (1, "light"), (2, "floor"))}
    assert got == want
