"""CPU tests of the benchmark's plain reference: values worked out by
hand on tiny scenes, agreement with the program's own CPU oracle (a
test may read the program; the reference may not), the control in
bfloat16 failing the limits, and the imports that no run may load."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import scene as bscene
from benchmark.reference import camera, pathtrace, post, preview, rng
from benchmark.reference import scene as rscene

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(width=8, height=8, max_depth=8, rr_rate=0.9, sss_rate=0.5, hdr_clamp=10.0,
           max_refract_bounces=32, internal_reflect_rate=0.2, preview_bounces=2)


def _constant_sky(value: float, h: int = 8, w: int = 16) -> np.ndarray:
    return np.full((h, w, 3), value, np.float32)


def test_rng_matches_hand_computed_pcg():
    # pcg output of (pixel * K_PIXEL + sample * K_SAMPLE), then bounce, seed
    # and site mixed in, top 24 bits / 2^24, worked out with Python ints
    def pcg(x):
        x = (x * 747796405 + 2891336453) & 0xFFFFFFFF
        w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & 0xFFFFFFFF
        return (w >> 22) ^ w

    p, s, b, site, seed = 12345, 7, 3, 6, 2 ** 31 + 5
    h = pcg((p * 0x9E3779B9 + s * 0x85EBCA6B) & 0xFFFFFFFF)
    h = (h + b * 0xC2B2AE35) & 0xFFFFFFFF
    h = (h + seed * 0x165667B1) & 0xFFFFFFFF
    want = (pcg((h + site * 0x27D4EB2F) & 0xFFFFFFFF) >> 8) / 2 ** 24
    got = rng.uniform(torch.tensor([p]), torch.tensor([s]), b, site, seed)
    assert float(got[0]) == want


def test_a_ray_into_an_empty_sky_reads_the_sky():
    # nothing in view: every sample is the sky's constant, clamped at 10
    raw = bscene.RawScene(objects=[bscene.place("floor", *bscene._box(),
                                                bscene.MIRROR_FLOOR,
                                                dict(rotate=(0, 0, 0), translate=(0, -50, 0),
                                                     scale=(1, 1, 1)))],
                          env=_constant_sky(0.5))
    t = rscene.build(raw, "cpu")
    cam = camera.orbit(0.0, 0.0, 4.0)
    sums = pathtrace.render_pixels(t, CFG, cam, torch.arange(64), 4, 99, (0,))
    assert torch.allclose(sums, torch.full((64, 3), 2.0))
    raw.env = _constant_sky(25.0)
    t = rscene.build(raw, "cpu")
    sums = pathtrace.render_pixels(t, CFG, cam, torch.arange(64), 4, 99, (0,))
    assert torch.allclose(sums, torch.full((64, 3), 40.0))  # 4 samples x the clamp 10


def test_a_light_filling_the_view_counts_twice():
    # the camera looks straight at a light quad that covers the film: the
    # primary hit adds its emission, and the path stops on it adding it
    # again (PathTrace.cu:916-919): 2 x 1000 a sample
    light = bscene.place("light", *bscene._quad(), bscene.LIGHT_1000,
                         dict(rotate=(0, 0, 0), translate=(0, 0, 0), scale=(20, 20, 1)))
    raw = bscene.RawScene(objects=[light], env=_constant_sky(0.5))
    t = rscene.build(raw, "cpu")
    cam = camera.orbit(0.0, 0.0, 2.0)
    sums = pathtrace.render_pixels(t, CFG, cam, torch.arange(64), 3, 5, (0, 1))
    assert torch.allclose(sums, torch.full((64, 3), 6000.0))
    # the preview: emission at the primary hit, then two bounces off the
    # quad that leave into the sky: each adds sky x brdf/pi x |cos| x 2pi
    counts = torch.full((64,), 1)
    prev = preview.render_pixels(t, CFG, cam, torch.arange(64), counts, 5)
    assert bool((prev >= 1000.0).all())


def test_display_values():
    # ACES(1) = 2.54 / 3.16; gamma 1/2.2; x255 truncated: 230. ACES(100) =
    # 25103 / 24359.14 > 1, so x255 passes 255 and is clamped there
    want = int(((2.54 / 3.16) ** (1 / 2.2)) * 255)
    assert want == 230
    got = post.display(torch.tensor([[4.0, 0.0, 400.0]]), torch.tensor([4]))
    assert got.tolist() == [[230, 0, 255]]
    assert post.finalize(np.array([[1.0, 0.0, 100.0]], np.float32)).tolist() == \
        got.tolist()


def test_scene_maker_matches_the_programs_demo_scene():
    from jaderaytracerendering_tpu_torch.models import demo

    raw = bscene.jade(300, (16, 32))
    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    for ro, po in zip(raw.objects, ds.objects):
        for k in ("p1", "p2", "p3", "norm"):
            assert np.array_equal(getattr(ro, k), getattr(po.mesh, k)), (ro.name, k)
        assert vars(ro.material) == vars(po.material)
    assert np.array_equal(raw.env, ds.env_map)


def _nearest_of_all(t, o, d, exclude):
    """Every ray against every triangle: what ``pathtrace.nearest`` has to
    give (lowest id on equal t)."""
    from benchmark.reference.vec import V3, cross, dot, normalize

    d = normalize(d)
    p1, e1, e2 = (V3(*(c[None] for c in v)) for v in (t.p1, t.e1, t.e2))
    oc, dc = V3(*(c[:, None] for c in o)), V3(*(c[:, None] for c in d))
    h = cross(dc, e2)
    f = torch.reciprocal(dot(e1, h))
    s = oc - p1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(dc, q)
    tt = f * dot(e2, q)
    ids = torch.arange(t.n_triangles)
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0) & (ids[None] != exclude[:, None])
    tt = torch.where(ok, tt, pathtrace.INF)
    j = torch.argmin(tt, dim=1)
    tc = tt.gather(1, j[:, None])[:, 0]
    return tc < pathtrace.INF, torch.where(tc < pathtrace.INF, j, 0), tc


def test_the_clustered_hit_search_finds_the_nearest_of_all_triangles():
    """Rays aimed at points on the statue's triangles from nearby (many
    clusters met, grazing hits), some along an axis, some of zero length,
    some excluding the triangle they aim at."""
    from benchmark.reference.vec import V3

    raw = bscene.jade(3000, (16, 32))
    t = rscene.build(raw, "cpu")
    assert t.cluster.shape[1] == rscene.CLUSTER
    ids = t.cluster[t.cluster >= 0]
    assert torch.equal(ids.sort().values, torch.arange(t.n_triangles))  # each once
    g = torch.Generator().manual_seed(1)
    n = 2000
    tgt = torch.randint(0, t.n_triangles, (n,), generator=g)
    w = torch.rand(n, 3, generator=g)
    pts = (t.tri_p[tgt] * (w / w.sum(1, keepdim=True))[:, :, None]).sum(1)
    org = pts + 0.5 * torch.randn(n, 3, generator=g)
    org[:200, 1] = pts[:200, 1]
    dirs = pts - org
    dirs[:100, 1] = 0.0
    dirs[100:110] = 0.0
    exclude = torch.where(torch.rand(n, generator=g) < 0.3, tgt, -1)
    o, d = V3(*org.unbind(1)), V3(*dirs.unbind(1))
    got, want = pathtrace.nearest(t, o, d, exclude), _nearest_of_all(t, o, d, exclude)
    assert int(got[0].sum()) > n // 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the statue as the demo makes it (SSS), and made DIR_REFRACT (the
# refraction march, which no cell runs yet)
GLASS = bscene.Material(brdf=(0.05, 0.05, 0.05), refract_mode=bscene.DIR_REFRACT,
                        refract_rate=(0.9, 0.95, 0.9), refract_index=1.5)


@pytest.mark.parametrize("statue", [None, GLASS], ids=["jade", "dir-refract"])
def test_reference_matches_the_programs_oracle_and_engines(statue):
    """Sample for sample against the program's CPU oracle (cpuref) and its
    engines' plain versions, in a view that sees the statue and the light;
    only the right order of the light slots agrees."""
    import dataclasses

    from jaderaytracerendering_tpu_torch.core.camera import OrbitCamera
    from jaderaytracerendering_tpu_torch.cpuref import integrator as cpuref
    from jaderaytracerendering_tpu_torch.integrator import render
    from jaderaytracerendering_tpu_torch.models import demo
    from jaderaytracerendering_tpu_torch.scene import material
    from jaderaytracerendering_tpu_torch.scene.scene import assemble
    from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

    raw = bscene.jade(300, (16, 32))
    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    if statue is not None:
        raw.objects[0] = dataclasses.replace(raw.objects[0], material=statue)
        ds.objects[0] = dataclasses.replace(ds.objects[0],
                                            material=material.Material(**vars(statue)))
    sd = assemble(ds.objects, ds.env_map, device="cpu")
    w, spp, seed = 12, 4, 2 ** 31 + 11
    pcfg = RenderConfig(width=w, height=w, spp=spp, max_depth=16, seed=seed)
    cam = OrbitCamera(r=1.2, up_angle=10.0)
    oracle = cpuref.render_radiance(sd, cam, pcfg).reshape(-1, 3).numpy() * spp
    film = render.render_film(sd, cam, pcfg).accum.reshape(-1, 3).numpy()
    t = rscene.build(raw, "cpu")
    cfg = dict(CFG, width=w, height=w, max_depth=16)
    readings = {}
    for order in pathtrace.light_orders(t):
        ref = pathtrace.render_pixels(t, cfg, camera.orbit(10.0, 0.0, 1.2),
                                      torch.arange(w * w), spp, seed, order).numpy()
        readings[order] = (np.abs(ref - oracle).max() / np.abs(oracle).max(),
                           np.abs(ref - film).max() / np.abs(film).max())
    good = min(readings, key=lambda o: readings[o][0])
    assert readings[good][0] < 1e-5 and readings[good][1] < 1e-5
    assert all(r[0] > 1e-2 for o, r in readings.items() if o != good)


def test_preview_reference_matches_the_programs_plain_preview():
    from jaderaytracerendering_tpu_torch.core.camera import OrbitCamera
    from jaderaytracerendering_tpu_torch.integrator import render
    from jaderaytracerendering_tpu_torch.models import demo
    from jaderaytracerendering_tpu_torch.scene.scene import assemble
    from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

    ds = demo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    sd = assemble(ds.objects, ds.env_map, device="cpu")
    w, seed = 12, 77
    cfg = RenderConfig(width=w, height=w, spp=1, spp_batch=1, integrator="preview", seed=seed)
    cam = OrbitCamera(r=1.2, up_angle=10.0)
    film = None
    for _ in range(3):
        film = render.render_film_preview(sd, cam, cfg, film)
    t = rscene.build(bscene.jade(300, (16, 32)), "cpu")
    ref = preview.render_pixels(t, dict(CFG, width=w, height=w), camera.orbit(10.0, 0.0, 1.2),
                                torch.arange(w * w), torch.full((w * w,), 3), seed)
    prog = film.accum.reshape(-1, 3)
    assert float((ref - prog).abs().max() / prog.abs().max()) < 1e-5


@pytest.mark.parametrize("workload", ["jade_offline.mega_1024", "jade_preview.orbit"])
def test_the_control_in_bfloat16_fails_a_limit(tmp_path, capsys, workload):
    """The control (the reference in bfloat16 in the program's place) on
    tiny seeds: it fails at least one of the cell's limits."""
    from benchmark import control
    from benchmark.test_benchmark_harness import tiny_root

    root = tiny_root(tmp_path / "root")
    for f in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["camera"].update(r=1.2, up_deg=10.0)
        f.write_text(json.dumps(c))
    assert control.main(["--workload", workload, "--seeds", "3", "--control-seeds", "3",
                         "--seconds", "0.3", "--device", "cpu", "--root", str(root)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    limits = lines[-1]["limits_now"]
    for line in lines[:-1]:
        assert all(v <= limits[k] for k, v in line["program"].items())
        assert any(v > limits[k] for k, v in line["control_bf16"].items())


FORBIDDEN = ("jax", "jaxlib", "flax", "jaderaytracerendering_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax():
    top = _loaded("import benchmark.run, benchmark.program, benchmark.control, "
                  "benchmark.clients.offline, benchmark.clients.preview")
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "jaderaytracerendering_tpu_torch" in top  # the program itself is loaded


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import benchmark.reference.pathtrace, benchmark.reference.preview, "
                  "benchmark.reference.post, benchmark.reference.scene, benchmark.scene, "
                  "benchmark.check, benchmark.seeds, benchmark.roofline")
    assert not top & {*FORBIDDEN, "jaderaytracerendering_tpu_torch"}, top
