"""Port parity: the multi-device render over torch.distributed
(parallel/sharding.py) against the port's single-device films and the
JAX package's ``sharding.render_film_distributed``.

One worker script runs as 4 gloo ranks on the CPU (each its own process,
a ``file://`` rendezvous in the test's temporary directory) over the JAX
tests' setup (tests/test_parallel.py): ``demo.tiny_scene()``, 8x8, depth
2, traversal 'bvh', both packages' scenes built by the NumPy SAH builder.
It renders the meshes (4, 1), (2, 2) and (1, 4) through the engines
scan, pool and mega at 4 spp (spp_batch 2), scan and mega on the (4, 1)
mesh at a ragged height (11 rows: ranks of 3, 3, 3 and 2 dealt rows), a
resumed render (4 spp, then 4 more), the scan at 6 spp over an spp axis
of 2 (3 samples a rank, in spp_batch steps of 2 and 1) and a spp that
does not divide by the spp axis, and saves every rank's films.

Tolerances: bit for bit against the single-device film of the same
engine on tile-only meshes for scan and mega (each pixel's samples are
summed in ascending order on one rank, and the gather adds exact zeros;
every window is whole 8-pixel rows, whose lanes fill torch's 16-float CPU
vectors as the whole film's do, and the plain versions' ``pow`` and
``atan2`` round there as in the whole film);
rtol 1e-4 + atol 1e-5 on the mean film elsewhere (the spp split sums its
halves in another order; the pool's film adds run in another order),
the JAX tests' own bound (tests/test_parallel.py). Against the JAX
package's distributed scan film: rtol 1e-4 + atol 1e-5 on the mean
film. Every rank's film bit for bit equal to rank 0's; useful rays
exact.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.parallel import sharding as jsh
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.parallel import sharding as tsh
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]
ENGINES = ["scan", "pool", "mega"]
SIZE = dict(width=8, height=8, spp=4, spp_batch=2, max_depth=2, traversal="bvh")
RAGGED = dict(height=11)  # rows dealt over 4 tiles: 3, 3, 3, 2
RTOL, ATOL = 1e-4, 1e-5
TIMEOUT = 300

_WORKER = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, init_file, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.parallel import sharding as sh
from jaderaytracerendering_tpu_torch.scene.scene import assemble
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

assert sh.init_distributed(f"file://{init_file}", world, rank, device="cpu")
assert not sh.init_distributed(f"file://{init_file}", world, rank, device="cpu")
ds = demo.tiny_scene()
sd = assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")
cfg = RenderConfig(**json.loads(sys.argv[5]))
films, meta = {}, {}

def run(key, mesh, c, film=None):
    stats = {}
    f = sh.render_film_distributed(sd, ds.camera, c, mesh, film=film, stats=stats)
    films[key] = f.accum.numpy()
    meta[key] = {"count": f.count, "rays": stats["rays"], "backend": stats["backend"],
                 "coords": mesh.coords}
    return f

for shape in json.loads(sys.argv[6]):
    mesh = sh.make_mesh(shape)
    for engine in json.loads(sys.argv[7]):
        run(f"{engine}_{shape[0]}x{shape[1]}", mesh, cfg.replace(engine=engine))
for engine in ("scan", "mega"):
    run(f"{engine}_4x1_ragged", sh.make_mesh((4, 1)),
        cfg.replace(engine=engine, **json.loads(sys.argv[8])))
mesh = sh.make_mesh((2, 2))
first = run("resume_first", mesh, cfg.replace(engine="scan"))
run("resume", mesh, cfg.replace(engine="scan"), film=first)
run("uneven6", mesh, cfg.replace(engine="scan", spp=6))
try:
    sh.render_film_distributed(sd, ds.camera, cfg.replace(spp=6), sh.make_mesh((1, 4)))
    meta["spp6_over_4"] = "rendered"
except ValueError as e:
    meta["spp6_over_4"] = "ValueError: " + str(e)
from jaderaytracerendering_tpu_torch.core.camera import camera_tensors
eye, rot = camera_tensors(ds.camera, "cpu")
ids = torch.arange(64)
for shape, sppb in (((4, 1), 2), ((2, 2), 1)):
    mesh = sh.make_mesh(shape)
    shard = sh.render_batch_sharded(sd, eye, rot, ids, 0, cfg, sppb, mesh)
    films[f"batch_shard_{shape[0]}x{shape[1]}"] = shard.numpy()
    films[f"batch_film_{shape[0]}x{shape[1]}"] = sh.gather_film(shard, mesh).numpy()
try:
    sh.render_batch_sharded(sd, eye, rot, ids[:63], 0, cfg, 1, sh.make_mesh((4, 1)))
    meta["63_ids_over_4"] = "rendered"
except ValueError as e:
    meta["63_ids_over_4"] = "ValueError: " + str(e)
np.savez(f"{out}/rank{rank}.npz", **films)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(meta, f)
torch.distributed.destroy_process_group()
"""


def _start_workers(tmp):
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    args = [json.dumps(SIZE), json.dumps(MESHES), json.dumps(ENGINES), json.dumps(RAGGED)]
    return [subprocess.Popen([sys.executable, str(worker), str(r), str(WORLD),
                              str(tmp / "rendezvous"), str(tmp)] + args,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=tmp)
            for r in range(WORLD)]


def _jax_films():
    """The JAX package's distributed scan film at each mesh shape, on the
    8-device CPU mesh of tests/conftest.py -> {shape: mean film}."""
    ds = jdemo.tiny_scene()
    sd = jassemble(ds.objects, ds.env_map, xp=jnp, bvh_backend="numpy")
    cfg = JConfig(**SIZE, engine="scan")
    return {shape: np.asarray(jsh.render_film_distributed(
        sd, ds.camera, cfg, jsh.make_mesh(shape)).mean()) for shape in MESHES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 4 ranks, renders the JAX films while they run, then
    reads every rank's films -> (ranks [(films, meta)], JAX films)."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs = _start_workers(tmp)
    try:
        jax_films = _jax_films()
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for r in range(WORLD):
        films = dict(np.load(tmp / f"rank{r}.npz"))
        ranks.append((films, json.loads((tmp / f"rank{r}.json").read_text())))
    return ranks, jax_films


@pytest.fixture(scope="module")
def single():
    """The port's single-device films on the CPU -> {(engine, spp): (accum,
    rays)}."""
    ds = tdemo.tiny_scene()
    sd = tscene.assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")
    out = {}
    for engine, spp in [(e, 4) for e in ENGINES] + [("scan", 8), ("scan", 6)]:
        stats = {}
        f = trender.render_film(sd, ds.camera, TConfig(**SIZE).replace(engine=engine, spp=spp),
                                stats=stats)
        out[engine, spp] = (f.accum.numpy(), stats["rays"])
    for engine in ("scan", "mega"):
        stats = {}
        f = trender.render_film(sd, ds.camera, TConfig(**SIZE, engine=engine).replace(**RAGGED),
                                stats=stats)
        out[engine, "ragged"] = (f.accum.numpy(), stats["rays"])
    return out


def _key(engine, shape):
    return f"{engine}_{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("height", ["8", "ragged"])
@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_tile_only_mesh_is_bit_equal_to_one_device(runs, single, engine, height):
    """The 4x1 mesh's film (rows dealt round-robin) equals the one-device
    film bit for bit, at 8 rows and at 11 (ranks of 3, 3, 3 and 2 rows)."""
    films, meta = runs[0][0]
    key = _key(engine, (4, 1)) + ("_ragged" if height == "ragged" else "")
    accum, rays = single[engine, 4 if height == "8" else "ragged"]
    assert films[key].shape == accum.shape
    np.testing.assert_array_equal(films[key], accum)
    assert meta[key]["rays"] == rays


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("engine", ENGINES)
def test_mesh_matches_one_device(runs, single, engine, shape):
    films, meta = runs[0][0]
    m = meta[_key(engine, shape)]
    accum, rays = single[engine, 4]
    assert m["count"] == 4 and m["backend"] == "gloo"
    np.testing.assert_allclose(films[_key(engine, shape)] / 4, accum / 4, rtol=RTOL, atol=ATOL)
    assert m["rays"] == rays


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scan_matches_jax_distributed(runs, shape):
    films, _ = runs[0][0]
    np.testing.assert_allclose(films[_key("scan", shape)] / 4, runs[1][shape],
                               rtol=RTOL, atol=ATOL)


def test_every_rank_holds_the_same_film(runs):
    (films0, meta0), *rest = runs[0]
    coords = {tuple(meta0["scan_2x2"]["coords"])}
    for films, meta in rest:
        assert films.keys() == films0.keys()
        for k in films0:
            if k.startswith("batch_shard"):  # a rank's own tile shard
                continue
            np.testing.assert_array_equal(films[k], films0[k], err_msg=k)
            if k in meta0:
                assert (meta[k]["count"], meta[k]["rays"]) == (meta0[k]["count"],
                                                               meta0[k]["rays"])
        coords.add(tuple(meta["scan_2x2"]["coords"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}  # row-major, as JAX's reshape


def test_resume_equals_a_straight_render(runs, single):
    films, meta = runs[0][0]
    assert meta["resume_first"]["count"] == 4 and meta["resume"]["count"] == 8
    np.testing.assert_allclose(films["resume"] / 8, single["scan", 8][0] / 8,
                               rtol=RTOL, atol=ATOL)


def test_scan_over_the_spp_axis_in_uneven_batch_steps(runs, single):
    """6 spp over an spp axis of 2: each spp rank renders its 3 samples in
    steps of 2 and 1 (spp_batch 2); the film equals one device's."""
    films, meta = runs[0][0]
    assert meta["uneven6"]["count"] == 6
    np.testing.assert_allclose(films["uneven6"] / 6, single["scan", 6][0] / 6,
                               rtol=RTOL, atol=ATOL)


def test_spp_must_divide_by_the_spp_axis(runs):
    for _, meta in runs[0]:
        assert meta["spp6_over_4"].startswith("ValueError: spp 6 must divide")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_render_batch_sharded_and_gather_film(runs, shape):
    """One sharded step over 64 pixel ids, 2 samples a pixel (sppb 2 on a
    4x1 mesh, 1 a rank on 2x2): each rank's tile shard holds its rows,
    ``gather_film`` gives every rank the whole [64, 3] film, equal bit for
    bit to one ``render_batch`` of the ids (two ranks' sums of one sample
    each add as the one-device sum adds them); 63 ids do not split over
    4 tiles."""
    ds = tdemo.tiny_scene()
    sd = tscene.assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")
    eye, rot = (torch.tensor(v, dtype=torch.float32) for v in (ds.camera.eye,
                                                               ds.camera.camera_rotate))
    want, _ = trender.render_batch(sd, eye, rot, torch.arange(64), 0, TConfig(**SIZE), 2)
    key = f"{shape[0]}x{shape[1]}"
    k = 64 // shape[0]
    for films, meta in runs[0]:
        t = meta[f"scan_{key}"]["coords"][0]
        assert films[f"batch_shard_{key}"].shape == (k, 3)
        np.testing.assert_array_equal(films[f"batch_shard_{key}"], want[t * k:(t + 1) * k])
        np.testing.assert_array_equal(films[f"batch_film_{key}"], want)
        assert meta["63_ids_over_4"].startswith("ValueError: 63 pixel ids")


def test_multislice_grid_matches_jax_layout(monkeypatch):
    """2 nodes of 4 ranks: the JAX function's device grid (sharding.py:98-104,
    fake devices with their process index) against the port's rank grid;
    tile within a node, spp across nodes."""
    fake = [types.SimpleNamespace(id=r, process_index=r // 4) for r in range(8)]
    monkeypatch.setattr(jax, "devices", lambda: fake)
    monkeypatch.setattr(jsh, "Mesh", lambda devs, names: devs)
    for tile, spp in [(None, 1), (2, 2), (1, 4)]:
        want = np.vectorize(lambda d: d.id)(jsh.make_multislice_mesh(tile, spp))
        got = tsh.multislice_grid(8, 4, tile, spp)
        np.testing.assert_array_equal(got, want)
    grid = tsh.multislice_grid(8, 4)
    assert grid.shape == (4, 2) and all(len({r // 4 for r in row}) == 2 for row in grid)
    with pytest.raises(ValueError):
        tsh.multislice_grid(8, 4, tile=3)


def test_one_process_mesh_runs_without_a_group(single):
    """Outside torch.distributed a (1, 1) mesh renders the single-device
    film bit for bit; a larger one is refused."""
    ds = tdemo.tiny_scene()
    sd = tscene.assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")
    mesh = tsh.make_mesh()
    assert mesh.shape == {"tile": 1, "spp": 1}
    film = tsh.render_film_distributed(sd, ds.camera, TConfig(**SIZE, engine="mega"), mesh)
    np.testing.assert_array_equal(film.accum.numpy(), single["mega", 4][0])
    with pytest.raises(ValueError, match="integrator"):
        tsh.render_film_distributed(sd, ds.camera, TConfig(**SIZE, integrator="preview"), mesh)
    with pytest.raises(ValueError):
        tsh.make_mesh((2, 1))
