"""The offline renderer tiled over one node's cards: a closed loop with
one client, each job one image of the traffic's film size and samples
per pixel into a fresh film, split over the configuration's ``mesh``
[tile, spp] of ranks, one a device, as the render CLI's ``--mesh
TILExSPP`` splits it (``parallel.sharding.render_film_distributed``, the
program's own multi-device path), and finished to u8 on rank 0's card as
the CLI's rank 0 finishes it (``finalize(film.mean(), flip=True)``).
Image k draws its samples under ``seeds.derive(seed, "image", k)``.

Rank 0 is the run's own process on its device, with the scene the run
built. ``warm_up`` starts the other ranks: daemonic processes (spawn),
each of which builds the same scene from the configuration (the native
SAH builder is deterministic) and joins the group through
``sharding.init_distributed`` (a ``file://`` rendezvous, every wait
bounded by ``GROUP_TIMEOUT_S``). Each image, rank 0 broadcasts its render
seed, or ``STOP``, and every rank renders its tile window; the film's
all_reduce leaves the whole film on every rank. A rank that ends before
the stop ends the run with exit code 1 (a watcher thread on rank 0), so
a run never waits on a dead rank.

``keep`` stops the ranks, so that a run ends with them joined, then
renders each kept image again on rank 0's device alone
(``render.render_film``) and keeps ``single_card_off_share``: the share of
film values in which the mesh's film differs from the one-device film
(a mesh without an spp axis renders that film bit for bit). The compared
pixels, the reference and their comparison are the offline client's.

This client and its ranks import ``parallel.sharding`` of the program
besides what ``benchmark/program.py`` gives."""

from __future__ import annotations

import json
import multiprocessing
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from .. import program, seeds
from . import offline

GROUP_TIMEOUT_S = 120.0  # the longest a rank waits for another, in the rendezvous or a collective
STOP = -1
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _rank_env(rank: int, world: int) -> dict:
    """The environment of rank ``rank`` of a group on one node, as
    torchrun sets it (``sharding.choose_backend`` reads the node's ranks)."""
    return dict(zip(_ENV, map(str, (rank, world, rank, world))))


def _camera(config: dict):
    c = config["camera"]
    return program.OrbitCamera(up_angle=c["up_deg"], rotate_angle=c["rotate_deg"], r=c["r"])


def _broadcast(value: int, device) -> int:
    """Rank 0's ``value`` on every rank (the other ranks' is overwritten)."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


def _comm_device(device: torch.device) -> torch.device:
    """Where the broadcast's tensor lives: NCCL takes the rank's card,
    gloo the host."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def _worker(rank: int, world: int, init: str, config: dict, settings: dict, device: str,
            out_dir: str) -> None:
    """Rank ``rank`` (1 ..): build the scene, join the group, then render
    the image of each seed rank 0 sends until ``STOP``."""
    t0 = time.perf_counter()
    os.environ.update(_rank_env(rank, world))
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    from jaderaytracerendering_tpu_torch.parallel import sharding

    from .. import scene

    phases = {"imports": time.perf_counter() - t0}
    dev = sharding.rank_device(device)
    t = time.perf_counter()
    raw = scene.make(config["scene"])
    phases["scene_make"] = time.perf_counter() - t
    t = time.perf_counter()
    program.load_libraries(dev)
    sd = program.build_scene(raw, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases["scene_build"] = time.perf_counter() - t
    t = time.perf_counter()
    sharding.init_distributed(init, world, rank, device=device, timeout=GROUP_TIMEOUT_S)
    mesh = sharding.make_mesh(tuple(config["mesh"]))
    phases["join"] = time.perf_counter() - t
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(phases, f)
    cfg, cam, comm = program.render_config(settings), _camera(config), _comm_device(dev)
    while (seed := _broadcast(STOP, comm)) != STOP:
        sharding.render_film_distributed(sd, cam, cfg.replace(seed=seed), mesh, stats={})
    dist.destroy_process_group()


class Client(offline.Client):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.world = ctx.config["mesh"][0] * ctx.config["mesh"][1]
        self.mesh = None
        self.workers = []
        self.tile_ms, self.gather_ms = [], []

    # ---- the ranks ----------------------------------------------------------

    def _up(self) -> None:
        """Start ranks 1 .. world-1 and join the group as rank 0."""
        from jaderaytracerendering_tpu_torch.parallel import sharding

        self.tmp = tempfile.mkdtemp(prefix="jade-mesh-")
        init = f"file://{os.path.join(self.tmp, 'rendezvous')}"
        kind = self.ctx.device.type
        spawn = multiprocessing.get_context("spawn")
        self.workers = [spawn.Process(target=_worker, name=f"mesh-rank{r}", daemon=True,
                                      args=(r, self.world, init, self.ctx.config,
                                            self.ctx.settings, kind, self.tmp))
                        for r in range(1, self.world)]
        for p in self.workers:
            p.start()
        print(f"mesh: ranks 1-{self.world - 1} pids "
              f"{json.dumps([p.pid for p in self.workers])}", file=sys.stderr, flush=True)
        self.stopping = threading.Event()
        threading.Thread(target=self._watch, name="mesh-watch", daemon=True).start()
        self.env = {k: os.environ.get(k) for k in _ENV}
        os.environ.update(_rank_env(0, self.world))
        t0 = time.perf_counter()
        sharding.init_distributed(init, self.world, 0, device=kind, timeout=GROUP_TIMEOUT_S)
        self.mesh = sharding.make_mesh(tuple(self.ctx.config["mesh"]))
        self.backend = dist.get_backend()
        self.comm = _comm_device(self.ctx.device)
        self.join_s = time.perf_counter() - t0

    def _watch(self) -> None:
        """End the run when a rank ends before ``_down`` stops it: the
        others would wait on it in the next collective."""
        left = {p.sentinel: p for p in self.workers}
        while left:
            for s in multiprocessing.connection.wait(list(left)):
                p = left.pop(s)
                if self.stopping.is_set():
                    continue
                print(f"mesh: {p.name} ended with exit code {p.exitcode} during the run",
                      file=sys.stderr, flush=True)
                for q in self.workers:
                    if q.is_alive():
                        q.kill()
                shutil.rmtree(self.tmp, ignore_errors=True)
                sys.stdout.flush()
                os._exit(1)

    def _down(self) -> None:
        """Stop the ranks, leave the group, and wait for the ranks to end."""
        if self.mesh is None:
            return
        self.stopping.set()
        _broadcast(STOP, self.comm)
        dist.destroy_process_group()
        for p in self.workers:
            p.join(GROUP_TIMEOUT_S)
        failed = [(p.name, p.exitcode) for p in self.workers if p.exitcode != 0]
        for p in self.workers:
            if p.is_alive():
                p.kill()
                p.join()
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.mesh, self.workers = None, []
        if failed:
            raise RuntimeError(f"mesh ranks ended badly: {failed}")

    # ---- the client protocol ------------------------------------------------

    def _image(self, seed: int, stats: dict):
        from jaderaytracerendering_tpu_torch.parallel import sharding

        _broadcast(seed, self.comm)
        mine = {}
        film = sharding.render_film_distributed(self.ctx.sd, self.cam, self.cfg.replace(seed=seed),
                                                self.mesh, stats=mine)
        with torch.profiler.record_function("benchmark.finish"):
            img = program.tonemap.finalize(film.mean(), self.cfg.tonemap, flip=True)
        stats["rays"] = stats.get("rays", 0.0) + mine["rays"]
        self.tile_ms.append(mine["window_ms"])
        self.gather_ms.append(mine["allreduce_ms"])
        return film, img

    def warm_up(self) -> None:
        """Start the ranks and render one image over the mesh; print each
        rank's set-up phases (rank 0's wait in the rendezvous, which
        overlaps the other ranks' scene builds, and theirs)."""
        self._up()
        super().warm_up()
        phases = {"rank0_join": self.join_s}
        for r in range(1, self.world):  # written before the ranks' first image
            with open(os.path.join(self.tmp, f"rank{r}.json")) as f:
                phases[f"rank{r}"] = json.load(f)
        print(f"mesh: {self.world} ranks over {self.backend}; set-up phases "
              f"{json.dumps(phases)}", file=sys.stderr, flush=True)

    def window(self, seconds: float, seed: int):
        if self.mesh is None:  # a window after ``keep`` (benchmark/control.py)
            self._up()
        self.tile_ms, self.gather_ms = [], []
        win = super().window(seconds, seed)
        win.counters.update(backend=self.backend, window_ms=self.tile_ms,
                            allreduce_ms=self.gather_ms)
        return win

    def keep(self, win, seed: int) -> None:
        self._down()
        films = {k: kept[0] for k, kept in win.kept.items() if k != "last"}
        k_last, films[k_last], _ = win.kept["last"]
        shares = {}
        for k, film in films.items():
            one = program.render.render_film(self.ctx.sd, self.cam,
                                             self.cfg.replace(seed=seeds.derive(seed, "image", k)))
            shares[k] = float((one.accum != film.accum).double().mean())
        super().keep(win, seed)
        for k, share in shares.items():
            win.kept["outputs"][k]["single_card_off_share"] = share

    @staticmethod
    def compare(outputs: dict, refs: dict) -> dict:
        """The offline client's numbers, and the worst
        ``single_card_off_share`` of the compared images (the program's
        outputs carry it; the reference's, as the control compares them,
        do not)."""
        numbers = offline.Client.compare(outputs, refs)
        shares = [outputs[k]["single_card_off_share"] for k in refs
                  if "single_card_off_share" in outputs[k]]
        if shares:
            numbers["single_card_off_share"] = max(shares)
        return numbers
