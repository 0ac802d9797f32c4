"""Multi-device rendering over ``torch.distributed``: film tiles x samples.

The JAX package's parallel/sharding.py runs one controller over a device
mesh with ``shard_map`` and ``psum``. Here each rank is a process with one
device, and the mesh is an explicit ``[tile, spp]`` grid of ranks:

- **film tiles**: tile rank t renders the pixel window [t * shard_px,
  min((t + 1) * shard_px, npix)), shard_px = ceil(npix / n_tile), with no
  communication (the megakernel and the pool take the window directly,
  the scan engine renders its pixel ids);
- **samples**: spp rank s renders the same window at another sample
  offset, and the sums are reduced over the ranks of the tile row.

Both compose in one mesh. Collectives are ``all_reduce`` alone, over a
film-sized buffer: the spp reduction (JAX ``psum('spp')``) is an
``all_reduce`` of the window over the rank's **spp group** (its tile
row); ``gather_film`` (JAX ``all_gather('tile')``) writes the window into
a zero film of ``n_tile * shard_px`` rows and ``all_reduce``s it over the
rank's **tile group** (its spp column), which adds exact zeros and so
changes no bit. This works alike under NCCL and gloo: gloo has
``all_reduce`` for CUDA tensors but no ``all_gather``, and ranks that
share a card cannot use NCCL, which refuses two ranks on one GPU. (When
``stats`` are asked for, one more ``all_reduce`` of a float64 scalar sums
the ranks' useful rays.)

Inside a rank each pixel's samples are summed in ascending order, so a
mesh without an spp axis renders the single-device film bit for bit;
only the spp split sums its halves in another order.

Each rank builds the same scene itself: the native SAH builder is
deterministic. That replaces the JAX package's ``scene_to_global`` and
``host_local_to_global``, which exist because JAX arrays are global.

``make_multislice_mesh`` keeps the tile axis within a node and lays the
spp axis across nodes (a JAX slice is a node here, ``LOCAL_WORLD_SIZE``
ranks), so the film-sized tile traffic stays on the node.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import multiprocessing.connection
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import camera as camera_mod
from ..core.film import Film
from ..utils.config import RenderConfig, check_traversal

AXES = ("tile", "spp")


# ---- process group, devices ------------------------------------------------

def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's rank on its node: ``LOCAL_RANK`` (torchrun, and the
    ranks ``spawn_local`` starts), else its global rank (``process_id``
    before the group exists)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None:
        return int(process_id)
    return int(os.environ.get("RANK", _rank()))


def local_world_size() -> int:
    """The ranks on this node: ``LOCAL_WORLD_SIZE``, else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", _world())))


def rank_device(device: str = "cuda", local_device_ids=None,
                process_id: Optional[int] = None) -> torch.device:
    """The device this rank renders on: the CPU when the caller asks for
    it, else card ``local_device_ids[0]``, by default the local rank
    modulo the cards (ranks share the cards when they outnumber them)."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to render on the CPU")
    idx = int(local_device_ids[0]) if local_device_ids else local_rank(process_id) % n
    return torch.device("cuda", idx)


def choose_backend(device: torch.device) -> str:
    """``nccl`` when every rank of this node has a card of its own, else
    ``gloo``: on the CPU, or where ranks share a card (NCCL refuses two
    ranks on one GPU; the render stays on the card, only the film's
    all_reduce goes through gloo)."""
    if device.type == "cuda" and local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, device: str = "cuda") -> bool:
    """Join the process group: ``dist.init_process_group`` with the
    backend ``choose_backend`` gives for this rank's device, which becomes
    the current CUDA device. ``coordinator_address``: an init method
    (``file://...``, ``tcp://host:port``) or ``host:port``; None reads the
    environment as torchrun sets it (``env://``). Returns True if this call
    initialised the group, False if one already existed (safe to call
    more than once)."""
    dev = rank_device(device, local_device_ids, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        choose_backend(dev), init_method=method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))
    return True


# ---- the mesh --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[tile, spp]`` grid of global ranks and this rank's groups: its
    tile row (``spp_group``, the spp reduction) and its spp column
    (``tile_group``, ``gather_film``). A group of one rank is None and
    its collectives are skipped."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int
    spp_group: object
    tile_group: object

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def coords(self) -> Tuple[int, int]:
        """(tile index, spp index) of this rank."""
        t, s = np.argwhere(self.ranks == self.rank)[0]
        return int(t), int(s)


def _mesh(grid: np.ndarray, axis_names) -> Mesh:
    """The groups of ``grid``. Every rank creates every group, in the same
    order (tile rows, then spp columns), as ``dist.new_group`` requires."""
    world = _world()
    if grid.size != world:
        raise ValueError(f"a mesh of {grid.shape[0]}x{grid.shape[1]} = {grid.size} ranks in a "
                         f"process group of {world}")
    rank = _rank()
    t, s = (int(v) for v in np.argwhere(grid == rank)[0])
    spp_group = tile_group = None
    if grid.shape[1] > 1:
        for i in range(grid.shape[0]):
            g = dist.new_group([int(r) for r in grid[i]])
            if i == t:
                spp_group = g
    if grid.shape[0] > 1:
        for j in range(grid.shape[1]):
            g = dist.new_group([int(r) for r in grid[:, j]])
            if j == s:
                tile_group = g
    return Mesh(grid, tuple(axis_names), rank, spp_group, tile_group)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = AXES) -> Mesh:
    """The mesh of every rank, laid out row-major as JAX's
    ``reshape(devices, shape)``. Default: all ranks on the 'tile' axis."""
    if shape is None:
        shape = (_world(), 1)
    shape = tuple(int(v) for v in shape) + (1,) * (len(axis_names) - len(shape))
    return _mesh(np.arange(int(np.prod(shape))).reshape(shape), axis_names)


def multislice_grid(world: int, per_node: int, tile: Optional[int] = None,
                    spp_per_slice: int = 1) -> np.ndarray:
    """The ``[tile, spp]`` rank grid of ``make_multislice_mesh`` for
    ``world`` ranks, ``per_node`` a node (node n holds ranks n * per_node
    .. as torchrun numbers them): 'tile' within a node, 'spp' across nodes
    (times ``spp_per_slice`` within one), as JAX sharding.py:98-104."""
    if world % per_node:
        raise ValueError(f"{world} ranks in nodes of {per_node}: uneven nodes")
    if per_node % spp_per_slice:
        raise ValueError("spp_per_slice must divide the ranks of a node")
    if tile is None:
        tile = per_node // spp_per_slice
    if tile * spp_per_slice != per_node:
        raise ValueError("tile * spp_per_slice != the ranks of a node")
    return np.concatenate([np.arange(n * per_node, (n + 1) * per_node)
                           .reshape(tile, spp_per_slice)
                           for n in range(world // per_node)], axis=1)


def make_multislice_mesh(tile: Optional[int] = None, spp_per_slice: int = 1,
                         axis_names: Sequence[str] = AXES) -> Mesh:
    """The mesh over several nodes (``multislice_grid``): tile within a
    node, spp across nodes, so only the spp reduction crosses nodes. In
    one node it degenerates to ``make_mesh((tile, spp_per_slice))``."""
    return _mesh(multislice_grid(_world(), local_world_size(), tile, spp_per_slice),
                 axis_names)


# ---- collectives -----------------------------------------------------------

class _Clock:
    """Time, calls and bytes of the film's all_reduce calls: CUDA events on
    the card (read once, at the end), the host clock on the CPU. The time
    includes waiting for the slowest rank of the group."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events = []
        self.host_s = 0.0
        self.calls = 0
        self.bytes = 0

    @contextlib.contextmanager
    def span(self, t: torch.Tensor):
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            yield
            b.record()
            self.events.append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.host_s += time.perf_counter() - t0
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def ms(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return float(sum(a.elapsed_time(b) for a, b in self.events))
        return self.host_s * 1e3


def _all_reduce(t: torch.Tensor, group, clock: Optional[_Clock] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing for a group of one)."""
    if group is None:
        return t
    with (clock.span(t) if clock else contextlib.nullcontext()):
        dist.all_reduce(t, group=group)
    return t


def gather_film(local: torch.Tensor, mesh: Mesh, clock: Optional[_Clock] = None
                ) -> torch.Tensor:
    """The full film from tile shards: this rank's shard ``local`` [k, C]
    is rows t*k .. of a zero film [n_tile * k, C], summed over the tile
    group (exact: one rank holds each row) -> the film on every rank."""
    n_tile = mesh.shape["tile"]
    if n_tile == 1:
        return local
    k = local.shape[0]
    t, _ = mesh.coords
    buf = torch.zeros((n_tile * k,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    buf[t * k:(t + 1) * k] = local
    return _all_reduce(buf, mesh.tile_group, clock)


def _finish_stats(stats: Optional[dict], rays: float, clock: _Clock,
                  device: torch.device) -> None:
    """The mesh's useful rays (summed over every rank) and this rank's
    all_reduce figures into ``stats``."""
    if stats is None:
        return
    total = torch.tensor([rays], dtype=torch.float64, device=device)
    if _world() > 1:
        dist.all_reduce(total)
    stats["rays"] = stats.get("rays", 0.0) + float(total[0])
    stats["allreduce_ms"] = stats.get("allreduce_ms", 0.0) + clock.ms()
    stats["allreduce_calls"] = stats.get("allreduce_calls", 0) + clock.calls
    stats["allreduce_bytes"] = stats.get("allreduce_bytes", 0) + clock.bytes
    stats["backend"] = dist.get_backend() if dist.is_initialized() else None


# ---- sharded renders -------------------------------------------------------

def _render_ids(sd, eye, rot, ids: torch.Tensor, out: torch.Tensor, sample_base: int,
                cfg: RenderConfig, sppb: int) -> float:
    """The scan engine over arbitrary pixel ids, chunked as
    ``render.render_window``: adds the sums into ``out`` -> useful rays."""
    from ..integrator.render import SCAN_LANES, render_batch

    chunk = max(1, SCAN_LANES // sppb)
    rays = 0.0
    for c0 in range(0, ids.shape[0], chunk):
        rad, n = render_batch(sd, eye, rot, ids[c0:c0 + chunk], sample_base, cfg, sppb)
        out[c0:c0 + rad.shape[0]] += rad
        rays += float(n.sum())
    return rays


def render_batch_sharded(sd, eye, rot, pixel_ids, sample_base: int, cfg: RenderConfig,
                         sppb: int, mesh: Mesh) -> torch.Tensor:
    """One sharded render step: ``pixel_ids`` split over 'tile' (its length
    must divide by the tile axis), ``sppb`` samples a rank, spp rank s
    taking samples ``sample_base + s * sppb ..`` -> this rank's tile shard
    of the radiance sums [len / n_tile, 3], reduced over 'spp'."""
    n_tile = mesh.shape["tile"]
    p = int(pixel_ids.shape[0])
    if p % n_tile:
        raise ValueError(f"{p} pixel ids do not split over a tile axis of {n_tile}")
    k = p // n_tile
    t, s = mesh.coords
    ids = pixel_ids[t * k:(t + 1) * k].to(device=sd.device, dtype=torch.int64)
    out = torch.zeros((k, 3), dtype=torch.float32, device=sd.device)
    _render_ids(sd, eye, rot, ids, out, int(sample_base) + s * sppb, cfg, sppb)
    return _all_reduce(out, mesh.spp_group)


def _window(npix: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(shard_px, first pixel, pixels) of this rank's tile window."""
    shard = -(-npix // mesh.shape["tile"])
    t, _ = mesh.coords
    p0 = min(t * shard, npix)
    return shard, p0, min(shard, npix - p0)


def _check(cfg: RenderConfig, mesh: Mesh) -> None:
    check_traversal(cfg.traversal)
    if cfg.integrator != "full":
        raise ValueError(f"integrator {cfg.integrator!r} over a mesh: only 'full' renders "
                         "distributed")
    n_spp = mesh.shape["spp"]
    if cfg.spp % n_spp:
        raise ValueError(f"spp {cfg.spp} must divide by the mesh's spp axis {n_spp}")


def _film_from_window(acc: torch.Tensor, shard: int, cfg: RenderConfig, mesh: Mesh,
                      clock: _Clock) -> torch.Tensor:
    """This rank's window sums [n_px, 3] -> the full film [H, W, 3]."""
    npix = cfg.width * cfg.height
    if acc.shape[0] < shard and mesh.shape["tile"] > 1:  # the ragged last window
        acc = torch.cat([acc, acc.new_zeros((shard - acc.shape[0], 3))])
    return gather_film(acc, mesh, clock)[:npix].reshape(cfg.height, cfg.width, 3)


def _render_film_windows(window_fn, sd, cam, cfg: RenderConfig, mesh: Mesh,
                         film: Optional[Film], stats: Optional[dict]) -> Film:
    """A window engine over the mesh: spp rank s renders cfg.spp / n_spp
    samples from ``film.count + s * spp_local`` of its tile window through
    ``window_fn(sd, cam, cfg, acc, pix0, sample_base, spp) -> rays``; the
    new sums are reduced over 'spp', added to the film's window and
    gathered."""
    _check(cfg, mesh)
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    n_spp = mesh.shape["spp"]
    _, s = mesh.coords
    spp_local = cfg.spp // n_spp
    shard, p0, n_px = _window(cfg.width * cfg.height, mesh)
    clock = _Clock(sd.device)
    win = film.accum.reshape(-1, 3)[p0:p0 + n_px]
    if n_spp == 1:  # as the single-device engine: the samples added to the film in order
        acc = win.clone()
        rays = window_fn(sd, cam, cfg, acc, p0, film.count, cfg.spp)
    else:
        new = torch.zeros_like(win)
        rays = window_fn(sd, cam, cfg, new, p0, film.count + s * spp_local, spp_local)
        acc = win + _all_reduce(new, mesh.spp_group, clock)
    accum = _film_from_window(acc, shard, cfg, mesh, clock)
    _finish_stats(stats, rays, clock, sd.device)
    return Film(accum, film.count + cfg.spp)


def render_film_mega_distributed(sd, cam, cfg: RenderConfig, mesh: Mesh,
                                 film: Optional[Film] = None,
                                 stats: Optional[dict] = None) -> Film:
    """The megakernel over the mesh: each tile rank renders its window
    (``integrator/mega.render_window_mega``), spp ranks disjoint sample
    ranges of it, reduced over 'spp'."""
    from ..integrator import mega as mega_mod

    return _render_film_windows(mega_mod.render_window_mega, sd, cam, cfg, mesh, film, stats)


def _pool_window(sd, cam, cfg, acc, pix0, sample_base, spp) -> float:
    from ..integrator import pool as pool_mod

    return pool_mod.render_window_pool(sd, cam, cfg, acc, pix0, sample_base, spp)[0]


def _render_film_scan(sd, cam, cfg: RenderConfig, mesh: Mesh, film: Optional[Film],
                      stats: Optional[dict]) -> Film:
    """The scan engine over the mesh, in passes of n_spp * sppb samples,
    the last pass clamped so that exactly cfg.spp samples are rendered."""
    from ..integrator.render import render_window

    _check(cfg, mesh)
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    n_spp = mesh.shape["spp"]
    _, s = mesh.coords
    shard, p0, n_px = _window(cfg.width * cfg.height, mesh)
    eye, rot = camera_mod.camera_tensors(cam, sd.device)
    clock = _Clock(sd.device)
    acc = film.accum.reshape(-1, 3)[p0:p0 + n_px].clone()
    sppb = max(1, min(cfg.spp_batch, cfg.spp // n_spp))
    rays = 0.0
    done = 0
    while done < cfg.spp:
        # the rest stays a multiple of n_spp, so the clamp never reaches 0
        step = min(sppb, (cfg.spp - done) // n_spp)
        base = film.count + done + s * step
        if n_spp == 1:
            rays += render_window(sd, eye, rot, acc, p0, base, cfg, step)
        else:
            new = torch.zeros_like(acc)
            rays += render_window(sd, eye, rot, new, p0, base, cfg, step)
            acc += _all_reduce(new, mesh.spp_group, clock)
        done += step * n_spp
    accum = _film_from_window(acc, shard, cfg, mesh, clock)
    _finish_stats(stats, rays, clock, sd.device)
    return Film(accum, film.count + done)


def render_film_distributed(sd, cam, cfg: RenderConfig, mesh: Mesh,
                            film: Optional[Film] = None,
                            stats: Optional[dict] = None) -> Film:
    """The film over the mesh, film tiles over 'tile' and samples over
    'spp', routed by engine: ``mega`` (``render_film_mega_distributed``),
    ``pool`` (a private queue a tile window) or ``scan`` (passes of n_spp *
    sppb samples). Returns the full film on every rank. Raises
    ``ValueError`` when cfg.spp does not divide by the spp axis, and for
    any integrator but 'full' (the JAX function renders NEE on its scan
    route whatever ``cfg.integrator`` asks). ``stats``, when given,
    receives ``rays`` (the mesh's useful rays), this rank's
    ``allreduce_ms``/``allreduce_calls``/``allreduce_bytes`` (the film's
    all_reduce calls) and ``backend``."""
    if cfg.engine == "mega":
        return render_film_mega_distributed(sd, cam, cfg, mesh, film, stats)
    if cfg.engine == "pool":
        return _render_film_windows(_pool_window, sd, cam, cfg, mesh, film, stats)
    if cfg.engine == "scan":
        return _render_film_scan(sd, cam, cfg, mesh, film, stats)
    raise ValueError(f"unknown engine {cfg.engine!r}")


# ---- ranks on this node ----------------------------------------------------

def _rank_entry(rank: int, world: int, init_file: str, device: str, target: str, args,
                out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    init_distributed(f"file://{init_file}", world, rank, device=device)
    try:
        mod, name = target.split(":")
        result = getattr(importlib.import_module(mod), name)(*args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_local(target: str, world: int, args=(), device: str = "cuda") -> list:
    """Run ``target`` (``"module:function"``) on ``world`` ranks of this
    node, each a process started by ``torch.multiprocessing`` (spawn) that
    joins a group through a ``file://`` rendezvous (``init_distributed``)
    and calls ``function(*args)``. Returns each rank's JSON-able result, in
    rank order. A rank that fails stops the others and raises
    ``RuntimeError``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="jade-ranks-")
    try:
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, os.path.join(tmp, "rendezvous"), device,
                                   target, args, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            while True:
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0][0]} of {world} failed with exit code "
                                       f"{failed[0][1]}")
                alive = [p for p in procs if p.exitcode is None]
                if not alive:
                    break
                multiprocessing.connection.wait([p.sentinel for p in alive], timeout=1.0)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
