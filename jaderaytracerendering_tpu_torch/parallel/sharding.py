"""Multi-device rendering over ``torch.distributed``: film tiles x samples.

The JAX package's parallel/sharding.py runs one controller over a device
mesh with ``shard_map`` and ``psum``. Here each rank is a process with one
device, and the mesh is an explicit ``[tile, spp]`` grid of ranks:

- **film tiles**: the film's rows are dealt round-robin: tile rank t
  renders rows t, t + n_tile, t + 2 n_tile, .. < H (``ceil((H - t) /
  n_tile)`` rows, so any height splits), with no communication, in one
  call of the engine's window function (integrator/render.py ``ENGINES``,
  a window of whole rows ``n_tile`` apart). Neighbouring rows cost nearly
  the same, so each rank carries ~1/n_tile of every region's cost (the
  statue's rows too) for any camera and scene, with no estimate of a
  row's cost; contiguous row tiles left one rank the statue while the
  others waited;
- **samples**: spp rank s renders the same rows at another sample
  offset, and the sums are reduced over the ranks of the tile row.

Both compose in one mesh. Collectives are ``all_reduce`` alone, over a
film-sized buffer: the spp reduction (JAX ``psum('spp')``) is an
``all_reduce`` of the window over the rank's **spp group** (its tile
row); the film's gather writes the rank's rows into a zero film at rows
t::n_tile and ``all_reduce``s it over the rank's **tile group** (its spp
column), which adds exact zeros and so changes no bit. This works alike
under NCCL and gloo: gloo has ``all_reduce`` for CUDA tensors but no
``all_gather``, and ranks that share a card cannot use NCCL, which
refuses two ranks on one GPU. (When ``stats`` are asked for, one more
``all_reduce`` of a float64 vector sums the ranks' useful rays and
carries each rank's window time to every rank.) ``gather_film`` and
``render_batch_sharded`` keep the JAX package's contiguous layout (tile
t holds shard rows t*k ..; JAX ``all_gather('tile')``), which a caller of
a sharded step over its own ``pixel_ids`` expects.

Under a profiler (``utils/logging.py``) each rank records the span
``parallel.sharding.window`` around the render of its tile window and
``parallel.sharding.all_reduce`` around each film ``all_reduce``, the
wait for the group's slowest rank included; rank 0 counts
``parallel.tile_rows`` (its window's film rows, each image: the layout in
force), ``parallel.tile_us_max`` (the slowest rank's window, in us, each
image), ``parallel.tile_us_sum`` (every rank's) and
``parallel.tile_windows`` (ranks x images).

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
import datetime
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

from ..core.film import Film
from ..integrator import render
from ..utils import logging
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
                     local_device_ids=None, device: str = "cuda",
                     timeout: Optional[float] = None) -> bool:
    """Join the process group: ``dist.init_process_group`` with the
    backend ``choose_backend`` gives for this rank's device, which becomes
    the current CUDA device. ``coordinator_address``: an init method
    (``file://...``, ``tcp://host:port``) or ``host:port``; None reads the
    environment as torchrun sets it (``env://``). ``timeout``: seconds the
    rendezvous and each collective may wait for the other ranks (None:
    torch's default). Returns True if this call initialised the group,
    False if one already existed (safe to call more than once)."""
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
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        choose_backend(dev), init_method=method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id), **extra)
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
    """Time, calls and bytes of the spans it times (the film's all_reduce
    calls, the render of the tile window): CUDA events on the card (read
    once, at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events = []
        self.host_s = 0.0
        self.calls = 0
        self.bytes = 0

    @contextlib.contextmanager
    def span(self, t: Optional[torch.Tensor] = None):
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
        if t is not None:
            self.bytes += t.numel() * t.element_size()

    def ms(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return float(sum(a.elapsed_time(b) for a, b in self.events))
        return self.host_s * 1e3


def _all_reduce(t: torch.Tensor, group, clock: Optional[_Clock] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing for a group of one),
    waiting for the sum (on the card: for the device's stream), so that the
    time covers the wait for the group's slowest rank."""
    if group is None:
        return t
    with logging.span("parallel.sharding.all_reduce"), \
            (clock.span(t) if clock else contextlib.nullcontext()):
        dist.all_reduce(t, group=group)
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
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


def _finish_stats(stats: Optional[dict], rays: float, clock: _Clock, window: _Clock,
                  device: torch.device) -> None:
    """Into ``stats``: the mesh's useful rays (summed over every rank),
    each rank's window ms, and this rank's all_reduce figures. One
    all_reduce of [rays, us_0, .., us_{n-1}] (float64), in which rank r
    puts its window's whole us in slot r; rank 0 counts the tiles
    (``parallel.tile_*``, the module's docstring)."""
    if stats is None:
        return
    world, rank = _world(), _rank()
    vec = [rays] + [0.0] * world
    vec[1 + rank] = float(round(window.ms() * 1e3))
    total = torch.tensor(vec, dtype=torch.float64, device=device)
    if world > 1:
        dist.all_reduce(total)
    rays_all, *us = total.tolist()
    stats["rays"] = stats.get("rays", 0.0) + rays_all
    before = stats.get("window_ms", [0.0] * world)
    stats["window_ms"] = [b + u / 1e3 for b, u in zip(before, us)]
    if rank == 0:
        logging.count("parallel.tile_us_max", int(max(us)))
        logging.count("parallel.tile_us_sum", int(sum(us)))
        logging.count("parallel.tile_windows", world)
    stats["allreduce_ms"] = stats.get("allreduce_ms", 0.0) + clock.ms()
    stats["allreduce_calls"] = stats.get("allreduce_calls", 0) + clock.calls
    stats["allreduce_bytes"] = stats.get("allreduce_bytes", 0) + clock.bytes
    stats["backend"] = dist.get_backend() if dist.is_initialized() else None


def tile_imbalance_pct(window_ms: Sequence[float]) -> float:
    """How far the slowest rank's window sets the image's pace: 100 x
    (max x ranks / sum - 1); 0 when every window takes the same time."""
    total = sum(window_ms)
    return 100.0 * (max(window_ms) * len(window_ms) / total - 1.0) if total > 0 else 0.0


# ---- sharded renders -------------------------------------------------------

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
    render.render_ids(sd, eye, rot, ids, out, int(sample_base) + s * sppb, cfg, sppb)
    return _all_reduce(out, mesh.spp_group)


def _window(height: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(first row, rows, row step) of this rank's tile window: tile rank t
    of n_tile takes the film rows t, t + n_tile, .. < ``height``."""
    n_tile = mesh.shape["tile"]
    t, _ = mesh.coords
    return t, len(range(t, height, n_tile)), n_tile


def _check(cfg: RenderConfig, mesh: Mesh) -> None:
    check_traversal(cfg.traversal)
    if cfg.integrator != "full":
        raise ValueError(f"integrator {cfg.integrator!r} over a mesh: only 'full' renders "
                         "distributed")
    n_spp = mesh.shape["spp"]
    if cfg.spp % n_spp:
        raise ValueError(f"spp {cfg.spp} must divide by the mesh's spp axis {n_spp}")


@contextlib.contextmanager
def _window_span(timer: _Clock):
    """The render of this rank's tile window: the span
    ``parallel.sharding.window``, timed by ``timer``."""
    with logging.span("parallel.sharding.window"), timer.span():
        yield


def _film_from_window(acc: torch.Tensor, cfg: RenderConfig, mesh: Mesh,
                      clock: _Clock) -> torch.Tensor:
    """This rank's window sums [rows * W, 3] -> the full film [H, W, 3]:
    its rows written at rows t::n_tile of a zero film, summed over the
    tile group (exact: one rank holds each row)."""
    rows = acc.reshape(-1, cfg.width, 3)
    n_tile = mesh.shape["tile"]
    if n_tile == 1:
        return rows
    t, _ = mesh.coords
    film = rows.new_zeros((cfg.height, cfg.width, 3))
    film[t::n_tile] = rows
    return _all_reduce(film, mesh.tile_group, clock)


def render_film_distributed(sd, cam, cfg: RenderConfig, mesh: Mesh,
                            film: Optional[Film] = None,
                            stats: Optional[dict] = None) -> Film:
    """The film over the mesh, film rows dealt over 'tile' and samples over
    'spp': spp rank s renders cfg.spp / n_spp samples from ``film.count +
    s * cfg.spp / n_spp`` of its tile window (the rows t, t + n_tile, ..)
    in one call of the engine's window function (``render.window_fn``);
    the new sums are reduced over 'spp', added to the film's rows and
    gathered. Returns the full film on every rank. Raises ``ValueError``
    when cfg.spp does not divide by the spp axis, for an unknown engine,
    and for any integrator but 'full' (the JAX function renders NEE on its
    scan route whatever ``cfg.integrator`` asks). ``stats``, when given,
    receives ``rays`` (the mesh's useful rays), ``window_ms`` (each rank's
    render of its tile window, by global rank: device time on the card,
    the host clock on the CPU), this rank's
    ``allreduce_ms``/``allreduce_calls``/``allreduce_bytes`` (the film's
    all_reduce calls) and ``backend``. Every rank of the group passes
    ``stats`` or none does: it adds one collective."""
    _check(cfg, mesh)
    window = render.window_fn(cfg.engine)
    if film is None:
        film = Film.create(cfg.height, cfg.width, sd.device)
    n_spp = mesh.shape["spp"]
    _, s = mesh.coords
    spp_local = cfg.spp // n_spp
    row0, rows, step = _window(cfg.height, mesh)
    if _rank() == 0:
        logging.count("parallel.tile_rows", rows)
    clock, timer = _Clock(sd.device), _Clock(sd.device)
    win = film.accum[row0::step].reshape(-1, 3)
    pix0 = row0 * cfg.width
    if n_spp == 1:  # as the single-device engine: the samples added to the film in order
        acc = win.clone()
        with _window_span(timer):
            rays = window(sd, cam, cfg, acc, pix0, film.count, cfg.spp, row_step=step)
    else:
        new = torch.zeros_like(win)
        with _window_span(timer):
            rays = window(sd, cam, cfg, new, pix0, film.count + s * spp_local, spp_local,
                          row_step=step)
        acc = win + _all_reduce(new, mesh.spp_group, clock)
    accum = _film_from_window(acc, cfg, mesh, clock)
    _finish_stats(stats, rays, clock, timer, sd.device)
    return Film(accum, film.count + cfg.spp)


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
