"""Dealt film rows: the tile ranks' windows of ``parallel/sharding.py``
(tile rank t of n_tile renders the film rows t, t + n_tile, ..) and the
engines' windows of whole rows ``row_step`` apart
(``core/film.window_pixels``) against the stride-1 whole-film render.

The window functions run their plain versions on the CPU on the jade
scene (300 statue triangles, camera r 2, 8x8, 4 spp in one step, depth
4). Every render here traces a multiple of 32 lanes (8-pixel rows x 4
samples), so torch's AVX-512 ``pow`` and ``atan2`` take every lane
through their vectorised body in the window and in the whole film alike
(a lane in the scalar tail of one and the body of the other can move a
last bit; the kernels are held bit for bit on the card,
tests/test_torch_cuda.py). The pool runs one lane a sample (its default
lanes, capped at the queue), so each pixel's film adds run in the same
order in both renders.
"""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu_torch.core.film import check_window, window_pixels
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import mega as megak
from jaderaytracerendering_tpu_torch.parallel import sharding as tsh
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=8, height=8, spp=4, spp_batch=4, max_depth=4)


def _mesh(n_tile: int, t: int) -> tsh.Mesh:
    """Tile rank t of an (n_tile, 1) mesh, without a process group."""
    return tsh.Mesh(np.arange(n_tile).reshape(n_tile, 1), tsh.AXES, t, None, None)


@pytest.mark.parametrize("height", [8, 12, 11, 13, 3])
@pytest.mark.parametrize("n_tile", [1, 2, 3, 4])
def test_dealt_rows_cover_every_row_once(n_tile, height):
    """Every film row in exactly one rank's window, rank row counts apart
    by at most one, and each window's slots the pixels of its rows in
    order (heights divisible by n_tile or not, and below it)."""
    width = 5
    dealt, counts = [], []
    for t in range(n_tile):
        row0, rows, step = tsh._window(height, _mesh(n_tile, t))
        assert (row0, step) == (t, n_tile)
        mine = [row0 + k * step for k in range(rows)]
        assert all(r < height for r in mine)
        dealt += mine
        counts.append(rows)
        slots = torch.arange(rows * width)
        want = torch.tensor([r * width + c for r in mine for c in range(width)],
                            dtype=torch.int64)
        assert torch.equal(window_pixels(row0 * width, slots, step, width), want)
        check_window(width, height, row0 * width, rows * width, step)
    assert sorted(dealt) == list(range(height))
    assert max(counts) - min(counts) <= 1


def test_a_window_past_the_film_or_of_part_rows_is_refused():
    check_window(8, 8, 8, 24, 3)  # rows 1, 4, 7
    for pix0, n_px, step in ((8, 32, 3), (4, 16, 2), (0, 12, 2), (0, 8, 0)):
        with pytest.raises(ValueError, match="pixel window"):
            check_window(8, 8, pix0, n_px, step)
    assert window_pixels(21, 30, 1, 8) == 51  # step 1: pix0 + slot, from any pixel


@pytest.fixture(scope="module")
def jade():
    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    return ds, tscene.assemble(ds.objects, ds.env_map, device="cpu")


@pytest.fixture(scope="module")
def whole(jade):
    """The stride-1 whole-film render of each engine -> {engine: (film
    [H, W, 3], useful rays)}, and the megakernel's plain per-pixel rays."""
    ds, st = jade
    out = {}
    for engine in trender.ENGINES:
        stats = {}
        film = trender.render_film(st, ds.camera, TConfig(**SIZE, engine=engine), stats=stats)
        out[engine] = (film.accum, stats["rays"])
    eye, rot = (torch.tensor(v, dtype=torch.float32) for v in (ds.camera.eye,
                                                               ds.camera.camera_rotate))
    out["pixel_rays"] = megak.mega_render(st, eye, rot, TConfig(**SIZE), 0, 4)[3]
    return out


@pytest.mark.parametrize("row_step", [2, 3])
@pytest.mark.parametrize("engine", ["mega", "pool", "scan"])
def test_strided_window_equals_the_whole_film(jade, whole, engine, row_step):
    """Each window of rows t, t + row_step, .. through the engine's window
    function: its sums bit for bit the whole film's rows t::row_step, and
    the useful rays of the windows together the whole film's; each dealt
    pixel's useful rays (the megakernel's plain version, per pixel) the
    whole film's."""
    ds, st = jade
    cfg = TConfig(**SIZE, engine=engine)
    film, rays_whole = whole[engine]
    eye, rot = (torch.tensor(v, dtype=torch.float32) for v in (ds.camera.eye,
                                                               ds.camera.camera_rotate))
    rays = 0.0
    for t in range(row_step):
        rows = len(range(t, cfg.height, row_step))
        acc = torch.zeros((rows * cfg.width, 3))
        rays += trender.window_fn(engine)(st, ds.camera, cfg, acc, t * cfg.width, 0, cfg.spp,
                                          row_step=row_step)
        assert torch.equal(acc.reshape(rows, cfg.width, 3), film[t::row_step]), t
        ids = window_pixels(t * cfg.width, torch.arange(rows * cfg.width), row_step, cfg.width)
        per_pixel = megak.mega_render(st, eye, rot, cfg, 0, cfg.spp, t * cfg.width,
                                      rows * cfg.width, row_step=row_step)[3]
        assert torch.equal(per_pixel, whole["pixel_rays"][ids]), t
    assert rays == rays_whole
