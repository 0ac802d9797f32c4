"""Port parity: the port's ``engine='mega'`` on CPU tensors (its wrapper
runs the plain version there) against the JAX package's
``mega.render_film_mega`` in interpret mode, at the size of
tests/test_mega.py (8x8, 4 spp, depth 4, mega_gather='take'). The CUDA
wrapper must not count a launch on the CPU.

Tolerance: atol = 1e-4 * max|film|, rtol = 1e-3 (tests/test_integrator.py
precedent; the JAX megakernel itself is held to the scan engine at
1e-6/1e-5, and the torch engine to the scan engine at this tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.integrator import mega as jmega
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels, mega as megak
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=8, height=8, spp=4, spp_batch=4, max_depth=4,
            rays_per_launch=64, mega_gather="take")
MEGA_RTOL, MEGA_ATOL_FRAC = 1e-5, 1e-6  # the megakernel-vs-plain bound (tests/test_torch_cuda.py)


def test_mega_cornell_matches_jax_mega():
    ds = jdemo.cornell_scene()
    # the NumPy SAH builder, as the port's: the triangle order fixes the
    # light order and so each light's RNG sites
    sdj = jassemble(ds.objects, ds.env_map, xp=jnp, bvh_backend="numpy")
    a = np.asarray(jmega.render_film_mega(
        sdj, ds.camera, JConfig(**SIZE, traversal="sweep")).mean())
    t = tdemo.cornell_scene()
    st = tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")
    kernels.reset_launches()
    film = trender.render_film(st, t.camera, TConfig(**SIZE, engine="mega"))
    assert set(kernels.LAUNCHES.values()) == {0}
    assert film.count == 4
    b = film.mean().numpy()
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("calls", [1, 2])
def test_mega_batches_equal_scan(calls, monkeypatch):
    """The window's 4 samples in one ``mega_render`` call, or split over
    two (``MAX_ITEMS`` set below spp: calls of 3 and 1 samples); the film
    and the useful-ray count equal the scan engine's."""
    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE)
    if calls > 1:
        monkeypatch.setattr(megak, "MAX_ITEMS", 3)
    seen = _spy_calls(monkeypatch)
    s_mega, s_scan = {}, {}
    a = trender.render_film(st, ds.camera, cfg.replace(engine="mega"), stats=s_mega)
    assert len(seen) == calls
    b = trender.render_film(st, ds.camera, cfg.replace(engine="scan"), stats=s_scan)
    assert a.count == b.count == 4
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), rtol=1e-5,
                               atol=1e-5 * float(b.accum.abs().max()))
    assert s_mega["rays"] == s_scan["rays"]


def _spy_calls(monkeypatch) -> list:
    """Wrap ``ops.mega.mega_render``: the list receives (sample_base, spp,
    pix0, n_px) of each call."""
    seen, real = [], megak.mega_render

    def spy(sd, eye, rot, cfg, sample_base, spp, pix0=0, n_px=None, stamps=None, row_step=1):
        seen.append((sample_base, spp, pix0, n_px))
        return real(sd, eye, rot, cfg, sample_base, spp, pix0, n_px, stamps=stamps,
                    row_step=row_step)

    monkeypatch.setattr(megak, "mega_render", spy)
    return seen


class _FakeLibrary:
    """The megakernel's C interface on the host: each ``mega_render``
    launch appends (the window's first pixel, the launch's first slot,
    slots, spp, row step) and succeeds."""

    def __init__(self):
        self.launches = []

    def mega_render(self, s, r, pix0, slot0, n, out, ld, part, next_item, stamps, stream):
        self.launches.append((pix0, slot0, n, r._obj.spp, r._obj.row_step))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """``render_window_mega`` over ``mega_render``'s launch path without a
    card: the window's calls go to a scene on the meta device (no memory
    behind its buffers) whose launches ``_FakeLibrary`` records; each call
    returns zero sums on the CPU. -> (calls, the library)."""
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "scene_args", lambda sd, stack: kernels.SceneArgs())
    monkeypatch.setattr(kernels, "stream", lambda device: None)
    meta = types.SimpleNamespace(device=torch.device("meta"))
    seen, real = [], megak.mega_render

    def on_meta(sd, eye, rot, cfg, sample_base, spp, pix0=0, n_px=None, stamps=None,
                row_step=1):
        seen.append((sample_base, spp, pix0, n_px, row_step))
        real(meta, eye, rot, cfg, sample_base, spp, pix0, n_px, row_step=row_step)
        return torch.zeros((4, n_px))

    monkeypatch.setattr(megak, "mega_render", on_meta)
    return seen, lib


# (film side, first pixel, slots, spp, row step) -> the launches of the
# window's one call as (first pixel, slots): 256^2 x 256 in one launch of
# 2^24 items; 1024^2 x 256 in four of 256 rows; a --mesh 4x1 tile (rank 1's
# 256 rows 1, 5, .., dealt 4 apart) in one launch of 2^26; the same rows
# at 512 spp in two launches, the second from the window's row 128 (film
# row 1 + 4 x 128)
PLANS = [
    (256, 0, 1 << 16, 256, 1, [(0, 1 << 16)]),
    (1024, 0, 1 << 20, 256, 1, [(a, 1 << 18) for a in range(0, 1 << 20, 1 << 18)]),
    (1024, 1024, 1 << 18, 256, 4, [(1024, 1 << 18)]),
    (1024, 1024, 1 << 18, 512, 4, [(1024, 1 << 17), (513 * 1024, 1 << 17)]),
    (1024, 0, 1 << 20, 64, 1, [(0, 1 << 20)]),
]


@pytest.mark.parametrize("side,pix0,n_px,spp,row_step,launches", PLANS)
def test_a_window_is_one_call_split_by_pixels_only(fake_card, side, pix0, n_px, spp, row_step,
                                                   launches):
    """``render_window_mega`` makes one ``mega_render`` call for all of a
    window's samples; the call launches the slot windows of
    ``launch_windows`` (at most MAX_ITEMS items each), every one at the
    window's spp, first pixel and row step, so that a launch's first slot
    maps to its pixel as every other slot does (core/film.window_pixels)."""
    from jaderaytracerendering_tpu_torch.core.film import window_pixels
    from jaderaytracerendering_tpu_torch.integrator import mega as tmega

    seen, lib = fake_card
    cam = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32)).camera
    cfg = TConfig(width=side, height=side, spp=spp)
    acc = torch.zeros((n_px, 3))
    tmega.render_window_mega(None, cam, cfg, acc, pix0, 7, spp, row_step=row_step)
    assert seen == [(7, spp, pix0, n_px, row_step)]
    assert [(a, n) for _, a, n, _, _ in lib.launches] == megak.launch_windows(n_px, spp)
    assert [(window_pixels(p, a, st, side), n) for p, a, n, _, st in lib.launches] == launches
    assert {(p, k, st) for p, _, _, k, st in lib.launches} == {(pix0, spp, row_step)}
    assert max(n for _, _, n, _, _ in lib.launches) * spp <= megak.MAX_ITEMS


def test_the_samples_split_over_calls_only_past_max_items(fake_card, monkeypatch):
    """Where one pixel's samples alone pass MAX_ITEMS the window's samples
    go in calls of MAX_ITEMS samples, in order, each launched a pixel at a
    time."""
    from jaderaytracerendering_tpu_torch.integrator import mega as tmega

    seen, lib = fake_card
    monkeypatch.setattr(megak, "MAX_ITEMS", 100)
    cam = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32)).camera
    cfg = TConfig(width=4, height=4, spp=256)
    tmega.render_window_mega(None, cam, cfg, torch.zeros((3, 3)), 5, 11, 256)
    assert seen == [(11, 100, 5, 3, 1), (111, 100, 5, 3, 1), (211, 56, 5, 3, 1)]
    assert lib.launches == [(5, a, 1, k, 1) for k in (100, 100, 56) for a in (0, 1, 2)]


def test_the_launches_counter_records_only_under_the_profiler(fake_card):
    """``ops.mega.launches`` adds one a megakernel launch while spans are
    recorded (four a 1024^2 x 256 window, one a 256^2 x 256 one), and
    nothing without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from jaderaytracerendering_tpu_torch.integrator import mega as tmega
    from jaderaytracerendering_tpu_torch.utils import logging as tlog

    cam = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32)).camera
    big, tile = TConfig(width=1024, height=1024, spp=256), TConfig(width=256, height=256,
                                                                   spp=256)
    kernels.reset_launches()
    tmega.render_window_mega(None, cam, big, torch.zeros((1 << 20, 3)), 0, 0, 256)
    assert "ops.mega.launches" not in tlog.counters()
    assert kernels.LAUNCHES["mega_render"] == kernels.LAUNCHES["mega_fold"] == 4
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        for cfg in (big, tile):
            kernels.reset_launches()
            tmega.render_window_mega(None, cam, cfg, torch.zeros((cfg.width ** 2, 3)), 0,
                                     0, 256)
            got.append(dict(tlog.counters()))
    tlog.reset()
    assert got == [{"ops.mega.launches": 4}, {"ops.mega.launches": 1}]


def test_split_samples_render_the_unsplit_film(monkeypatch):
    """The plain version (a scene on the CPU) over a window whose samples
    split over calls (MAX_ITEMS below spp) renders the one call's film:
    each call sums its samples in order and the window adds the calls in
    order, so the sums are the same sums; useful rays equal."""
    from jaderaytracerendering_tpu_torch.integrator import mega as tmega

    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE)
    one, split = torch.zeros((64, 3)), torch.zeros((64, 3))
    rays_one = tmega.render_window_mega(st, ds.camera, cfg, one, 0, 2, 4)
    monkeypatch.setattr(megak, "MAX_ITEMS", 3)
    seen = _spy_calls(monkeypatch)
    rays_split = tmega.render_window_mega(st, ds.camera, cfg, split, 0, 2, 4)
    assert [(b, k) for b, k, _, _ in seen] == [(2, 3), (5, 1)]
    assert rays_split == rays_one
    assert torch.equal(split, one)


# pixel windows (pix0, n_px) of the 64-pixel film: the first, a ragged
# middle one, a last one shorter than the others
WINDOWS = [(0, 16), (21, 19), (50, 14)]


def test_mega_windows_equal_the_whole_film():
    """``mega_render`` over a pixel window (the plain version on the CPU)
    equals the window's columns of the whole film: useful rays exact,
    radiance within MEGA_RTOL / MEGA_ATOL_FRAC (torch's CPU ``pow`` and
    ``atan2`` round their vectorised body and their scalar tail apart, so
    a window that does not start on a vector boundary moves a pixel's
    last bit; the kernel is held bit for bit on the card,
    tests/test_torch_cuda.py); a window outside the film is refused."""
    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    eye, rot = torch.tensor(ds.camera.eye, dtype=torch.float32), \
        torch.tensor(ds.camera.camera_rotate, dtype=torch.float32)
    cfg = TConfig(**SIZE)
    whole = megak.mega_render(st, eye, rot, cfg, 3, 4)
    assert whole.shape == (4, 64)
    for pix0, n_px in WINDOWS:
        win = megak.mega_render(st, eye, rot, cfg, 3, 4, pix0, n_px)
        want = whole[:, pix0:pix0 + n_px]
        assert torch.equal(win[3], want[3]), (pix0, n_px)
        np.testing.assert_allclose(win[:3].numpy(), want[:3].numpy(), rtol=MEGA_RTOL,
                                   atol=MEGA_ATOL_FRAC * float(whole[:3].abs().max()))
    assert torch.equal(megak.mega_render(st, eye, rot, cfg, 3, 4, 48), whole[:, 48:])
    for pix0, n_px in ((60, 5), (-1, 3)):
        with pytest.raises(ValueError, match="pixel window"):
            megak.mega_render(st, eye, rot, cfg, 3, 4, pix0, n_px)


def test_wrapper_rejects_a_non_cuda_device():
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu").to("meta")
    eye, rot = torch.zeros(3), torch.eye(4)
    with pytest.raises(ValueError):
        megak.mega_render(st, eye, rot, TConfig(**SIZE), 0, 1)


def test_kernel_struct_matches_scene_tables():
    """The ctypes structures in ops/kernels.py mirror csrc/path.cuh's
    SceneArgs and RenderArgs and csrc/pool.cu's PoolArgs field for field."""
    import re

    src = "".join((kernels.build.CSRC_DIR / f).read_text()
                  for f in ("path.cuh", "pool.cu"))

    def fields(name):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        return [re.search(r"(\w+)(\[\d+\])?;", line.split("//")[0]).group(1)
                for line in body.splitlines() if ";" in line]

    assert fields("SceneArgs") == [f[0] for f in kernels.SceneArgs._fields_]
    assert fields("RenderArgs") == [f[0] for f in kernels.RenderArgs._fields_]
    assert fields("PoolArgs") == [f[0] for f in kernels.PoolArgs._fields_]


@pytest.mark.parametrize("spp", [1, 3, 7, 8, 63, 64, 65])
def test_work_items_windows_and_scratch(spp):
    """The megakernel's host arithmetic: spp items a pixel, launches of at
    most MAX_ITEMS items that cover the window once and in order, and a
    scratch of one float4 an item of the largest launch."""
    for n_px in (1, 5, 4096, 3 * (1 << 20) + 17):
        wins = megak.launch_windows(n_px, spp)
        assert wins[0][0] == 0 and sum(n for _, n in wins) == n_px
        assert all(a + n == b for (a, n), (b, _) in zip(wins, wins[1:]))
        assert max(n for _, n in wins) * spp <= megak.MAX_ITEMS
        assert len(wins) == 1 or wins[0][1] * spp > megak.MAX_ITEMS - spp
        assert megak.scratch_shape(n_px, spp) == (wins[0][1] * spp, 4)
    assert megak.scratch_shape(9, 0) == (0, 4)


def test_the_main_path_launch_is_one_launch_of_one_gib_of_scratch():
    """1024^2 pixels x 64 spp, one sample an item: 2^26 items, one launch,
    16 bytes of partials an item; a larger film splits into launches."""
    assert megak.launch_windows(1 << 20, 64) == [(0, 1 << 20)]
    assert megak.scratch_shape(1 << 20, 64) == (1 << 26, 4)
    assert megak.launch_windows(1920 * 1080, 64) == [(0, 1 << 20),
                                                     (1 << 20, 1920 * 1080 - (1 << 20))]


def test_count_stamps_adds_launch_and_tail_us():
    """Each launch's stamps (start, the counter found dry, end; ns) add
    end - start to ``ops.mega.launch_us`` and end - dry to ``tail_us``,
    summed over the launches and rounded to whole us, and its four counts
    to ``ops.mega.bounces``, ``ops.mega.sss_bounces``,
    ``ops.mega.refract_bounces`` and ``ops.mega.march_steps``, while
    recording."""
    from torch.profiler import ProfilerActivity, profile

    from jaderaytracerendering_tpu_torch.utils import logging as tlog

    stamps = [torch.tensor([1_000, 41_000, 43_500, 7_000, 3_000, 0, 0]),
              torch.tensor([50_000, 90_400, 93_000, 5_000_000_000, 11, 600, 4_000_000_001])]
    tlog.reset()
    megak.count_stamps(stamps)
    assert tlog.counters() == {}  # no profiler: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        tlog.reset()
        megak.count_stamps(stamps)
        megak.count_stamps([])
        got = dict(tlog.counters())
    tlog.reset()
    assert got == {"ops.mega.launch_us": 86, "ops.mega.tail_us": 5,
                   "ops.mega.bounces": 5_000_007_000, "ops.mega.sss_bounces": 3_011,
                   "ops.mega.refract_bounces": 600, "ops.mega.march_steps": 4_000_000_001}


def test_bind_refuses_a_library_without_the_entry_point():
    """``kernels.bind`` types the entry points it is given and names the
    one a library lacks as it loads, not at the first launch."""
    import ctypes

    libc = ctypes.CDLL(None)
    with pytest.raises(AttributeError, match="'mega_render'"):
        kernels.bind(libc, ("mega_render",))
    assert "mega_fold" in kernels.LAUNCHES and "mega_render" in kernels.SIGNATURES
