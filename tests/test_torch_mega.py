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


@pytest.mark.parametrize("batch", [1, 3])
def test_mega_batches_equal_scan(batch):
    """mega_spp_batch splits the samples over launches; the film and the
    useful-ray count equal the scan engine's."""
    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE, mega_spp_batch=batch)
    s_mega, s_scan = {}, {}
    a = trender.render_film(st, ds.camera, cfg.replace(engine="mega"), stats=s_mega)
    b = trender.render_film(st, ds.camera, cfg.replace(engine="scan"), stats=s_scan)
    assert a.count == b.count == 4
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), rtol=1e-5,
                               atol=1e-5 * float(b.accum.abs().max()))
    assert s_mega["rays"] == s_scan["rays"]


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
    summed over the launches and rounded to whole us, while recording."""
    from torch.profiler import ProfilerActivity, profile

    from jaderaytracerendering_tpu_torch.utils import logging as tlog

    stamps = [torch.tensor([1_000, 41_000, 43_500]), torch.tensor([50_000, 90_400, 93_000])]
    tlog.reset()
    megak.count_stamps(stamps)
    assert tlog.counters() == {}  # no profiler: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        tlog.reset()
        megak.count_stamps(stamps)
        megak.count_stamps([])
        got = dict(tlog.counters())
    tlog.reset()
    assert got == {"ops.mega.launch_us": 86, "ops.mega.tail_us": 5}


def test_bind_refuses_a_library_without_the_entry_point():
    """``kernels.bind`` types the entry points it is given and names the
    one a library lacks as it loads, not at the first launch."""
    import ctypes

    libc = ctypes.CDLL(None)
    with pytest.raises(AttributeError, match="'mega_render'"):
        kernels.bind(libc, ("mega_render",))
    assert "mega_fold" in kernels.LAUNCHES and "mega_render" in kernels.SIGNATURES
