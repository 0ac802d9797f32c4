"""Port parity: for one film, the displayed image and its BMP/PNG files
are byte-equal to the JAX package's (tonemap.finalize on NumPy, the film
flipped so row 0 is the top, image_io writers). The port's side is a CPU
film, so its NumPy path runs on any machine; the card's path is held
against it in tests/test_torch_cuda.py.

The identity that ``finalize``'s card path rests on: the postfx kernel's
plain version at sample count 1 gives the NumPy tone map's bytes, in each
mode, over ragged and flipped films and extreme values (the kernel equals
its plain version byte for byte on the card: tests/test_torch_cuda.py).
A CPU tensor, with or without ``flip``, gives the NumPy array's bytes;
with no CUDA device nothing runs on a card.

Tolerance: none — byte equality."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jaderaytracerendering_tpu.post import image_io as jio, tonemap as jtm
from jaderaytracerendering_tpu_torch.core.film import Film
from jaderaytracerendering_tpu_torch.ops import kernels, postfx
from jaderaytracerendering_tpu_torch.post import image_io as tio, tonemap as ttm
from jaderaytracerendering_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)


def _film():
    g = np.random.default_rng(0)
    accum = (g.gamma(0.6, 2.0, size=(13, 10, 3)) * 3).astype(np.float32)
    accum[0, 0] = [0.0, 5000.0, 1e-8]
    return Film(torch.from_numpy(accum), 3)


@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
@pytest.mark.parametrize("ext", ["bmp", "png"])
def test_image_bytes_equal(tmp_path, mode, ext):
    film = _film()
    rad = film.mean().numpy()[::-1]
    want_rad = (film.accum.numpy() / np.float32(3))[::-1]
    np.testing.assert_array_equal(rad, want_rad)
    a, b = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"port.{ext}")
    jio.save(a, np.asarray(jtm.finalize(want_rad, np, mode)))
    tio.save(b, ttm.finalize(film.mean(), mode, flip=True))  # a CPU film: the NumPy path
    assert open(a, "rb").read() == open(b, "rb").read()


def test_bmp_round_trip(tmp_path):
    img = ttm.finalize(_film().mean().numpy()[::-1])
    path = str(tmp_path / "x.bmp")
    tio.write_bmp(path, img)
    np.testing.assert_array_equal(tio.read_bmp(path), img)


def _numpy_finish(rad, mode, g=2.2):
    """The NumPy path of ``finalize``, named so that no card takes it."""
    return ttm.quantize_u8(ttm.gamma(ttm.tonemap(np.asarray(rad, np.float32), mode), g))


def _hdr(h, w, seed):
    """A mean film [h, w, 3] of HDR radiance with the extremes: 0, 1e-8,
    5000, negatives, and values about the knee of each curve."""
    g = np.random.default_rng(seed)
    rad = (g.gamma(0.6, 2.0, size=(h, w, 3)) * g.choice([0.05, 1.0, 30.0], (h, w, 1)))
    rad = rad.astype(np.float32)
    rad[0, 0], rad[-1, -1] = [0.0, 1e-8, 5000.0], [-1e-8, -0.5, -3e4]
    rad[h // 2, :3] = [[1.0, 0.5, 2.0], [0.18, 1e-4, 100.0], [1e6, 0.0, 1.0]]
    return rad


@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
@pytest.mark.parametrize("w", [64, 37])  # a multiple of 4, and not
@pytest.mark.parametrize("flipped", [False, True])
def test_plain_postfx_at_count_one_equals_numpy(mode, w, flipped):
    rad = _hdr(9, w, w)
    if flipped:
        rad = rad[::-1]  # the client's view, a negative row stride
    want = _numpy_finish(rad, mode, 2.2)
    got = postfx.postfx_plain(torch.from_numpy(np.ascontiguousarray(rad)), 1, mode, 2.2)
    assert got.dtype == torch.uint8 and got.shape == rad.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == 255


@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
def test_finalize_cpu_tensor_equals_numpy(mode):
    rad = _hdr(11, 37, 3)
    want = _numpy_finish(rad[::-1], mode)
    got = ttm.finalize(torch.from_numpy(rad), mode, flip=True)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttm.finalize(torch.from_numpy(rad), mode),
                                  _numpy_finish(rad, mode))


def test_finalize_without_a_card_counts_no_card_image(monkeypatch):
    """A host array in a process without a CUDA device: the span is
    recorded, no postfx launch and no ``post.tonemap.card_images``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tlog.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.reset_launches()
        ttm.finalize(_hdr(5, 8, 1)[::-1])
        names = [s.name for s in tlog.spans()]
        counters = dict(tlog.counters())
    tlog.reset()
    assert names == ["post.tonemap.finalize"]
    assert "post.tonemap.card_images" not in counters
    assert kernels.LAUNCHES["postfx"] == 0
