"""Port parity: for one film, the displayed image and its BMP/PNG files
are byte-equal to the JAX package's (tonemap.finalize on NumPy, the film
flipped so row 0 is the top, image_io writers).

Tolerance: none — byte equality."""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.post import image_io as jio, tonemap as jtm
from jaderaytracerendering_tpu_torch.core.film import Film
from jaderaytracerendering_tpu_torch.post import image_io as tio, tonemap as ttm

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
    tio.save(b, ttm.finalize(rad, mode))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_bmp_round_trip(tmp_path):
    img = ttm.finalize(_film().mean().numpy()[::-1])
    path = str(tmp_path / "x.bmp")
    tio.write_bmp(path, img)
    np.testing.assert_array_equal(tio.read_bmp(path), img)
