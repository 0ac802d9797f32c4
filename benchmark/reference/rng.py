"""Keyed counter RNG: every draw a pure function of (pixel, sample,
bounce, site, seed), hashed with a PCG mixer on uint32 values held in
int64 tensors (masked to 32 bits after every multiply and add). The
keys and constants are those of the renderer (PathTrace.cu's sampling
sites, numbered as below), so the reference draws what the program
draws."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_K_PIXEL = 0x9E3779B9
_K_SAMPLE = 0x85EBCA6B
_K_BOUNCE = 0xC2B2AE35
_K_SITE = 0x27D4EB2F
_K_SEED = 0x165667B1
_INV_2_24 = 1.0 / 16777216.0

# site ids of the draws of one bounce
JITTER_X, JITTER_Y = 0, 1
SELECT_REFRACT, SELECT_SSS = 2, 3
HDR_COS, HDR_PHI = 4, 5
RR = 6
CONT_COS, CONT_PHI = 7, 8
AREA_CDF, EXIT_U, EXIT_V = 9, 10, 11
REFRACT_BASE = 16  # + march step
LIGHT_BASE = 64    # + 2 * light slot (+ 1)


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _pcg(x: torch.Tensor) -> torch.Tensor:
    x = (x * 747796405 + 2891336453) & _M32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (word >> 22) ^ word


def _base(pixel, sample, bounce, seed) -> torch.Tensor:
    dev = pixel.device if isinstance(pixel, torch.Tensor) else None
    h = (_u32(pixel, dev) * _K_PIXEL + _u32(sample, dev) * _K_SAMPLE) & _M32
    h = _pcg(h)
    h = (h + _u32(bounce, dev) * _K_BOUNCE) & _M32
    return (h + _u32(seed, dev) * _K_SEED) & _M32


def _unit(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.int32).to(torch.float32) * _INV_2_24


def uniform(pixel, sample, bounce, site, seed) -> torch.Tensor:
    """U[0, 1) float32, exact in 24 bits; arguments broadcast."""
    h = _base(pixel, sample, bounce, seed)
    return _unit(_pcg((h + _u32(site, h.device) * _K_SITE) & _M32))


def uniform_sites(pixel, sample, bounce, sites, seed) -> torch.Tensor:
    """[len(sites), ...] float32; row k is ``uniform(..., sites[k], seed)``."""
    h = _base(pixel, sample, bounce, seed)
    col = torch.tensor([int(s) for s in sites], dtype=torch.int64,
                       device=h.device).reshape((len(sites),) + (1,) * h.dim())
    return _unit(_pcg((h + col * _K_SITE) & _M32))
