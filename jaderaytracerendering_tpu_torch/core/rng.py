"""Counter-based RNG, bit-exact with the JAX package's core/rng.py.

Every draw is a pure function of ``(pixel, sample, bounce, site, seed)``
hashed with a PCG mixer on uint32. torch has no full uint32 arithmetic,
so values live in int64 tensors and are masked to 32 bits after every
multiply and add and before every right shift. A product of two 32-bit
values can wrap past 2^63; its low 32 bits are still right. The CUDA
kernel (csrc/mega.cu) computes the same hash on ``uint32_t``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_K_PIXEL = 0x9E3779B9
_K_SAMPLE = 0x85EBCA6B
_K_BOUNCE = 0xC2B2AE35
_K_SITE = 0x27D4EB2F
_K_SEED = 0x165667B1
_INV_2_24 = 1.0 / 16777216.0


def _u32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on uint32 values held in int64."""
    x = (x * 747796405 + 2891336453) & _M32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (word >> 22) ^ word


def _base(pixel_id, sample_id, bounce, seed) -> torch.Tensor:
    h = (_u32(pixel_id) * _K_PIXEL + _u32(sample_id) * _K_SAMPLE) & _M32
    h = pcg_hash(h)
    h = (h + _u32(bounce) * _K_BOUNCE) & _M32
    return (h + _u32(seed) * _K_SEED) & _M32


def hash_counters(pixel_id, sample_id, bounce, site, seed=0) -> torch.Tensor:
    """Mix a counter tuple into one uint32 (int64 tensor). Arguments
    broadcast."""
    h = _base(pixel_id, sample_id, bounce, seed)
    return pcg_hash((h + _u32(site) * _K_SITE) & _M32)


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    # top 24 bits -> exact float32 in [0, 1)
    return (bits >> 8).to(torch.int32).to(torch.float32) * _INV_2_24


def uniform(pixel_id, sample_id, bounce, site, seed=0) -> torch.Tensor:
    """U[0, 1) float32 draw, one per broadcast element."""
    return _to_unit(hash_counters(pixel_id, sample_id, bounce, site, seed))


def uniform_sites(pixel_id, sample_id, bounce, sites, seed=0) -> torch.Tensor:
    """All ``sites`` at once -> [S, ...] f32; row s equals
    ``uniform(pixel_id, sample_id, bounce, sites[s], seed)``."""
    h = _base(pixel_id, sample_id, bounce, seed)
    site_col = torch.tensor([int(s) for s in sites], dtype=torch.int64,
                            device=h.device).reshape((len(sites),)
                                                     + (1,) * h.dim())
    return _to_unit(pcg_hash((h + site_col * _K_SITE) & _M32))


class DrawSites:
    """Static site ids for every distinct random draw in one bounce
    (the same ids as the JAX package). Per-light draws use
    LIGHT_BASE + 2*i {+1}."""

    JITTER_X = 0          # primary-ray film jitter (PathTrace.cu:1430)
    JITTER_Y = 1
    SELECT_REFRACT = 2    # reflect-vs-refract lobe pick (PathTrace.cu:924)
    SELECT_SSS = 3        # SSS entry-vs-exit pick (PathTrace.cu:930)
    HDR_COS = 4           # env NEE direction (PathTrace.cu:968-970)
    HDR_PHI = 5
    RR = 6                # Russian roulette (PathTrace.cu:988)
    CONT_COS = 7          # continuation direction (PathTrace.cu:992-994)
    CONT_PHI = 8
    AREA_CDF = 9          # BSSRDF exit-triangle pick (PathTrace.cu:1031)
    EXIT_U = 10           # exit-point barycentrics (PathTrace.cu:1051-1052)
    EXIT_V = 11
    REFRACT_BASE = 16     # internal-reflection picks, + march step i
    LIGHT_BASE = 64       # per-emissive-triangle point draws, + 2*i, +2*i+1
