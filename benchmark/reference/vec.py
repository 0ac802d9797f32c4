"""Plane-form 3-vectors: each component its own tensor. Every helper
spells out its association order (a dot product is ``(x*x' + y*y') +
z*z'``) and divides by a constant with a true division, so that float32
sums round as the renderer's do."""

from __future__ import annotations

import typing as _t

import torch


class V3(_t.NamedTuple):
    x: _t.Any
    y: _t.Any
    z: _t.Any

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def dot(a: V3, b: V3):
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (through float64) on every device."""
    return torch.sqrt(x.double()).to(x.dtype)


def normalize(v: V3, eps: float = 0.0) -> V3:
    """v * (1 / sqrt(v.v)); ``eps`` floors v.v (a zero vector stays zero)."""
    n2 = dot(v, v)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return v * torch.reciprocal(sqrt(n2))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division in x's precision on every device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def where(mask, a, b) -> V3:
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, ax, bx), torch.where(mask, ay, by), torch.where(mask, az, bz))


def rows(t: torch.Tensor) -> V3:
    """[..., 3] -> V3 of its columns."""
    return V3(t[..., 0], t[..., 1], t[..., 2])


def stack(v: V3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z], dim=-1)


def take(v: V3, idx) -> V3:
    return V3(v.x[idx], v.y[idx], v.z[idx])


def put(v: V3, idx, w: V3) -> V3:
    """A copy of ``v`` with rows ``idx`` set to ``w``."""
    out = V3(v.x.clone(), v.y.clone(), v.z.clone())
    out.x[idx], out.y[idx], out.z[idx] = w.x, w.y, w.z
    return out
