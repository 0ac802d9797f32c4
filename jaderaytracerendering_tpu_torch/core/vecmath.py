"""Plane-form (SoA) 3-vectors on torch tensors.

A ``V3`` holds each component as its own same-shaped tensor, as the JAX
package's ``core/vecmath.V3``. Every helper spells out its association
order (``vdot`` is ``(x*x' + y*y') + z*z'``) and the CUDA kernel
(csrc/mega.cu, built with ``--fmad=false``) evaluates the same order, so
the kernel and this plain version round alike.

Division by a constant goes through ``div``: torch's CUDA ``div`` turns
a Python-scalar divisor into a multiplication by its reciprocal, while
JAX, torch on the CPU and the kernel divide; a 0-d tensor divisor on the
same device keeps every one of them a true float32 division.

Square roots go through ``sqrt``: torch's CPU ``sqrt`` of float32 is not
correctly rounded on every x86 build (many values an ulp off, at every
ATen CPU capability), while NumPy, XLA and the kernels' ``sqrtf`` round
correctly.
"""

from __future__ import annotations

import typing as _t

import torch


class V3(_t.NamedTuple):
    """A 3-vector of same-shaped component tensors (or scalars)."""

    x: _t.Any
    y: _t.Any
    z: _t.Any

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def vdot(a: V3, b: V3):
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device: the float64 root of
    a float32 value rounds to the float32 root exactly (53 >= 2 * 24 + 2,
    so the double rounding is innocuous)."""
    return torch.sqrt(x.double()).to(x.dtype)


def vnorm(v: V3) -> torch.Tensor:
    return sqrt(vdot(v, v))


def vnormalize(v: V3, eps: float = 0.0) -> V3:
    """v / |v| as ``v * (1 / sqrt(v.v))``; ``eps`` floors v.v so a zero
    vector stays zero instead of becoming NaN."""
    n2 = vdot(v, v)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return v * torch.reciprocal(sqrt(n2))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true float32 division on every device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def vreflect(d: V3, n: V3) -> V3:
    """d - 2 (d.n) n (the reflection inside direct refraction,
    PathTrace.cu:1217)."""
    k = 2.0 * vdot(d, n)
    return V3(d.x - n.x * k, d.y - n.y * k, d.z - n.z * k)


def vdiv(v: V3, c: float) -> V3:
    return V3(div(v.x, c), div(v.y, c), div(v.z, c))


def vwhere(mask, a, b) -> V3:
    """Componentwise where; ``a``/``b`` are V3 or scalars."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, ax, bx), torch.where(mask, ay, by),
              torch.where(mask, az, bz))


def vrows(t: torch.Tensor) -> V3:
    """[..., 3] tensor -> V3 of its columns."""
    return V3(t[..., 0], t[..., 1], t[..., 2])


def vstack(v: V3) -> torch.Tensor:
    """V3 -> [..., 3] tensor."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def vcat(parts: _t.Sequence[V3]) -> V3:
    return V3(torch.cat([p.x for p in parts]), torch.cat([p.y for p in parts]),
              torch.cat([p.z for p in parts]))


def vtransform(m: torch.Tensor, v: V3, w: float) -> V3:
    """4x4 GLM-layout (m[col, row]) transform on planes."""
    ox = m[0, 0] * v.x + m[1, 0] * v.y + m[2, 0] * v.z + m[3, 0] * w
    oy = m[0, 1] * v.x + m[1, 1] * v.y + m[2, 1] * v.z + m[3, 1] * w
    oz = m[0, 2] * v.x + m[1, 2] * v.y + m[2, 2] * v.z + m[3, 2] * w
    return V3(ox, oy, oz)
