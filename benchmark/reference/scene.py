"""The reference's scene tables, worked out from the raw scene
(``benchmark/scene.py``) in load order: no BVH, no reordering.

Triangle ids are load-order ids. For the hit search alone the triangles
of each object are also grouped into clusters of ``CLUSTER`` along the
Morton order of their centroids, each with the box of its vertices: a
ray tests the triangles of every cluster whose box it meets
(``pathtrace.nearest``), which finds the same nearest hit as testing
every triangle, in a time that a million triangles allow.

The lights are the triangles of the emissive objects; PathTrace.cu
numbers them in the order its BVH leaves them, which the reference
cannot know, so ``Tables.lights`` is in load order and the integrator
takes the order of its light slots as an argument
(``pathtrace.render_pixels``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .vec import V3, rows

EMISSIVE_THRESHOLD = 1.5e-4  # a light (PathTrace.cu:1597)
CLUSTER = 64        # triangles of a cluster
MORTON_BITS = 21    # bits of a centroid's coordinate in its Morton code
BOX_PAD = 1e-5      # a cluster's box grows by this x (1 + |coordinate|)


@dataclasses.dataclass
class Tables:
    p1: V3
    p2: V3
    p3: V3
    e1: V3            # p2 - p1
    e2: V3            # p3 - p1
    norm: torch.Tensor       # [T, 3]
    obj: torch.Tensor        # [T] int64
    emissive: torch.Tensor   # [O, 3]
    brdf: torch.Tensor
    reflex: torch.Tensor     # [O] int64
    refract: torch.Tensor
    refract_rate: torch.Tensor
    refract_albedo: torch.Tensor
    refract_index: torch.Tensor  # [O]
    lights: torch.Tensor     # [E] int64 load-order ids of the light triangles
    prefix_area: torch.Tensor    # [T] per-object running area, load order
    obj_total_area: torch.Tensor  # [O]
    seg_begin: torch.Tensor  # [O] first triangle of each object
    seg_end: torch.Tensor    # [O] last triangle
    env: torch.Tensor        # [H, W, 3]
    tri_p: torch.Tensor      # [T, 3, 3] the vertices, for point sampling
    cluster: torch.Tensor    # [C, CLUSTER] int64 triangle ids, -1 where a cluster ends early
    box_lo: torch.Tensor     # [C, 3] float32 each cluster's box, padded
    box_hi: torch.Tensor
    dtype: torch.dtype

    @property
    def n_triangles(self) -> int:
        return int(self.obj.shape[0])


def _area64(p1, p2, p3) -> np.ndarray:
    a, b = p2 - p1, p3 - p1
    c = np.cross(a, b)
    return 0.5 * np.sqrt(np.sum(c * c, axis=-1))


def _spread_bits(q: np.ndarray) -> np.ndarray:
    """The low 21 bits of ``q`` (int64) moved to every third bit."""
    q = q.astype(np.uint64) & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        q = (q | (q << np.uint64(shift))) & np.uint64(mask)
    return q


def clusters(vertices: np.ndarray, seg_begin, seg_end) -> tuple:
    """Clusters of each object's triangles (``vertices`` [T, 3, 3], in
    the precision the tables hold) -> (ids [C, CLUSTER] with -1 padding,
    box lo [C, 3], box hi [C, 3]), the boxes padded by ``BOX_PAD`` for the
    rounding of the box test."""
    ids = []
    cen = vertices.mean(axis=1)
    for b, e in zip(seg_begin, seg_end):
        c = cen[b:e + 1]
        lo = c.min(axis=0)
        ext = np.maximum(c.max(axis=0) - lo, 1e-30)
        q = np.clip((c - lo) / ext * (2 ** MORTON_BITS - 1), 0, 2 ** MORTON_BITS - 1)
        q = q.astype(np.int64)
        code = (_spread_bits(q[:, 0]) << np.uint64(2)) | (_spread_bits(q[:, 1]) << np.uint64(1)) \
            | _spread_bits(q[:, 2])
        order = b + np.argsort(code, kind="stable")
        order = np.concatenate([order, np.full(-len(order) % CLUSTER, -1, np.int64)])
        ids.append(order.reshape(-1, CLUSTER))
    ids = np.concatenate(ids)
    vlo = np.concatenate([vertices.min(axis=1), np.full((1, 3), np.inf)])
    vhi = np.concatenate([vertices.max(axis=1), np.full((1, 3), -np.inf)])
    lo, hi = vlo[ids].min(axis=1), vhi[ids].max(axis=1)  # id -1: the padding row
    pad = BOX_PAD * (1.0 + np.maximum(np.abs(lo), np.abs(hi)))
    return ids, lo - pad, hi + pad


def build(raw, device, dtype=torch.float32) -> Tables:
    """Tables of ``raw`` (a ``benchmark.scene.RawScene``) on ``device`` in
    ``dtype``. The area prefix sums follow PathTrace.cu:1538-1546: float64
    areas, summed per object, stored in float32."""
    objs = raw.objects
    cat = {k: np.concatenate([getattr(o, k) for o in objs]) for k in ("p1", "p2", "p3", "norm")}
    counts = np.array([len(o.p1) for o in objs], np.int64)
    seg_end = np.cumsum(counts) - 1
    seg_begin = seg_end - counts + 1
    obj = np.concatenate([np.full(n, i, np.int64) for i, n in enumerate(counts)])
    areas = _area64(*(cat[k].astype(np.float64) for k in ("p1", "p2", "p3")))
    prefix = np.empty(len(obj), np.float32)
    for b, e in zip(seg_begin, seg_end):
        prefix[b:e + 1] = np.cumsum(areas[b:e + 1])
    mats = [o.material for o in objs]
    emissive = np.array([m.emissive for m in mats], np.float32)
    lights = np.nonzero((emissive > EMISSIVE_THRESHOLD).any(axis=1)[obj])[0]

    def f(a):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    def i(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    p1, p2, p3 = (f(cat[k]) for k in ("p1", "p2", "p3"))
    tri_p = torch.stack([p1, p2, p3], dim=1)
    ids, lo, hi = clusters(tri_p.float().cpu().numpy().astype(np.float64), seg_begin, seg_end)
    return Tables(
        p1=rows(p1), p2=rows(p2), p3=rows(p3), e1=rows(p2 - p1), e2=rows(p3 - p1),
        norm=f(cat["norm"]), obj=i(obj), emissive=f(emissive),
        brdf=f([m.brdf for m in mats]), reflex=i([m.reflex_mode for m in mats]),
        refract=i([m.refract_mode for m in mats]),
        refract_rate=f([m.refract_rate for m in mats]),
        refract_albedo=f([m.refract_albedo for m in mats]),
        refract_index=f([m.refract_index for m in mats]),
        lights=i(lights), prefix_area=f(prefix), obj_total_area=f(prefix[seg_end]),
        seg_begin=i(seg_begin), seg_end=i(seg_end), env=f(raw.env),
        tri_p=tri_p, cluster=i(ids), box_lo=torch.tensor(lo, dtype=torch.float32, device=device),
        box_hi=torch.tensor(hi, dtype=torch.float32, device=device),
        dtype=dtype)
