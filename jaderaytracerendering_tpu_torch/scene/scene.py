"""Scene assembly: objects -> flat torch tables on one device.

The JAX package's scene/scene.py ``assemble`` (object segments, per-object
area prefix sums, SAH BVH reorder, the load-order -> sorted ``mapping``,
the emissive registry in sorted space, hoisted per-light tables), keeping
only the tables the GPU path reads. The TPU layouts (cluster tables, MXU
coefficients, 128-lane packed rows, SSS bucket/window tables) are not
built: the SSS exit pick runs the reference bisection over
``prefix_area`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..accel import bvh as bvh_mod
from ..accel import native
from . import material as material_mod
from .objloader import MeshData


@dataclasses.dataclass
class SceneObject:
    mesh: MeshData
    material: material_mod.Material
    name: str = ""
    source_path: Optional[str] = None
    transform: Optional[np.ndarray] = None
    normalize: bool = False


# tensor fields, with their dtypes; triangles are in BVH-sorted order
_F32, _I32 = torch.float32, torch.int32
TABLES = {
    "tri_p1": _F32, "tri_p2": _F32, "tri_p3": _F32,   # [T, 3]
    "tri_norm": _F32,                                 # [T, 3]
    "tri_obj": _I32,                                  # [T] object id
    "mat_emissive": _F32, "mat_brdf": _F32,           # [O, 3]
    "mat_reflex": _I32, "mat_refract": _I32,          # [O]
    "mat_refract_rate": _F32, "mat_refract_albedo": _F32,  # [O, 3]
    "mat_refract_index": _F32,                        # [O]
    "emit_idx": _I32,                                 # [E] sorted-space ids
    "light_p1": _F32, "light_p2": _F32, "light_p3": _F32,  # [E, 3]
    "light_norm": _F32, "light_emis": _F32,           # [E, 3]
    "light_area": _F32,                               # [E]
    "prefix_area": _F32,                              # [T] load order
    "obj_total_area": _F32,                           # [O]
    "mapping": _I32,                                  # [T] load -> sorted
    "seg_begin": _I32, "seg_end": _I32,               # [O] load order, incl.
    "bvh_left": _I32, "bvh_right": _I32,              # [K] node 0 sentinel
    "bvh_n": _I32, "bvh_index": _I32,                 # [K]
    "bvh_aa": _F32, "bvh_bb": _F32,                   # [K, 3]
    "env_map": _F32,                                  # [He, We, 3]
}

# the kernels' walk tables, packed on the host from the SoA tables above
# (``pack_walk_tables``); the plain versions walk the SoA tables
PACKED = {
    "bvh_nodes": _I32,   # [inner nodes, 16]: one 64-byte record each
    "tri_packed": _F32,  # [T, 12]: p1, p2, p3 in one 48-byte record each
}
# a child word of a record (``pack_walk_tables``): an inner child is its
# record index (>= 0); a leaf child is LEAF_FLAG | count << 24 | first
# triangle; a missing child is LEAF_FLAG alone (a leaf of no triangles)
LEAF_FLAG = -(1 << 31)
LEAF_MAX_COUNT = 127
LEAF_MAX_FIRST = (1 << 24) - 1


def pack_walk_tables(fields: dict) -> dict:
    """The kernels' walk tables from the SoA tables (NumPy, every value
    bit-identical to its SoA source):

    - ``bvh_nodes`` int32 [inner nodes, 16], one 64-byte record per inner
      node in node-id order (the root first): words 0-2 the left child's
      ``aa``, 3-5 its ``bb``, 6-8 the right child's ``aa``, 9-11 its
      ``bb`` (float32 bits), 12 the left child's word, 13 the right's,
      14-15 zero;
    - ``tri_packed`` float32 [T, 12], per triangle p1, p2, p3 and three
      zeros (3 x float4);
    - ``bvh_root``: the root's child word.

    Node 0 is the sentinel; a node with ``bvh_n > 0`` is a leaf."""
    left = np.asarray(fields["bvh_left"], np.int64)
    right = np.asarray(fields["bvh_right"], np.int64)
    n = np.asarray(fields["bvh_n"], np.int64)
    index = np.asarray(fields["bvh_index"], np.int64)
    aa = np.ascontiguousarray(fields["bvh_aa"], np.float32).view(np.int32)
    bb = np.ascontiguousarray(fields["bvh_bb"], np.float32).view(np.int32)
    k = len(n)
    if (n > LEAF_MAX_COUNT).any() or (index[n > 0] + n[n > 0] - 1 > LEAF_MAX_FIRST).any():
        raise ValueError(f"a leaf holds more than {LEAF_MAX_COUNT} triangles or starts "
                         f"beyond triangle {LEAF_MAX_FIRST}: the packed walk cannot "
                         f"address it")
    inner = np.nonzero((np.arange(k) > 0) & (n <= 0))[0]
    record = np.full(k, -1, np.int64)
    record[inner] = np.arange(len(inner))
    word = np.where(n > 0, LEAF_FLAG | (n << 24) | index, record).astype(np.int64)

    def child_word(c):
        return np.where(c > 0, word[np.clip(c, 0, k - 1)], LEAF_FLAG)

    nodes = np.zeros((len(inner), 16), np.int32)
    lc, rc = left[inner], right[inner]
    nodes[:, 0:3] = aa[np.clip(lc, 0, k - 1)]
    nodes[:, 3:6] = bb[np.clip(lc, 0, k - 1)]
    nodes[:, 6:9] = aa[np.clip(rc, 0, k - 1)]
    nodes[:, 9:12] = bb[np.clip(rc, 0, k - 1)]
    nodes[lc <= 0, 0:6] = 0
    nodes[rc <= 0, 6:12] = 0
    nodes[:, 12] = child_word(lc)
    nodes[:, 13] = child_word(rc)
    t = len(fields["tri_p1"])
    tris = np.zeros((t, 12), np.float32)
    for j, key in enumerate(("tri_p1", "tri_p2", "tri_p3")):
        tris[:, 3 * j:3 * j + 3] = np.asarray(fields[key], np.float32).reshape(t, 3)
    root = int(word[1]) if k > 1 else LEAF_FLAG
    return dict(bvh_nodes=nodes, tri_packed=tris, bvh_root=root)


@dataclasses.dataclass
class SceneData:
    """Flat scene tables (see ``TABLES``) plus static facts."""

    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_p3: torch.Tensor
    tri_norm: torch.Tensor
    tri_obj: torch.Tensor
    mat_emissive: torch.Tensor
    mat_brdf: torch.Tensor
    mat_reflex: torch.Tensor
    mat_refract: torch.Tensor
    mat_refract_rate: torch.Tensor
    mat_refract_albedo: torch.Tensor
    mat_refract_index: torch.Tensor
    emit_idx: torch.Tensor
    light_p1: torch.Tensor
    light_p2: torch.Tensor
    light_p3: torch.Tensor
    light_norm: torch.Tensor
    light_emis: torch.Tensor
    light_area: torch.Tensor
    prefix_area: torch.Tensor
    obj_total_area: torch.Tensor
    mapping: torch.Tensor
    seg_begin: torch.Tensor
    seg_end: torch.Tensor
    bvh_left: torch.Tensor
    bvh_right: torch.Tensor
    bvh_n: torch.Tensor
    bvh_index: torch.Tensor
    bvh_aa: torch.Tensor
    bvh_bb: torch.Tensor
    env_map: torch.Tensor
    bvh_nodes: Optional[torch.Tensor]   # PACKED; None: a scene the kernels refuse
    tri_packed: Optional[torch.Tensor]
    bvh_root: int
    n_triangles: int
    n_objects: int
    n_emit: int
    n_nodes: int
    leaf_size: int
    has_sss: bool
    has_refract: bool
    has_mirror: bool
    bvh_depth: int
    bvh_builder: str = ""  # 'native' | 'numpy' (assemble); '' for other fields

    @property
    def device(self) -> torch.device:
        return self.tri_p1.device

    def to(self, device) -> "SceneData":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in TABLES},
            **{k: None if getattr(self, k) is None else getattr(self, k).to(device)
               for k in PACKED})


def _check_device(device) -> torch.device:
    """The scene's device; CUDA that is missing is an error, never a quiet
    fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the scene tables "
                           "(pass device='cpu' to build them on the CPU)")
    return device


def scene_from_numpy(fields: dict, device="cuda") -> SceneData:
    """SceneData from a dict of NumPy arrays named as ``TABLES`` plus
    ``leaf_size`` and, optionally, ``bvh_builder`` (extra keys ignored) —
    e.g. ``assemble_numpy``'s, or the fields of the JAX
    package's ``assemble(..., xp=np)``. The kernels' packed walk tables
    (``PACKED``) and the other static facts are computed from the tables.
    The tables go to the card unless the caller asks for another device."""
    device = _check_device(device)
    t = {k: torch.tensor(np.ascontiguousarray(np.asarray(fields[k])),
                         dtype=dt, device=device) for k, dt in TABLES.items()}
    packed = pack_walk_tables(fields)
    t.update({k: torch.from_numpy(packed[k]).to(device) for k in PACKED})
    refract = np.asarray(fields["mat_refract"])
    reflex = np.asarray(fields["mat_reflex"])
    left = np.asarray(fields["bvh_left"])
    n = np.asarray(fields["bvh_n"])
    nodes = bvh_mod.BVHArrays(left=left, right=np.asarray(fields["bvh_right"]),
                              n=n, index=np.asarray(fields["bvh_index"]),
                              aa=np.asarray(fields["bvh_aa"]),
                              bb=np.asarray(fields["bvh_bb"]))
    return SceneData(
        **t,
        bvh_root=packed["bvh_root"],
        n_triangles=int(len(fields["tri_p1"])),
        n_objects=int(len(refract)),
        n_emit=int(len(fields["emit_idx"])),
        n_nodes=int(len(left)),
        leaf_size=int(fields["leaf_size"]),
        has_sss=bool((refract == material_mod.SUB_SURFACE).any()),
        has_refract=bool((refract == material_mod.DIR_REFRACT).any()),
        has_mirror=bool((reflex == material_mod.MIRROR).any()),
        bvh_depth=bvh_mod.tree_depth(nodes),
        bvh_builder=str(fields.get("bvh_builder", "")),
    )


def _triangle_area(p1, p2, p3) -> np.ndarray:
    """0.5 * |(p2-p1) x (p3-p1)| (PathTrace.cu:897-903), the JAX
    package's vecmath.triangle_area on NumPy."""
    a, b = p2 - p1, p3 - p1
    c = np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                  a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                  a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)
    return 0.5 * np.sqrt(np.sum(c * c, axis=-1))


def assemble_numpy(objects: List[SceneObject], env_map: np.ndarray,
                   leaf_size: int = 8, bvh_method: str = "sah",
                   bvh_backend: str = "auto") -> dict:
    """Build the ``TABLES`` arrays on the host (NumPy), plus ``leaf_size``
    and ``bvh_builder``, the builder that ran. ``bvh_backend`` as the JAX
    package's ``assemble``: 'auto' takes the native SAH builder
    (accel/native.py) when its library builds and the NumPy one otherwise;
    'native' and 'numpy' force one."""
    if bvh_backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown BVH backend {bvh_backend!r}")
    if not objects:
        raise ValueError("scene needs at least one object")
    p1 = np.concatenate([o.mesh.p1 for o in objects])
    p2 = np.concatenate([o.mesh.p2 for o in objects])
    p3 = np.concatenate([o.mesh.p3 for o in objects])
    norm = np.concatenate([o.mesh.norm for o in objects])
    t = len(p1)
    obj_idx = np.concatenate(
        [np.full(o.mesh.n_triangles, i, np.int32) for i, o in enumerate(objects)]
    )

    # per-object load-order segments (Obj_seg, PathTrace.cu:435-436)
    counts = np.array([o.mesh.n_triangles for o in objects], np.int64)
    seg_end = np.cumsum(counts) - 1
    seg_begin = seg_end - counts + 1

    # area prefix sums in load order (PathTrace.cu:1538-1546)
    areas = _triangle_area(p1.astype(np.float64), p2.astype(np.float64),
                           p3.astype(np.float64))
    prefix_area = np.empty(t, np.float32)
    for b, e in zip(seg_begin, seg_end):
        prefix_area[b : e + 1] = np.cumsum(areas[b : e + 1])
    obj_total_area = prefix_area[seg_end].astype(np.float32)

    # BVH build reorders triangles (PathTrace.cu:1565)
    if bvh_backend == "native" or (bvh_backend == "auto" and native.available()):
        builder = "native"
        nodes, perm = native.build(p1, p2, p3, leaf_size=leaf_size, method=bvh_method,
                                   required=True)
    else:
        builder = "numpy"
        nodes, perm = bvh_mod.build(p1, p2, p3, leaf_size=leaf_size, method=bvh_method)
    p1, p2, p3, norm, obj_idx = (a[perm] for a in (p1, p2, p3, norm, obj_idx))
    mapping = np.empty(t, np.int32)
    mapping[perm] = np.arange(t, dtype=np.int32)

    # emissive registry in sorted space (PathTrace.cu:1596-1600)
    mats = [o.material for o in objects]
    emissive = np.array([m.emissive for m in mats], np.float32)
    is_emissive_obj = (emissive > material_mod.EMISSIVE_THRESHOLD).any(axis=1)
    emit_idx = np.nonzero(is_emissive_obj[obj_idx])[0].astype(np.int32)

    return dict(
        tri_p1=p1, tri_p2=p2, tri_p3=p3, tri_norm=norm, tri_obj=obj_idx,
        mat_emissive=emissive,
        mat_brdf=np.array([m.brdf for m in mats], np.float32),
        mat_reflex=np.array([m.reflex_mode for m in mats], np.int32),
        mat_refract=np.array([m.refract_mode for m in mats], np.int32),
        mat_refract_rate=np.array([m.refract_rate for m in mats], np.float32),
        mat_refract_albedo=np.array([m.refract_albedo for m in mats], np.float32),
        mat_refract_index=np.array([m.refract_index for m in mats], np.float32),
        emit_idx=emit_idx,
        light_p1=p1[emit_idx], light_p2=p2[emit_idx], light_p3=p3[emit_idx],
        light_norm=norm[emit_idx],
        light_emis=emissive[obj_idx[emit_idx]],
        light_area=_triangle_area(p1[emit_idx], p2[emit_idx],
                                  p3[emit_idx]).astype(np.float32),
        prefix_area=prefix_area, obj_total_area=obj_total_area,
        mapping=mapping, seg_begin=seg_begin.astype(np.int32),
        seg_end=seg_end.astype(np.int32),
        bvh_left=nodes.left, bvh_right=nodes.right, bvh_n=nodes.n,
        bvh_index=nodes.index, bvh_aa=nodes.aa, bvh_bb=nodes.bb,
        env_map=np.asarray(env_map, np.float32),
        leaf_size=leaf_size, bvh_builder=builder,
    )


def assemble(objects: List[SceneObject], env_map: np.ndarray,
             leaf_size: int = 8, bvh_method: str = "sah", bvh_backend: str = "auto",
             device="cuda") -> SceneData:
    """Build the scene on the host (``assemble_numpy``) and place its
    tables on ``device`` (the card unless the caller asks for the CPU; no
    CUDA device is an error)."""
    _check_device(device)
    return scene_from_numpy(assemble_numpy(objects, env_map, leaf_size, bvh_method,
                                           bvh_backend), device)
