"""The kernels' packed walk tables (``scene.pack_walk_tables``): value for
value the SoA tables they are packed from, the same from ``assemble`` and
from the JAX package's NumPy fields, and walked in the kernels' order
(``csrc/path.cuh`` ``bvh_nearest_hit``, here in Python) they give the
plain walk's hits bit for bit. The stack-size rule of the kernels'
wrappers raises where it raised before the tables were packed.

Tolerance: none — exact equality (floats compared as their bits)."""

import dataclasses

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu_torch.core.vecmath import V3, vnormalize
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import intersect, kernels, traverse
from jaderaytracerendering_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

SCENES = {"jade": dict(n_buddha_tris=300, env_shape=(16, 32)), "cornell": {}}


def _scene(name):
    ds = getattr(tdemo, f"{name}_scene")(**SCENES[name])
    return tscene.assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _decode(word):
    """A child word -> ("inner", record) | ("leaf", count, first) | ("none",)."""
    if word >= 0:
        return ("inner", word)
    if word == tscene.LEAF_FLAG:
        return ("none",)
    w = word & 0xFFFFFFFF
    return ("leaf", (w >> 24) & 0x7F, w & 0xFFFFFF)


def _child(sd, c, record_of):
    if c <= 0:
        return ("none",)
    n = int(sd.bvh_n[c])
    return ("leaf", n, int(sd.bvh_index[c])) if n > 0 else ("inner", record_of[c])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_tables_equal_soa(name):
    sd = _scene(name)
    n = sd.bvh_n.numpy()
    inner = [i for i in range(1, sd.n_nodes) if n[i] <= 0]
    record_of = {node: r for r, node in enumerate(inner)}
    nodes = sd.bvh_nodes.numpy()
    assert sd.bvh_nodes.dtype == torch.int32 and nodes.shape == (len(inner), 16)
    aa, bb = _bits(sd.bvh_aa).numpy(), _bits(sd.bvh_bb).numpy()
    leaves = 0
    for r, node in enumerate(inner):
        rec = nodes[r]
        for side, c, off in (("l", int(sd.bvh_left[node]), 0), ("r", int(sd.bvh_right[node]), 6)):
            want = _child(sd, c, record_of)
            assert _decode(int(rec[12 + (side == "r")])) == want, (node, side)
            leaves += want[0] == "leaf"
            box = np.concatenate([aa[c], bb[c]]) if c > 0 else np.zeros(6, np.int32)
            np.testing.assert_array_equal(rec[off:off + 6], box)
        np.testing.assert_array_equal(rec[14:], 0)
    assert leaves == int((n[1:] > 0).sum()) - int(n[1] > 0)  # every leaf but a leaf root
    assert _decode(sd.bvh_root) == (_child(sd, 1, record_of) if sd.n_nodes > 1 else ("none",))
    tris = _bits(sd.tri_packed).numpy()
    assert tris.shape == (sd.n_triangles, 12)
    for j, k in enumerate(("tri_p1", "tri_p2", "tri_p3")):
        np.testing.assert_array_equal(tris[:, 3 * j:3 * j + 3], _bits(getattr(sd, k)).numpy())
    np.testing.assert_array_equal(tris[:, 9:], 0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_tables_from_jax_fields(name):
    j = getattr(jdemo, f"{name}_scene")(**SCENES[name])
    sj = jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy")
    back = tscene.scene_from_numpy({f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
                                   device="cpu")
    st = _scene(name)
    for k in tscene.PACKED:
        assert torch.equal(_bits(getattr(back, k)), _bits(getattr(st, k))), k
    assert back.bvh_root == st.bvh_root


def _packed_walk(sd, o, d, excl):
    """csrc/path.cuh bvh_nearest_hit on one ray, step for step, with the
    plain walk's arithmetic (ops/intersect on one-element tensors) ->
    (t, id, deepest stack)."""
    nodes = sd.bvh_nodes
    tris = sd.tri_packed
    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    f32 = lambda w: one(0.0).view(torch.int32).fill_(int(w)).view(torch.float32)  # noqa: E731
    best_t, best_i = intersect.INF, 0
    o = V3(*(one(v) for v in o))
    d = vnormalize(V3(*(one(v) for v in d)))
    inv = V3(torch.reciprocal(d.x), torch.reciprocal(d.y), torch.reciprocal(d.z))
    stack, deepest = [sd.bvh_root], 1
    while stack:
        w = stack.pop()
        if w < 0:
            _, cnt, first = _decode(w)
            for i in range(first, first + cnt):
                if i == excl:
                    continue
                p = tris[i]
                hit, t = intersect.ray_triangle(o, d, V3(*p[0:3]), V3(*p[3:6]), V3(*p[6:9]))
                t = float(t)
                if bool(hit) and t < intersect.INF and (
                        t < best_t or (t == best_t and i < best_i)):
                    best_t, best_i = t, i
            continue
        rec = nodes[w]
        box = [V3(*(f32(v) for v in rec[k:k + 3])) for k in (0, 3, 6, 9)]
        l, r = int(rec[12]), int(rec[13])
        el, dl = intersect.ray_aabb(o, inv, box[0], box[1]) if l != tscene.LEAF_FLAG \
            else (0.0, -1.0)
        er, dr = intersect.ray_aabb(o, inv, box[2], box[3]) if r != tscene.LEAF_FLAG \
            else (0.0, -1.0)
        push_l = l != tscene.LEAF_FLAG and float(dl) > 0 and float(el) <= best_t
        push_r = r != tscene.LEAF_FLAG and float(dr) > 0 and float(er) <= best_t
        near_l = float(dl) < float(dr)
        if push_l and push_r:
            stack += [r, l] if near_l else [l, r]
        elif push_l or push_r:
            stack.append(l if push_l else r)
        deepest = max(deepest, len(stack))
    return best_t, best_i, deepest


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_walk_matches_plain_walk(name):
    sd = _scene(name)
    g = np.random.default_rng(11)
    m = 48
    lo, hi = sd.bvh_aa[1].numpy(), sd.bvh_bb[1].numpy()
    o = g.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (m, 3)).astype(np.float32)
    d = (g.uniform(lo, hi, (m, 3)).astype(np.float32) - o).astype(np.float32)
    ex = g.integers(-1, sd.n_triangles, m).astype(np.int32)
    hit, idx, t = traverse.nearest_hit_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                           torch.from_numpy(ex), sd)
    assert bool(hit.any())
    for i in range(m):
        pt, pi, deepest = _packed_walk(sd, o[i], d[i], int(ex[i]))
        assert (pi, np.float32(pt).view(np.int32)) == \
            (int(idx[i]), t[i].numpy().view(np.int32)), i
        assert deepest <= sd.bvh_depth + 1


def test_stack_size_rule_raises():
    sd = _scene("jade")
    with pytest.raises(ValueError, match="BVH depth"):
        kernels.check_scene(sd, kernels.MAX_STACK + 1)
    with pytest.raises(ValueError, match="BVH depth"):
        kernels.check_scene(sd, sd.bvh_depth)
    for ok in (sd.bvh_depth + 1, kernels.MAX_STACK):  # then only the device is refused
        with pytest.raises(ValueError, match="needs CUDA"):
            kernels.check_scene(sd, ok)
    with pytest.raises(ValueError, match="BVH depth"):
        traverse.nearest_hit_bvh(torch.zeros(1, 3), torch.ones(1, 3),
                                 torch.zeros(1, dtype=torch.int32), sd, sd.bvh_depth)


def test_scene_without_packed_tables_is_refused():
    sd = _scene("cornell")
    for k in tscene.PACKED:
        with pytest.raises(ValueError, match="packed walk tables"):
            kernels.check_scene(dataclasses.replace(sd, **{k: None}), 128)
    moved = dataclasses.replace(sd, bvh_nodes=None).to("meta")
    assert moved.bvh_nodes is None and moved.tri_packed.device.type == "meta"
