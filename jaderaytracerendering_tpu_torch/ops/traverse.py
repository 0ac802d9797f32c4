"""Stackful BVH nearest-hit walk over ray batches (plain torch).

The JAX package's ops/traverse.py: an explicit per-ray stack, root at
node 1 (node 0 is a sentinel), near child first by the reference's AABB
distance (PathTrace.cu:835-848), ordered pruning against the ray's best
hit, and leaves tested brute-force with source-index exclusion. All rays
step together; rays whose stack is empty drop out of the batch.

Two rules make the result independent of visit order, so that this walk,
the brute-force sweep and the CUDA kernels' walk (csrc/path.cuh
``bvh_nearest_hit``, which runs the same steps per thread) agree:
on equal t the minimum triangle id wins (the sweep kernels' rule,
ops/pallas/cluster_sweep_fused.py:26-29 of the JAX package), and a box
is pruned only when its entry lies strictly beyond the best hit. A ray
with a zero direction is a miss.

Inside ``count_work()`` every walk counts its box tests (one per child
of each inner node it visits) and its ray-triangle tests: the work a
traversal kernel does on the same rays, for its roofline bound.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.vecmath import V3, vnormalize, vrows
from .intersect import INF, ray_aabb, ray_triangle


_WORK: list = []  # the count dicts of the open count_work() blocks


@contextlib.contextmanager
def count_work():
    """Yield {"boxes": n, "tris": n}, the tests of every walk in the block."""
    work = {"boxes": 0, "tris": 0}
    _WORK.append(work)
    try:
        yield work
    finally:
        _WORK.pop()


def _take(v: V3, idx) -> V3:
    return V3(v.x[idx], v.y[idx], v.z[idx])


def _col(v: V3) -> V3:
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def nearest_hit_bvh(origins: torch.Tensor, dirs: torch.Tensor,
                    exclude: torch.Tensor, sd, stack_size: int = 128):
    """[M, 3] origins/dirs, [M] excluded triangle ids -> (hit [M] bool,
    index [M] int32 (0 on a miss), t [M] f32 (INF on a miss)). ``dirs``
    are normalized here, as the JAX walk does."""
    work = _WORK[-1] if _WORK else None
    if sd.bvh_depth + 1 > stack_size:
        raise ValueError(f"BVH depth {sd.bvh_depth} + 1 exceeds the stack "
                         f"of {stack_size} entries")
    dev = origins.device
    m = origins.shape[0]
    o = vrows(origins.to(torch.float32))
    raw = vrows(dirs.to(torch.float32))
    d = vnormalize(raw)
    inv = V3(torch.reciprocal(d.x), torch.reciprocal(d.y), torch.reciprocal(d.z))
    exclude = exclude.to(torch.int32)
    best_t = torch.full((m,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((m,), dtype=torch.int32, device=dev)
    stack = torch.zeros((m, stack_size), dtype=torch.int32, device=dev)
    stack[:, 0] = 1
    walking = (raw.x != 0) | (raw.y != 0) | (raw.z != 0)
    if sd.n_nodes <= 1:
        walking = torch.zeros_like(walking)
    sp = walking.to(torch.int32)
    ks = torch.arange(sd.leaf_size, dtype=torch.int32, device=dev)
    tri = (vrows(sd.tri_p1), vrows(sd.tri_p2), vrows(sd.tri_p3))
    box = (vrows(sd.bvh_aa), vrows(sd.bvh_bb))

    lanes = torch.nonzero(walking).squeeze(1)
    while lanes.numel():
        spm = sp[lanes] - 1
        top = stack[lanes, spm]
        n = sd.bvh_n[top]
        bt = best_t[lanes]
        bi = best_i[lanes]
        ol, dl, il = _take(o, lanes), _take(d, lanes), _take(inv, lanes)

        # leaf: nearest of up to leaf_size triangles, then merge with best
        ids = sd.bvh_index[top][:, None] + ks[None, :]
        valid = ((n > 0)[:, None] & (ks[None, :] < n[:, None])
                 & (ids != exclude[lanes][:, None]))
        safe = torch.where(valid, ids, 0)
        if work is not None:
            work["tris"] += int(valid.sum())
        hit, t = ray_triangle(_col(ol), _col(dl), _take(tri[0], safe),
                              _take(tri[1], safe), _take(tri[2], safe))
        t = torch.where(valid & hit, t, INF)
        j = torch.argmin(t, dim=1, keepdim=True)  # first = lowest id on ties
        tc = t.gather(1, j)[:, 0]
        ic = ids.gather(1, j)[:, 0]
        better = (tc < bt) | ((tc == bt) & (ic < bi) & (tc < INF))
        bt = torch.where(better, tc, bt)
        bi = torch.where(better, ic, bi)

        # inner: child boxes, near child pushed last so it pops first
        left = sd.bvh_left[top]
        right = sd.bvh_right[top]
        l_ok = (n <= 0) & (left > 0)
        r_ok = (n <= 0) & (right > 0)
        if work is not None:
            work["boxes"] += int(l_ok.sum() + r_ok.sum())
        sl = torch.where(l_ok, left, 0)
        sr = torch.where(r_ok, right, 0)
        enter_l, dist_l = ray_aabb(ol, il, _take(box[0], sl), _take(box[1], sl))
        enter_r, dist_r = ray_aabb(ol, il, _take(box[0], sr), _take(box[1], sr))
        push_l = l_ok & (dist_l > 0) & (enter_l <= bt)
        push_r = r_ok & (dist_r > 0) & (enter_r <= bt)
        both = push_l & push_r
        near_is_l = dist_l < dist_r
        first = torch.where(both, torch.where(near_is_l, right, left),
                            torch.where(push_l, left, right))
        second = torch.where(near_is_l, left, right)
        write1 = push_l | push_r
        write2 = both & (spm + 1 < stack_size)
        stack[lanes[write1], spm[write1]] = first[write1]
        stack[lanes[write2], spm[write2] + 1] = second[write2]
        new_sp = spm + write1.to(torch.int32) + write2.to(torch.int32)
        sp[lanes] = new_sp
        best_t[lanes] = bt
        best_i[lanes] = bi
        lanes = lanes[new_sp > 0]
    return best_t < INF, best_i, best_t
