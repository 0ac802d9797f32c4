"""SAH BVH builder over triangle soups.

Reimplements buildBVHwithSAH (PathTrace.cpp:532-663, PathTrace.cu:497-628)
with NumPy-vectorized sweeps:

- full-sort SAH: per node, triangles in [l, r] are sorted by centroid on
  each axis; prefix/suffix AABB sweeps give cost
  ``2*(xy+xz+yz)_left * nLeft + 2*(xy+xz+yz)_right * nRight``; best
  (axis, split) over all three axes wins;
- leaves hold <= leaf_size triangles (8 in the reference,
  PathTrace.cpp:1086);
- node 0 is a garbage sentinel and the real root is node 1, matching the
  reference's testNode push (PathTrace.cpp:1078-1084, PathTrace.cu:1557-1563)
  and both traversers starting at stack[0]=1 (PathTrace.cu:804,
  fshader_render.fsh:275);
- the (unused-in-reference) midpoint builder buildBVH
  (PathTrace.cpp:469-529) is provided as ``method='median'``.

The builder returns SoA node arrays plus the triangle permutation — the
triangles themselves are reordered by the caller, mirroring the in-place
sorts of the reference.

Host-side NumPy: the same builder as the JAX package's accel/bvh.py, so
both packages build identical trees from identical triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INF = 2147483647.0  # PathTrace.cu:23


@dataclasses.dataclass
class BVHArrays:
    """Flat SoA BVH. Node 0 is a sentinel; root is node 1 (if any)."""

    left: np.ndarray   # [K] int32, 0 = none
    right: np.ndarray  # [K] int32, 0 = none
    n: np.ndarray      # [K] int32, >0 marks a leaf with n triangles
    index: np.ndarray  # [K] int32, first triangle of a leaf (sorted order)
    aa: np.ndarray     # [K, 3] float32 box min
    bb: np.ndarray     # [K, 3] float32 box max

    @property
    def n_nodes(self) -> int:
        return len(self.left)


_SENTINEL = dict(  # PathTrace.cu:1557-1563
    left=255, right=128, n=30, index=0,
    aa=(1.0, 1.0, 0.0), bb=(0.0, 1.0, 0.0),
)


def build(
    p1: np.ndarray,
    p2: np.ndarray,
    p3: np.ndarray,
    leaf_size: int = 8,
    method: str = "sah",
) -> tuple[BVHArrays, np.ndarray]:
    """Build a BVH -> (nodes, perm). perm maps sorted position -> original index.

    Callers reorder triangle arrays with ``tri[perm]`` after building.
    """
    t = len(p1)
    lo = np.minimum(np.minimum(p1, p2), p3).astype(np.float64)
    hi = np.maximum(np.maximum(p1, p2), p3).astype(np.float64)
    centroid = ((p1 + p2 + p3) / 3.0).astype(np.float64)

    order = np.arange(t, dtype=np.int64)
    nodes_left: list[int] = [_SENTINEL["left"]]
    nodes_right: list[int] = [_SENTINEL["right"]]
    nodes_n: list[int] = [_SENTINEL["n"]]
    nodes_index: list[int] = [_SENTINEL["index"]]
    nodes_aa: list = [np.asarray(_SENTINEL["aa"], np.float64)]
    nodes_bb: list = [np.asarray(_SENTINEL["bb"], np.float64)]

    def new_node(l: int, r: int) -> int:
        nid = len(nodes_left)
        nodes_left.append(0)
        nodes_right.append(0)
        nodes_n.append(0)
        nodes_index.append(0)
        ids = order[l : r + 1]
        nodes_aa.append(lo[ids].min(axis=0))
        nodes_bb.append(hi[ids].max(axis=0))
        return nid

    def half_area2(amin: np.ndarray, amax: np.ndarray) -> np.ndarray:
        ln = amax - amin
        return 2.0 * (ln[..., 0] * ln[..., 1] + ln[..., 0] * ln[..., 2]
                      + ln[..., 1] * ln[..., 2])

    # Iterative recursion (explicit stack) — deep meshes overflow
    # Python's recursion limit. Children must be numbered exactly as the
    # reference's recursion would (left subtree fully before right), so we
    # process a child completely before its sibling via DFS where parents
    # record pending child slots.
    def build_range(l: int, r: int) -> int:
        if l > r:
            return 0
        # manual stack of (l, r, parent_id, which_child)
        root_id = -1
        stack = [(l, r, -1, 0)]
        while stack:
            cl, cr, parent, slot = stack.pop()
            nid = new_node(cl, cr)
            if parent >= 0:
                if slot == 0:
                    nodes_left[parent] = nid
                else:
                    nodes_right[parent] = nid
            else:
                root_id = nid
            count = cr - cl + 1
            if count <= leaf_size:
                nodes_n[nid] = count
                nodes_index[nid] = cl
                continue

            ids = order[cl : cr + 1]
            if method == "sah":
                best = (INF, 0, (cl + cr) // 2, None)  # cost, axis, split, sorted ids
                for axis in range(3):
                    s = ids[np.argsort(centroid[ids, axis], kind="stable")]
                    lmax = np.maximum.accumulate(hi[s], axis=0)
                    lmin = np.minimum.accumulate(lo[s], axis=0)
                    rmax = np.maximum.accumulate(hi[s][::-1], axis=0)[::-1]
                    rmin = np.minimum.accumulate(lo[s][::-1], axis=0)[::-1]
                    n_l = np.arange(1, count, dtype=np.float64)
                    cost = (half_area2(lmin[:-1], lmax[:-1]) * n_l
                            + half_area2(rmin[1:], rmax[1:]) * (count - n_l))
                    i = int(np.argmin(cost))
                    c = float(cost[i])
                    if c < best[0]:
                        best = (c, axis, cl + i, s)
                _, _, split, s = best
                order[cl : cr + 1] = s
            elif method == "median":
                # midpoint builder (PathTrace.cpp:469-529): longest axis,
                # sort, split at the middle.
                ext = hi[ids].max(axis=0) - lo[ids].min(axis=0)
                axis = int(np.argmax(ext))
                s = ids[np.argsort(centroid[ids, axis], kind="stable")]
                order[cl : cr + 1] = s
                split = (cl + cr) // 2
            else:
                raise ValueError(f"unknown BVH method {method!r}")

            # push right first so left is popped (and numbered) first,
            # matching the reference's recursion order
            stack.append((split + 1, cr, nid, 1))
            stack.append((cl, split, nid, 0))
        return root_id

    if t > 0:
        build_range(0, t - 1)

    nodes = BVHArrays(
        left=np.asarray(nodes_left, np.int32),
        right=np.asarray(nodes_right, np.int32),
        n=np.asarray(nodes_n, np.int32),
        index=np.asarray(nodes_index, np.int32),
        aa=np.asarray(np.stack(nodes_aa), np.float32),
        bb=np.asarray(np.stack(nodes_bb), np.float32),
    )
    return nodes, order


def tree_depth(nodes: BVHArrays) -> int:
    """Max levels from the root (leaf-only tree = 1). The stackful
    traversal (ops.traverse) pops one node and pushes at most two per
    step, so its worst-case stack occupancy is depth + 1 — callers
    validate bvh_stack_size against this instead of silently dropping
    children on overflow."""
    if nodes.n_nodes <= 1:
        return 0
    depth = 0
    frontier = np.array([1], np.int64)
    while frontier.size:
        depth += 1
        inner = frontier[nodes.n[frontier] == 0]
        frontier = np.concatenate([nodes.left[inner], nodes.right[inner]])
        frontier = frontier[frontier > 0]
    return depth


def check_invariants(nodes: BVHArrays, n_triangles: int, leaf_size: int = 8) -> None:
    """Assert structural invariants (SURVEY §4): leaf ranges partition
    [0, N), children boxes are contained in parents, every node reachable
    exactly once from the root."""
    if n_triangles == 0:
        return
    seen = np.zeros(n_triangles, np.int32)
    visited = np.zeros(nodes.n_nodes, bool)
    stack = [1]
    while stack:
        i = stack.pop()
        assert 0 < i < nodes.n_nodes, f"node id {i} out of range"
        assert not visited[i], f"node {i} visited twice"
        visited[i] = True
        if nodes.n[i] > 0:
            assert nodes.n[i] <= leaf_size
            lo_i, hi_i = nodes.index[i], nodes.index[i] + nodes.n[i]
            assert 0 <= lo_i and hi_i <= n_triangles
            seen[lo_i:hi_i] += 1
        else:
            l, r = int(nodes.left[i]), int(nodes.right[i])
            assert l > 0 and r > 0, f"inner node {i} missing children"
            for c in (l, r):
                assert (nodes.aa[c] >= nodes.aa[i] - 1e-5).all()
                assert (nodes.bb[c] <= nodes.bb[i] + 1e-5).all()
            stack += [l, r]
    assert (seen == 1).all(), "leaf ranges do not partition the triangles"
    assert visited[1:].all(), "unreachable nodes"
