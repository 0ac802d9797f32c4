"""The roofline yardstick: the H100's published peaks and the least
time a piece of work could take on it.

The work of a sample is frozen in each traffic file as
``ops_per_sample`` (counted once, as the traffic file says, from the
plain BVH walk's box and triangle tests on a pixel subset, times
``BOX_OPS`` and ``TRI_OPS``, plus the shading of each bounce), so the
bound does not move when the program changes how it does the work."""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM (NVIDIA data sheet; 700 W)
PEAK_F32 = 67e12      # FP32 operations/s outside the tensor cores
# float operations of one ray-box slab test and one Moller-Trumbore
# triangle test, counted from csrc/path.cuh
BOX_OPS, TRI_OPS = 25, 57
# bytes of one triangle the walk and shading read: three float32 vertices
# (48), its normal (12) and its object id (4)
TRIANGLE_BYTES = 64


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of bytes / peak bandwidth and operations / FP32 peak."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def scene_bytes(n_triangles: int, env_texels: int) -> int:
    """The scene's tables read once: its triangles and the float32 sky."""
    return n_triangles * TRIANGLE_BYTES + env_texels * 12
