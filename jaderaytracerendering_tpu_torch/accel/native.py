"""ctypes binding to the native C++ scene runtime: the SAH BVH builder and
the OBJ parser of ``runtime/jade_native.cpp``.

The JAX package's accel/native.py, with the same entry points and ctypes
signatures. The port keeps its own copy of the source and builds it at
first use with ``g++ -O3 -fPIC -shared -std=c++17`` (no ``-march=native``:
the tree does not depend on it) into the package's ``build/`` directory,
named by a hash of the source and the flags. The library is written to a
temporary file and moved into place, so builders that race (test
workers) each see all of it or none. With no C++ compiler the library is
unavailable: ``build`` falls back to the NumPy builder (accel/bvh.py, the
same semantics) unless ``required``; a compile that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

from ..ops.build import BUILD_DIR
from . import bvh as bvh_mod

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "runtime" / "jade_native.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_lib = None
_lib_checked = False


def find_compiler() -> str | None:
    return shutil.which("g++")


def library_path() -> pathlib.Path:
    """``build/libjade_native-<hash>.so``, the hash over flags and source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libjade_native-{digest.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path | None:
    """Compile ``runtime/jade_native.cpp`` unless its library exists ->
    its path, or None when there is no C++ compiler."""
    out = library_path()
    if out.exists():
        return out
    cxx = find_compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", lib, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, out)
    return out


def load_library():
    """Build (first use) and load the native library, memoized; None when
    there is no C++ compiler."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    path = build_library()
    _lib_checked = True
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.jade_build_bvh_sah.restype = ctypes.c_int64
    lib.jade_build_bvh_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # p1 [T*3]
        ctypes.POINTER(ctypes.c_float),   # p2
        ctypes.POINTER(ctypes.c_float),   # p3
        ctypes.c_int64,                   # T
        ctypes.c_int32,                   # leaf_size
        ctypes.c_int32,                   # method: 0 sah, 1 median
        ctypes.POINTER(ctypes.c_int64),   # out perm [T]
        ctypes.POINTER(ctypes.c_int32),   # out left [cap]
        ctypes.POINTER(ctypes.c_int32),   # out right
        ctypes.POINTER(ctypes.c_int32),   # out n
        ctypes.POINTER(ctypes.c_int32),   # out index
        ctypes.POINTER(ctypes.c_float),   # out aa [cap*3]
        ctypes.POINTER(ctypes.c_float),   # out bb [cap*3]
        ctypes.c_int64,                   # cap
    ]
    lib.jade_parse_obj_counts.restype = ctypes.c_int64
    lib.jade_parse_obj_counts.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.jade_parse_obj.restype = ctypes.c_int64
    lib.jade_parse_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def parse_obj(path: str, compat_slash_faces: bool = False):
    """Native OBJ parse -> (vertices [V,3] f64, 0-based faces [F,3] i64),
    or None if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.jade_parse_obj_counts(path.encode(), ctypes.byref(nv), ctypes.byref(nf),
                                   1 if compat_slash_faces else 0)
    if rc < 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nf.value, 3), np.int64)
    rc = lib.jade_parse_obj(
        path.encode(),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nv.value, nf.value, 1 if compat_slash_faces else 0)
    if rc < 0:
        raise RuntimeError(f"native OBJ parse failed ({rc}) for {path}")
    return verts, faces


def build(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray, leaf_size: int = 8,
          method: str = "sah", required: bool = False
          ) -> tuple[bvh_mod.BVHArrays, np.ndarray]:
    """Build the BVH natively -> (nodes, permutation); without the library,
    the NumPy builder, or RuntimeError if ``required``."""
    lib = load_library()
    if lib is None:
        if required:
            raise RuntimeError("native BVH builder requested but no C++ compiler (g++) "
                               "is available to build runtime/jade_native.cpp")
        return bvh_mod.build(p1, p2, p3, leaf_size=leaf_size, method=method)

    t = len(p1)
    cap = max(2 * t + 2, 8)
    p1c, p2c, p3c = (np.ascontiguousarray(a, np.float32) for a in (p1, p2, p3))
    perm = np.empty(t, np.int64)
    left, right, n, index = (np.empty(cap, np.int32) for _ in range(4))
    aa = np.empty((cap, 3), np.float32)
    bb = np.empty((cap, 3), np.float32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n_nodes = lib.jade_build_bvh_sah(
        ptr(p1c, ctypes.c_float), ptr(p2c, ctypes.c_float), ptr(p3c, ctypes.c_float),
        t, leaf_size, 0 if method == "sah" else 1,
        ptr(perm, ctypes.c_int64),
        ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
        ptr(n, ctypes.c_int32), ptr(index, ctypes.c_int32),
        ptr(aa, ctypes.c_float), ptr(bb, ctypes.c_float), cap)
    if n_nodes < 0:
        raise RuntimeError(f"native BVH build failed (code {n_nodes})")
    k = int(n_nodes)
    nodes = bvh_mod.BVHArrays(left=left[:k].copy(), right=right[:k].copy(), n=n[:k].copy(),
                              index=index[:k].copy(), aa=aa[:k].copy(), bb=bb[:k].copy())
    return nodes, perm
