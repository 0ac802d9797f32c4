"""Build the package's CUDA sources into a shared library and load it.

The kernels in ``csrc/`` have a plain C interface and are bound with
ctypes, so a build is one ``nvcc`` call that does not include PyTorch's
headers (seconds, not minutes). The library lands in ``build/`` inside
the package, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# --fmad=false: no contraction of a*b+c into FMA, so the kernels round
# like the plain torch versions (one op, one rounding); never fast-math
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, sources: list[str]) -> pathlib.Path:
    """Compile ``csrc/<sources>`` (plus every header there) into
    ``build/<name>-<hash>.so`` unless that file exists; return its path."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources)))
