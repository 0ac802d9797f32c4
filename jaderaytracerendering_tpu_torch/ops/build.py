"""Build the package's CUDA sources into a shared library and load it.

The kernels in ``csrc/`` have a plain C interface and are bound with
ctypes, so a build does not include PyTorch's headers (seconds, not
minutes): one ``nvcc -c`` per source, all started together, then one
link. The library lands in ``build/`` inside the package, named by a hash
of the sources, the headers and the flags, so a changed source rebuilds
and an unchanged one loads at once; the compilers' output (``-Xptxas -v``:
registers, stack, spills per kernel) is kept beside it as ``.log``.
Nothing here runs at import time.
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
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, sources: list[str]) -> pathlib.Path:
    """``build/<name>-<hash>.so``, the hash over flags, sources and headers."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / s for s in sources] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; raise on the first that
    failed; return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library(name: str, sources: list[str]) -> pathlib.Path:
    """Compile ``csrc/<sources>`` into ``build/<name>-<hash>.so`` unless
    that file exists; return its path."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, pathlib.Path(s).stem + ".o") for s in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC_DIR / s)]
                        for s, o in zip(sources, objs)])
        lib = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", lib, *objs]])
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
    return out


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources)))
