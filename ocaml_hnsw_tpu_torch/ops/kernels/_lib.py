"""Build and load the hand-written CUDA kernels in `ocaml_hnsw_tpu_torch/csrc`.

nvcc compiles every `csrc/*.cu` for Hopper (`sm_90a`), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which ctypes loads.  The library lands in
`ocaml_hnsw_tpu_torch/build/` (git-ignored) under a name that hashes the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _int = ctypes.c_void_p, ctypes.c_int
#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so 64-bit addresses are not cut to ints)
_SIGNATURES = {
    "ohnsw_gather_dists": [_vp, _int, _vp, _vp, _vp, _vp,
                           _int, _int, _int, _int, _int, _int,
                           _int, _int, _int, _int, _int, _int, _vp],
    "ohnsw_packed_score": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _int, _int, _int, _int, _int, _int, _int,
                           _int, _int, _int, _int, _int, _int, _int,
                           _vp],
    "ohnsw_packed_score_occupancy": [_int, _int, _int, _int, _vp],
    "ohnsw_scan_topk": [_vp, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp, _vp, _int, _int, _int, _int, _int, _int,
                        _int, _int, _int, _int, _int, _int, _int, _int,
                        _int, _int, _int, _vp],
    "ohnsw_scan_topk_occupancy": [_int, _int, _int, _int, _int, _int, _vp],
}
#: dynamic shared memory one block may opt into on Hopper (227 KiB)
SMEM_LIMIT = 232448

_lib = None
build_log = ""  # ptxas report of the last build (registers, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libohnsw_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this exact source set has no library yet.
    Returns the library's path; `build_log` keeps nvcc's report."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, out.name)
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        build_log = "".join(logs)
        if not os.path.exists(lib):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(lib, out)  # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
