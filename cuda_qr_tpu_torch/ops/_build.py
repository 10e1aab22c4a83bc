"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for sm_90a into one
shared library with a plain C interface, loaded with ctypes.  The library
goes to ``build/cuda_qr_tpu_torch/`` beside the package (git-ignored), named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads.  Only sources in this repository are compiled; a
missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cuda_qr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = 0.0   # time the last compile took (0.0 when the cache hit)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # G, L, Li, nb, batch, stream
    "cqt_chol_inv_f32": [_P, _P, _P, _I, _I, _P],
    "cqt_chol_inv_f64": [_P, _P, _P, _I, _I, _P],
    # panelT, packedT, tau, T, m, w, off, stream
    "cqt_geqrt_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cqt_geqrt_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    # panelsT, packedT, tau, T, batch, m, w, off, stream
    "cqt_geqrt_batched_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cqt_geqrt_batched_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # S, norms, S scratch, norms scratch, ord, l, cand, nb, stream
    "cqt_select_pivots_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of cuda_qr_tpu_torch are built from csrc/ at first use")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcqt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for the current sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Compile to a private name, then rename: concurrent processes never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")
