"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for sm_90a into a shared
library of its own with a plain C interface, one process per source, all
started together; the libraries are loaded with ctypes.  They go to
``build/cuda_qr_tpu_torch/`` beside the package (git-ignored), each named by
a hash of its source and the flags, so an edited source rebuilds and an
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
build_seconds = 0.0   # wall time of the last build (0.0 when every library was cached)
build_log: dict[str, str] = {}   # ptxas resource lines (registers, spills, smem) per built source

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry points of each source: name -> argtypes.
_SIGNATURES = {
    "chol_inv.cu": {
        # G, L, Li, nb, batch, stream
        "cqt_chol_inv_f32": [_P, _P, _P, _I, _I, _P],
        "cqt_chol_inv_f64": [_P, _P, _P, _I, _I, _P],
    },
    "geqrt.cu": {
        # A, lda, packed, tau, T, batch, m, w, off, kb, resident, nslices, stream
        "cqt_geqrt_batched_f32": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "cqt_geqrt_batched_f64": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # A, lda, packed, tau, T, batch, m, w, stream
        "cqt_geqrt_blocked_f32": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
        # A, lda, packed, tau, T, batch, w, stream
        "cqt_geqrt_pair_f32": [_P, _I, _P, _P, _P, _I, _I, _P],
        "cqt_geqrt_pair_f64": [_P, _I, _P, _P, _P, _I, _I, _P],
        # w, f64
        "cqt_geqrt_pair_ctas_per_sm": [_I, _I],
    },
    "newton_inv.cu": {
        # M, N, err, cert, iters, nb, tol, max_iters, stream
        "cqt_newton_inv_f32": [_P, _P, _P, _P, _P, _I, _F, _I, _P],
    },
    "select_pivots.cu": {
        # S, norms, ord, l, cand, nb, stream
        "cqt_select_pivots_f32": [_P, _P, _P, _I, _I, _I, _P],
    },
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


def library_path(src: Path) -> Path:
    """The shared library of one source, named by a hash of it and the flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcqt_{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library does not exist yet, one nvcc per
    source, all started together: {source name: library}."""
    global build_seconds
    outs = {src.name: library_path(src) for src in _sources()}
    todo = [(src, outs[src.name]) for src in _sources() if not outs[src.name].exists()]
    build_seconds = 0.0
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    jobs = []
    for src, out in todo:
        # Compile to a private name, then rename: concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
        jobs.append((src, cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, cmd, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
            build_log[src.name] = "\n".join(
                line.strip() for line in stderr.splitlines()
                if "Compiling entry" in line or "Used" in line or "spill" in line)
    if errors:
        raise RuntimeError("\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return outs


class _Kernels:
    """The entry points of every kernel library, as attributes."""

    def __init__(self, paths: dict[str, Path]):
        self.paths = paths
        for src, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name, fn)


def load() -> _Kernels:
    """The kernel libraries, built on first call."""
    global _lib
    if _lib is None:
        _lib = _Kernels(build())
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")
