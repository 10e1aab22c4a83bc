"""ctypes binding to the C99 sliding-panel oracle (the counterpart of
``cuda_qr_tpu/oracle/binding.py``, over this package's own copy of the C
sources).

The oracle is the bit-level semantic reference of the source paper's
sliding-panel MMQR algorithm (``oracle_impl.h``); tests compare the blocked
factorizations against it the way the paper compares its GPU kernels
against qr.c.  It is host code, not a kernel.

At first use, ``cc`` builds ``libqroracle.so`` (and, on request, the
standalone harness ``qr_oracle_main``) with the reference Makefile's flags
into ``build/cuda_qr_tpu_torch/oracle/`` beside the package (git-ignored),
each named by a hash of the sources and the flags, as ``ops/_build.py``
does for the kernels: an edited source rebuilds, an unchanged one loads.
The package directory is never written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
ORACLE_BUILD_DIR = BUILD_DIR / "oracle"
CFLAGS = ["-O2", "-std=c99", "-Wall", "-Wextra", "-fPIC"]
_SOURCES = ("oracle_impl.h", "qr_oracle.c", "qr_oracle_main.c")


def _cc() -> str:
    return os.environ.get("CC", "cc")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path, flags: list[str], sources: list[str]) -> Path:
    """cc (the reference Makefile's command line) into a private name, then
    rename: concurrent processes never load a half-written file."""
    if out.exists():
        return out
    ORACLE_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=ORACLE_BUILD_DIR)
    os.close(fd)
    cmd = [_cc(), *CFLAGS, *flags, "-o", tmp, *(str(_DIR / s) for s in sources), "-lm"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"oracle build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """``libqroracle.so``, built on first call."""
    return _compile(ORACLE_BUILD_DIR / f"libqroracle_{_digest()}.so", ["-shared"],
                    ["qr_oracle.c"])


def main_binary() -> Path:
    """The standalone harness ``qr_oracle_main m n pr pc [trials]`` (one
    JSON line), built on first call."""
    return _compile(ORACLE_BUILD_DIR / f"qr_oracle_main_{_digest()}", [],
                    ["qr_oracle_main.c", "qr_oracle.c"])


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    dp = ctypes.POINTER(ctypes.c_double)
    sp = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    lib.mmqr_d.argtypes = [dp, dp, i, i, i, i]
    lib.mmqr_s.argtypes = [sp, sp, i, i, i, i]
    lib.explicit_qr_d.argtypes = [dp, dp, dp, dp, i, i, i, i]
    lib.explicit_qr_s.argtypes = [sp, sp, sp, sp, i, i, i, i]
    lib.qr_check_d.argtypes = [dp, dp, dp, i, i, dp, dp]
    lib.qr_check_s.argtypes = [sp, sp, sp, i, i, dp, dp]
    lib.panel_dims.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    return lib


def _as_fortran(A: np.ndarray, dtype) -> np.ndarray:
    return np.asfortranarray(np.asarray(A, dtype=dtype))


def _ptr(dtype):
    return ctypes.POINTER(ctypes.c_double if dtype == np.float64 else ctypes.c_float)


def panel_dims(m: int, n: int, pr: int, pc: int) -> tuple[int, int]:
    """(row panels, column panels) of the sliding-panel grid (qr.cu:49-55)."""
    rp, cp = ctypes.c_int(), ctypes.c_int()
    _lib().panel_dims(m, n, pr, pc, ctypes.byref(rp), ctypes.byref(cp))
    return rp.value, cp.value


def mmqr(A: np.ndarray, pr: int, pc: int):
    """Sliding-panel QR by the C oracle: (packed, tau).  float32 input runs
    the float instantiation, anything else the double one."""
    lib = _lib()
    dtype = np.float32 if np.asarray(A).dtype == np.float32 else np.float64
    m, n = A.shape
    rp, cp = panel_dims(m, n, pr, pc)
    packed = _as_fortran(A, dtype)
    tau = np.zeros(rp * cp * pc, dtype=dtype)
    fn = lib.mmqr_d if dtype == np.float64 else lib.mmqr_s
    ptr = _ptr(dtype)
    rc = fn(packed.ctypes.data_as(ptr), tau.ctypes.data_as(ptr), m, n, pr, pc)
    if rc:
        raise ValueError(
            f"oracle mmqr rejected m={m} n={n} pr={pr} pc={pc} (rc={rc}): "
            "misaligned sizes (the oracle enforces the reference's "
            "alignment precondition instead of corrupting, SURVEY.md S4)")
    return packed, tau


def explicit_qr(packed: np.ndarray, tau: np.ndarray, pr: int, pc: int):
    """Dense Q (m x m) and R (m x n) from the oracle's packed factors."""
    lib = _lib()
    dtype = packed.dtype.type
    m, n = packed.shape
    Q = np.zeros((m, m), dtype=dtype, order="F")
    R = np.zeros((m, n), dtype=dtype, order="F")
    packed = _as_fortran(packed, dtype)
    tau = np.ascontiguousarray(tau, dtype=dtype)
    fn = lib.explicit_qr_d if dtype == np.float64 else lib.explicit_qr_s
    ptr = _ptr(dtype)
    fn(packed.ctypes.data_as(ptr), tau.ctypes.data_as(ptr),
       Q.ctypes.data_as(ptr), R.ctypes.data_as(ptr), m, n, pr, pc)
    return Q, R


def qr_check(A: np.ndarray, Q: np.ndarray, R: np.ndarray):
    """(residual, orthogonality), computed natively."""
    lib = _lib()
    dtype = Q.dtype.type
    m, n = A.shape
    resid, orth = ctypes.c_double(), ctypes.c_double()
    A, Q, R = (_as_fortran(x, dtype) for x in (A, Q, R))
    fn = lib.qr_check_d if dtype == np.float64 else lib.qr_check_s
    ptr = _ptr(dtype)
    fn(A.ctypes.data_as(ptr), Q.ctypes.data_as(ptr), R.ctypes.data_as(ptr),
       m, n, ctypes.byref(resid), ctypes.byref(orth))
    return resid.value, orth.value


def factor_and_check(A: np.ndarray, pr: int, pc: int):
    """(residual, orthogonality) of the oracle's factorization of A."""
    packed, tau = mmqr(A, pr, pc)
    Q, R = explicit_qr(packed, tau, pr, pc)
    return qr_check(np.asarray(A, dtype=packed.dtype.type), Q, R)
