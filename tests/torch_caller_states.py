"""The five ways a caller can leave PyTorch's float32 GEMM mode set.

The port sets cuBLAS's float32 mode around each of its own products
(``cuda_qr_tpu_torch/ops/gemm.py``, ``_product``) through
``torch.backends.cuda.matmul.fp32_precision`` only.  Its entry points must
work, and leave both ``fp32_precision`` attributes as they found them,
whichever of these states the caller set before the call:

  untouched              nothing set (a fresh process);
  allow_tf32             the legacy flag, ``torch.backends.cuda.matmul.allow_tf32 = True``;
  matmul_precision_high  ``torch.set_float32_matmul_precision("high")``;
  matmul_fp32_precision  ``torch.backends.cuda.matmul.fp32_precision = "tf32"``;
  fp32_precision         ``torch.backends.fp32_precision = "tf32"``.

Since PyTorch 2.9 the last two make PyTorch refuse to read the legacy flag,
so code that reads it raises in them.  ``caller_state(name)`` sets one
state for a block and puts the process back as a fresh one reads after.
"""

import contextlib

import torch


def _legacy():
    torch.backends.cuda.matmul.allow_tf32 = True


def _matmul_new():
    torch.backends.cuda.matmul.fp32_precision = "tf32"


def _global_new():
    torch.backends.fp32_precision = "tf32"


CALLER_STATES = {
    "untouched": lambda: None,
    "allow_tf32": _legacy,
    "matmul_precision_high": lambda: torch.set_float32_matmul_precision("high"),
    "matmul_fp32_precision": _matmul_new,
    "fp32_precision": _global_new,
}


def fp32_reads():
    """(torch.backends.cuda.matmul.fp32_precision, torch.backends.fp32_precision)."""
    return torch.backends.cuda.matmul.fp32_precision, torch.backends.fp32_precision


def _reset():
    """Every setting the states touch back to a fresh process's reads."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.fp32_precision = "none"
    torch.backends.cuda.matmul.fp32_precision = "none"
    torch.backends.mkldnn.matmul.fp32_precision = "none"


@contextlib.contextmanager
def caller_state(name: str):
    _reset()
    CALLER_STATES[name]()
    try:
        yield
    finally:
        _reset()
