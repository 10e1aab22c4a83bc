"""One intra-op thread for the port's CPU test modules.

A module takes it with ``from torch_threads import one_thread  # noqa: F401``:
the fixture is autouse and module-scoped, so importing it applies it to the
module's tests and fixtures, and the caller's thread count comes back after.

Why: the suite runs on several pytest-xdist workers that share the host's
cores, and torch's default pool holds one thread per core in every worker.
Its OpenMP barriers then wait on threads that the other workers have
descheduled: in the whole suite on 6 workers of an 8-core host,
``tests/test_torch_precision.py`` took 517.5 s with the default pool and
55.4 s with one thread.

The thread count sets the summation order of the CPU BLAS (MKL splits some
products across threads), so a module whose bounds are ratios to the
reference's rounding keeps the default pool: ``test_torch_accuracy.py``,
whose ``tsqr-cholqr2`` and ``qr-mixed-k4`` cases read 1.113x and 1.104x the
reference's orthogonality with one thread (bound 1.1x).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
