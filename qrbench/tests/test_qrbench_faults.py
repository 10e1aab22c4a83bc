"""A run whose timed path is broken underneath reads ``correct`` false.

The harness's look for a card is skipped (``run_cell`` on the CPU at tiny
sizes); the program's entry points are replaced by broken versions of
themselves, one fault at a time, for each fault a cell can have: a call
that returns its input unchanged, half of the work left out, and one
entry of an answer altered where it is produced.  One card per cell:
there is no exchange between chips to leave out.
"""

import json

import pytest
import torch

import cuda_qr_tpu_torch as ct
from qrbench import run, spec
from qrbench.tests.tiny_root import REPO, cells, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


def _altered(X):
    X = X.clone()
    X[0, 0] += 1e-2 * X.abs().max()
    return X


def _thin_faults(orig):
    def unchanged(A, config, **kw):
        return A.clone(), torch.eye(A.shape[1], dtype=A.dtype)

    def half(A, config, **kw):
        Q, R = orig(A, config, **kw)
        Q = Q.clone()
        Q[:, Q.shape[1] // 2:] = 0        # half of the columns never computed
        return Q, R

    def half_rows(A, config, **kw):
        Q, R = orig(A, config, **kw)
        Q = Q.clone()
        Q[Q.shape[0] // 2:] = 0           # half of the leaves left out
        return Q, R

    def altered(A, config, **kw):
        Q, R = orig(A, config, **kw)
        return Q, _altered(R)
    return {"unchanged": unchanged, "half": half, "half_rows": half_rows, "altered": altered}


def _apply_faults(orig):
    def unchanged(self, B):
        return B.clone()

    def half(self, B):
        X = B.clone()
        k = B.shape[1] // 2
        X[:, :k] = orig(self, B[:, :k])   # the other half of the batch left as it came
        return X

    def altered(self, B):
        return _altered(orig(self, B))
    return {"unchanged": unchanged, "half": half, "altered": altered}


# The faults a thin entry point can have: half of qr's columns (its panels),
# half of tsqr's rows (its leaves); both for an entry not named here.
FAULTS = {"qr": ("unchanged", "half", "altered"), "tsqr": ("unchanged", "half_rows", "altered")}


def _thin_cells() -> list:
    """(workload, entry) of BENCHMARK.json's cells whose traffic calls a thin
    QR entry point directly (no set-up)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    traffic = {w["name"]: spec.load(w["name"]).traffic for w in bench["workloads"]}
    return [(w, t["entry"]) for w, t in traffic.items()
            if t["check"] == "thin_qr" and not t.get("setup")]


THIN = [(w, entry, f) for w, entry in _thin_cells()
        for f in FAULTS.get(entry, ("unchanged", "half", "half_rows", "altered"))]


@pytest.mark.parametrize("workload,entry,fault", THIN)
def test_broken_thin_qr_reads_incorrect(root, monkeypatch, workload, entry, fault):
    monkeypatch.setattr(ct, entry, _thin_faults(getattr(ct, entry))[fault])
    result = run.run_cell(workload, 2**31 + 5, 0.1, False, root=root, device="cpu")
    assert result["correct"] is False
    assert any(not run.passes(c) for c in result["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_apply_qt_reads_incorrect(root, monkeypatch, fault):
    monkeypatch.setattr(ct.QRResult, "apply_qt", _apply_faults(ct.QRResult.apply_qt)[fault])
    result = run.run_cell("qr8192.apply_qt", 2**31 + 5, 0.1, False, root=root, device="cpu")
    assert result["correct"] is False


def test_a_call_that_raises_in_the_window_reads_incorrect(root, monkeypatch):
    orig, calls = ct.tsqr, []

    def flaky(A, config, **kw):          # the warm-up's two calls pass
        calls.append(1)
        if len(calls) > 2 and len(calls) % 2:
            raise RuntimeError("planted")
        return orig(A, config, **kw)
    monkeypatch.setattr(ct, "tsqr", flaky)
    result = run.run_cell("tsqr1M.qr", 1, 0.2, False, root=root, device="cpu",
                          log=lambda s: None)
    assert result["correct"] is False and 0 < result["failed"] < result["attempted"]


def test_a_call_that_raises_in_warm_up_ends_the_run(root, monkeypatch):
    def boom(A, config, **kw):
        raise RuntimeError("planted")
    monkeypatch.setattr(ct, "tsqr", boom)
    with pytest.raises(RuntimeError, match="planted"):
        run.run_cell("tsqr1M.qr", 1, 0.1, False, root=root, device="cpu")


@pytest.mark.parametrize("workload", cells())
def test_unbroken_reads_correct(root, workload):
    assert run.run_cell(workload, 2**31 + 5, 0.1, False, root=root, device="cpu")["correct"]
