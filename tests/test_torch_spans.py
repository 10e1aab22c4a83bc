"""The port's program spans (``utils/profiling.span``): off and free without
a profiler, and under one, nested by layer (entry > driver > panel, the
host syncs innermost) with totals that add up: one ``driver.host_sync`` per
counted host sync, one ``panel.factor`` per panel, self time between 0 and
the total, a TSQR tree's leaves and levels, and the direct CholeskyQR2
attempt of ``tsqr`` and ``tsqr_r`` with its two syncs inside it."""

import math
import sys
import threading

import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.utils import profiling

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

CPU = [torch.profiler.ProfilerActivity.CPU]
CFG = ct.QRConfig(device="cpu", panel_width=64)
LAYERS = ("entry.", "driver.", "panel.")


def _matrix(m, n, seed=0, dtype=torch.float32):
    return torch.randn(m, n, generator=torch.Generator().manual_seed(seed), dtype=dtype)


def _snapshot():
    return {k: (t.count, t.total_s, t.child_s) for k, t in profiling.span_totals.items()}


def _change(before):
    """{name: (count, total_s, child_s)} added since ``before``."""
    out = {}
    for k, t in profiling.span_totals.items():
        c0, t0, ch0 = before.get(k, (0, 0.0, 0.0))
        if t.count > c0:
            out[k] = (t.count - c0, t.total_s - t0, t.child_s - ch0)
    return out


def _program_events(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name]


def test_off_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    A = _matrix(256, 128)
    before = _snapshot()
    ct.qr(A, CFG)
    ct.tsqr(_matrix(2048, 16), CFG.replace(block_rows=256))
    assert entered == []
    assert _snapshot() == before
    assert profiling.span("entry.qr") is profiling.span("panel.factor")


def test_qr_spans_nest_by_layer():
    A = _matrix(512, 256)
    ct.qr(A, CFG)                                   # the same path once, unrecorded
    before, syncs = _snapshot(), smalllinalg.host_syncs
    with torch.profiler.profile(activities=CPU) as prof:
        ct.qr(A, CFG)
    change = _change(before)
    assert change["entry.qr"][0] == 1 and change["driver.factor"][0] == 1
    assert change["driver.group"][0] == 4 and change["panel.factor"][0] == 4
    assert change["driver.orgqr"][0] == 1 and change["driver.orgqr_group"][0] == 4
    assert change["driver.host_sync"][0] == smalllinalg.host_syncs - syncs > 0
    for name, (count, total, child) in change.items():
        assert name.startswith(LAYERS)
        assert 0.0 <= total - child <= total, name
    # Each child lies inside its parent on the profiler's clock.
    (entry,) = _program_events(prof, "entry.qr")
    (factor,) = _program_events(prof, "driver.factor")
    groups = _program_events(prof, "driver.group")
    panels = _program_events(prof, "panel.factor")
    assert entry[0] <= factor[0] and factor[1] <= entry[1]
    assert all(factor[0] <= g[0] and g[1] <= factor[1] for g in groups)
    assert all(any(g[0] <= p[0] and p[1] <= g[1] for g in groups) for p in panels)
    assert len(panels) == 4
    # The factor's and the panels' children are accounted to them.
    assert change["entry.qr"][2] == pytest.approx(
        change["driver.factor"][1] + change["driver.orgqr"][1], rel=1e-9)
    assert change["driver.factor"][2] == pytest.approx(change["driver.group"][1], rel=1e-9)


def test_retry_spans_nest_in_their_panel():
    A = _matrix(256, 128, seed=1, dtype=torch.float64)
    A[:, 40] = 0.0                                  # a Cholesky breakdown in panel 2
    before = _snapshot()
    with torch.profiler.profile(activities=CPU) as prof:
        ct.qr(A, CFG.replace(panel_width=32, dtype=torch.float64))
    change = _change(before)
    assert change["panel.retry_hr"][0] == 1 and change["panel.retry_geqr2"][0] == 1
    panels = _program_events(prof, "panel.factor")
    for name in ("panel.retry_hr", "panel.retry_geqr2"):
        (r,) = _program_events(prof, name)
        assert any(p[0] <= r[0] and r[1] <= p[1] for p in panels)


@pytest.mark.parametrize("m", [4096, 5000])
def test_tsqr_spans_count_the_tree(m):
    config = CFG.replace(block_rows=256)
    leaves = math.ceil(m / 256)
    before = _snapshot()
    with torch.profiler.profile(activities=CPU):
        ct.tsqr(_matrix(m, 16), config)
    change = _change(before)
    assert change["entry.tsqr"][0] == 1 and change["driver.tsqr_leaves"][0] == 1
    assert change["driver.tsqr_level"][0] == math.ceil(math.log2(leaves))
    assert change["driver.tsqr_q"][0] == 1
    assert change["entry.tsqr"][2] <= change["entry.tsqr"][1]


DIRECT = CFG.replace(block_rows=256, tsqr_leaf="cholqr2")


def _ill_conditioned():
    """cond(A) ~ 3e7 in float32: the direct path's certificate fails."""
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((2048, 16)))
    return torch.from_numpy((U * np.logspace(0, -7.5, 16)).astype(np.float32))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("entry", ["tsqr", "tsqr_r"])
def test_direct_attempt_is_one_span_around_its_two_syncs(entry):
    A = _matrix(4096, 16)
    before, syncs = _snapshot(), smalllinalg.host_syncs
    with torch.profiler.profile(activities=CPU) as prof:
        getattr(ct, entry)(A, DIRECT)
    change = _change(before)
    assert change["driver.tsqr_direct"][0] == 1
    assert change["driver.host_sync"][0] == smalllinalg.host_syncs - syncs == 2
    assert "driver.tsqr_leaves" not in change and "driver.tsqr_level" not in change
    (direct,) = _program_events(prof, "driver.tsqr_direct")
    assert all(_inside(s, direct) for s in _program_events(prof, "driver.host_sync"))
    if entry == "tsqr":
        (call,) = _program_events(prof, "entry.tsqr")
        assert _inside(direct, call)
        assert change["entry.tsqr"][2] == pytest.approx(change["driver.tsqr_direct"][1],
                                                        rel=1e-9)
    assert change["driver.tsqr_direct"][2] == pytest.approx(change["driver.host_sync"][1],
                                                            rel=1e-9)


def test_a_fallback_records_the_direct_attempt_then_the_tree():
    before = _snapshot()
    with torch.profiler.profile(activities=CPU) as prof:
        ct.tsqr(_ill_conditioned(), DIRECT)
    change = _change(before)
    assert change["driver.tsqr_direct"][0] == 1 and change["driver.tsqr_leaves"][0] == 1
    assert change["driver.tsqr_level"][0] == math.ceil(math.log2(2048 / 256))
    (call,) = _program_events(prof, "entry.tsqr")
    (direct,) = _program_events(prof, "driver.tsqr_direct")
    (leaves,) = _program_events(prof, "driver.tsqr_leaves")
    levels = _program_events(prof, "driver.tsqr_level")
    assert all(_inside(s, call) for s in [direct, leaves] + levels)
    assert direct[1] <= leaves[0] and all(leaves[1] <= lv[0] for lv in levels)
    assert not any(_inside(lv, direct) for lv in levels)


def test_direct_spans_off_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = _snapshot()
    ct.tsqr(_matrix(4096, 16), DIRECT)
    ct.tsqr_r(_matrix(4096, 16), DIRECT)
    ct.tsqr(_ill_conditioned(), DIRECT)
    assert entered == [] and _snapshot() == before


def test_totals_keep_every_thread_span():
    """Threads share the totals: none of a shortened switch interval's
    interleavings loses a count or puts a thread's child in another's
    parent."""
    threads, per_thread = 12, 300
    before = _snapshot()
    old = sys.getswitchinterval()

    def body():
        for _ in range(per_thread):
            with profiling.span("test.outer"):
                with profiling.span("test.inner"):
                    pass
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            workers = [threading.Thread(target=body) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    change = _change(before)
    assert change["test.outer"][0] == change["test.inner"][0] == threads * per_thread
    assert change["test.outer"][2] == pytest.approx(change["test.inner"][1], rel=1e-9)


def test_profile_script_reads_the_same_totals():
    from cuda_qr_tpu_torch.utils.profile import _span_seconds
    A = _matrix(256, 128, seed=2)
    before, totals = _span_seconds(), _snapshot()
    with torch.profiler.profile(activities=CPU):
        ct.qr(A, CFG)
    after, change = _span_seconds(), _change(totals)
    assert after["sync_wait"] - before["sync_wait"] == pytest.approx(
        change["driver.host_sync"][1], rel=1e-9)
    assert after["panel_self"] - before["panel_self"] == pytest.approx(
        sum(t - c for k, (_, t, c) in change.items() if k.startswith("panel.")), rel=1e-9)
    assert after["driver_self"] > before["driver_self"]


def test_profile_script_counts_no_span_range_as_device_work():
    from types import SimpleNamespace

    from cuda_qr_tpu_torch.utils.profile import device_work
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(name="panel.factor", device_type=cuda, is_user_annotation=True),
              SimpleNamespace(name="panel.factor", device_type=cpu, is_user_annotation=True),
              SimpleNamespace(name="chol_inv_kernel", device_type=cuda, is_user_annotation=False),
              SimpleNamespace(name="aten::mm", device_type=cpu, is_user_annotation=False)]
    assert [e.name for e in device_work(events)] == ["chol_inv_kernel"]
