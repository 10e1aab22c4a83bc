"""The panel-grouping knobs that decide the factor's groups: ``stage_schedule``
(panels per stage of the factor) and the reference's ``driver="unrolled"``
(``factor_lookahead=1`` here), against the reference on the same input.

Tolerances are ``test_torch_blocked.py``'s: Q, R, packed factors, taus and
Ts agree to 1e-10 (x max|A| for R and the packed factors) in float64 and
1e-4 in float32.  Accuracy: the port's orthogonality ||Q^T Q - I||_F and
residual ||A - QR||_F / ||A||_F at most 1.1x the reference's, as a
geometric mean over seeds 0-3 (``test_torch_accuracy.py``'s bound).  A
schedule the factor cannot take raises the reference's ValueError; ``eigh``
drops a schedule, as the reference's does; the command line takes
``--stages`` and ``--stage-schedule`` before the command, as the
reference's does.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
from cuda_qr_tpu import cli as ref_cli
from cuda_qr_tpu_torch import cli, eigh, extract_r, lstsq, orgqr, qr_blocked
from cuda_qr_tpu_torch.ops import blocked
from cuda_qr_tpu_torch.ops.blocked import _groups
from cuda_qr_tpu_torch.utils.config import QRConfig
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from test_torch_blocked import reference_groups
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NB = 32
DTYPES = {"f64": (np.float64, jnp.float64, 1e-10), "f32": (np.float32, jnp.float32, 1e-4)}
# (schedule, factor_lookahead): a tail of a deep group after shallow ones,
# an uneven start, and the shape of the reference's tuned tail schedules
# ((2,)*24 + (8,)*2 at lookahead 8).
SCHEDULES = {"2-2-4": ((2, 2, 4), 4), "1-1-2-4": ((1, 1, 2, 4), 4),
             "tail8": ((2,) * 4 + (8,), 8)}
SEEDS = range(4)


def ref_config(jdt, method="geqr2", **kw):
    return ref.QRConfig(dtype=jdt, panel_width=NB, panel_method=method,
                        use_pallas=method != "geqr2", **kw)


def square(seed, k, ndt, rows=None):
    """A Gaussian (rows or k panels) x k panels."""
    shape = ((rows or k) * NB, k * NB)
    return np.random.default_rng(seed).standard_normal(shape).astype(ndt)


def factor_both(A, rcfg):
    """(reference packed factors, Q, R), (the port's) under one reference config."""
    m, n = A.shape
    rfac = ref.qr_blocked(jnp.asarray(A), rcfg)
    rQ, rR = ref.orgqr(rfac, m, n, rcfg), ref.extract_r(rfac, n)
    cfg = config_from_reference(rcfg, device="cpu")
    fac = qr_blocked(A, cfg)
    return ((rfac, np.asarray(rQ), np.asarray(rR)),
            (fac, orgqr(fac, m, n, cfg).numpy(), extract_r(fac, n).numpy()))


def assert_factors_agree(A, both, tol):
    (rfac, rQ, rR), (fac, Q, R) = both
    scale = np.abs(A).max()
    assert np.abs(fac.packed.numpy() - np.asarray(rfac.packed)).max() <= tol * scale
    assert np.abs(fac.taus.numpy() - np.asarray(rfac.taus)).max() <= tol
    assert np.abs(fac.Ts.numpy() - np.asarray(rfac.Ts)).max() <= tol
    assert np.abs(Q - rQ).max() <= tol
    assert np.abs(R - rR).max() <= tol * scale


def accuracy(A, Q, R):
    A64, Q64, R64 = (np.asarray(x, np.float64) for x in (A, Q, R))
    orth = np.linalg.norm(Q64.T @ Q64 - np.eye(Q64.shape[1]))
    return orth, np.linalg.norm(A64 - Q64 @ R64) / np.linalg.norm(A64)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_factor_matches_reference(case, dt):
    schedule, lookahead = SCHEDULES[case]
    ndt, jdt, tol = DTYPES[dt]
    A = square(0, sum(schedule), ndt)
    rcfg = ref_config(jdt, stage_schedule=schedule, factor_lookahead=lookahead)
    assert config_from_reference(rcfg).stage_schedule == schedule
    assert_factors_agree(A, factor_both(A, rcfg), tol)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_as_accurate_as_reference(case):
    """float32, seeds 0-3: orthogonality and residual <= 1.1x the
    reference's as a geometric mean."""
    schedule, lookahead = SCHEDULES[case]
    rcfg = ref_config(jnp.float32, stage_schedule=schedule, factor_lookahead=lookahead)
    ratios = []
    for seed in SEEDS:
        A = square(seed, sum(schedule), np.float32)
        (_, rQ, rR), (_, Q, R) = factor_both(A, rcfg)
        ratios.append(np.array(accuracy(A, Q, R)) / np.array(accuracy(A, rQ, rR)))
    orth, resid = np.exp(np.log(ratios).mean(axis=0))
    assert orth <= 1.1 and resid <= 1.1, (orth, resid)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_groups_follow_the_schedule(width):
    """The factor's groups under a schedule are the ones the reference's
    ``_qr_blocked_scan`` forms, for 200 random schedules of up to 40
    panels, and SCHEDULES."""
    rng = np.random.default_rng(width)
    schedules = [s for s, _ in SCHEDULES.values()] + [
        tuple(int(c) for c in rng.integers(1, 9, size=rng.integers(1, 6))) for _ in range(200)]
    for schedule in schedules:
        k = sum(schedule)
        assert _groups(k, width, 4, schedule) == reference_groups(k, width, schedule=schedule)
    assert _groups(16, 8, 4, (2,) * 4 + (8,)) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 16)]


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_is_not_dropped(case):
    """A reference config with a schedule gives the port another factor than
    the same config without one, wherever the groups differ; a schedule
    that forms the default stages gives the same bits."""
    schedule, lookahead = SCHEDULES[case]
    k = sum(schedule)
    A = square(0, k, np.float32)
    rcfg = ref_config(jnp.float32, factor_lookahead=lookahead)
    plain = qr_blocked(A, config_from_reference(rcfg, device="cpu")).packed
    staged = qr_blocked(A, config_from_reference(
        rcfg.replace(stage_schedule=schedule), device="cpu")).packed
    assert _groups(k, lookahead, 4, schedule) != _groups(k, lookahead, 4)
    assert not torch.equal(staged, plain)
    even = (k // 4,) * 4   # the default scan_stages=4 bounds
    assert _groups(k, lookahead, 4, even) == _groups(k, lookahead, 4)
    assert torch.equal(qr_blocked(A, config_from_reference(
        rcfg.replace(stage_schedule=even), device="cpu")).packed, plain)


@pytest.mark.parametrize("method", ["geqr2", "cholqr2_bk"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_unrolled_driver_is_lookahead_one(method, dt):
    """The reference's unrolled driver (one panel, then a K = nb larfb of
    the exact trailing block) is the port's factor_lookahead=1, on a
    256 x 128 input (4 panels: the unrolled graph's compile grows with
    each)."""
    ndt, jdt, tol = DTYPES[dt]
    A = square(1, 4, ndt, rows=8)
    # The reference's plain Gram Cholesky: its Pallas kernel, interpreted on
    # the CPU, adds compile time to every unrolled panel, for the same function.
    rcfg = ref_config(jdt, method, driver="unrolled", use_chol_kernel=False)
    assert config_from_reference(rcfg).factor_lookahead == 1
    assert config_from_reference(rcfg).scan_stages == rcfg.scan_stages  # orgqr's groups
    assert_factors_agree(A, factor_both(A, rcfg), tol)


@pytest.mark.parametrize("schedule", [(2, 2, 2), (2, 2, 4, 1), (0, 4, 4), (-1, 5, 4)])
def test_bad_schedule_raises_before_any_work(monkeypatch, schedule):
    """A schedule that does not sum to k = 8 or has an entry <= 0 raises the
    reference's ValueError, before any panel is factored."""
    A = square(0, 8, np.float64)
    message = "must be positive and sum to the panel count k=8"
    with pytest.raises(ValueError, match=message):
        ref.qr_blocked(jnp.asarray(A), ref_config(jnp.float64, stage_schedule=schedule))

    def no_panel(*args):
        raise AssertionError("a panel was factored")
    monkeypatch.setattr(blocked, "_panel_factor", no_panel)
    cfg = QRConfig(dtype=torch.float64, panel_width=NB, stage_schedule=schedule, device="cpu")
    with pytest.raises(ValueError, match=message):
        qr_blocked(A, cfg)


def test_unrolled_with_schedule_raises():
    rcfg = ref_config(jnp.float64, driver="unrolled", stage_schedule=(4, 4))
    message = "stage_schedule is a scan-driver knob"
    with pytest.raises(ValueError, match=message):
        ref.qr_blocked(jnp.asarray(square(0, 8, np.float64)), rcfg)
    with pytest.raises(ValueError, match=message):
        config_from_reference(rcfg)


def test_composite_solver_raises_on_a_schedule_it_cannot_take():
    """lstsq factors A (k = 8 panels) with the caller's config: a schedule
    of another sum raises the reference's ValueError in both packages."""
    A = square(0, 8, np.float64)
    b = np.random.default_rng(1).standard_normal((A.shape[0], 2))
    rcfg = ref_config(jnp.float64, stage_schedule=(4, 2))
    message = "must be positive and sum to the panel count k=8"
    with pytest.raises(ValueError, match=message):
        ref.lstsq(jnp.asarray(A), jnp.asarray(b), rcfg)
    with pytest.raises(ValueError, match=message):
        lstsq(A, b, config_from_reference(rcfg, device="cpu"))


def test_eigh_drops_the_schedule():
    """eigh's divide and conquer runs QRs of many panel counts: a caller's
    schedule is dropped (the reference's ``_route_large_n``), so the result
    is the one without it, bit for bit."""
    n = 160
    B = np.random.default_rng(3).standard_normal((n, n))
    A = torch.from_numpy(B + B.T)
    cfg = QRConfig(dtype=torch.float64, panel_width=NB, device="cpu")
    w0, V0 = eigh(A, cfg, base_n=64)
    w1, V1 = eigh(A, cfg.replace(stage_schedule=(1, 2)), base_n=64)
    assert torch.equal(w0, w1) and torch.equal(V0, V1)


CPU = ["--platform", "cpu", "--no-pallas", "--trials", "1"]


def run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [["--stages", "2"], ["--stage-schedule", "1,1"]])
def test_cli_takes_the_stage_flags(capsys, flags):
    """``factor 256 256`` (k = 2 at the default panel width 128) with either
    flag before the command: ok and the reference's keys, in both CLIs."""
    argv = CPU + flags + ["factor", "256", "256"]
    rc, rec = run(cli.main, argv, capsys)
    ref_rc, ref_rec = run(ref_cli.main, argv, capsys)
    assert rc == ref_rc == 0 and rec["ok"] is True and ref_rec["ok"] is True
    assert set(rec) == set(ref_rec), set(rec) ^ set(ref_rec)


def test_cli_schedule_sets_the_factor(capsys, monkeypatch):
    """``--stage-schedule 2,2,4 factor 1024 1024`` (k = 8) reaches
    qr_blocked as the config's schedule and passes the gates."""
    seen = []
    real = blocked.qr_blocked

    def spy(A, config):
        seen.append(config.stage_schedule)
        return real(A, config)
    monkeypatch.setattr(blocked, "qr_blocked", spy)
    rc, rec = run(cli.main, CPU + ["--stage-schedule", "2,2,4", "factor", "1024", "1024"],
                  capsys)
    assert rc == 0 and rec["ok"] is True
    assert seen and set(seen) == {(2, 2, 4)}


def test_cli_schedule_that_does_not_sum_raises(capsys):
    """``--stage-schedule 2,2,4 factor 256 256``: k = 2, so both CLIs raise
    the factor's ValueError."""
    argv = CPU + ["--stage-schedule", "2,2,4", "factor", "256", "256"]
    for main in (cli.main, ref_cli.main):
        with pytest.raises(ValueError, match="sum to the panel count k=2"):
            main(argv)


@pytest.mark.parametrize("main", [cli.main, ref_cli.main], ids=["port", "reference"])
def test_cli_refuses_a_schedule_outside_the_factorizations(capsys, main):
    with pytest.raises(SystemExit) as exc:
        main(["--platform", "cpu", "--stage-schedule", "2", "eigh", "64"])
    assert exc.value.code == 2
    assert "--stage-schedule only applies" in capsys.readouterr().err
