"""The port's command line (``python -m cuda_qr_tpu_torch``, ``cli.py``)
against the reference's (``python -m cuda_qr_tpu``).

factor, tsqr, lstsq, pivoted and decomp run through both CLIs in process on
the same seed, at the sizes of the reference's own CLI tests, with
``--no-pallas``: the records must have the same keys, the same ``ok``, and
every accuracy field must sit under the gate that command applies
(residual < n eps and orthogonality < 4 n eps for the factorizations; the
pivoted factor's max |Q^T Q - I| < 1e-4; decomp's residual < max(m, n) x
1.2e-7 with orthogonality < 1e-4; lstsq's error against LAPACK < 1e-4 in
float32).  The oracle's records must be identical.  The other commands:
their record keys (the reference's; ``compare``'s ``xla_*`` keys become
``torch_*``), ``ok`` and exit code; ``caqr``/``dist`` at ``--devices 4``,
one gloo spawn each.  Then the error exits, ``--help``, the card by
default, and one ``python -m`` subprocess.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_qr_tpu import cli as ref_cli
from cuda_qr_tpu_torch import cli

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--platform", "cpu"]
EPS = {"f32": float(np.finfo(np.float32).eps), "f64": float(np.finfo(np.float64).eps)}


def run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _factor_gates(rec, dtype):
    n, eps = rec["n"], EPS[dtype]
    return {"residual": n * eps, "orthogonality": 4 * n * eps}


SAME_SEED = {
    "factor-f64": ["--no-pallas", "--dtype", "f64", "--trials", "1", "factor", "64", "32"],
    "factor-f32": ["--no-pallas", "--trials", "1", "factor", "96", "48"],
    "factor-mixed": ["--no-pallas", "--trials", "1", "--mixed", "factor", "96", "48"],
    "tsqr": ["--no-pallas", "--trials", "1", "tsqr", "2048", "32"],
    "tsqr-cholqr2": ["--no-pallas", "--trials", "1", "--tsqr-leaf", "cholqr2", "tsqr", "2048",
                     "32"],
    "lstsq": ["--no-pallas", "--trials", "1", "lstsq", "200", "48", "2"],
    "pivoted": ["--no-pallas", "--trials", "1", "pivoted", "128", "64", "--decay", "0.9"],
    "pivoted-rank": ["--no-pallas", "--trials", "1", "pivoted", "128", "64", "--rank", "16",
                     "--decay", "0.5"],
    "decomp-lq": ["--no-pallas", "--trials", "1", "decomp", "lq", "48", "80"],
    "decomp-rq": ["--no-pallas", "--trials", "1", "decomp", "rq", "80", "48"],
    "decomp-ql": ["--no-pallas", "--trials", "1", "decomp", "ql", "80", "48"],
}


def gates_of(case, rec):
    dtype = rec.get("dtype", "f32")
    if case.startswith(("factor", "tsqr")):
        return _factor_gates(rec, dtype)
    if case == "lstsq":
        return {"rel_err_vs_lapack": 1e-4}
    if case.startswith("pivoted"):     # truncated at a rank: the residual is the tail's
        gates = {"orthogonality": 1e-4}
        return gates if rec["rank"] is not None else gates | {"residual": rec["n"] * EPS[dtype]}
    return {"residual": max(rec["m"], rec["n"]) * 1.2e-7, "orthogonality": 1e-4}


@pytest.mark.parametrize("case", list(SAME_SEED))
def test_cli_agrees_with_reference(capsys, case):
    argv = CPU + SAME_SEED[case]
    rc, rec = run(cli.main, argv, capsys)
    ref_rc, ref = run(ref_cli.main, argv, capsys)
    assert rc == ref_rc == 0
    assert set(rec) == set(ref), set(rec) ^ set(ref)
    assert rec.get("ok") == ref.get("ok")
    for field, gate in gates_of(case, ref).items():
        assert rec[field] < gate and ref[field] < gate, (field, rec[field], ref[field], gate)
    for key in ("cmd", "m", "n", "dtype", "leaf", "kind", "rank", "decay", "k"):
        assert rec.get(key) == ref.get(key), key


@pytest.mark.parametrize("argv", [["oracle", "64", "32", "16", "8"],
                                  ["oracle", "96", "32", "32", "16"],
                                  ["--seed", "3", "oracle", "244", "64", "64", "4"]])
def test_cli_oracle_record_identical(capsys, argv):
    rc, rec = run(cli.main, CPU + argv, capsys)
    ref_rc, ref = run(ref_cli.main, argv, capsys)
    assert rc == ref_rc == 0 and rec == ref


OTHER = {
    "compare": (["compare", "96", "48"],
                {"cmd", "m", "n", "dtype", "ours_factor_ms", "ours_factor_gflops",
                 "ours_q_plus_r_ms", "torch_q_plus_r_ms", "q_plus_r_speedup_vs_torch"}),
    "batched": (["batched", "4", "48", "16"],
                {"cmd", "b", "m", "n", "dtype", "steady_ms", "compile_s", "gflops", "residual",
                 "orthogonality", "ok"}),
    "update": (["update", "64", "24"],
               {"cmd", "m", "n", "dtype", "update_ms", "refactor_ms", "compile_s", "residual",
                "orthogonality", "ok"}),
    "rsvd": (["rsvd", "128", "64", "--rank", "8", "--decay", "0.7"],
             {"cmd", "m", "n", "rank", "dtype", "steady_ms", "compile_s", "err2", "s_next",
              "ok"}),
    "rsvd-sym": (["rsvd", "96", "96", "--rank", "8", "--decay", "0.7", "--sym"],
                 {"cmd", "m", "rank", "dtype", "steady_ms", "compile_s", "err2", "w_next",
                  "ok"}),
    "polar": (["polar", "128", "32"],
              {"cmd", "m", "n", "cond", "dtype", "steady_ms", "compile_s", "residual",
               "orthogonality", "ok"}),
    "polar-wide": (["polar", "32", "96"],
                   {"cmd", "m", "n", "cond", "dtype", "steady_ms", "compile_s", "residual",
                    "orthogonality", "ok"}),
    "eigh": (["eigh", "64", "--base-n", "32"],
             {"cmd", "n", "dtype", "base_n", "steady_ms", "compile_s", "residual",
              "orthogonality", "eigval_rel_err", "ok"}),
    "svd": (["svd", "128", "64"],
            {"cmd", "m", "n", "cond", "eigh_impl", "dtype", "steady_ms", "compile_s", "residual",
             "orthogonality", "sv_rel_err", "ok"}),
    "no-verify": (["--no-verify", "factor", "64", "32"],
                  {"cmd", "m", "n", "dtype", "steady_ms", "compile_s", "gflops"}),
}


@pytest.mark.parametrize("case", list(OTHER))
def test_cli_other_commands(capsys, case):
    argv, keys = OTHER[case]
    rc, rec = run(cli.main, CPU + ["--trials", "1"] + argv, capsys)
    assert rc == 0 and set(rec) == keys, set(rec) ^ keys
    assert rec.get("ok", True) is True
    if case == "rsvd":
        assert rec["err2"] < 3 * rec["s_next"] + 1e-4
    if case == "rsvd-sym":
        assert rec["cmd"] == "eigh_rand" and rec["err2"] < 3 * rec["w_next"] + 1e-4
    if case == "compare":
        # The ratio of one CPU trial, rounded to 3 places, may read 0.0 under
        # load; the record must hold two times and their ratio.
        ours, lib = rec["ours_q_plus_r_ms"], rec["torch_q_plus_r_ms"]
        assert ours > 0 and lib > 0
        assert rec["q_plus_r_speedup_vs_torch"] == pytest.approx(round(lib / ours, 3), abs=1e-3)


DISTRIBUTED = {
    "caqr": (["caqr", "256", "64", "--devices", "4", "--layout", "cyclic"],
             {"layout", "residual", "orthogonality", "ok"}),
    "tsqr": (["dist", "tsqr", "512", "32", "--devices", "4", "--strategy", "butterfly"],
             {"strategy", "residual", "orthogonality", "ok"}),
    "lstsq": (["dist", "lstsq", "256", "48", "--devices", "4"], {"x_rel_err", "ok"}),
    "polar": (["dist", "polar", "512", "32", "--devices", "4"],
              {"cond", "residual", "orthogonality", "ok"}),
    "svd": (["dist", "svd", "512", "32", "--devices", "4"],
            {"cond", "eigh_impl", "residual", "orthogonality", "sv_rel_err", "ok"}),
    "rsvd": (["dist", "rsvd", "512", "128", "--devices", "4"], {"rank", "err2", "s_next", "ok"}),
    "eigh-rand": (["dist", "eigh-rand", "256", "256", "--devices", "4"],
                  {"rank", "err2", "w_next", "ok"}),
}


@pytest.mark.parametrize("case", list(DISTRIBUTED))
def test_cli_distributed(capsys, case):
    argv, extra = DISTRIBUTED[case]
    rc, rec = run(cli.main, CPU + ["--trials", "1"] + argv, capsys)
    keys = {"cmd", "m", "n", "devices", "dtype", "steady_ms", "compile_s"} | extra
    assert rc == 0 and set(rec) == keys, set(rec) ^ keys
    assert rec["ok"] is True and rec["devices"] == 4
    assert rec["cmd"] == ("caqr" if case == "caqr" else f"{case}_dist")


@pytest.mark.parametrize("argv,message", [(["factor", "0", "0"], "must be >= 1"),
                                          (["factor", "10", "20"], "n <= m"),
                                          (["oracle", "8", "8", "0", "4"], "must be >= 1"),
                                          (["--platform", "tpu", "factor", "8", "4"],
                                           "invalid choice")])
def test_cli_rejects_bad_arguments(capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_cli_dist_rejects_short_shards(capsys):
    assert cli.main(CPU + ["dist", "tsqr", "256", "128", "--devices", "4"]) == 2
    assert "m/devices" in capsys.readouterr().err
    assert cli.main(CPU + ["dist", "lstsq", "250", "16", "--devices", "4"]) == 2
    assert "must divide the mesh" in capsys.readouterr().err


def test_cli_help_lists_every_command(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for name in ("factor", "tsqr", "lstsq", "compare", "caqr", "pivoted", "oracle", "batched",
                 "update", "decomp", "rsvd", "polar", "eigh", "svd", "dist"):
        assert name in out
    assert len(cli.COMMANDS) == 15


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["--trials", "1", "factor", "8", "4"])


def test_python_m_entry_point():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-m", "cuda_qr_tpu_torch", *CPU, "--trials", "1",
                          "factor", "64", "32"], capture_output=True, text=True, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["cmd"] == "factor" and rec["ok"] is True
    code = ("import sys, cuda_qr_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cuda_qr_tpu.'))"
            " or m == 'cuda_qr_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env)
