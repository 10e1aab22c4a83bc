"""The port's utilities against the reference's: debug printing, the
finiteness guard and trace gating, profiling, the panel-grid geometry,
``to_device``/``to_host``, ``bench``, and the public surface.

Outputs that are text or integers must be equal (print_mat character for
character, assert_finite's message, PanelGrid/reflector_extent over a grid
of shapes); round trips must be exact.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import cuda_qr_tpu
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.utils import debug as ref_debug
from cuda_qr_tpu.utils import geometry as ref_geometry
from cuda_qr_tpu_torch.utils import debug, geometry, hostio, profiling
from cuda_qr_tpu_torch.utils.errors import QRNumericalError
from cuda_qr_tpu_torch.utils.timing import BenchResult, bench

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.mark.parametrize("shape,max_dim,name", [((3, 4), 16, "A"), ((20, 20), 4, "B"),
                                                ((5, 30), 8, ""), ((30, 2), 6, "C")])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_print_mat_matches_reference(capsys, rng, shape, max_dim, name, as_tensor):
    A = rng.standard_normal(shape)
    ref_debug.print_mat(A, name=name, max_dim=max_dim)
    want = capsys.readouterr().out
    debug.print_mat(torch.from_numpy(A) if as_tensor else A, name=name, max_dim=max_dim)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("bad", [np.array([1.0, np.nan, 2.0]),
                                 np.array([[0.0, np.inf], [-np.inf, 1.0]])])
def test_assert_finite_matches_reference(rng, bad):
    debug.assert_finite(torch.from_numpy(rng.standard_normal(8)), "ok")
    with pytest.raises(Exception) as ref_err:
        ref_debug.assert_finite(bad, "bad")
    with pytest.raises(QRNumericalError) as err:
        debug.assert_finite(torch.from_numpy(bad), "bad")
    assert str(err.value) == str(ref_err.value)


def test_trace_print_reads_nothing_unless_enabled(monkeypatch, capsys):
    reads = []
    monkeypatch.setattr(hostio, "to_host", lambda x: reads.append(x) or np.asarray(x))
    monkeypatch.setenv("CUDA_QR_TRACE", "0")
    debug.trace_print("norm {} at {}", torch.tensor(2.5), 3)
    assert capsys.readouterr().out == "" and reads == []
    monkeypatch.setenv("CUDA_QR_TRACE", "1")
    assert debug.trace_enabled()
    debug.trace_print("norm {} at {}", torch.tensor(2.5), 3)
    assert capsys.readouterr().out == "norm 2.5 at 3\n" and len(reads) == 1


def test_device_memory_stats_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "tr"
    with profiling.trace(str(logdir)):
        with profiling.span("gemm"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    trace = logdir / "trace.json"
    assert trace.exists() and "gemm" in trace.read_text()


GRID_SHAPES = [(m, n, pr, pc) for m, n, pr, pc in itertools.product(
    (6, 16, 30, 64, 100, 244), (4, 8, 13, 32, 64), (4, 8, 16, 64), (2, 4, 8, 16))
    if pc < pr and n <= m]


def test_panel_grid_matches_reference():
    for m, n, pr, pc in GRID_SHAPES:
        g, r = geometry.PanelGrid(m, n, pr, pc), ref_geometry.PanelGrid(m, n, pr, pc)
        assert (g.col_panels, g.row_panels, g.tau_len, g.aligned(), g.panel_row_starts()) == \
            (r.col_panels, r.row_panels, r.tau_len, r.aligned(), r.panel_row_starts())
        for pc_idx, pr_idx, col in itertools.product(range(g.col_panels), range(g.row_panels),
                                                     range(pc)):
            assert g.tau_index(pc_idx, pr_idx, col) == r.tau_index(pc_idx, pr_idx, col)
    for bad in ((8, 4, 4, 4), (4, 8, 8, 4)):
        with pytest.raises(ValueError):
            geometry.PanelGrid(*bad)


def test_reflector_extent_matches_reference():
    for m, n, pr, pc in GRID_SHAPES:
        for pr_start in ref_geometry.PanelGrid(m, n, pr, pc).panel_row_starts():
            for pc_idx, col in itertools.product(range(-(-n // pc)), range(pc)):
                args = (pr_start, col, pc_idx, pr, pc, m)
                assert geometry.reflector_extent(*args) == ref_geometry.reflector_extent(*args)
    assert geometry.ceildiv(7, 2) == 4 and geometry.round_up(7, 4) == 8


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_to_host_round_trip(rng, dtype):
    x = rng.standard_normal((5, 3)).astype(dtype)
    if np.iscomplexobj(x):
        x = x + 1j * rng.standard_normal((5, 3)).astype(dtype)
    t = torch.from_numpy(x)
    assert hostio.to_device(t) is t                      # a tensor passes through
    back = ct.to_host(t)
    assert back.dtype == x.dtype and np.array_equal(back, x)
    assert np.array_equal(ct.to_host(t.mH), x.conj().T)  # a conjugate view is resolved
    assert ct.to_host(x) is not None and np.array_equal(ct.to_host(x), x)


def test_to_host_bfloat16_is_float32():
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    out = ct.to_host(t)
    assert out.dtype == np.float32 and np.array_equal(out, [1.5, -2.25, 3.0])


def test_to_device_places_on_default_device(monkeypatch):
    x = np.arange(6.0).reshape(2, 3) + 1j
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ct.to_device(x)                              # the card, no fallback
    monkeypatch.setattr(hostio, "DEFAULT_CONFIG", ct.QRConfig(device="cpu"))
    t = ct.to_device(x)
    assert t.device.type == "cpu" and t.dtype == torch.complex128
    assert np.array_equal(ct.to_host(t), x)


def test_bench_on_the_cpu():
    calls = []
    r = bench(lambda a: calls.append(1) or a @ a, torch.ones(8, 8), reps=3, flops=1e6)
    assert isinstance(r, BenchResult) and len(calls) == 1 + 1 + 3
    assert r.steady_s > 0 and r.compile_s > 0 and r.gflops == 1e6 / r.steady_s / 1e9
    assert bench(lambda: None, reps=2).flops is None


def test_public_surface_covers_the_reference():
    assert set(cuda_qr_tpu.__all__) <= set(ct.__all__)
    for name in ct.__all__:
        assert hasattr(ct, name), name
    assert ct.__version__ == cuda_qr_tpu.__version__ == "0.3.0"
    assert "to_device" in ct.__all__ and "to_host" in ct.__all__


def test_utilities_import_no_jax():
    import subprocess
    import sys
    code = ("import sys; import cuda_qr_tpu_torch.utils.debug, cuda_qr_tpu_torch.utils.profiling, "
            "cuda_qr_tpu_torch.utils.hostio, cuda_qr_tpu_torch.oracle.binding; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cuda_qr_tpu.'))"
            " or m == 'cuda_qr_tpu']; assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
