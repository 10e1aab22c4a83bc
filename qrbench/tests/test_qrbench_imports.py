"""No module that a run loads is JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

from qrbench import run
from qrbench.tests.tiny_root import REPO

PROGRAM = "cuda_qr_tpu_torch"


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(out.split())


def test_a_run_loads_no_jax():
    code = ("import sys, tempfile, pathlib, torch\n"
            "torch.set_num_threads(2)\n"
            "from qrbench.tests.tiny_root import make_root\n"
            "from qrbench.run import run_cell\n"
            "root = make_root(pathlib.Path(tempfile.mkdtemp()))\n"
            "for w in ('qr8192.qr', 'tsqr1M.qr', 'qr8192.apply_qt'):\n"
            "    assert run_cell(w, 3, 0.1, w == 'qr8192.qr', root=root, device='cpu')['correct']\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    names = _top_levels(code)
    assert PROGRAM in names
    assert not names & set(run.FORBIDDEN)


def test_forbidden_names_compare_whole_top_levels():
    saved = dict(sys.modules)
    try:
        sys.modules["cuda_qr_tpu_torch_extra"] = sys
        assert "cuda_qr_tpu" not in run.loaded_forbidden()
        sys.modules["cuda_qr_tpu.models"] = sys
        assert "cuda_qr_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((REPO / "qrbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in ("torch", "__future__", "math", "numpy"), (path, name)
    code = ("import sys, qrbench.reference.thin_qr, qrbench.reference.apply_qt\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    names = _top_levels(code)
    assert PROGRAM not in names and not names & set(run.FORBIDDEN)
