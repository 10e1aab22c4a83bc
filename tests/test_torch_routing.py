"""Where the port decides between a kernel and its plain version.

Each kernel module (B1 ``ops/chol_kernel.py``, B2 ``ops/geqrt.py``, B3
``ops/select_kernel.py``, B4 ``ops/newton_kernel.py``) owns the decision
for its kernel: its routed entry reads the config's switches.  Besides
them, only the modules that define, convert or print a config, and
``ops/blocked.py``'s complex configuration (which turns the kernels off),
name the kernel switches.  The plain layer, ``ops/smalllinalg.py``, imports
no kernel module.  The checks read the source, so they hold on any machine.
"""

import ast
import pathlib

import pytest

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "cuda_qr_tpu_torch"
KERNEL_MODULES = ("ops/chol_kernel.py", "ops/geqrt.py", "ops/newton_kernel.py",
                  "ops/select_kernel.py")
NAME_THE_SWITCHES = {*KERNEL_MODULES, "utils/config.py", "utils/interop.py", "cli.py",
                     "parallel/dryrun.py", "ops/blocked.py"}
SWITCHES = ("use_chol_kernel", "use_select_kernel")
MODULES = sorted(p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py"))


def tree(module: str) -> ast.Module:
    return ast.parse((PACKAGE / module).read_text())


def switches_named(module: str) -> set:
    """The kernel switches a module reads or sets (attributes and keyword
    arguments; docstrings and comments do not count)."""
    named = set()
    for node in ast.walk(tree(module)):
        if isinstance(node, ast.Attribute) and node.attr in SWITCHES:
            named.add(node.attr)
        elif isinstance(node, ast.keyword) and node.arg in SWITCHES:
            named.add(node.arg)
    return named


def imported_modules(module: str) -> set:
    """The modules a module imports from, relative names resolved to their
    last component (``from .chol_kernel import x`` -> "chol_kernel")."""
    seen = set()
    for node in ast.walk(tree(module)):
        if isinstance(node, ast.ImportFrom):
            seen.add((node.module or "").rsplit(".", 1)[-1])
            seen.update(a.name for a in node.names if node.module is None)
        elif isinstance(node, ast.Import):
            seen.update(a.name.rsplit(".", 1)[-1] for a in node.names)
    return seen


@pytest.mark.parametrize("module", MODULES)
def test_only_the_kernel_modules_read_the_kernel_switches(module):
    named = switches_named(module)
    assert module in NAME_THE_SWITCHES or not named, f"{module} reads {sorted(named)}"


def test_the_kernel_modules_read_their_switches():
    assert "use_chol_kernel" in switches_named("ops/chol_kernel.py")
    assert "use_select_kernel" in switches_named("ops/select_kernel.py")


def test_smalllinalg_imports_no_kernel_module():
    kernels = {pathlib.PurePath(m).stem for m in KERNEL_MODULES}
    assert not imported_modules("ops/smalllinalg.py") & kernels


def test_no_module_imports_a_moved_private_route():
    """The routes have one home each: the TSQR geqrt route is
    ``ops.geqrt.geqrt_auto``, the Newton-Schulz chain
    ``smalllinalg.newton_certified``, the identity ``smalllinalg.eye_like``."""
    moved = {"_geqrt", "_newton_schulz", "_eye", "_newton_on_kernel"}
    for module in MODULES:
        for node in ast.walk(tree(module)):
            if isinstance(node, ast.ImportFrom):
                assert not {a.name for a in node.names} & moved, module
