"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, and
the reference imports nothing of the program. Module names are compared by
their whole top-level name: ``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys
import textwrap

import pytest

from portbench import manifest as M
from portbench import run

HARNESS = sorted(p for p in (M.HERE).rglob("*.py") if "tests" not in p.relative_to(M.HERE).parts)
REFERENCE = sorted((M.HERE / "reference").rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(M.HERE)))
def test_harness_imports_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(M.HERE)))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (JAX | {"repro_torch"})
    # within the benchmark it reads only the yardstick's shapes
    tree = ast.parse(path.read_text())
    inner = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0
             and n.module.startswith("portbench")}
    assert inner <= {"portbench.flops", "portbench.reference.model", "portbench.reference.adamw"}


def test_whole_names_are_compared(monkeypatch):
    for name in [n for n in sys.modules if n.split(".")[0] in JAX]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert run.forbidden_modules() == ["repro"]


def test_a_run_loads_no_jax():
    """A whole run at tiny widths, in a fresh interpreter: the port is
    loaded, none of JAX, flax or ``repro`` is."""
    code = textwrap.dedent("""
        import sys, torch
        from portbench.tests.helpers import tiny
        from portbench import run
        run.execute(tiny("hymba-train-4k"), 1, 0.2, True, torch.device("cpu"))
        run.execute(tiny("mamba2-prefill-4k"), 1, 0.2, True, torch.device("cpu"))
        assert "repro_torch" in sys.modules
        print(run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
