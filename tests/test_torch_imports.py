"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_import_without_jax():
    """Every module of the port imports with JAX (and ``repro``) made
    unimportable, as on a machine that has only the port."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.core.pipeline\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    """Without a CUDA device (here) the script exits non-zero and prints no
    result; copied alone into an empty directory it does the same."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_streaming_and_cluster_modules_are_covered():
    """The modules of the streaming and cluster layers are among those
    checked above, and the port's cluster launcher starts only the port,
    with none of the JAX-only environment."""
    assert {"repro_torch.streaming", "repro_torch.streaming.moments",
            "repro_torch.streaming.stats", "repro_torch.streaming.append",
            "repro_torch.streaming.incremental", "repro_torch.runtime.cluster"} <= set(MODULES)
    script = (ROOT / "src" / "repro_torch" / "launch" / "cluster.sh").read_text()
    assert "-m repro_torch.launch.run_pdf" in script
    assert "-m repro_torch.runtime.cluster" in script
    for jax_only in ("-m repro.", "XLA_FLAGS", "JAX_", "CPU_DEVICES_PER_PROC"):
        assert jax_only not in script, jax_only
