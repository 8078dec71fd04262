"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

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


def test_lm_modules_are_covered():
    """The LM serving path's modules, the SSD's, the enc-dec's and the
    four MoE, VLM and enc-dec configs included, are among those checked
    above."""
    assert {"repro_torch.models.ssm", "repro_torch.models.transformer", "repro_torch.models.layers",
            "repro_torch.models.encdec", "repro_torch.configs.mamba2_780m",
            "repro_torch.configs.hymba_1_5b", "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.configs.llama32_vision_90b", "repro_torch.configs.arctic_480b",
            "repro_torch.configs.kimi_k2_1t", "repro_torch.launch.serve_decode",
            "repro_torch.launch.serve"} <= set(MODULES)


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


def test_training_modules_are_covered():
    """The training path's modules (optimizers, checkpoints, the token
    pipeline, the trainer) are among those checked above."""
    assert {"repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
            "repro_torch.optim.schedule", "repro_torch.optim.compression",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.data.tokens", "repro_torch.launch.train",
            "repro_torch.runtime.trace"} <= set(MODULES)


def test_accounting_modules_are_covered():
    """The accounting layer's modules (shapes, mesh, placements, roofline,
    the dry runs and the report) are among those checked above, and the
    dry runs set no XLA flags."""
    new = {"repro_torch.configs.shapes", "repro_torch.launch.mesh", "repro_torch.models.sharding",
           "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
           "repro_torch.launch.dryrun_pdf", "repro_torch.launch.report"}
    assert new <= set(MODULES)
    for name in ("dryrun", "dryrun_pdf"):
        source = (ROOT / "src" / "repro_torch" / "launch" / f"{name}.py").read_text()
        assert "os.environ" not in source, name


def test_multi_device_modules_are_covered():
    """The multi-device half (the pipeline stages beside the mesh,
    placements, compression, grouping and loader modules it extends) is
    among the modules checked above, and the port's module list now holds
    every module of the reference's, its invariant lint ``analysis``
    included, but two plain versions that live in the port's ``kernel.py``
    files."""
    assert {"repro_torch.launch.pipeline_pp", "repro_torch.launch.mesh",
            "repro_torch.models.sharding", "repro_torch.optim.compression",
            "repro_torch.core.grouping", "repro_torch.data.loader"} <= set(MODULES)
    ref = {".".join(p.relative_to(ROOT / "src" / "repro").with_suffix("").parts).removesuffix(
        ".__init__") for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {m.removeprefix("repro_torch.") for m in MODULES}
    assert ref - port == {"kernels.hist.ref", "kernels.moments.ref"}


TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))


def _is_port_import(node) -> bool:
    """A module-level import that needs torch: torch itself, the port, or
    another port test module."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        names = [node.module]
    else:
        return False
    return any(n.split(".")[0] in ("torch", "repro_torch") or n.startswith("test_torch_")
               for n in names)


def _is_torch_skip(node) -> bool:
    """``pytest.importorskip("torch")``, bare or assigned."""
    call = node.value if isinstance(node, (ast.Expr, ast.Assign)) else None
    return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "importorskip" and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "pytest" and len(call.args) == 1
            and isinstance(call.args[0], ast.Constant) and call.args[0].value == "torch")


@pytest.mark.parametrize("path", TEST_FILES, ids=lambda p: p.name)
def test_port_test_skips_before_it_imports_torch(path):
    """Every port test file calls ``pytest.importorskip("torch")`` at module
    level before its first import of torch, the port or another port test."""
    body = ast.parse(path.read_text(), filename=str(path)).body
    skip = next((i for i, node in enumerate(body) if _is_torch_skip(node)), None)
    first = next((i for i, node in enumerate(body) if _is_port_import(node)), len(body))
    assert skip is not None and skip < first, (skip, first)


def test_port_tests_collect_as_skipped_without_torch(tmp_path):
    """With torch made unimportable (a stub package first on the path, as
    on a machine without the wheel) every port test file is collected as
    skipped: no collection error, nothing interrupted."""
    stub = tmp_path / "torch"
    stub.mkdir()
    (stub / "__init__.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'torch'\", name='torch')\n")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-rs", "-p", "no:cacheprovider",
         "-p", "no:xdist", *(str(p.relative_to(ROOT)) for p in TEST_FILES)],
        cwd=ROOT, capture_output=True, text=True, timeout=180, stdin=subprocess.DEVNULL,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT / "src")]),
             "JAX_PLATFORMS": "cpu"})
    text = out.stdout + out.stderr
    assert out.returncode in (0, 5), text  # 5: nothing collected, every file skipped
    assert "Interrupted" not in text and "error" not in text.lower(), text
    assert text.count("could not import 'torch'") == len(TEST_FILES), text
