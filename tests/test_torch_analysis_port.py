"""The port's own invariant lint, ``repro_torch.analysis``: the reference's
findings on the reference's fixtures and tree, the torch and CUDA checks
it adds (each flags its seeded violation and spares the clean idiom
beside it), the CLI's exit contract, and no finding on the port itself."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.analysis as ref_analysis  # noqa: E402
from repro.analysis import det as ref_det  # noqa: E402
from repro.analysis import errors as ref_errors  # noqa: E402
from repro.analysis import hashes as ref_hashes  # noqa: E402
from repro.analysis import locks as ref_locks  # noqa: E402
from repro.analysis import shape as ref_shape  # noqa: E402
from repro.analysis import selfcheck as ref_selfcheck  # noqa: E402

import repro_torch.analysis as analysis  # noqa: E402
from repro_torch.analysis import det, errors, hashes, locks, shape  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.analysis.selfcheck import FIXTURE_DIR, FIXTURES, run_self_check  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
REF_FIXTURES = Path(ref_selfcheck.FIXTURE_DIR)

# (reference fixture, path it plays, reference rule, the port's rule)
PARITY = [
    ("det_case.py", "core/det_case.py", ref_det.DetRule(), det.DetRule()),
    ("lock_case.py", "serve/lock_case.py", ref_locks.LockRule(), locks.LockRule()),
    ("err_case.py", "core/err_case.py", ref_errors.ErrRule(), errors.ErrRule()),
    ("hash_case.py", "api/spec.py", ref_hashes.HashRule(), hashes.HashRule()),
]


def _keys(findings):
    return [(f.rule, f.path, f.line, f.message, f.snippet) for f in findings]


def _run(*args, env=None):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env or {**os.environ, "PYTHONPATH": str(ROOT / "src")})


# -- parity with the reference --------------------------------------------------


@pytest.mark.parametrize("fname, relpath, ref_rule, port_rule", PARITY,
                         ids=[p[0] for p in PARITY])
def test_reference_fixture_gives_the_reference_findings(fname, relpath, ref_rule, port_rule):
    src = (REF_FIXTURES / fname).read_text()
    ref_found, ref_supp = ref_analysis.analyze_source(src, relpath, [ref_rule])
    port_found, port_supp = analysis.analyze_source(src, relpath, [port_rule])
    assert ref_found and _keys(port_found) == _keys(ref_found)
    assert port_supp == ref_supp == 1


@pytest.mark.parametrize("fname", ["det_case.py", "lock_case.py", "err_case.py", "hash_case.py"])
def test_port_fixture_is_the_reference_text(fname):
    """The port's fixtures keep the reference's lines: the ERR fixture's
    import of the fault taxonomy is the only line that differs (the DET
    fixture adds torch's cases after the reference's and one import)."""
    ref = (REF_FIXTURES / fname).read_text().splitlines()
    port = (FIXTURE_DIR / fname).read_text().splitlines()
    if fname == "det_case.py":
        port = [line for line in port if line != "import torch"][:len(ref)]
    assert len(port) == len(ref)
    differ = [(a, b) for a, b in zip(ref, port) if a != b]
    if fname == "err_case.py":
        assert differ == [("from repro.runtime.faults import is_transient",
                           "from repro_torch.runtime.faults import is_transient")]
    else:
        assert differ == []


def test_reference_tree_gives_the_reference_findings():
    ref_rules = [ref_det.DetRule(), ref_hashes.HashRule(), ref_locks.LockRule(),
                 ref_errors.ErrRule()]
    port_rules = [det.DetRule(), hashes.HashRule(), locks.LockRule(), errors.ErrRule()]
    ref_report = ref_analysis.analyze_tree(REF, ref_rules)
    port_report = analysis.analyze_tree(REF, port_rules)
    assert _keys(port_report.findings) == _keys(ref_report.findings)
    assert port_report.suppressed == ref_report.suppressed > 0
    assert port_report.files == ref_report.files


def test_translated_shape_fixture_flags_the_reference_lines():
    ref_src = (REF_FIXTURES / "shape_case.py").read_text()
    port_src = (FIXTURE_DIR / "shape_case.py").read_text()
    ref_found, ref_supp = ref_analysis.analyze_source(ref_src, "core/executor.py",
                                                      [ref_shape.ShapeRule()])
    port_found, port_supp = analysis.analyze_source(port_src, "core/executor.py",
                                                    [shape.ShapeRule()])
    assert [f.line for f in port_found] == [f.line for f in ref_found] == [9, 14, 18]
    assert port_supp == ref_supp == 1
    assert all("cuBLAS" in f.message for f in port_found)


# -- the self-check and the port's tree ------------------------------------------


def test_self_check_passes_and_every_rule_has_a_fixture():
    assert run_self_check() == []
    covered = {r.name for _, _, rules in FIXTURES for r in rules}
    assert covered == {r.name for r in analysis.ALL_RULES}
    assert {f for f, _, _ in FIXTURES} == {
        p.name for p in FIXTURE_DIR.iterdir() if p.name.endswith(("_case.py", "_case.cu"))}
    out = _run("--self-check")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 problem(s) across 5 rules" in out.stdout


def test_port_tree_has_no_finding_without_a_baseline():
    """The default root is the port's package; its CUDA sources are read
    and the justified sites are suppressed inline, not baselined."""
    out = _run("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["new"] == [] and report["baselined"] == [] and report["stale_baseline"] == []
    walked = [p for p in PORT.rglob("*")
              if "__pycache__" not in p.parts and p.relative_to(PORT).parts[0] != "analysis"]
    cuda = [p for p in walked if p.suffix in (".cu", ".cuh")]
    py = [p for p in walked if p.suffix == ".py"]
    assert len(cuda) >= 8 and report["files"] == len(cuda) + len(py)
    # the two histogram counters, the float32 ones scatter, and the
    # reference's own sites (CUDA_HOME lookup among them)
    assert report["suppressed_inline"] >= 9
    out = _run("--list-rules")
    assert out.returncode == 0, out.stdout + out.stderr
    assert [line.split()[0] for line in out.stdout.splitlines()] == [r.name for r in analysis.ALL_RULES]


# -- the new checks: a violation flagged, the clean idiom beside it not ----------

CASES = {
    "torch-global-rng": ("core/x.py", "import torch\nx = torch.randn(3)\n",
                         "import torch\nx = torch.randn(3, generator=torch.Generator())\n"),
    "torch-rng-from-import": ("data/x.py", "from torch import randint\nx = randint(0, 9, (3,))\n",
                              "from torch import randint\nx = randint(0, 9, (3,), generator=g)\n"),
    "inplace-sampler": ("kernels/x.py", "x.uniform_(0, 1)\n", "x.uniform_(0, 1, generator=g)\n"),
    "global-seed": ("serve/x.py", "import torch\ntorch.manual_seed(0)\n",
                    "import torch\ng = torch.Generator().manual_seed(0)\n"),
    "cuda-global-seed": ("api/x.py", "import torch\ntorch.cuda.manual_seed_all(0)\n",
                         "import torch\ng = torch.Generator(device='cuda').manual_seed(0)\n"),
    "index-add": ("core/x.py", "out.index_add_(0, idx, src)\n", "out.index_copy_(0, idx, src)\n"),
    "scatter-reduce-sum": ("core/x.py", "out.scatter_reduce_(0, idx, src, 'sum')\n",
                           "out.scatter_reduce_(0, idx, src, 'amax')\n"),
    "index-put-accumulate": ("core/x.py", "out.index_put_((i,), v, accumulate=True)\n",
                             "out.index_put_((i,), v, accumulate=False)\n"),
    "put-accumulate": ("core/x.py", "out.put_(i, v, True)\n", "out.put_(i, v)\n"),
    "weighted-bincount": ("core/x.py", "import torch\nc = torch.bincount(i, w)\n",
                          "import torch\nc = torch.bincount(i, minlength=4)\n"),
    "histc": ("core/x.py", "import torch\nh = torch.histc(x)\n",
              "import numpy as np\nh = np.histogram(x)\n"),
    "cuda-atomic": ("csrc/x.cu", "__device__ void f(float* o, float v) { atomicAdd(o, v); }\n",
                    "__device__ void f(float* o, float v) { o[0] += v; }  // not atomicAdd(o, v)\n"),
    "cuda-atomic-in-literal": ("csrc/x.cuh", "__device__ int f(int* l) { return atomicCAS(l, 0, 1); }\n",
                               '__device__ void f() { printf("atomicCAS(l, 0, 1)"); }\n'),
    "cuda-atomic-exch": ("csrc/x.cu", "__device__ void f(float* o, float v) { atomicExch(o, v); }\n",
                         "__device__ void f(float* o, float v) { if (threadIdx.x == 0) o[0] = v; }\n"),
    "shape-torch-cat": ("core/executor.py", "import torch\ndef f(a):\n    return torch.cat(a)\n",
                        "import numpy as np\ndef f(a):\n    return np.concatenate(a)\n"),
    "shape-pad": ("serve/server.py",
                  "import torch.nn.functional as F\ndef f(x):\n    return F.pad(x, (0, 1))\n",
                  "def f(x, n):\n    return x.reshape(n, -1)\n"),
    "shape-repeat-interleave": (
        "core/executor.py", "import torch\ndef f(x, n):\n    return torch.repeat_interleave(x, n)\n",
        "import torch\ndef f(x, g, n):\n    g.padded_size(n)\n    return torch.repeat_interleave(x, n)\n"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_check_flags_violation_and_spares_clean_idiom(case):
    relpath, bad, good = CASES[case]
    found, _ = analysis.analyze_source(bad, relpath, list(analysis.ALL_RULES))
    assert len(found) == 1, _keys(found)
    assert found[0].line == len(bad.splitlines())
    clean, _ = analysis.analyze_source(good, relpath, list(analysis.ALL_RULES))
    assert clean == [], _keys(clean)


def test_new_checks_respect_scope():
    """torch's RNG and accumulation checks read DET's scope only; a CUDA
    source is read anywhere under the root, and never by the Python rules."""
    bad = "import torch\nx = torch.randn(3)\nout.index_add_(0, i, s)\n"
    for outside in ("launch/x.py", "runtime/x.py", "models/x.py"):
        assert analysis.analyze_source(bad, outside, list(analysis.ALL_RULES))[0] == []
    cu = "__device__ void f(float* o) { atomicAdd(o, 1.f); }\n"
    found, _ = analysis.analyze_source(cu, "kernels/x.cu", list(analysis.ALL_RULES))
    assert [f.rule for f in found] == ["DET"]
    assert analysis.analyze_source(cu, "core/x.cu", [locks.LockRule(), errors.ErrRule()])[0] == []


# -- seeded violations in the port's own sources ---------------------------------

# (port source, code appended to it, the call that must be flagged, rule)
SEEDS = {
    "randn-without-generator": ("core/regions.py", "\n\ndef _draw(n):\n    return {}\n",
                                "torch.randn(n)", "DET"),
    "index-add": ("core/pdf_error.py", "\n\ndef _sum(out, idx, src):\n    return {}\n",
                  "out.index_add_(0, idx, src)", "DET"),
    "cat-outside-padded-size": ("core/executor.py", "\n\ndef _join(parts):\n    return {}\n",
                                "torch.cat(parts)", "SHAPE"),
    "float-atomic-add": ("csrc/hist.cu", "\n__device__ void add_sum(float* out, float v) {{\n  {};\n}}\n",
                         "atomicAdd(out, v)", "DET"),
}


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_seeded_violation_in_a_port_module_is_flagged(seed):
    relpath, extra, call, rule = SEEDS[seed]
    src = (PORT / relpath).read_text()
    assert analysis.analyze_source(src, relpath, list(analysis.ALL_RULES))[0] == []
    seeded = src + extra.format(call)
    found, _ = analysis.analyze_source(seeded, relpath, list(analysis.ALL_RULES))
    want = [i for i, line in enumerate(seeded.splitlines(), 1) if call in line]
    assert [(f.rule, f.line) for f in found] == [(rule, want[-1])]


def test_histogram_counters_need_their_allow():
    src = (PORT / "csrc" / "row_hist.cuh").read_text()
    found, supp = analysis.analyze_source(src, "csrc/row_hist.cuh", [det.DetRule()])
    assert found == [] and supp == 2
    bare = "\n".join(line.split("  // repro: allow[DET]")[0] for line in src.splitlines())
    found, supp = analysis.analyze_source(bare, "csrc/row_hist.cuh", [det.DetRule()])
    assert supp == 0 and [f.message.split()[0] for f in found] == ["atomicAdd", "atomicAdd"]
    assert all("atomicAdd(hist" in f.snippet for f in found)


def test_suppression_accepts_both_comment_styles():
    py = "import torch\nx = torch.randn(3)  # repro: allow[DET]: test\n"
    cu = "__device__ void f(int* c) { atomicAdd(c, 1); }  // repro: allow[DET]: test\n"
    assert analysis.analyze_source(py, "core/x.py", [det.DetRule()]) == ([], 1)
    assert analysis.analyze_source(cu, "csrc/x.cu", [det.DetRule()]) == ([], 1)
    wrong_rule = cu.replace("allow[DET]", "allow[LOCK]")
    assert len(analysis.analyze_source(wrong_rule, "csrc/x.cu", [det.DetRule()])[0]) == 1


# -- the CLI's exit contract -----------------------------------------------------

VIOLATIONS = {
    "py": ("core/bad.py", "import torch\n\n\ndef draw():\n    return torch.randn(3)\n",
           "return torch.randn(3)"),
    "cuda": ("csrc/bad.cu", "__global__ void k(float* o) {\n  atomicAdd(o, 1.f);\n}\n",
             "atomicAdd(o, 1.f);"),
}


def _seeded_tree(tmp_path: Path, kind: str) -> Path:
    relpath, text, _ = VIOLATIONS[kind]
    root = tmp_path / "pkg"
    (root / relpath).parent.mkdir(parents=True)
    (root / relpath).write_text(text)
    return root


@pytest.mark.parametrize("kind", sorted(VIOLATIONS))
def test_cli_flags_seeded_violation(tmp_path, capsys, kind):
    root = _seeded_tree(tmp_path, kind)
    assert analysis_main(["--root", str(root)]) == 1
    out = capsys.readouterr().out
    assert VIOLATIONS[kind][0] in out and "[DET]" in out


@pytest.mark.parametrize("kind", sorted(VIOLATIONS))
def test_cli_json_report(tmp_path, capsys, kind):
    root = _seeded_tree(tmp_path, kind)
    assert analysis_main(["--root", str(root), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["files"] == 1
    assert [f["rule"] for f in report["new"]] == ["DET"]
    assert report["new"][0]["snippet"] == VIOLATIONS[kind][2]


@pytest.mark.parametrize("kind", sorted(VIOLATIONS))
def test_cli_rule_subset(tmp_path, capsys, kind):
    root = _seeded_tree(tmp_path, kind)
    # the violation is DET-only, so a SHAPE-only run is clean
    assert analysis_main(["--root", str(root), "--rules", "SHAPE"]) == 0
    assert analysis_main(["--root", str(root), "--rules", "DET"]) == 1


@pytest.mark.parametrize("kind", sorted(VIOLATIONS))
def test_cli_baseline_carries_a_justified_finding(tmp_path, capsys, kind):
    root = _seeded_tree(tmp_path, kind)
    relpath, _, snippet = VIOLATIONS[kind]
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"findings": [
        {"rule": "DET", "path": relpath, "snippet": snippet, "justification": "test"}]}))
    assert analysis_main(["--root", str(root), "--baseline", str(b)]) == 0
    assert "1 baselined" in capsys.readouterr().out


def test_cli_clean_tree_exits_zero(tmp_path):
    root = tmp_path / "pkg"
    (root / "core").mkdir(parents=True)
    (root / "core" / "ok.py").write_text("X = 1\n")
    (root / "csrc").mkdir()
    (root / "csrc" / "ok.cu").write_text("// atomicAdd(x, 1) in a comment\n")
    assert analysis_main(["--root", str(root)]) == 0


def test_cli_stale_baseline_fails(tmp_path, capsys):
    root = tmp_path / "pkg"
    (root / "core").mkdir(parents=True)
    (root / "core" / "ok.py").write_text("X = 1\n")
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"findings": [
        {"rule": "DET", "path": "core/ok.py", "snippet": "gone()",
         "justification": "was fixed"}]}))
    assert analysis_main(["--root", str(root), "--baseline", str(b)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--rules", "NOPE"], ["--root", "/nonexistent/pkg"]],
                         ids=["unknown-rule", "missing-root"])
def test_cli_usage_error_exits_two(argv):
    assert analysis_main(argv) == 2


# -- no heavy imports -------------------------------------------------------------


def test_runs_with_torch_and_jax_unimportable(tmp_path):
    """With stub ``torch``, ``jax`` and ``numpy`` packages that raise first
    on the path, the lint imports, self-checks and lints the port."""
    for name in ("torch", "jax", "numpy"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('{name} is stubbed out')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT / "src")])}
    for args in ([], ["--self-check"]):
        out = _run(*args, env=env)
        assert out.returncode == 0, out.stdout + out.stderr
    code = ("import sys, repro_torch.analysis\n"
            "assert not {'torch', 'jax', 'numpy', 'repro'} & set(sys.modules), sorted(sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stderr


def test_lint_has_the_reference_fixtures_and_a_cuda_one():
    """The reference's fixtures, each under its own name, plus the CUDA
    fixture that only the port's DET reads."""
    ref = {p.name for p in (REF / "analysis" / "fixtures").glob("*_case.py")}
    port = {p.name for p in (PORT / "analysis" / "fixtures").iterdir()
            if p.name.endswith(("_case.py", "_case.cu"))}
    assert port == ref | {"atomics_case.cu"}
