"""The analysis engine: findings, suppression, baselines, and the tree walk.

A :class:`Rule` is a pure function from one module's AST to a list of
:class:`Finding`\\ s; the engine owns everything around that — which files a
rule sees, the ``# repro: allow[RULE]`` inline-suppression syntax, and the
checked-in baseline that lets pre-existing findings ride while new ones
fail. Rules import nothing from the package under analysis (stdlib ``ast``
and ``re`` only), so ``python -m repro_torch.analysis`` runs without PyTorch,
JAX or NumPy present.

The walk reads the port's Python (``*.py``, parsed with ``ast``) and its
CUDA sources (``*.cu``/``*.cuh`` under ``csrc/``, read as text). A rule
declares which of them it reads in ``suffixes``; a CUDA source reaches
``check`` with ``tree=None``.

Finding identity is ``(rule, path, snippet)`` — the *stripped source line*,
not the line number — so a baseline survives unrelated edits above the
finding but goes stale the moment the offending line itself changes, which
is exactly when a human should re-justify it.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path

#: ``# repro: allow[DET]`` or ``# repro: allow[DET,LOCK]: reason`` on the
#: finding's own line suppresses it (``// repro: allow[DET]: reason`` in a
#: CUDA source). Justification text after ``:`` is for the reader; the
#: engine only matches the rule list.
SUPPRESS_RE = re.compile(r"(?:#|//)\s*repro:\s*allow\[([A-Za-z_*,\s]+)\]")

#: The sources the walk reads: Python, and the CUDA kernels under ``csrc/``.
PY_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")

#: Subtrees of the package root the walker never descends into: the
#: analyzer must not lint itself (its fixtures are *deliberate* violations).
EXCLUDE_PREFIXES = ("analysis/",)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source line."""

    rule: str
    path: str  # posix path relative to the package root (e.g. "core/executor.py")
    line: int  # 1-based physical line of the offending node
    message: str
    snippet: str = ""  # stripped source text of that line (baseline identity)

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "snippet": self.snippet}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Rule:
    """Base class: subclasses set ``name``, scope via ``applies`` and emit
    findings from ``check``. One instance is stateless and reusable."""

    name = "RULE"
    description = ""
    suffixes = PY_SUFFIXES  # the file kinds ``check`` reads

    def applies(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.Module | None, lines: list[str],
              relpath: str) -> list[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST | int, message: str,
                lines: list[str]) -> Finding:
        line = node if isinstance(node, int) else node.lineno
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        return Finding(self.name, relpath, line, message, snippet)


# -- shared AST helpers ---------------------------------------------------------


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names to the dotted import they stand for, so
    ``np.random.rand`` resolves to ``numpy.random.rand`` and a
    ``from time import time`` call resolves to ``time.time``."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def qualname(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted name of a ``Name``/``Attribute`` chain with the leading alias
    expanded, or None when the chain roots in anything else (a call result,
    a subscript, ...)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    return ".".join([aliases.get(parts[0], parts[0])] + parts[1:])


def self_attr(node: ast.AST) -> str | None:
    """Attribute name X when ``node`` is ``self.X`` — possibly behind
    subscripts, so ``self._counts["hits"]`` also resolves to ``_counts``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"):
        return node.attr
    return None


# -- suppression ----------------------------------------------------------------


def parse_suppressions(lines: list[str]) -> dict[int, set[str]]:
    """Per-line allow sets: line number -> {rule names} (``*`` = all)."""
    allow: dict[int, set[str]] = {}
    for i, text in enumerate(lines, 1):
        m = SUPPRESS_RE.search(text)
        if m:
            allow[i] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return allow


# -- per-file / per-tree analysis -----------------------------------------------


def analyze_source(src: str, relpath: str,
                   rules: list[Rule]) -> tuple[list[Finding], int]:
    """Run every applicable rule over one source file (Python, or CUDA by
    its suffix); returns the surviving findings and how many were
    suppressed inline."""
    tree = ast.parse(src, filename=relpath) if relpath.endswith(PY_SUFFIXES) else None
    lines = src.splitlines()
    allow = parse_suppressions(lines)
    findings: list[Finding] = []
    suppressed = 0
    for rule in rules:
        if not (relpath.endswith(rule.suffixes) and rule.applies(relpath)):
            continue
        for f in rule.check(tree, lines, relpath):
            marked = allow.get(f.line, ())
            if "*" in marked or f.rule in marked:
                suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed


@dataclass
class TreeReport:
    findings: list[Finding]
    suppressed: int  # inline ``# repro: allow[...]`` hits
    files: int


def analyze_tree(root: Path, rules: list[Rule]) -> TreeReport:
    """Walk every ``.py``, ``.cu`` and ``.cuh`` under ``root`` (the
    ``repro_torch`` package directory), skipping the analyzer's own
    subtree, and run the rule battery."""
    findings: list[Finding] = []
    suppressed = 0
    files = 0
    paths = (p for p in root.rglob("*") if p.suffix in PY_SUFFIXES + CUDA_SUFFIXES)
    for path in sorted(paths):
        relpath = path.relative_to(root).as_posix()
        if relpath.startswith(EXCLUDE_PREFIXES) or "__pycache__" in relpath:
            continue
        files += 1
        got, supp = analyze_source(path.read_text(), relpath, rules)
        findings.extend(got)
        suppressed += supp
    return TreeReport(findings=findings, suppressed=suppressed, files=files)


# -- baseline -------------------------------------------------------------------


class BaselineError(ValueError):
    """Malformed baseline file (bad JSON, missing keys, no justification)."""


def load_baseline(path: Path) -> list[dict]:
    """Parse and validate the baseline. Every entry must carry a one-line
    ``justification`` — an unexplained suppression is a config error, not a
    finding to tolerate."""
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise BaselineError(f"cannot read baseline {path}: {e}") from e
    entries = data.get("findings") if isinstance(data, dict) else None
    if not isinstance(entries, list):
        raise BaselineError(
            f"baseline {path} must be {{\"findings\": [...]}}")
    for i, e in enumerate(entries):
        missing = [k for k in ("rule", "path", "snippet", "justification")
                   if not (isinstance(e, dict) and e.get(k))]
        if missing:
            raise BaselineError(
                f"baseline entry #{i} is missing {missing} "
                f"(every entry needs rule/path/snippet and a justification)")
    return entries


def apply_baseline(
    findings: list[Finding], entries: list[dict],
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split findings into (new, baselined) and report stale entries —
    baseline rows whose (rule, path, snippet) no longer matches anything,
    i.e. the violation was fixed (or edited: re-justify it)."""
    keys = {(e["rule"], e["path"], e["snippet"]): e for e in entries}
    new = [f for f in findings if f.key() not in keys]
    baselined = [f for f in findings if f.key() in keys]
    matched = {f.key() for f in baselined}
    stale = [e for k, e in keys.items() if k not in matched]
    return new, baselined, stale
