"""``--self-check``: run every rule against its fixture file.

Each fixture under ``fixtures/`` seeds deliberate violations, one per
line, marked with a trailing ``# expect[RULE]`` comment (``// expect[RULE]``
in the CUDA fixture); clean idioms and one ``# repro: allow[RULE]``
suppression ride along as negative cases. The
self-check fails on any delta in either direction — a rule that stops
firing on its own fixtures would otherwise turn the CI gate vacuously
green, and a rule that over-fires would bury real findings in noise.

The fixtures are parsed, never imported, and each is presented to the
engine under a scope path its rule applies to (the SHAPE fixture plays
``core/executor.py``, the HASH fixture plays ``api/spec.py``, the CUDA
fixture plays a kernel source under ``csrc/``).
"""

from __future__ import annotations

import re
from pathlib import Path

from repro_torch.analysis.det import DetRule
from repro_torch.analysis.engine import analyze_source
from repro_torch.analysis.errors import ErrRule
from repro_torch.analysis.hashes import HashRule
from repro_torch.analysis.locks import LockRule
from repro_torch.analysis.shape import ShapeRule

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"

EXPECT_RE = re.compile(r"(?:#|//)\s*expect\[([A-Za-z_,\s]+)\]")

#: (fixture file, relpath it impersonates, rules to run)
FIXTURES = (
    ("det_case.py", "core/det_case.py", (DetRule(),)),
    ("atomics_case.cu", "csrc/atomics_case.cu", (DetRule(),)),
    ("shape_case.py", "core/executor.py", (ShapeRule(),)),
    ("lock_case.py", "serve/lock_case.py", (LockRule(),)),
    ("err_case.py", "core/err_case.py", (ErrRule(),)),
    ("hash_case.py", "api/spec.py", (HashRule(),)),
)


def expected_in(src: str) -> set[tuple[str, int]]:
    """(rule, line) pairs declared by ``# expect[RULE]`` markers."""
    want: set[tuple[str, int]] = set()
    for i, line in enumerate(src.splitlines(), 1):
        m = EXPECT_RE.search(line)
        if m:
            for rule in m.group(1).split(","):
                want.add((rule.strip(), i))
    return want


def run_self_check() -> list[str]:
    """Empty list when every rule reports exactly its fixture's expected
    findings (and its allow-line suppresses); problem strings otherwise."""
    problems: list[str] = []
    for fname, relpath, rules in FIXTURES:
        src = (FIXTURE_DIR / fname).read_text()
        findings, suppressed = analyze_source(src, relpath, list(rules))
        got = {(f.rule, f.line) for f in findings}
        want = expected_in(src)
        for rule, line in sorted(want - got):
            problems.append(
                f"{fname}:{line}: expected a {rule} finding, rule reported "
                "none — the checker has gone blind to this violation class")
        for rule, line in sorted(got - want):
            problems.append(f"{fname}:{line}: unexpected {rule} finding")
        if "repro: allow[" in src and not suppressed:
            problems.append(
                f"{fname}: the fixture's allow[...] line suppressed "
                "nothing — inline suppression is broken")
    return problems
