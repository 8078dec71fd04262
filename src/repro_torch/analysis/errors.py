"""ERR — exception handling must speak the transient-fault taxonomy.

DESIGN.md §14 classifies failures once, in ``runtime.faults``: transient
(``TransientError``, OSError/TimeoutError families — retry with backoff)
vs fatal (``ShardLostError``, programming errors — re-raise immediately).
A handler that retries outside that taxonomy, or swallows broadly without
consulting it, silently converts bugs into "transients" and retries them
into the quarantine path — the exact failure mode the taxonomy exists to
prevent.

Two checks per ``except`` handler in the runtime-facing packages:

* **broad swallow** — a bare / ``Exception`` / ``BaseException`` handler
  must either re-``raise`` on some path or classify via ``is_transient``;
  one that does neither swallows fatals;
* **foreign retry** — a handler that retries (a ``continue``, or a
  backoff ``sleep`` in its body) may only catch taxonomy types; retrying
  a ``ValueError`` is a loop around a bug.

Deliberate swallow-and-surface-later sites (a worker thread that parks the
exception for the main thread to re-raise) carry ``# repro: allow[ERR]``
with the surfacing path named.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, Rule, qualname

SCOPE = ("core/", "data/", "serve/", "api/", "runtime/")

BROAD = {"Exception", "BaseException"}

# The transient taxonomy: runtime.faults.TransientError and the stdlib
# families is_transient() honors (OSError and subclasses, timeouts).
TRANSIENT_TYPES = {
    "TransientError", "InjectedFault", "PrefetchError",
    "OSError", "IOError", "EnvironmentError", "TimeoutError",
    "ConnectionError", "ConnectionResetError", "BrokenPipeError",
    "FileExistsError", "FileNotFoundError", "PermissionError",
    "InterruptedError", "BlockingIOError",
    # queue backpressure is flow control, not failure — retrying it is the
    # whole point of a bounded queue
    "queue.Empty", "Empty", "queue.Full", "Full",
}


def _caught_names(handler: ast.ExceptHandler) -> list[str]:
    t = handler.type
    if t is None:
        return ["<bare>"]
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    names = []
    for n in nodes:
        q = qualname(n, {})
        names.append(q if q else "<expr>")
    return names


def _body_has(handler: ast.ExceptHandler, *, raises=False, classifies=False,
              retries=False) -> bool:
    for node in ast.walk(handler):
        if raises and isinstance(node, ast.Raise):
            return True
        if classifies and isinstance(node, ast.Call):
            q = qualname(node.func, {}) or ""
            if q.split(".")[-1] == "is_transient":
                return True
        if retries:
            if isinstance(node, ast.Continue):
                return True
            if isinstance(node, ast.Call):
                q = qualname(node.func, {}) or ""
                if q.split(".")[-1] == "sleep":
                    return True
    return False


class ErrRule(Rule):
    name = "ERR"
    description = ("broad excepts must re-raise or classify via "
                   "is_transient; retrying handlers must catch taxonomy "
                   "types only")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(SCOPE)

    def check(self, tree, lines, relpath):
        out: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            names = _caught_names(node)
            broad = any(n in BROAD or n == "<bare>" for n in names)
            raises = _body_has(node, raises=True)
            classifies = _body_has(node, classifies=True)
            retries = _body_has(node, retries=True)
            if broad and not (raises or classifies):
                out.append(self.finding(
                    relpath, node,
                    f"broad except ({', '.join(names)}) neither re-raises "
                    "nor classifies via is_transient — fatal errors are "
                    "swallowed outside the taxonomy (runtime.faults)",
                    lines))
            elif retries and not broad:
                foreign = [n for n in names
                           if n.split(".")[-1] not in TRANSIENT_TYPES
                           and n != "<expr>"]
                if foreign:
                    out.append(self.finding(
                        relpath, node,
                        f"retrying handler catches {', '.join(foreign)} — "
                        "outside the TransientError taxonomy; retrying a "
                        "non-transient loops around a bug",
                        lines))
        return out
