"""LOCK — lock-consistency inference for shared mutable state.

A store-vs-evict race in the result cache motivated this rule: a counter or map
that is *sometimes* mutated under a lock is a cross-thread contract, and
every other mutation site is a race until proven otherwise.

The analysis is RacerD-style inference, per class, with no annotations:

1. a class owns a lock when a method assigns ``self.X = threading.Lock()``
   (or ``RLock``);
2. pass 1 — every ``self.Y`` mutated inside ``with self.X:`` becomes
   *guarded* (assignment, augmented assignment, subscript store, deletion,
   or a known mutator-method call like ``.append``/``.setdefault``);
3. pass 2 — a mutation of a guarded attribute *outside* any lock is a
   finding. ``__init__``/``__post_init__`` are exempt (no concurrent
   aliases exist yet), and a nested function's body resets the held-lock
   depth: defining a closure under ``with`` does not mean it *runs* there.

Reads are deliberately not flagged: ``stats()``-style snapshots are racy
but benign by documented contract ("may lag"), and flagging them would
drown the mutation signal that actually corrupts state.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, Rule, qualname, self_attr

SCOPE = ("core/", "data/", "serve/", "api/", "runtime/")

LOCK_FACTORIES = {"threading.Lock", "threading.RLock"}

MUTATORS = {"append", "appendleft", "add", "extend", "insert", "remove",
            "discard", "pop", "popitem", "popleft", "clear", "update",
            "setdefault", "move_to_end", "sort", "reverse"}

INIT_METHODS = {"__init__", "__post_init__", "__new__"}


def _lock_attrs(cls: ast.ClassDef, aliases: dict[str, str]) -> set[str]:
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if qualname(node.value.func, aliases) in LOCK_FACTORIES:
                for t in node.targets:
                    attr = self_attr(t)
                    if attr:
                        locks.add(attr)
    return locks


def _mutations(node: ast.AST) -> list[tuple[str, ast.AST]]:
    """(attr, node) pairs for every ``self.X`` mutation rooted at ``node``
    itself (non-recursive — the walker drives traversal)."""
    out: list[tuple[str, ast.AST]] = []

    def targets_of(t: ast.AST):
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                targets_of(elt)
        else:
            attr = self_attr(t)
            if attr:
                out.append((attr, t))

    if isinstance(node, ast.Assign):
        for t in node.targets:
            targets_of(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        if node.value is not None or isinstance(node, ast.AugAssign):
            targets_of(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            targets_of(t)
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in MUTATORS:
            attr = self_attr(node.func.value)
            if attr:
                out.append((attr, node))
    return out


class LockRule(Rule):
    name = "LOCK"
    description = ("attributes mutated under a class's lock must always be "
                   "mutated under it (inferred guarded-by sets)")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(SCOPE)

    def check(self, tree, lines, relpath):
        from repro_torch.analysis.engine import import_aliases

        aliases = import_aliases(tree)
        out: list[Finding] = []
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(cls, aliases, lines, relpath))
        return out

    def _check_class(self, cls, aliases, lines, relpath):
        locks = _lock_attrs(cls, aliases)
        if not locks:
            return []

        guarded: dict[str, str] = {}  # attr -> lock it was seen held under
        findings: list[tuple[str, ast.AST]] = []

        def walk(node: ast.AST, depth: int, collect: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # a nested def/lambda runs later, not under the current lock
                body = node.body if isinstance(node.body, list) else [node.body]
                for child in body:
                    walk(child, 0, collect)
                return
            held = depth
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = self_attr(item.context_expr)
                    if attr in locks:
                        held += 1
            for attr, at in _mutations(node):
                if attr in locks:
                    continue
                if held and collect:
                    guarded.setdefault(attr, "lock")
                elif not held and not collect and attr in guarded:
                    findings.append((attr, at))
            for child in ast.iter_child_nodes(node):
                walk(child, held, collect)

        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for phase_collect in (True, False):
            for m in methods:
                if m.name in INIT_METHODS:
                    continue
                for stmt in m.body:
                    walk(stmt, 0, phase_collect)

        return [self.finding(
            relpath, at,
            f"{cls.name}.{attr} is mutated under a lock elsewhere but "
            "unlocked here — cross-thread mutation must hold the lock",
            lines) for attr, at in findings]
