"""HASH — spec-field metadata must agree with the content-hash subtree.

``content_hash()`` is the cache key for every persisted result (the
``ResultCache``, ``.npz`` watermarks, resume). A result-defining field that
silently stays out of the hash is a cache-poisoning incident waiting for
its first collision; a staging field that sneaks *in* shatters cache reuse
for runs that compute identical bytes. So the hash subtree is declared
three times on purpose — and this rule cross-checks the declarations:

* ``HASHED_SECTIONS`` — which top-level spec sections are hashed;
* ``HASH_EXCLUDED_FIELDS`` — per-section fields carved out of the hash
  (``source.throttle_mb_s``/``path``/``layout``: location and bandwidth do
  not change the bytes read);
* per-field ``hashed=`` tags in every ``_meta(...)`` — the machine-readable
  truth ``api.cli`` renders into docs and the runtime test exercises.

Checks: every field of every ``_GROUPS`` dataclass carries ``_meta`` with a
literal ``hashed=`` that matches its section's hashedness and exclusions;
``content_hash`` builds its payload from ``HASHED_SECTIONS`` (not a
hand-maintained dict); any ``hash_payload`` of a section with exclusions
consults ``HASH_EXCLUDED_FIELDS``. The rule is purely structural (AST), so
it also runs on the fixture spec in ``--self-check``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, Rule

SPEC_PATH = "api/spec.py"


def _assign_value(tree: ast.Module, name: str) -> ast.expr | None:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) and node.target.id == name:
                return node.value
    return None


def _const_strs(node: ast.expr | None) -> list[str]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _excluded_map(node: ast.expr | None) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out[k.value] = _const_strs(v)
    return out


def _groups(node: ast.expr | None) -> list[tuple[str, str]]:
    """(section path, class name) pairs from the ``_GROUPS`` literal."""
    out: list[tuple[str, str]] = []
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            if (isinstance(e, ast.Tuple) and len(e.elts) >= 2
                    and isinstance(e.elts[0], ast.Constant)
                    and isinstance(e.elts[1], ast.Name)):
                out.append((e.elts[0].value, e.elts[1].id))
    return out


def _kwarg(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _meta_call(field_call: ast.Call) -> ast.Call | None:
    meta = _kwarg(field_call, "metadata")
    if (isinstance(meta, ast.Call) and isinstance(meta.func, ast.Name)
            and meta.func.id == "_meta"):
        return meta
    return None


def _uses_name(fn: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name for n in ast.walk(fn))


class HashRule(Rule):
    name = "HASH"
    description = ("spec field hashed= tags must match the declared "
                   "content_hash subtree (sections + exclusions)")

    def applies(self, relpath: str) -> bool:
        return relpath == SPEC_PATH

    def check(self, tree, lines, relpath):
        out: list[Finding] = []

        def emit(node, msg):
            out.append(self.finding(relpath, node, msg, lines))

        sections = _const_strs(_assign_value(tree, "HASHED_SECTIONS"))
        excluded = _excluded_map(_assign_value(tree, "HASH_EXCLUDED_FIELDS"))
        groups = _groups(_assign_value(tree, "_GROUPS"))
        if not sections or not groups:
            emit(1, "spec module must declare HASHED_SECTIONS and _GROUPS "
                    "as module-level literals — the hash subtree is checked "
                    "against them")
            return out

        # class name -> section top segments it serves under
        owners: dict[str, list[str]] = {}
        for path, cls_name in groups:
            owners.setdefault(cls_name, []).append(path.split(".")[0])

        classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

        for cls_name, tops in owners.items():
            cls = classes.get(cls_name)
            if cls is None:
                continue
            in_hash = {t in sections for t in tops}
            if len(in_hash) > 1:
                emit(cls, f"{cls_name} serves both hashed and unhashed "
                          "sections — per-field hashed= tags are ambiguous")
                continue
            section_hashed = in_hash.pop()
            carved = {f for t in tops for f in excluded.get(t, ())}
            for stmt in cls.body:
                if not (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    continue
                fname = stmt.target.id
                if not (isinstance(stmt.value, ast.Call)
                        and isinstance(stmt.value.func, ast.Name)
                        and stmt.value.func.id == "field"):
                    emit(stmt, f"{cls_name}.{fname} is not declared via "
                               "field(metadata=_meta(...)) — it has no "
                               "hashed= tag for the cross-check")
                    continue
                meta = _meta_call(stmt.value)
                if meta is None:
                    emit(stmt, f"{cls_name}.{fname} has no _meta metadata "
                               "— every spec field declares its CLI surface "
                               "and hashed= tag")
                    continue
                hashed = _kwarg(meta, "hashed")
                if hashed is None:
                    emit(stmt, f"{cls_name}.{fname} is missing hashed= — "
                               "tag whether this field feeds content_hash")
                    continue
                if not (isinstance(hashed, ast.Constant)
                        and isinstance(hashed.value, bool)):
                    emit(stmt, f"{cls_name}.{fname}: hashed= must be a "
                               "literal True/False (machine-checkable)")
                    continue
                expected = section_hashed and fname not in carved
                if hashed.value != expected:
                    why = ("its section is excluded from content_hash"
                           if not section_hashed else
                           f"HASH_EXCLUDED_FIELDS carves it out"
                           if fname in carved else
                           "its section is hashed and it is not excluded")
                    emit(stmt, f"{cls_name}.{fname}: hashed="
                               f"{hashed.value} but {why}")
            # sections with exclusions must consult the constant, so the
            # carve-out list cannot drift from the actual pops
            if section_hashed and carved:
                payload_fn = next(
                    (n for n in cls.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "hash_payload"), None)
                if payload_fn is None or not _uses_name(
                        payload_fn, "HASH_EXCLUDED_FIELDS"):
                    emit(payload_fn or cls,
                         f"{cls_name}.hash_payload must drop exactly "
                         "HASH_EXCLUDED_FIELDS — hand-listed exclusions "
                         "drift from the declared carve-outs")

        # content_hash must be driven by HASHED_SECTIONS, not a literal dict
        content_fn = next(
            (n for c in classes.values() for n in c.body
             if isinstance(n, ast.FunctionDef) and n.name == "content_hash"),
            None)
        if content_fn is None:
            emit(1, "no content_hash() method found — the spec module must "
                    "define the provenance hash")
        elif not _uses_name(content_fn, "HASHED_SECTIONS"):
            emit(content_fn,
                 "content_hash() does not build its payload from "
                 "HASHED_SECTIONS — a new section (or a tag change) would "
                 "not reach the hash")
        return out
