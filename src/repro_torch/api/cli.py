"""Argparse flags generated from the spec — declared once, used everywhere.

``add_spec_args(parser)`` walks the ``PipelineSpec`` dataclass tree and
registers one flag per field from the field's own metadata (help text,
choices, parser), plus ``--spec FILE`` (load a JSON spec) and ``--serial``
(the prefetch+async-persist kill switch the launchers always offered).
``spec_from_args(parsed)`` rebuilds the spec: start from ``--spec``'s JSON
(or the launcher's ``base`` spec, or all defaults) and overlay *only the
flags the user actually passed* — generated flags default to
``argparse.SUPPRESS``, so a launcher-specific base default (e.g. the
dry-run's 20 bins) survives unless overridden explicitly.

No consumer declares a pipeline knob by hand anymore: adding a field to a
spec dataclass (with its ``_meta``) is all it takes for every launcher,
benchmark, and example to grow the flag — so no launcher can silently drop
a knob (such as ``--group-tol``) that another one takes.

The same single declaration also generates the documentation:
``python -m repro_torch.api.cli --doc`` renders every field (flag, type,
default, choices, help) to markdown. Port of ``repro.api.cli``: the flags,
types and hash tags are the reference's, field for field.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import MISSING, fields
from pathlib import Path

from repro_torch.api.spec import (
    _GROUPS,
    HASHED_SECTIONS,
    SPEC_VERSION,
    PipelineSpec,
)


def _dest(path: str, name: str) -> str:
    return f"spec__{path.replace('.', '_')}__{name}"


def _iter_flag_fields():
    for path, cls, prefix in _GROUPS:
        for f in fields(cls):
            meta = f.metadata
            if not meta or meta.get("type") is None:
                continue  # nested spec fields (e.g. method.tree) have no flag
            yield path, prefix, f, meta


def add_spec_args(parser: argparse.ArgumentParser) -> None:
    """Register every spec field as a flag (grouped per sub-spec), plus
    ``--spec`` and ``--serial``. Safe to call once per parser."""
    parser.add_argument(
        "--spec", default=None, metavar="FILE",
        help="JSON PipelineSpec to load; explicit flags override its fields")
    parser.add_argument(
        "--serial", action="store_true", default=argparse.SUPPRESS,
        help="disable prefetch + async persist (the serial reference path)")
    groups = {}
    for path, prefix, f, meta in _iter_flag_fields():
        top = path.split(".")[0]
        if top not in groups:
            groups[top] = parser.add_argument_group(f"{top} spec")
        flag = meta.get("flag") or "--" + prefix + f.name.replace("_", "-")
        kwargs: dict = {
            "dest": _dest(path, f.name),
            "default": argparse.SUPPRESS,
            "help": meta["help"],
        }
        if meta["type"] is bool:
            kwargs["action"] = argparse.BooleanOptionalAction
        else:
            kwargs["type"] = meta["type"]
            if meta.get("choices"):
                kwargs["choices"] = meta["choices"]
            if meta.get("nargs"):
                kwargs["nargs"] = meta["nargs"]
        groups[top].add_argument(flag, **kwargs)


def explicit_fields(args: argparse.Namespace) -> set[str]:
    """Dotted spec paths the user passed explicitly (e.g. ``method.name``,
    ``compute.types``) — launchers use this to distinguish 'user chose X'
    from 'X is the default' (generated flags default to SUPPRESS)."""
    out = set()
    for path, _prefix, f, _meta in _iter_flag_fields():
        if hasattr(args, _dest(path, f.name)):
            out.add(f"{path}.{f.name}")
    return out


def spec_from_args(
    args: argparse.Namespace, base: PipelineSpec | None = None
) -> PipelineSpec:
    """Build the run's ``PipelineSpec`` from parsed args.

    Precedence: explicit flags > ``--spec`` JSON > ``base`` > spec defaults.
    Every override goes through ``dataclasses.replace``, so the frozen
    specs re-validate after overlay."""
    spec_file = getattr(args, "spec", None)
    if spec_file:
        spec = PipelineSpec.from_json(Path(spec_file).read_text())
    else:
        spec = base if base is not None else PipelineSpec()

    overrides: dict[str, dict] = {}
    for path, _prefix, f, meta in _iter_flag_fields():
        dest = _dest(path, f.name)
        if not hasattr(args, dest):
            continue
        v = getattr(args, dest)
        if meta.get("convert") is not None:
            v = meta["convert"](v)
        elif isinstance(v, list):
            v = tuple(v)
        overrides.setdefault(path, {})[f.name] = v
    if getattr(args, "serial", False):
        overrides.setdefault("execution", {}).update(
            prefetch=False, async_persist=False)

    tree = dataclasses.replace(spec.method.tree, **overrides.get("method.tree", {}))
    method_over = overrides.get("method", {})
    if tree != spec.method.tree:
        method_over = {**method_over, "tree": tree}
    placement = dataclasses.replace(
        spec.execution.placement, **overrides.get("execution.placement", {}))
    exec_over = overrides.get("execution", {})
    if placement != spec.execution.placement:
        exec_over = {**exec_over, "placement": placement}
    return dataclasses.replace(
        spec,
        source=dataclasses.replace(spec.source, **overrides.get("source", {})),
        method=dataclasses.replace(spec.method, **method_over),
        compute=dataclasses.replace(spec.compute, **overrides.get("compute", {})),
        execution=dataclasses.replace(spec.execution, **exec_over),
        serve=dataclasses.replace(spec.serve, **overrides.get("serve", {})),
        stream=dataclasses.replace(spec.stream, **overrides.get("stream", {})),
    )


# -- spec reference documentation (--doc) --------------------------------------

# Which sub-specs enter content_hash() — derived from the spec's own
# HASHED_SECTIONS declaration (never re-stated here), rendered per section
# so the doc states, for every knob, whether changing it changes the
# result identity.
_HASHED_PATHS = tuple(
    path for path, _, _ in _GROUPS if path.split(".")[0] in HASHED_SECTIONS)

_DOC_HEADER = """\
# PipelineSpec reference

> Generated from the spec field metadata by
> `python -m repro_torch.api.cli --doc` — do not edit by hand. One row per
> field of the `PipelineSpec` dataclass tree
> (`src/repro_torch/api/spec.py`), which is the single declaration site for
> every pipeline knob: the same metadata generates the CLI flags of every
> launcher.

Current `SPEC_VERSION`: **{version}**.

Every launcher additionally accepts `--spec FILE` (load a JSON
`PipelineSpec`; explicit flags override its fields) and `--serial`
(shorthand for `--no-prefetch --no-async-persist`, the serial reference
path).

**Hash rule** — `content_hash()` covers `version` + `source` + `method` +
`compute` and the implementation tag `HASH_IMPL` (so a port result never
shares a key with a JAX result); `execution`, `serve`, and `stream` are
excluded by the
staged-executor / coalescing / streaming-update bitwise-equivalence
contracts, as are `source.throttle_mb_s`
(the NFS model only sleeps) and
`source.path`/`source.layout` (a `kind='file'` cube hashes by its
manifest's content sha256, not its location). See DESIGN.md §11/§12/§16.

The per-field **hashed** column below is read from each field's
machine-readable `hashed=` metadata tag. The tag is checked twice: the
static HASH rule (`python -m repro.analysis --root src/repro_torch`,
DESIGN.md §15) cross-checks every tag against the `HASHED_SECTIONS` /
`HASH_EXCLUDED_FIELDS` declarations, and tier-1 tests assert the tags agree
with actual `content_hash()` behavior for every field.
"""


def _fmt(v) -> str:
    """Markdown-cell rendering of a default / choice value."""
    if v is None:
        return "`None`"
    if isinstance(v, tuple):
        return "`" + ", ".join(str(x) for x in v) + "`"
    return f"`{v}`"


def _fmt_type(meta: dict) -> str:
    t = meta.get("type")
    if t is None:
        return "—"
    name = getattr(t, "__name__", str(t))
    return f"list of {name}" if meta.get("nargs") else name


def _flag_of(prefix: str, f, meta: dict) -> str:
    if meta.get("type") is None:
        return "—"  # nested spec (e.g. method.tree): no flag of its own
    flag = meta.get("flag") or "--" + prefix + f.name.replace("_", "-")
    if meta["type"] is bool:
        return f"`{flag}` / `--no-{flag[2:]}`"
    return f"`{flag}`"


def render_spec_reference() -> str:
    """The full markdown reference, deterministically, from the dataclass
    tree — fields, auto-generated flags, types, defaults, choice sets, and
    the help text, one section per sub-spec."""
    out = [_DOC_HEADER.format(version=SPEC_VERSION)]
    for path, cls, prefix in _GROUPS:
        hashed = path in _HASHED_PATHS
        out.append(f"\n## `{path}` — {cls.__name__}\n")
        out.append(("Result-defining: enters `content_hash()`."
                    if hashed else
                    "Staging-only: excluded from `content_hash()` — varying "
                    "these fields cannot change per-point results.") + "\n")
        out.append("\n| field | flag | type | hashed | default | choices | description |")
        out.append("\n|---|---|---|---|---|---|---|")
        for f in fields(cls):
            meta = f.metadata
            default = ("—" if f.default is MISSING
                       else _fmt(f.default))
            if f.name == "tree":
                default = "`TreeSpec()` (see `method.tree`)"
            elif f.name == "placement":
                default = "`PlacementSpec()` (see `execution.placement`)"
            choices = meta.get("choices")
            choices_s = (", ".join(f"`{c}`" for c in choices)
                         if choices else "—")
            help_s = (meta.get("help") or "").replace("|", "\\|")
            hashed_s = "yes" if meta.get("hashed") else "no"
            out.append(
                f"\n| `{f.name}` | {_flag_of(prefix, f, meta)} | "
                f"{_fmt_type(meta)} | {hashed_s} | {default} | "
                f"{choices_s} | {help_s} |")
        out.append("\n")
    return "".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.cli",
        description="spec tooling: render the generated PipelineSpec "
                    "reference (--doc)")
    ap.add_argument("--doc", action="store_true",
                    help="render the spec reference (markdown) to stdout")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the rendered doc here instead of stdout")
    args = ap.parse_args(argv)
    if not args.doc:
        ap.error("nothing to do — pass --doc")
    text = render_spec_reference()
    if args.out:
        Path(args.out).write_text(text)
    else:
        print(text, end="")


if __name__ == "__main__":
    main()
