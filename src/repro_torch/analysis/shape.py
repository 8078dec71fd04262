"""SHAPE — launch-shape discipline at the device boundary.

A kernel's reduction order follows the shape it is launched at: cuBLAS
picks its tiling and split-K by shape, and the port's own kernels (K1–K4)
split a row's reduction by its length. Two launches that compute "the
same" reduction at different shapes may therefore differ by ~1 ulp — the
reference measured exactly that when a batched concatenate produced a
differently-shaped fused launch than the serial path. The repo's defense
is the *shape-class* discipline: device inputs are padded to a small set
of blessed bucket sizes (``grouping.padded_size``) so batched and serial
runs hit the same launch shape.

This rule guards the two files that build device launches — the executor
and the serving batcher: any ``torch.cat``/``stack``/``reshape``/
``repeat_interleave``-family call, or ``torch.nn.functional.pad``, inside
a function that never consults ``padded_size`` is flagged as a potential
unblessed shape seam. Fixed-shape assemblies that are provably not batch
seams (e.g. a per-point feature triple) carry an inline
``# repro: allow[SHAPE]`` with the argument.

Only ``torch``-qualified calls are matched. Tensor methods (``x.reshape``,
``x.view``) share their names with NumPy's, and host-side ``np.*``
assembly is exempt: NumPy never feeds a launch directly here, and host
concatenation reduces nothing (no re-tiling).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Rule, import_aliases, qualname

SCOPE_FILES = ("core/executor.py", "serve/server.py")

SHAPE_FNS = {"cat", "concat", "concatenate", "stack", "hstack", "vstack",
             "dstack", "column_stack", "reshape", "tile", "repeat_interleave",
             "broadcast_to", "atleast_1d", "atleast_2d", "atleast_3d"}

PAD_FNS = {"torch.nn.functional.pad"}


def _shape_call(q: str | None) -> str | None:
    """The function's name when ``q`` is a matched shape-building call."""
    if q in PAD_FNS:
        return "pad"
    if q and q.count(".") == 1 and q.startswith("torch."):
        attr = q.split(".", 1)[1]
        if attr in SHAPE_FNS:
            return attr
    return None


def _blessed_functions(tree: ast.Module) -> set[ast.AST]:
    """Function nodes whose subtree calls ``padded_size`` — the shape-class
    helper blesses every device assembly in that function."""
    blessed: set[ast.AST] = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if name == "padded_size":
                    blessed.add(fn)
                    break
    return blessed


class ShapeRule(Rule):
    name = "SHAPE"
    description = ("torch cat/stack/reshape/pad feeding a device launch "
                   "outside the padded_size shape-class helpers")

    def applies(self, relpath: str) -> bool:
        return relpath in SCOPE_FILES

    def check(self, tree, lines, relpath):
        aliases = import_aliases(tree)
        blessed = _blessed_functions(tree)
        out = []

        def visit(node: ast.AST, fn_stack: tuple[ast.AST, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn_stack = fn_stack + (node,)
            elif isinstance(node, ast.Call):
                attr = _shape_call(qualname(node.func, aliases))
                if attr and not any(fn in blessed for fn in fn_stack):
                    out.append(self.finding(
                        relpath, node,
                        f"{attr} builds a device tensor's shape outside a "
                        "padded_size shape class — a differently-shaped "
                        "launch of cuBLAS or of K1–K4 may reduce in another "
                        "order (~1 ulp, DESIGN.md §13)",
                        lines))
            for child in ast.iter_child_nodes(node):
                visit(child, fn_stack)

        visit(tree, ())
        return out
