"""DET — determinism sources inside result-defining modules.

The bitwise contracts (staged-executor equivalence §9, fault recovery §14,
coalescing equivalence) all assume a window's bytes depend on the spec
alone. This rule flags the ways ambient state leaks into that path:

* wall-clock reads (``time.time`` / ``datetime.now``) — timing-only uses
  (staleness checks, backoff) carry a justified ``# repro: allow[DET]``;
* unseeded randomness: NumPy's global RNG (``np.random.rand`` et al.), a
  seed-less ``default_rng()`` / ``RandomState()``, the stdlib ``random``
  module, ``os.urandom`` / ``secrets`` / ``uuid.uuid4``, and torch's
  global generator — a sampler (``torch.randn``, ``x.normal_()``, ...)
  without ``generator=`` — or its process-global state
  (``torch.manual_seed``, ``torch.cuda.set_rng_state``, ...);
* environment reads (``os.environ`` / ``os.getenv``) — config must arrive
  through the spec, never ambiently;
* iteration over a ``set`` literal / comprehension / call — string hashing
  is salted per process (PYTHONHASHSEED), so set order is run-dependent;
  ordered consumers (``sorted``, ``min``/``max``), membership tests, and
  aggregations (``len``/``sum``/``any``/``all``) are fine;
* float accumulation whose order CUDA does not fix: ``index_add``,
  ``scatter_add``, ``index_reduce_``/``scatter_reduce`` (but ``amin`` and
  ``amax``, which are order-free), ``index_put``/``put_`` with
  ``accumulate=True``, a weighted ``bincount`` and ``histc`` — their
  CUDA kernels add with atomics, so a float result's last bits depend on
  thread timing. The AST cannot see dtypes: an exact site (integer
  values, or float ones below 2^24) carries ``# repro: allow[DET]`` with
  the argument;
* in the CUDA sources (``*.cu``/``*.cuh``, comments stripped), every
  ``atomicAdd``/``atomicSub``/``atomicCAS``/``atomicExch`` — the float
  form reduces in thread order, and the value an exchange leaves is the
  last thread's; an integer counter, exact in any order, carries
  ``// repro: allow[DET]: reason`` on its line.

Scope: ``core/``, ``kernels/``, ``data/``, ``serve/``, ``api/`` — the
modules whose outputs are result-defining — and every CUDA source under
the root (the kernels' bodies, in ``csrc/``). ``runtime/`` (monitor,
backoff, fault clocks) and ``launch/`` are timing/UX layers and exempt by
design.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import (
    CUDA_SUFFIXES,
    PY_SUFFIXES,
    Finding,
    Rule,
    import_aliases,
    qualname,
)

SCOPE = ("core/", "kernels/", "data/", "serve/", "api/")

WALL_CLOCK = {
    "time.time": "wall-clock read (time.time)",
    "time.time_ns": "wall-clock read (time.time_ns)",
    "datetime.datetime.now": "wall-clock read (datetime.now)",
    "datetime.datetime.utcnow": "wall-clock read (datetime.utcnow)",
    "datetime.datetime.today": "wall-clock read (datetime.today)",
    "datetime.date.today": "wall-clock read (date.today)",
}

# numpy.random attributes that are NOT the seeded-generator API: anything
# else on numpy.random is the shared global RNG.
NP_RANDOM_OK = {"default_rng", "Generator", "RandomState", "SeedSequence",
                "PCG64", "Philox", "SFC64", "MT19937", "BitGenerator"}

ENTROPY = {
    "os.urandom": "os.urandom is non-deterministic entropy",
    "uuid.uuid4": "uuid.uuid4 is non-deterministic entropy",
}

# builtins that materialize their argument's iteration order
ORDER_SINKS = {"list", "tuple", "iter", "enumerate"}

# torch samplers that draw from the global generator unless given one
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "rand_like",
                  "randn_like", "randint_like", "normal", "bernoulli",
                  "multinomial", "poisson"}

# in-place samplers, matched by attribute name: the AST cannot type the
# receiver, and no numpy or stdlib method shares these names
TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "exponential_",
                          "bernoulli_", "cauchy_", "log_normal_", "geometric_"}

# calls that seed or overwrite the process-global generators
TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.set_rng_state",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.random.set_rng_state", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.cuda.set_rng_state", "torch.cuda.set_rng_state_all",
}

# accumulating scatters whose CUDA kernels add with atomics, in any order
ACCUMULATE_ALWAYS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                     "histc"}
# reductions that are order-free only under these reduce modes; the value
# is the position of ``reduce`` in the method form's arguments
REDUCE_OPS = {"scatter_reduce": 3, "scatter_reduce_": 3, "index_reduce_": 3}
ORDER_FREE_REDUCE = {"amin", "amax"}
# writes that accumulate only with ``accumulate=True``; the value is the
# position of ``accumulate`` in the method form's arguments
ACCUMULATE_FLAG = {"index_put": 2, "index_put_": 2, "put_": 2}

# CUDA atomics, called (``atomicAdd(`` / ``atomicAdd_block(``)
CUDA_ATOMIC_RE = re.compile(r"\b(atomic(?:Add|Sub|CAS|Exch))(?:_block|_system)?\s*\(")
# comments and literals of a CUDA source, blanked before matching
CUDA_STRIP_RE = re.compile(
    r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"|'(?:\\.|[^'\\\n])*'", re.S)


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


def _arg(node: ast.Call, name: str, pos: int) -> ast.expr | None:
    """The argument ``name``, by keyword or at position ``pos``."""
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return node.args[pos] if len(node.args) > pos else None


def _global_draw(node: ast.Call, q: str | None) -> str | None:
    """The sampler's name when ``node`` draws from torch's global generator
    (no ``generator=``), else None."""
    if any(kw.arg == "generator" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in node.keywords):
        return None
    if q and q.count(".") == 1 and q.startswith("torch."):
        name = q.split(".", 1)[1]
        return name if name in TORCH_SAMPLERS else None
    if isinstance(node.func, ast.Attribute) and node.func.attr in TORCH_INPLACE_SAMPLERS:
        return node.func.attr
    return None


def _accumulation(node: ast.Call, q: str | None) -> str | None:
    """The op name when ``node`` is a float-accumulating scatter, else None.
    ``torch.op(input, ...)`` shifts every argument one place right of the
    method form ``input.op(...)``."""
    if not isinstance(node.func, ast.Attribute):
        return None
    op = node.func.attr
    if q and q.startswith("numpy."):
        return None
    shift = 1 if q == f"torch.{op}" else 0
    if op in ACCUMULATE_ALWAYS:
        return op
    if op in REDUCE_OPS:
        mode = _arg(node, "reduce", REDUCE_OPS[op] + shift)
        if isinstance(mode, ast.Constant) and mode.value in ORDER_FREE_REDUCE:
            return None
        return op
    if op in ACCUMULATE_FLAG:
        flag = _arg(node, "accumulate", ACCUMULATE_FLAG[op] + shift)
        if isinstance(flag, ast.Constant) and flag.value is True:
            return f"{op}(accumulate=True)"
        return None
    if op == "bincount" and _arg(node, "weights", shift) is not None:
        return "weighted bincount"
    return None


def _blank(m: re.Match) -> str:
    """A stripped comment or literal, as spaces with its newlines kept (so
    every match keeps its line)."""
    text = m.group(0)
    if text[0] in "\"'":
        return text[0] + " " * (len(text) - 2) + text[-1]
    return re.sub(r"[^\n]", " ", text)


class DetRule(Rule):
    name = "DET"
    description = ("no unseeded randomness, wall-clock, env reads, "
                   "set-iteration-order leakage or unordered float "
                   "accumulation in result-defining modules and kernels")
    suffixes = PY_SUFFIXES + CUDA_SUFFIXES

    def applies(self, relpath: str) -> bool:
        return relpath.endswith(CUDA_SUFFIXES) or relpath.startswith(SCOPE)

    def check(self, tree, lines, relpath):
        if tree is None:
            return self._check_cuda(lines, relpath)
        aliases = import_aliases(tree)
        out: list[Finding] = []

        def emit(node, msg):
            out.append(self.finding(relpath, node, msg, lines))

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                q = qualname(node.func, aliases)
                draw = _global_draw(node, q)
                acc = _accumulation(node, q)
                if q in WALL_CLOCK:
                    emit(node, WALL_CLOCK[q]
                         + " — results must not depend on when they ran")
                elif q in ENTROPY:
                    emit(node, ENTROPY[q])
                elif q and q.startswith("numpy.random."):
                    attr = q.rsplit(".", 1)[1]
                    if attr not in NP_RANDOM_OK:
                        emit(node, f"numpy global-RNG call ({attr}) — use "
                                   "np.random.default_rng(seed)")
                    elif attr in ("default_rng", "RandomState") and not (
                            node.args or node.keywords):
                        emit(node, f"{attr}() without a seed draws OS entropy")
                elif q and (q.startswith("random.") or q.startswith("secrets.")):
                    emit(node, f"{q} is unseeded process-global randomness")
                elif q == "os.getenv" or (q or "").startswith("os.environ."):
                    emit(node, "environment read — configuration must come "
                               "from the spec, not ambient state")
                elif q in TORCH_GLOBAL_SEED:
                    emit(node, f"{q} sets process-global RNG state — seed a "
                               "torch.Generator and pass it as generator=")
                elif draw:
                    emit(node, f"torch global-RNG call ({draw}) — pass "
                               "generator=torch.Generator(...).manual_seed(seed)")
                elif acc:
                    emit(node, f"{acc} accumulates in an order CUDA does not "
                               "fix — a float result's last bits vary run to "
                               "run; allow it only where the sum is exact")
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in ORDER_SINKS and node.args
                        and _is_set_expr(node.args[0])):
                    emit(node, f"{node.func.id}() over a set materializes "
                               "hash-salted iteration order")
            elif isinstance(node, ast.Subscript):
                if qualname(node.value, aliases) == "os.environ":
                    emit(node, "environment read — configuration must come "
                               "from the spec, not ambient state")
            elif isinstance(node, ast.For) and _is_set_expr(node.iter):
                emit(node, "for-loop over a set leaks hash-salted iteration "
                           "order into results (sort it)")
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter):
                        emit(gen.iter, "comprehension over a set leaks "
                                       "hash-salted iteration order (sort it)")
        return out

    def _check_cuda(self, lines, relpath):
        code = CUDA_STRIP_RE.sub(_blank, "\n".join(lines))
        out: list[Finding] = []
        for m in CUDA_ATOMIC_RE.finditer(code):
            line = code.count("\n", 0, m.start()) + 1
            out.append(self.finding(
                relpath, line,
                f"{m.group(1)} acts in thread order — a float sum's last bits, "
                "or the value an exchange leaves, vary run to run; only an "
                "integer counter (exact in any order) may carry an allow", lines))
        return out
