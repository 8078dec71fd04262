"""repro_torch.analysis — the port's repo-invariant static checker
(DESIGN.md §15), reading PyTorch's and CUDA's idioms.

Every hard-won contract of the port is one careless edit away from
silently breaking: determinism (bitwise results under faults, fixed-order
float reductions in the CUDA kernels), spec content-hash coverage (cache
keys), the serial-shape launch discipline (a differently-shaped launch may
reduce in another order), and the lock/error taxonomy around shared state.
This package walks ``src/repro_torch`` (its Python with ``ast``, its
``csrc/`` CUDA sources as text) and fails CI when a change violates one.

Usage::

    python -m repro_torch.analysis                      # human output, exit code
    python -m repro_torch.analysis --rules DET,LOCK     # subset
    python -m repro_torch.analysis --baseline FILE      # justified old findings
    python -m repro_torch.analysis --json               # machine-readable
    python -m repro_torch.analysis --self-check         # rules vs their fixtures

Exit codes: 0 clean, 1 new findings / stale baseline / self-check failure,
2 usage or internal error. Suppress a single line with
``# repro: allow[RULE]: reason`` (``// repro: allow[RULE]: reason`` in a
CUDA source); park pre-existing findings in a baseline file (every entry
needs a one-line justification). The port carries none.

The rule battery lives in sibling modules (``det``, ``hashes``, ``shape``,
``locks``, ``errors``); ``engine`` owns findings, suppression, baselines,
and the tree walk. Rules never import the code under analysis — the
checker runs on a bare Python without PyTorch or JAX installed.
"""

from repro_torch.analysis.det import DetRule
from repro_torch.analysis.engine import (
    Finding,
    Rule,
    TreeReport,
    analyze_source,
    analyze_tree,
    apply_baseline,
    load_baseline,
)
from repro_torch.analysis.errors import ErrRule
from repro_torch.analysis.hashes import HashRule
from repro_torch.analysis.locks import LockRule
from repro_torch.analysis.shape import ShapeRule

#: The battery, in reporting order.
ALL_RULES = (DetRule(), HashRule(), ShapeRule(), LockRule(), ErrRule())

__all__ = [
    "ALL_RULES", "Finding", "Rule", "TreeReport", "analyze_source",
    "analyze_tree", "apply_baseline", "load_baseline",
]
