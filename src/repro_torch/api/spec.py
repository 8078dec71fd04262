"""The declarative pipeline spec: one serializable object drives every run.

Port of ``repro.api.spec``. The paper's pipeline is one conceptual object —
a cube source, a method (baseline / grouping / reuse / ML / sampling), and
an execution strategy — declared here as a frozen, versioned dataclass tree
that

  * validates every knob at construction (not deep inside a run),
  * round-trips through JSON (``to_json`` / ``from_json``), and
  * has a stable content hash over its *result-defining* subtree
    (``content_hash``) — embedded in persisted ``.npz`` watermarks and
    BENCH rows for provenance and resume-mismatch detection.

Hash rule: ``version + source + method + compute`` are hashed; ``execution``
is NOT — staging knobs (prefetch, shards, persist dir, result cache) are
bitwise-invariant by the staged-executor equivalence contract (DESIGN.md §9),
so two runs with the same hash must produce identical per-point results —
the invariant the spec-hash-keyed ``ResultCache`` is built on.
``kind='file'`` sources hash by their on-disk manifest's content sha256
(DESIGN.md §12), so the hash pins the bytes read, not just the knobs.

Every field carries its own CLI metadata (``help``/``choices``/parsers), so
``api.cli`` can generate argparse flags from this single declaration —
consumers never declare a pipeline knob by hand.

The JSON is the reference's, field for field: a reference spec file loads
here unchanged and a port spec's ``to_json`` loads in the reference. The
content hash is not: ``HASH_IMPL`` enters the hash payload (never the
JSON), so a port result and a JAX result of the same spec — equal within
the parity tolerances, not bitwise — never share a key in a ``cache_dir``
or a watermark.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from dataclasses import dataclass, field, fields
from typing import Any

from repro_torch.core import distributions as dists
from repro_torch.core import fitting
from repro_torch.core import grouping as grp
from repro_torch.core.executor import (
    METHODS,
    SAMPLERS,
    SELECT_BACKENDS,
    ExecutorConfig,
    PDFConfig,
)

# Version 2: SourceSpec grew kind='file' (+ path/layout) and file sources
# hash by their manifest's content sha256 — a semantic change to the hash
# payload, so version-1 specs must be re-emitted.
# Version 3: the ``stream`` section (StreamSpec — streaming ingestion /
# incremental recompute). Staging-only, so version-2 specs upgrade in place:
# ``from_dict`` loads them with ``stream`` defaults and a warning (the
# forward-compat shim), not an error.
# Version 4: the ``execution.placement`` section (PlacementSpec —
# multi-process cluster execution) and ``execution.compile_cache_dir``
# (persistent compilation cache). Staging-only again, so version-2/3
# specs upgrade in place through the same shim.
SPEC_VERSION = 4

# Which implementation computed a result: part of every content hash, so
# the same spec hashes differently here and in the JAX reference.
HASH_IMPL = "repro_torch"

MODES = ("faithful", "fused")
SOURCE_KINDS = ("simulation", "external", "file")
FILE_LAYOUTS = ("chunked",)  # mirrors data.file_source.LAYOUTS

# The hash subtree, declared once and machine-checked: ``content_hash``
# covers exactly these top-level sections (``execution``/``serve`` are
# staging-only by the bitwise-equivalence contracts, DESIGN.md §9/§13),
# minus the per-section carve-outs below (location and bandwidth do not
# change the observations read). Every field additionally carries a
# ``hashed=`` tag in its ``_meta`` — the static HASH rule
# (``python -m repro.analysis``) cross-checks tags against these
# declarations, and tests/test_torch_api.py asserts the tags agree with
# actual ``content_hash`` behavior for every single field.
HASHED_SECTIONS = ("source", "method", "compute")
HASH_EXCLUDED_FIELDS = {"source": ("throttle_mb_s", "path", "layout")}


def _meta(help_: str, *, hashed: bool, type_: Any = None, choices=None,
          nargs=None, flag: str | None = None, convert=None) -> dict:
    """CLI metadata attached to a spec field (consumed by ``api.cli``):
    ``type_``/``choices``/``nargs`` feed argparse, ``flag`` overrides the
    auto-derived flag name, ``convert`` post-processes the parsed value
    (e.g. '--types 4' -> the TYPES_4 tuple). ``hashed`` is the
    machine-readable tag for whether this field feeds ``content_hash`` —
    required, so no spec field can ship without declaring its hash
    behavior (the HASH rule verifies the tag against HASHED_SECTIONS /
    HASH_EXCLUDED_FIELDS)."""
    return {"help": help_, "hashed": hashed, "type": type_,
            "choices": choices, "nargs": nargs, "flag": flag,
            "convert": convert}


def _types_convert(vals):
    """'--types 4' / '--types 10' expand to the paper's candidate sets;
    anything else is an explicit list of distribution names."""
    vals = list(vals)
    if vals == ["4"]:
        return dists.TYPES_4
    if vals == ["10"]:
        return dists.TYPES_10
    return tuple(vals)


@dataclass(frozen=True)
class SourceSpec:
    """Where observations come from. ``kind='simulation'`` is the lazy
    Monte-Carlo seismic cube (data/simulation.py) and is fully described by
    these fields; ``kind='file'`` is an exported cube directory on disk/NFS
    (data/file_source.py) identified by ``path`` — geometry comes from its
    manifest and the spec hashes by the manifest's content sha256, so
    provenance tracks the actual bytes read; ``kind='external'`` marks a
    caller-supplied window source (``PDFSession(spec, data_source=...)`` or
    the ``PDFComputer`` shim) whose identity the spec cannot capture —
    geometry fields are advisory for both non-simulation kinds."""

    kind: str = field(default="simulation", metadata=_meta(
        "observation source", hashed=True, type_=str, choices=list(SOURCE_KINDS)))
    path: str | None = field(default=None, metadata=_meta(
        "exported cube directory (kind='file'; see data.file_source)", hashed=False,
        type_=str, flag="--source-path"))
    layout: str = field(default="chunked", metadata=_meta(
        "on-disk cube layout (kind='file')", hashed=False, type_=str,
        choices=list(FILE_LAYOUTS)))
    num_slices: int = field(default=8, metadata=_meta(
        "cube depth (slices)", hashed=True, type_=int))
    lines_per_slice: int = field(default=24, metadata=_meta(
        "lines per slice", hashed=True, type_=int, flag="--lines"))
    points_per_line: int = field(default=60, metadata=_meta(
        "points per line", hashed=True, type_=int, flag="--ppl"))
    observations: int = field(default=300, metadata=_meta(
        "Monte-Carlo observations per point", hashed=True, type_=int, flag="--obs"))
    num_layers: int = field(default=16, metadata=_meta(
        "velocity-model layers (type cycle)", hashed=True, type_=int))
    base_vp: float = field(default=3000.0, metadata=_meta(
        "m/s scale of the layered velocity model", hashed=True, type_=float))
    quantize_decimals: int = field(default=3, metadata=_meta(
        "output rounding -> grouping redundancy", hashed=True, type_=int))
    group_block: int = field(default=4, metadata=_meta(
        "points per line sharing one generator cell", hashed=True, type_=int))
    line_block: int = field(default=2, metadata=_meta(
        "consecutive lines sharing generator cells", hashed=True, type_=int))
    seed: int = field(default=0, metadata=_meta(
        "simulation seed", hashed=True, type_=int))
    throttle_mb_s: float | None = field(default=None, metadata=_meta(
        "model NFS reads at this bandwidth (MB/s; overlap benchmarks)", hashed=False,
        type_=float))

    def __post_init__(self):
        if self.kind not in SOURCE_KINDS:
            raise ValueError(f"source kind must be one of {SOURCE_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "file" and not self.path:
            raise ValueError(
                "source.kind='file' requires source.path (an exported cube "
                "directory — data.file_source.export_cube writes one)")
        if self.kind != "file" and self.path is not None:
            raise ValueError(
                f"source.path is only meaningful for kind='file', "
                f"got path={self.path!r} with kind={self.kind!r}")
        if self.layout not in FILE_LAYOUTS:
            raise ValueError(
                f"source.layout must be one of {FILE_LAYOUTS}, "
                f"got {self.layout!r}")
        for name in ("num_slices", "lines_per_slice", "points_per_line",
                     "observations", "num_layers", "group_block", "line_block"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"source.{name} must be a positive int, got {v!r}")
        if self.quantize_decimals < 0:
            raise ValueError(
                f"source.quantize_decimals must be >= 0, got {self.quantize_decimals}")
        if self.throttle_mb_s is not None and not self.throttle_mb_s > 0:
            raise ValueError(
                f"source.throttle_mb_s must be > 0, got {self.throttle_mb_s}")

    def hash_payload(self, manifest_version: int | None = None) -> dict:
        """The source's contribution to ``content_hash``.

        ``throttle_mb_s`` is always excluded (the NFS model only sleeps);
        ``path``/``layout`` are excluded too — *where* a cube sits and how
        its chunks are laid out do not change the observations read, so a
        cube moved to another mount keeps its hash. For ``kind='file'`` the
        geometry knobs are advisory (the manifest is authoritative) and the
        payload is the manifest's content sha256 instead: the hash tracks
        the actual bytes, so re-exporting different data to the same path
        is a different computation. Reads the manifest — a file spec whose
        cube does not exist (yet) cannot be hashed, by design.

        ``manifest_version`` pins an archived manifest version of an
        append-able cube (default: the current one) — the streaming layer
        hashes the same spec at two versions to re-key unchanged slices
        across an append (``ResultCache.adopt``)."""
        if self.kind == "file":
            from repro_torch.data.file_source import manifest_sha

            return {"kind": "file",
                    "manifest_sha256": manifest_sha(self.path,
                                                    version=manifest_version)}
        d = dataclasses.asdict(self)
        for name in HASH_EXCLUDED_FIELDS["source"]:
            d.pop(name)
        return d


@dataclass(frozen=True)
class TreeSpec:
    """§5.3.1 decision-tree training config (used by the ml/sampling
    methods). ``train_slices=None`` auto-selects the first
    ``min(4, num_slices)`` slices — four consecutive slices cover all four
    distribution types in the synthetic cube."""

    depth: int = field(default=4, metadata=_meta(
        "decision tree depth", hashed=True, type_=int, flag="--tree-depth"))
    max_bins: int = field(default=32, metadata=_meta(
        "candidate split thresholds per feature", hashed=True, type_=int,
        flag="--tree-max-bins"))
    train_slices: tuple[int, ...] | None = field(default=None, metadata=_meta(
        "slices of 'previously generated output data' (default: first 4)", hashed=True,
        type_=int, nargs="+", flag="--tree-train-slices"))
    train_window_lines: int = field(default=4, metadata=_meta(
        "window size for the training baseline runs", hashed=True, type_=int,
        flag="--tree-train-window-lines"))

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"tree.depth must be >= 1, got {self.depth}")
        if self.max_bins < 2:
            raise ValueError(f"tree.max_bins must be >= 2, got {self.max_bins}")
        if self.train_window_lines < 1:
            raise ValueError(
                f"tree.train_window_lines must be >= 1, got {self.train_window_lines}")
        if self.train_slices is not None:
            ts = tuple(self.train_slices)
            object.__setattr__(self, "train_slices", ts)
            if not ts or any((not isinstance(s, int)) or s < 0 for s in ts):
                raise ValueError(
                    f"tree.train_slices must be non-empty non-negative ints, got {ts}")


@dataclass(frozen=True)
class MethodSpec:
    """Which of the paper's methods runs, with its knobs — including
    sampling (§5.4, Algorithm 5), which is a first-class registry entry
    here rather than benchmark-side glue."""

    name: str = field(default="baseline", metadata=_meta(
        "paper method (§5/§6)", hashed=True, type_=str, choices=list(METHODS),
        flag="--method"))
    group_tol: float = field(default=grp.DEFAULT_TOL, metadata=_meta(
        "grouping tolerance (§5.2 'acceptable fluctuation')", hashed=True, type_=float))
    rep_bucket: int = field(default=64, metadata=_meta(
        "geometric padding bucket for representative batches "
        "(64 suits reduced workloads, 256 at paper scale)", hashed=True, type_=int))
    error_bound: float | None = field(default=None, metadata=_meta(
        "the paper's bounded-error constraint on Eq.-6 E", hashed=True, type_=float))
    sample_frac: float = field(default=0.1, metadata=_meta(
        "sampling rate for method=sampling", hashed=True, type_=float))
    sampler: str = field(default="random", metadata=_meta(
        "point sampler for method=sampling", hashed=True, type_=str,
        choices=list(SAMPLERS)))
    kmeans_iters: int = field(default=10, metadata=_meta(
        "Lloyd iterations for sampler=kmeans", hashed=True, type_=int))
    sample_seed: int = field(default=0, metadata=_meta(
        "base seed for the per-window sample draw", hashed=True, type_=int))
    tree: TreeSpec = field(default=TreeSpec(), metadata=_meta(
        "decision-tree training config", hashed=True))

    def __post_init__(self):
        if self.name not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.name!r}")
        if not self.group_tol > 0:
            raise ValueError(f"method.group_tol must be > 0, got {self.group_tol}")
        if self.rep_bucket < 1:
            raise ValueError(f"method.rep_bucket must be >= 1, got {self.rep_bucket}")
        if self.error_bound is not None and not self.error_bound > 0:
            raise ValueError(
                f"method.error_bound must be > 0 (or null), got {self.error_bound}")
        if not 0 < self.sample_frac <= 1:
            raise ValueError(
                f"method.sample_frac must be in (0, 1], got {self.sample_frac}")
        if self.sampler not in SAMPLERS:
            raise ValueError(
                f"method.sampler must be one of {SAMPLERS}, got {self.sampler!r}")
        if self.kmeans_iters < 1:
            raise ValueError(
                f"method.kmeans_iters must be >= 1, got {self.kmeans_iters}")


@dataclass(frozen=True)
class ComputeSpec:
    """The per-window device computation: candidate set, binning, windowing,
    and which backend implements fit / Select."""

    types: tuple[str, ...] = field(default=dists.TYPES_4, metadata=_meta(
        "candidate distribution set: '4', '10', or explicit names", hashed=True,
        type_=str, nargs="+", convert=_types_convert))
    num_bins: int = field(default=64, metadata=_meta(
        "histogram bins L for the Eq.-5 error", hashed=True, type_=int))
    window_lines: int = field(default=6, metadata=_meta(
        "lines per window (§4.2; grouping dedup scope)", hashed=True, type_=int))
    mode: str = field(default="fused", metadata=_meta(
        "shared-histogram fit vs paper-faithful per-type passes", hashed=True,
        type_=str, choices=list(MODES)))
    fit_backend: str = field(default="fused", metadata=_meta(
        "device-work implementation (DESIGN.md §2.1)", hashed=True, type_=str,
        choices=list(fitting.FIT_BACKENDS)))
    select_backend: str = field(default="host", metadata=_meta(
        "where Select's dedup runs (DESIGN.md §6)", hashed=True, type_=str,
        choices=list(SELECT_BACKENDS)))

    def __post_init__(self):
        object.__setattr__(self, "types", tuple(self.types))
        if not self.types:
            raise ValueError("compute.types must not be empty")
        for t in self.types:
            if t not in dists.TYPES_10:
                raise ValueError(
                    f"unknown distribution type {t!r} (candidates: {dists.TYPES_10})")
        if self.num_bins < 2:
            raise ValueError(f"compute.num_bins must be >= 2, got {self.num_bins}")
        if self.window_lines < 1:
            raise ValueError(
                f"compute.window_lines must be >= 1, got {self.window_lines}")
        if self.mode not in MODES:
            raise ValueError(f"compute.mode must be one of {MODES}, got {self.mode!r}")
        if self.fit_backend not in fitting.FIT_BACKENDS:
            raise ValueError(
                f"compute.fit_backend must be one of {fitting.FIT_BACKENDS}, "
                f"got {self.fit_backend!r}")
        if self.select_backend not in SELECT_BACKENDS:
            raise ValueError(
                f"compute.select_backend must be one of {SELECT_BACKENDS}, "
                f"got {self.select_backend!r}")


@dataclass(frozen=True)
class PlacementSpec:
    """Multi-process placement (DESIGN.md §17): how many worker processes
    form the cluster, where the ``torch.distributed`` rendezvous lives,
    which process this is, and (optionally) which local CUDA device each
    shard's executor stages onto. Staging-only like the rest of
    ``ExecSpec`` — slices are whole-slice partitions computed independently
    per process (the paper's per-node assignment), so any placement produces
    bitwise-identical results to the single-process run.

    The port's cluster layer is ``runtime.cluster`` (``launch/cluster.sh``
    spawns the workers; ``run_pdf`` seats each one). The fields keep the
    reference's names and meaning, so a spec file reads in either
    package."""

    num_processes: int = field(default=1, metadata=_meta(
        "worker processes in the cluster run (1 = single-process)", hashed=False,
        type_=int))
    process_id: int | None = field(default=None, metadata=_meta(
        "this process's id (0-based; >= num_processes joins as extra "
        "capacity for redeal only)", hashed=False, type_=int))
    coordinator: str = field(default="127.0.0.1:12723", metadata=_meta(
        "host:port of the torch.distributed rendezvous (process 0)", hashed=False,
        type_=str))
    distributed: bool = field(default=True, metadata=_meta(
        "initialize torch.distributed across the processes (off = marker "
        "protocol only, no process group)", hashed=False, type_=bool))
    shard_devices: tuple[int, ...] | None = field(default=None, metadata=_meta(
        "local CUDA device index per shard (round-robin when shorter; "
        "default: the session's device)", hashed=False, type_=int, nargs="+"))
    redeal: bool = field(default=True, metadata=_meta(
        "survivors re-deal a dead process's unfinished slices "
        "(runtime.elastic.plan_redeal over the done/lost markers)", hashed=False,
        type_=bool))
    peer_timeout_s: float = field(default=120.0, metadata=_meta(
        "how long a finished worker waits for peers' done/lost markers "
        "before treating a silent peer as lost", hashed=False, type_=float))

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(
                f"placement.num_processes must be >= 1, got {self.num_processes}")
        if self.process_id is not None and self.process_id < 0:
            raise ValueError(
                f"placement.process_id must be >= 0, got {self.process_id}")
        host, sep, port = self.coordinator.rpartition(":")
        if not (host and sep and port.isdigit()):
            raise ValueError(
                f"placement.coordinator must be 'host:port', "
                f"got {self.coordinator!r}")
        if self.shard_devices is not None:
            sd = tuple(self.shard_devices)
            object.__setattr__(self, "shard_devices", sd)
            if not sd or any((not isinstance(d, int)) or d < 0 for d in sd):
                raise ValueError(
                    f"placement.shard_devices must be non-empty non-negative "
                    f"ints, got {sd}")
        if not self.peer_timeout_s > 0:
            raise ValueError(
                f"placement.peer_timeout_s must be > 0, "
                f"got {self.peer_timeout_s}")


@dataclass(frozen=True)
class ExecSpec:
    """Execution strategy: slice assignment, staging, persistence, resume.
    Excluded from ``content_hash`` — none of these change per-point results
    (the staged-executor bitwise-equivalence contract, DESIGN.md §9)."""

    slices: tuple[int, ...] | None = field(default=None, metadata=_meta(
        "slices to run (default: every slice of the cube)", hashed=False, type_=int,
        nargs="+"))
    shards: int = field(default=1, metadata=_meta(
        "shards of the mesh data axis (per-node slice assignment)", hashed=False, type_=int))
    shard: int | None = field(default=None, metadata=_meta(
        "run only this shard's assignment (per-node mode)", hashed=False, type_=int))
    prefetch: bool = field(default=True, metadata=_meta(
        "overlap window loading with device compute", hashed=False, type_=bool))
    prefetch_depth: int = field(default=2, metadata=_meta(
        "how many windows the load stage may run ahead", hashed=False, type_=int))
    async_persist: bool = field(default=True, metadata=_meta(
        "write .npz watermarks off the critical path", hashed=False, type_=bool))
    out_dir: str | None = field(default=None, metadata=_meta(
        "persist per-window .npz + watermarks here", hashed=False, type_=str, flag="--out-dir"))
    resume: bool = field(default=False, metadata=_meta(
        "skip windows completed under a matching spec hash", hashed=False, type_=bool))
    cache_dir: str | None = field(default=None, metadata=_meta(
        "spec-hash-keyed result cache: serve identical reruns per slice "
        "and store misses (api.ResultCache)", hashed=False, type_=str, flag="--cache-dir"))
    cache_max_bytes: int | None = field(default=None, metadata=_meta(
        "LRU size cap for cache_dir in bytes (oldest-used entries evicted; "
        "default: unbounded)", hashed=False, type_=int, flag="--cache-max-bytes"))
    # Fault tolerance (DESIGN.md §14). Like every other ExecSpec knob,
    # none of these change per-point results: retried/speculated/re-dealt
    # units recompute identical bytes, so they stay hash-excluded.
    max_retries: int = field(default=2, metadata=_meta(
        "transient-failure re-attempts per work unit before quarantine "
        "(exponential backoff + deterministic jitter)", hashed=False, type_=int))
    retry_backoff_s: float = field(default=0.05, metadata=_meta(
        "base backoff between work-unit retries (doubles per attempt)", hashed=False,
        type_=float))
    speculate: bool = field(default=True, metadata=_meta(
        "re-dispatch straggling window loads (first result wins; safe — "
        "launches are bitwise-identical by construction)", hashed=False, type_=bool))
    straggler_grace_s: float = field(default=1.0, metadata=_meta(
        "absolute floor below which a load is never flagged as straggling", hashed=False,
        type_=float))
    degraded_mode: bool = field(default=True, metadata=_meta(
        "complete runs despite unrecoverable units: quarantine them "
        "(type_idx=-1) and emit a failed-unit manifest instead of aborting", hashed=False,
        type_=bool))
    fault_plan: str | None = field(default=None, metadata=_meta(
        "JSON FaultPlan file for deterministic fault injection (chaos "
        "testing; runtime.faults)", hashed=False, type_=str, flag="--fault-plan"))
    # Cluster execution + cold-start elimination (DESIGN.md §17). Both
    # staging-only: placement deals whole slices to independent processes
    # (bitwise by the per-slice independence contract) and the compilation
    # cache only skips re-compiling executables that would be identical.
    compile_cache_dir: str | None = field(default=None, metadata=_meta(
        "persistent kernel build cache root: CUDA libraries built under "
        "<dir>/<spec_hash>, so a re-launched identical spec never "
        "re-compiles (runtime.cluster)", hashed=False, type_=str,
        flag="--compile-cache-dir"))
    placement: PlacementSpec = field(default=PlacementSpec(), metadata=_meta(
        "multi-process placement (see execution.placement)", hashed=False))

    def __post_init__(self):
        if self.cache_max_bytes is not None and self.cache_max_bytes <= 0:
            raise ValueError(
                f"execution.cache_max_bytes must be > 0 (or null), "
                f"got {self.cache_max_bytes}")
        if self.cache_max_bytes is not None and self.cache_dir is None:
            raise ValueError(
                "execution.cache_max_bytes requires execution.cache_dir")
        if self.shards < 1:
            raise ValueError(f"execution.shards must be >= 1, got {self.shards}")
        if self.shard is not None and not 0 <= self.shard < self.shards:
            raise ValueError(
                f"execution.shard {self.shard} outside range 0..{self.shards - 1}")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"execution.prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.slices is not None:
            ts = tuple(self.slices)
            object.__setattr__(self, "slices", ts)
            if not ts or any((not isinstance(s, int)) or s < 0 for s in ts):
                raise ValueError(
                    f"execution.slices must be non-empty non-negative ints, got {ts}")
        if self.resume and self.out_dir is None:
            raise ValueError("execution.resume requires execution.out_dir")
        if self.max_retries < 0:
            raise ValueError(
                f"execution.max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"execution.retry_backoff_s must be >= 0, "
                f"got {self.retry_backoff_s}")
        if self.straggler_grace_s < 0:
            raise ValueError(
                f"execution.straggler_grace_s must be >= 0, "
                f"got {self.straggler_grace_s}")
        if self.placement.num_processes > 1 and self.out_dir is None:
            raise ValueError(
                "execution.placement.num_processes > 1 requires "
                "execution.out_dir: processes share results and the "
                "done/lost marker protocol through it")


@dataclass(frozen=True)
class ServeSpec:
    """The serving layer's knobs (``repro_torch.serve.PDFServer``): request
    coalescing, launch batching, and the in-memory hot-window cache.
    Staging-only — excluded from ``content_hash`` like ``ExecSpec``: served
    answers are bitwise-identical with any of these settings (the
    coalescing-equivalence contract, tests/test_torch_serve.py)."""

    tick_seconds: float = field(default=0.001, metadata=_meta(
        "how long the batcher keeps draining the queue after the first "
        "pending request before launching (the coalescing window)", hashed=False,
        type_=float, flag="--serve-tick-seconds"))
    max_batch_windows: int = field(default=32, metadata=_meta(
        "max deduplicated windows per fused launch (larger batches are "
        "chunked)", hashed=False, type_=int, flag="--serve-max-batch-windows"))
    coalesce: bool = field(default=True, metadata=_meta(
        "batch concurrent requests into shared launches; off = the naive "
        "one-launch-per-query baseline", hashed=False,
        type_=bool, flag="--serve-coalesce"))
    window_cache_entries: int = field(default=256, metadata=_meta(
        "in-memory hot-window LRU entries held by the server (0 disables)", hashed=False,
        type_=int, flag="--serve-window-cache-entries"))
    # Fault tolerance (DESIGN.md §14): deadlines, launch retry, shedding.
    request_deadline_s: float | None = field(default=None, metadata=_meta(
        "fail a request's future with TimeoutError if not answered within "
        "this many seconds of submit (default: no deadline)", hashed=False,
        type_=float, flag="--serve-deadline-s"))
    max_queue_depth: int = field(default=0, metadata=_meta(
        "reject submits (ServerOverloadedError) once this many requests "
        "are pending — load shedding with backpressure (0 = unbounded)",
        hashed=False, type_=int, flag="--serve-max-queue-depth"))
    retry_transient: int = field(default=2, metadata=_meta(
        "transient launch-failure re-attempts per batch chunk; exhaustion "
        "fails only the affected windows' futures, not the server", hashed=False,
        type_=int, flag="--serve-retries"))

    def __post_init__(self):
        if not self.tick_seconds >= 0:
            raise ValueError(
                f"serve.tick_seconds must be >= 0, got {self.tick_seconds}")
        if self.max_batch_windows < 1:
            raise ValueError(
                f"serve.max_batch_windows must be >= 1, "
                f"got {self.max_batch_windows}")
        if self.window_cache_entries < 0:
            raise ValueError(
                f"serve.window_cache_entries must be >= 0, "
                f"got {self.window_cache_entries}")
        if self.request_deadline_s is not None and not self.request_deadline_s > 0:
            raise ValueError(
                f"serve.request_deadline_s must be > 0 (or null), "
                f"got {self.request_deadline_s}")
        if self.max_queue_depth < 0:
            raise ValueError(
                f"serve.max_queue_depth must be >= 0, "
                f"got {self.max_queue_depth}")
        if self.retry_transient < 0:
            raise ValueError(
                f"serve.retry_transient must be >= 0, "
                f"got {self.retry_transient}")


UPDATE_MODES = ("merge", "strict")


@dataclass(frozen=True)
class StreamSpec:
    """Streaming ingestion: how a run reacts to cube appends
    (``repro_torch.streaming``). Staging-only — excluded from
    ``content_hash`` like ``ExecSpec``.
    That exclusion is sound because the cache never holds merge-path
    results: cached entries are always fresh full computes (or dep-verified
    adoptions of one), bitwise-reproducible by the hash rule, while
    ``update_mode='merge'`` updates live only in the persisted windows,
    whose watermarks record the merge tolerance (``MERGE_ULP_BUDGET``)."""

    update_mode: str = field(default="merge", metadata=_meta(
        "how appends update already-fitted windows: 'merge' re-fits from "
        "merged sufficient statistics (histograms bitwise, moments within "
        "the recorded ulp budget), 'strict' recomputes affected windows "
        "in full for a bitwise guarantee", hashed=False, type_=str,
        choices=list(UPDATE_MODES), flag="--stream-update-mode"))
    persist_stats: bool = field(default=False, metadata=_meta(
        "write per-window sufficient-statistic sidecars next to persisted "
        ".npz windows (required for merge-mode updates of old windows)",
        hashed=False, type_=bool, flag="--stream-persist-stats"))
    incremental: bool = field(default=True, metadata=_meta(
        "adopt cached slices whose chunk fingerprints are unchanged across "
        "an append, recomputing only touched slices", hashed=False,
        type_=bool, flag="--stream-incremental"))
    poll_interval_s: float = field(default=1.0, metadata=_meta(
        "manifest-version polling interval for run_pdf --watch", hashed=False,
        type_=float, flag="--stream-poll-interval-s"))
    max_updates: int | None = field(default=None, metadata=_meta(
        "stop --watch after applying this many appends (default: run until "
        "interrupted)", hashed=False, type_=int, flag="--stream-max-updates"))

    def __post_init__(self):
        if self.update_mode not in UPDATE_MODES:
            raise ValueError(
                f"stream.update_mode must be one of {UPDATE_MODES}, "
                f"got {self.update_mode!r}")
        if not self.poll_interval_s > 0:
            raise ValueError(
                f"stream.poll_interval_s must be > 0, "
                f"got {self.poll_interval_s}")
        if self.max_updates is not None and self.max_updates < 1:
            raise ValueError(
                f"stream.max_updates must be >= 1 (or null), "
                f"got {self.max_updates}")


_GROUPS: tuple[tuple[str, type, str], ...] = (
    # (dotted path into PipelineSpec, dataclass, auto flag prefix)
    ("source", SourceSpec, ""),
    ("method", MethodSpec, ""),
    ("method.tree", TreeSpec, "tree-"),
    ("compute", ComputeSpec, ""),
    ("execution", ExecSpec, ""),
    ("execution.placement", PlacementSpec, ""),
    ("serve", ServeSpec, ""),
    ("stream", StreamSpec, ""),
)


@dataclass(frozen=True)
class PipelineSpec:
    """The one public entry point: everything a run needs, declared once.

    Construct directly, from JSON (``from_json``), or from CLI flags
    (``api.cli.spec_from_args``); execute with ``api.PDFSession``.
    """

    version: int = SPEC_VERSION
    source: SourceSpec = SourceSpec()
    method: MethodSpec = MethodSpec()
    compute: ComputeSpec = ComputeSpec()
    execution: ExecSpec = ExecSpec()
    serve: ServeSpec = ServeSpec()
    stream: StreamSpec = StreamSpec()

    def __post_init__(self):
        if self.version != SPEC_VERSION:
            raise ValueError(
                f"spec version {self.version} unsupported (this build speaks "
                f"version {SPEC_VERSION}; re-emit the spec with to_json)")
        if self.execution.slices is not None and self.source.kind == "simulation":
            bad = [s for s in self.execution.slices if s >= self.source.num_slices]
            if bad:
                raise ValueError(
                    f"execution.slices {bad} outside the cube's "
                    f"{self.source.num_slices} slices")

    # -- serialization ---------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineSpec":
        if not isinstance(d, dict):
            raise ValueError(f"spec must be a JSON object, got {type(d).__name__}")
        d = dict(d)
        parts = {}
        for name, sub_cls in (("source", SourceSpec), ("method", MethodSpec),
                              ("compute", ComputeSpec), ("execution", ExecSpec),
                              ("serve", ServeSpec), ("stream", StreamSpec)):
            if name in d:
                parts[name] = _sub_from_dict(sub_cls, d.pop(name), name)
        version = d.pop("version", SPEC_VERSION)
        if version in (2, 3):
            # Forward-compat shim: versions 3 and 4 only ADDED staging-only
            # surface (v3: the ``stream`` section; v4: ``execution.placement``
            # + ``execution.compile_cache_dir``), so an older spec is a valid
            # version-4 spec with the new knobs defaulted. Note the upgrade
            # DOES change the spec's content_hash (the version feeds the hash
            # payload) — persisted watermarks from the old build won't resume
            # against it, which is exactly the resume-mismatch detection
            # working.
            warnings.warn(
                f"upgrading spec from version {version} to {SPEC_VERSION}: "
                "the sections/fields added since take their defaults",
                stacklevel=2)
            version = SPEC_VERSION
        if d:
            raise ValueError(f"unknown spec keys: {sorted(d)}")
        return cls(version=version, **parts)

    @classmethod
    def from_json(cls, text: str) -> "PipelineSpec":
        return cls.from_dict(json.loads(text))

    # -- provenance ------------------------------------------------------------

    def content_hash(self, manifest_version: int | None = None) -> str:
        """Stable hash of the result-defining subtree (version + source +
        method + compute) and ``HASH_IMPL``, so it never equals the JAX
        reference's hash of the same spec. Two specs with equal hashes must produce bitwise
        identical per-point results; ``execution``, ``serve`` and ``stream``
        are staging-only and excluded, and so is ``source.throttle_mb_s`` — the
        NFS-bandwidth model only *sleeps* (data is unchanged), so a throttled
        benchmark run and its unthrottled resume are the same computation.
        ``kind='file'`` sources hash by their manifest's content sha256
        (``SourceSpec.hash_payload``), so the hash pins the exact bytes the
        run reads — the key the ``ResultCache`` relies on (DESIGN.md §12).
        ``manifest_version`` hashes a file source at an archived manifest
        version (streaming adoption; see ``SourceSpec.hash_payload``)."""
        payload: dict[str, Any] = {"version": self.version, "impl": HASH_IMPL}
        for name in HASHED_SECTIONS:
            sub = getattr(self, name)
            payload[name] = (sub.hash_payload(manifest_version)
                             if hasattr(sub, "hash_payload")
                             else dataclasses.asdict(sub))
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- bridges to the internal configs --------------------------------------

    def pdf_config(self) -> PDFConfig:
        return PDFConfig(
            types=tuple(self.compute.types),
            num_bins=self.compute.num_bins,
            window_lines=self.compute.window_lines,
            method=self.method.name,
            mode=self.compute.mode,
            group_tol=self.method.group_tol,
            rep_bucket=self.method.rep_bucket,
            error_bound=self.method.error_bound,
            fit_backend=self.compute.fit_backend,
            select_backend=self.compute.select_backend,
            sample_frac=self.method.sample_frac,
            sampler=self.method.sampler,
            kmeans_iters=self.method.kmeans_iters,
            sample_seed=self.method.sample_seed,
        )

    def exec_config(self) -> ExecutorConfig:
        return ExecutorConfig(
            prefetch=self.execution.prefetch,
            prefetch_depth=self.execution.prefetch_depth,
            async_persist=self.execution.async_persist,
            max_retries=self.execution.max_retries,
            retry_backoff_s=self.execution.retry_backoff_s,
            speculate=self.execution.speculate,
            straggler_grace_s=self.execution.straggler_grace_s,
            degraded_mode=self.execution.degraded_mode,
        )


def _sub_from_dict(cls, d: dict, path: str):
    if not isinstance(d, dict):
        raise ValueError(f"spec.{path} must be a JSON object, got {type(d).__name__}")
    d = dict(d)
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d.pop(f.name)
        if f.name == "tree":
            v = _sub_from_dict(TreeSpec, v, f"{path}.tree")
        elif f.name == "placement":
            v = _sub_from_dict(PlacementSpec, v, f"{path}.placement")
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    if d:
        raise ValueError(f"unknown spec.{path} keys: {sorted(d)}")
    return cls(**kwargs)


# -- spec construction from legacy configs / live sources ----------------------


def spec_from_config(
    config: PDFConfig,
    exec_config: ExecutorConfig | None = None,
    source: SourceSpec | None = None,
) -> PipelineSpec:
    """Lift a legacy ``PDFConfig`` (+``ExecutorConfig``) into a spec — the
    ``PDFComputer`` shim uses this so even legacy construction stamps the
    same provenance hash the session would."""
    ec = exec_config or ExecutorConfig()
    return PipelineSpec(
        source=source or SourceSpec(kind="external"),
        method=MethodSpec(
            name=config.method,
            group_tol=config.group_tol,
            rep_bucket=config.rep_bucket,
            error_bound=config.error_bound,
            sample_frac=config.sample_frac,
            sampler=config.sampler,
            kmeans_iters=config.kmeans_iters,
            sample_seed=config.sample_seed,
        ),
        compute=ComputeSpec(
            types=tuple(config.types),
            num_bins=config.num_bins,
            window_lines=config.window_lines,
            mode=config.mode,
            fit_backend=config.fit_backend,
            select_backend=config.select_backend,
        ),
        execution=ExecSpec(
            prefetch=ec.prefetch,
            prefetch_depth=ec.prefetch_depth,
            async_persist=ec.async_persist,
            max_retries=ec.max_retries,
            retry_backoff_s=ec.retry_backoff_s,
            speculate=ec.speculate,
            straggler_grace_s=ec.straggler_grace_s,
            degraded_mode=ec.degraded_mode,
        ),
    )


def source_spec_for(data_source) -> SourceSpec:
    """Describe a live window source as a ``SourceSpec``: the synthetic
    simulation and the file cube reader (optionally behind a
    ``ThrottledSource``) round-trip exactly; anything else is marked
    ``kind='external'``."""
    from repro_torch.data.file_source import FileCubeSource
    from repro_torch.data.loader import ThrottledSource
    from repro_torch.data.simulation import SeismicSimulation

    throttle = None
    if isinstance(data_source, ThrottledSource):
        throttle = data_source.bandwidth / 1e6
        data_source = data_source.inner
    if isinstance(data_source, FileCubeSource):
        g = data_source.geometry
        # advisory geometry from the manifest, like export_cube's returned
        # spec — the hash is manifest-based either way, but the serialized
        # spec should read true
        return SourceSpec(kind="file", path=str(data_source.path),
                          throttle_mb_s=throttle,
                          num_slices=g.num_slices,
                          lines_per_slice=g.lines_per_slice,
                          points_per_line=g.points_per_line,
                          observations=data_source.num_observations)
    if isinstance(data_source, SeismicSimulation):
        cfg = data_source.config
        g = cfg.geometry
        return SourceSpec(
            kind="simulation",
            num_slices=g.num_slices,
            lines_per_slice=g.lines_per_slice,
            points_per_line=g.points_per_line,
            observations=cfg.num_simulations,
            num_layers=cfg.num_layers,
            base_vp=cfg.base_vp,
            quantize_decimals=cfg.quantize_decimals,
            group_block=cfg.group_block,
            line_block=cfg.line_block,
            seed=cfg.seed,
            throttle_mb_s=throttle,
        )
    return SourceSpec(kind="external", throttle_mb_s=throttle)


def build_source(spec: SourceSpec):
    """Materialize the window source a ``SourceSpec`` describes."""
    from repro_torch.core.regions import CubeGeometry
    from repro_torch.data.file_source import FileCubeSource
    from repro_torch.data.loader import ThrottledSource
    from repro_torch.data.simulation import SeismicSimulation, SimulationConfig

    if spec.kind == "file":
        src = FileCubeSource(spec.path)
        if spec.throttle_mb_s is not None:
            return ThrottledSource(src, spec.throttle_mb_s * 1e6)
        return src
    if spec.kind != "simulation":
        raise ValueError(
            "source.kind='external' cannot be materialized from the spec — "
            "pass the live object (PDFSession(spec, data_source=...)), or "
            "snapshot it to disk once with data.file_source.export_cube(...) "
            "and run it as a materializable kind='file' source")
    sim = SeismicSimulation(SimulationConfig(
        geometry=CubeGeometry(spec.num_slices, spec.lines_per_slice,
                              spec.points_per_line),
        num_simulations=spec.observations,
        num_layers=spec.num_layers,
        base_vp=spec.base_vp,
        quantize_decimals=spec.quantize_decimals,
        group_block=spec.group_block,
        line_block=spec.line_block,
        seed=spec.seed,
    ))
    if spec.throttle_mb_s is not None:
        return ThrottledSource(sim, spec.throttle_mb_s * 1e6)
    return sim
