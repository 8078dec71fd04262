#!/usr/bin/env bash
# Multi-process cluster launcher of the PyTorch port (DESIGN.md §17): spawn
# NPROCS repro_torch.launch.run_pdf workers on this host, each pinned to one
# seat of the placement (--num-processes/--process-id), joined into one
# torch.distributed world (gloo) at one coordinator and sharing one
# --out-dir. Usage:
#
#   src/repro_torch/launch/cluster.sh NPROCS [run_pdf flags...]
#
# Every flag after NPROCS is passed through to every worker — give them a
# shared --out-dir (required in cluster mode) and optionally a shared
# --compile-cache-dir so only the first launch ever builds the CUDA
# kernels. Workers run on the default CUDA device (pass --device cpu for
# the plain versions); several workers share one card. Environment:
#
#   COORD_PORT   coordinator port (default 12723)
#   CLUSTER_REF  a reference out_dir: after the run, verify this run's
#                --out-dir is bitwise-identical to it and print the
#                invariant line
#   PYTHON       the interpreter (default python3)
set -euo pipefail

if [ "$#" -lt 1 ]; then
    echo "usage: src/repro_torch/launch/cluster.sh NPROCS [run_pdf flags...]" >&2
    exit 2
fi
NPROCS="$1"; shift
PY="${PYTHON:-python3}"

SRC_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$SRC_ROOT${PYTHONPATH:+:$PYTHONPATH}"

COORD="127.0.0.1:${COORD_PORT:-12723}"

# The shared out_dir is also where the marker protocol lives — find it in
# the pass-through flags so the optional CLUSTER_REF verification knows
# what to compare.
OUT_DIR=""
prev=""
for arg in "$@"; do
    if [ "$prev" = "--out-dir" ]; then OUT_DIR="$arg"; fi
    prev="$arg"
done

echo "[cluster.sh] launching $NPROCS worker(s), coordinator $COORD"
pids=()
for i in $(seq 0 $((NPROCS - 1))); do
    # a subshell per worker, so its exit code (not sed's) is what we wait on
    ( "$PY" -m repro_torch.launch.run_pdf \
        --num-processes "$NPROCS" --process-id "$i" --coordinator "$COORD" \
        "$@" 2>&1 | sed -u "s/^/[proc $i] /"; exit "${PIPESTATUS[0]}" ) &
    pids+=($!)
done
status=0
for pid in "${pids[@]}"; do
    wait "$pid" || status=$?
done
if [ "$status" -ne 0 ]; then
    echo "[cluster.sh] a worker failed (exit $status)" >&2
    exit "$status"
fi

if [ -n "${CLUSTER_REF:-}" ]; then
    if [ -z "$OUT_DIR" ]; then
        echo "[cluster.sh] CLUSTER_REF set but no --out-dir flag found" >&2
        exit 2
    fi
    "$PY" -m repro_torch.runtime.cluster --compare "$CLUSTER_REF" "$OUT_DIR"
fi
echo "[cluster.sh] done"
