"""Build the CUDA sources under ``repro_torch/csrc`` with ``nvcc``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
root of the checkout, a shared library with a plain C interface that
``ctypes`` loads (no PyTorch headers, so a build takes seconds). The hash
covers the source, every header in ``csrc/`` and the flags, so an edited
source is rebuilt and an unchanged one is reused.

The flags are fixed: ``sm_90a`` (Hopper), ``-O3``, never fast math, and
``-fmad=false`` so the kernels' float arithmetic rounds operation by
operation as their plain PyTorch versions do (no fused multiply-adds).

Nothing is compiled when this module is imported: ``library(name)`` builds
on first use, and ``build(*names)`` builds several sources at once, one
``nvcc`` process each, all started together. ``counters()`` reports, for
the process, the ``nvcc`` builds started and the libraries loaded from
``build/kernels/`` without a build (``api.SessionReport``'s compile
counts).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_counts = {"builds": 0, "cached_loads": 0}


def counters() -> dict[str, int]:
    """Process-wide ``{"builds": nvcc builds started, "cached_loads":
    libraries loaded that needed no build}``, a snapshot."""
    with _lock:
        return dict(_counts)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")  # repro: allow[DET]: locates nvcc, defines no result
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of repro_torch "
            "are compiled on first use and need the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` process per source, all running at once; raises after all have
    ended if any failed."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs, failed = [], []
        try:
            for name in dict.fromkeys(names):
                out = _target(name)
                if out.exists():
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                _counts["builds"] += 1
                jobs.append((name, out, tmp, proc))
        finally:  # every started nvcc is waited for, even if a later start failed
            for name, out, tmp, proc in jobs:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
                else:
                    os.replace(tmp, out)  # atomic: a reader never sees a half-written library
        if failed:
            raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if target.exists():
                _counts["cached_loads"] += 1
            else:
                build(name)
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib
