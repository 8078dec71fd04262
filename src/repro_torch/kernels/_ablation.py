"""What the ablation tools (``fitpdf/ablation.py``, ``band_attn/ablation.py``)
share: building variants of ``csrc/`` on the card's machine.

A variant is ``csrc/`` with statements replaced, written to
``build/kernels/ablation/<tool>/<variant>/``; an ``--against`` directory
(another version of the sources, with its headers) is copied there as it
is. Each named source of each variant is compiled with the kernels' own
flags, one nvcc a source, all at once.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels import _build


def _write_variant(name: str, edits, out: Path) -> Path:
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text() for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    for fname, old, new in edits:
        if old not in texts[fname]:
            raise RuntimeError(f"variant {name}: statement not found in {fname}: {old!r}")
        texts[fname] = texts[fname].replace(old, new)
    for fname, text in texts.items():
        (d / fname).write_text(text)
    return d


def build_variants(tool: str, variants: dict, sources: tuple[str, ...], against=(),
                   flags: tuple[str, ...] = ()) -> dict[str, tuple[Path, dict[str, str]]]:
    """Write every variant (``{name: [(file, statement, replacement), ...]}``)
    and copy every ``against`` directory (named ``against:DIR``), then
    compile ``<source>.cu`` of each into ``<source>.so`` beside it, with
    ``flags`` added. Returns ``{name: (directory, {source: nvcc output})}``;
    raises if any nvcc failed."""
    out = _build.BUILD_DIR / "ablation" / tool
    dirs = {name: _write_variant(name, edits, out) for name, edits in variants.items()}
    for i, src in enumerate(against):
        d = out / f"against{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        dirs[f"against:{src}"] = d
    procs = {}
    for name, d in dirs.items():
        for src in sources:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(d / f"{src}.so"),
                   str(d / f"{src}.cu")]
            procs[(name, src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    logs, failed = {name: {} for name in dirs}, []
    for (name, src), proc in procs.items():
        logs[name][src] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name} {src}:\n{logs[name][src]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: (d, logs[name]) for name, d in dirs.items()}
