"""The repository's invariant lint (``repro.analysis``: determinism, error
handling, locks, shapes, hashes) over the port: no finding, no baseline."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_port_has_no_analysis_findings():
    out = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--root", str(ROOT / "src" / "repro_torch"),
         "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["new"] == [] and report["baselined"] == [], report
