"""The port's PDF examples (``examples/*_torch.py``, the counterparts of
``quickstart.py``, ``pdf_full_slice.py`` and ``uq_ensemble.py``) run on
``--device cpu`` at a small size."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    (res,) = load("quickstart_torch").main(["--device", "cpu"])
    assert res.slice_i == 6 and len(res.type_idx) == 12 * 40
    assert np.isfinite(res.avg_error) and res.error_bound_satisfied
    assert "device cpu" in capsys.readouterr().out


def test_pdf_full_slice():
    errors, resumed = load("pdf_full_slice_torch").main(
        ["--device", "cpu", "--obs", "100", "--lines", "12", "--ppl", "30"])
    assert list(errors) == ["baseline", "grouping", "reuse", "ml", "grouping_ml"]
    assert all(np.isfinite(e) for e in errors.values())
    assert resumed.avg_error == errors["grouping_ml"]


def test_uq_ensemble():
    pct = load("uq_ensemble_torch").main(["--device", "cpu"])
    assert pct.shape == (4,) and pct[0] > 0.5 and abs(pct.sum() - 1.0) < 1e-9
