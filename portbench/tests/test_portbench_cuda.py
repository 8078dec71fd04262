"""On the card: a tiny version of every cell through the whole run, and
the card's numbers under their names. Run on the card with
``python3 -m pytest -q portbench/tests -m cuda``; skipped without one."""

import pytest
import torch

from portbench import run
from portbench.tests.helpers import CELLS, tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels and CUDA events)")
    # A training cell's limits (its loss_err) are set for bfloat16 at full size, where rounding
    # averages over far more terms than at these widths: the tiny step computes in float32.
    dtype = {"compute_dtype": "float32"} if "train" in cell else {}
    res = run.execute(tiny(cell, **dtype), 12345, 0.5, True, torch.device("cuda", 0))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
