"""The control, the reference computed with float8 e4m3 products in the
program's place (the precision below the configuration's bfloat16), comes
out not correct against every cell's limits on the CPU, at 8 layers 128
wide (at 2 layers too little rounding piles up to stand for the cells'
depth); so do the faults planted in the reference. On the card
``python3 -m portbench.control`` reads them at the cells' sizes."""

import pytest
import torch

from portbench import check, control
from portbench.tests.helpers import tiny


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-prefill-4k", "hymba-train-4k",
                                  "mamba2-train-4k"])
def test_control_fails_the_limits(cell):
    c = tiny(cell, deep=True)
    readings = control.readings(c, 5, torch.device("cpu"))
    correct, checks = check.judge(readings["control"], c.limits)
    assert not correct, checks
    for fault, numbers in readings.items():
        assert not check.judge(numbers, c.limits)[0], (fault, numbers)


def test_fp8_rounds_and_passes_gradients():
    from portbench.reference.model import fp8

    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = fp8(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
