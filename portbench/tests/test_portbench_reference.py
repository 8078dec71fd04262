"""The reference against the port at tiny widths on the CPU, both in
float32 so that only the order of operations differs: the prefill's
logits; the training steps' losses, first gradient and the parameters'
change, by leaf."""

import pytest
import torch

from portbench import check, run, system
from portbench import traffic as TR
from portbench import weights as W
from portbench.reference.model import Reference
from portbench.tests.helpers import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-prefill-4k"])
def test_prefill_logits(cell):
    c = tiny(cell, compute_dtype="float32")
    prog = system.Prefill(c.config, c.traffic, SEED, CPU)
    prompt = TR.prompt(c.traffic, c.config, SEED, 0, CPU)
    got = prog(prompt)
    ref = Reference(c.config, W.draw_all(c.config, SEED, CPU)).last_logits(prompt)
    assert got.shape == ref.shape == (2, c.config["vocab"])
    assert check.logit_err(got, ref) < 2e-5


@pytest.mark.parametrize("cell", ["hymba-train-4k", "mamba2-train-4k"])
def test_training_steps(cell):
    c = tiny(cell, compute_dtype="float32")
    prog = system.Train(c.config, c.traffic, SEED, CPU)
    mine = run.checked_steps(prog, c, SEED, CPU)
    ref = check.ref_train(c.config, c.traffic, SEED, CPU)
    nums = check.train_numbers(mine, ref)
    assert nums["loss_err"] < 1e-6
    assert nums["grad_err"] < 1e-4
    assert nums["change_err"] < 1e-3
    assert set(mine["change_norms"]) == set(prog.params())


def test_windowed_attention_is_banded():
    """The reference's window: a key further back than the window leaves
    the output unchanged."""
    c = tiny("hymba-prefill-4k", compute_dtype="float32")
    params = W.draw_all(c.config, SEED, CPU)
    ref = Reference(c.config, params)
    x = torch.randn(1, 40, c.config["d_model"])
    y = ref.attention(x, "layers.1.", 16)
    x2 = x.clone()
    x2[:, 0] += 1.0
    y2 = ref.attention(x2, "layers.1.", 16)
    assert torch.equal(y[:, 16:], y2[:, 16:]) and not torch.equal(y[:, :16], y2[:, :16])


def test_ssd_scan_is_the_recurrence():
    """The chunked scan equals the token-by-token recurrence, with a
    sequence that is not a multiple of the chunk."""
    c = tiny("mamba2-prefill-4k")
    ref = Reference(dict(c.config, ssm_chunk=8), {})
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 21, 3, 4, 5
    x, bm, cm = (torch.randn(b, s, h, k, generator=g) for k in (p, n, n))
    a = -torch.rand(b, s, h, generator=g)
    y = ref.scan(x, a, bm, cm)
    state = torch.zeros(b, h, n, p)
    for t in range(s):
        state = torch.exp(a[:, t])[..., None, None] * state + bm[:, t, :, :, None] * x[:, t, :, None, :]
        assert torch.allclose(y[:, t], torch.einsum("bhn,bhnp->bhp", cm[:, t], state), atol=1e-5)
