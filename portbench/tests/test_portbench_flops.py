"""The yardstick's arithmetic against counts worked by hand, and its
copies against the port's ``launch/roofline.py``."""

import pytest

from portbench import flops
from portbench.tests import helpers  # noqa: F401  (the port on the path)

SMALL = {
    "num_layers": 2, "d_model": 4, "vocab": 10, "q_heads": 2, "kv_heads": 1, "head_dim": 2, "d_ff": 3,
    "ssm_state": 2, "ssm_expand": 2, "ssm_head_dim": 4, "ssm_groups": 1, "ssm_conv": 2,
    "prefix": [{"mixer": "attn", "window": None, "ffn": "dense"}],
    "pattern": [{"mixer": "ssm", "window": None, "ffn": "none"}],
}


def test_forward_flops_by_hand():
    # head 2*4*10*3 = 240; attention layer: params 4*(2+2)*2 + 2*2*4 = 48 plus the MLP's
    # 3*4*3 = 36 -> 2*84*3 = 504, the band 4*2*6*1*2 = 96 (6 causal pairs at S 3); SSD layer:
    # in_proj 4*(16+4+2) = 88 and out_proj 8*4 = 32 -> 2*120*3 = 720, the recurrence
    # 5*2*4*2*3 = 240, the conv 2*2*12*3 = 144.
    assert flops.forward_flops(SMALL, 1, 3) == 240 + 504 + 96 + 720 + 240 + 144
    assert flops.train_flops(SMALL, 1, 3) == 3 * 1944


def test_window_counts_the_band():
    assert flops.band_pairs(3, 2) == 5  # 1 + 2 + 2
    assert flops.band_pairs(3, None) == flops.band_pairs(3, 3) == 6
    cfg = dict(SMALL, prefix=[{"mixer": "attn", "window": 2, "ffn": "dense"}])
    assert flops.forward_flops(SMALL, 1, 3) - flops.forward_flops(cfg, 1, 3) == 4 * 2 * (6 - 5) * 2


def test_batch_and_tokens_scale():
    assert flops.forward_flops(SMALL, 2, 3) == 2 * flops.forward_flops(SMALL, 1, 3)


def test_cells_shares_stay_under_the_peak():
    """A prefill of mamba2-780m at 4 x 4,096: 2 x 0.778 B parameters in
    products (the embedding is a lookup) x 16,384 tokens = 2.55e13, plus
    the recurrence and the conv, 2.71e13 FLOPs; 27 ms at the bf16 peak."""
    from portbench import manifest as M

    cfg = M.Cell(M.load(), "mamba2-prefill-4k").config
    f = flops.forward_flops(cfg, 4, 4096)
    assert 2.65e13 < f < 2.75e13


@pytest.mark.parametrize("shape", [(4, 4096, 25, 5, 64, 1024), (4, 4096, 16, 8, 256, 1024),
                                   (2, 700, 4, 2, 16, 16)])
def test_k5_copy_matches_the_port(shape):
    import torch
    from repro_torch.launch import roofline as rl

    mine = flops.k5_work(*shape, itemsize=2)
    port = rl.k5_work(*shape, torch.bfloat16)
    assert tuple(mine) == tuple(port)
    assert flops.bound_ms(*mine) == rl.bound_ms(*port)
    assert (flops.PEAK_FLOPS, flops.HBM_BW) == (rl.PEAK_FLOPS, rl.HBM_BW)


def test_k5_bound_at_hymba():
    cfg = {"q_heads": 25, "kv_heads": 5, "head_dim": 64}
    assert flops.k5_bound_ms(cfg, 4, 4096, 1024) == pytest.approx(0.0950, abs=5e-5)
