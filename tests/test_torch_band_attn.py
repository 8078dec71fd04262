"""Port vs reference: banded sliding-window attention (K5). On the CPU the
port's ``banded_attention`` takes its plain version; it is held against the
reference's Pallas kernel (interpret mode, as test_band_attn_kernel.py runs
it) and its oracle, on the same inputs made with numpy. The CUDA kernel is
held against the plain version on the card in test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.band_attn import banded_attention as j_banded_attention
from repro.kernels.band_attn import banded_attention_ref as j_banded_attention_ref
from repro_torch.kernels.band_attn import banded_attention, banded_attention_ref
from repro_torch.kernels.band_attn import kernel as tk
from repro_torch.kernels.band_attn.ref import row_errors

# (B, S, H, KV, hd, W): the reference's own CASES (test_band_attn_kernel.py:12-20)
CASES = [
    (2, 64, 4, 2, 16, 16),   # GQA
    (1, 48, 8, 8, 32, 16),   # MHA
    (2, 50, 4, 2, 16, 16),   # ragged tail (S % W != 0)
    (1, 128, 6, 2, 64, 32),  # wider head, G=3
    (1, 16, 2, 1, 8, 16),    # single block (S == W)
    (1, 8, 2, 1, 8, 16),     # S < W
]
# that file's tolerances: f32 2e-5, bf16 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(case, seed):
    b, s, h, kv, hd, _ = case
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((b, s, h, hd))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, s, kv, hd))).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_banded_attention_matches_reference(case, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    w = case[-1]
    arrays = _inputs(case, seed=case[1])
    # both packages round the same float32 arrays to the working type
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk_, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = tk.banded_attention_kernel.launches
    got = banded_attention(tq, tk_, tv, w)
    assert tk.banded_attention_kernel.launches == before  # the CPU path launches nothing
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    want_kernel = np.asarray(j_banded_attention(jq, jk, jv, w, interpret=True), np.float32)
    want_ref = np.asarray(j_banded_attention_ref(jq, jk, jv, w), np.float32)
    np.testing.assert_allclose(got, want_kernel, atol=atol)
    np.testing.assert_allclose(got, want_ref, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_oracle_rounding_matches_reference(case):
    """The plain version with ``round_weights`` (bf16 weights, bf16 weighted
    sum) against the reference's oracle in bf16, at that file's bf16
    tolerance: the oracle's bf16 einsum also rounds the scores."""
    w = case[-1]
    arrays = _inputs(case, seed=case[1])
    got = banded_attention_ref(*(torch.from_numpy(a).bfloat16() for a in arrays), w, round_weights=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_banded_attention_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays), w),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=DTYPES["bf16"][2])


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > c[-1]])
def test_row_gate_accepts_oracle_rejects_window_off_by_one(case):
    """The bf16 kernel's gate (chip_smoke.py K5_TOL, test_torch_kernels_cuda
    BAND_TOL): worst row of ``row_errors`` against the float32 truth within
    twice that of the oracle-rounded plain version. The reference's own bf16
    oracle passes it; the plain version at window W - 1 does not."""
    w = case[-1]
    arrays = _inputs(case, seed=case[1])
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    truth = banded_attention_ref(q.float(), k.float(), v.float(), w)
    assert truth.dtype == torch.float32
    limit = 2.0 * float(row_errors(banded_attention_ref(q, k, v, w, round_weights=True), truth).max())
    oracle = np.asarray(j_banded_attention_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays), w),
                        np.float32)
    assert float(row_errors(torch.from_numpy(oracle), truth).max()) <= limit
    assert float(row_errors(banded_attention_ref(q, k, v, w - 1), truth).max()) > limit


def test_row_errors_is_relative_row_norm():
    truth = torch.tensor([[[3.0, 4.0], [1.0, 0.0]]])
    got = torch.tensor([[[3.0, 4.5], [1.0, 0.0]]])
    np.testing.assert_allclose(row_errors(got, truth).numpy(), [[0.1, 0.0]])


def test_plain_version_is_full_masked_softmax():
    """The plain version against attention written out row by row in
    float64: key j valid for query i iff i - W < j <= i."""
    case = (1, 21, 4, 2, 8, 5)
    q, k, v = _inputs(case, seed=7)
    got = banded_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), case[-1]).numpy()
    b, s, h, kvh, hd, w = case
    want = np.zeros_like(got, dtype=np.float64)
    for hh in range(h):
        kk = hh // (h // kvh)
        for i in range(s):
            js = np.arange(max(0, i - w + 1), i + 1)
            sc = (k[0, js, kk].astype(np.float64) @ q[0, i, hh].astype(np.float64)) * hd**-0.5
            p = np.exp(sc - sc.max())
            want[0, i, hh] = (p / p.sum()) @ v[0, js, kk].astype(np.float64)
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("bad", ["float16", "hd12", "hd264", "heads", "window", "kv_dtype"])
def test_rejects_what_the_kernel_does_not_take(bad):
    """The CPU path holds the kernel's contract too, so a caller finds out
    here what the card would refuse."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 8, 4, 2, 16, 4), seed=1))
    w = 4
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "hd12":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "hd264":
        q, k, v = (torch.zeros(t.shape[:-1] + (264,)) for t in (q, k, v))
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "window":
        w = 0
    elif bad == "kv_dtype":
        k = k.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        banded_attention(q, k, v, w)
