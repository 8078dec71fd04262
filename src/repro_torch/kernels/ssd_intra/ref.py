"""The SSD's intra-chunk product in plain PyTorch: the path of every call
the kernel does not take (CPU, float32, meta tensors, autograd), and the
version the kernel is held to.

These are the reference's operations (``repro/models/ssm.py``): C.B per
group repeated over the group's heads, the masked decay matrix in float32,
rounded to the compute type, then its product with dt x.
"""

from __future__ import annotations

import torch


def intra_matrix(cb: torch.Tensor, ca: torch.Tensor) -> torch.Tensor:
    """The intra-chunk matrix M[i, j] = (C_i . B_j) exp(ca_i - ca_j) for
    j <= i, else 0, in float32. cb (B, Nc, H, Q, Q), ca (B, Nc, Q, H).

    Above the diagonal the exponent is positive and overflows to inf once
    a chunk's decay passes ~88; the ``where`` drops those entries. Under
    autograd the exponent is also masked to -inf there before the exp,
    which gives 0 with a zero gradient: the reference masks only after the
    exp, so its backward multiplies that inf by the ``where``'s zero
    cotangent and its gradients turn NaN (ROADMAP queue 3). The forward is
    the same bits either way; serving skips the extra pass over the
    (B, Nc, H, Q, Q) exponents (~5 % of an SSM prefill)."""
    q = ca.shape[2]
    causal = torch.ones((q, q), dtype=torch.bool, device=ca.device).tril()
    decay = (ca[..., :, None, :] - ca[..., None, :, :]).movedim(-1, 2)  # (B,Nc,H,Q,Q) i, j
    if decay.requires_grad:
        decay.masked_fill_(~causal, float("-inf"))  # the subtraction's backward saves nothing
    return torch.where(causal, cb.float() * torch.exp(decay),
                       torch.zeros((), dtype=torch.float32, device=ca.device))


def ssd_intra_ref(cb: torch.Tensor, ca: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """cb (B, Nc, G, Q, Q) C.B per group, ca (B, Nc, Q, H) float32, xdt
    (B, Nc, Q, H, P) -> y_intra (B, Nc, Q, H, P) in xdt's type: the decay
    matrix of each head (group h // (H / G)) rounded to xdt's type, times
    xdt."""
    hpg = xdt.shape[3] // cb.shape[2]
    m = intra_matrix(cb.repeat_interleave(hpg, dim=2), ca).to(xdt.dtype)  # (B, Nc, H, Q, Q)
    return torch.einsum("bchqk,bckhp->bcqhp", m, xdt)
