"""The SSD's intra-chunk product, kernel or plain path.

The kernel (``kernel.ssd_intra_kernel``, K6) has no backward. It takes a
bf16 SSD whose chunk is a multiple of 64 (``kernel_takes``) where nothing
asks for a gradient: its wrapper runs the plain version on a CPU tensor,
charges the dry run's meter on a meta tensor and launches K6 on a CUDA
tensor. Every other call takes the plain path (``ref.ssd_intra_ref``): an
SSD in another compute type or chunk (float32 compute, the registry's
``reduced()`` configs with their chunk of 8), and under autograd every
training forward, remat's recompute and the backward, with
``ref.intra_matrix``'s masked exponent.

K6 under autograd, with the plain version's gradient recomputed in the
backward (as K5's ``BandedAttention``), was built and measured on an H100
80GB: 8-12 % more training tokens a second for mamba2-780m at 4 x 4,096,
but hymba-1.5b's step at 4 x 4,096 (74.8 GB at its peak on the plain path)
ran out of memory in its first backward, with 14.8 GiB cached but free and
no 6.25 GiB block for a global layer's scores (PERF.md).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_intra.kernel import TILE, ssd_intra_kernel
from repro_torch.kernels.ssd_intra.ref import ssd_intra_ref


def kernel_takes(dtype: torch.dtype, chunk: int) -> bool:
    """Whether an SSD of this compute type and chunk length takes the
    kernel's wrapper where no gradient is asked for (on the card: launches
    K6)."""
    return dtype == torch.bfloat16 and chunk % TILE == 0


def ssd_intra(cb: torch.Tensor, ca: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """cb (B, Nc, G, Q, Q) C.B per group, ca (B, Nc, Q, H) float32, xdt
    (B, Nc, Q, H, P) -> y_intra (B, Nc, Q, H, P) in xdt's type."""
    grad = torch.is_grad_enabled() and (cb.requires_grad or ca.requires_grad or xdt.requires_grad)
    if grad or not kernel_takes(xdt.dtype, xdt.shape[2]):
        return ssd_intra_ref(cb, ca, xdt)
    return ssd_intra_kernel(cb.contiguous(), ca.contiguous(), xdt.contiguous())
