"""K3 ``moments_stats``: the CUDA wrapper beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/moments/kernel.py::
moments_stats``. values (P, n) f32 -> stats (P, 8) f32 [mean, var
(unbiased), skew, kurt, vmin, vmax, 0, 0]. Bound on an H100: bytes. It must
read the window once, P*n*4 B (25.1 MB for a Set1 window of 6,275 x 1,000,
about 7.5 us at 3.35 TB/s); its arithmetic is ~10 float operations per
value. Design: K1's kernel (``csrc/row_moments.cuh``) with the edges
compiled out (``csrc/moments.cu``): a warp a row, every 16-byte load of a
lane's share in flight at once, shifted power sums in float, min and max in
registers, then the lanes' sums in double through a fixed shuffle tree, so
its stats equal K1's bit for bit and repeat bitwise. Which lane adds a
value, and in what order, depends on its index and n alone, so a row's
stats do not depend on where the row lies. The TPU kernel pads P to its
8-row tile; this one masks its own ragged edge, so no row is padded.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version, a CUDA tensor the kernel or an exception, a meta tensor its
output's shape and the dry run's charge (``_launch.on_meta``). It counts its launches in
``moments_stats.launches`` (the CPU path counts nothing).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

NUM_STATS = 8  # mean, var(unbiased), skew, kurt, min, max, (2 pad lanes)
_EPS = 1e-12


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("moments", {
        "moments_stats": ([vp, vp, i32, i32, i32, vp], i32),
        "moments_attributes": ([i32, ctypes.POINTER(ctypes.c_int)], i32),
    })


def moments_stats_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (and of K1's stats): the shifted power
    sums of the reference kernel (one full-row sum per power), then its
    finalize, line by line."""
    p, n = values.shape
    shift = values[:, :1]
    d = values - shift
    d2 = d * d
    d3 = d2 * d
    s1, s2, s3, s4 = d.sum(1), d2.sum(1), d3.sum(1), (d3 * d).sum(1)
    mn, mx = torch.amin(values, dim=1), torch.amax(values, dim=1)

    nf = float(n)
    md = s1 / nf  # mean of shifted values
    e2, e3, e4 = s2 / nf, s3 / nf, s4 / nf
    mdsq = md * md
    m2 = torch.clamp(e2 - mdsq, min=0.0)
    m3 = e3 - 3.0 * md * e2 + 2.0 * (md * mdsq)
    m4 = e4 - 4.0 * md * e3 + 6.0 * md * md * e2 - 3.0 * (mdsq * mdsq)
    mean = shift[:, 0] + md
    var = m2 * nf / max(nf - 1.0, 1.0)
    sig = torch.sqrt(torch.clamp(m2, min=_EPS))
    skew = m3 / (sig * (sig * sig))
    m2c = torch.clamp(m2, min=_EPS)
    kurt = m4 / (m2c * m2c) - 3.0
    zero = torch.zeros_like(mean)
    return torch.stack([mean, var, skew, kurt, mn, mx, zero, zero], dim=1)


def moments_stats(values: torch.Tensor) -> torch.Tensor:
    """values (P, n) f32 -> stats (P, 8) f32."""
    _launch.check_values(values)
    if values.device.type == "cpu":
        return moments_stats_plain(values)
    p, n = values.shape
    stats = torch.empty((p, NUM_STATS), dtype=torch.float32, device=values.device)
    if values.device.type == "meta":
        _launch.on_meta("moments_stats", p, n)
        return stats
    _launch.check_contiguous(values)
    if p:
        lib = _library()
        rc = lib.moments_stats(values.data_ptr(), stats.data_ptr(), p, n,
                               _launch.device_index(values.device), _launch.stream(values.device))
        _launch.raise_if_failed(lib, "moments", rc, "moments_stats")
        moments_stats.launches += 1
    return stats


moments_stats.launches = 0


def moments_attributes(device: int = 0) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills) and static shared memory bytes a block of K3's kernel on CUDA
    device ``device``, from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.moments_attributes(device, out)
    _launch.raise_if_failed(lib, "moments", rc, "moments_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2])
