"""What the CUDA kernel wrappers of repro_torch share: binding a library's C
functions with ``ctypes``, the launch stream, the checks of their inputs
and the check of a launch's return code."""

from __future__ import annotations

import ctypes

import torch

VP, I32, SIZE_T = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t

_bound: dict[str, ctypes.CDLL] = {}


def bind(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built on first use) with
    ``argtypes`` and ``restype`` set for each function in ``signatures``
    and for its ``<name>_error_string``."""
    lib = _bound.get(name)
    if lib is None:
        from repro_torch.kernels._build import library

        lib = library(name)
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [I32], ctypes.c_char_p
        _bound[name] = lib
    return lib


def raise_if_failed(lib: ctypes.CDLL, name: str, rc: int, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_index(device: torch.device) -> int:
    return device.index or 0


def check_values(values: torch.Tensor) -> None:
    """A (P, n) float32 window on the CPU or a CUDA device, n >= 1, with
    extents that fit the kernels' int arguments."""
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if values.ndim != 2 or values.shape[1] < 1:
        raise ValueError(f"values must be (P, n) with n >= 1, got {tuple(values.shape)}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"values on unsupported device {values.device}")
    if values.shape[0] >= 2**31 or values.shape[1] >= 2**31:
        raise ValueError(f"values shape {tuple(values.shape)} exceeds int32 extents")


def check_operand(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, values on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_contiguous(values: torch.Tensor) -> None:
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")

