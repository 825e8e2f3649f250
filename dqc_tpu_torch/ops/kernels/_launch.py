"""Argument checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from dqc_tpu_torch.ops.kernels import _build

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong


def entry(lib_name: str, fn_name: str, argtypes):
    """``lib_name``'s C function ``fn_name`` with its signature declared."""
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def raise_on_error(code: int, lib_name: str, what: str) -> None:
    if code != 0:
        err = _build.library(lib_name).dqc_error_string
        err.argtypes = [INT]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({err(code).decode(errors='replace')})")


def check_cuda_f32(what: str, tensors: Sequence[torch.Tensor],
                   device: torch.device, align: int = 4) -> None:
    """Every tensor is contiguous float32 on ``device`` (a CUDA device)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: expected CPU or CUDA tensors, got {device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: expected float32 planes, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{what}: data must be {align}-byte aligned")


def output_planes(what: str, xr: torch.Tensor, xi: torch.Tensor, acc,
                  alias: bool):
    """Where an apply kernel writes: the accumulator planes (``acc``, added
    to), the input planes (``alias``, in place) or fresh planes."""
    if acc is not None:
        out = tuple(a.view(xr.shape) for a in acc)
        check_cuda_f32(what, out, xr.device, align=16)
        return out
    if alias:
        return xr, xi
    return torch.empty_like(xr), torch.empty_like(xi)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def table_ptrs(diag_tables) -> list:
    """The six table pointers (null without a run)."""
    if diag_tables is None:
        return [None] * 6
    return [ptr(t) for t in diag_tables]


def check_tables(what: str, diag_tables, A: int, device: torch.device) -> None:
    """``(tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)``: (128, 128) x 2 and
    (A, 128) x 4 (or any contiguous view of A rows of 128), contiguous f32
    on ``device``."""
    if diag_tables is None:
        return
    if len(diag_tables) != 6:
        raise ValueError(f"{what}: expected 6 diag table planes")
    check_cuda_f32(what, diag_tables, device)
    got = [tuple(t.shape) for t in diag_tables]
    if (got[0] != (128, 128) or got[1] != (128, 128)
            or any(t.numel() != A * 128 or t.shape[-1] != 128
                   for t in diag_tables[2:])):
        raise ValueError(f"{what}: diag tables of shapes {got}, want "
                         f"(128, 128) x 2 and {A} rows of 128 x 4")
