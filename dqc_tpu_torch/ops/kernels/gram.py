"""Group Gram of f32 planes in one read: ``(S, C)`` over the view ``(P, X, Q)``.

``S[x, y] = sum_{p,q} xr[p,x,q] xr[p,y,q] + xi[p,x,q] xi[p,y,q]`` and
``C[x, y] = sum_{p,q} xr[p,x,q] xi[p,y,q]``; the complex group Gram is
``G = S + i (C^T - C)`` (ops/planes.gram_axis). Replaces the three TPU
kernels of ``dqc_tpu/ops/pallas/gram.py`` — ``gram_lane`` (:58, view
``(A 128, 128, 1)``), ``gram_sublane`` (:97, view ``(A, 128, 128)``) and
``gram_high`` (:134, view ``(A1, X, M 128)``; also on the merged top
axis of a tiny top group, X = 256 or 512, ops/planes.gram_merged_top) —
with one Hopper kernel, ``csrc/gram.cu`` (bound by operations: S is
symmetric, so 2 X + 1 real multiply-adds per amplitude against 8 bytes; the
kernel does 3 X), which sums per-block partials and adds them in a second,
fixed-order pass. :func:`gram_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st

KERNEL_X = (8, 16, 32, 64, 128)
WIDE_X = (256, 512)   # the merged top axis: 128 x 128 patches of (S, C)
_BLOCKS_PER_SM = 4


_CHUNK = 1024


def pair_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_{p,q} a[p,x,q] b[p,y,q]`` (real or complex, no conjugation) as
    products of chunks of at most 1024 columns, then one sum over the
    chunks: a single f32 product over millions of columns loses ~1e-4
    relative (measured on the CPU at 24 qubits), the chunked form ~1e-6.
    The plain versions of the Gram and of the backward kernels' pair grams
    share it."""
    P, X, Q = a.shape
    if Q == 1:
        kp = math.gcd(P, _CHUNK)
        return torch.einsum("bkx,bky->bxy", a.reshape(P // kp, kp, X),
                            b.reshape(P // kp, kp, X)).sum(0)
    kq = math.gcd(Q, _CHUNK)
    return torch.einsum("pxck,pyck->pcxy", a.reshape(P, X, Q // kq, kq),
                        b.reshape(P, X, Q // kq, kq)).sum((0, 1))


def gram_plain(xr: torch.Tensor, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: three real contractions."""
    return pair_sum(xr, xr) + pair_sum(xi, xi), pair_sum(xr, xi)


_ARGTYPES = [_launch.VOIDP] * 4 + [_launch.LONG, _launch.INT, _launch.LONG,
                                   _launch.INT, _launch.VOIDP]


def gram(xr: torch.Tensor, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, C)``, each float32 (X, X), of planes viewed as ``(P, X, Q)``;
    X in 8..128, or 256 / 512 with Q a multiple of 32."""
    if xr.dim() != 3 or xi.shape != xr.shape:
        raise ValueError(f"gram: planes must be one (P, X, Q) view, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    _st.refuse_reduced("gram", xr, xi)
    if xr.device.type == "cpu":
        return gram_plain(xr, xi)
    P, X, Q = xr.shape
    if X not in KERNEL_X + WIDE_X:
        raise ValueError(f"gram: X={X} is not one of {KERNEL_X + WIDE_X}")
    cols_per_tile = 4096 // min(X, 128)
    if (P * Q) % cols_per_tile or (Q != 1 and Q % cols_per_tile) or (
            X > 128 and Q == 1):
        raise ValueError(f"gram: view {tuple(xr.shape)} does not tile by "
                         f"{cols_per_tile} columns")
    _launch.check_cuda_f32("gram", (xr, xi), xr.device)
    # X > 128: each block forms one of the (X / 128)^2 patches of (S, C)
    patches = (X // 128) ** 2 if X > 128 else 1
    nblk = min((P * Q) // cols_per_tile, max(
        1, _BLOCKS_PER_SM * _launch.sm_count(xr.device) // patches))
    part = torch.empty((nblk, 2, X, X), dtype=torch.float32, device=xr.device)
    out = torch.empty((2, X, X), dtype=torch.float32, device=xr.device)
    fn = _launch.entry("gram", "dqc_gram", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), part.data_ptr(), out.data_ptr(),
              P, X, Q, nblk, _launch.stream(xr.device))
    _launch.raise_on_error(code, "gram", "gram launch")
    gram.launches += 1
    return out[0], out[1]


gram.launches = 0
