"""Group Gram of the planes in one read: ``(S, C)`` over the view ``(P, X, Q)``.

``S[x, y] = sum_{p,q} xr[p,x,q] xr[p,y,q] + xi[p,x,q] xi[p,y,q]`` and
``C[x, y] = sum_{p,q} xr[p,x,q] xi[p,y,q]``; the complex group Gram is
``G = S + i (C^T - C)`` (ops/planes.gram_axis). Replaces the three TPU
kernels of ``dqc_tpu/ops/pallas/gram.py`` — ``gram_lane`` (:58, view
``(A 128, 128, 1)``), ``gram_sublane`` (:97, view ``(A, 128, 128)``) and
``gram_high`` (:134, view ``(A1, X, M 128)``; also on the merged top
axis of a tiny top group, X = 256 or 512, ops/planes.gram_merged_top) —
with ``csrc/gram.cu`` (S is symmetric, so 2 X + 1 real multiply-adds per
amplitude against 8 bytes: bound by bytes at X = 8..64, by operations
above), which sums per-block partials and adds them in a second,
fixed-order pass. Its C entry ``dqc_gram_tc`` runs the products on the
tensor cores at every X (3xTF32 in the "f32" dot mode, three bf16 passes
in bf16x3, one bf16 pass on bf16 planes, exact in both; S formed as ``P +
P^T``): 128 x 128 patches of (S, C) over 32-column tiles at X = 128, 256
and 512, one X x X patch over 128-column tiles (64 at X = 64) streamed
through a three-stage ring below; every launch counted in
``mode_launches["tc"]``. :func:`gram_plain` is its plain PyTorch version.

The planes may be stored bfloat16 ("bf16" storage, decoded on the read) and
the products run bf16x3 (``dot_mode``, the TPU kernels' ``dot_mode``), at
every X, counted in ``mode_launches`` as "fwd_bf16" and "fwd_bf16x3".
On bf16 planes bf16x3 and f32 compute the same sums: a bf16 value's lo part
is zero, so each product is the exact one. float16 planes (a cotangent
stored "f16", which the TPU kernels decode but no path of either package
hands them) raise ``NotImplementedError`` (ROADMAP.md queue B item 1).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st

KERNEL_X = (8, 16, 32, 64, 128, 256, 512)
_BLOCKS_PER_SM = 4        # X >= 128: over the (X / 128)^2 patches
_SMALL_BLOCKS_PER_SM = 2  # X <= 64: one patch a block


def tile_columns(X: int) -> int:
    """The columns of one tile of the view at X (``csrc/gram.cu``)."""
    return 32 if X >= 128 else 64 if X == 64 else 128


def k_groups(X: int) -> int:
    """Partial slots a block writes: one at X >= 128, else one per k-group
    of its warps (2 at X = 64, 8 below)."""
    return 1 if X >= 128 else 2 if X == 64 else 8


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


def _pair_sum3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`pair_sum` of real tensors in bf16x3: ``ah (bh + bl) + al bh``."""
    ah, al = _st.split(a)
    bh, bl = _st.split(b)
    return pair_sum(ah, bh + bl) + pair_sum(al, bh)


def gram_plain(xr: torch.Tensor, xi: torch.Tensor,
               dot_mode: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: three real contractions of the
    decoded planes in ``dot_mode``."""
    xr, xi = xr.to(torch.float32), xi.to(torch.float32)
    ps = pair_sum if dot_mode == "f32" else _pair_sum3
    return ps(xr, xr) + ps(xi, xi), ps(xr, xi)


_TC_ARGTYPES = ([_launch.VOIDP] * 5 + [_launch.LONG, _launch.INT, _launch.LONG]
                + [_launch.INT] * 3 + [_launch.VOIDP])


def gram(xr: torch.Tensor, xi: torch.Tensor,
         dot_mode: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, C)``, each float32 (X, X), of planes (float32 or bfloat16)
    viewed as ``(P, X, Q)``; X in 8..64 with Q a multiple of 128 (64 at X =
    64), or 128 / 256 / 512 with Q = 1 (X = 128 only) or a multiple of 32;
    ``dot_mode`` the products'."""
    if xr.dim() != 3 or xi.shape != xr.shape:
        raise ValueError(f"gram: planes must be one (P, X, Q) view, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    _st.check_fwd("gram", xr, xi, dot_mode)
    if xr.device.type == "cpu":
        return gram_plain(xr, xi, dot_mode)
    P, X, Q = xr.shape
    if X not in KERNEL_X:
        raise ValueError(f"gram: X={X} is not one of {KERNEL_X}")
    cols_per_tile = tile_columns(X)
    if (P * Q) % cols_per_tile or (Q != 1 and Q % cols_per_tile) or (
            Q == 1 and X != 128):
        raise ValueError(f"gram: view {tuple(xr.shape)} does not tile by "
                         f"{cols_per_tile} columns")
    _launch.check_cuda_f32("gram", (xr, xi), xr.device, align=16,
                           dtypes=_st.FWD_DTYPES)
    # X >= 128: each block forms one of the (X / 128)^2 patches of (S, C)
    blocks = (_BLOCKS_PER_SM * _launch.sm_count(xr.device) // (X // 128) ** 2
              if X >= 128 else _SMALL_BLOCKS_PER_SM * _launch.sm_count(xr.device))
    nblk = min((P * Q) // cols_per_tile, 65535, max(1, blocks))
    part = torch.empty((nblk * k_groups(X), 2, X, X), dtype=torch.float32,
                       device=xr.device)
    tot = torch.empty((2, X, X), dtype=torch.float32, device=xr.device)
    out = torch.empty((2, X, X), dtype=torch.float32, device=xr.device)
    fn = _launch.entry("gram", "dqc_gram_tc", _TC_ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), part.data_ptr(), tot.data_ptr(),
              out.data_ptr(), P, X, Q, nblk, _st.storage_kind(xr.dtype),
              int(dot_mode == "bf16x3"), _launch.stream(xr.device))
    _launch.raise_on_error(code, "gram", "gram launch")
    gram.launches += 1
    gram.mode_launches["tc"] += 1
    _st.count_fwd(gram, xr.dtype, dot_mode)
    return out[0], out[1]


gram.launches = 0
gram.mode_launches = {"tc": 0, "fwd_bf16": 0, "fwd_bf16x3": 0}
