"""The tensor-core kernels' operand splits and pre-split operators.

``csrc/tc_apply.cuh`` (the high apply at X = 128 / 256 / 512, and the two
updates of the X = 256 / 512 adjoint), the X = 256 / 512 cross-Gram of
``csrc/block_backward_high.cu`` and the one-pass adjoint step of the dual,
lane and sublane adjoints and of the high adjoint at X = 128
(``csrc/tc_adjoint.cuh``; the merged-top adjoint runs it too) and at X =
8..64 (``csrc/block_backward_high_small.cu``), and the Gram at every X
(``csrc/gram.cu``, which reads no operator) run their products on the
tensor cores:

* the "f32" dot mode as 3xTF32: ``hi = tf32(a)``, ``lo = tf32(a - hi)``,
  both rounded to nearest with ties away from zero (``cvt.rna.tf32``), and
  ``a b ~ ah bh + ah bl + al bh`` in m16n8k8 tf32 products with f32 sums
  (one pass of TF32 keeps ~11 bits; the three leave ~2^-21 of a product);
* bf16x3: ``hi = bf16(a)``, ``lo = bf16(a - hi)`` (``_storage.split``),
  the same three products in m16n8k16 bf16.

:func:`tc_operator` is an operator as those kernels read it, made once
per launch (X x X entries, 0.1% of the work): the hi and lo parts of its
real and imaginary planes in mma fragment order, so that a warp reads each
part of a fragment as one 16-byte load per lane and splits nothing; one
gather through a cached index.
:func:`split_tf32` is the tf32 split in plain PyTorch, the kernels'
numerics written out for the CPU tests.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _storage as _st

_TF32_HALF = 0x1000        # half an ulp of tf32's 10-bit mantissa, in f32 bits
_TF32_MASK = -(1 << 13)    # the 13 low bits tf32 drops (0xFFFFE000)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 values rounded to tf32 (10 mantissa bits),
    to nearest with ties away from zero, as f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + _TF32_HALF) & _TF32_MASK).view(torch.float32)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A real f32 tensor as its tf32 hi part and tf32 lo remainder."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def split_parts(a: torch.Tensor, dot_mode: str):
    """(hi, lo) of a real f32 tensor in the kernels' split for ``dot_mode``:
    tf32 in "f32" (3xTF32), bf16 in "bf16x3"."""
    return split_tf32(a) if dot_mode == "f32" else _st.split(a)


def split_tf32_3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A real f32 tensor as three tf32 parts, hi + lo + lo2 within ~2^-33 of
    it: the operator of a 3xTF32 product whose planes operand is exact in
    tf32 (16-bit planes), so that its products are as close as f32's."""
    hi, lo = split_tf32(a)
    return hi, lo, tf32_round(a - hi - lo)


def operator_parts(mode: str, planes_dtype) -> int:
    """The parts of an operator that meets planes stored as ``planes_dtype``
    in ``mode``: three (six with re and im) where 3xTF32 meets 16-bit
    planes, exact in tf32 (the kernels read them so), else two."""
    return 6 if mode == "f32" and planes_dtype != torch.float32 else 4


@functools.lru_cache(maxsize=None)
def _gather_index(X: int, ks: int, device) -> torch.Tensor:
    """Flat indices into an X x X part of the entries of its A fragments in
    the kernels' order (k-step s, m-tile mt, lane, register[, half]): row
    mt 16 + g + 8 (r & 1) and column s ks + t + 4 (r >> 1) for m16n8k8 tf32
    (ks = 8), the pair at columns s ks + 2 t + 8 (r >> 1) + {0, 1} for
    m16n8k16 bf16 (ks = 16, the lower column in the register's low half);
    lane = 4 g + t."""
    s = torch.arange(X // ks, device=device).view(-1, 1, 1, 1)
    mt = torch.arange(X // 16, device=device).view(1, -1, 1, 1)
    lane = torch.arange(32, device=device).view(1, 1, -1, 1)
    r = torch.arange(4, device=device).view(1, 1, 1, -1)
    g, t = lane // 4, lane % 4
    row = mt * 16 + g + 8 * (r & 1)
    if ks == 8:
        return (row * X + s * ks + t + 4 * (r >> 1)).reshape(-1)
    at = row * X + s * ks + 2 * t + 8 * (r >> 1)
    return torch.stack((at, at + 1), dim=-1).reshape(-1)


def _diag2(e: torch.Tensor) -> torch.Tensor:
    """diag(E, E) of an operator (or of each of a stack)."""
    z = e.new_zeros((*e.shape[:-2], 16, 16))
    z[..., :8, :8] = e
    z[..., 8:, 8:] = e
    return z


def tc_operator(e_r: torch.Tensor, e_i: torch.Tensor, dot_mode: str,
                parts: int = 4) -> torch.Tensor:
    """The X x X operator ``E`` as the tensor-core kernels read it
    (``csrc/tc_apply.cuh``, ``csrc/tc_adjoint.cuh``): an int32 tensor ``(X /
    ks, X / 16, parts, 32, 4)`` — k-step, m-tile, part (re hi, re lo, im
    hi, im lo; with ``parts=6``, "f32" only, then re lo2 and im lo2:
    :func:`split_tf32_3`), lane, register — of f32 bit patterns of tf32
    parts ("f32", ks = 8), or of pairs of bf16 parts ("bf16x3", ks = 16).
    ``e_r`` / ``e_i`` may be views (a transpose), or stacks ``(T, X, X)`` of
    operators (the multi-term dual apply's terms, ``csrc/dual_multi_apply.cu``),
    each laid out so: ``(T, X / ks, X / 16, parts, 32, 4)``. An X = 8
    operator is laid out as ``diag(E, E)``, 16 x 16: the small-X kernels
    (``csrc/small_x.cuh``) stack two 8-row halves of their tile as 16 rows."""
    if e_r.shape[-1] == 8:
        e_r, e_i = _diag2(e_r), _diag2(e_i)
    X = e_r.shape[-1]
    lead = tuple(e_r.shape[:-2])
    ks = 8 if dot_mode == "f32" else 16
    idx = _gather_index(X, ks, e_r.device)
    if parts == 6:
        if dot_mode != "f32":
            raise ValueError("tc_operator: three parts are 3xTF32's")
        (rh, rl, rl2), (ih, il, il2) = split_tf32_3(e_r), split_tf32_3(e_i)
        split = [rh, rl, ih, il, rl2, il2]
    else:
        split = [*split_parts(e_r, dot_mode), *split_parts(e_i, dot_mode)]
    P = len(split)
    flat = torch.stack(split, dim=-3).reshape(*lead, P, X * X)
    if ks == 8:
        f = flat.view(torch.int32)[..., idx].view(*lead, P, X // ks, X // 16, 32, 4)
    else:  # the two bf16 halves of a register, the lower column low
        f = (flat.to(torch.bfloat16).view(torch.int16)[..., idx]
             .view(*lead, P, X // ks, X // 16, 32, 4, 2).view(torch.int32)[..., 0])
    d = len(lead)
    return f.permute(*range(d), d + 1, d + 2, d, d + 3, d + 4).contiguous()

