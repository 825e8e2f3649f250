"""The tensor-core kernels' operand splits and pre-split operators.

``csrc/tc_apply.cuh`` (the high apply at X = 128 / 256 / 512, and the two
updates of the X = 256 / 512 adjoint) and the X = 256 / 512 cross-Gram of
``csrc/block_backward_high.cu`` run their products on the tensor cores:

* the "f32" dot mode as 3xTF32: ``hi = tf32(a)``, ``lo = tf32(a - hi)``,
  both rounded to nearest with ties away from zero (``cvt.rna.tf32``), and
  ``a b ~ ah bh + ah bl + al bh`` in m16n8k8 tf32 products with f32 sums
  (one pass of TF32 keeps ~11 bits; the three leave ~2^-21 of a product);
* bf16x3: ``hi = bf16(a)``, ``lo = bf16(a - hi)`` (``_storage.split``),
  the same three products in m16n8k16 bf16.

:func:`tc_operator` is the apply's operator as the kernel reads it, made
once per launch (X x X entries, 0.1% of the work): the hi and lo parts of
its real and imaginary planes in mma fragment order, so that a warp reads
each part of a fragment as one 16-byte load per lane and splits nothing.
:func:`split_tf32` is the tf32 split in plain PyTorch, the kernels'
numerics written out for the CPU tests.
"""

from __future__ import annotations

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


def _fragment_index(ks: int, device):
    """Row and column of each (lane, register[, half]) of an A fragment of
    16 rows x ``ks`` columns: m16n8k8 tf32 (ks = 8: (32, 4)) or m16n8k16
    bf16 (ks = 16: (32, 4, 2), the lower column in the register's low
    half)."""
    lane = torch.arange(32, device=device)
    g, t = (lane // 4)[:, None], (lane % 4)[:, None]
    r = torch.arange(4, device=device)[None, :]
    row = g + 8 * (r & 1)
    if ks == 8:
        return row, t + 4 * (r >> 1)
    col = 2 * t + 8 * (r >> 1)
    return row[..., None], col[..., None] + torch.arange(2, device=device)


def tc_operator(e_r: torch.Tensor, e_i: torch.Tensor, dot_mode: str) -> torch.Tensor:
    """The X x X operator ``E`` as ``csrc/tc_apply.cuh`` reads it: an int32
    tensor ``(X / ks, X / 16, 4, 32, 4)`` — k-step, m-tile, part (re hi, re
    lo, im hi, im lo), lane, register — of f32 bit patterns of tf32 parts
    ("f32", ks = 8), or of pairs of bf16 parts ("bf16x3", ks = 16)."""
    X = e_r.shape[0]
    ks = 8 if dot_mode == "f32" else 16
    row, col = _fragment_index(ks, e_r.device)
    parts = [*split_parts(e_r, dot_mode), *split_parts(e_i, dot_mode)]
    out = []
    for p in parts:
        blocks = p.reshape(X // 16, 16, X // ks, ks)
        if ks == 8:
            f = blocks[:, row, :, col].view(torch.int32)      # (32, 4, mt, s)
        else:  # the two bf16 halves of a register, the lower column low
            h = blocks.to(torch.bfloat16).view(torch.int16)[:, row, :, col]
            f = h.permute(0, 1, 3, 4, 2).contiguous().view(torch.int32)[..., 0]
        out.append(f.permute(3, 2, 0, 1))                     # (s, mt, 32, 4)
    return torch.stack(out, dim=2).contiguous()
