"""One-pass adjoint step of a high-group block on f32 planes.

Replaces the TPU kernel ``block_backward_high``
(``dqc_tpu/ops/pallas/block_backward.py:906``) for ``X <= 128``, without
its ``diag_q`` outputs: on the view ``(A1, X, M, 128)`` of the forward
planes ``F`` and the cotangent planes ``B``, with the group's operator
``E`` (X x X) on axis X,

``F <- Einv F``, ``T0[x, y] += sum B[i, x, q] F[i, y, q]``, ``B <- E^T B``

with the pair gram holomorphic (no conjugation) and an optional fused
diagonal run rolled back (``F *= Dinv``, ``B *= D``) before the dense stage
when the run followed it in the forward (``diag_first_fwd=False``), after
it otherwise. The run's tables stay canonical, as in ``high_apply``. The
Hopper kernel is ``csrc/block_backward_high.cu`` (bound by operations: 3 X
complex multiply-adds per amplitude); :func:`block_backward_high_plain` is
its plain PyTorch version.

:func:`block_backward_high` updates ``(F, B)`` in place on a CUDA tensor
and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_r, T0_i)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split
from dqc_tpu_torch.ops.kernels.gram import pair_sum
from dqc_tpu_torch.ops.kernels.high_apply import KERNEL_X, view_diag_run


def block_backward_high_plain(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                              diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_first_fwd: bool = True):
    """Plain PyTorch version of the kernel (complex64 matmuls); fresh
    outputs."""
    A1, X, M, _ = fr.shape
    v = (A1, X, M * 128)
    F = torch.complex(fr, fi).reshape(v)
    B = torch.complex(br, bi).reshape(v)
    if diag_tables is not None:
        Dinv = view_diag_run(diag_inv_tables, fr.shape).reshape(v)
        D = view_diag_run(diag_tables, fr.shape).reshape(v)
        if not diag_first_fwd:
            F, B = F * Dinv, B * D
    F = torch.matmul(torch.complex(einv_r, einv_i), F)
    T0 = pair_sum(B, F)
    B = torch.matmul(torch.complex(e_r, e_i).transpose(0, 1), B)
    if diag_tables is not None and diag_first_fwd:
        F, B = F * Dinv, B * D
    return _split(F.reshape(fr.shape), B.reshape(fr.shape), T0)


_ARGTYPES = ([_launch.VOIDP] * 20 + [_launch.INT] * 2 + [_launch.VOIDP] * 2
             + [_launch.LONG, _launch.INT, _launch.LONG, _launch.INT,
                _launch.VOIDP])


def block_backward_high(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                        diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_first_fwd: bool = True):
    """The adjoint step on the view ``(A1, X, M, 128)``, X in 8..128;
    operators are f32 real/imag pairs (X, X); the tables as in
    ``high_apply`` (run's inverse, then run), or both None. A run needs
    M % 128 == 0."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 4 or fr.shape[-1] != 128 or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_high: planes must be (A1, X, M, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    A1, X, M, _ = fr.shape
    if (diag_tables is None) != (diag_inv_tables is None):
        raise ValueError("block_backward_high: give both diag tables or neither")
    if diag_tables is not None and M % 128:
        raise ValueError(f"block_backward_high: a diag run needs M % 128 == 0, "
                         f"got M={M}")
    ops = (einv_r, einv_i, e_r, e_i)
    if fr.device.type == "cpu":
        return block_backward_high_plain(
            *planes, *ops, diag_inv_tables=diag_inv_tables,
            diag_tables=diag_tables, diag_first_fwd=diag_first_fwd)
    if X not in KERNEL_X:
        raise ValueError(f"block_backward_high: X={X} is not one of {KERNEL_X}")
    _launch.check_cuda_f32("block_backward_high", planes + ops, fr.device)
    if any(tuple(o.shape) != (X, X) for o in ops):
        raise ValueError(f"block_backward_high: operators must be ({X}, {X})")
    for tabs in (diag_inv_tables, diag_tables):
        _launch.check_tables("block_backward_high", tabs, A1 * X * M // 128,
                             fr.device)
    lib = "block_backward_high"
    slots = _launch.entry(lib, "dqc_block_backward_high_slots", [_launch.INT])(X)
    ntiles = A1 * X * M * 128 // 8192
    nblk = min(ntiles, _launch.sm_count(fr.device))
    part = torch.zeros((nblk * slots, 2, X, X), dtype=torch.float32,
                       device=fr.device)
    out = torch.empty((2, X, X), dtype=torch.float32, device=fr.device)
    fn = _launch.entry(lib, "dqc_block_backward_high", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in ops),
              *_launch.table_ptrs(diag_inv_tables),
              *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
              int(diag_first_fwd), part.data_ptr(), out.data_ptr(), A1, X,
              M * 128, nblk, _launch.stream(fr.device))
    _launch.raise_on_error(code, lib, "block_backward_high launch")
    block_backward_high.launches += 1
    return (fr, fi, br, bi, out[0], out[1])


block_backward_high.launches = 0
