"""One-pass adjoint step of a lane + sublane block pair on f32 planes.

Replaces the TPU kernel ``block_backward_dual``
(``dqc_tpu/ops/pallas/block_backward.py:437``), with its ``diag_q``
outputs: on the forward planes ``F`` and the cotangent planes ``B``
``(A, 128, 128) x 2``, with lane operator ``E0`` and sublane operator
``E1``, in tape order (``g0_first``: the lane block came first in the
forward, so the sublane block is rolled back first)

* sublane: ``F <- E1inv F``, ``T0_sub[x, y] += sum B[a, x, c] F[a, y, c]``,
  ``B <- E1^T B``;
* lane: ``F <- F E0inv^T``, ``T0_lane[x, y] += sum B[a, r, x] F[a, r, y]``,
  ``B <- B E0``;

with the pair grams holomorphic (no conjugation) and an optional fused
diagonal run rolled back (``F *= Dinv``, ``B *= D``) before both steps
when the run followed the pair in the forward (``diag_first_fwd=False``),
after them otherwise. With ``diag_q`` (a run with variable gates) it also
returns the run's Q reductions of the holomorphic product ``Q[a, s, l] =
B F`` of the planes as they meet the run, before its update: ``Qsl``
(128, 128) summed over ``a``, ``Qas`` (A, 128) summed over ``l``, ``Qal``
(A, 128) summed over ``s``. The Hopper kernel is
``csrc/block_backward_dual.cu`` (bound by operations: 768 complex
multiply-adds per amplitude); :func:`block_backward_dual_plain` is its
plain PyTorch version.

:func:`block_backward_dual` updates ``(F, B)`` in place on a CUDA tensor
(the TPU kernel aliases them) and returns the plain version's fresh planes
on a CPU tensor. Returns ``(f_r, f_i, b_r, b_i, T0_lane_r, T0_lane_i,
T0_sub_r, T0_sub_i)``, then with ``diag_q`` ``(Qsl_r, Qsl_i, Qas_r, Qas_i,
Qal_r, Qal_i)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.dual_apply import diag_run
from dqc_tpu_torch.ops.kernels.gram import pair_sum


def _split(*zs):
    return tuple(t for z in zs for t in (z.real.contiguous(), z.imag.contiguous()))


def block_backward_dual_plain(fr, fi, br, bi, e0inv_r, e0inv_i, e0_r, e0_i,
                              e1inv_r, e1inv_i, e1_r, e1_i, *,
                              g0_first: bool = True,
                              diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_first_fwd: bool = True,
                              diag_q: bool = False):
    """Plain PyTorch version of the kernel (complex64 matmuls); fresh
    outputs."""
    _check_diag_q(diag_q, diag_tables)
    A = fr.shape[0]
    F, B = torch.complex(fr, fi), torch.complex(br, bi)
    E0inv, E0 = torch.complex(e0inv_r, e0inv_i), torch.complex(e0_r, e0_i)
    E1inv, E1 = torch.complex(e1inv_r, e1inv_i), torch.complex(e1_r, e1_i)
    Q = None
    if diag_tables is not None:
        Dinv, D = diag_run(diag_inv_tables), diag_run(diag_tables)
        if not diag_first_fwd:
            Q = B * F if diag_q else None
            F, B = F * Dinv, B * D

    def sublane(F, B):
        F = torch.matmul(E1inv, F)
        return F, torch.matmul(E1.transpose(0, 1), B), pair_sum(B, F)

    def lane(F, B):
        F = torch.matmul(F, E0inv.transpose(0, 1))
        T = pair_sum(B.reshape(A * 128, 128, 1), F.reshape(A * 128, 128, 1))
        return F, torch.matmul(B, E0), T

    if g0_first:
        F, B, Ts = sublane(F, B)
        F, B, Tl = lane(F, B)
    else:
        F, B, Tl = lane(F, B)
        F, B, Ts = sublane(F, B)
    if diag_tables is not None and diag_first_fwd:
        Q = B * F if diag_q else None
        F, B = F * Dinv, B * D
    if Q is None:
        return _split(F, B, Tl, Ts)
    return _split(F, B, Tl, Ts, Q.sum(0), Q.sum(2), Q.sum(1))


def _check_diag_q(diag_q: bool, diag_tables) -> None:
    if diag_q and diag_tables is None:
        raise ValueError("block_backward_dual: diag_q needs a diagonal run")


_ARGTYPES = ([_launch.VOIDP] * 24 + [_launch.INT] * 4 + [_launch.VOIDP] * 6
             + [_launch.LONG, _launch.INT, _launch.VOIDP])


def block_backward_dual(fr, fi, br, bi, e0inv_r, e0inv_i, e0_r, e0_i,
                        e1inv_r, e1inv_i, e1_r, e1_i, *, g0_first: bool = True,
                        diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_first_fwd: bool = True, diag_q: bool = False):
    """The adjoint step on planes ``(A, 128, 128)``; operators are f32
    real/imag pairs (128, 128); ``diag_inv_tables`` / ``diag_tables`` the
    six f32 planes ``(tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)`` of the
    run's inverse and of the run, or both None; ``diag_q`` (with a run)
    adds its Q reductions to the outputs."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 3 or tuple(fr.shape[1:]) != (128, 128) or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_dual: planes must be (A, 128, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    if (diag_tables is None) != (diag_inv_tables is None):
        raise ValueError("block_backward_dual: give both diag tables or neither")
    _check_diag_q(diag_q, diag_tables)
    ops = (e0inv_r, e0inv_i, e0_r, e0_i, e1inv_r, e1inv_i, e1_r, e1_i)
    if fr.device.type == "cpu":
        return block_backward_dual_plain(
            *planes, *ops, g0_first=g0_first, diag_inv_tables=diag_inv_tables,
            diag_tables=diag_tables, diag_first_fwd=diag_first_fwd,
            diag_q=diag_q)
    A = fr.shape[0]
    _launch.check_cuda_f32("block_backward_dual", planes + ops, fr.device)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("block_backward_dual: operators must be (128, 128)")
    for tabs in (diag_inv_tables, diag_tables):
        _launch.check_tables("block_backward_dual", tabs, A, fr.device)
    nblk = min(A, _launch.sm_count(fr.device))
    n_out = 6 if diag_q else 4
    part = torch.zeros((nblk, n_out, 128, 128), dtype=torch.float32,
                       device=fr.device)
    out = torch.empty((n_out, 128, 128), dtype=torch.float32, device=fr.device)
    rows = (torch.zeros((4, A, 128), dtype=torch.float32, device=fr.device)
            if diag_q else None)
    fn = _launch.entry("block_backward_dual", "dqc_block_backward_dual",
                       _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in ops),
              *_launch.table_ptrs(diag_inv_tables),
              *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
              int(diag_first_fwd), int(g0_first), int(diag_q),
              *([None] * 4 if rows is None else [r.data_ptr() for r in rows]),
              part.data_ptr(), out.data_ptr(), A, nblk, _launch.stream(fr.device))
    _launch.raise_on_error(code, "block_backward_dual", "block_backward_dual launch")
    block_backward_dual.launches += 1
    if diag_q:
        block_backward_dual.mode_launches["diag_q"] += 1
    if rows is None:
        return (fr, fi, br, bi, *out)
    # the kernel keeps Qsl in the order of the step that meets the run:
    # [l][s] for the lane step (second with g0_first, the run met last with
    # diag_first_fwd)
    qsl = out[4:]
    if diag_first_fwd == g0_first:
        qsl = qsl.transpose(1, 2)
    return (fr, fi, br, bi, *out[:4], *qsl, *rows)


block_backward_dual.launches = 0
block_backward_dual.mode_launches = {"diag_q": 0}
