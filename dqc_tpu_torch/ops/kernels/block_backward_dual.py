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
``csrc/block_backward_dual.cu`` on ``csrc/tc_adjoint.cuh``: every product on
the tensor cores (``mma.sync``), the uncomputes and transports as 3xTF32
in the "f32" dot mode or three bf16 products in bf16x3, the pair grams
likewise (bound by the tensor cores' rate: 768 complex multiply-adds per
amplitude); each launch hands it the four operators pre-split in mma
fragment order (:func:`step_operators`) and counts in
``mode_launches["tc"]``. :func:`block_backward_dual_plain` is its plain
PyTorch version.

:func:`block_backward_dual` updates ``(F, B)`` in place on a CUDA tensor
(the TPU kernel aliases them) and returns the plain version's fresh planes
on a CPU tensor. Returns ``(f_r, f_i, b_r, b_i, T0_lane_r, T0_lane_i,
T0_sub_r, T0_sub_i)``, then with ``diag_q`` ``(Qsl_r, Qsl_i, Qas_r, Qas_i,
Qal_r, Qal_i)``.

The cotangent planes ``B`` may be stored as float32, bfloat16 or float16
(the kernels' codec, ops/kernels/_storage.py) and the forward planes ``F``
as float32 or bfloat16 ("bf16" storage); the uncomputes run in
``dot_mode``, the transports and the pair grams in ``bwd_mode`` /
``gram_mode`` ("f32" or "bf16x3"), as the TPU kernel's ``dot_mode``,
``bwd_dot_mode`` and ``gram_dot_mode``. ``F`` and ``B`` are rounded to
their storage where the TPU kernel stores and reloads them: between the
two steps and next to the run. Such launches are also counted in
``mode_launches`` ("bf16" / "f16" for B's storage, "bf16x3" for the
transports, "gram_bf16x3" for the pair grams, "fwd_bf16" for F's storage
and "fwd_bf16x3" for the uncomputes). With ``diag_q`` under reduced
storage, Q is taken from the planes as the TPU kernel stages them: where
the run is met after the dense steps, from F and B rounded to their
storage (the kernel stores and rereads them there); where it is met
first, from the decoded input planes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels import _tc
from dqc_tpu_torch.ops.kernels._storage import (check_modes, count_modes, load_b,
                                                round_b, store_b)
from dqc_tpu_torch.ops.kernels.dual_apply import diag_run


def _split(*zs):
    return tuple(t for z in zs for t in (z.real.contiguous(), z.imag.contiguous()))


def block_backward_dual_plain(fr, fi, br, bi, e0inv_r, e0inv_i, e0_r, e0_i,
                              e1inv_r, e1inv_i, e1_r, e1_i, *,
                              g0_first: bool = True,
                              diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_first_fwd: bool = True,
                              diag_q: bool = False, bwd_mode: str = "f32",
                              gram_mode: str = "f32", dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64 matmuls in the dot
    modes, F and B decoded, rounded and encoded where the kernel does);
    fresh outputs."""
    _check_diag_q(diag_q, diag_tables)
    A = fr.shape[0]
    bdt, fdt = br.dtype, fr.dtype
    F, B = load_b(fr, fi), load_b(br, bi)
    E0inv, E0 = torch.complex(e0inv_r, e0inv_i), torch.complex(e0_r, e0_i)
    E1inv, E1 = torch.complex(e1inv_r, e1inv_i), torch.complex(e1_r, e1_i)
    Q = None
    if diag_tables is not None:
        Dinv, D = diag_run(diag_inv_tables), diag_run(diag_tables)
        if not diag_first_fwd:
            Q = B * F if diag_q else None
            F, B = round_b(F * Dinv, fdt), round_b(B * D, bdt)

    def sublane(F, B):
        F = _st.cmatmul(E1inv, F, dot_mode)
        return (F, _st.cmatmul(E1.transpose(0, 1), B, bwd_mode),
                _st.pair_sum(B, F, gram_mode))

    def lane(F, B):
        F = _st.cmatmul(F, E0inv.transpose(0, 1), dot_mode)
        T = _st.pair_sum(B.reshape(A * 128, 128, 1), F.reshape(A * 128, 128, 1),
                         gram_mode)
        return F, _st.cmatmul(B, E0, bwd_mode), T

    if g0_first:
        F, B, Ts = sublane(F, B)
        F, B, Tl = lane(round_b(F, fdt), round_b(B, bdt))
    else:
        F, B, Tl = lane(F, B)
        F, B, Ts = sublane(round_b(F, fdt), round_b(B, bdt))
    if diag_tables is not None and diag_first_fwd:
        F, B = round_b(F, fdt), round_b(B, bdt)
        Q = B * F if diag_q else None
        F, B = F * Dinv, B * D
    out = (*store_b(F, fdt), *store_b(B, bdt), *_split(Tl, Ts))
    if Q is None:
        return out
    return out + _split(Q.sum(0), Q.sum(2), Q.sum(1))


def _check_diag_q(diag_q: bool, diag_tables) -> None:
    if diag_q and diag_tables is None:
        raise ValueError("block_backward_dual: diag_q needs a diagonal run")


def step_operators(einv_r, einv_i, e_r, e_i, dot_mode: str, bwd_mode: str,
                   fdtype=torch.float32, bdtype=torch.float32):
    """One step's operators as ``csrc/tc_adjoint.cuh`` reads them
    (``_tc.tc_operator``): ``Einv`` for the uncompute in ``dot_mode`` on F
    stored as ``fdtype``, ``E^T`` for the transport in ``bwd_mode`` on B
    stored as ``bdtype`` (each the ``Op`` of its ``Op x tile`` product)."""
    return (_tc.tc_operator(einv_r, einv_i, dot_mode, _tc.operator_parts(dot_mode, fdtype)),
            _tc.tc_operator(e_r.t(), e_i.t(), bwd_mode, _tc.operator_parts(bwd_mode, bdtype)))


_ARGTYPES = ([_launch.VOIDP] * 20 + [_launch.INT] * 4 + [_launch.VOIDP] * 6
             + [_launch.LONG] + [_launch.INT] * 6 + [_launch.VOIDP])


def block_backward_dual(fr, fi, br, bi, e0inv_r, e0inv_i, e0_r, e0_i,
                        e1inv_r, e1inv_i, e1_r, e1_i, *, g0_first: bool = True,
                        diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_first_fwd: bool = True, diag_q: bool = False,
                        bwd_mode: str = "f32", gram_mode: str = "f32",
                        dot_mode: str = "f32"):
    """The adjoint step on planes ``(A, 128, 128)``; operators are f32
    real/imag pairs (128, 128); ``diag_inv_tables`` / ``diag_tables`` the
    six f32 planes ``(tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)`` of the
    run's inverse and of the run, or both None; ``diag_q`` (with a run)
    adds its Q reductions to the outputs. ``B`` is stored as float32,
    bfloat16 or float16, ``F`` as float32 or bfloat16; ``dot_mode``,
    ``bwd_mode`` / ``gram_mode`` are the uncomputes', the transports' and
    the pair grams' dot modes. Every launch also counts as
    ``mode_launches["tc"]``."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 3 or tuple(fr.shape[1:]) != (128, 128) or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_dual: planes must be (A, 128, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    if (diag_tables is None) != (diag_inv_tables is None):
        raise ValueError("block_backward_dual: give both diag tables or neither")
    _check_diag_q(diag_q, diag_tables)
    check_modes("block_backward_dual", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    if fi.dtype != fr.dtype:
        raise TypeError("block_backward_dual: forward planes of two dtypes")
    ops = (e0inv_r, e0inv_i, e0_r, e0_i, e1inv_r, e1inv_i, e1_r, e1_i)
    if fr.device.type == "cpu":
        return block_backward_dual_plain(
            *planes, *ops, g0_first=g0_first, diag_inv_tables=diag_inv_tables,
            diag_tables=diag_tables, diag_first_fwd=diag_first_fwd,
            diag_q=diag_q, bwd_mode=bwd_mode, gram_mode=gram_mode,
            dot_mode=dot_mode)
    A = fr.shape[0]
    _launch.check_cuda_f32("block_backward_dual", (fr, fi), fr.device,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("block_backward_dual", ops, fr.device)
    _launch.check_cuda_f32("block_backward_dual", (br, bi), fr.device,
                           dtypes=_st.STORAGE_DTYPES)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("block_backward_dual: operators must be (128, 128)")
    for tabs in (diag_inv_tables, diag_tables):
        _launch.check_tables("block_backward_dual", tabs, A, fr.device)
        # the kernel reads four neighbouring entries of tal and tsl at once
        if tabs is not None and any(t.data_ptr() % 16 for t in tabs):
            raise ValueError("block_backward_dual: diag tables must be "
                             "16-byte aligned")
    nblk = min(A, _launch.sm_count(fr.device))
    n_out = 6 if diag_q else 4
    part = torch.zeros((nblk, n_out, 128, 128), dtype=torch.float32,
                       device=fr.device)
    out = torch.empty((n_out, 128, 128), dtype=torch.float32, device=fr.device)
    rows = (torch.zeros((4, A, 128), dtype=torch.float32, device=fr.device)
            if diag_q else None)
    kinds = (dot_mode, bwd_mode, fr.dtype, br.dtype)
    tc_ops = (*step_operators(*ops[:4], *kinds), *step_operators(*ops[4:], *kinds))
    fn = _launch.entry("block_backward_dual", "dqc_block_backward_dual",
                       _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in tc_ops),
              *_launch.table_ptrs(diag_inv_tables),
              *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
              int(diag_first_fwd), int(g0_first), int(diag_q),
              *([None] * 4 if rows is None else [r.data_ptr() for r in rows]),
              part.data_ptr(), out.data_ptr(), A, nblk,
              _st.storage_kind(br.dtype), int(bwd_mode == "bf16x3"),
              int(gram_mode == "bf16x3"), _st.storage_kind(fr.dtype),
              int(dot_mode == "bf16x3"), _launch.stream(fr.device))
    _launch.raise_on_error(code, "block_backward_dual", "block_backward_dual launch")
    block_backward_dual.launches += 1
    block_backward_dual.mode_launches["tc"] += 1
    count_modes(block_backward_dual, br.dtype, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_dual, fr.dtype, dot_mode)
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
block_backward_dual.mode_launches = {"diag_q": 0, "tc": 0, "bf16": 0, "f16": 0,
                                     "bf16x3": 0, "gram_bf16x3": 0,
                                     "fwd_bf16": 0, "fwd_bf16x3": 0}
