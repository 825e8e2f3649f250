"""One-pass adjoint step of a high-group block on the planes.

Replaces the TPU kernel ``block_backward_high``
(``dqc_tpu/ops/pallas/block_backward.py:906``) with its ``diag_q``
outputs: on the view ``(A1, X, M, 128)`` of the forward
planes ``F`` and the cotangent planes ``B``, with the group's operator
``E`` (X x X) on axis X,

``F <- Einv F``, ``T0[x, y] += sum B[i, x, q] F[i, y, q]``, ``B <- E^T B``

with the pair gram holomorphic (no conjugation) and an optional fused
diagonal run rolled back (``F *= Dinv``, ``B *= D``) before the dense stage
when the run followed it in the forward (``diag_first_fwd=False``), after
it otherwise. The run's tables stay canonical, as in ``high_apply``. With
``diag_q`` (a run with variable gates) it also returns the run's Q
reductions of the holomorphic product ``Q = B F`` where the planes meet the
run, before its update: ``Qsl`` (128, 128) summed over ``a``, ``Qas`` and
``Qal`` (A, 128) summed over ``l`` and over ``s``, for the view element
``(i, x, q = (p 128 + s) 128 + l)`` at ``a = (i X + x) post + p``. The
Hopper kernels run every product on the tensor cores (3xTF32 in the "f32"
dot mode, three bf16 products in bf16x3), in every storage, run and Q, handed
``Einv`` and ``E^T`` pre-split in mma fragment order
(:func:`block_backward_dual.step_operators`) and counted also in
``mode_launches["tc"]``: at X = 8..64 ``csrc/block_backward_high_small.cu``
(the C entry ``dqc_block_backward_high_small``, a library of its own:
tiles of 2048 amplitudes streamed through a cp.async stage, the operators in
shared memory, X = 8 as 16 rows under ``diag(E, E)``; bound by bytes), at X
= 128 the dual adjoint's step (``csrc/tc_adjoint.cuh``, the C entry
``dqc_block_backward_high_tc`` in ``csrc/block_backward_high.cu``);
:func:`block_backward_high_plain` is their
plain PyTorch version. X is 8..128, or 256 / 512 on the merged top axis
of a tiny top group without a run (a lone top-group block as ``E (x) I``,
the unfactorized hpair's merged operator), where the kernel forms the pair
gram as ``(B F^T) Einv^T`` on the tensor cores (3xTF32, or three bf16
products in bf16x3), then updates the planes with two in-place launches of
the tensor-core apply of the ``high_apply`` library (``csrc/tc_apply.cuh``,
:func:`high_apply.launch_tc`) on ``Einv`` and ``E^T``, pre-split here
(``_tc.tc_operator``); the adjoint is counted once, also in
``mode_launches["wide"]``.

At X <= 128 the cotangent planes ``B`` may be stored as float32, bfloat16
or float16 and the transport and the pair gram run in ``bwd_mode`` /
``gram_mode`` ("f32" or "bf16x3"), as the TPU kernel's ``bwd_dot_mode``
and ``gram_dot_mode``, counted in ``mode_launches`` as in
``block_backward_dual``; at X = 256 / 512 too, where the cross-Gram reads
B in its storage and the transport is the wide apply in place on it. At
every X the forward planes ``F`` may be stored bfloat16 ("bf16" storage,
decoded on load, rounded on store; with B stored bfloat16 at X = 256 /
512, as "bf16" storage stores both) and the uncompute run bf16x3
(``dot_mode``), counted as "fwd_bf16" and "fwd_bf16x3"; at X = 256 / 512
the cross-Gram decodes F and the uncompute is the wide apply in place on
F in its storage. With ``diag_q``, Q is the product of the f32 values
(the TPU kernel does not stage them): of the decoded input where the run
is met first, of the uncompute's and the transport's results, unrounded,
where it is met after the dense stage.

:func:`block_backward_high` updates ``(F, B)`` in place on a CUDA tensor
and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_r, T0_i)``, then with ``diag_q`` ``(Qsl_r, Qsl_i,
Qas_r, Qas_i, Qal_r, Qal_i)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels import _tc
from dqc_tpu_torch.ops.kernels._storage import (check_modes, count_modes, load_b,
                                                store_b)
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split, step_operators
from dqc_tpu_torch.ops.kernels.high_apply import (KERNEL_X, WIDE_X, launch_tc,
                                                  view_diag_run)


def block_backward_high_plain(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                              diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_tables: Optional[Sequence[torch.Tensor]] = None,
                              diag_first_fwd: bool = True, diag_q: bool = False,
                              bwd_mode: str = "f32", gram_mode: str = "f32",
                              dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64 matmuls in the dot
    modes, F and B decoded on load and encoded on store); fresh outputs."""
    _check_diag_q(diag_q, diag_tables)
    A1, X, M, _ = fr.shape
    v = (A1, X, M * 128)
    F = load_b(fr, fi).reshape(v)
    B = load_b(br, bi).reshape(v)
    Q = None
    if diag_tables is not None:
        Dinv = view_diag_run(diag_inv_tables, fr.shape).reshape(v)
        D = view_diag_run(diag_tables, fr.shape).reshape(v)
        if not diag_first_fwd:
            Q = B * F if diag_q else None
            F, B = F * Dinv, B * D
    F = _st.cmatmul(torch.complex(einv_r, einv_i), F, dot_mode)
    T0 = _st.pair_sum(B, F, gram_mode)
    B = _st.cmatmul(torch.complex(e_r, e_i).transpose(0, 1), B, bwd_mode)
    if diag_tables is not None and diag_first_fwd:
        Q = B * F if diag_q else None
        F, B = F * Dinv, B * D
    out = (*store_b(F.reshape(fr.shape), fr.dtype),
           *store_b(B.reshape(fr.shape), br.dtype), *_split(T0))
    if Q is None:
        return out
    # view element (i, x, (p, s, l)) reads the run at a = (i X + x) post + p
    Qv = Q.reshape(A1 * X * (M // 128), 128, 128)
    return out + _split(Qv.sum(0), Qv.sum(2), Qv.sum(1))


def _check_diag_q(diag_q: bool, diag_tables) -> None:
    if diag_q and diag_tables is None:
        raise ValueError("block_backward_high: diag_q needs a diagonal run")


# dqc_block_backward_high_tc (X = 128): planes, the two pre-split
# operators, the twelve tables, run flags, Q outputs and scratch, A1, Q,
# nblk, kinds and modes
_TC_ARGTYPES = ([_launch.VOIDP] * 18 + [_launch.INT] * 3 + [_launch.VOIDP] * 8
                + [_launch.LONG, _launch.LONG] + [_launch.INT] * 6
                + [_launch.VOIDP])
# dqc_block_backward_high_small (X = 8..64): the same with X after A1 and
# the pair gram's slots a block after nblk
_SMALL_ARGTYPES = ([_launch.VOIDP] * 18 + [_launch.INT] * 3 + [_launch.VOIDP] * 8
                   + [_launch.LONG, _launch.INT, _launch.LONG] + [_launch.INT] * 7
                   + [_launch.VOIDP])
TC_X = 128   # the X of the dual adjoint's step; below, the small-X step
SMALL_TILE = 2048   # amplitudes of the small-X step's tiles
# the small-X step's pair-gram slots and blocks per SM at each X
# (csrc/block_backward_high_small.cu SmCfg: WG_K, kBlocksPerSm)
SMALL_SLOTS = {8: 8, 16: 8, 32: 2, 64: 1}
SMALL_BLOCKS_PER_SM = {8: 2, 16: 2, 32: 2, 64: 1}


def block_backward_high(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                        diag_inv_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_tables: Optional[Sequence[torch.Tensor]] = None,
                        diag_first_fwd: bool = True, diag_q: bool = False,
                        bwd_mode: str = "f32", gram_mode: str = "f32",
                        dot_mode: str = "f32"):
    """The adjoint step on the view ``(A1, X, M, 128)``, X in 8..128, or
    256 / 512 without a run; operators are f32 real/imag pairs (X, X); the
    tables as in ``high_apply`` (run's inverse, then run), or both None. A
    run needs M % 128 == 0; ``diag_q`` (with a run) adds its Q reductions
    to the outputs. ``B`` is stored as float32, bfloat16 or float16, ``F``
    as float32 or bfloat16; ``dot_mode``, ``bwd_mode`` /
    ``gram_mode`` are the uncompute's, the transport's and the pair gram's
    dot modes. Launches at X <= 128 also count as ``mode_launches["tc"]``."""
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
    _check_diag_q(diag_q, diag_tables)
    if X > 128 and diag_tables is not None:
        raise ValueError(f"block_backward_high: a diag run folds into X <= 128 "
                         f"only, got X={X}")
    ops = (einv_r, einv_i, e_r, e_i)
    check_modes("block_backward_high", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    if fi.dtype != fr.dtype:
        raise TypeError("block_backward_high: forward planes of two dtypes")
    if X in WIDE_X and fr.dtype == torch.bfloat16 and br.dtype != torch.bfloat16:
        raise TypeError("block_backward_high: bfloat16 forward planes at X = "
                        f"{X} take bfloat16 cotangent planes, got {br.dtype}")
    if fr.device.type == "cpu":
        return block_backward_high_plain(
            *planes, *ops, diag_inv_tables=diag_inv_tables,
            diag_tables=diag_tables, diag_first_fwd=diag_first_fwd,
            diag_q=diag_q, bwd_mode=bwd_mode, gram_mode=gram_mode,
            dot_mode=dot_mode)
    if X not in KERNEL_X + WIDE_X:
        raise ValueError(f"block_backward_high: X={X} is not one of "
                         f"{KERNEL_X + WIDE_X}")
    _launch.check_cuda_f32("block_backward_high", (fr, fi), fr.device,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("block_backward_high", ops, fr.device)
    _launch.check_cuda_f32("block_backward_high", (br, bi), fr.device,
                           dtypes=_st.STORAGE_DTYPES)
    if any(tuple(o.shape) != (X, X) for o in ops):
        raise ValueError(f"block_backward_high: operators must be ({X}, {X})")
    if X in WIDE_X:
        return _block_backward_wide(planes, ops, A1, X, M, bwd_mode, gram_mode,
                                    dot_mode)
    for tabs in (diag_inv_tables, diag_tables):
        _launch.check_tables("block_backward_high", tabs, A1 * X * M // 128,
                             fr.device)
        # the tensor-core steps read four neighbouring entries of tal and
        # tsl at once
        if tabs is not None and any(t.data_ptr() % 16 for t in tabs):
            raise ValueError("block_backward_high: diag tables must be "
                             "16-byte aligned")
    if X < TC_X and any(p.data_ptr() % 16 for p in planes):
        raise ValueError("block_backward_high: planes must be 16-byte aligned")
    # the blocks take tiles of 8192 (X = 128) or 2048 amplitudes, or with
    # diag_q whole (i, p) groups of 128 x 128 columns
    tile = 8192 if X == TC_X else SMALL_TILE
    units = A1 * M // 128 if diag_q else A1 * X * M * 128 // tile
    per_sm = 1 if X == TC_X else SMALL_BLOCKS_PER_SM[X]
    nblk = min(units, per_sm * _launch.sm_count(fr.device))
    slots = 1 if X == TC_X else SMALL_SLOTS[X]
    dev = fr.device
    part = torch.zeros((nblk * slots, 2, X, X), dtype=torch.float32, device=dev)
    out = torch.empty((2, X, X), dtype=torch.float32, device=dev)
    q_ptrs = [None] * 6
    if diag_q:
        rows = torch.zeros((4, A1 * X * M // 128, 128), dtype=torch.float32,
                           device=dev)
        qpart = torch.zeros((nblk, 2, 128, 128), dtype=torch.float32, device=dev)
        qsl = torch.empty((2, 128, 128), dtype=torch.float32, device=dev)
        q_ptrs = [r.data_ptr() for r in rows] + [qpart.data_ptr(), qsl.data_ptr()]
    # a run rolled back on load leaves f32 values in the step's tiles (no
    # staging), which the operators then meet in two parts
    raw = diag_tables is not None and not diag_first_fwd
    tc_ops = step_operators(*ops, dot_mode, bwd_mode,
                            torch.float32 if raw else fr.dtype,
                            torch.float32 if raw else br.dtype)
    if X == TC_X:
        lib = "block_backward_high"
        fn = _launch.entry(lib, "dqc_block_backward_high_tc", _TC_ARGTYPES)
        shape = (A1, M * 128, nblk)
    else:
        lib = "block_backward_high_small"
        fn = _launch.entry(lib, "dqc_block_backward_high_small", _SMALL_ARGTYPES)
        shape = (A1, X, M * 128, nblk, slots)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in tc_ops),
              *_launch.table_ptrs(diag_inv_tables),
              *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
              int(diag_first_fwd), int(diag_q), *q_ptrs, part.data_ptr(),
              out.data_ptr(), *shape, _st.storage_kind(br.dtype),
              int(bwd_mode == "bf16x3"), int(gram_mode == "bf16x3"),
              _st.storage_kind(fr.dtype), int(dot_mode == "bf16x3"),
              _launch.stream(dev))
    _launch.raise_on_error(code, lib, "block_backward_high launch")
    block_backward_high.launches += 1
    block_backward_high.mode_launches["tc"] += 1
    count_modes(block_backward_high, br.dtype, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_high, fr.dtype, dot_mode)
    if not diag_q:
        return (fr, fi, br, bi, out[0], out[1])
    block_backward_high.mode_launches["diag_q"] += 1
    return (fr, fi, br, bi, out[0], out[1], qsl[0], qsl[1], *rows)


_WIDE_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 5
                  + [_launch.LONG, _launch.INT, _launch.LONG] + [_launch.INT] * 2
                  + [_launch.VOIDP])
_BLOCKS_PER_SM = 4   # cross-Gram blocks per SM in all (one resident at a time)
_WIDE_TILE = 16      # columns of one cross-Gram tile


def _block_backward_wide(planes, ops, A1: int, X: int, M: int, bwd_mode: str,
                         gram_mode: str, dot_mode: str):
    """X = 256 / 512: each block of the cross-Gram forms one of the
    (X / 128)^2 patches of ``B F^T`` over its group of 16-column tiles; the
    library adds them and forms T0, then the two in-place tensor-core
    applies update F and B."""
    dev = planes[0].device
    fdt, bdt = planes[0].dtype, planes[2].dtype
    patches = (X // 128) ** 2
    nblk = min(A1 * M * 128 // _WIDE_TILE, 65535,
               max(1, _BLOCKS_PER_SM * _launch.sm_count(dev) // patches))
    part = torch.empty((nblk, 2, X, X), dtype=torch.float32, device=dev)
    gram = torch.empty((2, X, X), dtype=torch.float32, device=dev)
    out = torch.empty((2, X, X), dtype=torch.float32, device=dev)
    lib = "block_backward_high"
    fn = _launch.entry(lib, "dqc_block_backward_high_wide", _WIDE_ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), _st.storage_kind(bdt),
              _st.storage_kind(fdt), ops[0].data_ptr(), ops[1].data_ptr(),
              part.data_ptr(), gram.data_ptr(), out.data_ptr(), A1, X, M * 128,
              nblk, int(gram_mode == "bf16x3"), _launch.stream(dev))
    _launch.raise_on_error(code, lib, "block_backward_high launch")
    # F <- Einv F (F in its storage, dot_mode), B <- E^T B (B in its
    # storage, bwd_mode), in place, each operator pre-split for its mode;
    # after the cross-Gram on the same stream, which read them as they came
    fr, fi, br, bi = planes
    launch_tc(fr, fi, fr, fi, _tc.tc_operator(ops[0], ops[1], dot_mode), dot_mode)
    launch_tc(br, bi, br, bi, _tc.tc_operator(ops[2].t().contiguous(),
                                              ops[3].t().contiguous(), bwd_mode),
              bwd_mode)
    block_backward_high.launches += 1
    block_backward_high.mode_launches["wide"] += 1
    count_modes(block_backward_high, bdt, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_high, fdt, dot_mode)
    return (*planes, out[0], out[1])


block_backward_high.launches = 0
block_backward_high.mode_launches = {"diag_q": 0, "wide": 0, "tc": 0, "bf16": 0,
                                     "f16": 0, "bf16x3": 0, "gram_bf16x3": 0,
                                     "fwd_bf16": 0, "fwd_bf16x3": 0}
