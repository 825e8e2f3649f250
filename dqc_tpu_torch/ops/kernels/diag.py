"""Fused diagonal-run sweep and its one-pass adjoint on f32 planes.

Replaces the TPU kernels ``diag_sweep_planes``
(``dqc_tpu/ops/pallas/diag.py:75``) and ``diag_backward_planes`` (``:154``),
with its Q reductions (``with_q``): a run of commuting diagonal
gates is one elementwise multiply by its total diagonal in factored form,
``D[a, s, l] = (tas[a, s] tal[a, l]) tsl[s, l]`` on planes ``(A, 128, 128)``
(ops/planes.py, plane_scan._DiagFactors):

* :func:`diag_sweep`: ``x *= D``;
* :func:`diag_backward`: ``fwd *= Dinv``, ``bwd *= D`` (the cotangent
  transport by ``D^T = D``); with ``with_q`` (a run with variable gates)
  also the reductions of the holomorphic product ``Q[a, s, l] = bwd fwd``
  taken before the update: ``Qsl`` (128, 128) summed over ``a``, ``Qas``
  (A, 128) summed over ``l``, ``Qal`` (A, 128) summed over ``s``.

The Hopper kernels are ``csrc/diag.cu`` (bound by bytes: one read and one
write of each plane, 16 or 32 bytes per amplitude, against 3 or 6 complex
multiplies; with Q, persistent blocks one an SM that read each amplitude
once and keep their Qsl partial on the SM until their walk ends,
:func:`_q_buffers`); :func:`diag_sweep_plain` and
:func:`diag_backward_plain` are their plain PyTorch versions. On a CUDA
tensor the wrappers update the planes in place (the TPU kernels alias
them) and return them; on a CPU tensor they return the plain version's
fresh planes. The forward planes may be stored bfloat16 ("bf16" storage:
decoded on load, rounded to nearest even on store; counted in
``mode_launches["fwd_bf16"]``), with or without the Q reductions (taken
from the decoded planes). The sweep's planes may not be float16 (a
cotangent stored "f16", which no path hands it): that raises
``NotImplementedError`` (ROADMAP.md queue B item 1).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels._storage import count_modes, load_b, store_b
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split
from dqc_tpu_torch.ops.kernels.dual_apply import diag_run


def _times(xr, xi, tables):
    return _st.store_b(_st.load_b(xr, xi) * diag_run(tables), xr.dtype)


def diag_sweep_plain(xr, xi, *tables):
    """Plain PyTorch version of the sweep (complex64); fresh outputs of the
    input's storage."""
    return _times(xr, xi, tables)


def diag_backward_plain(fr, fi, br, bi, *tables, with_q: bool = False):
    """Plain PyTorch version of the adjoint; ``tables`` are the run's
    inverse's six planes, then the run's. B is decoded on load and encoded
    on store. Fresh outputs."""
    B = load_b(br, bi)
    out = (*_times(fr, fi, tables[:6]), *store_b(B * diag_run(tables[6:]),
                                                 br.dtype))
    if not with_q:
        return out
    Q = B * _st.load_b(fr, fi)
    return out + _split(Q.sum(0), Q.sum(2), Q.sum(1))


def _check_planes(what: str, planes: Sequence[torch.Tensor]) -> int:
    x = planes[0]
    if x.dim() != 3 or tuple(x.shape[1:]) != (128, 128) or any(
            p.shape != x.shape for p in planes):
        raise ValueError(f"{what}: planes must be (A, 128, 128), got "
                         f"{[tuple(p.shape) for p in planes]}")
    return x.shape[0]


_SWEEP_ARGTYPES = [_launch.VOIDP] * 8 + [_launch.LONG, _launch.INT,
                                         _launch.VOIDP]
_BACKWARD_ARGTYPES = [_launch.VOIDP] * 16 + [_launch.LONG, _launch.INT,
                                             _launch.INT, _launch.VOIDP]
_BACKWARD_Q_ARGTYPES = ([_launch.VOIDP] * 22 + [_launch.LONG]
                        + [_launch.INT] * 3 + [_launch.VOIDP])


def _q_buffers(A: int, dev: torch.device):
    """The Q kernel's grid and buffers: ``nblk`` persistent blocks, one an
    SM and at most one a slab; the rows ``(Qas_r, Qas_i, Qal_r, Qal_i)``,
    (4, A, 128); a Qsl slot a block, (nblk, 2, 128, 128), each written
    whole by its block; and Qsl (2, 128, 128)."""
    nblk = min(A, _launch.sm_count(dev))
    rows = torch.empty((4, A, 128), dtype=torch.float32, device=dev)
    part = torch.empty((nblk, 2, 128, 128), dtype=torch.float32, device=dev)
    qsl = torch.empty((2, 128, 128), dtype=torch.float32, device=dev)
    return nblk, rows, part, qsl


def diag_sweep(xr, xi, tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i):
    """``x *= D`` on planes ``(A, 128, 128)`` stored as float32 or
    bfloat16; the six f32 table planes ``tsl`` (128, 128) and ``tas``,
    ``tal`` (A, 128)."""
    tables = (tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)
    A = _check_planes("diag_sweep", (xr, xi))
    _st.check_fwd("diag_sweep", xr, xi)
    if xr.device.type == "cpu":
        return diag_sweep_plain(xr, xi, *tables)
    _launch.check_cuda_f32("diag_sweep", (xr, xi), xr.device, align=16,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_tables("diag_sweep", tables, A, xr.device)
    _launch.check_cuda_f32("diag_sweep", tables, xr.device, align=16)
    fn = _launch.entry("diag", "dqc_diag_sweep", _SWEEP_ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), *_launch.table_ptrs(tables), A,
              _st.storage_kind(xr.dtype), _launch.stream(xr.device))
    _launch.raise_on_error(code, "diag", "diag_sweep launch")
    diag_sweep.launches += 1
    _st.count_fwd(diag_sweep, xr.dtype, "f32")
    return xr, xi


def diag_backward(fr, fi, br, bi, isl_r, isl_i, ias_r, ias_i, ial_r, ial_i,
                  tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i, *,
                  with_q: bool = False):
    """``fwd *= Dinv``, ``bwd *= D`` on planes ``(A, 128, 128)``: the run's
    inverse's six table planes, then the run's. Returns the four planes,
    then with ``with_q`` ``(Qsl_r, Qsl_i, Qas_r, Qas_i, Qal_r, Qal_i)``.
    ``bwd`` may be stored as float32, bfloat16 or float16 (the kernels'
    codec), counted in ``mode_launches`` under the storage's name, and
    ``fwd`` as float32 or bfloat16, counted as "fwd_bf16"."""
    planes = (fr, fi, br, bi)
    inv = (isl_r, isl_i, ias_r, ias_i, ial_r, ial_i)
    fwd = (tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)
    A = _check_planes("diag_backward", planes)
    _st.check_f("diag_backward", fr, fi)
    _st.storage_kind(br.dtype)
    if bi.dtype != br.dtype:
        raise TypeError("diag_backward: cotangent planes of two dtypes")
    if fr.device.type == "cpu":
        return diag_backward_plain(*planes, *inv, *fwd, with_q=with_q)
    dev = fr.device
    _launch.check_cuda_f32("diag_backward", (fr, fi), dev, align=16,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("diag_backward", (br, bi), dev, align=16,
                           dtypes=_st.STORAGE_DTYPES)
    bkind = _st.storage_kind(br.dtype)
    for tabs in (inv, fwd):
        _launch.check_tables("diag_backward", tabs, A, dev)
        _launch.check_cuda_f32("diag_backward", tabs, dev, align=16)
    if not with_q:
        fn = _launch.entry("diag", "dqc_diag_backward", _BACKWARD_ARGTYPES)
        code = fn(*(p.data_ptr() for p in planes), *_launch.table_ptrs(inv),
                  *_launch.table_ptrs(fwd), A, bkind, _st.storage_kind(fr.dtype),
                  _launch.stream(dev))
        _launch.raise_on_error(code, "diag", "diag_backward launch")
        diag_backward.launches += 1
        count_modes(diag_backward, br.dtype, "f32", "f32")
        _st.count_fwd(diag_backward, fr.dtype, "f32")
        return fr, fi, br, bi
    nblk, rows, part, qsl = _q_buffers(A, dev)
    fn = _launch.entry("diag", "dqc_diag_backward_q", _BACKWARD_Q_ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *_launch.table_ptrs(inv),
              *_launch.table_ptrs(fwd), *(r.data_ptr() for r in rows),
              part.data_ptr(), qsl.data_ptr(), A, nblk, bkind,
              _st.storage_kind(fr.dtype), _launch.stream(dev))
    _launch.raise_on_error(code, "diag", "diag_backward launch")
    diag_backward.launches += 1
    diag_backward.mode_launches["with_q"] += 1
    count_modes(diag_backward, br.dtype, "f32", "f32")
    _st.count_fwd(diag_backward, fr.dtype, "f32")
    return fr, fi, br, bi, qsl[0], qsl[1], *rows


diag_sweep.launches = 0
diag_sweep.mode_launches = {"fwd_bf16": 0}
diag_backward.launches = 0
diag_backward.mode_launches = {"with_q": 0, "bf16": 0, "f16": 0, "fwd_bf16": 0}
