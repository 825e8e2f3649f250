"""Fused diagonal-run sweep and its one-pass adjoint on f32 planes.

Replaces the TPU kernels ``diag_sweep_planes``
(``dqc_tpu/ops/pallas/diag.py:75``) and ``diag_backward_planes`` (``:154``)
without its Q reductions (``with_q=False``): a run of commuting diagonal
gates is one elementwise multiply by its total diagonal in factored form,
``D[a, s, l] = (tas[a, s] tal[a, l]) tsl[s, l]`` on planes ``(A, 128, 128)``
(ops/planes.py, plane_scan._DiagFactors):

* :func:`diag_sweep`: ``x *= D``;
* :func:`diag_backward`: ``fwd *= Dinv``, ``bwd *= D`` (the cotangent
  transport by ``D^T = D``).

The Hopper kernels are ``csrc/diag.cu`` (bound by bytes: one read and one
write of each plane, 16 or 32 bytes per amplitude, against 3 or 6 complex
multiplies); :func:`diag_sweep_plain` and :func:`diag_backward_plain` are
their plain PyTorch versions. On a CUDA tensor the wrappers update the
planes in place (the TPU kernels alias them) and return them; on a CPU
tensor they return the plain version's fresh planes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.dual_apply import diag_run


def _times(xr, xi, tables):
    y = torch.complex(xr, xi) * diag_run(tables)
    return y.real.contiguous(), y.imag.contiguous()


def diag_sweep_plain(xr, xi, *tables):
    """Plain PyTorch version of the sweep (complex64); fresh outputs."""
    return _times(xr, xi, tables)


def diag_backward_plain(fr, fi, br, bi, *tables):
    """Plain PyTorch version of the adjoint; ``tables`` are the run's
    inverse's six planes, then the run's. Fresh outputs."""
    return (*_times(fr, fi, tables[:6]), *_times(br, bi, tables[6:]))


def _check_planes(what: str, planes: Sequence[torch.Tensor]) -> int:
    x = planes[0]
    if x.dim() != 3 or tuple(x.shape[1:]) != (128, 128) or any(
            p.shape != x.shape for p in planes):
        raise ValueError(f"{what}: planes must be (A, 128, 128), got "
                         f"{[tuple(p.shape) for p in planes]}")
    return x.shape[0]


_SWEEP_ARGTYPES = [_launch.VOIDP] * 8 + [_launch.LONG, _launch.VOIDP]
_BACKWARD_ARGTYPES = [_launch.VOIDP] * 16 + [_launch.LONG, _launch.VOIDP]


def diag_sweep(xr, xi, tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i):
    """``x *= D`` on planes ``(A, 128, 128)``; the six f32 table planes
    ``tsl`` (128, 128) and ``tas``, ``tal`` (A, 128)."""
    tables = (tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)
    A = _check_planes("diag_sweep", (xr, xi))
    if xr.device.type == "cpu":
        return diag_sweep_plain(xr, xi, *tables)
    _launch.check_cuda_f32("diag_sweep", (xr, xi), xr.device, align=16)
    _launch.check_tables("diag_sweep", tables, A, xr.device)
    _launch.check_cuda_f32("diag_sweep", tables, xr.device, align=16)
    fn = _launch.entry("diag", "dqc_diag_sweep", _SWEEP_ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), *_launch.table_ptrs(tables), A,
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "diag", "diag_sweep launch")
    diag_sweep.launches += 1
    return xr, xi


def diag_backward(fr, fi, br, bi, isl_r, isl_i, ias_r, ias_i, ial_r, ial_i,
                  tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i, *,
                  with_q: bool = False):
    """``fwd *= Dinv``, ``bwd *= D`` on planes ``(A, 128, 128)``: the run's
    inverse's six table planes, then the run's. ``with_q`` (the pair-product
    reductions of a run with variable gates) is not ported."""
    if with_q:
        raise NotImplementedError(
            "diag_backward_planes with_q=True (the Q reductions of a variable "
            "diagonal run) is not ported to dqc_tpu_torch yet; see ROADMAP.md "
            "slice item 5")
    planes = (fr, fi, br, bi)
    inv = (isl_r, isl_i, ias_r, ias_i, ial_r, ial_i)
    fwd = (tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i)
    A = _check_planes("diag_backward", planes)
    if fr.device.type == "cpu":
        return diag_backward_plain(*planes, *inv, *fwd)
    _launch.check_cuda_f32("diag_backward", planes, fr.device, align=16)
    for tabs in (inv, fwd):
        _launch.check_tables("diag_backward", tabs, A, fr.device)
        _launch.check_cuda_f32("diag_backward", tabs, fr.device, align=16)
    fn = _launch.entry("diag", "dqc_diag_backward", _BACKWARD_ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *_launch.table_ptrs(inv),
              *_launch.table_ptrs(fwd), A, _launch.stream(fr.device))
    _launch.raise_on_error(code, "diag", "diag_backward launch")
    diag_backward.launches += 1
    return fr, fi, br, bi


diag_sweep.launches = 0
diag_backward.launches = 0
