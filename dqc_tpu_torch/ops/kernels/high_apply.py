"""High-group apply on f32 planes: ``y = E . x`` along X of ``(A1, X, M, 128)``.

Replaces the TPU kernel ``high_group_apply_planes``
(``dqc_tpu/ops/pallas/high_apply.py:76``): a dense ``X x X`` operator on
the contracted group axis of the high view, with an optional fused
diagonal run multiplied before (``diag_first``) or after the product, and
the density-seed modes ``conj`` / ``acc`` / ``alias=False`` of
``dual_apply``. The run's tables stay canonical — ``tsl (128, 128)``,
``tas``/``tal`` ``(A, 128)`` read at ``a = (i X + x) post + p`` for view
element ``(i, x, m = p 128 + s, l)``. X is 8..128, or 256 / 512 on the
merged top axis of a tiny top group (ops/planes._merged_view), there
without a run, in place (a lone top-group block as ``E (x) I``, the
unfactorized hpair's merged operator) or in the seed modes (the merged-top
density seed). The Hopper kernel is ``csrc/high_apply.cu``, and
``csrc/wide_apply.cuh`` at X = 256 / 512 (bound by operations: X complex
multiply-adds per amplitude against 16 bytes, 24 in the seed modes);
:func:`high_apply_plain` is its plain PyTorch version.

:func:`high_apply` returns its output planes like ``dual_apply``: the
input planes (in place), the accumulator, or fresh planes on a CUDA
tensor; the plain version's fresh planes on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.dual_apply import _seed_out

Planes = Tuple[torch.Tensor, torch.Tensor]
KERNEL_X = (8, 16, 32, 64, 128)
WIDE_X = (256, 512)   # the merged top axis: every mode but a diagonal run


def view_diag_run(diag_tables: Sequence[torch.Tensor], shape) -> torch.Tensor:
    """Complex D on the high view ``shape = (A1, X, M, 128)``."""
    A1, X, M, _ = shape
    post = M // 128
    tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i = diag_tables
    tas = torch.complex(tas_r, tas_i).reshape(A1, X, post, 128, 1)
    tal = torch.complex(tal_r, tal_i).reshape(A1, X, post, 1, 128)
    tsl = torch.complex(tsl_r, tsl_i)
    return ((tas * tal) * tsl).reshape(A1, X, M, 128)


def high_apply_plain(xr, xi, e_r, e_i,
                     diag_tables: Optional[Sequence[torch.Tensor]] = None,
                     diag_first: bool = True, *, conj: bool = False,
                     acc: Optional[Planes] = None, alias: bool = True) -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmul); fresh
    outputs, whatever ``alias`` says."""
    A1, X, M, _ = xr.shape
    x = torch.complex(xr, xi)
    D = view_diag_run(diag_tables, xr.shape) if diag_tables is not None else None
    if D is not None and diag_first:
        x = x * D
    y = torch.matmul(torch.complex(e_r, e_i),
                     x.reshape(A1, X, M * 128)).reshape(x.shape)
    if D is not None and not diag_first:
        y = y * D
    if acc is not None:
        acc = (acc[0].reshape(xr.shape), acc[1].reshape(xr.shape))
    return _seed_out(y.real, y.imag, conj, acc)


_ARGTYPES = [_launch.VOIDP] * 12 + [_launch.INT] * 4 + [
    _launch.LONG, _launch.INT, _launch.LONG, _launch.VOIDP]


def high_apply(xr, xi, e_r, e_i,
               diag_tables: Optional[Sequence[torch.Tensor]] = None,
               diag_first: bool = True, *, conj: bool = False,
               acc: Optional[Planes] = None, alias: bool = True) -> Planes:
    """``[acc +] conj?([D] E x [D])`` on the view ``(A1, X, M, 128)``, X in
    8..128, or 256 / 512 without a run; ``E`` an f32 real/imag pair (X, X);
    ``diag_tables`` the run's six f32 planes (tsl (128, 128); tas, tal (A,
    128) or their (A1, X, post, 128) view, planes.dhigh_view_tables) or
    None. A run needs M % 128 == 0. ``acc`` planes have the view's shape.
    The in-place sweep at X = 256 / 512 is also counted in
    ``mode_launches["wide_inplace"]``."""
    if xr.dim() != 4 or xr.shape[-1] != 128 or xi.shape != xr.shape:
        raise ValueError(f"high_apply: planes must be (A1, X, M, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    A1, X, M, _ = xr.shape
    if diag_tables is not None and M % 128:
        raise ValueError(f"high_apply: a diag run needs M % 128 == 0, got M={M}")
    if X > 128 and diag_tables is not None:
        raise ValueError(f"high_apply: a diag run folds into X <= 128 only, "
                         f"got X={X}")
    if xr.device.type == "cpu":
        return high_apply_plain(xr, xi, e_r, e_i, diag_tables, diag_first,
                                conj=conj, acc=acc)
    if X not in KERNEL_X + WIDE_X:
        raise ValueError(f"high_apply: X={X} is not one of {KERNEL_X + WIDE_X}")
    _launch.check_cuda_f32("high_apply", (xr, xi, e_r, e_i), xr.device)
    out = _launch.output_planes("high_apply", xr, xi, acc, alias)
    if tuple(e_r.shape) != (X, X) or tuple(e_i.shape) != (X, X):
        raise ValueError(f"high_apply: operator must be ({X}, {X})")
    _launch.check_tables("high_apply", diag_tables, A1 * X * M // 128, xr.device)
    fn = _launch.entry("high_apply", "dqc_high_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
              e_r.data_ptr(), e_i.data_ptr(), *_launch.table_ptrs(diag_tables),
              int(diag_tables is not None), int(diag_first), int(conj),
              int(acc is not None), A1, X, M * 128, _launch.stream(xr.device))
    _launch.raise_on_error(code, "high_apply", "high_apply launch")
    high_apply.launches += 1
    if X in WIDE_X and out[0] is xr:
        high_apply.mode_launches["wide_inplace"] += 1
    return out


high_apply.launches = 0
high_apply.mode_launches = {"wide_inplace": 0}
