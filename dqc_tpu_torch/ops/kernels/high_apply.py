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
density seed). The Hopper kernel is ``csrc/high_apply.cu``: at X = 128,
256 and 512 the tensor-core apply ``csrc/tc_apply.cuh`` (3xTF32 in the
"f32" dot mode, three bf16 products in bf16x3; every storage and mode),
counted also in ``mode_launches["tc"]``; at X = 8..64 its own CUDA-core
kernel on f32 planes, the bf16 / f16 / bf16x3 variants there built as a
library of their own, ``csrc/high_apply_fwd16.cu`` (bound by operations: X
complex multiply-adds per amplitude against 16 bytes, 24 in the seed
modes); :func:`high_apply_plain` is its plain PyTorch version.

:func:`high_apply` returns its output planes like ``dual_apply``: the
input planes (in place), the accumulator, or fresh planes on a CUDA
tensor; the plain version's fresh planes on a CPU tensor. The seed's
output planes may be stored reduced (``out_dtype`` or the accumulator's
dtype, as in ``dual_apply``), counted in ``mode_launches`` under the
storage's name. The input planes may be stored bfloat16 ("bf16" storage)
and the product run bf16x3 (``dot_mode``), counted as "fwd_bf16" and
"fwd_bf16x3", at every X, in place and as seeds; or float16 (the cotangent
under "f16", which the per-term fallback of a dense cross-group gate hands
the kernel as its input) into planes of that storage, at every X, counted
as "in_f16".
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels import _tc

Planes = Tuple[torch.Tensor, torch.Tensor]
KERNEL_X = (8, 16, 32, 64, 128)
WIDE_X = (256, 512)   # the merged top axis: every mode but a diagonal run
TC_X = (128, 256, 512)   # the tensor-core apply (csrc/tc_apply.cuh)


def kernel_route(X: int, dtype, dot_mode: str) -> str:
    """Which kernel a launch at X on input planes of ``dtype`` in
    ``dot_mode`` reaches: "tc" (the tensor-core apply in the "high_apply"
    library) at X >= 128, every storage and mode; below, "high_apply_fwd16"
    for 16-bit planes or bf16x3, else "high_apply" (the CUDA-core kernel)."""
    if X in TC_X:
        return "tc"
    if dtype != torch.float32 or dot_mode == "bf16x3":
        return "high_apply_fwd16"
    return "high_apply"


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
                     acc: Optional[Planes] = None, alias: bool = True,
                     out_dtype=None, dot_mode: str = "f32") -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmul in
    ``dot_mode``); fresh outputs, whatever ``alias`` says."""
    A1, X, M, _ = xr.shape
    x = _st.load_b(xr, xi)
    D = view_diag_run(diag_tables, xr.shape) if diag_tables is not None else None
    if D is not None and diag_first:
        x = x * D
    y = _st.cmatmul(torch.complex(e_r, e_i), x.reshape(A1, X, M * 128),
                    dot_mode).reshape(x.shape)
    if D is not None and not diag_first:
        y = y * D
    if acc is not None:
        acc = (acc[0].reshape(xr.shape), acc[1].reshape(xr.shape))
    return _st.seed_out(y.real, y.imag, conj, acc, out_dtype or xr.dtype)


_ARGTYPES = [_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 8 + [
    _launch.INT] * 5 + [_launch.LONG, _launch.INT, _launch.LONG, _launch.VOIDP]
_TC_ARGTYPES = [_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 7 + [
    _launch.INT] * 5 + [_launch.LONG, _launch.INT, _launch.LONG, _launch.VOIDP]


def launch_tc(xr, xi, yr, yi, op: torch.Tensor, dot_mode: str,
              diag_tables: Optional[Sequence[torch.Tensor]] = None,
              diag_first: bool = True, conj: bool = False,
              has_acc: bool = False) -> None:
    """One launch of the tensor-core apply (``dqc_tc_apply``) on the view
    ``(A1, X, ...)`` of ``xr``, X in ``TC_X``: ``y <- [y +] conj?([D] E x
    [D])``, ``op`` being E pre-split for ``dot_mode``
    (``_tc.tc_operator``). Checks nothing and counts nothing: the callers
    are :func:`high_apply` and the X = 256 / 512 adjoint's two in-place
    updates, each counted by its own wrapper."""
    A1, X = xr.shape[0], xr.shape[1]
    code = _launch.entry("high_apply", "dqc_tc_apply", _TC_ARGTYPES)(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        _st.storage_kind(xr.dtype), _st.storage_kind(yr.dtype), op.data_ptr(),
        *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
        int(diag_first), int(conj), int(has_acc), int(dot_mode == "bf16x3"),
        A1, X, xr[0, 0].numel(), _launch.stream(xr.device))
    _launch.raise_on_error(code, "high_apply", "high_apply launch")


def high_apply(xr, xi, e_r, e_i,
               diag_tables: Optional[Sequence[torch.Tensor]] = None,
               diag_first: bool = True, *, conj: bool = False,
               acc: Optional[Planes] = None, alias: bool = True,
               out_dtype=None, dot_mode: str = "f32") -> Planes:
    """``[acc +] conj?([D] E x [D])`` on the view ``(A1, X, M, 128)``, X in
    8..128, or 256 / 512 without a run; ``E`` an f32 real/imag pair (X, X);
    ``diag_tables`` the run's six f32 planes (tsl (128, 128); tas, tal (A,
    128) or their (A1, X, post, 128) view, planes.dhigh_view_tables) or
    None. A run needs M % 128 == 0. ``acc`` planes have the view's shape.
    ``out_dtype``: the storage of fresh output planes (``alias=False``);
    ``dot_mode``: the product's dot mode. The in-place sweep at X = 256 /
    512 is also counted in ``mode_launches["wide_inplace"]``, every launch
    of the tensor-core apply (X >= 128) in ``mode_launches["tc"]``."""
    if xr.dim() != 4 or xr.shape[-1] != 128 or xi.shape != xr.shape:
        raise ValueError(f"high_apply: planes must be (A1, X, M, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    A1, X, M, _ = xr.shape
    if diag_tables is not None and M % 128:
        raise ValueError(f"high_apply: a diag run needs M % 128 == 0, got M={M}")
    if X > 128 and diag_tables is not None:
        raise ValueError(f"high_apply: a diag run folds into X <= 128 only, "
                         f"got X={X}")
    _st.check_fwd("high_apply", xr, xi, dot_mode, f16=True)
    seed = acc is not None or not alias
    if seed:
        _st.check_apply_storage("high_apply", xr.dtype, (
            acc[0].dtype if acc is not None else out_dtype or xr.dtype))
    if xr.device.type == "cpu":
        return high_apply_plain(xr, xi, e_r, e_i, diag_tables, diag_first,
                                conj=conj, acc=acc, out_dtype=out_dtype,
                                dot_mode=dot_mode)
    if X not in KERNEL_X + WIDE_X:
        raise ValueError(f"high_apply: X={X} is not one of {KERNEL_X + WIDE_X}")
    _launch.check_cuda_f32("high_apply", (xr, xi), xr.device,
                           dtypes=_st.STORAGE_DTYPES)
    _launch.check_cuda_f32("high_apply", (e_r, e_i), xr.device)
    out = _launch.output_planes("high_apply", xr, xi, acc, alias, out_dtype,
                                _st.STORAGE_DTYPES)
    if tuple(e_r.shape) != (X, X) or tuple(e_i.shape) != (X, X):
        raise ValueError(f"high_apply: operator must be ({X}, {X})")
    _launch.check_tables("high_apply", diag_tables, A1 * X * M // 128, xr.device)
    route = kernel_route(X, xr.dtype, dot_mode)
    if route == "tc":
        launch_tc(xr, xi, *out, _tc.tc_operator(e_r, e_i, dot_mode), dot_mode,
                  diag_tables, diag_first, conj, acc is not None)
    else:
        fn = (_launch.entry("high_apply_fwd16", "dqc_high_apply_fwd16", _ARGTYPES)
              if route == "high_apply_fwd16"
              else _launch.entry("high_apply", "dqc_high_apply", _ARGTYPES))
        code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr(), _st.storage_kind(xr.dtype),
                  _st.storage_kind(out[0].dtype), e_r.data_ptr(), e_i.data_ptr(),
                  *_launch.table_ptrs(diag_tables), int(diag_tables is not None),
                  int(diag_first), int(conj), int(acc is not None),
                  int(dot_mode == "bf16x3"), A1, X, M * 128,
                  _launch.stream(xr.device))
        _launch.raise_on_error(code, "high_apply", "high_apply launch")
    high_apply.launches += 1
    if route == "tc":
        high_apply.mode_launches["tc"] += 1
    if X in WIDE_X and out[0] is xr:
        high_apply.mode_launches["wide_inplace"] += 1
    if seed:
        _st.count_storage(high_apply, out[0].dtype)
    _st.count_fwd(high_apply, xr.dtype, dot_mode)
    if xr.dtype == torch.float16:
        high_apply.mode_launches["in_f16"] += 1
    return out


high_apply.launches = 0
high_apply.mode_launches = {"in_f16": 0, "wide_inplace": 0, "tc": 0, "bf16": 0,
                            "f16": 0, "fwd_bf16": 0, "fwd_bf16x3": 0}
