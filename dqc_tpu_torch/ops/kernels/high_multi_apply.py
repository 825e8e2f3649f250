"""Multi-term high + lane apply on the planes over the view ``(A1, X, M, 128)``.

Replaces the TPU kernel ``high_multi_apply_planes``
(``dqc_tpu/ops/pallas/high_apply.py:273``) in its in-place form:
``y = sum_t (E_t on axis X) (El_t on the lane axis) x``, with per-term
factors ``E_t`` (X x X) and ``El_t`` (128 x 128) — a dense gate with bits on
the lane group and on a high group, or on a span of high bits
(ops/planes.apply_cross_span; X = 8 for the CNOT ring's closing gate), in
one pass, with the density-seed modes of ``dual_multi_apply`` (``conj``,
``acc``, ``alias=False``: the seed of a density across the lane group and a
high group, on the span view). The Hopper kernel is the multi-term dual
apply's (``csrc/dual_multi_apply.cu``, its C entry
``dqc_high_multi_apply``): a tile of 128 rows (128 / X consecutive m of one
i) by 128 lanes, per term the lane product on the tensor cores as the dual
form's and the group product block-diagonal (X = 8 as ``diag(E_t, E_t)``),
both on ``mma.sync`` (3xTF32 in the "f32" dot mode, bf16x3); bound by
operations: (128 + X) T complex multiply-adds per amplitude against 16
bytes, 7.08 ms at X = 8, T = 2 on 2^29 f32 amplitudes. Every launch counts
in ``mode_launches["tc"]``. :func:`high_multi_apply_plain` is its plain
PyTorch version.

:func:`high_multi_apply` consumes its input planes (unless ``alias=False``
or ``acc``) like ``dual_multi_apply``, and takes the plane storages and
the dot modes of ``dual_multi_apply`` (counted in ``mode_launches`` as
there).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels.dual_multi_apply import (check_terms, count_modes,
                                                       operators, out_storage)
from dqc_tpu_torch.ops.kernels.high_apply import KERNEL_X

Planes = Tuple[torch.Tensor, torch.Tensor]


def high_multi_apply_plain(xr, xi, e_r, e_i, el_r, el_i, *,
                           conj: bool = False, acc=None, alias: bool = True,
                           out_dtype=None, dot_mode: str = "f32") -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls in
    ``dot_mode``, one term at a time, the lane product first, the planes
    decoded and encoded as the kernel does); fresh outputs in the kernel's
    storage, whatever ``alias`` says."""
    A1, X, M, _ = xr.shape
    x = _st.load_b(xr, xi)
    e = torch.complex(e_r, e_i)
    el = torch.complex(el_r, el_i)
    y = None
    for t in range(e.shape[0]):
        z = _st.cmatmul(x, el[t].transpose(0, 1), dot_mode).reshape(A1, X, M * 128)
        yt = _st.cmatmul(e[t], z, dot_mode)
        y = yt if y is None else y + yt
    y = y.reshape(xr.shape)
    if acc is not None:
        acc = (acc[0].view(xr.shape), acc[1].view(xr.shape))
    return _st.seed_out(y.real, y.imag, conj, acc, out_dtype or xr.dtype)


# x, y, kinds, x3, El_t and E_t pre-split, El_t in three parts, T, conj,
# has_acc, A1, X, M, stream
_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 3 + [_launch.VOIDP] * 2
             + [_launch.INT] * 4 + [_launch.LONG, _launch.INT, _launch.LONG,
                                    _launch.VOIDP])


def high_multi_apply(xr, xi, e_r, e_i, el_r, el_i, *, conj: bool = False,
                     acc=None, alias: bool = True, out_dtype=None,
                     dot_mode: str = "f32") -> Planes:
    """``[acc +] conj?(sum_t E_t x El_t^T)`` on the view ``(A1, X, M, 128)``,
    X in 8..128; ``e_*`` stacked ``(T, X, X)``, ``el_*`` stacked
    ``(T, 128, 128)``, f32 real/imag planes. ``out_dtype``: the storage of
    fresh output planes (``alias=False``); ``dot_mode``: the products'
    (the forward dot mode)."""
    if xr.dim() != 4 or xr.shape[-1] != 128 or xi.shape != xr.shape:
        raise ValueError(f"high_multi_apply: planes must be (A1, X, M, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    A1, X, M, _ = xr.shape
    T = e_r.shape[0] if e_r.dim() == 3 else 0
    if T < 1:
        raise ValueError("high_multi_apply: factors must be stacked (T, ...)")
    check_terms("high_multi_apply", (e_r, e_i), T, (X, X))
    check_terms("high_multi_apply", (el_r, el_i), T, (128, 128))
    _st.check_apply_storage("high_multi_apply", xr.dtype,
                            out_storage(xr, acc, alias, out_dtype))
    _st.check_dot_mode("high_multi_apply", dot_mode)
    if xr.device.type == "cpu":
        return high_multi_apply_plain(xr, xi, e_r, e_i, el_r, el_i, conj=conj,
                                      acc=acc,
                                      out_dtype=None if alias else out_dtype,
                                      dot_mode=dot_mode)
    if X not in KERNEL_X or M % (128 // X):
        raise ValueError(f"high_multi_apply: X={X} must be one of {KERNEL_X} "
                         f"and M={M} a multiple of {128 // max(X, 1)}")
    ops = (e_r, e_i, el_r, el_i)
    _launch.check_cuda_f32("high_multi_apply", (xr, xi), xr.device, align=16,
                           dtypes=_st.STORAGE_DTYPES)
    out = _launch.output_planes("high_multi_apply", xr, xi, acc, alias,
                                out_dtype, _st.STORAGE_DTYPES)
    _launch.check_cuda_f32("high_multi_apply", ops, xr.device)
    op_l, op_e = operators(el_r, el_i, e_r, e_i, dot_mode, xr.dtype)
    fn = _launch.entry("dual_multi_apply", "dqc_high_multi_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
              _st.storage_kind(xr.dtype), _st.storage_kind(out[0].dtype),
              int(dot_mode == "bf16x3"), op_l.data_ptr(), op_e.data_ptr(),
              int(op_l.shape[3] == 6), T, int(conj), int(acc is not None), A1, X, M,
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "high_multi_apply", "high_multi_apply launch")
    high_multi_apply.launches += 1
    high_multi_apply.mode_launches["tc"] += 1
    count_modes(high_multi_apply, xr.dtype, out[0].dtype,
                conj or acc is not None or not alias, dot_mode)
    return out


high_multi_apply.launches = 0
high_multi_apply.mode_launches = {"tc": 0, "seed": 0, "bf16": 0, "f16": 0,
                                  "fwd_bf16": 0, "fwd_bf16x3": 0}
