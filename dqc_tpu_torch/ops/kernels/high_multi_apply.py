"""Multi-term high + lane apply on f32 planes over the view ``(A1, X, M, 128)``.

Replaces the TPU kernel ``high_multi_apply_planes``
(``dqc_tpu/ops/pallas/high_apply.py:273``) in its in-place form:
``y = sum_t (E_t on axis X) (El_t on the lane axis) x``, with per-term
factors ``E_t`` (X x X) and ``El_t`` (128 x 128) — a dense gate with bits on
the lane group and on a high group, or on a span of high bits
(ops/planes.apply_cross_span; X = 8 for the CNOT ring's closing gate), in
one pass. The seed modes (``conj``, ``acc``, ``alias=False``) are not ported
and raise ``NotImplementedError`` on any device. The Hopper kernel is
``csrc/high_multi_apply.cu`` on ``csrc/multi_apply.cuh`` (bound by
operations: (128 + X) T complex multiply-adds per amplitude against 16
bytes); :func:`high_multi_apply_plain` is its plain PyTorch version.

:func:`high_multi_apply` consumes its input planes like
``dual_multi_apply``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.dual_multi_apply import check_in_place, check_terms
from dqc_tpu_torch.ops.kernels.high_apply import KERNEL_X

Planes = Tuple[torch.Tensor, torch.Tensor]


def high_multi_apply_plain(xr, xi, e_r, e_i, el_r, el_i, *,
                           conj: bool = False, acc=None,
                           alias: bool = True) -> Planes:
    """Plain PyTorch version of the kernel (complex64 matmuls, one term at a
    time); fresh outputs. The seed modes raise, as in the kernel."""
    check_in_place("high_multi_apply_planes", conj, acc, alias)
    A1, X, M, _ = xr.shape
    x = torch.complex(xr, xi)
    e = torch.complex(e_r, e_i)
    el = torch.complex(el_r, el_i)
    y = None
    for t in range(e.shape[0]):
        z = torch.matmul(x, el[t].transpose(0, 1)).reshape(A1, X, M * 128)
        yt = torch.matmul(e[t], z)
        y = yt if y is None else y + yt
    y = y.reshape(xr.shape)
    return y.real.contiguous(), y.imag.contiguous()


_ARGTYPES = [_launch.VOIDP] * 6 + [_launch.INT, _launch.LONG, _launch.INT,
                                   _launch.LONG, _launch.VOIDP]


def high_multi_apply(xr, xi, e_r, e_i, el_r, el_i, *, conj: bool = False,
                     acc=None, alias: bool = True) -> Planes:
    """``sum_t E_t x El_t^T`` on the view ``(A1, X, M, 128)``, X in 8..128,
    in place; ``e_*`` stacked ``(T, X, X)``, ``el_*`` stacked
    ``(T, 128, 128)``, f32 real/imag planes."""
    check_in_place("high_multi_apply_planes", conj, acc, alias)
    if xr.dim() != 4 or xr.shape[-1] != 128 or xi.shape != xr.shape:
        raise ValueError(f"high_multi_apply: planes must be (A1, X, M, 128), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    A1, X, M, _ = xr.shape
    T = e_r.shape[0] if e_r.dim() == 3 else 0
    if T < 1:
        raise ValueError("high_multi_apply: factors must be stacked (T, ...)")
    check_terms("high_multi_apply", (e_r, e_i), T, (X, X))
    check_terms("high_multi_apply", (el_r, el_i), T, (128, 128))
    if xr.device.type == "cpu":
        return high_multi_apply_plain(xr, xi, e_r, e_i, el_r, el_i)
    if X not in KERNEL_X or M % (128 // X):
        raise ValueError(f"high_multi_apply: X={X} must be one of {KERNEL_X} "
                         f"and M={M} a multiple of {128 // max(X, 1)}")
    ops = (e_r, e_i, el_r, el_i)
    _launch.check_cuda_f32("high_multi_apply", (xr, xi), xr.device, align=16)
    _launch.check_cuda_f32("high_multi_apply", ops, xr.device)
    # the kernel reads the factors transposed, so that its tile loads coalesce
    et_r, et_i, elt_r, elt_i = (o.transpose(1, 2).contiguous() for o in ops)
    fn = _launch.entry("high_multi_apply", "dqc_high_multi_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), elt_r.data_ptr(), elt_i.data_ptr(),
              et_r.data_ptr(), et_i.data_ptr(), T, A1, X, M,
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "high_multi_apply", "high_multi_apply launch")
    high_multi_apply.launches += 1
    return xr, xi


high_multi_apply.launches = 0
