"""Kronecker-factorized apply on the merged top axis: ``y = (Et (x) El) x``.

Replaces the TPU kernel ``merged_fact_apply_planes``
(``dqc_tpu/ops/pallas/high_apply.py:190``, body ``_kernel_fact`` :148): when
the top group is tiny (Xt = 2 or 4 wide), a dense block on it and one on the
group below run as ONE sweep on the merged view ``(A1, Xt Xl, M, 128)``,
merged row ``x = t Xl + d`` (ops/planes._merged_view), without expanding
the ``(Xt Xl)^2`` operator: the low factor ``El`` (Xl x Xl) acts within each
top slice ``t``, the top factor ``Et`` (Xt x Xt) mixes the slices
elementwise. The Hopper kernel is ``csrc/merged_fact_apply.cu`` (bound by
operations: Xl + Xt complex multiply-adds per amplitude against 16 bytes):
the low factor on the tensor cores (``csrc/tc_adjoint.cuh``'s tile product
on tiles of the Xt slices; 3xTF32 in the "f32" dot mode, three bf16 passes
in bf16x3), handed ``El`` pre-split in mma fragment order
(``_tc.tc_operator``), the top factor's combinations on the CUDA cores as
the tiles load; every launch counts in ``mode_launches["tc"]``.
:func:`merged_fact_apply_plain` is its plain PyTorch version.

:func:`merged_fact_apply` updates the planes in place on a CUDA tensor (the
TPU kernel aliases them) and returns them; on a CPU tensor it returns the
plain version's fresh planes. The planes are float32 or bfloat16 ("bf16"
storage: decoded on load, rounded to nearest even on store) and the low
factor's product runs in ``dot_mode`` ("f32" or "bf16x3"; the top factor's
scalar combinations are f32 whatever the mode, as in ``_kernel_fact``),
counted in ``mode_launches`` as "fwd_bf16" and "fwd_bf16x3". The kernel
applies the top factor first (the two commute) and the plain version does
the same, so that under bf16x3 both split the same operand. float16 planes
(a cotangent stored "f16", which no path hands this kernel) raise
``NotImplementedError`` (ROADMAP.md queue B item 1).
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels import _tc

KERNEL_X_TOP = (2, 4)
KERNEL_X_LOW = 128


def top_combine(Et: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``y[i, a] = sum_b Et[a, b] v[i, b]`` over the top axis of ``v``
    ``(A1, Xt, ...)``, one complex scalar combination per output slice."""
    return torch.stack([sum(Et[a, b] * v[:, b] for b in range(v.shape[1]))
                        for a in range(Et.shape[0])], dim=1)


def merged_fact_apply_plain(xr, xi, el_r, el_i, et_r, et_i, *, x_top: int,
                            dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64, the low factor's
    product in ``dot_mode``); fresh outputs of the input's storage."""
    A1, XX, M, _ = xr.shape
    Xl = el_r.shape[0]
    x = _st.load_b(xr, xi).reshape(A1, x_top, Xl, M * 128)
    if dot_mode == "f32":
        v = torch.matmul(torch.complex(el_r, el_i), x)
        y = top_combine(torch.complex(et_r, et_i), v)
    else:
        v = top_combine(torch.complex(et_r, et_i), x)
        y = _st.cmatmul(torch.complex(el_r, el_i), v, dot_mode)
    return _st.store_b(y.reshape(xr.shape), xr.dtype)


def check_merged(what: str, planes, low_ops, top_ops, x_top: int):
    """Shapes of a merged-axis call: planes ``(A1, Xt Xl, M, 128)``, low
    operators (Xl, Xl), top operators (Xt, Xt). Returns ``(A1, Xl, M)``."""
    x = planes[0]
    if x.dim() != 4 or x.shape[-1] != 128 or any(p.shape != x.shape for p in planes):
        raise ValueError(f"{what}: planes must be (A1, Xt Xl, M, 128), got "
                         f"{[tuple(p.shape) for p in planes]}")
    A1, XX, M, _ = x.shape
    Xl = low_ops[0].shape[0]
    if XX != x_top * Xl:
        raise ValueError(f"{what}: merged axis {XX} != x_top {x_top} x Xl {Xl}")
    if any(tuple(o.shape) != (Xl, Xl) for o in low_ops) or any(
            tuple(o.shape) != (x_top, x_top) for o in top_ops):
        raise ValueError(f"{what}: operators must be ({Xl}, {Xl}) and "
                         f"({x_top}, {x_top})")
    return A1, Xl, M


def check_kernel_widths(what: str, x_top: int, Xl: int) -> None:
    if x_top not in KERNEL_X_TOP or Xl != KERNEL_X_LOW:
        raise ValueError(f"{what}: the kernel takes x_top in {KERNEL_X_TOP} "
                         f"and Xl = {KERNEL_X_LOW}, got {x_top} and {Xl}")


_ARGTYPES = [_launch.VOIDP] * 5 + [_launch.LONG, _launch.INT, _launch.LONG,
                                   _launch.INT, _launch.INT, _launch.VOIDP]


def merged_fact_apply(xr, xi, el_r, el_i, et_r, et_i, *, x_top: int,
                      dot_mode: str = "f32"):
    """``(Et (x) El) x`` in place on the merged view ``(A1, Xt Xl, M, 128)``
    of planes stored as float32 or bfloat16; ``el`` an f32 real/imag pair
    (Xl, Xl), ``et`` one (Xt, Xt); ``dot_mode`` the low factor's."""
    A1, Xl, M = check_merged("merged_fact_apply", (xr, xi), (el_r, el_i),
                             (et_r, et_i), x_top)
    _st.check_fwd("merged_fact_apply", xr, xi, dot_mode)
    if xr.device.type == "cpu":
        return merged_fact_apply_plain(xr, xi, el_r, el_i, et_r, et_i,
                                       x_top=x_top, dot_mode=dot_mode)
    check_kernel_widths("merged_fact_apply", x_top, Xl)
    _launch.check_cuda_f32("merged_fact_apply", (xr, xi), xr.device, align=16,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("merged_fact_apply", (el_r, el_i, et_r, et_i),
                           xr.device)
    op = _tc.tc_operator(el_r, el_i, dot_mode)
    fn = _launch.entry("merged_fact_apply", "dqc_merged_fact_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), op.data_ptr(), et_r.data_ptr(),
              et_i.data_ptr(), A1, x_top, M * 128,
              _st.storage_kind(xr.dtype), int(dot_mode == "bf16x3"),
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "merged_fact_apply", "merged_fact_apply launch")
    merged_fact_apply.launches += 1
    merged_fact_apply.mode_launches["tc"] += 1
    _st.count_fwd(merged_fact_apply, xr.dtype, dot_mode)
    return xr, xi


merged_fact_apply.launches = 0
merged_fact_apply.mode_launches = {"tc": 0, "fwd_bf16": 0, "fwd_bf16x3": 0}
