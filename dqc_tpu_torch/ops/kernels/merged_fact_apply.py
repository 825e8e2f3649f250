"""Kronecker-factorized apply on the merged top axis: ``y = (Et (x) El) x``.

Replaces the TPU kernel ``merged_fact_apply_planes``
(``dqc_tpu/ops/pallas/high_apply.py:190``, body ``_kernel_fact`` :148): when
the top group is tiny (Xt = 2 or 4 wide), a dense block on it and one on the
group below run as ONE sweep on the merged view ``(A1, Xt Xl, M, 128)``,
merged row ``x = t Xl + d`` (ops/planes._merged_view), without expanding
the ``(Xt Xl)^2`` operator: the low factor ``El`` (Xl x Xl) acts within each
top slice ``t``, the top factor ``Et`` (Xt x Xt) mixes the slices
elementwise. The Hopper kernel is ``csrc/merged_fact_apply.cu`` (bound by
operations: Xl + Xt complex multiply-adds per amplitude against 16 bytes);
:func:`merged_fact_apply_plain` is its plain PyTorch version.

:func:`merged_fact_apply` updates the planes in place on a CUDA tensor (the
TPU kernel aliases them) and returns them; on a CPU tensor it returns the
plain version's fresh planes.
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch

KERNEL_X_TOP = (2, 4)
KERNEL_X_LOW = 128


def top_combine(Et: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``y[i, a] = sum_b Et[a, b] v[i, b]`` over the top axis of ``v``
    ``(A1, Xt, ...)``, one complex scalar combination per output slice."""
    return torch.stack([sum(Et[a, b] * v[:, b] for b in range(v.shape[1]))
                        for a in range(Et.shape[0])], dim=1)


def merged_fact_apply_plain(xr, xi, el_r, el_i, et_r, et_i, *, x_top: int):
    """Plain PyTorch version of the kernel (complex64); fresh outputs."""
    A1, XX, M, _ = xr.shape
    Xl = el_r.shape[0]
    x = torch.complex(xr, xi).reshape(A1, x_top, Xl, M * 128)
    v = torch.matmul(torch.complex(el_r, el_i), x)
    y = top_combine(torch.complex(et_r, et_i), v).reshape(xr.shape)
    return y.real.contiguous(), y.imag.contiguous()


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


_ARGTYPES = [_launch.VOIDP] * 6 + [_launch.LONG, _launch.INT, _launch.LONG,
                                   _launch.VOIDP]


def merged_fact_apply(xr, xi, el_r, el_i, et_r, et_i, *, x_top: int):
    """``(Et (x) El) x`` in place on the merged view ``(A1, Xt Xl, M, 128)``;
    ``el`` an f32 real/imag pair (Xl, Xl), ``et`` one (Xt, Xt)."""
    A1, Xl, M = check_merged("merged_fact_apply", (xr, xi), (el_r, el_i),
                             (et_r, et_i), x_top)
    if xr.device.type == "cpu":
        return merged_fact_apply_plain(xr, xi, el_r, el_i, et_r, et_i,
                                       x_top=x_top)
    check_kernel_widths("merged_fact_apply", x_top, Xl)
    _launch.check_cuda_f32("merged_fact_apply", (xr, xi, el_r, el_i, et_r, et_i),
                           xr.device)
    fn = _launch.entry("merged_fact_apply", "dqc_merged_fact_apply", _ARGTYPES)
    code = fn(xr.data_ptr(), xi.data_ptr(), el_r.data_ptr(), el_i.data_ptr(),
              et_r.data_ptr(), et_i.data_ptr(), A1, x_top, M * 128,
              _launch.stream(xr.device))
    _launch.raise_on_error(code, "merged_fact_apply", "merged_fact_apply launch")
    merged_fact_apply.launches += 1
    return xr, xi


merged_fact_apply.launches = 0
