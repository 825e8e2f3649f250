"""Kronecker-factorized one-pass adjoint on the merged top axis.

Replaces the TPU kernel ``block_backward_merged_fact``
(``dqc_tpu/ops/pallas/block_backward.py:670``, body ``_kernel_mtop_fact``
:534): the adjoint of ``merged_fact_apply`` (a sweep of ``Et (x) El`` on the
merged view ``(A1, Xt Xl, M, 128)``, merged row ``x = t Xl + d``). On the
forward planes ``F`` (the sweep's output) and the cotangent planes ``B``:

* ``fwdA = (Eti (x) I) F``, ``T0_top[x, y] = sum B[(x, d), c] fwdA[(y, d), c]``;
* ``fwdB = (I (x) Eli) F``, ``T0_low[x, y] = sum B[(e, x), c] fwdB[(e, y), c]``;
* ``F <- (Eti (x) I) fwdB = (Eti (x) Eli) F`` (the uncompute);
* ``B <- (Et^T (x) I)(I (x) El^T) B`` (the cotangent transport);

the pair grams holomorphic (no conjugation) and summed over every column,
``T0_top`` (Xt x Xt) and ``T0_low`` (Xl x Xl) being the restrictions of the
merged pair gram that the two blocks' cotangents need
(plane_scan._backward_hpair). The Hopper kernel is
``csrc/block_backward_merged_fact.cu`` (bound by operations: 3 Xl + 3 Xt
complex multiply-adds per amplitude against 32 bytes);
:func:`block_backward_merged_fact_plain` is its plain PyTorch version.

:func:`block_backward_merged_fact` updates ``(F, B)`` in place on a CUDA
tensor and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_top_r, T0_top_i, T0_low_r, T0_low_i)``.
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split
from dqc_tpu_torch.ops.kernels.gram import pair_sum
from dqc_tpu_torch.ops.kernels.merged_fact_apply import (
    check_kernel_widths,
    check_merged,
    top_combine,
)


def block_backward_merged_fact_plain(fr, fi, br, bi, elinv_r, elinv_i, el_r,
                                     el_i, etinv_r, etinv_i, et_r, et_i, *,
                                     x_top: int):
    """Plain PyTorch version of the kernel (complex64); fresh outputs."""
    A1, XX, M, _ = fr.shape
    Xl = el_r.shape[0]
    Q = M * 128
    v = (A1, x_top, Xl, Q)
    F = torch.complex(fr, fi).reshape(v)
    B = torch.complex(br, bi).reshape(v)
    Eli, El = torch.complex(elinv_r, elinv_i), torch.complex(el_r, el_i)
    Eti, Et = torch.complex(etinv_r, etinv_i), torch.complex(et_r, et_i)
    fA = top_combine(Eti, F)
    T0_top = pair_sum(B.reshape(A1, x_top, Xl * Q), fA.reshape(A1, x_top, Xl * Q))
    fB = torch.matmul(Eli, F)
    T0_low = pair_sum(B.reshape(A1 * x_top, Xl, Q), fB.reshape(A1 * x_top, Xl, Q))
    F = top_combine(Eti, fB)
    B = top_combine(Et.transpose(0, 1), torch.matmul(El.transpose(0, 1), B))
    return _split(F.reshape(fr.shape), B.reshape(fr.shape), T0_top, T0_low)


_ARGTYPES = [_launch.VOIDP] * 16 + [_launch.LONG, _launch.INT, _launch.LONG,
                                    _launch.INT, _launch.VOIDP]


def block_backward_merged_fact(fr, fi, br, bi, elinv_r, elinv_i, el_r, el_i,
                               etinv_r, etinv_i, et_r, et_i, *, x_top: int):
    """The adjoint step on the merged view ``(A1, Xt Xl, M, 128)``; the low
    operators (Eli, El) are f32 real/imag pairs (Xl, Xl), the top ones
    (Eti, Et) pairs (Xt, Xt)."""
    planes = (fr, fi, br, bi)
    low = (elinv_r, elinv_i, el_r, el_i)
    top = (etinv_r, etinv_i, et_r, et_i)
    A1, Xl, M = check_merged("block_backward_merged_fact", planes, low, top, x_top)
    if fr.device.type == "cpu":
        return block_backward_merged_fact_plain(*planes, *low, *top, x_top=x_top)
    check_kernel_widths("block_backward_merged_fact", x_top, Xl)
    _launch.check_cuda_f32("block_backward_merged_fact", planes + low + top,
                           fr.device)
    lib = "block_backward_merged_fact"
    ntiles = A1 * x_top * Xl * M * 128 // 8192
    nblk = min(ntiles, _launch.sm_count(fr.device))
    dev = fr.device
    part_low = torch.zeros((nblk, 2, Xl, Xl), dtype=torch.float32, device=dev)
    warps = _launch.entry(lib, "dqc_block_backward_merged_fact_warps", [])()
    part_top = torch.zeros((nblk, warps, 2, x_top, x_top), dtype=torch.float32,
                           device=dev)
    t0_low = torch.empty((2, Xl, Xl), dtype=torch.float32, device=dev)
    t0_top = torch.empty((2, x_top, x_top), dtype=torch.float32, device=dev)
    fn = _launch.entry(lib, "dqc_block_backward_merged_fact", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes + low + top), part_low.data_ptr(),
              part_top.data_ptr(), t0_low.data_ptr(), t0_top.data_ptr(), A1,
              x_top, M * 128, nblk, _launch.stream(dev))
    _launch.raise_on_error(code, lib, "block_backward_merged_fact launch")
    block_backward_merged_fact.launches += 1
    return (fr, fi, br, bi, t0_top[0], t0_top[1], t0_low[0], t0_low[1])


block_backward_merged_fact.launches = 0
