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
complex multiply-adds per amplitude against 32 bytes): the low factor runs
``csrc/tc_adjoint.cuh``'s one-pass step on the tensor cores (3xTF32 in the
"f32" dot mode, three bf16 passes in bf16x3), handed ``Eli`` and ``El^T``
pre-split in mma fragment order (:func:`block_backward_dual.step_operators`),
the top factor and ``T0_top`` two passes of its own on the CUDA cores; every
launch counts in ``mode_launches["tc"]``.
:func:`block_backward_merged_fact_plain` is its plain PyTorch version.

:func:`block_backward_merged_fact` updates ``(F, B)`` in place on a CUDA
tensor and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_top_r, T0_top_i, T0_low_r, T0_low_i)``.

The cotangent planes ``B`` may be stored as float32, bfloat16 or float16
and the forward planes ``F`` as float32 or bfloat16 ("bf16" storage); the
low uncompute runs in ``dot_mode``, the low transport and ``T0_low`` in
``bwd_mode`` / ``gram_mode`` ("f32" or "bf16x3"), the top factor and
``T0_top`` in f32 whatever the modes, as in the TPU kernel; counted in
``mode_launches`` as in ``block_backward_dual``. The three modes are
independent (``ops/planes.backward_merged_top_fact`` hands it an f32
transport whenever the backward mode resolves to bf16x3, as the JAX
package's planes layer clamps this kernel's transport).
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels._storage import (check_modes, count_modes, load_b,
                                                store_b)
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split, step_operators
from dqc_tpu_torch.ops.kernels.gram import pair_sum
from dqc_tpu_torch.ops.kernels.merged_fact_apply import (
    check_kernel_widths,
    check_merged,
    top_combine,
)


def block_backward_merged_fact_plain(fr, fi, br, bi, elinv_r, elinv_i, el_r,
                                     el_i, etinv_r, etinv_i, et_r, et_i, *,
                                     x_top: int, bwd_mode: str = "f32",
                                     gram_mode: str = "f32",
                                     dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64, the low uncompute,
    the low transport and T0_low in the dot modes, F and B decoded on load
    and encoded on store); fresh outputs."""
    A1, XX, M, _ = fr.shape
    Xl = el_r.shape[0]
    Q = M * 128
    v = (A1, x_top, Xl, Q)
    F = load_b(fr, fi).reshape(v)
    B = load_b(br, bi).reshape(v)
    Eli, El = torch.complex(elinv_r, elinv_i), torch.complex(el_r, el_i)
    Eti, Et = torch.complex(etinv_r, etinv_i), torch.complex(et_r, et_i)
    fA = top_combine(Eti, F)
    T0_top = pair_sum(B.reshape(A1, x_top, Xl * Q), fA.reshape(A1, x_top, Xl * Q))
    fB = _st.cmatmul(Eli, F, dot_mode)
    T0_low = _st.pair_sum(B.reshape(A1 * x_top, Xl, Q),
                          fB.reshape(A1 * x_top, Xl, Q), gram_mode)
    F = top_combine(Eti, fB)
    B = top_combine(Et.transpose(0, 1),
                    _st.cmatmul(El.transpose(0, 1), B, bwd_mode))
    return (*store_b(F.reshape(fr.shape), fr.dtype),
            *store_b(B.reshape(fr.shape), br.dtype), *_split(T0_top, T0_low))


# planes, the two pre-split low operators, the top operators, scratch and
# outputs; A1, Xt, Q, nblk; kinds and modes
_ARGTYPES = ([_launch.VOIDP] * 14 + [_launch.LONG, _launch.INT, _launch.LONG]
             + [_launch.INT] * 6 + [_launch.VOIDP])


def block_backward_merged_fact(fr, fi, br, bi, elinv_r, elinv_i, el_r, el_i,
                               etinv_r, etinv_i, et_r, et_i, *, x_top: int,
                               bwd_mode: str = "f32", gram_mode: str = "f32",
                               dot_mode: str = "f32"):
    """The adjoint step on the merged view ``(A1, Xt Xl, M, 128)``; the low
    operators (Eli, El) are f32 real/imag pairs (Xl, Xl), the top ones
    (Eti, Et) pairs (Xt, Xt). ``B`` is stored as float32, bfloat16 or
    float16, ``F`` as float32 or bfloat16; ``dot_mode``, ``bwd_mode`` /
    ``gram_mode`` are the low uncompute's, the low transport's and
    T0_low's dot modes. Every launch also counts as
    ``mode_launches["tc"]``."""
    planes = (fr, fi, br, bi)
    low = (elinv_r, elinv_i, el_r, el_i)
    top = (etinv_r, etinv_i, et_r, et_i)
    A1, Xl, M = check_merged("block_backward_merged_fact", planes, low, top, x_top)
    check_modes("block_backward_merged_fact", fr, br, bi, bwd_mode, gram_mode,
                dot_mode)
    if fi.dtype != fr.dtype:
        raise TypeError("block_backward_merged_fact: forward planes of two dtypes")
    if fr.device.type == "cpu":
        return block_backward_merged_fact_plain(
            *planes, *low, *top, x_top=x_top, bwd_mode=bwd_mode,
            gram_mode=gram_mode, dot_mode=dot_mode)
    check_kernel_widths("block_backward_merged_fact", x_top, Xl)
    # the tensor-core step loads and stores four neighbouring elements
    _launch.check_cuda_f32("block_backward_merged_fact", (fr, fi), fr.device,
                           align=16, dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("block_backward_merged_fact", low + top, fr.device)
    _launch.check_cuda_f32("block_backward_merged_fact", (br, bi), fr.device,
                           align=16, dtypes=_st.STORAGE_DTYPES)
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
    tc_ops = step_operators(*low, dot_mode, bwd_mode, fr.dtype, br.dtype)
    fn = _launch.entry(lib, "dqc_block_backward_merged_fact", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in tc_ops),
              *(p.data_ptr() for p in top), part_low.data_ptr(),
              part_top.data_ptr(), t0_low.data_ptr(), t0_top.data_ptr(), A1,
              x_top, M * 128, nblk, _st.storage_kind(br.dtype),
              int(bwd_mode == "bf16x3"), int(gram_mode == "bf16x3"),
              _st.storage_kind(fr.dtype), int(dot_mode == "bf16x3"),
              _launch.stream(dev))
    _launch.raise_on_error(code, lib, "block_backward_merged_fact launch")
    block_backward_merged_fact.launches += 1
    block_backward_merged_fact.mode_launches["tc"] += 1
    count_modes(block_backward_merged_fact, br.dtype, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_merged_fact, fr.dtype, dot_mode)
    return (fr, fi, br, bi, t0_top[0], t0_top[1], t0_low[0], t0_low[1])


block_backward_merged_fact.launches = 0
block_backward_merged_fact.mode_launches = {"tc": 0, "bf16": 0, "f16": 0, "bf16x3": 0,
                                            "gram_bf16x3": 0, "fwd_bf16": 0,
                                            "fwd_bf16x3": 0}
