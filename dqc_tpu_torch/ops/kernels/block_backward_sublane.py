"""One-pass adjoint step of an unpaired sublane-group block on the planes.

Replaces the TPU kernel ``block_backward_sublane``
(``dqc_tpu/ops/pallas/block_backward.py:184``): on the forward planes ``F``
and the cotangent planes ``B`` ``(A, 128, 128) x 2``, with the sublane-group
operator ``E`` (qubits 7..13, the middle axis),

``F <- Einv F``, ``T0[x, y] += sum B[a, x, c] F[a, y, c]``, ``B <- E^T B``

with the pair gram holomorphic (no conjugation; ``B`` the incoming
cotangent, ``F`` the uncomputed planes). The Hopper kernel is the dual
adjoint's sublane step alone, built in its library
(``csrc/block_backward_dual.cu``'s ``dqc_block_backward_sublane`` on
``csrc/tc_adjoint.cuh``): the three products on the tensor cores, 3xTF32
in the "f32" dot mode or three bf16 products in bf16x3 (bound by the
tensor cores' rate: 384 complex multiply-adds per amplitude); each launch
hands it ``Einv`` and ``E^T`` pre-split in mma fragment order and counts in
``mode_launches["tc"]``. :func:`block_backward_sublane_plain` is its plain
PyTorch version.

:func:`block_backward_sublane` updates ``(F, B)`` in place on a CUDA tensor
and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_r, T0_i)``.

The cotangent planes ``B`` may be stored as float32, bfloat16 or float16
(the kernels' codec, ops/kernels/_storage.py), and the transport and the
pair gram run in ``bwd_mode`` / ``gram_mode`` ("f32" or "bf16x3"), as the
TPU kernel's ``bwd_dot_mode`` and ``gram_dot_mode``; such launches are also
counted in ``mode_launches`` ("bf16" / "f16", "bf16x3", "gram_bf16x3"). The
forward planes ``F`` may be stored as float32 or bfloat16 ("bf16" storage:
one load and one store, the pair gram on the unrounded uncompute, as in
the TPU kernel) and the uncompute run in ``dot_mode`` (the forward bf16x3),
counted as "fwd_bf16" and "fwd_bf16x3".
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels._storage import (check_modes, count_modes, load_b,
                                                store_b)
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split, step_operators


def block_backward_sublane_plain(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                                 bwd_mode: str = "f32", gram_mode: str = "f32",
                                 dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64 matmuls in the dot
    modes, F and B decoded on load and encoded on store); fresh outputs."""
    check_modes("block_backward_sublane", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    F = _st.cmatmul(torch.complex(einv_r, einv_i), load_b(fr, fi), dot_mode)
    B = load_b(br, bi)
    T0 = _st.pair_sum(B, F, gram_mode)
    B = _st.cmatmul(torch.complex(e_r, e_i).transpose(0, 1), B, bwd_mode)
    return (*store_b(F, fr.dtype), *store_b(B, br.dtype), *_split(T0))


_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 4
             + [_launch.LONG] + [_launch.INT] * 4 + [_launch.VOIDP])


def block_backward_sublane(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                           bwd_mode: str = "f32", gram_mode: str = "f32",
                           dot_mode: str = "f32"):
    """The adjoint step on planes ``(A, 128, 128)``; operators are f32
    real/imag pairs (128, 128). ``B`` is stored as float32, bfloat16 or
    float16, ``F`` as float32 or bfloat16; ``dot_mode``, ``bwd_mode`` /
    ``gram_mode`` are the uncompute's, the transport's and the pair gram's
    dot modes. Every launch also counts as ``mode_launches["tc"]``."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 3 or tuple(fr.shape[1:]) != (128, 128) or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_sublane: planes must be (A, 128, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    ops = (einv_r, einv_i, e_r, e_i)
    check_modes("block_backward_sublane", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    if fi.dtype != fr.dtype:
        raise TypeError("block_backward_sublane: forward planes of two dtypes")
    if fr.device.type == "cpu":
        return block_backward_sublane_plain(*planes, *ops, bwd_mode=bwd_mode,
                                            gram_mode=gram_mode, dot_mode=dot_mode)
    A = fr.shape[0]
    _launch.check_cuda_f32("block_backward_sublane", (fr, fi), fr.device,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("block_backward_sublane", ops, fr.device)
    _launch.check_cuda_f32("block_backward_sublane", (br, bi), fr.device,
                           dtypes=_st.STORAGE_DTYPES)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("block_backward_sublane: operators must be (128, 128)")
    nblk = min(A, _launch.sm_count(fr.device))
    part = torch.zeros((nblk, 2, 128, 128), dtype=torch.float32, device=fr.device)
    out = torch.empty((2, 128, 128), dtype=torch.float32, device=fr.device)
    lib = "block_backward_dual"   # the dual adjoint's library: its sublane step
    tc_ops = step_operators(*ops, dot_mode, bwd_mode, fr.dtype, br.dtype)
    fn = _launch.entry(lib, "dqc_block_backward_sublane", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), _st.storage_kind(br.dtype),
              _st.storage_kind(fr.dtype), *(o.data_ptr() for o in tc_ops),
              part.data_ptr(), out.data_ptr(), A, nblk,
              int(bwd_mode == "bf16x3"), int(gram_mode == "bf16x3"),
              int(dot_mode == "bf16x3"), _launch.stream(fr.device))
    _launch.raise_on_error(code, lib, "block_backward_sublane launch")
    block_backward_sublane.launches += 1
    block_backward_sublane.mode_launches["tc"] += 1
    count_modes(block_backward_sublane, br.dtype, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_sublane, fr.dtype, dot_mode)
    return (fr, fi, br, bi, out[0], out[1])


block_backward_sublane.launches = 0
block_backward_sublane.mode_launches = {"tc": 0, "bf16": 0, "f16": 0, "bf16x3": 0,
                                        "gram_bf16x3": 0, "fwd_bf16": 0,
                                        "fwd_bf16x3": 0}
