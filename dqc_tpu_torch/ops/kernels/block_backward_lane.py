"""One-pass adjoint step of an unpaired lane-group block on the planes.

Replaces the TPU kernel ``block_backward_lane``
(``dqc_tpu/ops/pallas/block_backward.py:88``): on the forward planes ``F``
and the cotangent planes ``B`` ``(A, 128, 128) x 2``, with the lane-group
operator ``E`` (qubits 0..6, the last axis),

``F <- F Einv^T``, ``T0[x, y] += sum B[a, s, x] F[a, s, y]``, ``B <- B E``

with the pair gram holomorphic (no conjugation; ``B`` the incoming
cotangent, ``F`` the uncomputed planes). The Hopper kernel is
``csrc/block_backward_lane.cu`` on ``csrc/adjoint.cuh`` (bound by
operations: 384 complex multiply-adds per amplitude);
:func:`block_backward_lane_plain` is its plain PyTorch version.

:func:`block_backward_lane` updates ``(F, B)`` in place on a CUDA tensor
and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_r, T0_i)``.

The cotangent planes ``B`` may be stored as float32, bfloat16 or float16
(the kernels' codec, ops/kernels/_storage.py), and the transport and the
pair gram run in ``bwd_mode`` / ``gram_mode`` ("f32" or "bf16x3"), as the
TPU kernel's ``bwd_dot_mode`` and ``gram_dot_mode``; such launches are also
counted in ``mode_launches`` ("bf16" / "f16", "bf16x3", "gram_bf16x3"). The
forward planes ``F`` may be stored as float32 or bfloat16 ("bf16" storage:
one load and one store, the pair gram on the unrounded uncompute, as in
the TPU kernel) and the uncompute run in ``dot_mode`` (the forward
bf16x3), counted as "fwd_bf16" and "fwd_bf16x3".
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels import _storage as _st
from dqc_tpu_torch.ops.kernels._storage import (check_modes, count_modes, load_b,
                                                store_b)
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split


def block_backward_lane_plain(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                              bwd_mode: str = "f32", gram_mode: str = "f32",
                              dot_mode: str = "f32"):
    """Plain PyTorch version of the kernel (complex64 matmuls in the dot
    modes, F and B decoded on load and encoded on store); fresh outputs."""
    check_modes("block_backward_lane", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    F = _st.cmatmul(load_b(fr, fi),
                    torch.complex(einv_r, einv_i).transpose(0, 1), dot_mode)
    B = load_b(br, bi)
    T0 = _st.pair_sum(B.reshape(-1, 128, 1), F.reshape(-1, 128, 1), gram_mode)
    B = _st.cmatmul(B, torch.complex(e_r, e_i), bwd_mode)
    return (*store_b(F, fr.dtype), *store_b(B, br.dtype), *_split(T0))


_ARGTYPES = ([_launch.VOIDP] * 4 + [_launch.INT] * 2 + [_launch.VOIDP] * 6
             + [_launch.LONG] + [_launch.INT] * 4 + [_launch.VOIDP])


def block_backward_lane(fr, fi, br, bi, einv_r, einv_i, e_r, e_i, *,
                        bwd_mode: str = "f32", gram_mode: str = "f32",
                        dot_mode: str = "f32"):
    """The adjoint step on planes ``(A, 128, 128)``; operators are f32
    real/imag pairs (128, 128). ``B`` is stored as float32, bfloat16 or
    float16, ``F`` as float32 or bfloat16; ``dot_mode``, ``bwd_mode`` /
    ``gram_mode`` are the uncompute's, the transport's and the pair gram's
    dot modes."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 3 or tuple(fr.shape[1:]) != (128, 128) or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_lane: planes must be (A, 128, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    ops = (einv_r, einv_i, e_r, e_i)
    check_modes("block_backward_lane", fr, br, bi, bwd_mode, gram_mode, dot_mode)
    if fi.dtype != fr.dtype:
        raise TypeError("block_backward_lane: forward planes of two dtypes")
    if fr.device.type == "cpu":
        return block_backward_lane_plain(*planes, *ops, bwd_mode=bwd_mode,
                                         gram_mode=gram_mode, dot_mode=dot_mode)
    A = fr.shape[0]
    _launch.check_cuda_f32("block_backward_lane", (fr, fi), fr.device,
                           dtypes=_st.FWD_DTYPES)
    _launch.check_cuda_f32("block_backward_lane", ops, fr.device)
    _launch.check_cuda_f32("block_backward_lane", (br, bi), fr.device,
                           dtypes=_st.STORAGE_DTYPES)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("block_backward_lane: operators must be (128, 128)")
    nblk = min(A, _launch.sm_count(fr.device))
    part = torch.zeros((nblk, 2, 128, 128), dtype=torch.float32, device=fr.device)
    out = torch.empty((2, 128, 128), dtype=torch.float32, device=fr.device)
    lib = "block_backward_lane"
    fn = _launch.entry(lib, "dqc_block_backward_lane", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), _st.storage_kind(br.dtype),
              _st.storage_kind(fr.dtype), *(o.data_ptr() for o in ops),
              part.data_ptr(), out.data_ptr(), A, nblk,
              int(bwd_mode == "bf16x3"), int(gram_mode == "bf16x3"),
              int(dot_mode == "bf16x3"), _launch.stream(fr.device))
    _launch.raise_on_error(code, lib, "block_backward_lane launch")
    block_backward_lane.launches += 1
    count_modes(block_backward_lane, br.dtype, bwd_mode, gram_mode)
    _st.count_fwd(block_backward_lane, fr.dtype, dot_mode)
    return (fr, fi, br, bi, out[0], out[1])


block_backward_lane.launches = 0
block_backward_lane.mode_launches = {"bf16": 0, "f16": 0, "bf16x3": 0,
                                     "gram_bf16x3": 0, "fwd_bf16": 0,
                                     "fwd_bf16x3": 0}
