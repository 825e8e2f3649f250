"""One-pass adjoint step of an unpaired sublane-group block on f32 planes.

Replaces the TPU kernel ``block_backward_sublane``
(``dqc_tpu/ops/pallas/block_backward.py:184``): on the forward planes ``F``
and the cotangent planes ``B`` ``(A, 128, 128) x 2``, with the sublane-group
operator ``E`` (qubits 7..13, the middle axis),

``F <- Einv F``, ``T0[x, y] += sum B[a, x, c] F[a, y, c]``, ``B <- E^T B``

with the pair gram holomorphic (no conjugation; ``B`` the incoming
cotangent, ``F`` the uncomputed planes). The Hopper kernel is
``csrc/block_backward_sublane.cu`` on ``csrc/adjoint.cuh`` (bound by
operations: 384 complex multiply-adds per amplitude);
:func:`block_backward_sublane_plain` is its plain PyTorch version.

:func:`block_backward_sublane` updates ``(F, B)`` in place on a CUDA tensor
and returns the plain version's fresh planes on a CPU tensor. Returns
``(f_r, f_i, b_r, b_i, T0_r, T0_i)``.
"""

from __future__ import annotations

import torch

from dqc_tpu_torch.ops.kernels import _launch
from dqc_tpu_torch.ops.kernels.block_backward_dual import _split
from dqc_tpu_torch.ops.kernels.gram import pair_sum


def block_backward_sublane_plain(fr, fi, br, bi, einv_r, einv_i, e_r, e_i):
    """Plain PyTorch version of the kernel (complex64 matmuls); fresh
    outputs."""
    F = torch.matmul(torch.complex(einv_r, einv_i), torch.complex(fr, fi))
    B = torch.complex(br, bi)
    T0 = pair_sum(B, F)
    return _split(F, torch.matmul(torch.complex(e_r, e_i).transpose(0, 1), B), T0)


_ARGTYPES = [_launch.VOIDP] * 10 + [_launch.LONG, _launch.INT, _launch.VOIDP]


def block_backward_sublane(fr, fi, br, bi, einv_r, einv_i, e_r, e_i):
    """The adjoint step on planes ``(A, 128, 128)``; operators are f32
    real/imag pairs (128, 128)."""
    planes = (fr, fi, br, bi)
    if fr.dim() != 3 or tuple(fr.shape[1:]) != (128, 128) or any(
            p.shape != fr.shape for p in planes):
        raise ValueError(f"block_backward_sublane: planes must be (A, 128, 128), "
                         f"got {[tuple(p.shape) for p in planes]}")
    ops = (einv_r, einv_i, e_r, e_i)
    if fr.device.type == "cpu":
        return block_backward_sublane_plain(*planes, *ops)
    A = fr.shape[0]
    _launch.check_cuda_f32("block_backward_sublane", planes + ops, fr.device)
    if any(tuple(o.shape) != (128, 128) for o in ops):
        raise ValueError("block_backward_sublane: operators must be (128, 128)")
    nblk = min(A, _launch.sm_count(fr.device))
    part = torch.zeros((nblk, 2, 128, 128), dtype=torch.float32, device=fr.device)
    out = torch.empty((2, 128, 128), dtype=torch.float32, device=fr.device)
    lib = "block_backward_sublane"
    fn = _launch.entry(lib, "dqc_block_backward_sublane", _ARGTYPES)
    code = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in ops),
              part.data_ptr(), out.data_ptr(), A, nblk, _launch.stream(fr.device))
    _launch.raise_on_error(code, lib, "block_backward_sublane launch")
    block_backward_sublane.launches += 1
    return (fr, fi, br, bi, out[0], out[1])


block_backward_sublane.launches = 0
