"""Block operators of a fused tape (the forward helpers of the plane scan).

Counterpart of the per-ref operator helpers of
``dqc_tpu/circuit/fused_autograd.py`` that ``circuit/plane_scan.py`` imports:
a fused block's gates expand to full-group operators (or diagonal tables)
and compose into one block operator. Constant gates stay host numpy end to
end (value-memoised in ops/groups.py); variable gates are torch tensors and
compose on their own device. The blockwise adjoint is the next slice.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dqc_tpu_torch.circuit.fusion import FBlock, GateRef
from dqc_tpu_torch.ops import groups as gr

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def _ref_gate(ref: GateRef, var_gates, const_gates):
    return var_gates[ref.queue_idx] if ref.var else const_gates[ref.queue_idx]


def _diag_to_dense(table):
    c = gr.concrete_or_none(table)
    if c is not None:
        return gr._cached(("diagm", c.tobytes(), c.dtype.str), lambda: np.diag(c))
    return torch.diag(table)


def _ref_op(ref: GateRef, gate, g: int):
    """Full-group operator of one gate occurrence (dense 2^g x 2^g)."""
    k = len(ref.rel_positions)
    if ref.diag:
        return _diag_to_dense(_ref_table(ref, gate, g))
    return gr.expand_in_group(gate.reshape(1 << k, 1 << k), ref.rel_positions, g)


def _ref_table(ref: GateRef, gate, g: int):
    """Full-group diagonal table of one diag gate occurrence."""
    return gr.expand_diag_in_group(gate.reshape(-1), ref.rel_positions, g)


def _block_ops(block: FBlock, var_gates, const_gates, g: int, dtype) -> List:
    ops = []
    for ref in block.gates:
        gate = _astype_host(_ref_gate(ref, var_gates, const_gates), dtype)
        if block.all_diag:
            ops.append(_ref_table(ref, gate, g))
        else:
            ops.append(_ref_op(ref, gate, g))
    return ops


def _astype_host(x, dtype):
    """Cast a gate to the complex ``dtype``: host numpy stays numpy (so that
    constants keep value-memoisation), tensors stay on their device."""
    c = gr.concrete_or_none(x)
    if c is not None:
        return c.astype(_NP_COMPLEX[dtype])
    return x.to(dtype)


def _as_tensor_like(a, ref: torch.Tensor) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.ascontiguousarray(a), dtype=ref.dtype,
                           device=ref.device)


def _opmul(a, b):
    """Operator-space product: host numpy pairs multiply in numpy; anything
    with a tensor multiplies on that tensor's device (full f32 on the card:
    the port never enables TF32)."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a @ b
    ref = a if isinstance(a, torch.Tensor) else b
    return torch.matmul(_as_tensor_like(a, ref), _as_tensor_like(b, ref))


def _elmul(a, b):
    """Elementwise product of two diagonal tables (numpy or tensor)."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a * b
    ref = a if isinstance(a, torch.Tensor) else b
    return _as_tensor_like(a, ref) * _as_tensor_like(b, ref)


def _compose(ops: List, *, diag: bool):
    """Total block operator ``E_m ... E_1`` (tables multiply for an
    all-diagonal block)."""
    total = ops[0]
    for o in ops[1:]:
        total = _elmul(total, o) if diag else _opmul(o, total)
    return total
