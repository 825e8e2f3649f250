"""Block operators of a fused tape, and the per-gate close of the adjoint.

Counterpart of the per-ref operator helpers of
``dqc_tpu/circuit/fused_autograd.py`` that ``circuit/plane_scan.py``
imports: a fused block's gates expand to full-group operators (or diagonal
tables) and compose into one block operator, or into its inverse for the
uncompute. Constant gates stay host numpy end to end (value-memoised in
ops/groups.py); variable gates are torch tensors and compose on their own
device.

The blockwise adjoint reads one pair gram per dense block,
``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]`` (no conjugation), and closes
every variable gate's cotangent from it in ``2^g x 2^g`` matrix algebra
(:func:`dense_block_var_cts`). Cotangents follow the JAX package's
convention (the conjugate of a torch gradient); the autograd boundary in
circuit/plane_scan.py converts.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dqc_tpu_torch.circuit.fusion import FBlock, GateRef
from dqc_tpu_torch.ops import groups as gr
from dqc_tpu_torch.ops import inversion

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def _ref_gate(ref: GateRef, var_gates, const_gates):
    return var_gates[ref.queue_idx] if ref.var else const_gates[ref.queue_idx]


def _inv_dense(m, unitary: bool, ctx: str = "gate"):
    return inversion.invert_gate(m, unitary, ctx)


def _inv_diag(d, unitary: bool, ctx: str = "diag gate"):
    return inversion.invert_diag(d, unitary, ctx)


def _ref_ctx(ref: GateRef) -> str:
    return f"{'var' if ref.var else 'const'} gate, queue index {ref.queue_idx}"


def _diag_to_dense(table):
    c = gr.concrete_or_none(table)
    if c is not None:
        return gr._cached(("diagm", c.tobytes(), c.dtype.str), lambda: np.diag(c))
    return torch.diag(table)


def _ref_op(ref: GateRef, gate, g: int, *, inverse: bool = False):
    """Full-group operator of one gate occurrence (dense 2^g x 2^g)."""
    k = len(ref.rel_positions)
    if ref.diag:
        return _diag_to_dense(_ref_table(ref, gate, g, inverse=inverse))
    m = gate.reshape(1 << k, 1 << k)
    if inverse:
        m = _inv_dense(m, ref.unitary, _ref_ctx(ref))
    return gr.expand_in_group(m, ref.rel_positions, g)


def _ref_table(ref: GateRef, gate, g: int, *, inverse: bool = False):
    """Full-group diagonal table of one diag gate occurrence."""
    d = gate.reshape(-1)
    if inverse:
        d = _inv_diag(d, ref.unitary, _ref_ctx(ref))
    return gr.expand_diag_in_group(d, ref.rel_positions, g)


def _gate_op(block: FBlock, ref: GateRef, var_gates, const_gates, g: int,
             dtype, *, inverse: bool = False):
    """One gate's full-group operator (its diagonal table in an all-diagonal
    block)."""
    gate = _astype_host(_ref_gate(ref, var_gates, const_gates), dtype)
    if block.all_diag:
        return _ref_table(ref, gate, g, inverse=inverse)
    return _ref_op(ref, gate, g, inverse=inverse)


def _block_ops(block: FBlock, var_gates, const_gates, g: int, dtype, *,
               inverse: bool = False) -> List:
    return [_gate_op(block, ref, var_gates, const_gates, g, dtype,
                     inverse=inverse) for ref in block.gates]


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


def _compose(ops: List, *, diag: bool, reverse: bool = False):
    """Total block operator ``E_m ... E_1`` (tables multiply for an
    all-diagonal block). ``reverse=True`` composes the inverse order, for
    the uncompute: ``(E_m ... E_1)^-1 = E_1^-1 ... E_m^-1``."""
    total = ops[0]
    for o in ops[1:]:
        if diag:
            total = _elmul(total, o)
        else:
            total = _opmul(total, o) if reverse else _opmul(o, total)
    return total


# ---------------------------------------------------------------------------
# Cotangents of a block's variable gates from its pair gram
# ---------------------------------------------------------------------------

def _ref_op_vjp(ref: GateRef, full_ct: torch.Tensor, g: int) -> torch.Tensor:
    """Cotangent of the gate from the cotangent of its full-group operator
    ``_ref_op(ref, gate, g)``: the transpose of the (linear) expansion. A
    dense gate's entry (a, b) appears at every (a c, b c) of the expanded
    operator; a diagonal gate's entry m along the diagonal wherever the
    target bits read m. Returns the gate's flat shape (2^k * 2^k or 2^k)."""
    if ref.diag:
        return _diag_table_vjp(ref, torch.diagonal(full_ct), g)
    rels = tuple(int(p) for p in ref.rel_positions)
    k = len(rels)
    perm = gr._expand_perm(rels, g)
    inv = [perm.index(i) for i in range(2 * g)]
    D = full_ct.reshape((2,) * (2 * g)).permute(inv).reshape(
        1 << k, 1 << (g - k), 1 << k, 1 << (g - k))
    return torch.einsum("acbc->ab", D).reshape(-1)


def _diag_table_vjp(ref: GateRef, table_ct: torch.Tensor, g: int) -> torch.Tensor:
    """Cotangent of a diagonal gate from the cotangent of its full-group
    table (``_ref_table``): each entry added to the gate entry it reads."""
    return gr.bits_sum(table_ct, [g - 1 - int(r) for r in ref.rel_positions], g)


def dense_block_var_cts(fi: FBlock, ops, T0: torch.Tensor, var_gates,
                        const_gates, g: int, dtype,
                        var_cts: Dict[int, torch.Tensor]) -> None:
    """Close each var gate's cotangent of a dense/mixed block from the pair
    gram ``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]``: the full-group operator
    cotangent of gate ``i`` is ``suffix_i^T T0 prefix_i^T`` (2^g x 2^g
    matrix algebra), projected through the transpose of the gate's
    expansion (:func:`_ref_op_vjp`)."""
    m = len(ops)
    eye = torch.eye(1 << g, dtype=dtype, device=T0.device)
    prefix = [None] * (m + 1)
    prefix[0] = eye
    for i in range(m):
        prefix[i + 1] = _opmul(ops[i], prefix[i])
    # suffix[i] = E_{m-1} ... E_{i+1}  (operators applied after gate i)
    suffix = [None] * m
    suffix[m - 1] = eye
    for i in range(m - 2, -1, -1):
        suffix[i] = _opmul(suffix[i + 1], ops[i + 1])
    for i, ref in enumerate(fi.gates):
        if not ref.var:
            continue
        full_ct = _opmul(_opmul(suffix[i].T, T0), prefix[i].T)
        gate = _ref_gate(ref, var_gates, const_gates)
        var_cts[ref.queue_idx] = _ref_op_vjp(ref, full_ct, g).reshape(
            gate.shape).to(dtype)


def diag_block_var_cts(fi: FBlock, tables, W: torch.Tensor, var_gates,
                       const_gates, g: int, dtype,
                       var_cts: Dict[int, torch.Tensor]) -> None:
    """Close each var gate's cotangent of an all-diagonal block from the
    block's gradient source ``W[x] = sum_b bwd[x, b] fwd_in[x, b]``: the
    full-group table cotangent of gate ``i`` is ``W`` times the other
    gates' tables (prefix and suffix products), projected through the
    transpose of the diagonal expansion (each table entry added to the gate
    entry it reads)."""
    m = len(tables)
    ones = torch.ones(1 << g, dtype=dtype, device=W.device)
    prefix = [ones]
    for i in range(m):
        prefix.append(_elmul(prefix[i], tables[i]))
    suffix = [ones] * (m + 1)
    for i in range(m - 1, -1, -1):
        suffix[i] = _elmul(suffix[i + 1], tables[i])
    for i, ref in enumerate(fi.gates):
        if not ref.var:
            continue
        full_ct = _elmul(_elmul(W, prefix[i]), suffix[i + 1])
        var_cts[ref.queue_idx] = _diag_table_vjp(ref, full_ct, g).to(dtype)
