"""Fused-tape execution on the grouped complex engine, and its blockwise
O(1)-memory adjoint.

Counterpart of ``dqc_tpu/circuit/fused_autograd.py``. A fused block's
gates expand to full-group operators (or diagonal tables) and compose into
one block operator, or into its inverse for the uncompute. Constant gates
stay host numpy end to end (value-memoised in ops/groups.py); variable
gates are torch tensors and compose on their own device.

:func:`fused_run` executes a fused tape on a complex state in the grouped
shape (ops/groups.py), one product per block; :func:`fused_tape_forward`
is its differentiable form, a ``torch.autograd.Function`` whose backward
rolls the state back block by block (the off-plane engine of
``AutoGradCircuit.build``: n < 14, complex128, and ``simple_run`` at every
n). The plane engine (circuit/plane_scan.py) shares the operator helpers
and the cotangent close below.

The blockwise adjoint reads one pair gram per dense block,
``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]`` (no conjugation), and closes
every variable gate's cotangent from it in ``2^g x 2^g`` matrix algebra
(:func:`dense_block_var_cts`). Cotangents follow the JAX package's
convention (the conjugate of a torch gradient); the autograd boundary in
circuit/plane_scan.py converts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dqc_tpu_torch.circuit.fusion import FBlock, FCross, FDensity, FusedTape, GateRef
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


# ---------------------------------------------------------------------------
# The grouped complex engine
# ---------------------------------------------------------------------------

def _cross_ref(fi: FCross) -> GateRef:
    return GateRef(fi.var, fi.queue_idx, (), fi.diag, fi.unitary)


def _apply_block(t: torch.Tensor, block: FBlock, ops: List, *,
                 reverse: bool = False) -> torch.Tensor:
    if block.all_diag:
        return gr.apply_group_diag(t, _compose(ops, diag=True), block.group)
    return gr.apply_group_matrix(t, _compose(ops, diag=False, reverse=reverse),
                                 block.group)


def fused_run(ftape: FusedTape, state: torch.Tensor, var_gates, const_gates, *,
              only_diff: bool = False, stop_after: Optional[int] = None
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Execute a fused tape on a flat complex state; returns
    ``(densities in tape order, final flat state)``. ``only_diff`` keeps the
    differentiated densities only; ``stop_after`` ends the run after that
    instruction index. Plain torch ops (differentiable as they are)."""
    n = ftape.n
    t = gr.to_grouped(state, n)
    sizes = gr.group_sizes_low_first(n)
    densities: List[torch.Tensor] = []
    gram_cache: dict = {}  # per-group Grams shared by densities at one point
    for idx, fi in enumerate(ftape.instructions):
        if stop_after is not None and idx > stop_after:
            break
        if isinstance(fi, FDensity):
            if fi.diff or not only_diff:
                densities.append(gr.density_cached(t, fi.positions, n, gram_cache))
        elif isinstance(fi, FBlock):
            gram_cache.clear()
            t = _apply_block(t, fi, _block_ops(fi, var_gates, const_gates,
                                               sizes[fi.group], t.dtype))
        else:
            gram_cache.clear()
            gate = _astype_host(_ref_gate(_cross_ref(fi), var_gates, const_gates),
                                t.dtype)
            if fi.diag:
                t = gr.apply_diag(t, gate.reshape(-1), fi.positions, n)
            else:
                t = gr.apply_dense(t, gate, fi.positions, n)
    return tuple(densities), gr.from_grouped(t)


def _backward_gate_step(fi, fwd, bwd, var_gates, const_gates, sizes, n: int,
                        var_cts: Dict[int, torch.Tensor]):
    """Roll (fwd, bwd) back through one gate instruction (FCross or FBlock),
    recording the variable gates' cotangents in ``var_cts``. ``bwd`` may be
    None (exactly zero, before any density seed)."""
    if isinstance(fi, FCross):
        gate = _astype_host(_ref_gate(_cross_ref(fi), var_gates, const_gates),
                            fwd.dtype)
        ctx = (f"{'var' if fi.var else 'const'} cross-group gate, "
               f"queue index {fi.queue_idx}")
        if fi.diag:
            d = gate.reshape(-1)
            fwd = gr.apply_diag(fwd, _inv_diag(d, fi.unitary, ctx), fi.positions, n)
            if fi.var and bwd is not None:
                var_cts[fi.queue_idx] = gr.diag_pair_grad(fwd, bwd, fi.positions, n)
            if bwd is not None:
                bwd = gr.apply_diag(bwd, d, fi.positions, n)
        else:
            kk = 1 << len(fi.positions)
            m = gate.reshape(kk, kk)
            fwd = gr.apply_dense(fwd, _inv_dense(m, fi.unitary, ctx), fi.positions, n)
            if fi.var and bwd is not None:
                var_cts[fi.queue_idx] = gr.pair_grad(fwd, bwd, fi.positions, n)
            if bwd is not None:
                bwd = gr.apply_dense(bwd, m.T, fi.positions, n)
        return fwd, bwd

    g = sizes[fi.group]
    inv_ops = _block_ops(fi, var_gates, const_gates, g, fwd.dtype, inverse=True)
    if fi.all_diag:
        fwd = gr.apply_group_diag(fwd, _compose(inv_ops, diag=True), fi.group)
        if bwd is not None:
            tables = _block_ops(fi, var_gates, const_gates, g, fwd.dtype)
            if fi.has_var:
                W = gr.group_diag_gram(fwd, bwd, fi.group)
                diag_block_var_cts(fi, tables, W, var_gates, const_gates, g,
                                   fwd.dtype, var_cts)
            bwd = gr.apply_group_diag(bwd, _compose(tables, diag=True), fi.group)
        return fwd, bwd

    fwd = gr.apply_group_matrix(fwd, _compose(inv_ops, diag=False, reverse=True),
                                fi.group)
    if bwd is not None:
        ops = _block_ops(fi, var_gates, const_gates, g, fwd.dtype)
        if fi.has_var:
            T0 = gr.group_pair_gram(fwd, bwd, fi.group)
            dense_block_var_cts(fi, ops, T0, var_gates, const_gates, g,
                                fwd.dtype, var_cts)
        bwd = gr.apply_group_matrix(bwd, _compose(ops, diag=False).T, fi.group)
    return fwd, bwd


def _fused_backward(ftape: FusedTape, state: torch.Tensor, var_gates,
                    const_gates, density_cts) -> Tuple[Optional[torch.Tensor],
                                                       Dict[int, torch.Tensor]]:
    """The blockwise adjoint in the JAX package's cotangent convention:
    ``(state cotangent or None, {queue index: var-gate cotangent})``."""
    n = ftape.n
    sizes = gr.group_sizes_low_first(n)
    last = ftape.last_diff_density_index()
    diff_indices = [i for i, fi in enumerate(ftape.instructions)
                    if isinstance(fi, FDensity) and fi.diff]
    ct_of = dict(zip(diff_indices, density_cts))

    fwd = gr.to_grouped(state, n)
    bwd = None
    var_cts: Dict[int, torch.Tensor] = {}
    pending: Dict[int, object] = {}  # group -> summed seed operator

    def flush_seeds(fwd, bwd):
        # every density cotangent at one circuit point seeds the same
        # conj(fwd): the expanded (L + L^H) sum per group, applied once
        if not pending:
            return bwd
        conj = fwd.conj()
        for j, M in pending.items():
            seed = gr.apply_group_matrix(conj, M, j)
            bwd = seed if bwd is None else bwd + seed
        pending.clear()
        return bwd

    for idx in range(last, -1, -1):
        fi = ftape.instructions[idx]
        if isinstance(fi, FDensity):
            if not fi.diff or ct_of[idx] is None:
                continue
            d = 1 << len(fi.positions)
            ct_m = ct_of[idx].reshape(d, d).to(fwd.dtype)
            sym = ct_m + ct_m.conj().T
            groups_hit = {gr.group_of_bit(n, p)[0] for p in fi.positions}
            if len(groups_hit) == 1:
                j = groups_hit.pop()
                rels = tuple(p % gr.GROUP_BITS for p in fi.positions)
                E = gr.expand_in_group(sym, rels, sizes[j])
                pending[j] = E if j not in pending else pending[j] + E
            else:
                seed = gr.apply_dense(fwd.conj(), sym, fi.positions, n)
                bwd = seed if bwd is None else bwd + seed
            continue
        bwd = flush_seeds(fwd, bwd)
        fwd, bwd = _backward_gate_step(fi, fwd, bwd, var_gates, const_gates,
                                       sizes, n, var_cts)
    bwd = flush_seeds(fwd, bwd)
    return (None if bwd is None else gr.from_grouped(bwd)), var_cts


class _FusedTapeForward(torch.autograd.Function):
    """Diff densities of a fused tape with the blockwise uncompute adjoint;
    the residual is the state at the last differentiated density (or the
    initial state) and the gate values."""

    @staticmethod
    def forward(ctx, ftape, const_gates, initial_state, *var_gates):
        last = ftape.last_diff_density_index()
        densities, state = fused_run(ftape, initial_state.reshape(-1), var_gates,
                                     const_gates, only_diff=True,
                                     stop_after=last if last >= 0 else -1)
        if last < 0:
            state = initial_state.reshape(-1)
        ctx.statics = (ftape, const_gates)
        ctx.save_for_backward(state, initial_state, *var_gates)
        return densities

    @staticmethod
    def backward(ctx, *density_grads):
        from dqc_tpu_torch.circuit.autograd import match_grad

        ftape, const_gates = ctx.statics
        state, initial_state, *var_gates = ctx.saved_tensors
        cts = tuple(None if g is None else g.conj() for g in density_grads)
        state_ct, var_cts = _fused_backward(ftape, state, var_gates,
                                            const_gates, cts)
        state_grad = None
        if ctx.needs_input_grad[2]:
            state_grad = (torch.zeros_like(initial_state) if state_ct is None
                          else match_grad(state_ct, initial_state))
        grads = tuple(torch.zeros_like(ref) if q not in var_cts
                      else match_grad(var_cts[q], ref)
                      for q, ref in enumerate(var_gates))
        return (None, None, state_grad) + grads


def fused_tape_forward(ftape: FusedTape, initial_state: torch.Tensor,
                       var_gates, const_gates) -> Tuple[torch.Tensor, ...]:
    """Differentiable fused execution returning the diff-density matrices,
    with gradients to ``var_gates`` and ``initial_state`` through the
    blockwise O(1)-memory adjoint."""
    return _FusedTapeForward.apply(ftape, tuple(const_gates), initial_state,
                                   *var_gates)
