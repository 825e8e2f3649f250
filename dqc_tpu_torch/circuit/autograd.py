"""Per-gate tape execution and its O(1)-memory adjoint.

Counterpart of ``dqc_tpu/circuit/autograd.py``:

* :func:`run_tape` folds the tape over a flat state and collects the
  requested density matrices (every one, or the differentiated ones);
* :func:`tape_forward` is the differentiable form, a
  ``torch.autograd.Function`` whose backward does not keep a state per gate:
  it **uncomputes** the forward state, applying ``G^dagger`` (unitary) or
  ``G^-1`` (non-unitary), while it transports one cotangent state, so two
  or three statevectors are live whatever the depth.

Cotangents follow the JAX package's convention inside (for ``psi' = G
psi``: ``psi_bar = G^T psi'_bar``, ``G_bar[p, q] = sum psi'_bar[p] psi[q]``,
a density cotangent ``L`` seeds ``(L + L^H) conj(psi)``); torch's gradient
of a complex tensor is the conjugate of that cotangent, so the backward
conjugates the density gradients on the way in and the cotangents on the
way out. Gradients flow to the variable gates and the initial state;
constant gates get none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dqc_tpu_torch.circuit.ir import InstrKind, Instruction, Tape
from dqc_tpu_torch.ops import inversion
from dqc_tpu_torch.ops import statevector as sv


def _gates_by_instruction(tape: Tape, var_gates, const_gates) -> List:
    """Each instruction's gate (None for densities), the var and const
    queues consumed in tape order."""
    out: List = []
    vi, ci = iter(var_gates), iter(const_gates)
    for inst in tape.instructions:
        if inst.is_gate:
            out.append(next(vi) if inst.var else next(ci))
        else:
            out.append(None)
    return out


def _apply(state, inst: Instruction, gate):
    if inst.kind is InstrKind.GATE:
        return sv.apply_gate(state, gate, inst.positions)
    if inst.kind is InstrKind.DIAG:
        return sv.apply_diag(state, gate, inst.positions)
    raise AssertionError(inst)


def _uncompute(state, inst: Instruction, gate):
    """Roll the forward state back through one gate."""
    if inst.kind is InstrKind.GATE:
        if inst.unitary:
            return sv.apply_gate_adjoint(state, gate, inst.positions)
        return sv.apply_gate_inverse(state, gate, inst.positions,
                                     ctx=f"gate at positions {inst.positions}")
    if inst.kind is InstrKind.DIAG:
        inv = inversion.invert_diag(gate.reshape(-1), inst.unitary,
                                    ctx=f"diag gate at positions {inst.positions}")
        return sv.apply_diag(state, inv, inst.positions)
    raise AssertionError(inst)


def _transport(ct_state, inst: Instruction, gate):
    """Pull the cotangent state back through one gate: ``G^T`` (a diagonal
    gate is its own transpose)."""
    if inst.kind is InstrKind.GATE:
        return sv.apply_gate_transpose(ct_state, gate, inst.positions)
    if inst.kind is InstrKind.DIAG:
        return sv.apply_diag(ct_state, gate, inst.positions)
    raise AssertionError(inst)


def match_grad(ct: torch.Tensor, ref) -> torch.Tensor:
    """The torch gradient of the input ``ref`` from its JAX-convention
    cotangent ``ct``: conjugated, reshaped like ``ref``, its real part for
    a real input."""
    ct = ct.reshape(tuple(ref.shape))
    if ref.is_complex():
        return ct.conj().resolve_conj().to(ref.dtype)
    return ct.real.to(ref.dtype)


def run_tape(tape: Tape, state: torch.Tensor, var_gates: Sequence, const_gates: Sequence, *,
             only_diff: bool = False, stop_after: Optional[int] = None
             ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Fold the tape over the state; collect the requested density matrices
    (all of them, or with ``only_diff`` the differentiated ones).
    ``stop_after`` ends the run after that instruction index. Returns
    ``(densities_in_tape_order, state_after_the_last_executed_instruction)``.
    Plain torch ops: differentiable by torch autograd as they are."""
    state = state.reshape(-1)
    gates = _gates_by_instruction(tape, var_gates, const_gates)
    densities: List[torch.Tensor] = []
    for idx, (inst, gate) in enumerate(zip(tape.instructions, gates)):
        if stop_after is not None and idx > stop_after:
            break
        if inst.kind is InstrKind.DENSITY:
            if inst.diff or not only_diff:
                densities.append(sv.density(state, inst.positions))
        else:
            state = _apply(state, inst, gate)
    return tuple(densities), state


class _TapeForward(torch.autograd.Function):
    """Diff densities of ``tape`` with the per-gate uncompute adjoint; the
    residual is the state at the last differentiated density (or the
    initial state) and the gate values."""

    @staticmethod
    def forward(ctx, tape, const_gates, initial_state, *var_gates):
        last = tape.last_diff_density_index()
        densities, state = run_tape(tape, initial_state, var_gates, const_gates,
                                    only_diff=True,
                                    stop_after=last if last >= 0 else -1)
        if last < 0:
            state = initial_state.reshape(-1)
        ctx.statics = (tape, const_gates)
        ctx.save_for_backward(state, initial_state, *var_gates)
        return densities

    @staticmethod
    def backward(ctx, *density_grads):
        tape, const_gates = ctx.statics
        state, initial_state, *var_gates = ctx.saved_tensors
        last = tape.last_diff_density_index()
        gates = _gates_by_instruction(tape, var_gates, const_gates)
        diff_indices = [i for i, inst in enumerate(tape.instructions)
                        if inst.kind is InstrKind.DENSITY and inst.diff]
        ct_of = dict(zip(diff_indices, density_grads))

        fwd = state
        bwd = None  # the cotangent state (None: exactly zero)
        var_cts: List[Optional[torch.Tensor]] = []
        # var gates after the last diff density get zero gradients, and are
        # neither executed nor uncomputed
        for idx in range(len(tape.instructions) - 1, last, -1):
            inst = tape.instructions[idx]
            if inst.is_gate and inst.var:
                var_cts.append(None)
        for idx in range(last, -1, -1):
            inst = tape.instructions[idx]
            gate = gates[idx]
            if inst.kind is InstrKind.DENSITY:
                if not inst.diff or ct_of[idx] is None:
                    continue
                d = 1 << inst.k
                ct_m = ct_of[idx].reshape(d, d).conj().to(fwd.dtype)
                # the vjp of rho = psi psi^H: psi_bar += (L + L^H) conj(psi)
                seed = sv.apply_gate(fwd.conj(), ct_m + ct_m.conj().T,
                                     inst.positions)
                bwd = seed if bwd is None else bwd + seed
                continue
            g = sv._as_tensor(gate, fwd) if isinstance(gate, torch.Tensor) else gate
            fwd = _uncompute(fwd, inst, g)  # the state entering this gate
            if inst.var:
                if bwd is None:
                    var_cts.append(None)
                elif inst.kind is InstrKind.DIAG:
                    var_cts.append(sv.diag_gate_grad(fwd, bwd, inst.positions))
                else:
                    var_cts.append(sv.gate_grad(fwd, bwd, inst.positions))
            if bwd is not None:
                bwd = _transport(bwd, inst, g)

        state_grad = None
        if ctx.needs_input_grad[2]:
            state_grad = (torch.zeros_like(initial_state) if bwd is None
                          else match_grad(bwd, initial_state))
        grads = tuple(torch.zeros_like(ref) if ct is None else match_grad(ct, ref)
                      for ct, ref in zip(reversed(var_cts), var_gates))
        return (None, None, state_grad) + grads


def tape_forward(tape: Tape, initial_state: torch.Tensor, var_gates,
                 const_gates) -> Tuple[torch.Tensor, ...]:
    """Differentiable tape execution returning the diff-density matrices,
    with gradients to ``var_gates`` and ``initial_state`` (tensors) through
    the per-gate O(1)-memory adjoint."""
    return _TapeForward.apply(tape, tuple(const_gates), initial_state,
                              *var_gates)
