"""Layer-scanned execution: the repeated layer of a deep layered circuit.

Counterpart of ``dqc_tpu/circuit/scan.py``. A fused gate-only layer tape
runs L times over a state, the per-layer gate values stacked along a
leading layer axis. The port runs the layers as a Python loop (the JAX
package's ``lax.scan``):

* forward: ``fused_run`` of the layer tape, layer after layer;
* backward (:class:`_ScannedLayers`): the O(1)-memory uncompute adjoint in
  reverse, layer by layer through ``fused_autograd._backward_gate_step``,
  which re-derives each layer's gate cotangents from its pair grams and
  stacks them like the gates. Only the final state and the gate values
  are saved, whatever the depth.

:func:`scanned_layers` dispatches to the plane engine
(``plane_scan.plane_scanned_layers``) when ``plane_scan.use_plane_engine``
says so, else runs the grouped complex engine here (n < 14, complex128, or
``config.set_plane_engine(False)``), in plain torch on any device.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dqc_tpu_torch.circuit.fused_autograd import _backward_gate_step, fused_run
from dqc_tpu_torch.circuit.fusion import FDensity, FusedTape, fuse_tape
from dqc_tpu_torch.circuit.ir import Tape
from dqc_tpu_torch.ops import groups as gr
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet


def fuse_layer(tape: Tape) -> FusedTape:
    """Fuse a gate-only layer tape (rejects density instructions)."""
    ftape = fuse_tape(tape)
    if any(isinstance(fi, FDensity) for fi in ftape.instructions):
        raise ValueError("layer tapes must contain gates only; put density "
                         "ops in an epilogue tape")
    return ftape


def _match_ct(ct: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A cotangent reshaped like its gate, in its dtype (real part for a
    real gate)."""
    ct = ct.reshape(ref.shape)
    if ref.is_complex():
        return ct.to(ref.dtype)
    return ct.real.to(ref.dtype)


def _num_layers(stacked_var_gates) -> int:
    return int(stacked_var_gates[0].shape[0]) if stacked_var_gates else 0


class _ScannedLayers(torch.autograd.Function):
    """The final flat state after L layers of ``ftape`` from
    ``initial_state``, differentiable in the initial state and the stacked
    var gates. Saves the final state and the gates; the backward rolls the
    state back layer by layer (two states live, whatever L). Torch's
    gradient of a complex tensor is the conjugate of the JAX package's
    cotangent: the backward conjugates on the way in and out."""

    @staticmethod
    def forward(ctx, ftape, const_gates, n_layers, initial_state,
                *stacked_var_gates):
        state = initial_state.reshape(-1)
        for l in range(n_layers):
            _, state = fused_run(ftape, state,
                                 tuple(g[l] for g in stacked_var_gates),
                                 const_gates)
        ctx.statics = (ftape, const_gates, n_layers)
        ctx.save_for_backward(state, initial_state, *stacked_var_gates)
        return state

    @staticmethod
    def backward(ctx, grad_state):
        from dqc_tpu_torch.circuit.autograd import match_grad

        ftape, const_gates, n_layers = ctx.statics
        final, initial_state, *stacked = ctx.saved_tensors
        n = ftape.n
        sizes = gr.group_sizes_low_first(n)
        fwd = gr.to_grouped(final, n)
        bwd = gr.to_grouped(grad_state.conj().to(final.dtype), n)
        per_layer: List = [None] * n_layers
        for l in reversed(range(n_layers)):
            gates = tuple(g[l] for g in stacked)
            var_cts: Dict[int, torch.Tensor] = {}
            for fi in reversed(ftape.instructions):
                fwd, bwd = _backward_gate_step(fi, fwd, bwd, gates, const_gates,
                                               sizes, n, var_cts)
            per_layer[l] = tuple(_match_ct(var_cts[q], g)
                                 for q, g in enumerate(gates))
        grads = tuple(match_grad(torch.stack([cts[q] for cts in per_layer]), g)
                      for q, g in enumerate(stacked))
        state_grad = None
        if ctx.needs_input_grad[3]:
            state_grad = match_grad(gr.from_grouped(bwd), initial_state)
        return (None, None, None, state_grad) + grads


def scanned_layers(ftape: FusedTape, initial_state: torch.Tensor,
                   stacked_var_gates, const_gates, *,
                   kernels: KernelSet = KERNELS) -> torch.Tensor:
    """Apply the layer tape ``L`` times: each of ``stacked_var_gates``
    carries a leading layer axis of length L; ``const_gates`` are shared by
    every layer. Returns the final flat state, differentiable in the
    initial state and the stacked gates. On the plane engine when
    ``plane_scan.use_plane_engine`` holds (``kernels`` picks its kernels or
    their plain versions), else the grouped complex engine."""
    from dqc_tpu_torch.circuit import plane_scan

    if plane_scan.use_plane_engine(ftape, initial_state.dtype):
        return plane_scan.plane_scanned_layers(
            ftape, initial_state, stacked_var_gates, const_gates,
            kernels=kernels)
    return _ScannedLayers.apply(ftape, tuple(const_gates),
                                _num_layers(stacked_var_gates), initial_state,
                                *stacked_var_gates)
