"""`AutoGradCircuit` — the reference-compatible builder API.

Counterpart of ``dqc_tpu/circuit/builder.py`` (reference
src/qdc/circuit.py:8-202): the builder methods append instructions to a
:class:`~dqc_tpu_torch.circuit.ir.Tape`, and :meth:`AutoGradCircuit.build`
returns ``(simple_run, autodiff_run)`` with the calling convention
``fn(var_gates, const_gates) -> [density_matrices]``:

* ``simple_run`` evaluates every requested density with the fused
  grouped-axis engine (circuit/fused_autograd.fused_run), plain torch ops;
* ``autodiff_run`` returns the ``*_with_grad`` densities, differentiable in
  the variable gates by torch autograd (``loss.backward()``) through the
  O(1)-memory uncompute adjoint: on the plane engine and its kernels
  (circuit/plane_scan.plane_tape_forward) when ``use_plane_tape`` holds
  (n >= 14, complex64, a CUDA device or ``config.set_plane_engine(True)``),
  otherwise on the fused engine (fused_tape_forward).

Gates may be numpy arrays or tensors, flat (the reference's convention) or
square. Variable gates become tensors on the circuit's device (a tensor
keeps its autograd history); constant gates stay host numpy, so that
equal constants share one expanded operator. The densities come back as
complex tensors on the circuit's device, the CUDA card unless the circuit
was made with ``device="cpu"``.

Qubit convention: positions count from the innermost (fastest-varying) bit;
for 2-qubit ops ``pos2`` is the gate's most-significant qubit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.ir import InstrKind, Instruction, Tape

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


class AutoGradCircuit:
    """Quantum circuit with automatic differentiation. ``device`` (default:
    the CUDA card) is where ``build``'s functions run; it is resolved when
    they are built, so that a circuit can serve as a plain tape builder on
    any machine."""

    def __init__(self, qubits_number: int, dtype=None, device=None):
        if qubits_number < 1:
            raise ValueError("qubits_number must be >= 1")
        self.n = int(qubits_number)
        self.dtype = config.canonicalize_complex(dtype)
        self.device = device
        self.tape = Tape(self.n)
        self._initial_state = None

    # -- initial state -------------------------------------------------------

    def set_state_from_vector(self, vec) -> None:
        """Set the initial state from ``2**n`` amplitudes (a numpy array or
        a tensor), kept as given and cast to the circuit's dtype and device
        when a built function runs."""
        size = vec.numel() if isinstance(vec, torch.Tensor) else np.asarray(vec).size
        if size != (1 << self.n):
            raise ValueError(f"state must have {1 << self.n} amplitudes, got {size}")
        self._initial_state = (vec.detach().reshape(-1)
                               if isinstance(vec, torch.Tensor)
                               else np.asarray(vec).reshape(-1))

    def initial_state(self, device=None) -> torch.Tensor:
        """The circuit's initial state (|0...0> unless set) as a flat
        complex tensor on ``device`` (default: the circuit's)."""
        from dqc_tpu_torch.ops import statevector as sv

        dev = config.resolve_device(self.device if device is None else device)
        if self._initial_state is None:
            return sv.standard_state(self.n, self.dtype, dev)
        return torch.as_tensor(self._initial_state, device=dev).to(self.dtype)

    def _gates(self, var_gates, const_gates, device) -> Tuple[tuple, tuple]:
        """Variable gates as tensors on ``device`` (autograd history kept),
        constant gates as host numpy in the circuit's precision."""
        vg = tuple(g.to(device) if isinstance(g, torch.Tensor)
                   else torch.as_tensor(np.asarray(g), device=device)
                   for g in var_gates)
        np_dt = _NP_COMPLEX[self.dtype]
        cg = tuple((g.detach().cpu().numpy() if isinstance(g, torch.Tensor)
                    else np.asarray(g)).astype(np_dt) for g in const_gates)
        self.tape.validate(vg, cg)
        return vg, cg

    # -- generic instruction appenders ----------------------------------------

    def add_gate(self, positions: Sequence[int], *, var: bool, unitary: bool = True):
        """Append a dense k-qubit gate on ``positions`` (msb first)."""
        self.tape = self.tape.append(
            Instruction(InstrKind.GATE, tuple(positions), var=var, unitary=unitary)
        )

    def add_diag_gate(self, positions: Sequence[int], *, var: bool, unitary: bool = True):
        """Append a diagonal k-qubit gate on ``positions`` (msb first)."""
        self.tape = self.tape.append(
            Instruction(InstrKind.DIAG, tuple(positions), var=var, unitary=unitary)
        )

    def get_dens_op(self, positions: Sequence[int], *, with_grad: bool = False):
        """Append a k-qubit reduced-density-matrix request."""
        self.tape = self.tape.append(
            Instruction(InstrKind.DENSITY, tuple(positions), diff=with_grad)
        )

    # -- reference-compatible 1q/2q methods (circuit.py:24-158) --------------

    def add_q1_const_gate(self, pos: int):
        self.add_gate((pos,), var=False, unitary=True)

    def add_q1_const_gate_nonu(self, pos: int):
        self.add_gate((pos,), var=False, unitary=False)

    def add_q1_var_gate(self, pos: int):
        self.add_gate((pos,), var=True, unitary=True)

    def add_q1_var_gate_nonu(self, pos: int):
        self.add_gate((pos,), var=True, unitary=False)

    def add_q2_const_gate(self, pos2: int, pos1: int):
        self.add_gate((pos2, pos1), var=False, unitary=True)

    def add_q2_const_gate_nonu(self, pos2: int, pos1: int):
        self.add_gate((pos2, pos1), var=False, unitary=False)

    def add_q2_const_gate_diag(self, pos2: int, pos1: int):
        self.add_diag_gate((pos2, pos1), var=False, unitary=True)

    def add_q2_var_gate(self, pos2: int, pos1: int):
        self.add_gate((pos2, pos1), var=True, unitary=True)

    def add_q2_var_gate_nonu(self, pos2: int, pos1: int):
        self.add_gate((pos2, pos1), var=True, unitary=False)

    def add_q2_var_gate_diag(self, pos2: int, pos1: int):
        self.add_diag_gate((pos2, pos1), var=True, unitary=True)

    def get_q1_dens_op(self, pos: int):
        self.get_dens_op((pos,), with_grad=False)

    def get_q2_dens_op(self, pos2: int, pos1: int):
        self.get_dens_op((pos2, pos1), with_grad=False)

    def get_q1_dens_op_with_grad(self, pos: int):
        self.get_dens_op((pos,), with_grad=True)

    def get_q2_dens_op_with_grad(self, pos2: int, pos1: int):
        self.get_dens_op((pos2, pos1), with_grad=True)

    # -- build ----------------------------------------------------------------

    def build(self, fused: Optional[bool] = None) -> Tuple[Callable, Callable]:
        """Return ``(simple_run, autodiff_run)`` (reference
        circuit.py:160-202).

        ``simple_run(var_gates, const_gates)`` evaluates *all* requested
        density matrices; ``autodiff_run`` returns only the ``*_with_grad``
        densities, differentiable with the O(1)-memory adjoint. ``fused``
        (default: ``config.default_fusion()``) selects the gate-fusion
        engines; ``fused=False`` runs gate by gate (circuit/autograd.py)."""
        from dqc_tpu_torch.circuit.autograd import run_tape, tape_forward
        from dqc_tpu_torch.circuit.fused_autograd import fused_run
        from dqc_tpu_torch.circuit.fusion import fuse_tape

        tape = self.tape
        device = config.resolve_device(self.device)
        fused = config.default_fusion() if fused is None else fused
        if fused:
            ftape = fuse_tape(tape)

            def run_all(vg, cg):
                return fused_run(ftape, self.initial_state(device), vg, cg)[0]

            def run_diff(vg, cg):
                return autodiff_densities(ftape, self.initial_state(device), vg, cg)
        else:
            def run_all(vg, cg):
                return run_tape(tape, self.initial_state(device), vg, cg)[0]

            def run_diff(vg, cg):
                return tape_forward(tape, self.initial_state(device), vg, cg)

        def simple_run(var_gates, const_gates):
            return list(run_all(*self._gates(var_gates, const_gates, device)))

        def autodiff_run(var_gates, const_gates):
            return list(run_diff(*self._gates(var_gates, const_gates, device)))

        return simple_run, autodiff_run

    def build_state_fn(self) -> Callable:
        """``fn(var_gates, const_gates) -> final statevector`` (a flat
        complex tensor on the circuit's device), run gate by gate in plain
        torch ops: differentiable by torch autograd as they are."""
        from dqc_tpu_torch.circuit.autograd import run_tape

        device = config.resolve_device(self.device)

        def state_run(var_gates, const_gates):
            vg, cg = self._gates(var_gates, const_gates, device)
            return run_tape(self.tape, self.initial_state(device), vg, cg,
                            only_diff=True)[1]

        return state_run


def autodiff_densities(ftape, state: torch.Tensor, var_gates, const_gates, *,
                       kernels=None):
    """The engine of ``autodiff_run`` for a fused tape from the flat
    ``state``: the plane tape when ``use_plane_tape`` holds (``kernels``:
    the kernel set, default the kernels, ``ops.kernels.PLAIN`` the plain
    versions), else the fused engine's blockwise adjoint."""
    from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward
    from dqc_tpu_torch.circuit.plane_scan import plane_tape_forward, use_plane_tape
    from dqc_tpu_torch.ops.kernels import KERNELS

    if use_plane_tape(ftape, state.dtype, state.device):
        return plane_tape_forward(ftape, state, var_gates, const_gates,
                                  kernels=KERNELS if kernels is None else kernels)
    return fused_tape_forward(ftape, state, var_gates, const_gates)
