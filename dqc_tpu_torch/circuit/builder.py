"""`AutoGradCircuit` — the tape-building half of the reference-compatible API.

Counterpart of the builder methods of ``dqc_tpu/circuit/builder.py``
(reference src/qdc/circuit.py:24-158): each method appends one instruction
to :attr:`AutoGradCircuit.tape`. ``build()`` and the per-gate engine behind
it are not ported yet (ROADMAP.md queue A); the models hand the tape to the
plane engine themselves.

Qubit convention: positions count from the innermost (fastest-varying) bit;
for 2-qubit ops ``pos2`` is the gate's most-significant qubit.
"""

from __future__ import annotations

from typing import Sequence

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.ir import InstrKind, Instruction, Tape


class AutoGradCircuit:
    """Quantum circuit tape builder."""

    def __init__(self, qubits_number: int, dtype=None):
        if qubits_number < 1:
            raise ValueError("qubits_number must be >= 1")
        self.n = int(qubits_number)
        self.dtype = config.canonicalize_complex(dtype)
        self.tape = Tape(self.n)

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
