"""Quantum Fourier transform circuit family.

Counterpart of ``dqc_tpu/models/qft.py``: per target qubit a Hadamard and
a ladder of controlled-phase gates (all diagonal, so long-range CPhases
never force dense cross-group work), then a qubit-reversal SWAP network —
cross-group diagonal tables at every distance and dense cross-group swaps.
"""

from __future__ import annotations

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.builder import AutoGradCircuit

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


class QFT:
    def __init__(self, qubits_number: int, dtype=None, swap_network: bool = True,
                 device=None):
        self.n = int(qubits_number)
        self.dtype = config.canonicalize_complex(dtype)
        self.device = device
        np_dt = _NP_COMPLEX[self.dtype]
        h2 = (np.asarray([[1, 1], [1, -1]]) / np.sqrt(2)).astype(np_dt)
        swap = np.asarray([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                          np_dt)

        c = AutoGradCircuit(self.n, dtype=self.dtype, device=device)
        gates = []
        # the standard QFT ladder, msb down (qubit n-1 the top bit)
        for j in range(self.n - 1, -1, -1):
            c.add_q1_const_gate(j)
            gates.append(h2.reshape(-1))
            for m, k in enumerate(range(j - 1, -1, -1), start=2):
                c.add_q2_const_gate_diag(j, k)  # diagonal: control order free
                phase = np.exp(2j * np.pi / (1 << m)).astype(np_dt)
                gates.append(np.asarray([1, 1, 1, phase], np_dt))
        if swap_network:
            for i in range(self.n // 2):
                c.add_q2_const_gate(i, self.n - 1 - i)
                gates.append(swap.reshape(-1))
        c.get_q1_dens_op_with_grad(0)  # keep the tape non-empty of outputs
        self.circuit = c
        self._gates = gates
        self._state_fn = c.build_state_fn()

    def num_gates(self) -> int:
        return len(self._gates)

    def apply_to_basis_state(self, x: int) -> torch.Tensor:
        """QFT|x> as a statevector (closed form: amplitudes
        ``exp(2 pi i x y / 2^n) / sqrt(2^n)``)."""
        c2 = AutoGradCircuit(self.n, dtype=self.dtype, device=self.device)
        v = torch.zeros(1 << self.n, dtype=self.dtype,
                        device=config.resolve_device(self.device))
        v[x] = 1.0
        c2.set_state_from_vector(v)
        c2.tape = self.circuit.tape
        return c2.build_state_fn()([], self._gates)

    def exact(self, x: int) -> np.ndarray:
        n = self.n
        y = np.arange(1 << n)
        return (np.exp(2j * np.pi * x * y / (1 << n)) / np.sqrt(1 << n)).astype(
            _NP_COMPLEX[self.dtype])
