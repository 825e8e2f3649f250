"""GHZ state preparation: a Hadamard on qubit 0 and a CNOT chain.

Counterpart of ``dqc_tpu/models/ghz.py`` (the reference's functional test
workload, reference src/test_ghz.py), through ``AutoGradCircuit.build``
and ``build_state_fn``. Every one-qubit density of the GHZ state is
``I / 2``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.builder import AutoGradCircuit

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


class GHZ:
    def __init__(self, qubits_number: int, dtype=None, densities: bool = True,
                 device=None):
        self.n = int(qubits_number)
        self.dtype = config.canonicalize_complex(dtype)
        np_dt = _NP_COMPLEX[self.dtype]
        h2 = (np.asarray([[1, 1], [1, -1]]) / np.sqrt(2)).astype(np_dt)
        cx = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                        np_dt)
        self._gates = [h2.reshape(-1)] + (self.n - 1) * [cx.reshape(-1)]

        c = AutoGradCircuit(self.n, dtype=self.dtype, device=device)
        c.add_q1_const_gate(0)
        for i in range(self.n - 1):
            c.add_q2_const_gate(i, i + 1)
        if densities:
            for i in range(self.n):
                c.get_q1_dens_op_with_grad(i)
        else:
            c.get_q1_dens_op_with_grad(0)
        self.circuit = c
        self._state_fn = c.build_state_fn()
        _, self._run = c.build()

    def state(self) -> torch.Tensor:
        """The prepared GHZ statevector."""
        return self._state_fn([], self._gates)

    def densities(self) -> List[torch.Tensor]:
        """All requested density matrices (each I/2 for a perfect GHZ)."""
        return self._run([], self._gates)

    def fidelity(self) -> float:
        """|<GHZ|psi>|^2 against the exact GHZ state."""
        psi = self.state()
        amp = (psi[0] + psi[-1]) / np.sqrt(2)
        return float(abs(amp.item()) ** 2)
