"""Hardware-efficient ansatz: parameterized 1q rotations + entangling rings.

Counterpart of ``dqc_tpu/models/hardware_efficient.py``: per layer, one
variable dense 1-qubit gate on every qubit followed by a ring of constant
entanglers (CNOT or CZ); observables are the 1-qubit densities of every
qubit, with a magnetization loss. In scan mode (the port's default at any
depth; the JAX class's from three layers on) the layer tape runs L times on
the plane engine (circuit/plane_scan.py), or off the planes below 14
qubits, at complex128 and under ``config.set_plane_engine(False)``
(circuit/scan.py); with ``scan=False`` the unrolled
circuit runs through ``AutoGradCircuit.build``'s engine
(builder.autodiff_densities: the plane tape, or the fused engine below 14
qubits and at complex128). ``densities`` and ``magnetization``
are differentiable in ``params`` with torch autograd (``loss.backward()``
is the counterpart of the JAX class's ``jax.value_and_grad``), through the
engine's O(1)-memory uncompute adjoint.

Both rings run at every n, forward and gradient, on the kernels from 14 to
30 qubits: the CZ ring
(n = 29 x 100 layers is the JAX package's bench workload) and the CNOT
ring, the JAX class's default, whose gates across group boundaries are
dense cross-group gates (one pass each of the multi-term kernels or of the
high kernels on a span view).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.builder import AutoGradCircuit, autodiff_densities
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.circuit.plane_scan import std_scan_with_epilogue
from dqc_tpu_torch.circuit.scan import fuse_layer
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet
from dqc_tpu_torch.ops.observables import expval_from_density

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


class HardwareEfficientAnsatz:
    def __init__(self, qubits_number: int, layers_number: int,
                 entangler: str = "cnot", dtype=None, device=None,
                 scan: bool = True):
        self.n = int(qubits_number)
        self.layers = int(layers_number)
        self.dtype = config.canonicalize_complex(dtype)
        self.device = config.resolve_device(device)
        self.scan = bool(scan)
        np_dt = _NP_COMPLEX[self.dtype]

        if entangler == "cnot":
            ent = np.array(
                [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                dtype=np_dt,
            ).reshape(-1)
            self._ent_diag = False
        elif entangler == "cz":
            ent = np.array([1, 1, 1, -1], dtype=np_dt)  # diagonal entries
            self._ent_diag = True
        else:
            raise ValueError(f"unknown entangler {entangler!r}")

        layer = AutoGradCircuit(self.n, dtype=self.dtype)
        self._add_layer(layer)
        epi = AutoGradCircuit(self.n, dtype=self.dtype)
        for i in range(self.n):
            epi.get_q1_dens_op_with_grad(i)
        self._layer_ftape = fuse_layer(layer.tape)
        self._epi_ftape = fuse_tape(epi.tape)
        self._layer_consts = tuple(self.n * [ent])
        self._z = np.array([[1, 0], [0, -1]], dtype=np_dt)
        self._const_gates = self.layers * list(self._layer_consts)

    @functools.cached_property
    def circuit(self) -> AutoGradCircuit:
        """The unrolled circuit (reference-compatible), built on first use:
        ``scan=False`` runs it, scan mode never does."""
        c = AutoGradCircuit(self.n, dtype=self.dtype, device=self.device)
        for _ in range(self.layers):
            self._add_layer(c)
        for i in range(self.n):
            c.get_q1_dens_op_with_grad(i)
        return c

    @functools.cached_property
    def _ftape(self):
        return fuse_tape(self.circuit.tape)

    def _add_layer(self, c: AutoGradCircuit) -> None:
        for i in range(self.n):
            c.add_q1_var_gate(i)
        for i in range(self.n - 1):
            if self._ent_diag:
                c.add_q2_const_gate_diag(i, i + 1)
            else:
                c.add_q2_const_gate(i, i + 1)
        if self._ent_diag:
            c.add_q2_const_gate_diag(0, self.n - 1)
        else:
            c.add_q2_const_gate(0, self.n - 1)

    @property
    def num_var_gates(self) -> int:
        return self.n * self.layers

    @property
    def num_gates(self) -> int:
        """Total gate applications per forward pass."""
        return 2 * self.n * self.layers

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        """``0.1 * N(0, 1)`` Euler angles ``(layers, n, 3)`` drawn from
        ``generator`` (on its device), placed on the model's device."""
        p = torch.randn((self.layers, self.n, 3), generator=generator,
                        dtype=config.real_of(self.dtype),
                        device=generator.device)
        return (0.1 * p).to(self.device)

    def _stacked_gates(self, params: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(layers, n, 3) params -> n per-qubit stacked slots of (L, 4)."""
        a, b, g = params[..., 0], params[..., 1], params[..., 2]
        dt = self.dtype
        ca, sa = torch.cos(a / 2).to(dt), torch.sin(a / 2).to(dt)
        eb = torch.exp(1j * b.to(dt))
        eg = torch.exp(1j * g.to(dt))
        mats = torch.stack([ca, -sa * eg, sa * eb, ca * eb * eg], dim=-1)  # (L, n, 4)
        return tuple(mats[:, q, :] for q in range(self.n))

    def params2gates(self, params: torch.Tensor) -> List[torch.Tensor]:
        """(layers, n, 3) Euler angles -> the unrolled circuit's var gates,
        flat (4,) SU(2) matrices in tape order."""
        mats = torch.stack(self._stacked_gates(params), dim=1)  # (L, n, 4)
        return [mats[l, q] for l in range(self.layers) for q in range(self.n)]

    def loss_from_gates(self, var_gates, *, kernels: KernelSet = KERNELS) -> torch.Tensor:
        """The magnetization taking the unrolled circuit's var gates."""
        dens = autodiff_densities(self._ftape, self.circuit.initial_state(),
                                  list(var_gates), self._const_gates,
                                  kernels=kernels)
        return torch.stack([expval_from_density(dm, self._z) for dm in dens]).sum()

    def densities(self, params, *, kernels: KernelSet = KERNELS) -> List[torch.Tensor]:
        """The n one-qubit density matrices (2, 2) after the circuit.
        ``kernels=ops.kernels.PLAIN`` runs the kernels' plain versions."""
        params = torch.as_tensor(params, device=self.device)
        if tuple(params.shape) != (self.layers, self.n, 3):
            raise ValueError(f"params must be ({self.layers}, {self.n}, 3), "
                             f"got {tuple(params.shape)}")
        if not self.scan:
            return list(autodiff_densities(
                self._ftape, self.circuit.initial_state(),
                self.params2gates(params), self._const_gates, kernels=kernels))
        return list(std_scan_with_epilogue(
            None, self._layer_ftape, self._epi_ftape, (),
            self._stacked_gates(params), self._layer_consts,
            dtype=self.dtype, device=self.device, kernels=kernels))

    def magnetization(self, params, *, kernels: KernelSet = KERNELS) -> torch.Tensor:
        """Sum of <Z_i> — the model's loss."""
        return torch.stack([expval_from_density(dm, self._z)
                            for dm in self.densities(params, kernels=kernels)]).sum()
