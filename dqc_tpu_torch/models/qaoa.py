"""QAOA for weighted MaxCut on an arbitrary graph.

Counterpart of ``dqc_tpu/models/qaoa.py``: the VQE circuit family (alternating diagonal ZZ-cost and X-mixer layers from |+>^n) over an
arbitrary weighted edge list with per-layer (gamma, beta) parameters. The
cut is read from the edge 2-qubit densities: ``cut = sum_e w_e (1 - <Z Z>_e)
/ 2``. ``loss`` is differentiable in ``params`` with torch autograd. Scan
mode (the default from three layers on) runs the layer tape on the plane
engine; ``scan=False`` the unrolled circuit through ``AutoGradCircuit
.build``'s engine.

On the plane engine the cost gates across group boundaries form one
variable diagonal run folded into the dual sweep; edges that span several
groups read their densities from a sub-block contraction, and seed the
gradient through the multi-term kernels' seed modes, a span view, or
per-term sweeps for the widest pairs.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.builder import AutoGradCircuit
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.circuit.plane_scan import std_scan_with_epilogue
from dqc_tpu_torch.circuit.scan import fuse_layer
from dqc_tpu_torch.circuit.builder import autodiff_densities
from dqc_tpu_torch.models.vqe_ising import (
    _NP_COMPLEX,
    hadamard_prologue,
    unrolled_circuit,
    x_rotation_stack,
)
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet
from dqc_tpu_torch.ops.observables import expval_from_density


class QAOAMaxCut:
    def __init__(self, qubits_number: int, edges: Sequence[Tuple[int, int]],
                 weights: Optional[Sequence[float]] = None,
                 layers_number: int = 2, dtype=None,
                 scan: Optional[bool] = None, device=None):
        self.n = int(qubits_number)
        self.edges = [(int(a), int(b)) for a, b in edges]
        self.weights = (np.ones(len(self.edges)) if weights is None
                        else np.asarray(weights, float))
        if len(self.weights) != len(self.edges):
            raise ValueError("one weight per edge required")
        self.layers = int(layers_number)
        self.dtype = config.canonicalize_complex(dtype)
        self.scan = (self.layers >= 3) if scan is None else bool(scan)
        self.device = config.resolve_device(device)

        self._pro_ftape, self._const_gates = hadamard_prologue(self.n, self.dtype)
        layer = AutoGradCircuit(self.n, dtype=self.dtype)
        self._add_layer(layer)
        epi = AutoGradCircuit(self.n, dtype=self.dtype)
        for (a, b) in self.edges:
            epi.get_q2_dens_op_with_grad(a, b)
        self._layer_ftape = fuse_layer(layer.tape)
        self._epi_ftape = fuse_tape(epi.tape)
        zz = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
        self._zz = torch.as_tensor(zz.astype(_NP_COMPLEX[self.dtype]),
                                   device=self.device)
        self._w = torch.as_tensor(self.weights, dtype=config.real_of(self.dtype),
                                  device=self.device)

    @functools.cached_property
    def circuit(self) -> AutoGradCircuit:
        """The unrolled circuit (reference-compatible), built on first use:
        ``scan=False`` runs it, scan mode never does."""
        return unrolled_circuit(self.n, self.dtype, self.device, self.layers,
                                self._add_layer, self.edges)

    @functools.cached_property
    def _ftape(self):
        return fuse_tape(self.circuit.tape)

    def _add_layer(self, c: AutoGradCircuit) -> None:
        for (a, b) in self.edges:
            c.add_q2_var_gate_diag(a, b)
        for i in range(self.n):
            c.add_q1_var_gate(i)

    def params2gates(self, params: torch.Tensor) -> List[torch.Tensor]:
        """(2L,) angles -> the unrolled circuit's var gates: per layer, one
        cost diagonal per edge, then n mixers."""
        stacked = self._stacked_gates(params)
        return [slot[l] for l in range(self.layers) for slot in stacked]

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        """``0.1 * N(0, 1)`` angles ``(2L,)`` drawn from ``generator`` (on
        its device), placed on the model's device."""
        p = torch.randn((2 * self.layers,), generator=generator,
                        dtype=config.real_of(self.dtype), device=generator.device)
        return (0.1 * p).to(self.device)

    def _edge_diag(self, gamma: torch.Tensor, w: float) -> torch.Tensor:
        """exp(-i gamma w Z(x)Z) diagonal entries, (q2 q1) order."""
        phase = gamma * w
        e_m = torch.exp(-1j * phase).to(self.dtype)
        e_p = torch.exp(1j * phase).to(self.dtype)
        return torch.stack([e_m, e_p, e_p, e_m], dim=-1)

    def _stacked_gates(self, params: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        gammas = params[0::2]
        slots = [self._edge_diag(gammas, float(w)) for w in self.weights]
        return tuple(slots + self.n * [x_rotation_stack(params[1::2], self.dtype)])

    def _densities(self, params, kernels: KernelSet) -> List[torch.Tensor]:
        params = torch.as_tensor(params, device=self.device)
        if tuple(params.shape) != (2 * self.layers,):
            raise ValueError(f"params must be ({2 * self.layers},), got "
                             f"{tuple(params.shape)}")
        if not self.scan:
            return list(autodiff_densities(
                self._ftape, self.circuit.initial_state(),
                self.params2gates(params), self._const_gates, kernels=kernels))
        return list(std_scan_with_epilogue(
            self._pro_ftape, self._layer_ftape, self._epi_ftape,
            tuple(self._const_gates), self._stacked_gates(params), (),
            dtype=self.dtype, device=self.device, kernels=kernels))

    def expected_cut(self, params, *, kernels: KernelSet = KERNELS) -> torch.Tensor:
        """Expected cut value (to be maximized)."""
        zz = torch.stack([expval_from_density(dm, self._zz)
                          for dm in self._densities(params, kernels)])
        return (self._w * (1.0 - zz) / 2.0).sum()

    def loss(self, params, *, kernels: KernelSet = KERNELS) -> torch.Tensor:
        """Negative expected cut (minimize)."""
        return -self.expected_cut(params, kernels=kernels)

    def exact_maxcut(self) -> float:
        """Brute-force optimum (small n only)."""
        if self.n > 20:
            raise ValueError("brute force limited to 20 qubits")
        best = 0.0
        for mask in range(1 << self.n):
            cut = 0.0
            for (a, b), w in zip(self.edges, self.weights):
                if ((mask >> a) & 1) != ((mask >> b) & 1):
                    cut += w
            best = max(best, cut)
        return float(best)
