"""VQE for the transverse-field Ising model (ring topology).

Counterpart of ``dqc_tpu/models/vqe_ising.py``: the reference example's
ansatz of ``layers`` alternating layers of diagonal ZZ gates on
every ring edge and X rotations on every qubit, from the uniform
superposition (a const prologue of Hadamards on |0..0>), with every
nearest-neighbour 2-qubit density as observable and the TFIM energy
``sum tr(rho h)`` as the loss. Scan mode (the default from three layers
on, as in the JAX class) runs the layer tape L times on the plane engine;
``scan=False`` runs the unrolled circuit through ``AutoGradCircuit.build``'s
engine (builder.autodiff_densities). ``energy`` is differentiable in ``params``
with torch autograd (``loss.backward()`` is the counterpart of the JAX
class's ``jax.value_and_grad``).

On the plane engine (circuit/plane_scan.py) every layer is one dual sweep
with the ZZ gates across group boundaries folded in as a variable diagonal
run (their cotangents from block_backward_dual's Q reductions), plus the
high-group sweeps; the edge densities across groups come from a sub-block
contraction and their seeds from the multi-term kernels' seed modes.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

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


def hadamard_prologue(n: int, dtype) -> Tuple:
    """The |+>^n start: a const Hadamard on every qubit (fused tape and its
    const gates), shared with QAOAMaxCut."""
    pro = AutoGradCircuit(n, dtype=dtype)
    for i in range(n):
        pro.add_q1_const_gate(i)
    h2 = np.asarray([[1, 1], [1, -1]], dtype=_NP_COMPLEX[dtype]) / np.sqrt(2)
    return fuse_tape(pro.tape), n * [h2.reshape(-1)]


def unrolled_circuit(n: int, dtype, device, layers: int, add_layer, edges) -> AutoGradCircuit:
    """The reference-compatible unrolled circuit of the VQE / QAOA family:
    const Hadamards, ``layers`` ansatz layers, one diff density per edge."""
    c = AutoGradCircuit(n, dtype=dtype, device=device)
    for i in range(n):
        c.add_q1_const_gate(i)
    for _ in range(layers):
        add_layer(c)
    for a, b in edges:
        c.get_q2_dens_op_with_grad(a, b)
    return c


def x_rotation_stack(betas: torch.Tensor, dtype) -> torch.Tensor:
    """(L,) angles -> (L, 4) flat X-rotation gates ``exp(-i beta X)``."""
    cb = torch.cos(betas).to(dtype)
    sb = (-1j * torch.sin(betas)).to(dtype)
    return torch.stack([cb, sb, sb, cb], dim=-1)


class VQEIsing:
    """Variational ground-state search for H = -sum ZZ - h/2 * sum X pairs."""

    def __init__(self, qubits_number: int, layers_number: int,
                 magnetic_field: float = 1.0, dtype=None,
                 scan: Optional[bool] = None, device=None):
        self.n = int(qubits_number)
        self.layers = int(layers_number)
        self.field = float(magnetic_field)
        self.dtype = config.canonicalize_complex(dtype)
        self.scan = (self.layers >= 3) if scan is None else bool(scan)
        self.device = config.resolve_device(device)

        self._pro_ftape, self._const_gates = hadamard_prologue(self.n, self.dtype)
        layer = AutoGradCircuit(self.n, dtype=self.dtype)
        self._add_layer_gates(layer)
        epi = AutoGradCircuit(self.n, dtype=self.dtype)
        for i in range(self.n - 1):
            epi.get_q2_dens_op_with_grad(i, i + 1)
        epi.get_q2_dens_op_with_grad(0, self.n - 1)
        self._layer_ftape = fuse_layer(layer.tape)
        self._epi_ftape = fuse_tape(epi.tape)

        # two-site TFIM Hamiltonian term, (q2 q1) index order
        sz = np.array([[1, 0], [0, -1]], dtype=complex)
        sx = np.array([[0, 1], [1, 0]], dtype=complex)
        eye = np.eye(2, dtype=complex)
        self.h = (-np.kron(sz, sz)
                  - 0.5 * self.field * (np.kron(sx, eye) + np.kron(eye, sx))
                  ).astype(_NP_COMPLEX[self.dtype])
        self._h = torch.as_tensor(self.h, device=self.device)

    @functools.cached_property
    def circuit(self) -> AutoGradCircuit:
        """The unrolled circuit (reference-compatible), built on first use:
        ``scan=False`` runs it, scan mode never does."""
        return unrolled_circuit(
            self.n, self.dtype, self.device, self.layers, self._add_layer_gates,
            [(i, i + 1) for i in range(self.n - 1)] + [(0, self.n - 1)])

    @functools.cached_property
    def _ftape(self):
        return fuse_tape(self.circuit.tape)

    def _add_layer_gates(self, c: AutoGradCircuit) -> None:
        """One ansatz layer (reference example_vqse_ising.py:68-75)."""
        for i in range(self.n - 1):
            c.add_q2_var_gate_diag(i, i + 1)
        c.add_q2_var_gate_diag(0, self.n - 1)  # ring closure
        for i in range(self.n):
            c.add_q1_var_gate(i)

    def _stacked_gates(self, params: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(2L,) gammas/betas -> per-layer stacked gate slots: n copies of the
        (L, 4) ZZ diagonals, then n copies of the (L, 4) X rotations (one
        tensor per kind, repeated: autograd sums the slots' cotangents)."""
        gammas = params[0::2].to(self.dtype)
        e_m, e_p = torch.exp(-1j * gammas), torch.exp(1j * gammas)
        zz_stack = torch.stack([e_m, e_p, e_p, e_m], dim=-1)
        x_stack = x_rotation_stack(params[1::2], self.dtype)
        return tuple([zz_stack] * self.n + [x_stack] * self.n)

    def params2gates(self, params: torch.Tensor) -> List[torch.Tensor]:
        """(2L,) angles -> the unrolled circuit's var gates: per layer, n
        copies of zz(gamma), then n copies of x(beta)."""
        stacked = self._stacked_gates(params)
        return [stacked[q][l] for l in range(self.layers)
                for q in range(2 * self.n)]

    def init_params(self, generator: torch.Generator) -> torch.Tensor:
        """``N(0, 1)`` angles ``(2L,)`` drawn from ``generator`` (on its
        device), placed on the model's device."""
        p = torch.randn((2 * self.layers,), generator=generator,
                        dtype=config.real_of(self.dtype), device=generator.device)
        return p.to(self.device)

    def _params(self, params) -> torch.Tensor:
        params = torch.as_tensor(params, device=self.device)
        if tuple(params.shape) != (2 * self.layers,):
            raise ValueError(f"params must be ({2 * self.layers},), got "
                             f"{tuple(params.shape)}")
        return params

    def densities(self, params, *, kernels: KernelSet = KERNELS) -> List[torch.Tensor]:
        """The n edge densities (4, 4): (i, i + 1) for i < n - 1, then
        (0, n - 1). ``kernels=ops.kernels.PLAIN`` runs the plain versions."""
        if not self.scan:
            return list(autodiff_densities(
                self._ftape, self.circuit.initial_state(),
                self.params2gates(self._params(params)), self._const_gates,
                kernels=kernels))
        return list(std_scan_with_epilogue(
            self._pro_ftape, self._layer_ftape, self._epi_ftape,
            tuple(self._const_gates), self._stacked_gates(self._params(params)),
            (), dtype=self.dtype, device=self.device, kernels=kernels))

    def energy(self, params, *, kernels: KernelSet = KERNELS) -> torch.Tensor:
        """TFIM energy estimate (real scalar), differentiable in params."""
        return torch.stack([expval_from_density(dm, self._h)
                            for dm in self.densities(params, kernels=kernels)]).sum()

    def build_distributed_energy(self, *args, **kwargs):
        raise NotImplementedError(
            "VQEIsing.build_distributed_energy: the sharded state (parallel/) "
            "is not ported to dqc_tpu_torch yet; see ROADMAP.md")

    def exact_ground_energy(self) -> float:
        """Exact TFIM ground energy at the phase-transition point h = 1
        (reference example_vqse_ising.py:127)."""
        return float(-2.0 / np.sin(np.pi / (2 * self.n)))
