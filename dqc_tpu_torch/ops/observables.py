"""Observables and measurement utilities.

Counterpart of ``dqc_tpu/ops/observables.py`` (its ``PauliSum`` is not
ported): expectation values read from reduced density matrices, Pauli
strings, bitstring sampling and fidelity. Random sampling takes an explicit ``torch.Generator`` (on the
state's device), where the JAX package takes a key.
"""

from __future__ import annotations

import numpy as np
import torch

from dqc_tpu_torch import config

_PAULI = {
    "I": np.eye(2, dtype=np.complex128),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
}
_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def pauli_matrix(s: str, dtype=None) -> np.ndarray:
    """Kron of single-qubit Paulis, msb-first: ``pauli_matrix("ZX")`` acts
    with Z on the higher (first) listed qubit, matching the density index
    convention ``rho[(q2 q1), (p2 p1)]``. Host numpy, like the JAX
    package's."""
    dtype = config.canonicalize_complex(dtype)
    m = np.eye(1, dtype=np.complex128)
    for ch in s:
        m = np.kron(m, _PAULI[ch.upper()])
    return m.astype(_NP_COMPLEX[dtype])


def expval_from_density(rho: torch.Tensor, op) -> torch.Tensor:
    """``tr(rho O)`` (real part — O is assumed Hermitian)."""
    op = torch.as_tensor(op, dtype=rho.dtype, device=rho.device)
    return torch.einsum("ij,ji->", rho, op).real


def sample(state: torch.Tensor, shots: int, generator: torch.Generator) -> torch.Tensor:
    """``shots`` basis-state indices drawn from ``|psi_i|^2`` with
    ``generator`` (on the state's device): inverse-CDF sampling on the f64
    cumulative sum, which, unlike ``torch.multinomial``, takes any number of
    amplitudes."""
    p = state.reshape(-1).abs().to(torch.float64) ** 2
    cdf = torch.cumsum(p, 0)
    u = torch.rand((shots,), generator=generator, dtype=torch.float64,
                   device=p.device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=p.numel() - 1)


def sample_counts(state: torch.Tensor, shots: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Histogram of :func:`sample` over the full computational basis."""
    idx = sample(state, shots, generator)
    return torch.bincount(idx, minlength=state.numel())


def fidelity(state_a: torch.Tensor, state_b: torch.Tensor) -> torch.Tensor:
    """``|<a|b>|^2`` for normalized statevectors."""
    a = torch.as_tensor(state_a).reshape(-1)
    b = torch.as_tensor(state_b).reshape(-1).to(device=a.device, dtype=a.dtype)
    return torch.abs(torch.vdot(a, b)) ** 2
