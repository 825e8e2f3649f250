"""Core statevector operations on a flat complex tensor.

Counterpart of ``dqc_tpu/ops/statevector.py``: gate application, reduced
density matrices and the gate-gradient contractions of the per-gate
adjoint, on a flat state of ``2**n`` amplitudes. Qubit ``pos`` is bit
``pos`` of the flat index (qubit 0 the fastest-varying bit); a k-qubit
gate on ``positions = (p_{k-1}, ..., p_0)`` is a ``2^k x 2^k`` matrix whose
first position is its most significant bit. Gates may be flat (``4^k``
entries) or square; diagonal gates are ``2^k`` vectors.

Every op views the state with the target qubits as a leading ``2^k`` axis
(a reshape and a permute) and runs one ``(2^k, 2^k) @ (2^k, 2^(n-k))``
product; the reductions over the other ``2^(n-k)`` amplitudes (densities,
gate gradients) sum in two levels (ops.kernels.gram.pair_sum). Gates may be numpy arrays or tensors; they are cast to the
state's dtype and device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.ops.kernels.gram import pair_sum


def _as_tensor(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a tensor of ``ref``'s dtype and
    device; a tensor keeps its autograd history."""
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.array(x), device=ref.device).to(ref.dtype)


def num_qubits(state: torch.Tensor) -> int:
    """Number of qubits of a flat statevector (validates power-of-2 size)."""
    size = state.numel()
    n = size.bit_length() - 1
    if (1 << n) != size:
        raise ValueError(f"state size {size} is not a power of two")
    return n


def standard_state(n: int, dtype=None, device=None) -> torch.Tensor:
    """|0...0> on ``n`` qubits, on ``device`` (default: the card)."""
    dtype = config.canonicalize_complex(dtype)
    out = torch.zeros((1 << n,), dtype=dtype, device=config.resolve_device(device))
    out[0] = 1.0
    return out


def _segment_dims(n: int, sorted_desc: Sequence[int]) -> Tuple[int, ...]:
    """``2^n`` as interleaved (segment, qubit, segment, ...) dims for
    strictly descending qubit positions."""
    dims = []
    prev = n
    for p in sorted_desc:
        dims.append(1 << (prev - p - 1))
        dims.append(2)
        prev = p
    dims.append(1 << prev)
    return tuple(dims)


def _qubits_to_front(state: torch.Tensor, positions: Sequence[int], n: int):
    """View ``state`` as ``(2^k, 2^(n-k))`` with the target qubits leading
    (bit significance in ``positions`` order), and what
    :func:`_qubits_from_front` needs to undo it."""
    k = len(positions)
    sorted_desc = sorted(positions, reverse=True)
    dims = _segment_dims(n, sorted_desc)
    axis_of = {p: 2 * i + 1 for i, p in enumerate(sorted_desc)}
    perm = [axis_of[p] for p in positions] + [2 * i for i in range(k + 1)]
    t = state.reshape(dims).permute(perm)
    return t.reshape(1 << k, -1), (dims, perm)


def _qubits_from_front(mat: torch.Tensor, restore, out_shape) -> torch.Tensor:
    dims, perm = restore
    t = mat.reshape(tuple(dims[a] for a in perm))
    inv = [0] * len(perm)
    for i, a in enumerate(perm):
        inv[a] = i
    return t.permute(inv).reshape(out_shape)


def _as_matrix(gate, k: int, ref: torch.Tensor) -> torch.Tensor:
    """A k-qubit gate as a ``(2^k, 2^k)`` tensor like ``ref``."""
    d = 1 << k
    g = _as_tensor(gate, ref)
    if g.numel() != d * d:
        raise ValueError(f"gate has {g.numel()} entries, expected {d * d}")
    return g.reshape(d, d)


def _check_positions(positions: Sequence[int], n: int) -> Tuple[int, ...]:
    positions = tuple(int(p) for p in positions)
    if len(set(positions)) != len(positions):
        raise ValueError(f"duplicate qubit positions {positions}")
    for p in positions:
        if not (0 <= p < n):
            raise ValueError(f"qubit position {p} out of range for {n} qubits")
    return positions


# ---------------------------------------------------------------------------
# Gate application
# ---------------------------------------------------------------------------

def apply_gate(state: torch.Tensor, gate, positions: Sequence[int]) -> torch.Tensor:
    """Apply a dense k-qubit gate: ``psi' = (G (x) I) psi``."""
    n = num_qubits(state)
    positions = _check_positions(positions, n)
    g = _as_matrix(gate, len(positions), state)
    mat, restore = _qubits_to_front(state, positions, n)
    return _qubits_from_front(torch.matmul(g, mat), restore, state.shape)


def apply_1q(state: torch.Tensor, gate, pos: int) -> torch.Tensor:
    """Apply a dense 1-qubit gate."""
    return apply_gate(state, gate, (pos,))


def apply_2q(state: torch.Tensor, gate, pos2: int, pos1: int) -> torch.Tensor:
    """Apply a dense 2-qubit gate ``G[(q2 q1), (p2 p1)]`` (``pos2`` is the
    gate's most significant qubit)."""
    return apply_gate(state, gate, (pos2, pos1))


def apply_diag(state: torch.Tensor, diag, positions: Sequence[int]) -> torch.Tensor:
    """Apply a diagonal k-qubit gate given its ``2^k`` diagonal entries."""
    n = num_qubits(state)
    positions = _check_positions(positions, n)
    d = _as_tensor(diag, state).reshape(1 << len(positions))
    mat, restore = _qubits_to_front(state, positions, n)
    return _qubits_from_front(d[:, None] * mat, restore, state.shape)


def apply_2q_diag(state: torch.Tensor, diag, pos2: int, pos1: int) -> torch.Tensor:
    """Apply a diagonal 2-qubit gate (4 entries indexed ``(q2 q1)``)."""
    return apply_diag(state, diag, (pos2, pos1))


# ---------------------------------------------------------------------------
# Observables
# ---------------------------------------------------------------------------

def density(state: torch.Tensor, positions: Sequence[int]) -> torch.Tensor:
    """Reduced density matrix of the given qubits, ``rho[i, j] = sum_b
    psi[i, b] conj(psi[j, b])`` (``i``, ``j`` in ``positions`` bit order)."""
    n = num_qubits(state)
    positions = _check_positions(positions, n)
    mat, _ = _qubits_to_front(state, positions, n)
    return pair_sum(mat[None], mat.conj()[None])


def density_1q(state: torch.Tensor, pos: int) -> torch.Tensor:
    return density(state, (pos,))


def density_2q(state: torch.Tensor, pos2: int, pos1: int) -> torch.Tensor:
    return density(state, (pos2, pos1))


def expectation(state: torch.Tensor, op, positions: Sequence[int]) -> torch.Tensor:
    """``<psi| (Op (x) I) |psi>`` for a k-qubit operator (complex scalar)."""
    n = num_qubits(state)
    positions = _check_positions(positions, n)
    o = _as_matrix(op, len(positions), state)
    mat, _ = _qubits_to_front(state, positions, n)
    return torch.sum(mat.conj() * torch.matmul(o, mat))


def norm(state: torch.Tensor) -> torch.Tensor:
    """L2 norm of the statevector."""
    return torch.sqrt(torch.sum(state.abs() ** 2))


def fidelity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|<a|b>|^2``."""
    return torch.abs(torch.vdot(a.reshape(-1), b.reshape(-1))) ** 2


# ---------------------------------------------------------------------------
# Adjoint-pass contractions (the per-gate O(1)-memory adjoint)
# ---------------------------------------------------------------------------

def gate_grad(fwd: torch.Tensor, bwd: torch.Tensor, positions: Sequence[int]) -> torch.Tensor:
    """Cotangent of a dense k-qubit gate, ``G_bar[p, q] = sum_b bwd[p, b]
    fwd[q, b]`` (holomorphic: no conjugation), ``fwd`` the state entering
    the gate and ``bwd`` the cotangent state. Returned square."""
    n = num_qubits(fwd)
    positions = tuple(int(p) for p in positions)
    f, _ = _qubits_to_front(fwd, positions, n)
    b, _ = _qubits_to_front(bwd, positions, n)
    return pair_sum(b[None], f[None])


def diag_gate_grad(fwd: torch.Tensor, bwd: torch.Tensor, positions: Sequence[int]) -> torch.Tensor:
    """Cotangent of a diagonal k-qubit gate: ``d_bar[i] = sum_b bwd[i, b]
    fwd[i, b]``."""
    n = num_qubits(fwd)
    positions = tuple(int(p) for p in positions)
    f, _ = _qubits_to_front(fwd, positions, n)
    b, _ = _qubits_to_front(bwd, positions, n)
    return torch.sum(b * f, dim=1)


def apply_gate_adjoint(state: torch.Tensor, gate, positions: Sequence[int]) -> torch.Tensor:
    """Apply ``G^dagger``: the uncompute of a unitary gate."""
    g = _as_matrix(gate, len(positions), state)
    return apply_gate(state, g.conj().T, positions)


def apply_gate_transpose(state: torch.Tensor, gate, positions: Sequence[int]) -> torch.Tensor:
    """Apply ``G^T``: the cotangent transport."""
    g = _as_matrix(gate, len(positions), state)
    return apply_gate(state, g.T, positions)


def apply_gate_inverse(state: torch.Tensor, gate, positions: Sequence[int],
                       ctx: str = "gate") -> torch.Tensor:
    """Apply ``G^-1``: the uncompute of a non-unitary gate (a constant gate
    is inverted on the host with a singularity check, ops/inversion.py)."""
    from dqc_tpu_torch.ops import inversion

    k = len(positions)
    g = (_as_matrix(gate, k, state) if isinstance(gate, torch.Tensor)
         else np.asarray(gate).reshape(1 << k, 1 << k))
    return apply_gate(state, inversion.invert_gate(g, unitary=False, ctx=ctx),
                      positions)


def probabilities(state: torch.Tensor) -> torch.Tensor:
    """Measurement probabilities ``|psi_i|^2``."""
    return (state * state.conj()).real


def sample_bitstrings(state: torch.Tensor, generator: torch.Generator,
                      shots: int) -> torch.Tensor:
    """``shots`` basis indices (int32; qubit 0 the least significant bit)
    drawn from ``|psi_i|^2`` with ``generator`` (on the state's device)."""
    from dqc_tpu_torch.ops.observables import sample

    return sample(state, shots, generator).to(torch.int32)
