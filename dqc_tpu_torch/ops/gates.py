"""Common gate library.

Counterpart of ``dqc_tpu/ops/gates.py``: fixed gates and the parameterized
gates of the reference's examples, in the framework's layouts — dense
k-qubit gates as ``(2^k, 2^k)`` complex matrices (``.reshape(-1)`` gives
the reference's flat form), 2-qubit matrices indexed ``G[(q2 q1), (p2
p1)]`` with the first position the most significant bit, diagonal gates as
``2^k`` vectors. Fixed gates are complex tensors on the CPU (pass
``device`` for another); parameterized ones are differentiable torch
functions of their angle tensors, on the angle's device.
"""

from __future__ import annotations

import math

import torch

from dqc_tpu_torch import config


def _c(x, dtype, device=None) -> torch.Tensor:
    return torch.tensor(x, dtype=config.canonicalize_complex(dtype),
                        device=device)


def _angle(theta, dtype) -> torch.Tensor:
    """An angle as a real tensor (keeps its autograd history and device)."""
    real = config.real_of(dtype)
    if isinstance(theta, torch.Tensor):
        return theta.to(real)
    return torch.tensor(theta, dtype=real)


# --- fixed 1-qubit gates ----------------------------------------------------

def identity(k: int = 1, dtype=None, device=None) -> torch.Tensor:
    """Identity on k qubits."""
    return torch.eye(1 << k, dtype=config.canonicalize_complex(dtype),
                     device=device)


def hadamard(dtype=None, device=None) -> torch.Tensor:
    s = 1 / math.sqrt(2)
    return _c([[s, s], [s, -s]], dtype, device)


def pauli_x(dtype=None, device=None) -> torch.Tensor:
    return _c([[0, 1], [1, 0]], dtype, device)


def pauli_y(dtype=None, device=None) -> torch.Tensor:
    return _c([[0, -1j], [1j, 0]], dtype, device)


def pauli_z(dtype=None, device=None) -> torch.Tensor:
    return _c([[1, 0], [0, -1]], dtype, device)


def s_gate(dtype=None, device=None) -> torch.Tensor:
    return _c([[1, 0], [0, 1j]], dtype, device)


def t_gate(dtype=None, device=None) -> torch.Tensor:
    return _c([[1, 0], [0, complex(math.cos(math.pi / 4), math.sin(math.pi / 4))]],
              dtype, device)


# --- parameterized 1-qubit rotations ----------------------------------------

def _mat2(a, b, c, d) -> torch.Tensor:
    return torch.stack([torch.stack([a, b]), torch.stack([c, d])])


def rx(theta, dtype=None) -> torch.Tensor:
    """exp(-i theta/2 X)."""
    dtype = config.canonicalize_complex(dtype)
    th = _angle(theta, dtype)
    c = torch.cos(th / 2).to(dtype)
    s = (-1j * torch.sin(th / 2)).to(dtype)
    return _mat2(c, s, s, c)


def ry(theta, dtype=None) -> torch.Tensor:
    """exp(-i theta/2 Y)."""
    dtype = config.canonicalize_complex(dtype)
    th = _angle(theta, dtype)
    c = torch.cos(th / 2).to(dtype)
    s = torch.sin(th / 2).to(dtype)
    return _mat2(c, -s, s, c)


def rz(theta, dtype=None) -> torch.Tensor:
    """exp(-i theta/2 Z)."""
    dtype = config.canonicalize_complex(dtype)
    th = _angle(theta, dtype).to(dtype)
    em, ep = torch.exp(-0.5j * th), torch.exp(0.5j * th)
    z = torch.zeros((), dtype=dtype, device=th.device)
    return _mat2(em, z, z, ep)


def phase(phi, dtype=None) -> torch.Tensor:
    """diag(1, e^{i phi}) as a dense matrix."""
    dtype = config.canonicalize_complex(dtype)
    ph = _angle(phi, dtype).to(dtype)
    one = torch.ones((), dtype=dtype, device=ph.device)
    z = torch.zeros((), dtype=dtype, device=ph.device)
    return _mat2(one, z, z, torch.exp(1j * ph))


def x_rotation(beta, dtype=None) -> torch.Tensor:
    """The reference example's ``x(beta)`` gate, ``[[cos b, -i sin b],
    [-i sin b, cos b]]``, i.e. RX(2 beta)."""
    dtype = config.canonicalize_complex(dtype)
    b = _angle(beta, dtype)
    c = torch.cos(b).to(dtype)
    s = (-1j * torch.sin(b)).to(dtype)
    return _mat2(c, s, s, c)


# --- fixed 2-qubit gates -----------------------------------------------------

def cnot(dtype=None, device=None) -> torch.Tensor:
    """CNOT with the most significant position (pos2) as control."""
    return _c([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype,
              device)


def cz(dtype=None, device=None) -> torch.Tensor:
    return torch.diag(_c([1, 1, 1, -1], dtype, device))


def swap(dtype=None, device=None) -> torch.Tensor:
    return _c([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype,
              device)


def cz_diag(dtype=None, device=None) -> torch.Tensor:
    """CZ as a diagonal gate (its 4 entries)."""
    return _c([1, 1, 1, -1], dtype, device)


# --- parameterized 2-qubit gates ----------------------------------------------

def zz(gamma, dtype=None) -> torch.Tensor:
    """Diagonal ZZ interaction exp(-i gamma Z (x) Z) as 4 diagonal entries."""
    dtype = config.canonicalize_complex(dtype)
    g = _angle(gamma, dtype).to(dtype)
    e_m, e_p = torch.exp(-1j * g), torch.exp(1j * g)
    return torch.stack([e_m, e_p, e_p, e_m])


def cphase(phi, dtype=None) -> torch.Tensor:
    """Controlled phase as 4 diagonal entries: diag(1, 1, 1, e^{i phi})."""
    dtype = config.canonicalize_complex(dtype)
    ph = _angle(phi, dtype).to(dtype)
    one = torch.ones((), dtype=dtype, device=ph.device)
    return torch.stack([one, one, one, torch.exp(1j * ph)])


def controlled(u, dtype=None) -> torch.Tensor:
    """A 1-qubit gate as its controlled 2-qubit version (control = the most
    significant position)."""
    dtype = config.canonicalize_complex(dtype)
    u = torch.as_tensor(u).to(dtype).reshape(2, 2)
    top = torch.cat([torch.eye(2, dtype=dtype, device=u.device),
                     torch.zeros((2, 2), dtype=dtype, device=u.device)], dim=1)
    bottom = torch.cat([torch.zeros((2, 2), dtype=dtype, device=u.device), u], dim=1)
    return torch.cat([top, bottom], dim=0)
