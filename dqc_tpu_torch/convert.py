"""Carry-over between the JAX package and the port, through numpy.

The two packages exchange data only as numpy arrays: the Euler angles of
the hardware-efficient ansatz, ``(L, n, 3)``, the flat ``(gamma, beta)``
vector of VQEIsing and QAOAMaxCut, ``(2L,)``, plane states, two f32
arrays ``(A, 128, 128)``, and the gate lists and initial state of an
``AutoGradCircuit`` (``build()``'s ``var_gates`` / ``const_gates``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dqc_tpu_torch import config


def params_from_jax(params, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(L, n, 3)`` Euler angles or a flat ``(2L,)`` angle vector (a numpy
    array, or any array numpy can read) -> a tensor of ``dtype`` on
    ``device`` (default: the card)."""
    a = np.asarray(params)
    flat = a.ndim == 1 and a.shape[0] % 2 == 0
    if not flat and (a.ndim != 3 or a.shape[-1] != 3):
        raise ValueError(f"expected (layers, n, 3) or (2 layers,) angles, got "
                         f"{a.shape}")
    return torch.tensor(a, dtype=dtype, device=config.resolve_device(device))


def gates_from_jax(var_gates, const_gates, initial_state=None, *, dtype=None,
                   device=None):
    """An ``AutoGradCircuit``'s gate lists (numpy-readable arrays, flat or
    square) and optional flat initial state -> the port's form: the var
    gates as complex tensors on ``device`` (default: the card), to take
    gradients; the const gates as host numpy arrays, so that equal
    constants share one expanded operator; the state as a complex tensor
    on ``device`` (None stays None)."""
    dt = config.canonicalize_complex(dtype)
    dev = config.resolve_device(device)
    np_dt = np.complex64 if dt == torch.complex64 else np.complex128
    vg = [torch.tensor(np.asarray(g, dtype=np_dt), device=dev) for g in var_gates]
    cg = [np.asarray(g, dtype=np_dt) for g in const_gates]
    state = None
    if initial_state is not None:
        state = torch.tensor(np.asarray(initial_state, dtype=np_dt).reshape(-1),
                             device=dev)
    return vg, cg, state


def planes_from_jax(xr, xi, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane state ``(xr, xi)`` (numpy-readable f32 arrays) -> contiguous
    f32 tensors on ``device`` (default: the card)."""
    dev = config.resolve_device(device)
    out = []
    for p in (xr, xi):
        a = np.asarray(p, dtype=np.float32)
        if a.ndim != 3 or a.shape[1:] != (128, 128):
            raise ValueError(f"expected (A, 128, 128) planes, got {a.shape}")
        out.append(torch.tensor(a, device=dev))
    return out[0], out[1]


def planes_to_numpy(xr: torch.Tensor, xi: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Plane tensors (any view of the planes) -> two f32 numpy arrays
    ``(A, 128, 128)``."""
    return tuple(p.detach().to("cpu", torch.float32).reshape(-1, 128, 128).numpy()
                 for p in (xr, xi))
