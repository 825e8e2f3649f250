"""Carry-over between the JAX package and the port, through numpy.

The two packages exchange data only as numpy arrays: the Euler angles of
the hardware-efficient ansatz, ``(L, n, 3)``, and plane states, two f32
arrays ``(A, 128, 128)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dqc_tpu_torch import config


def params_from_jax(params, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(L, n, 3)`` Euler angles (a numpy array, or any array numpy can
    read) -> a tensor of ``dtype`` on ``device`` (default: the card)."""
    a = np.asarray(params)
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"expected (layers, n, 3) angles, got {a.shape}")
    return torch.tensor(a, dtype=dtype, device=config.resolve_device(device))


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
