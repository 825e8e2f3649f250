"""Observables read from reduced density matrices.

Counterpart of ``expval_from_density`` in ``dqc_tpu/ops/observables.py``.
"""

from __future__ import annotations

import torch


def expval_from_density(rho: torch.Tensor, op) -> torch.Tensor:
    """``tr(rho O)`` (real part — O is assumed Hermitian)."""
    op = torch.as_tensor(op, dtype=rho.dtype, device=rho.device)
    return torch.einsum("ij,ji->", rho, op).real
