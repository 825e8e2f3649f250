"""Checked gate inversion for the uncompute of the O(1)-memory adjoint.

Counterpart of ``dqc_tpu/ops/inversion.py`` (``invert_gate``,
``invert_diag``) under its default policy ("host" checks). The adjoint rolls
the forward state back by applying ``G^-1``: a unitary gate inverts by its
conjugate transpose (a diagonal one by its conjugate), any other gate by a
true inverse. A (near-)singular gate would turn every gradient into inf/nan,
so a constant gate (host numpy) is inverted on the host with a condition
check that raises a ``ValueError`` naming the gate before any device work.
A variable gate (a torch tensor) is inverted on its device with
``torch.linalg.inv``, unchecked: the JAX package's debug-mode guard of
traced gates has no counterpart yet.
"""

from __future__ import annotations

import numpy as np
import torch

from dqc_tpu_torch.ops import groups as gr


def _msg(ctx: str, detail: str) -> str:
    return (
        f"singular non-unitary gate during uncompute ({ctx}): {detail}. "
        "The O(1)-memory adjoint inverts non-unitary gates to roll the "
        "forward state back; regularize the gate (e.g. unitary + small "
        "perturbation) so its inverse is well-conditioned."
    )


def _cond_limit(dtype) -> float:
    # past ~0.1/eps the uncomputed state has no correct bits left
    return 0.1 / float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)


def invert_gate(m, unitary: bool, ctx: str = "gate"):
    """``G^-1`` (``G^dagger`` for a unitary gate). A constant stays host
    numpy (so that it keeps value-memoisation); a tensor stays on its
    device."""
    c = gr.concrete_or_none(m)
    if c is not None:
        if unitary:
            return c.conj().T
        try:
            inv = np.linalg.inv(c)
        except np.linalg.LinAlgError as e:
            raise ValueError(_msg(ctx, str(e))) from None
        cond = float(np.linalg.cond(c))
        if not np.all(np.isfinite(inv)) or cond > _cond_limit(c.dtype):
            raise ValueError(_msg(ctx, f"condition number {cond:.3e}"))
        return inv
    if unitary:
        return m.conj().transpose(-2, -1)
    return torch.linalg.inv(m)


def invert_diag(d, unitary: bool, ctx: str = "diag gate"):
    """Elementwise inverse of a diagonal gate, checked like invert_gate."""
    c = gr.concrete_or_none(d)
    if c is not None:
        if unitary:
            return c.conj()
        mags = np.abs(c)
        if mags.min() == 0.0 or mags.max() / mags.min() > _cond_limit(c.dtype):
            detail = ("zero diagonal entry" if mags.min() == 0.0
                      else f"entry magnitude ratio {mags.max() / mags.min():.3e}")
            raise ValueError(_msg(ctx, detail))
        return 1.0 / c
    if unitary:
        return d.conj()
    return 1.0 / d
