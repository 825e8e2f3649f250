"""Plane-layout statevector ops: a complex64 state as two f32 planes.

Counterpart of the forward subset of ``dqc_tpu/ops/planes.py``. Inside the
layer loop (circuit/plane_scan.py) the state lives as a pair of float32
planes

    ``(xr, xi)``, each of shape ``(A, 128, 128)``, ``A = 2^(n-14)``,

the canonical grouped view (ops/groups.py): lane group = qubits 0..6 on the
last axis, sublane group = 7..13 on the middle axis, all higher groups
merged msb-first into the leading axis.

Op mapping (one pass over the state each):
* dense blocks on groups 0+1   -> the dual-group kernel (ops/kernels/dual_apply)
* dense block on group j >= 2  -> the high-axis kernel (ops/kernels/high_apply)
* a diagonal run next to either -> multiplied inside that kernel's pass
* group Grams (densities)      -> the Gram kernel (ops/kernels/gram)

Every apply consumes its input planes and returns the result (in place on
the card). ``kernels`` selects the wrappers (default) or the plain versions
(``ops.kernels.PLAIN``), the yardstick for the kernels on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.ops import groups as gr
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet

# a high-group kernel takes a contracted axis of at least 8 (the TPU
# kernels' tiling floor, kept so that both packages schedule alike)
MIN_KERNEL_X = 8

Planes = Tuple[torch.Tensor, torch.Tensor]


def plane_eligible(n: int, dtype) -> bool:
    """Plane layout requires both minor groups full (n >= 14) and complex64."""
    return n >= 14 and config.canonicalize_complex(dtype) == torch.complex64


def plane_shape(n: int) -> Tuple[int, int, int]:
    return (1 << (n - 14), 128, 128)


def to_planes(state: torch.Tensor, n: int) -> Planes:
    """Flat or grouped complex state -> (xr, xi) f32 planes."""
    t = state.reshape(plane_shape(n))
    return (t.real.to(torch.float32).contiguous(),
            t.imag.to(torch.float32).contiguous())


def from_planes(xr: torch.Tensor, xi: torch.Tensor, n: int) -> torch.Tensor:
    """(xr, xi) planes -> flat complex64 state."""
    return torch.complex(xr.to(torch.float32), xi.to(torch.float32)).reshape(-1)


def standard_planes(n: int, device=None) -> Planes:
    """|0...0> directly as planes — no 2^n complex buffer is built."""
    device = config.resolve_device(device)
    shape = plane_shape(n)
    xr = torch.zeros(shape, dtype=config.fwd_plane_dtype(), device=device)
    xr[0, 0, 0] = 1.0
    return xr, torch.zeros(shape, dtype=config.fwd_plane_dtype(), device=device)


def op_planes(E, device) -> Planes:
    """Complex operator (host numpy or tensor) -> contiguous f32 (real, imag)
    on ``device``."""
    E = torch.as_tensor(E, device=device).to(torch.complex64)
    return (E.real.to(torch.float32).contiguous(),
            E.imag.to(torch.float32).contiguous())


def _table_planes(tables, device):
    """Complex ``(tsl, tas, tal)`` -> the six f32 table planes of the
    fused-run kernels."""
    if tables is None:
        return None
    out = []
    for t in tables:
        out.extend(op_planes(t, device))
    return tuple(out)


# ---------------------------------------------------------------------------
# High-group axis views
# ---------------------------------------------------------------------------

def _high_view(n: int, j: int) -> Tuple[int, int, int]:
    """(pre, X, M) such that planes.reshape(pre, X, M, 128) puts group ``j``'s
    bits on axis 1 (j >= 2; M merges lower high groups with the sublane
    axis)."""
    dims = gr.group_dims(n)  # msb-first
    G = len(dims)
    ax = G - 1 - j  # axis of group j in the grouped view
    pre = int(np.prod(dims[:ax], dtype=np.int64)) if ax > 0 else 1
    X = dims[ax]
    post = int(np.prod(dims[ax + 1:G - 2], dtype=np.int64)) if ax + 1 <= G - 3 else 1
    return pre, X, post * 128


def merged_top_tiny(n: int) -> bool:
    """True when the top group is tiny enough that (top, top-1) ops merge
    onto one kernel axis (the hpair / merged-Gram criterion)."""
    dims = gr.group_dims(n)
    return len(dims) >= 4 and dims[0] < MIN_KERNEL_X


# ---------------------------------------------------------------------------
# Dense applies
# ---------------------------------------------------------------------------

def apply_dual(xr, xi, E0, E1, *, diag=None, diag_first: bool = True,
               kernels: KernelSet = KERNELS) -> Planes:
    """One pass applying lane-group operator ``E0`` and sublane-group
    operator ``E1`` (either may be None = identity; both 128x128 complex).
    ``diag``: complex (tsl, tas, tal) tables of a fused diagonal run
    multiplied in the same pass — BEFORE the dual gates when ``diag_first``
    (tape order [run, dense]), AFTER them otherwise ([dense, run])."""
    dev = xr.device
    eye = torch.eye(128, dtype=torch.float32, device=dev)
    zr = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    e0r, e0i = op_planes(E0, dev) if E0 is not None else (eye, zr)
    e1r, e1i = op_planes(E1, dev) if E1 is not None else (eye, zr)
    return kernels.dual_apply(xr, xi, e0r, e0i, e1r, e1i,
                              _table_planes(diag, dev), diag_first)


def dhigh_eligible(j: int, n: int) -> bool:
    """True when a diagonal run folds into the dense sweep on high group
    ``j`` as ONE fused kernel pass (plain high view, kernel-sized X)."""
    if j < 2:
        return False
    _, X, M = _high_view(n, j)
    return MIN_KERNEL_X <= X <= 128 and M % 128 == 0


def dhigh_view_tables(tables, j: int, n: int, device):
    """Diag-run tables (tsl (128,128), tas (A,128), tal (A,128)) complex ->
    the six f32 planes of the fused dhigh sweep on high group ``j``, with
    tas/tal viewed as (pre, X, post, 128): a = (i*X + x)*post + p. Views
    of the canonical tables — the kernel indexes them in place (the TPU
    kernel's further re-layout, common.dh_table_views, was a Mosaic tiling
    need)."""
    pre, X, M = _high_view(n, j)
    v = (pre, X, M // 128, 128)
    tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i = _table_planes(tables, device)
    return (tsl_r, tsl_i, tas_r.view(v), tas_i.view(v), tal_r.view(v),
            tal_i.view(v))


def apply_dhigh(xr, xi, E, tables, j: int, n: int, *, diag_first: bool = True,
                kernels: KernelSet = KERNELS) -> Planes:
    """Fused [diagonal run + dense sweep on high group ``j``] in ONE pass
    (``diag_first``: the run precedes the dense in tape order). Caller
    checks dhigh_eligible."""
    pre, X, M = _high_view(n, j)
    er, ei = op_planes(E, xr.device)
    yr, yi = kernels.high_apply(xr.view(pre, X, M, 128), xi.view(pre, X, M, 128),
                                er, ei, dhigh_view_tables(tables, j, n, xr.device),
                                diag_first)
    return yr.view(xr.shape), yi.view(xi.shape)


def apply_high(xr, xi, E, j: int, n: int, *,
               kernels: KernelSet = KERNELS) -> Planes:
    """Dense full-group operator on high group ``j >= 2`` (one pass)."""
    pre, X, M = _high_view(n, j)
    if X < MIN_KERNEL_X:
        raise NotImplementedError(
            f"dense block on a {X}-wide high group (n={n}, group {j}): the "
            "small-X high apply (planes._apply_high_smallx) and the merged "
            "top axis (merged_fact_apply_planes) are not ported yet; see "
            "ROADMAP.md")
    er, ei = op_planes(E, xr.device)
    yr, yi = kernels.high_apply(xr.view(pre, X, M, 128), xi.view(pre, X, M, 128),
                                er, ei)
    return yr.view(xr.shape), yi.view(xi.shape)


def apply_block(xr, xi, E, j: int, n: int, *,
                kernels: KernelSet = KERNELS) -> Planes:
    """Dense full-group operator on any group axis."""
    if j == 0:
        return apply_dual(xr, xi, E, None, kernels=kernels)
    if j == 1:
        return apply_dual(xr, xi, None, E, kernels=kernels)
    return apply_high(xr, xi, E, j, n, kernels=kernels)


# ---------------------------------------------------------------------------
# Group Grams (density epilogue)
# ---------------------------------------------------------------------------

def gram_axis(xr, xi, j: int, n: int, *,
              kernels: KernelSet = KERNELS) -> torch.Tensor:
    """Complex group Gram ``G[x, y] = sum_b t[x, b] conj(t[y, b])`` (conj on
    the second factor) over group axis ``j`` in ONE read of the planes:
    ``G = S + i (C^T - C)`` from the Gram kernel's (S, C)."""
    A = xr.shape[0]
    if j == 0:
        shape = (A * 128, 128, 1)
    elif j == 1:
        shape = (A, 128, 128)
    else:
        pre, X, M = _high_view(n, j)
        if X < MIN_KERNEL_X and j >= 3:
            raise NotImplementedError(
                f"Gram of the {X}-wide top group (n={n}): the merged-top-axis "
                "Gram (planes.gram_merged_top) is not ported yet; see ROADMAP.md")
        shape = (pre, X, M * 128)
    S, C = kernels.gram(xr.view(shape), xi.view(shape))
    return torch.complex(S, C.T - C)
