"""Plane-layout statevector ops: a complex64 state as two f32 planes.

Counterpart of the main-path subset of ``dqc_tpu/ops/planes.py``. Inside
the layer loop (circuit/plane_scan.py) the state lives as a pair of float32
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
* the adjoint of a dense block on group j >= 2, with or without a folded
  run -> the high backward kernel (ops/kernels/block_backward_high); the
  adjoint of a lane + sublane pair is called from circuit/plane_scan.py
  (ops/kernels/block_backward_dual), as in the JAX package

Every apply consumes its input planes and returns the result (in place on
the card), unless ``alias=False`` (fresh output planes) or ``acc`` (added
into the accumulator planes) is given: the density seed reads the forward
planes and leaves them intact. ``kernels`` selects the wrappers (default)
or the plain versions (``ops.kernels.PLAIN``), the yardstick for the
kernels on the card.
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


def _diag_table_planes(tables, device):
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

def _check_out_dtype(out_dtype) -> None:
    if out_dtype is not None and out_dtype != torch.float32:
        raise NotImplementedError(
            f"plane storage {out_dtype} is not ported to dqc_tpu_torch yet "
            "(only float32); see ROADMAP.md")


def apply_dual(xr, xi, E0, E1, *, alias: bool = True, conj: bool = False,
               acc=None, diag=None, diag_first: bool = True, out_dtype=None,
               kernels: KernelSet = KERNELS) -> Planes:
    """One pass applying lane-group operator ``E0`` and sublane-group
    operator ``E1`` (either may be None = identity; both 128x128 complex).
    ``diag``: complex (tsl, tas, tal) tables of a fused diagonal run
    multiplied in the same pass — BEFORE the dual gates when ``diag_first``
    (tape order [run, dense]), AFTER them otherwise ([dense, run]).
    ``conj``/``acc``/``alias``: the seed modes (module docstring)."""
    _check_out_dtype(out_dtype)
    dev = xr.device
    eye = torch.eye(128, dtype=torch.float32, device=dev)
    zr = torch.zeros((128, 128), dtype=torch.float32, device=dev)
    e0r, e0i = op_planes(E0, dev) if E0 is not None else (eye, zr)
    e1r, e1i = op_planes(E1, dev) if E1 is not None else (eye, zr)
    return kernels.dual_apply(xr, xi, e0r, e0i, e1r, e1i,
                              _diag_table_planes(diag, dev), diag_first,
                              conj=conj, acc=acc, alias=alias)


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
    tsl_r, tsl_i, tas_r, tas_i, tal_r, tal_i = _diag_table_planes(tables, device)
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


def apply_high(xr, xi, E, j: int, n: int, *, alias: bool = True,
               conj: bool = False, acc=None, out_dtype=None,
               kernels: KernelSet = KERNELS) -> Planes:
    """Dense full-group operator on high group ``j >= 2`` (one pass)."""
    _check_out_dtype(out_dtype)
    pre, X, M = _high_view(n, j)
    if X < MIN_KERNEL_X:
        raise NotImplementedError(
            f"dense block on a {X}-wide high group (n={n}, group {j}): the "
            "small-X high apply (planes._apply_high_smallx) and the merged "
            "top axis (merged_fact_apply_planes) are not ported yet; see "
            "ROADMAP.md")
    v = (pre, X, M, 128)
    er, ei = op_planes(E, xr.device)
    if acc is not None:
        acc = (acc[0].view(v), acc[1].view(v))
    yr, yi = kernels.high_apply(xr.view(v), xi.view(v), er, ei, conj=conj,
                                acc=acc, alias=alias)
    return yr.view(xr.shape), yi.view(xi.shape)


def apply_block(xr, xi, E, j: int, n: int, *, alias: bool = True,
                conj: bool = False, acc=None, out_dtype=None,
                kernels: KernelSet = KERNELS) -> Planes:
    """Dense full-group operator on any group axis. ``conj``/``acc``: emit
    ``acc + conj(E x)`` with the accumulator updated in place (density
    seeds)."""
    kw = dict(alias=alias, conj=conj, acc=acc, out_dtype=out_dtype,
              kernels=kernels)
    if j == 0:
        return apply_dual(xr, xi, E, None, **kw)
    if j == 1:
        return apply_dual(xr, xi, None, E, **kw)
    return apply_high(xr, xi, E, j, n, **kw)


# ---------------------------------------------------------------------------
# One-pass blockwise adjoint steps
# ---------------------------------------------------------------------------

def backward_dhigh(fxr, fxi, bxr, bxi, Einv, E, tables_inv, tables, j: int,
                   n: int, *, diag_first: bool = True, with_q: bool = False,
                   kernels: KernelSet = KERNELS):
    """One-pass adjoint of a fused [diag run + dense high sweep]: uncompute,
    cotangent transport and the dense block's T0 pair gram in a single read
    of the (fwd, bwd) planes. Returns ``(fxr, fxi, bxr, bxi, T0, None)``
    with T0 complex (X, X). The run's Q reductions (``with_q``, for a run
    with variable gates) are not ported: the kernel's ``diag_q`` outputs
    come with the diag backward kernels (ROADMAP.md)."""
    if with_q:
        raise NotImplementedError(
            "the Q reductions of a variable diagonal run (block_backward_high "
            "diag_q, diag_backward_planes) are not ported to dqc_tpu_torch "
            "yet; see ROADMAP.md")
    pre, X, M = _high_view(n, j)
    v = (pre, X, M, 128)
    dev = fxr.device
    out = kernels.block_backward_high(
        fxr.view(v), fxi.view(v), bxr.view(v), bxi.view(v),
        *op_planes(Einv, dev), *op_planes(E, dev),
        diag_inv_tables=dhigh_view_tables(tables_inv, j, n, dev),
        diag_tables=dhigh_view_tables(tables, j, n, dev),
        diag_first_fwd=diag_first)
    fr, fi, br, bi, t0r, t0i = out
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(t0r, t0i), None)


def backward_block(fxr, fxi, bxr, bxi, Einv, E, j: int, n: int, *,
                   kernels: KernelSet = KERNELS):
    """Uncompute + pair gram + cotangent transport for one dense block on a
    high group, in a single read of the (fwd, bwd) planes:

    ``fwd_in = Einv fwd_out``, ``bwd' = E^T bwd``,
    ``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]`` (complex, returned dense).

    Returns ``(fxr', fxi', bxr', bxi', T0)``. An unpaired lane or sublane
    block and a high group narrower than 8 need kernels not ported yet and
    raise ``NotImplementedError``."""
    if j in (0, 1):
        raise NotImplementedError(
            f"the adjoint of an unpaired {('lane', 'sublane')[j]} block needs "
            f"block_backward_{('lane', 'sublane')[j]} "
            f"(dqc_tpu/ops/pallas/block_backward.py:{(88, 184)[j]}), not "
            "ported to dqc_tpu_torch yet; see ROADMAP.md")
    pre, X, M = _high_view(n, j)
    if X < MIN_KERNEL_X:
        raise NotImplementedError(
            f"the adjoint of a dense block on a {X}-wide high group (n={n}, "
            f"group {j}) needs the merged top axis or the small-X path, not "
            "ported to dqc_tpu_torch yet; see ROADMAP.md")
    v = (pre, X, M, 128)
    dev = fxr.device
    fr, fi, br, bi, t0r, t0i = kernels.block_backward_high(
        fxr.view(v), fxi.view(v), bxr.view(v), bxi.view(v),
        *op_planes(Einv, dev), *op_planes(E, dev))
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(t0r, t0i))


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
