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
* a diagonal run on its own    -> the diag sweep kernel (ops/kernels/diag)
* dense blocks on a tiny top group and the group below it -> one merged-axis
  sweep, Kronecker-factorized (ops/kernels/merged_fact_apply), or expanded
  to the X = 256 / 512 merged axis (config.set_hpair_factorized(False)) on
  the high kernels, as a lone block on a tiny top group always is
* group Grams (densities)      -> the Gram kernel (ops/kernels/gram); both
  top groups' from one merged-axis read when the top group is tiny
* a 2- or 4-wide group 2 (n = 15, 16): elementwise combinations of its
  slices, which the JAX package leaves to XLA outside any kernel
* a dense gate across two groups (the CNOT ring) -> one pass: the
  multi-term dual kernel (ops/kernels/dual_multi_apply) for (lane, sublane),
  the high kernel on a span view of its high bits, or the multi-term high +
  lane kernel (ops/kernels/high_multi_apply) with a lane bit; its adjoint on
  a span view is one high backward kernel pass
* the adjoint of an unpaired lane or sublane block -> ops/kernels/
  block_backward_lane, block_backward_sublane
* a variable diagonal run's Q reductions -> the adjoint that rolls the run
  back (block_backward_dual / block_backward_high ``diag_q``, diag_backward
  ``with_q``)
* diagonals over more than two groups, and the gradient sources of the
  plane tape's unfused diagonal branches -> plain torch broadcast multiplies
  and sums, as the JAX package leaves them to XLA
* the adjoint of a dense block on group j >= 2, with or without a folded
  run -> the high backward kernel (ops/kernels/block_backward_high); the
  adjoint of a lane + sublane pair is called from circuit/plane_scan.py
  (ops/kernels/block_backward_dual), as in the JAX package; the adjoints of
  the merged sweep and of a lone diagonal run have kernels of their own
  (ops/kernels/block_backward_merged_fact, ops/kernels/diag); the expanded
  merged sweep's adjoint is the high backward kernel at X = 256 / 512

Every apply consumes its input planes and returns the result (in place on
the card), unless ``alias=False`` (fresh output planes) or ``acc`` (added
into the accumulator planes) is given: the density seed reads the forward
planes and leaves them intact. ``kernels`` selects the wrappers (default)
or the plain versions (``ops.kernels.PLAIN``), the yardstick for the
kernels on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def _merged_view(n: int, j: int) -> Tuple[int, int, int, int]:
    """(pre, X, Xl, M) merging tiny group ``j`` (j >= 3) with its lower
    neighbour ``j - 1``: planes.reshape(pre, X * Xl, M, 128) puts both
    groups' bits on one contracted axis (merged row ``x Xl + d``) of dim
    >= 256, where the top group's ops run as kernels."""
    if j < 3:
        raise ValueError(f"_merged_view: group {j} has no high group below it")
    dims = gr.group_dims(n)
    G = len(dims)
    ax = G - 1 - j
    pre = int(np.prod(dims[:ax], dtype=np.int64)) if ax > 0 else 1
    X = dims[ax]
    Xl = dims[ax + 1]
    post = int(np.prod(dims[ax + 2:G - 2], dtype=np.int64)) if ax + 2 <= G - 3 else 1
    return pre, X, Xl, post * 128


def kron_ops(Ea, Eb):
    """``Ea (x) Eb`` (Ea on the higher, major axis): host numpy when both
    operators are numpy, a complex64 tensor on the tensor's device
    otherwise."""
    if isinstance(Ea, np.ndarray) and isinstance(Eb, np.ndarray):
        return np.kron(Ea, Eb)
    dev = Ea.device if isinstance(Ea, torch.Tensor) else Eb.device
    return torch.kron(torch.as_tensor(Ea, device=dev).to(torch.complex64).contiguous(),
                      torch.as_tensor(Eb, device=dev).to(torch.complex64).contiguous())


def _kron_id(E, Xl: int):
    """``E (x) I_Xl`` (the identity made on a tensor's own device, so that a
    constant cached on the card needs no host-to-device copy)."""
    if isinstance(E, torch.Tensor):
        return kron_ops(E, torch.eye(Xl, dtype=torch.complex64, device=E.device))
    return kron_ops(E, np.eye(Xl, dtype=np.complex64))


def _trace_id(Gm: torch.Tensor, X: int, Xl: int) -> torch.Tensor:
    """Partial trace over the identity factor of a merged-axis (X Xl, X Xl)
    Gram: ``G[x, y] = sum_d Gm[(x, d), (y, d)]``."""
    return torch.einsum("xdyd->xy", Gm.reshape(X, Xl, X, Xl))


def merged_top_tiny(n: int) -> bool:
    """True when the top group is tiny enough that (top, top-1) ops merge
    onto one kernel axis (the hpair / merged-seed / merged-Gram criterion)."""
    dims = gr.group_dims(n)
    return len(dims) >= 4 and dims[0] < MIN_KERNEL_X


def _merged_planes(xr, xi, n: int):
    """The planes on the merged (top, top-1) view, and the top group's X."""
    pre, X, Xl, M = _merged_view(n, len(gr.group_dims(n)) - 1)
    v = (pre, X * Xl, M, 128)
    return xr.view(v), xi.view(v), X


def apply_merged_top(xr, xi, E_m, n: int, *, alias: bool = True,
                     conj: bool = False, acc=None,
                     kernels: KernelSet = KERNELS) -> Planes:
    """A dense operator ``E_m`` (X Xl, X Xl) on the merged (top, top-1) axis
    in one pass of the high apply at X = 256 / 512: in place (a lone
    top-group block, the unfactorized hpair) or the merged-top density seed
    (``alias=False``, ``conj``, ``acc``)."""
    vr, vi, _ = _merged_planes(xr, xi, n)
    er, ei = op_planes(E_m, xr.device)
    if acc is not None:
        acc = (acc[0].view(vr.shape), acc[1].view(vr.shape))
    yr, yi = kernels.high_apply(vr, vi, er, ei, conj=conj, acc=acc, alias=alias)
    return yr.view(xr.shape), yi.view(xi.shape)


def apply_merged_top_fact(xr, xi, Et, El, n: int, *,
                          kernels: KernelSet = KERNELS) -> Planes:
    """``Et (x) El`` on the merged (top, top-1) axis in one pass without
    expanding the Kronecker product (merged_fact_apply)."""
    vr, vi, X = _merged_planes(xr, xi, n)
    dev = xr.device
    yr, yi = kernels.merged_fact_apply(vr, vi, *op_planes(El, dev),
                                       *op_planes(Et, dev), x_top=X)
    return yr.view(xr.shape), yi.view(xi.shape)


def backward_merged_top_fact(fxr, fxi, bxr, bxi, Et, El, Eti, Eli, n: int, *,
                             kernels: KernelSet = KERNELS):
    """Factorized one-pass adjoint on the merged (top, top-1) axis: returns
    the planes and the complex ``(T0_top, T0_low)`` pair-gram restrictions
    (block_backward_merged_fact) instead of the (X Xl)^2 merged gram."""
    fr, fi, X = _merged_planes(fxr, fxi, n)
    br, bi, _ = _merged_planes(bxr, bxi, n)
    dev = fxr.device
    fr, fi, br, bi, ttr, tti, tlr, tli = kernels.block_backward_merged_fact(
        fr, fi, br, bi, *op_planes(Eli, dev), *op_planes(El, dev),
        *op_planes(Eti, dev), *op_planes(Et, dev), x_top=X)
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(ttr, tti), torch.complex(tlr, tli))


def backward_merged_top(fxr, fxi, bxr, bxi, Einv_m, E_m, n: int, *,
                        kernels: KernelSet = KERNELS):
    """The high backward kernel on the merged (top, top-1) axis at X = 256 /
    512: returns the planes and the complex merged (X Xl)^2 pair gram, from
    which the caller extracts the per-block ones."""
    fr, fi, _ = _merged_planes(fxr, fxi, n)
    br, bi, _ = _merged_planes(bxr, bxi, n)
    dev = fxr.device
    fr, fi, br, bi, t0r, t0i = kernels.block_backward_high(
        fr, fi, br, bi, *op_planes(Einv_m, dev), *op_planes(E_m, dev))
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(t0r, t0i))


def gram_merged_top(xr, xi, n: int, *, kernels: KernelSet = KERNELS):
    """(G_low, G_top): both top groups' Grams from ONE merged-axis kernel
    read, the partial traces of the (X Xl)^2 merged Gram over the other
    factor."""
    pre, X, Xl, M = _merged_view(n, len(gr.group_dims(n)) - 1)
    v = (pre, X * Xl, M * 128)
    S, C = kernels.gram(xr.view(v), xi.view(v))
    Gm = torch.complex(S, C.T - C).reshape(X, Xl, X, Xl)
    return torch.einsum("dxdy->xy", Gm), _trace_id(Gm, X, Xl)


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


def _apply_high_smallx(vxr, vxi, er, ei, X: int) -> Planes:
    """Tiny contracted axis (X < 8, a 1- or 2-bit group 2): the operator
    entries are scalars, so the apply is a linear combination of the axis
    slices, elementwise (the JAX package's XLA form of it)."""
    outr, outi = [], []
    for x in range(X):
        accr = acci = None
        for y in range(X):
            tr = er[x, y] * vxr[:, y] - ei[x, y] * vxi[:, y]
            ti = er[x, y] * vxi[:, y] + ei[x, y] * vxr[:, y]
            accr = tr if accr is None else accr + tr
            acci = ti if acci is None else acci + ti
        outr.append(accr)
        outi.append(acci)
    return torch.stack(outr, dim=1), torch.stack(outi, dim=1)


def apply_high(xr, xi, E, j: int, n: int, *, alias: bool = True,
               conj: bool = False, acc=None, out_dtype=None,
               kernels: KernelSet = KERNELS) -> Planes:
    """Dense full-group operator on high group ``j >= 2`` (one pass): the
    high kernel on the group's axis, or on the X = 256 / 512 merged axis of
    a tiny top group (``E (x) I``), or the elementwise small-X form on a
    tiny group 2 (fresh planes)."""
    _check_out_dtype(out_dtype)
    pre, X, M = _high_view(n, j)
    v = (pre, X, M, 128)
    if X < MIN_KERNEL_X and j < 3:
        er, ei = op_planes(E, xr.device)
        yr, yi = _apply_high_smallx(xr.view(v), xi.view(v), er, ei, X)
        if conj:
            yi = -yi
        if acc is not None:
            yr, yi = acc[0].view(v) + yr, acc[1].view(v) + yi
        return yr.reshape(xr.shape), yi.reshape(xi.shape)
    if X < MIN_KERNEL_X:
        return apply_merged_top(xr, xi, _kron_id(E, _merged_view(n, j)[2]), n,
                                alias=alias, conj=conj, acc=acc,
                                kernels=kernels)
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


def _stacked_planes(ops, device) -> Planes:
    rs, is_ = zip(*(op_planes(E, device) for E in ops))
    return torch.stack(rs), torch.stack(is_)


def cross_terms_operands(terms, n: int, device):
    """The stacked f32 factor planes of :func:`apply_cross_terms` on
    ``device``: ``("dual", el_r, el_i, em_r, em_i)`` for a (lane, sublane)
    pair, ``("high", j, eh_r, eh_i, el_r, el_i)`` for (lane, high group j)
    with a kernel-sized X, or None when the pair has no fused kernel."""
    groups = {t[1] for t in terms} | {t[3] for t in terms}
    if len(groups) != 2:
        return None
    if groups == {0, 1}:
        el = [EA if ja == 0 else EB for EA, ja, EB, jb in terms]
        em = [EB if ja == 0 else EA for EA, ja, EB, jb in terms]
        return ("dual", *_stacked_planes(el, device), *_stacked_planes(em, device))
    if 0 in groups:
        j = max(groups)
        if _high_view(n, j)[1] < MIN_KERNEL_X:
            return None
        eh = [EA if ja == j else EB for EA, ja, EB, jb in terms]
        el = [EB if ja == j else EA for EA, ja, EB, jb in terms]
        return ("high", j, *_stacked_planes(eh, device),
                *_stacked_planes(el, device))
    return None


def apply_cross_terms(xr, xi, terms, n: int, *, alias: bool = True,
                      conj: bool = False, acc=None, out_dtype=None,
                      kernels: KernelSet = KERNELS, operands=None):
    """ONE-pass execution of a dense cross-group gate's full per-group term
    decomposition (plane_scan._dense_cross_expanded_terms): ``y = sum_t
    (EA_t on ja)(EB_t on jb) x`` — the multi-term dual kernel for (lane,
    sublane), the multi-term high + lane kernel for (lane, high group).
    Returns None when the pair shape has no fused kernel (the caller falls
    back to the per-term sweeps). ``operands``: the result of
    :func:`cross_terms_operands`, staged on the device once per call for a
    constant gate (``terms`` is then not read). ``conj``/``acc``/``alias``:
    the seed modes of apply_block (the seed of a cross-group density)."""
    _check_out_dtype(out_dtype)
    if operands is None:
        operands = cross_terms_operands(terms, n, xr.device)
    if operands is None:
        return None
    kw = dict(conj=conj, acc=acc, alias=alias)
    if operands[0] == "dual":
        return kernels.dual_multi_apply(xr, xi, *operands[1:], **kw)
    pre, X, M = _high_view(n, operands[1])
    v = (pre, X, M, 128)
    yr, yi = kernels.high_multi_apply(xr.view(v), xi.view(v), *operands[2:], **kw)
    return yr.view(xr.shape), yi.view(xi.shape)


# ---------------------------------------------------------------------------
# One-pass dense cross-group gates on a SPAN view
#
# The plane layout's flat ravel orders qubits (n-1 .. 14 | 13 .. 7 | 6 .. 0):
# any contiguous bit range [b0, b_max] with b0 >= 7 is one contiguous axis of
# the view ``(2^(n-1-b_max), 2^span, 2^(b0-7), 128)`` — the high kernels'
# (A1, X, M, 128) contract. A dense gate whose non-lane bits fit a <= 8-bit
# span runs as ONE in-place high-kernel pass with the gate expanded over the
# span axis; lane bits ride along as per-term 128 x 128 lane factors in the
# multi-term high + lane kernel.
# ---------------------------------------------------------------------------

MAX_SPAN_BITS = 8


def _span_geom(positions, n: int):
    """(b0, span_bits, lane_bits) of the span view for a dense gate, or
    None when ineligible. The span covers every bit >= 7, padded down to at
    least 3 bits (X = 8, the smallest kernel axis)."""
    if n < 15:
        return None
    hi = [p for p in positions if p >= 7]
    lanes = tuple(p for p in positions if p < 7)
    # pure-minor pairs belong to the dual kernel; and without an A bit the
    # span view cannot beat the existing paths
    if not hi or max(hi) < 14:
        return None
    b_max, b_min = max(hi), min(hi)
    span = max(3, b_max - b_min + 1)
    if span > MAX_SPAN_BITS:
        return None
    b0 = b_max - span + 1
    if b0 < 7:
        return None
    if lanes and len(lanes) > 2:
        return None
    return b0, span, lanes


def cross_span_eligible(positions, n: int) -> bool:
    """True when a dense gate on ``positions`` runs as ONE span-view kernel
    pass (see _span_geom)."""
    return _span_geom(positions, n) is not None


def _permuted_gate(gate_m, positions):
    """(positions sorted descending, gate reindexed to that order) — the
    gate's index convention ties bit significance to the positions tuple
    order."""
    k = len(positions)
    order = sorted(range(k), key=lambda i: -positions[i])
    spos = tuple(positions[i] for i in order)
    if list(order) == list(range(k)):
        return spos, gate_m
    perm = list(order) + [k + i for i in order]
    c = gr.concrete_or_none(gate_m)
    if c is not None:
        key = ("PG", c.tobytes(), c.dtype.str, tuple(order))
        return spos, gr._cached(key, lambda: np.ascontiguousarray(
            c.reshape((2,) * (2 * k)).transpose(perm).reshape(1 << k, 1 << k)))
    G = gate_m.reshape((2,) * (2 * k))
    return spos, G.permute(perm).reshape(1 << k, 1 << k)


def _span_operator(G, rels, span: int):
    """Gate (descending-position index order) expanded over the span axis:
    complex ``(2^span, 2^span)`` (host-cached for constants)."""
    return gr.expand_in_group(G, rels, span)


def _lane_span_terms(G, kh: int, rels, span: int, lane_rels):
    """Two-side decomposition of a gate with lane bits: elementary
    ``|ql><pl|`` on the lane group x the corresponding gate slice expanded
    over the span axis. Returns stacked complex ``(T, R, R)`` span parts and
    ``(T, 128, 128)`` lane parts (zero slices pruned for constants)."""
    kl = len(lane_rels)
    c = gr.concrete_or_none(G)
    G4 = (c if c is not None else G).reshape(1 << kh, 1 << kl, 1 << kh, 1 << kl)
    eh, el = [], []
    for ql in range(1 << kl):
        for pl_ in range(1 << kl):
            sub = G4[:, ql, :, pl_]
            if c is not None and np.abs(sub).max() < 1e-12:
                continue
            B = np.zeros((1 << kl, 1 << kl), np.complex64)
            B[ql, pl_] = 1.0
            eh.append(gr.expand_in_group(sub, rels, span))
            el.append(gr.expand_in_group(B, lane_rels, gr.GROUP_BITS))
    return eh, el


def cross_span_operands(gate_m, positions, n: int, device):
    """The span view's shape and its f32 operand planes on ``device``:
    ``("high", vshape, er, ei)``, or ``("multi", vshape, eh_r, eh_i, el_r,
    el_i)`` with lane bits; None without a span view."""
    geom = _span_geom(positions, n)
    if geom is None:
        return None
    b0, span, _ = geom
    spos, G = _permuted_gate(gate_m, tuple(int(p) for p in positions))
    hi = [p for p in spos if p >= 7]
    lanes = [p for p in spos if p < 7]
    rels = tuple(p - b0 for p in hi)
    vshape = (1 << (n - 1 - hi[0]), 1 << span, 1 << (b0 - 7), 128)
    if not lanes:
        return ("high", vshape, *op_planes(_span_operator(G, rels, span), device))
    eh, el = _lane_span_terms(G, len(hi), rels, span, tuple(lanes))
    return ("multi", vshape, *_stacked_planes(eh, device),
            *_stacked_planes(el, device))


def apply_cross_span(xr, xi, gate_m, positions, n: int, *, alias: bool = True,
                     conj: bool = False, acc=None, out_dtype=None,
                     kernels: KernelSet = KERNELS, operands=None):
    """ONE-pass dense cross-group gate on the span view — the (sublane,
    high), (high, high) and (lane, high-span) shapes: the high apply kernel
    with the gate expanded over the span axis, or the multi-term high +
    lane kernel with lane bits. Semantics of apply_block
    (conj/acc/alias). Returns None when the bit pattern has no span view.
    ``operands``: the result of :func:`cross_span_operands`, staged once per
    call for a constant gate."""
    _check_out_dtype(out_dtype)
    if operands is None:
        operands = cross_span_operands(gate_m, positions, n, xr.device)
    if operands is None:
        return None
    vshape = operands[1]
    a2 = None if acc is None else (acc[0].view(vshape), acc[1].view(vshape))
    kw = dict(conj=conj, acc=a2, alias=alias)
    if operands[0] == "high":
        yr, yi = kernels.high_apply(xr.view(vshape), xi.view(vshape),
                                    *operands[2:], **kw)
    else:
        yr, yi = kernels.high_multi_apply(xr.view(vshape), xi.view(vshape),
                                          *operands[2:], **kw)
    return yr.view(xr.shape), yi.view(xi.shape)


def cross_pair_one_pass(positions, n: int) -> bool:
    """True when a dense cross-group gate over TWO groups executes its whole
    term decomposition as ONE fused pass: the multi-term dual kernel
    (minor-minor), the multi-term high + lane kernel (lane x kernel-sized
    high group), or a span view."""
    if cross_span_eligible(positions, n):
        return True
    groups = {gr.group_of_bit(n, p)[0] for p in positions}
    if groups == {0, 1}:
        return True
    sizes = gr.group_sizes_low_first(n)
    return 0 in groups and (1 << sizes[max(groups)]) >= MIN_KERNEL_X


def backward_span_eligible(positions, n: int) -> bool:
    """True when a dense gate on ``positions`` has a ONE-pass fused adjoint
    (backward_cross_span): a span view without lane bits (lane shapes keep
    the 3-pass path)."""
    geom = _span_geom(positions, n)
    return geom is not None and not geom[2]


def _span_cotangent(t0r, t0i, rels, span: int) -> torch.Tensor:
    """Adjoint of expand_in_group: partial trace of the span-block pair gram
    over the identity-factor bits. ``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]``
    with ``E = expand(G)`` gives ``dL/dG[p, q] = sum_r T0[x(p, r), y(q, r)]``
    (r = the non-gate span bits, equal on both sides). Complex out."""
    k = len(rels)
    row_axes = [span - 1 - r for r in rels]
    perm = row_axes + [a for a in range(span) if a not in row_axes]

    def red(T0):
        T4 = T0.reshape((2,) * (2 * span)).permute(perm + [span + a for a in perm])
        T4 = T4.reshape(1 << k, 1 << (span - k), 1 << k, 1 << (span - k))
        return torch.einsum("arbr->ab", T4)

    return torch.complex(red(t0r.float()), red(t0i.float()))


def backward_span_operands(gate_m, gate_inv, positions, n: int, device):
    """``(vshape, rels, span, einv_r, einv_i, e_r, e_i)`` of
    :func:`backward_cross_span` on ``device``, or None when the shape is not
    backward_span_eligible."""
    if not backward_span_eligible(positions, n):
        return None
    pos = tuple(int(p) for p in positions)
    b0, span, _ = _span_geom(pos, n)
    spos, G = _permuted_gate(gate_m, pos)
    _, Ginv = _permuted_gate(gate_inv, pos)
    rels = tuple(p - b0 for p in spos)
    vshape = (1 << (n - 1 - spos[0]), 1 << span, 1 << (b0 - 7), 128)
    return (vshape, rels, span,
            *op_planes(_span_operator(Ginv, rels, span), device),
            *op_planes(_span_operator(G, rels, span), device))


def backward_cross_span(fxr, fxi, bxr, bxi, gate_m, gate_inv, positions,
                        n: int, *, kernels: KernelSet = KERNELS, operands=None,
                        with_cotangent: bool = True):
    """ONE-pass adjoint for a span-eligible dense cross-group gate: uncompute
    (``fwd_in = expand(G^-1) fwd``), cotangent transport (``bwd' =
    expand(G)^T bwd``) and the gate cotangent, in a single read of the
    (fwd, bwd) planes via block_backward_high on the span view.

    Returns ``(fxr', fxi', bxr', bxi', W)`` with ``W`` the ``(2^k, 2^k)``
    complex cotangent in the ORIGINAL positions index order (None when
    ``with_cotangent`` is False: a constant gate), or None when the shape is
    not backward_span_eligible. ``operands``: the result of
    :func:`backward_span_operands`, staged once per call for a constant
    gate."""
    if operands is None:
        operands = backward_span_operands(gate_m, gate_inv, positions, n,
                                          fxr.device)
    if operands is None:
        return None
    vshape, rels, span = operands[:3]
    fr, fi, br, bi, t0r, t0i = kernels.block_backward_high(
        fxr.view(vshape), fxi.view(vshape), bxr.view(vshape), bxi.view(vshape),
        *operands[3:])
    W = None
    if with_cotangent:
        W = _span_cotangent(t0r, t0i, rels, span)
        pos = tuple(int(p) for p in positions)
        k = len(pos)
        order = sorted(range(k), key=lambda i: -pos[i])
        if list(order) != list(range(k)):
            inv = [order.index(i) for i in range(k)]
            W = W.reshape((2,) * (2 * k)).permute(
                inv + [k + i for i in inv]).reshape(1 << k, 1 << k)
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), W)


# ---------------------------------------------------------------------------
# One-pass blockwise adjoint steps
# ---------------------------------------------------------------------------

def backward_dhigh(fxr, fxi, bxr, bxi, Einv, E, tables_inv, tables, j: int,
                   n: int, *, diag_first: bool = True, with_q: bool = False,
                   kernels: KernelSet = KERNELS):
    """One-pass adjoint of a fused [diag run + dense high sweep]: uncompute,
    cotangent transport, the dense block's T0 pair gram and (``with_q``, a
    run with variable gates) the run's Q reductions, in a single read of
    the (fwd, bwd) planes. Returns ``(fxr, fxi, bxr, bxi, T0, Q)`` with T0
    complex (X, X) and Q None or the complex ``(Qsl (128, 128), Qas (A,
    128), Qal (A, 128))`` of ``Q = bwd fwd`` where the planes meet the run
    (the diag kernels' reductions)."""
    pre, X, M = _high_view(n, j)
    v = (pre, X, M, 128)
    dev = fxr.device
    out = kernels.block_backward_high(
        fxr.view(v), fxi.view(v), bxr.view(v), bxi.view(v),
        *op_planes(Einv, dev), *op_planes(E, dev),
        diag_inv_tables=dhigh_view_tables(tables_inv, j, n, dev),
        diag_tables=dhigh_view_tables(tables, j, n, dev),
        diag_first_fwd=diag_first, diag_q=with_q)
    fr, fi, br, bi, t0r, t0i = out[:6]
    Q = None
    if with_q:
        A = pre * X * (M // 128)
        Q = (torch.complex(out[6], out[7]),
             torch.complex(out[8], out[9]).reshape(A, 128),
             torch.complex(out[10], out[11]).reshape(A, 128))
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(t0r, t0i), Q)


def backward_block(fxr, fxi, bxr, bxi, Einv, E, j: int, n: int, *,
                   kernels: KernelSet = KERNELS):
    """Uncompute + pair gram + cotangent transport for one dense block on a
    high group, in a single read of the (fwd, bwd) planes:

    ``fwd_in = Einv fwd_out``, ``bwd' = E^T bwd``,
    ``T0[x, y] = sum_b bwd[x, b] fwd_in[y, b]`` (complex, returned dense).

    Returns ``(fxr', fxi', bxr', bxi', T0)``. An unpaired lane block runs
    block_backward_lane, an unpaired sublane block block_backward_sublane.
    A lone block on a tiny top group runs block_backward_high on the merged
    axis (X = 256 / 512) with ``E (x) I``, its pair gram the partial trace
    of the merged one; a tiny group 2 runs the elementwise small-X form."""
    dev = fxr.device
    if j in (0, 1):
        step = kernels.block_backward_lane if j == 0 else kernels.block_backward_sublane
        fr, fi, br, bi, t0r, t0i = step(fxr, fxi, bxr, bxi, *op_planes(Einv, dev),
                                        *op_planes(E, dev))
        return fr, fi, br, bi, torch.complex(t0r, t0i)
    pre, X, M = _high_view(n, j)
    v = (pre, X, M, 128)
    if X < MIN_KERNEL_X and j >= 3:
        _, X, Xl, _ = _merged_view(n, j)
        fr, fi, br, bi, T0m = backward_merged_top(
            fxr, fxi, bxr, bxi, _kron_id(Einv, Xl), _kron_id(E, Xl), n,
            kernels=kernels)
        return fr, fi, br, bi, _trace_id(T0m, X, Xl)
    if X < MIN_KERNEL_X:
        # tiny group 2: the small-X form; T0[x, y] = sum_b bwd[x] fwd_in[y]
        fr, fi = apply_high(fxr, fxi, Einv, j, n, kernels=kernels)
        vfr, vfi, vbr, vbi = fr.view(v), fi.view(v), bxr.view(v), bxi.view(v)
        T0 = torch.stack([torch.stack([
            torch.complex(torch.sum(vbr[:, x] * vfr[:, y])
                          - torch.sum(vbi[:, x] * vfi[:, y]),
                          torch.sum(vbr[:, x] * vfi[:, y])
                          + torch.sum(vbi[:, x] * vfr[:, y]))
            for y in range(X)]) for x in range(X)])
        br, bi = apply_high(bxr, bxi, torch.complex(*op_planes(E, dev)).T, j,
                            n, kernels=kernels)
        return fr, fi, br, bi, T0
    fr, fi, br, bi, t0r, t0i = kernels.block_backward_high(
        fxr.view(v), fxi.view(v), bxr.view(v), bxi.view(v),
        *op_planes(Einv, dev), *op_planes(E, dev))
    return (fr.view(fxr.shape), fi.view(fxr.shape), br.view(bxr.shape),
            bi.view(bxr.shape), torch.complex(t0r, t0i))


# ---------------------------------------------------------------------------
# Lone diagonal runs (ops/kernels/diag)
# ---------------------------------------------------------------------------

def apply_diag_run(xr, xi, tables, *, kernels: KernelSet = KERNELS) -> Planes:
    """One in-place pass applying a factored total diagonal ``tables =
    (tsl, tas, tal)`` (complex: (128, 128), (A, 128), (A, 128))."""
    return kernels.diag_sweep(xr, xi, *_diag_table_planes(tables, xr.device))


def backward_diag_run(fxr, fxi, bxr, bxi, inv_tables, tables, *, with_q: bool,
                      kernels: KernelSet = KERNELS):
    """One in-place pass rolling (fwd, bwd) back through a diagonal run:
    ``fwd *= D_inv``, ``bwd *= D``. Returns ``(fxr, fxi, bxr, bxi, Q)``, Q
    None or (``with_q``, a run with variable gates) the complex ``(Qsl
    (128, 128), Qas (A, 128), Qal (A, 128))`` reductions of ``Q = bwd fwd``
    taken before the update."""
    dev = fxr.device
    out = kernels.diag_backward(fxr, fxi, bxr, bxi,
                                *_diag_table_planes(inv_tables, dev),
                                *_diag_table_planes(tables, dev), with_q=with_q)
    if not with_q:
        return (*out, None)
    Q = tuple(torch.complex(out[k], out[k + 1]) for k in (4, 6, 8))
    return (*out[:4], Q)


# ---------------------------------------------------------------------------
# Diagonals off the kernels (plain torch on the planes, as the JAX package
# leaves them to XLA): a single-group or two-group diagonal of the plane
# tape's unfused branches, a diagonal over more than two groups, and their
# gradient sources
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(gr.group_dims(n))


def _cmul_planes(xr, xi, dr, di):
    return xr * dr - xi * di, xr * di + xi * dr


def _planes_times(xr, xi, tr, ti, shape, n: int) -> Planes:
    yr, yi = _cmul_planes(_grouped(xr, n), _grouped(xi, n), tr.reshape(shape),
                          ti.reshape(shape))
    return yr.reshape(xr.shape).contiguous(), yi.reshape(xi.shape).contiguous()


def apply_diag_axis(xr, xi, table, j: int, n: int) -> Planes:
    """Full-group diagonal table on group ``j`` (broadcast multiply)."""
    dims = gr.group_dims(n)
    shape = [1] * len(dims)
    shape[len(dims) - 1 - j] = dims[len(dims) - 1 - j]
    return _planes_times(xr, xi, *op_planes(table, xr.device), shape, n)


def _axis_indicators(positions, n: int):
    """For each of the ``2^k`` diagonal entries, the (axis, 0/1 indicator
    vector) factors whose broadcast product selects the amplitudes with
    that bit pattern (positions msb-first)."""
    dims = gr.group_dims(n)
    G = len(dims)
    k = len(positions)
    out = []
    for j in range(1 << k):
        factors: Dict[int, np.ndarray] = {}
        for gate_bit, p in enumerate(positions):
            jg, rel = gr.group_of_bit(n, p)
            ax = G - 1 - jg
            want = (j >> (k - 1 - gate_bit)) & 1
            v = (((np.arange(dims[ax]) >> rel) & 1) == want).astype(np.float32)
            factors[ax] = factors.get(ax, np.ones(dims[ax], np.float32)) * v
        out.append(factors)
    return out


def _multi_diag_table(d, positions, n: int, device) -> torch.Tensor:
    """The joint complex table of a diagonal over any groups, broadcastable
    to the grouped shape: ``sum_j d[j] * (indicator product)``."""
    dims = gr.group_dims(n)
    G = len(dims)
    d = torch.as_tensor(d, device=device).reshape(-1).to(torch.complex64)
    table = None
    for j, factors in enumerate(_axis_indicators(positions, n)):
        m = None
        for ax, v in factors.items():
            sh = [1] * G
            sh[ax] = dims[ax]
            b = torch.as_tensor(v, device=device).reshape(sh)
            m = b if m is None else m * b
        term = d[j] * m
        table = term if table is None else table + term
    return table


def apply_multi_diag(xr, xi, d, positions, n: int) -> Planes:
    """Diagonal k-qubit gate spanning any number of groups: its joint table
    (the indicator sum) applied as one broadcast multiply."""
    t = _multi_diag_table(d, positions, n, xr.device)
    return _planes_times(xr, xi, t.real, t.imag, t.shape, n)


def _sub_planes(xr, xi, positions, n: int):
    return (gr.subblocks(_grouped(xr, n), positions, n),
            gr.subblocks(_grouped(xi, n), positions, n))


def multi_diag_gram(fxr, fxi, bxr, bxi, positions, n: int) -> torch.Tensor:
    """``W[j] = sum_b bwd[j, b] fwd[j, b]`` over the gate-bit sub-blocks
    (the diagonal gate's cotangent, groups.diag_pair_grad on planes)."""
    Fr, Fi = _sub_planes(fxr, fxi, positions, n)
    Br, Bi = _sub_planes(bxr, bxi, positions, n)
    return torch.complex((Br * Fr - Bi * Fi).sum(1), (Br * Fi + Bi * Fr).sum(1))


def apply_cross_diag(xr, xi, table2, j2: int, j1: int, n: int) -> Planes:
    """Joint diagonal over two group axes; ``table2``: (dim_j2, dim_j1)."""
    dims = gr.group_dims(n)
    G = len(dims)
    a2, a1 = G - 1 - j2, G - 1 - j1
    tr, ti = op_planes(table2, xr.device)
    if a2 > a1:
        tr, ti = tr.T, ti.T
        a2, a1 = a1, a2
    shape = [1] * G
    shape[a2] = dims[a2]
    shape[a1] = dims[a1]
    return _planes_times(xr, xi, tr.contiguous(), ti.contiguous(), shape, n)


def _pair_reduce(fxr, fxi, bxr, bxi, keep, n: int) -> torch.Tensor:
    """``sum bwd * fwd`` (complex, no conjugation) over every grouped axis
    but ``keep``."""
    fr, fi = _grouped(fxr, n), _grouped(fxi, n)
    br, bi = _grouped(bxr, n), _grouped(bxi, n)
    axes = tuple(a for a in range(fr.dim()) if a not in keep)
    return torch.complex((br * fr - bi * fi).sum(axes),
                         (br * fi + bi * fr).sum(axes))


def diag_gram_axis(fxr, fxi, bxr, bxi, j: int, n: int) -> torch.Tensor:
    """Complex ``W[x] = sum_b bwd[x, b] fwd[x, b]`` over group axis ``j``
    (the all-diagonal block's gradient source)."""
    G = len(gr.group_dims(n))
    return _pair_reduce(fxr, fxi, bxr, bxi, (G - 1 - j,), n)


def cross_diag_gram(fxr, fxi, bxr, bxi, j2: int, j1: int, n: int) -> torch.Tensor:
    """Complex ``W2[x2, x1] = sum_b bwd fwd`` over the two group axes of a
    cross diagonal (its joint table's cotangent), (dim_j2, dim_j1)."""
    G = len(gr.group_dims(n))
    a2, a1 = G - 1 - j2, G - 1 - j1
    W = _pair_reduce(fxr, fxi, bxr, bxi, (a2, a1), n)
    return W.T if a2 > a1 else W


# ---------------------------------------------------------------------------
# Group Grams (density epilogue)
# ---------------------------------------------------------------------------

def _gram_axis_xla(xr, xi, j: int, n: int) -> torch.Tensor:
    """Three-einsum Gram of a tiny group 2 (X < 8), as the JAX package
    computes it outside any kernel."""
    dims = gr.group_dims(n)
    ax = len(dims) - 1 - j
    sub = "abcdefgh"[: len(dims)]
    spec = f"{sub[:ax]}Z{sub[ax + 1:]},{sub}->Z{sub[ax]}"
    vr, vi = xr.reshape(dims), xi.reshape(dims)
    A = torch.einsum(spec, vr, vr)
    B = torch.einsum(spec, vi, vi)
    C = torch.einsum(spec, vr, vi)
    return torch.complex(A + B, C.T - C)


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
        if X < MIN_KERNEL_X and j < 3:
            return _gram_axis_xla(xr, xi, j, n)
        if X < MIN_KERNEL_X:
            # tiny top group: merged-axis kernel Gram, partial-traced back
            return gram_merged_top(xr, xi, n, kernels=kernels)[1]
        shape = (pre, X, M * 128)
    S, C = kernels.gram(xr.view(shape), xi.view(shape))
    return torch.complex(S, C.T - C)
