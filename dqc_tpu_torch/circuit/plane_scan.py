"""Plane-layout layer loop: the hot path of the engine on the card.

Counterpart of ``dqc_tpu/circuit/plane_scan.py``. A gate-only fused layer
runs L times over a state that lives as two f32 planes (ops/planes.py),
and every dense block executes as a hand-written kernel:

* blocks on the lane and sublane groups PAIR into one dual-group kernel
  sweep; high-group blocks use the high-axis kernel;
* a diagonal run adjacent to a minor dual sweep ('ddual') or to a high
  sweep ('dhigh') is multiplied inside that sweep's pass;
* the densities of the last state come from one Gram kernel read per group.

The gradient is the JAX package's O(1)-memory uncompute adjoint: the final
planes are the only residual. The density cotangents seed the cotangent
planes (one conj/acc apply per group), then a reverse loop over the layers
rolls (fwd, bwd) back through each kernel item in one pass of a backward
kernel (block_backward_dual / block_backward_high), which also yields each
dense block's pair gram; the variable gates' cotangents close from it in
small matrix algebra (circuit/fused_autograd.py). ``plane_std_scan_densities``
is a ``torch.autograd.Function`` around both.

The scheduler (``plane_program`` and its passes) is pure host code and is
the same as the JAX package's, item for item. The port executes the items
``dense``, ``ddual``, ``dhigh``, ``diag`` (a lone diagonal run: the diag
kernels), ``hpair`` (a tiny top group's block merged with the one below
it, Kronecker-factorized: merged_fact_apply / block_backward_merged_fact)
and ``dcross`` (a dense gate across two groups, e.g. a CNOT of the ring: one
pass of dual_multi_apply, of the high apply on a span view or of
high_multi_apply; its adjoint one block_backward_high pass on a span view,
or the 3-pass uncompute / transport), both ways, and the scan rotation of a
trailing const run both ways. The others (``mdiag``, ``xcross``, ``dens``),
the gradient of a variable ``dcross`` gate without a span view
(``_plane_pair_grad``) and cross-group density seeds raise
``NotImplementedError`` naming what is still to be ported, before any state
is allocated. The layer loops are Python loops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dqc_tpu_torch.circuit.fused_autograd import (
    _astype_host,
    _block_ops,
    _compose,
    _gate_op,
    _inv_dense,
    _inv_diag,
    _ref_gate,
    dense_block_var_cts,
)
from dqc_tpu_torch.circuit.fusion import FBlock, FCross, FDensity, FusedTape, GateRef
from dqc_tpu_torch.ops import groups as gr
from dqc_tpu_torch.ops import planes as pl
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet

C64 = torch.complex64


def plane_tape_eligible(ftape: FusedTape, dtype) -> bool:
    """True when the plane layout can hold this gate-only layer tape."""
    if not pl.plane_eligible(ftape.n, dtype):
        return False
    return not any(isinstance(fi, FDensity) for fi in ftape.instructions)


# ---------------------------------------------------------------------------
# Instruction scheduling: pair lane/sublane dense blocks into dual sweeps
# ---------------------------------------------------------------------------

def _touched_groups(fi, n: int) -> set:
    if isinstance(fi, FBlock):
        return {fi.group}
    if isinstance(fi, FCross):
        return {gr.group_of_bit(n, p)[0] for p in fi.positions}
    return set(range(len(gr.group_sizes_low_first(n))))  # density: all


def _is_dense_minor_block(fi) -> bool:
    return isinstance(fi, FBlock) and fi.group in (0, 1) and not fi.all_diag


def schedule_dual_pairs(ftape: FusedTape) -> Tuple[Tuple[int, Optional[int]], ...]:
    """Execution order with lane/sublane dense blocks paired.

    Returns a tuple of ``(index, partner_index_or_None)``: when a dense block
    on group 0 (or 1) is followed — with no intervening instruction touching
    groups 0 or 1 — by a dense block on the other minor group, both apply in
    ONE dual kernel sweep. Instructions between the pair act on disjoint
    qubits, so hoisting the partner is exact.
    """
    instrs = ftape.instructions
    n = ftape.n
    consumed = [False] * len(instrs)
    out: List[Tuple[int, Optional[int]]] = []
    for i, fi in enumerate(instrs):
        if consumed[i]:
            continue
        partner = None
        if _is_dense_minor_block(fi):
            want = 1 - fi.group
            for j in range(i + 1, len(instrs)):
                fj = instrs[j]
                if consumed[j]:
                    continue
                if _is_dense_minor_block(fj) and fj.group == want:
                    partner = j
                    consumed[j] = True
                    break
                if _touched_groups(fj, n) & {0, 1}:
                    break
        out.append((i, partner))
        consumed[i] = True
    return tuple(out)


def plane_program(ftape: FusedTape) -> Tuple[Tuple, ...]:
    """Execution plan over the fused tape: ``('dense', i, partner_or_None)``
    kernel sweeps, ``('diag', (i1, ..., ik))`` fused diagonal runs (every
    consecutive stretch of commuting diagonals), the folded ``('ddual', ...)``
    / ``('dhigh', ...)`` / ``('hpair', ...)`` sweeps, cross-group items and
    ``('dens', i)`` density requests."""
    n = ftape.n
    items: List[Tuple] = []
    run: List = []
    for i, j in schedule_dual_pairs(ftape):
        fi = ftape.instructions[i]
        is_diag = (isinstance(fi, FCross) and fi.diag) or (
            isinstance(fi, FBlock) and fi.all_diag)
        if is_diag:
            if (isinstance(fi, FCross) and len(
                    {gr.group_of_bit(n, p)[0] for p in fi.positions}) > 2):
                # >2-group diagonal: joint broadcast multiply ('mdiag') —
                # still commutes with the run, but its table does not fold
                # into the 3-factor diag-run form
                run.append(("m", i))
            else:
                run.append(i)
            continue
        if run:
            items.extend(_split_diag_run(run))
            run = []
        if isinstance(fi, FDensity):
            items.append(("dens", i))
        elif isinstance(fi, FCross):
            groups = {gr.group_of_bit(n, p)[0] for p in fi.positions}
            items.append(("xcross", i) if len(groups) > 2 else ("dcross", i))
        else:
            items.append(("dense", i, j))
    if run:
        items.extend(_split_diag_run(run))
    items = _sink_diag_items(tuple(items), ftape)
    items = _pair_diag_into_dual(_pair_top_groups(items, ftape), ftape)
    return _pair_diag_into_high(items, ftape)


def _sink_diag_items(items: Tuple[Tuple, ...], ftape: FusedTape):
    """Move every diagonal item (``diag`` run / ``mdiag``) as LATE as
    possible — diagonals commute with each other and with dense sweeps on
    disjoint groups — then merge adjacent runs into one. Density readouts
    (``dens``) are barriers. Exact: only commuting items are reordered."""
    out: List[Tuple] = []
    for item in items:
        if item[0] in ("diag", "mdiag", "dens"):
            out.append(item)
            continue
        # sink the trailing diagonals past this dense item when their
        # touched groups are disjoint
        k = len(out)
        touched = _item_touched(item, ftape)
        while k > 0 and out[k - 1][0] in ("diag", "mdiag") and not (
                _item_touched(out[k - 1], ftape) & touched):
            k -= 1
        out.insert(k, item)
    merged: List[Tuple] = []
    for item in out:
        if item[0] == "diag" and merged and merged[-1][0] == "diag":
            merged[-1] = ("diag", merged[-1][1] + item[1])
        else:
            merged.append(item)
    return tuple(merged)


def _pair_diag_into_dual(items: Tuple[Tuple, ...], ftape: FusedTape):
    """Fold a diagonal run ADJACENT to a minor dense sweep into one fused
    kernel item ``('ddual', run, i, j, diag_first)`` — either tape order:
    [run, dense] (``diag_first=True``) or [dense, run]."""

    def minor_dense(item):
        if item[0] != "dense":
            return False
        fi = ftape.instructions[item[1]]
        return isinstance(fi, FBlock) and fi.group in (0, 1)

    out: List[Tuple] = []
    for item in items:
        if out and out[-1][0] == "diag" and minor_dense(item):
            run = out.pop()[1]
            out.append(("ddual", run, item[1], item[2], True))
            continue
        if item[0] == "diag" and out and minor_dense(out[-1]):
            prev = out.pop()
            out.append(("ddual", item[1], prev[1], prev[2], False))
            continue
        out.append(item)
    return tuple(out)


def _item_touched(item, ftape: FusedTape) -> set:
    """Groups an execution-plan item reads or writes."""
    n = ftape.n
    if item[0] == "diag":
        out = set()
        for i in item[1]:
            out |= _touched_groups(ftape.instructions[i], n)
        return out
    if item[0] == "dhigh":
        out = _touched_groups(ftape.instructions[item[2]], n)
        for i in item[1]:
            out |= _touched_groups(ftape.instructions[i], n)
        return out
    if item[0] == "dense" and item[2] is not None:
        return (_touched_groups(ftape.instructions[item[1]], n)
                | _touched_groups(ftape.instructions[item[2]], n))
    return _touched_groups(ftape.instructions[item[1]], n)


def _pair_diag_into_high(items: Tuple[Tuple, ...], ftape: FusedTape):
    """Fold a diagonal run ADJACENT to a plain dense high-group sweep into
    one fused kernel item ``('dhigh', run, i, diag_first)`` — either tape
    order. Runs AFTER _pair_diag_into_dual, so minor dual folds keep
    priority; order is preserved exactly."""
    n = ftape.n

    def foldable(item):
        if item[0] != "dense" or item[2] is not None:
            return None
        fi = ftape.instructions[item[1]]
        if not isinstance(fi, FBlock) or fi.all_diag:
            return None
        return item[1] if pl.dhigh_eligible(fi.group, n) else None

    out: List[Tuple] = []
    for item in items:
        if out and out[-1][0] == "diag":
            i = foldable(item)
            if i is not None:
                run = out.pop()[1]
                out.append(("dhigh", run, i, True))
                continue
        if item[0] == "diag" and out:
            i = foldable(out[-1])
            if i is not None:
                out.pop()
                out.append(("dhigh", item[1], i, False))
                continue
        out.append(item)
    return tuple(out)


def _pair_top_groups(items: Tuple[Tuple, ...], ftape: FusedTape):
    """Compose a dense block on a TINY top group with a dense block on the
    group below it into ONE merged-axis sweep ``('hpair', low_i, top_i)``
    (legal whenever nothing between them touches either group)."""
    n = ftape.n
    dims = gr.group_dims(n)
    G = len(dims)
    jtop, jlow = G - 1, G - 2
    if jlow < 2 or dims[0] >= pl.MIN_KERNEL_X:
        return items

    def dense_group(item):
        if item[0] != "dense" or item[2] is not None:
            return None
        fi = ftape.instructions[item[1]]
        return fi.group if (isinstance(fi, FBlock) and not fi.all_diag) else None

    # the merged op sits at the EARLIER block's position — the LATER block
    # hoists backwards past the in-between items, exact iff none of them
    # touches the LATER block's group
    out: List[Tuple] = []
    pending: Dict[int, Tuple[int, int]] = {}  # group -> (out idx, instr idx)
    last_touch = {jtop: -1, jlow: -1}
    for item in items:
        g = dense_group(item)
        if g in (jtop, jlow):
            other = jlow if g == jtop else jtop
            if other in pending and last_touch[g] < pending[other][0]:
                oi, ii = pending.pop(other)
                low_i, top_i = (ii, item[1]) if other == jlow else (item[1], ii)
                out[oi] = ("hpair", low_i, top_i)
                pending.pop(g, None)
                last_touch[g] = oi
                last_touch[other] = oi
                continue
            pending[g] = (len(out), item[1])
            last_touch[g] = len(out)
            out.append(item)
            continue
        touched = _item_touched(item, ftape)
        for gg in (jtop, jlow):
            if gg in touched:
                last_touch[gg] = len(out)
        out.append(item)
    return tuple(out)


def _split_diag_run(run) -> List[Tuple]:
    """A pending diagonal stretch -> ('diag', idxs) runs with ('mdiag', i)
    broadcast items first (diagonals commute), so the fused run stays
    adjacent to a following minor dense sweep."""
    plain = tuple(i for i in run if not isinstance(i, tuple))
    items: List[Tuple] = [("mdiag", i) for kind, i in
                          (x for x in run if isinstance(x, tuple))]
    if plain:
        items.append(("diag", plain))
    return items


# ---------------------------------------------------------------------------
# What this slice executes
# ---------------------------------------------------------------------------

_MISSING = {
    "mdiag": "the >2-group diagonal multiply (planes.apply_multi_diag)",
    "xcross": "the >2-group dense gate (xcross: _apply_xcross)",
    "dens": "mid-circuit densities (the generic plane tape path)",
}
_PAIR_GRAD = ("the gradient of a variable dense cross-group gate without a "
              "span view (_plane_pair_grad, on groups.subblocks)")


def _unsupported(what: str, n: int) -> NotImplementedError:
    return NotImplementedError(
        f"n={n} needs {what}, not ported to dqc_tpu_torch yet (the port "
        "runs gate-only layers of dense blocks and diagonal runs at n in "
        "14..30); see ROADMAP.md")


def check_forward_supported(ftape: FusedTape, epi_ftape: FusedTape) -> None:
    """Raise ``NotImplementedError`` naming every missing kernel when the
    layer program or the density epilogue needs one the port lacks."""
    n = ftape.n
    missing: List[str] = []
    for item in plane_program(ftape):
        if item[0] in _MISSING:
            missing.append(f"plane item {item[0]!r}: {_MISSING[item[0]]}")
    for fi in epi_ftape.instructions:
        if not isinstance(fi, FDensity):
            missing.append("a gate in the density epilogue")
        elif len(_density_groups(fi, n)) > 1:
            missing.append("a cross-group density (_cross_density)")
    if missing:
        raise _unsupported("; ".join(dict.fromkeys(missing)), n)


def check_backward_supported(ftape: FusedTape) -> None:
    """Raise ``NotImplementedError`` when the layer program's adjoint needs
    what the port lacks: a variable dense cross-group gate without a span
    view (its cotangent needs ``_plane_pair_grad``)."""
    n = ftape.n
    for item in plane_program(ftape):
        if item[0] == "dcross":
            fi = ftape.instructions[item[1]]
            if fi.var and not pl.backward_span_eligible(fi.positions, n):
                raise _unsupported(_PAIR_GRAD, n)


# ---------------------------------------------------------------------------
# Diagonal-run table composition: the run's total diagonal as three pairwise
# factors D[a, s, l] = Tas[a,s] * Tal[a,l] * Tsl[s,l]
# ---------------------------------------------------------------------------

class _DiagFactors:
    def __init__(self, n: int, device: torch.device):
        self.dims = gr.group_dims(n)          # msb-first
        self.a_dims = tuple(self.dims[:-2])   # merged high groups
        self.A = int(np.prod(self.a_dims, dtype=np.int64)) if self.a_dims else 1
        self.device = device
        self.sl = None                        # (128, 128) [s, l]
        self.a_s = None                       # (A, 128)
        self.a_l = None                       # (A, 128)
        self.lane = None                      # (128,)
        self.sub = None                       # (128,)
        self.a = None                         # (A,)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(C64)

    @staticmethod
    def _m(acc, t):
        return t if acc is None else acc * t

    def _ax(self, j: int) -> int:
        # group j >= 2 sits at this index of a_dims (== index in full dims)
        return len(self.dims) - 1 - j

    def _expand_vec(self, j: int, vec):
        shape = [1] * len(self.a_dims)
        shape[self._ax(j)] = self.dims[self._ax(j)]
        return self._t(vec).reshape(shape).expand(self.a_dims).reshape(-1)

    def _expand_rows(self, j: int, table2):
        shape = [1] * len(self.a_dims) + [128]
        shape[self._ax(j)] = self.dims[self._ax(j)]
        return self._t(table2).reshape(shape).expand(
            self.a_dims + (128,)).reshape(self.A, 128)

    def _expand_joint(self, ja: int, jb: int, table2):
        axa, axb = self._ax(ja), self._ax(jb)  # axa < axb (ja > jb)
        shape = [1] * len(self.a_dims)
        shape[axa] = self.dims[axa]
        shape[axb] = self.dims[axb]
        return self._t(table2).reshape(shape).expand(self.a_dims).reshape(-1)

    def mul_group(self, j: int, vec):
        if j == 0:
            self.lane = self._m(self.lane, self._t(vec).reshape(-1))
        elif j == 1:
            self.sub = self._m(self.sub, self._t(vec).reshape(-1))
        else:
            self.a = self._m(self.a, self._expand_vec(j, vec))

    def mul_pair(self, ja: int, jb: int, table2):
        """Joint (ja, jb) cross table, ja > jb (cross_diag_table order)."""
        if (ja, jb) == (1, 0):
            self.sl = self._m(self.sl, self._t(table2))
        elif jb == 0:
            self.a_l = self._m(self.a_l, self._expand_rows(ja, table2))
        elif jb == 1:
            self.a_s = self._m(self.a_s, self._expand_rows(ja, table2))
        else:
            self.a = self._m(self.a, self._expand_joint(ja, jb, table2))

    def tables(self):
        ones = dict(dtype=C64, device=self.device)
        tsl = torch.ones((128, 128), **ones)
        if self.sl is not None:
            tsl = tsl * self.sl
        if self.sub is not None:
            tsl = tsl * self.sub[:, None]
        if self.lane is not None:
            tsl = tsl * self.lane[None, :]
        tas = torch.ones((self.A, 128), **ones)
        if self.a_s is not None:
            tas = tas * self.a_s
        tal = torch.ones((self.A, 128), **ones)
        if self.a_l is not None:
            tal = tal * self.a_l
        if self.a is not None:
            tal = tal * self.a[:, None]
        return tsl, tas, tal


def _run_has_var(run, ftape: FusedTape) -> bool:
    for i in run:
        fi = ftape.instructions[i]
        if isinstance(fi, FBlock) and fi.has_var:
            return True
        if isinstance(fi, FCross) and fi.var:
            return True
    return False


class _Layer:
    """One layer's gate values, plus the per-call cache of everything that
    depends only on const gates (the same in every layer: a const diagonal
    run's tables, a const gate's or block's operator and their inverses),
    built once on ``device``. Keeping the constants on the device spares a
    blocking host-to-device copy per use, which would stall the host until
    the card had finished every kernel queued before it."""

    def __init__(self, ftape: FusedTape, var_gates, const_gates,
                 device: torch.device, kernels: KernelSet, consts: Dict):
        self.ftape = ftape
        self.var_gates = var_gates
        self.const_gates = const_gates
        self.device = device
        self.kernels = kernels
        self.consts = consts

    def _const(self, key, has_var: bool, build):
        if has_var:
            return build()
        if key not in self.consts:
            self.consts[key] = build()
        return self.consts[key]

    def _on_device(self, x):
        return torch.as_tensor(x, device=self.device)

    def group_size(self, i: int) -> int:
        return gr.group_sizes_low_first(self.ftape.n)[self.ftape.instructions[i].group]

    def ops(self, i: int, inverse: bool = False):
        """Block ``i``'s per-gate full-group operators (or their inverses),
        the constant ones cached on the device."""
        fi = self.ftape.instructions[i]
        g = self.group_size(i)
        return [self._const(("gate", i, k, inverse), ref.var,
                            lambda ref=ref: self._on_device(_gate_op(
                                fi, ref, self.var_gates, self.const_gates, g,
                                C64, inverse=inverse)))
                for k, ref in enumerate(fi.gates)]

    def operator(self, i: int, inverse: bool = False):
        """Block operator of instruction ``i`` (or its inverse, composed in
        reverse order, for the uncompute)."""
        fi = self.ftape.instructions[i]
        return self._const(("op", i, inverse), fi.has_var, lambda: _compose(
            self.ops(i, inverse), diag=fi.all_diag, reverse=inverse))

    def run_tables(self, run, inverse: bool = False):
        """Complex (tsl, tas, tal) of a diagonal run (or of its inverse)."""
        return self._const(("run", run, inverse), _run_has_var(run, self.ftape),
                           lambda: _diag_run_tables(run, self.ftape,
                                                    self.var_gates,
                                                    self.const_gates,
                                                    self.device,
                                                    inverse=inverse))


def _cross_ctx(fi: FCross) -> str:
    return (f"{'var' if fi.var else 'const'} cross-group diag gate, "
            f"queue index {fi.queue_idx}")


def _diag_run_tables(run, ftape: FusedTape, var_gates, const_gates,
                     device: torch.device, *, inverse: bool = False):
    n = ftape.n
    sizes = gr.group_sizes_low_first(n)
    f = _DiagFactors(n, device)
    for i in run:
        fi = ftape.instructions[i]
        if isinstance(fi, FBlock):
            f.mul_group(fi.group, _block_operator(fi, var_gates, const_gates,
                                                  sizes[fi.group],
                                                  inverse=inverse))
        else:
            d = _cross_gate(fi, var_gates, const_gates).reshape(-1)
            if inverse:
                d = _inv_diag(d, fi.unitary, _cross_ctx(fi))
            table2, ja, jb = gr.cross_diag_table(d, fi.positions, n)
            f.mul_pair(ja, jb, table2)
    return f.tables()


# ---------------------------------------------------------------------------
# Per-instruction plane execution
# ---------------------------------------------------------------------------

def _block_operator(fi: FBlock, var_gates, const_gates, g: int, *,
                    inverse: bool = False, reverse: bool = False):
    ops = _block_ops(fi, var_gates, const_gates, g, C64, inverse=inverse)
    return _compose(ops, diag=fi.all_diag, reverse=reverse)


def _cross_gate(fi: FCross, var_gates, const_gates):
    return _astype_host(
        _ref_gate(GateRef(fi.var, fi.queue_idx, (), fi.diag, fi.unitary),
                  var_gates, const_gates),
        C64,
    )


# ---------------------------------------------------------------------------
# Dense cross-group (2-qubit) gates on planes
#
# G = sum_t EA_t (x) EB_t over its two groups: the whole term sum runs in ONE
# kernel pass (a span view of the high bits, the multi-term dual kernel or
# the multi-term high + lane kernel), in place; shapes without a fused
# kernel run 2 accumulate sweeps per term.
# ---------------------------------------------------------------------------

def _schmidt_pruned(gate4):
    """schmidt_terms with concrete zero-weight terms dropped host-side."""
    As, Bs = gr.schmidt_terms(gate4)
    ca, cb = gr.concrete_or_none(As), gr.concrete_or_none(Bs)
    if ca is not None and cb is not None:
        return [(ca[i], cb[i]) for i in range(ca.shape[0])
                if np.abs(ca[i]).max() * np.abs(cb[i]).max() > 1e-12]
    return [(As[i], Bs[i]) for i in range(4)]


def _dense_cross_expanded_terms(gate_m, positions, n: int):
    """Exact per-group operator-product decomposition of a dense k-qubit
    gate spanning TWO groups: ``G = sum_t EA_t (on ja) * EB_t (on jb)``,
    full-group expanded.

    k = 2: operator-Schmidt (rank <= 4, SVD-pruned for constants). k >= 3:
    slice decomposition over the side with fewer gate bits — for each
    ``(qa, pa)`` a-side bit pattern pair, the a-side factor is the
    elementary ``|qa><pa|`` and the b-side factor the corresponding 2^kb
    slice of G (4^ka terms, zero slices of a constant dropped)."""
    sizes = gr.group_sizes_low_first(n)
    k = len(positions)
    if k == 2:
        p2, p1 = positions
        j2, r2 = gr.group_of_bit(n, p2)
        j1, r1 = gr.group_of_bit(n, p1)
        return [(gr.expand_in_group(A, (r2,), sizes[j2]), j2,
                 gr.expand_in_group(B, (r1,), sizes[j1]), j1)
                for A, B in _schmidt_pruned(gate_m)]

    info = [gr.group_of_bit(n, p) for p in positions]
    group_ids = list(dict.fromkeys(g for g, _ in info))
    assert len(group_ids) == 2, positions
    ia = [i for i, (g, _) in enumerate(info) if g == group_ids[0]]
    ib = [i for i, (g, _) in enumerate(info) if g == group_ids[1]]
    if len(ia) > len(ib):
        ia, ib = ib, ia
    ja, jb = info[ia[0]][0], info[ib[0]][0]
    ka, kb = len(ia), len(ib)
    rels_a = tuple(info[i][1] for i in ia)
    rels_b = tuple(info[i][1] for i in ib)
    c = gr.concrete_or_none(gate_m)
    G = (c if c is not None else gate_m).reshape((2,) * (2 * k))  # q .. p bits
    terms = []
    for qa in range(1 << ka):
        for pa in range(1 << ka):
            idx = [slice(None)] * (2 * k)
            for t, i in enumerate(ia):
                idx[i] = (qa >> (ka - 1 - t)) & 1
                idx[k + i] = (pa >> (ka - 1 - t)) & 1
            B = G[tuple(idx)].reshape(1 << kb, 1 << kb)
            if c is not None and np.abs(B).max() < 1e-12:
                continue
            A = np.zeros((1 << ka, 1 << ka), np.complex64)
            A[qa, pa] = 1.0
            terms.append((gr.expand_in_group(A, rels_a, sizes[ja]), ja,
                          gr.expand_in_group(B, rels_b, sizes[jb]), jb))
    return terms


def _cross_plan(gate_m, positions, n: int, device: torch.device):
    """How a dense cross-group gate runs, with its operands staged on
    ``device``: ``("span", ops)`` (planes.apply_cross_span), ``("terms",
    ops)`` (planes.apply_cross_terms) or ``("per_term", terms)`` (the
    operators of the 2-sweeps-per-term fallback)."""
    ops = pl.cross_span_operands(gate_m, positions, n, device)
    if ops is not None:
        return "span", ops
    terms = _dense_cross_expanded_terms(gate_m, positions, n)
    ops = pl.cross_terms_operands(terms, n, device)
    if ops is not None:
        return "terms", ops

    def dev(E):
        return torch.as_tensor(E, device=device).to(C64)

    return "per_term", [(dev(EA), ja, dev(EB), jb) for EA, ja, EB, jb in terms]


def _apply_dense_cross(xr, xi, gate_m, positions, n: int, kernels: KernelSet,
                       *, conj: bool = False, acc0=None, alias: bool = False,
                       plan=None):
    """Dense cross-group gate = per-group term decomposition: the WHOLE term
    sum in one fused kernel pass (in place when ``alias``), or 2 accumulate
    sweeps per term where the pair shape has no fused kernel. ``conj`` /
    ``acc0`` give the seed form ``acc0 + conj(G x)``. ``plan``: the gate's
    :func:`_cross_plan`, staged once per call for a constant gate
    (``gate_m`` is then not read)."""
    if plan is None:
        plan = _cross_plan(gate_m, positions, n, xr.device)
    kind, ops = plan
    kw = dict(alias=alias and acc0 is None, conj=conj, acc=acc0, kernels=kernels)
    if kind == "span":
        return pl.apply_cross_span(xr, xi, gate_m, positions, n, operands=ops, **kw)
    if kind == "terms":
        return pl.apply_cross_terms(xr, xi, None, n, operands=ops, **kw)
    acc = acc0
    for EA, ja, EB, jb in ops:
        tr, ti = pl.apply_block(xr, xi, EB, jb, n, alias=False, kernels=kernels)
        acc = pl.apply_block(tr, ti, EA, ja, n, acc=acc, conj=conj,
                             kernels=kernels)
    return acc


def _cross_dense_gate(fi: FCross, var_gates, const_gates):
    kk = 1 << len(fi.positions)
    return _cross_gate(fi, var_gates, const_gates).reshape(kk, kk)


def _cross_gates(layer: _Layer, i: int):
    """Instruction ``i``'s dense cross-group gate and its inverse."""
    fi = layer.ftape.instructions[i]
    m = _cross_dense_gate(fi, layer.var_gates, layer.const_gates)
    return m, _inv_dense(m, fi.unitary, _cross_ctx(fi))


def _apply_dcross(xr, xi, i: int, layer: _Layer):
    """Forward of a ``dcross`` item: one in-place kernel pass."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    plan = layer._const(("dcross", i), fi.var, lambda: _cross_plan(
        _cross_gates(layer, i)[0], fi.positions, n, layer.device))
    return _apply_dense_cross(xr, xi, None, fi.positions, n, layer.kernels,
                              alias=True, plan=plan)


def _dual_operators(layer: _Layer, i: int, j: Optional[int]):
    """(E0, E1) lane/sublane operators of a minor sweep (None = identity)."""
    fi = layer.ftape.instructions[i]
    E = layer.operator(i)
    Ep = layer.operator(j) if j is not None else None
    return (E, Ep) if fi.group == 0 else (Ep, E)


def _apply_dense_item(xr, xi, i, j, layer: _Layer):
    if j is not None:
        E0, E1 = _dual_operators(layer, i, j)
        return pl.apply_dual(xr, xi, E0, E1, kernels=layer.kernels)
    return pl.apply_block(xr, xi, layer.operator(i),
                          layer.ftape.instructions[i].group, layer.ftape.n,
                          kernels=layer.kernels)


def _ddual_order(item) -> bool:
    """diag_first flag of a ddual item (older 4-tuples = diag-first)."""
    return item[4] if len(item) > 4 else True


def _apply_ddual(xr, xi, item, layer: _Layer):
    """Fused [diag run + minor dense sweep] forward (either tape order):
    one kernel pass."""
    E0, E1 = _dual_operators(layer, item[2], item[3])
    return pl.apply_dual(xr, xi, E0, E1, diag=layer.run_tables(item[1]),
                         diag_first=_ddual_order(item), kernels=layer.kernels)


def _apply_dhigh_item(xr, xi, item, layer: _Layer):
    """Fused [diag run + dense high-group sweep] forward: one kernel pass."""
    fi = layer.ftape.instructions[item[2]]
    return pl.apply_dhigh(xr, xi, layer.operator(item[2]),
                          layer.run_tables(item[1]), fi.group, layer.ftape.n,
                          diag_first=item[3], kernels=layer.kernels)


def _hpair_ops(item, layer: _Layer, inverse: bool = False):
    """(E_low, E_top) block operators of an hpair item (or their inverses)."""
    return layer.operator(item[1], inverse), layer.operator(item[2], inverse)


def _apply_hpair(xr, xi, item, layer: _Layer):
    """Forward of a merged (top, top-1) dense sweep, Kronecker-factorized
    (config.hpair_factorized: the expanded sweep is not ported)."""
    El, Et = _hpair_ops(item, layer)
    return pl.apply_merged_top_fact(xr, xi, Et, El, layer.ftape.n,
                                    kernels=layer.kernels)


def _apply_forward(xr, xi, program, layer: _Layer):
    """Gate-only forward over a plane program (no density items)."""
    for item in program:
        if item[0] == "diag":
            xr, xi = pl.apply_diag_run(xr, xi, layer.run_tables(item[1]),
                                       kernels=layer.kernels)
        elif item[0] == "hpair":
            xr, xi = _apply_hpair(xr, xi, item, layer)
        elif item[0] == "ddual":
            xr, xi = _apply_ddual(xr, xi, item, layer)
        elif item[0] == "dhigh":
            xr, xi = _apply_dhigh_item(xr, xi, item, layer)
        elif item[0] == "dense":
            xr, xi = _apply_dense_item(xr, xi, item[1], item[2], layer)
        elif item[0] == "dcross":
            xr, xi = _apply_dcross(xr, xi, item[1], layer)
        else:
            raise _unsupported(
                f"plane item {item[0]!r}: {_MISSING[item[0]]}",
                layer.ftape.n)
    return xr, xi


# ---------------------------------------------------------------------------
# Per-item adjoint: the reverse of _apply_forward
# ---------------------------------------------------------------------------

def _backward_program(fxr, fxi, bxr, bxi, program, layer: _Layer,
                      var_cts: Dict[int, torch.Tensor]):
    """Reverse the program: paired dense sweeps (with a folded run or not)
    roll back in one dual backward kernel pass, high sweeps in one high
    backward kernel pass, merged sweeps in one merged backward kernel pass,
    each lone diagonal run in one diag backward kernel pass and each dense
    cross-group gate in one or three passes (_backward_dense_cross)."""
    for item in reversed(program):
        if item[0] == "diag":
            fxr, fxi, bxr, bxi = _diag_run_backward(fxr, fxi, bxr, bxi, item[1],
                                                    layer)
        elif item[0] == "hpair":
            fxr, fxi, bxr, bxi = _backward_hpair(fxr, fxi, bxr, bxi, item,
                                                 layer, var_cts)
        elif item[0] == "ddual":
            fxr, fxi, bxr, bxi = _backward_ddual(fxr, fxi, bxr, bxi, item,
                                                 layer, var_cts)
        elif item[0] == "dhigh":
            fxr, fxi, bxr, bxi = _backward_dhigh(fxr, fxi, bxr, bxi, item,
                                                 layer, var_cts)
        elif item[0] == "dense" and item[2] is None:
            fxr, fxi, bxr, bxi = _backward_step(fxr, fxi, bxr, bxi, item[1],
                                                layer, var_cts)
        elif item[0] == "dense":
            fxr, fxi, bxr, bxi = _backward_dual_step(
                fxr, fxi, bxr, bxi, item[1], item[2], layer, var_cts)
        elif item[0] == "dcross":
            fxr, fxi, bxr, bxi = _backward_dense_cross(
                fxr, fxi, bxr, bxi, item[1], layer, var_cts)
        else:
            raise _unsupported(f"plane item {item[0]!r}: {_MISSING[item[0]]}",
                               layer.ftape.n)
    return fxr, fxi, bxr, bxi


def _close_block_cts(layer: _Layer, i: int, T0: torch.Tensor,
                     var_cts: Dict[int, torch.Tensor]) -> None:
    """The var gates' cotangents of dense block ``i`` from its pair gram."""
    fi = layer.ftape.instructions[i]
    if fi.has_var:
        dense_block_var_cts(fi, layer.ops(i), T0.to(C64), layer.var_gates,
                            layer.const_gates, layer.group_size(i), C64,
                            var_cts)


def _no_var_run(run, layer: _Layer) -> None:
    if _run_has_var(run, layer.ftape):
        raise _unsupported(
            "the Q reductions of a variable diagonal run (the diag_q outputs of "
            "block_backward_dual / block_backward_high, _diag_cts_from_Q, "
            "diag_block_var_cts)", layer.ftape.n)


def _backward_step(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                   var_cts: Dict[int, torch.Tensor]):
    """Roll (fwd, bwd) planes back through one unpaired dense block,
    recording its var gates' cotangents (the dense FBlock branch of the JAX
    package's _backward_step; the diagonal and cross-group branches need
    kernels not ported yet)."""
    fi = layer.ftape.instructions[i]
    if not isinstance(fi, FBlock) or fi.all_diag:
        raise _unsupported("the adjoint of a cross-group instruction (the "
                           "cross-group paths)", layer.ftape.n)
    fxr, fxi, bxr, bxi, T0 = pl.backward_block(
        fxr, fxi, bxr, bxi, layer.operator(i, inverse=True), layer.operator(i),
        fi.group, layer.ftape.n, kernels=layer.kernels)
    _close_block_cts(layer, i, T0, var_cts)
    return fxr, fxi, bxr, bxi


def _backward_dual_step(fxr, fxi, bxr, bxi, i_first: int,
                        i_second: Optional[int], layer: _Layer,
                        var_cts: Dict[int, torch.Tensor], *, run=None,
                        diag_first: bool = True):
    """Adjoint of a lane + sublane dense sweep in ONE read of the (fwd, bwd)
    planes (block_backward_dual). ``i_first`` was applied before
    ``i_second`` in the forward (None: identity on the other minor group);
    ``run``: a const diagonal run folded into the sweep, before it in the
    forward when ``diag_first``."""
    ftape = layer.ftape
    dev = fxr.device
    g0_first = ftape.instructions[i_first].group == 0
    lane_i, sub_i = (i_first, i_second) if g0_first else (i_second, i_first)
    eye = torch.eye(128, dtype=torch.float32, device=dev)
    zr = torch.zeros((128, 128), dtype=torch.float32, device=dev)

    def ops_of(i):
        if i is None:
            return eye, zr, eye, zr
        return (*pl.op_planes(layer.operator(i, inverse=True), dev),
                *pl.op_planes(layer.operator(i), dev))

    diag = {}
    if run is not None:
        _no_var_run(run, layer)
        diag = dict(
            diag_inv_tables=pl._diag_table_planes(layer.run_tables(run, True), dev),
            diag_tables=pl._diag_table_planes(layer.run_tables(run), dev),
            diag_first_fwd=diag_first)
    out = layer.kernels.block_backward_dual(
        fxr, fxi, bxr, bxi, *ops_of(lane_i), *ops_of(sub_i),
        g0_first=g0_first, **diag)
    if lane_i is not None:
        _close_block_cts(layer, lane_i, torch.complex(out[4], out[5]), var_cts)
    if sub_i is not None:
        _close_block_cts(layer, sub_i, torch.complex(out[6], out[7]), var_cts)
    return out[0], out[1], out[2], out[3]


def _backward_ddual(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a fused [diag run + minor dense pair] in ONE kernel pass:
    the pair reverses as in _backward_dual_step and (fwd, bwd) roll through
    the run in the same pass (without the Q reductions: the run is const)."""
    return _backward_dual_step(fxr, fxi, bxr, bxi, item[2], item[3], layer,
                               var_cts, run=item[1],
                               diag_first=_ddual_order(item))


def _diag_run_backward(fxr, fxi, bxr, bxi, run, layer: _Layer):
    """One in-place kernel pass rolling (fwd, bwd) back through a const
    diagonal run (uncompute + cotangent transport). A run with variable
    gates needs the Q reductions and raises."""
    _no_var_run(run, layer)
    fxr, fxi, bxr, bxi, _ = pl.backward_diag_run(
        fxr, fxi, bxr, bxi, layer.run_tables(run, True), layer.run_tables(run),
        with_q=False, kernels=layer.kernels)
    return fxr, fxi, bxr, bxi


def _backward_hpair(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a merged (top, top-1) dense sweep in ONE kernel pass
    (block_backward_merged_fact). With forward order [low, top] (they
    commute) the two blocks' pair grams are the restrictions of the merged
    pair gram that the kernel returns: ``T0_top`` sees fwd with only the
    top block uncomputed, ``T0_low`` fwd with only the low block
    uncomputed, both against the incoming cotangent."""
    El, Et = _hpair_ops(item, layer)
    Eli, Eti = _hpair_ops(item, layer, inverse=True)
    fxr, fxi, bxr, bxi, T0_top, T0_low = pl.backward_merged_top_fact(
        fxr, fxi, bxr, bxi, Et, El, Eti, Eli, layer.ftape.n,
        kernels=layer.kernels)
    _close_block_cts(layer, item[2], T0_top, var_cts)
    _close_block_cts(layer, item[1], T0_low, var_cts)
    return fxr, fxi, bxr, bxi


def _backward_dense_cross(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                          var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a dense cross-group gate. A span view without lane bits:
    uncompute, transport and the gate cotangent in ONE block_backward_high
    pass (planes.backward_cross_span). Otherwise: uncompute with G^-1, the
    pair gradient on the restored planes (a variable gate: _plane_pair_grad,
    not ported — check_backward_supported refuses it before any state), and
    transport with G^T, each a fused one-pass apply."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    pos, dev = fi.positions, layer.device
    if pl.backward_span_eligible(pos, n):
        ops = layer._const(("dcross", i, "adjoint"), fi.var, lambda: (
            pl.backward_span_operands(*_cross_gates(layer, i), pos, n, dev)))
        fxr, fxi, bxr, bxi, W = pl.backward_cross_span(
            fxr, fxi, bxr, bxi, None, None, pos, n, kernels=layer.kernels,
            operands=ops, with_cotangent=fi.var)
        if fi.var:
            var_cts[fi.queue_idx] = W
        return fxr, fxi, bxr, bxi
    if fi.var:
        raise _unsupported(_PAIR_GRAD, n)
    inv_plan = layer._const(("dcross", i, "inverse"), fi.var, lambda: (
        _cross_plan(_cross_gates(layer, i)[1], pos, n, dev)))
    fxr, fxi = _apply_dense_cross(fxr, fxi, None, pos, n, layer.kernels,
                                  alias=True, plan=inv_plan)
    tr_plan = layer._const(("dcross", i, "transpose"), fi.var, lambda: (
        _cross_plan(_cross_gates(layer, i)[0].T, pos, n, dev)))
    bxr, bxi = _apply_dense_cross(bxr, bxi, None, pos, n, layer.kernels,
                                  alias=True, plan=tr_plan)
    return fxr, fxi, bxr, bxi


def _backward_dhigh(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a fused [diag run + dense high-group sweep] in ONE kernel
    pass: uncompute + transport + the dense block's T0 pair gram
    (pl.backward_dhigh)."""
    run, i = item[1], item[2]
    _no_var_run(run, layer)
    fi = layer.ftape.instructions[i]
    fxr, fxi, bxr, bxi, T0, _ = pl.backward_dhigh(
        fxr, fxi, bxr, bxi, layer.operator(i, inverse=True), layer.operator(i),
        layer.run_tables(run, True), layer.run_tables(run), fi.group,
        layer.ftape.n, diag_first=item[3], kernels=layer.kernels)
    _close_block_cts(layer, i, T0, var_cts)
    return fxr, fxi, bxr, bxi


# ---------------------------------------------------------------------------
# The layer loop
# ---------------------------------------------------------------------------

def _num_layers(stacked_var_gates) -> int:
    return int(stacked_var_gates[0].shape[0]) if stacked_var_gates else 0


def _rotatable_const_diag(program, ftape: FusedTape):
    """Scan-rotation eligibility: the program ends with a CONST diagonal run
    that, moved to the front, ddual-folds into the layer's minor dual sweep.
    Then ``(R D)^L = D (R D)^(L-1) R``: head once, the folded body L-1
    times, the run once — one full-state pass fewer per layer. Returns
    ``(head, rotated_body, diag_item)`` or None."""
    if len(program) < 2 or program[-1][0] != "diag":
        return None
    diag_item = program[-1]
    if _run_has_var(diag_item[1], ftape):
        return None
    head = program[:-1]
    rotated = _pair_diag_into_dual((diag_item,) + head, ftape)
    if not rotated or rotated[0][0] != "ddual":
        return None
    return head, rotated, diag_item


def _scan_layers_forward(xr, xi, ftape: FusedTape, program, stacked_var_gates,
                         const_gates, *, kernels: KernelSet = KERNELS):
    """Forward L layers of ``program`` on planes (a loop over layers), with
    the const-trailing-diag rotation when eligible."""
    consts: Dict = {}

    def layer(l: int) -> _Layer:
        return _Layer(ftape, tuple(g[l] for g in stacked_var_gates),
                      const_gates, xr.device, kernels, consts)

    L = _num_layers(stacked_var_gates)
    rot = _rotatable_const_diag(program, ftape)
    if rot is not None and L >= 2:
        head, rotated, diag_item = rot
        xr, xi = _apply_forward(xr, xi, head, layer(0))
        for l in range(1, L):
            xr, xi = _apply_forward(xr, xi, rotated, layer(l))
        return _apply_forward(xr, xi, (diag_item,), layer(0))
    for l in range(L):
        xr, xi = _apply_forward(xr, xi, program, layer(l))
    return xr, xi


def _match_ct(ct: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    ct = ct.reshape(ref.shape)
    if ref.is_complex():
        return ct.to(ref.dtype)
    return ct.real.to(ref.dtype)


def _scan_layers_backward(fxr, fxi, bxr, bxi, ftape: FusedTape, program,
                          stacked_var_gates, const_gates, *,
                          kernels: KernelSet = KERNELS):
    """The adjoint of L layers, last layer first (a loop over layers),
    mirroring the rotation of _scan_layers_forward: the trailing const run
    rolls back first (no cotangents), then the rotated body for layers
    L-1 .. 1, then the head with layer 0's gates. Returns ``((fxr, fxi, bxr,
    bxi), stacked_cts)``, the cotangents stacked like the gates."""
    L = _num_layers(stacked_var_gates)
    consts: Dict = {}
    per_layer: List = [None] * L

    def layer(l: int) -> _Layer:
        return _Layer(ftape, tuple(g[l] for g in stacked_var_gates),
                      const_gates, fxr.device, kernels, consts)

    def back(planes, prog, l: int):
        var_cts: Dict[int, torch.Tensor] = {}
        lay = layer(l)
        planes = _backward_program(*planes, prog, lay, var_cts)
        per_layer[l] = tuple(_match_ct(var_cts[q], g)
                             for q, g in enumerate(lay.var_gates))
        return planes

    planes = (fxr, fxi, bxr, bxi)
    rot = _rotatable_const_diag(program, ftape)
    if rot is not None and L >= 2:
        head, rotated, diag_item = rot
        planes = _backward_program(*planes, (diag_item,), layer(0), {})
        for l in reversed(range(1, L)):
            planes = back(planes, rotated, l)
        planes = back(planes, head, 0)
    else:
        for l in reversed(range(L)):
            planes = back(planes, program, l)
    stacked_cts = tuple(torch.stack([cts[q] for cts in per_layer])
                        for q in range(len(stacked_var_gates)))
    return planes, stacked_cts


# ---------------------------------------------------------------------------
# Plane density epilogue
# ---------------------------------------------------------------------------

def plane_epilogue_eligible(epi_ftape: FusedTape, dtype) -> bool:
    """Density-only tapes on a plane-eligible state."""
    if not pl.plane_eligible(epi_ftape.n, dtype):
        return False
    return all(isinstance(fi, FDensity) for fi in epi_ftape.instructions)


def _plane_gram(xr, xi, j: int, n: int, kernels: KernelSet) -> torch.Tensor:
    """Complex group Gram in one read of the planes (the Gram kernel)."""
    return pl.gram_axis(xr, xi, j, n, kernels=kernels)


def _density_groups(fi: FDensity, n: int) -> set:
    return {gr.group_of_bit(n, p)[0] for p in fi.positions}


def _density_for(grams: Dict, xr, xi, fi: FDensity, n: int,
                 kernels: KernelSet) -> torch.Tensor:
    groups = _density_groups(fi, n)
    if len(groups) != 1:
        raise _unsupported("a cross-group density (_cross_density)", n)
    j = groups.pop()
    G = _gram_for(grams, xr, xi, j, n, kernels)
    rels = tuple(p % gr.GROUP_BITS for p in fi.positions)
    return gr.density_from_gram(G, rels, gr.group_sizes_low_first(n)[j])


def _epilogue_density_list(epi_ftape: FusedTape, xr, xi, n: int,
                           kernels: KernelSet = KERNELS):
    """Diff-density matrices of a density-only tape from cached per-group
    Grams (one kernel read per group)."""
    grams: Dict[int, torch.Tensor] = {}
    return tuple(_density_for(grams, xr, xi, fi, n, kernels)
                 for fi in epi_ftape.instructions if fi.diff)


def _gram_for(grams: Dict[int, torch.Tensor], xr, xi, j: int, n: int,
              kernels: KernelSet) -> torch.Tensor:
    """Per-group Gram with caching; when the top group is tiny, ONE merged
    kernel read serves both the top and the next group (partial traces)."""
    G = grams.get(j)
    if G is not None:
        return G
    njg = len(gr.group_dims(n))
    if pl.merged_top_tiny(n) and j in (njg - 1, njg - 2):
        grams[njg - 2], grams[njg - 1] = pl.gram_merged_top(xr, xi, n,
                                                            kernels=kernels)
        return grams[j]
    G = grams[j] = _plane_gram(xr, xi, j, n, kernels)
    return G


# ---------------------------------------------------------------------------
# Density seeds of the cotangent planes
# ---------------------------------------------------------------------------

def _add_seed(pending: Dict, fi: FDensity, ct: torch.Tensor, n: int) -> None:
    """Fold one diff-density cotangent into the seed accumulators: in-group
    requests sum per-group expanded operators ``(L + L^H)`` (key = group).
    Cross-group requests need the dense cross-group seed, not ported."""
    sizes = gr.group_sizes_low_first(n)
    d = 1 << len(fi.positions)
    ct_m = ct.reshape(d, d).to(C64)
    sym = ct_m + ct_m.conj().T
    groups = _density_groups(fi, n)
    if len(groups) != 1:
        raise _unsupported("a cross-group density seed (the conj / acc modes of "
                           "dual_multi_apply_planes / high_multi_apply_planes)", n)
    j = groups.pop()
    rels = tuple(p % gr.GROUP_BITS for p in fi.positions)
    E = gr.expand_in_group(sym, rels, sizes[j])
    pending[j] = E if j not in pending else pending[j] + E


def _collect_seed_pending(epi_ftape: FusedTape, density_cts, n: int,
                          pending: Optional[Dict] = None) -> Dict:
    """Summed seed operators ``(L + L^H)`` from the diff-density cotangents
    of a density-only tape."""
    if pending is None:
        pending = {}
    it = iter(density_cts)
    for fi in epi_ftape.instructions:
        if not fi.diff:
            continue
        _add_seed(pending, fi, next(it), n)
    return pending


def _seed_apply(fxr, fxi, pending: Dict[int, torch.Tensor], n: int,
                kernels: KernelSet = KERNELS):
    """The density seeds ``sum_j M_j conj(psi)`` as cotangent planes,
    computed as ``conj(sum_j conj(M_j) psi)``: one apply per group that
    READS the forward planes (``alias=False``) and accumulates into one
    set of cotangent planes (``acc``). Returns ``(None, None)`` without
    seeds. When the top group is tiny, the top two groups' seeds (a sum of
    per-group operators) combine into ONE merged-axis operator
    ``kron(M_top, I) + kron(I, M_low)`` and one pass, first."""
    pending = dict(pending)
    njg = len(gr.group_dims(n))
    bxr = bxi = None
    if pl.merged_top_tiny(n) and (njg - 1 in pending or njg - 2 in pending):
        X, Xl = gr.group_dims(n)[:2]
        M_top = pending.pop(njg - 1, None)
        M_low = pending.pop(njg - 2, None)
        Mm = None
        if M_top is not None:
            Mm = pl._kron_id(M_top, Xl)
        if M_low is not None:
            t = pl.kron_ops(np.eye(X, dtype=np.complex64), M_low)
            Mm = t if Mm is None else Mm + t
        bxr, bxi = pl.apply_merged_top(fxr, fxi, Mm.conj(), n, alias=False,
                                       conj=True, kernels=kernels)
    for j, M in pending.items():
        acc = None if bxr is None else (bxr, bxi)
        bxr, bxi = pl.apply_block(fxr, fxi, M.conj(), j, n, alias=False,
                                  conj=True, acc=acc, kernels=kernels)
    return bxr, bxi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

class _StdScanDensities(torch.autograd.Function):
    """The densities of ``epi_ftape`` after L layers of ``ftape`` from
    |0..0>, differentiable in the stacked var gates.

    The forward keeps only the final planes (and the gate values); the
    backward consumes them in place (the uncompute rolls them back), so a
    second backward through the same graph raises. PyTorch's gradient of a
    complex tensor is the conjugate of the JAX package's cotangent: the
    backward conjugates the density gradients on the way in and the gate
    cotangents on the way out."""

    @staticmethod
    def forward(ctx, ftape, epi_ftape, const_gates, device, kernels,
                *stacked_var_gates):
        xr, xi = pl.standard_planes(ftape.n, device)
        xr, xi = _scan_layers_forward(xr, xi, ftape, plane_program(ftape),
                                      stacked_var_gates, const_gates,
                                      kernels=kernels)
        densities = _epilogue_density_list(epi_ftape, xr, xi, ftape.n, kernels)
        ctx.statics = (ftape, epi_ftape, const_gates, kernels)
        ctx.planes = (xr, xi) if any(ctx.needs_input_grad) else None
        ctx.save_for_backward(*stacked_var_gates)
        return densities

    @staticmethod
    def backward(ctx, *density_grads):
        ftape, epi_ftape, const_gates, kernels = ctx.statics
        if ctx.planes is None:
            raise RuntimeError(
                "plane_std_scan_densities: the final planes were consumed by "
                "an earlier backward (the O(1)-memory adjoint rolls them back "
                "in place); run the forward again for another gradient")
        (fxr, fxi), ctx.planes = ctx.planes, None
        stacked = ctx.saved_tensors
        n = ftape.n
        pending = _collect_seed_pending(
            epi_ftape, tuple(g.conj() for g in density_grads), n)
        if not pending:
            return (None,) * 5 + tuple(torch.zeros_like(g) for g in stacked)
        bxr, bxi = _seed_apply(fxr, fxi, pending, n, kernels)
        _, stacked_cts = _scan_layers_backward(
            fxr, fxi, bxr, bxi, ftape, plane_program(ftape), stacked,
            const_gates, kernels=kernels)
        return (None,) * 5 + tuple(ct.conj() for ct in stacked_cts)


def plane_std_scan_densities(pro_ftape: Optional[FusedTape], ftape: FusedTape,
                             epi_ftape: FusedTape, pro_const_gates,
                             stacked_var_gates, const_gates, *, device=None,
                             kernels: KernelSet = KERNELS):
    """Diff densities of ``epi_ftape`` after L layers of ``ftape``, starting
    from |0..0> — fully plane-resident, no 2^n complex buffer — and
    differentiable in ``stacked_var_gates`` with torch autograd. The JAX
    signature is kept; a const prologue tape (``pro_ftape``) is not ported
    yet and raises."""
    if pro_ftape is not None:
        raise NotImplementedError("a prologue tape is not ported to "
                                  "dqc_tpu_torch yet; see ROADMAP.md")
    check_forward_supported(ftape, epi_ftape)
    if torch.is_grad_enabled() and any(
            isinstance(g, torch.Tensor) and g.requires_grad
            for g in stacked_var_gates):
        check_backward_supported(ftape)
    return _StdScanDensities.apply(ftape, epi_ftape, tuple(const_gates),
                                   device, kernels, *stacked_var_gates)


def std_scan_with_epilogue(pro_ftape: Optional[FusedTape], ftape: FusedTape,
                           epi_ftape: FusedTape, pro_const_gates,
                           stacked_var_gates, const_gates, *,
                           dtype=C64, device=None,
                           kernels: KernelSet = KERNELS):
    """Models whose circuit starts from |0..0>: the plane-resident forward
    and its adjoint. The JAX package's composed non-plane fallback is not
    ported: an ineligible tape raises ``NotImplementedError``."""
    if not (plane_tape_eligible(ftape, dtype)
            and plane_epilogue_eligible(epi_ftape, dtype)):
        raise NotImplementedError(
            "only plane-eligible circuits (n >= 14, complex64, gate-only "
            "layers, density-only epilogue) run in dqc_tpu_torch yet; the "
            "non-plane engine is ROADMAP.md queue A")
    return plane_std_scan_densities(pro_ftape, ftape, epi_ftape,
                                    pro_const_gates, stacked_var_gates,
                                    const_gates, device=device,
                                    kernels=kernels)
