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
the same as the JAX package's, item for item. The port executes every item
kind: ``dense``, ``ddual``, ``dhigh``, ``diag`` (a lone diagonal run: the
diag kernels), ``hpair`` (a tiny top group's block merged with the one
below it, Kronecker-factorized: merged_fact_apply /
block_backward_merged_fact; or expanded to the X = 256 / 512 merged axis
under ``config.set_hpair_factorized(False)``: the high apply in place and
block_backward_high), ``dcross`` (a dense gate across two groups,
e.g. a CNOT of the ring: one pass of dual_multi_apply, of the high apply on
a span view or of high_multi_apply; its adjoint one block_backward_high
pass on a span view, or the 3-pass uncompute / pair gradient / transport),
both ways, and the scan rotation of a trailing const run both ways. A
diagonal run with variable gates (the ZZ cost gates of VQE and QAOA)
closes its cotangents from the Q reductions of the backward kernel that
rolls it back (``diag_q`` of block_backward_dual or block_backward_high,
``with_q`` of diag_backward). Densities across groups come from a
sub-block contraction, and their seeds from the multi-term kernels' seed
modes (or a span view, or per-term sweeps). A const-only prologue tape
runs on the planes before the layers. The remaining items are plain torch
on the planes, as the JAX package leaves them to XLA: ``mdiag`` (a
diagonal over more than two groups), ``xcross`` (a dense gate over more
than two groups without a span view: a sub-block product), ``dens`` (a
mid-circuit density) and the gradient of a variable cross gate without a
span view (``_plane_pair_grad``). The layer loops are Python loops.

:func:`plane_tape_forward` runs a whole fused tape on the planes, gates
and density requests interleaved, and is the engine of
``AutoGradCircuit.build``'s ``autodiff_run`` when :func:`use_plane_tape`
holds.

Scan mode's entry points follow the JAX package's dispatch:
:func:`std_scan_with_epilogue` (models from |0..0>) runs the fully
plane-resident op when :func:`use_plane_engine` holds and every stage is
plane eligible, else the fallback: a complex |0..0>, the prologue by
``fused_run`` and :func:`scan_with_epilogue`, which runs
:func:`plane_scan_densities` (from an arbitrary state, on the planes) or
composes ``scan.scanned_layers`` (:func:`plane_scanned_layers` on the
planes, the grouped complex engine off them) with
:func:`epilogue_densities` (:func:`plane_density_epilogue` or the fused
engine). Off the planes (n < 14, complex128, ``set_plane_engine(False)``)
everything is plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit.fused_autograd import (
    _astype_host,
    _block_ops,
    _compose,
    _gate_op,
    _inv_dense,
    _inv_diag,
    _ref_gate,
    dense_block_var_cts,
    diag_block_var_cts,
)
from dqc_tpu_torch.circuit.fusion import FBlock, FCross, FDensity, FusedTape, GateRef
from dqc_tpu_torch.circuit.scan import _match_ct, _num_layers
from dqc_tpu_torch.ops import groups as gr
from dqc_tpu_torch.ops import planes as pl
from dqc_tpu_torch.ops.kernels import KERNELS, KernelSet
from dqc_tpu_torch.ops.kernels.gram import pair_sum

C64 = torch.complex64


def plane_tape_eligible(ftape: FusedTape, dtype) -> bool:
    """True when the plane layout can hold this gate-only layer tape."""
    if not pl.plane_eligible(ftape.n, dtype):
        return False
    return not any(isinstance(fi, FDensity) for fi in ftape.instructions)


def use_plane_engine(ftape: FusedTape, dtype) -> bool:
    """Scan mode on the planes: ``config.plane_engine()`` True or "auto"
    with a plane-eligible layer tape (on any device: the CPU runs the
    kernels' plain versions); False keeps scan mode off the planes. The
    JAX package's "auto" asks for its TPU backend instead."""
    return config.plane_engine() is not False and plane_tape_eligible(ftape, dtype)


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
        del tr, ti  # one temporary pair at a time
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


def _dual_operators(layer: _Layer, i: int, j: Optional[int],
                    inverse: bool = False):
    """(E0, E1) lane/sublane operators of a minor sweep (None = identity),
    or their inverses."""
    fi = layer.ftape.instructions[i]
    E = layer.operator(i, inverse)
    Ep = layer.operator(j, inverse) if j is not None else None
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


def _apply_ddual(xr, xi, item, layer: _Layer, inverse: bool = False):
    """Fused [diag run + minor dense sweep] forward (either tape order):
    one kernel pass. ``inverse`` un-applies the item (inverse operands, the
    order flipped) for the uncompute without a cotangent."""
    E0, E1 = _dual_operators(layer, item[2], item[3], inverse)
    return pl.apply_dual(xr, xi, E0, E1, diag=layer.run_tables(item[1], inverse),
                         diag_first=_ddual_order(item) != inverse,
                         kernels=layer.kernels)


def _apply_dhigh_item(xr, xi, item, layer: _Layer, inverse: bool = False):
    """Fused [diag run + dense high-group sweep] forward: one kernel pass
    (``inverse``: un-applied, as in _apply_ddual)."""
    fi = layer.ftape.instructions[item[2]]
    return pl.apply_dhigh(xr, xi, layer.operator(item[2], inverse),
                          layer.run_tables(item[1], inverse), fi.group,
                          layer.ftape.n, diag_first=item[3] != inverse,
                          kernels=layer.kernels)


def _hpair_ops(item, layer: _Layer, inverse: bool = False):
    """(E_low, E_top) block operators of an hpair item (or their inverses)."""
    return layer.operator(item[1], inverse), layer.operator(item[2], inverse)


def _apply_hpair(xr, xi, item, layer: _Layer):
    """Forward of a merged (top, top-1) dense sweep: Kronecker-factorized by
    default, the expanded merged operator ``Et (x) El`` in one in-place
    X = 256 / 512 high sweep under ``config.set_hpair_factorized(False)``."""
    El, Et = _hpair_ops(item, layer)
    if config.hpair_factorized():
        return pl.apply_merged_top_fact(xr, xi, Et, El, layer.ftape.n,
                                        kernels=layer.kernels)
    return pl.apply_merged_top(xr, xi, pl.kron_ops(Et, El), layer.ftape.n,
                               kernels=layer.kernels)


def _apply_item(xr, xi, item, layer: _Layer):
    """Forward of one gate item of a plane program."""
    n = layer.ftape.n
    if item[0] == "diag":
        return pl.apply_diag_run(xr, xi, layer.run_tables(item[1]),
                                 kernels=layer.kernels)
    if item[0] == "hpair":
        return _apply_hpair(xr, xi, item, layer)
    if item[0] == "ddual":
        return _apply_ddual(xr, xi, item, layer)
    if item[0] == "dhigh":
        return _apply_dhigh_item(xr, xi, item, layer)
    if item[0] == "dense":
        return _apply_dense_item(xr, xi, item[1], item[2], layer)
    if item[0] == "dcross":
        return _apply_dcross(xr, xi, item[1], layer)
    fi = layer.ftape.instructions[item[1]]
    if item[0] == "mdiag":
        d = _cross_gate(fi, layer.var_gates, layer.const_gates).reshape(-1)
        return pl.apply_multi_diag(xr, xi, d, fi.positions, n)
    assert item[0] == "xcross", item
    return _apply_xcross(xr, xi, _cross_gates(layer, item[1])[0], fi.positions,
                         n, layer.kernels)


def _apply_forward(xr, xi, program, layer: _Layer):
    """Gate-only forward over a plane program (no density items)."""
    for item in program:
        xr, xi = _apply_item(xr, xi, item, layer)
    return xr, xi


# ---------------------------------------------------------------------------
# Per-item adjoint: the reverse of _apply_forward
# ---------------------------------------------------------------------------

def _backward_program(fxr, fxi, bxr, bxi, program, layer: _Layer,
                      var_cts: Dict[int, torch.Tensor]):
    """Reverse the program: paired dense sweeps (with a folded run or not)
    roll back in one dual backward kernel pass, high sweeps in one high
    backward kernel pass, merged sweeps in one merged backward kernel pass,
    each lone diagonal run in one diag backward kernel pass, each dense
    cross-group gate in one or three passes (_backward_dense_cross), and
    the >2-group items in plain torch steps."""
    for item in reversed(program):
        if item[0] == "diag":
            fxr, fxi, bxr, bxi = _diag_run_backward(fxr, fxi, bxr, bxi, item[1],
                                                    layer, var_cts)
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
        elif item[0] == "mdiag":
            fxr, fxi, bxr, bxi = _backward_multi_diag(
                fxr, fxi, bxr, bxi, item[1], layer, var_cts)
        else:
            assert item[0] == "xcross", item
            fxr, fxi, bxr, bxi = _backward_xcross(
                fxr, fxi, bxr, bxi, item[1], layer, var_cts)
    return fxr, fxi, bxr, bxi


def _close_block_cts(layer: _Layer, i: int, T0: torch.Tensor,
                     var_cts: Dict[int, torch.Tensor]) -> None:
    """The var gates' cotangents of dense block ``i`` from its pair gram."""
    fi = layer.ftape.instructions[i]
    if fi.has_var:
        dense_block_var_cts(fi, layer.ops(i), T0.to(C64), layer.var_gates,
                            layer.const_gates, layer.group_size(i), C64,
                            var_cts)


def _backward_step(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                   var_cts: Dict[int, torch.Tensor]):
    """Roll (fwd, bwd) planes back through one instruction, recording its
    var gates' cotangents (the plane mirror of
    fused_autograd._backward_gate_step): a diagonal gate across two groups
    or an all-diagonal block by broadcast multiplies (plain torch), a dense
    block in one backward kernel pass."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    if isinstance(fi, FCross):
        d = _cross_gate(fi, layer.var_gates, layer.const_gates).reshape(-1)
        inv_t2, ja, jb = gr.cross_diag_table(
            _inv_diag(d, fi.unitary, _cross_ctx(fi)), fi.positions, n)
        fxr, fxi = pl.apply_cross_diag(fxr, fxi, inv_t2, ja, jb, n)
        if fi.var:
            W2 = pl.cross_diag_gram(fxr, fxi, bxr, bxi, ja, jb, n)
            var_cts[fi.queue_idx] = gr.cross_diag_table_vjp(W2, fi.positions, n)
        t2, _, _ = gr.cross_diag_table(d, fi.positions, n)
        bxr, bxi = pl.apply_cross_diag(bxr, bxi, t2, ja, jb, n)
        return fxr, fxi, bxr, bxi
    if fi.all_diag:
        fxr, fxi = pl.apply_diag_axis(fxr, fxi, layer.operator(i, inverse=True),
                                      fi.group, n)
        if fi.has_var:
            W = pl.diag_gram_axis(fxr, fxi, bxr, bxi, fi.group, n)
            diag_block_var_cts(fi, layer.ops(i), W, layer.var_gates,
                               layer.const_gates, layer.group_size(i), C64,
                               var_cts)
        bxr, bxi = pl.apply_diag_axis(bxr, bxi, layer.operator(i), fi.group, n)
        return fxr, fxi, bxr, bxi
    fxr, fxi, bxr, bxi, T0 = pl.backward_block(
        fxr, fxi, bxr, bxi, layer.operator(i, inverse=True), layer.operator(i),
        fi.group, n, kernels=layer.kernels)
    _close_block_cts(layer, i, T0, var_cts)
    return fxr, fxi, bxr, bxi


# ---------------------------------------------------------------------------
# Gates over more than two groups (plain torch on the planes, as the JAX
# package leaves them to XLA), and the pair gradient of a cross gate
# without a span view
# ---------------------------------------------------------------------------

def _apply_xcross(xr, xi, gate_m, positions, n: int, kernels: KernelSet):
    """A dense k-qubit gate over more than two groups: one in-place pass of
    the span view where the bits allow one (planes.apply_cross_span), else
    the target bits gathered to the front (groups.subblocks), one
    ``(2^k, 2^k) x (2^k, 2^(n-k))`` complex product, and the result written
    back (fresh planes)."""
    ops = pl.cross_span_operands(gate_m, positions, n, xr.device)
    if ops is not None:
        return pl.apply_cross_span(xr, xi, None, positions, n, kernels=kernels,
                                   operands=ops)
    k = len(positions)
    m = torch.as_tensor(gate_m, device=xr.device).to(C64).reshape(1 << k, 1 << k)
    dims = gr.group_dims(n)
    Sr, restore_r = gr.subblocks_with_restore(xr.reshape(dims), positions, n)
    Si, restore_i = gr.subblocks_with_restore(xi.reshape(dims), positions, n)
    Y = torch.matmul(m, torch.complex(Sr, Si))
    del Sr, Si
    return (restore_r(Y.real).reshape(xr.shape),
            restore_i(Y.imag).reshape(xi.shape))


def _plane_pair_grad(fxr, fxi, bxr, bxi, positions, n: int) -> torch.Tensor:
    """Dense cross-gate cotangent ``W[p, q] = sum_b bwd[p, b] fwd[q, b]``
    on planes (groups.pair_grad on the complex sub-blocks)."""
    dims = gr.group_dims(n)
    F = torch.complex(gr.subblocks(fxr.reshape(dims), positions, n),
                      gr.subblocks(fxi.reshape(dims), positions, n))
    B = torch.complex(gr.subblocks(bxr.reshape(dims), positions, n),
                      gr.subblocks(bxi.reshape(dims), positions, n))
    return pair_sum(B[None], F[None])


def _backward_xcross(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                     var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a dense gate over more than two groups: one
    block_backward_high pass on a span view where the bits allow one, else
    the uncompute with G^-1, the pair gradient and the transport with G^T,
    each on the sub-blocks."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    m, minv = _cross_gates(layer, i)
    fused = pl.backward_cross_span(fxr, fxi, bxr, bxi, m, minv, fi.positions, n,
                                   kernels=layer.kernels, with_cotangent=fi.var)
    if fused is not None:
        fxr, fxi, bxr, bxi, W = fused
        if fi.var:
            var_cts[fi.queue_idx] = W
        return fxr, fxi, bxr, bxi
    fxr, fxi = _apply_xcross(fxr, fxi, minv, fi.positions, n, layer.kernels)
    if fi.var:
        var_cts[fi.queue_idx] = _plane_pair_grad(fxr, fxi, bxr, bxi,
                                                 fi.positions, n)
    bxr, bxi = _apply_xcross(bxr, bxi, m.T, fi.positions, n, layer.kernels)
    return fxr, fxi, bxr, bxi


def _backward_multi_diag(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                         var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a diagonal over more than two groups: broadcast uncompute
    with d^-1, the sub-block pair gradient, transport with d."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    d = _cross_gate(fi, layer.var_gates, layer.const_gates).reshape(-1)
    fxr, fxi = pl.apply_multi_diag(
        fxr, fxi, _inv_diag(d, fi.unitary, _cross_ctx(fi)), fi.positions, n)
    if fi.var:
        var_cts[fi.queue_idx] = pl.multi_diag_gram(fxr, fxi, bxr, bxi,
                                                   fi.positions, n)
    bxr, bxi = pl.apply_multi_diag(bxr, bxi, d, fi.positions, n)
    return fxr, fxi, bxr, bxi


def _backward_dual_step(fxr, fxi, bxr, bxi, i_first: int,
                        i_second: Optional[int], layer: _Layer,
                        var_cts: Dict[int, torch.Tensor], *, run=None,
                        diag_first: bool = True):
    """Adjoint of a lane + sublane dense sweep in ONE read of the (fwd, bwd)
    planes (block_backward_dual). ``i_first`` was applied before
    ``i_second`` in the forward (None: identity on the other minor group);
    ``run``: a diagonal run folded into the sweep, before it in the forward
    when ``diag_first``; a run with variable gates also yields its Q
    reductions, from which its gates' cotangents close
    (:func:`_diag_cts_from_Q`)."""
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
    with_q = run is not None and _run_has_var(run, ftape)
    if run is not None:
        diag = dict(
            diag_inv_tables=pl._diag_table_planes(layer.run_tables(run, True), dev),
            diag_tables=pl._diag_table_planes(layer.run_tables(run), dev),
            diag_first_fwd=diag_first, diag_q=with_q)
    out = layer.kernels.block_backward_dual(
        fxr, fxi, bxr, bxi, *ops_of(lane_i), *ops_of(sub_i),
        g0_first=g0_first, **diag)
    if lane_i is not None:
        _close_block_cts(layer, lane_i, torch.complex(out[4], out[5]), var_cts)
    if sub_i is not None:
        _close_block_cts(layer, sub_i, torch.complex(out[6], out[7]), var_cts)
    if with_q:
        Q = tuple(torch.complex(out[k], out[k + 1]) for k in (8, 10, 12))
        _diag_cts_from_Q(run, layer, Q, var_cts)
    return out[0], out[1], out[2], out[3]


def _backward_ddual(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a fused [diag run + minor dense pair] in ONE kernel pass:
    the pair reverses as in _backward_dual_step and (fwd, bwd) roll through
    the run in the same pass, with the run's Q reductions when it holds
    variable gates."""
    return _backward_dual_step(fxr, fxi, bxr, bxi, item[2], item[3], layer,
                               var_cts, run=item[1],
                               diag_first=_ddual_order(item))


def _reduce_a_rows(Qx: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """Merged-high-axis reduction keeping group ``j``: (A, ...) ->
    (dim_j, ...) by summing every other high axis (trailing dims kept)."""
    dims = gr.group_dims(n)
    a_dims = dims[:-2]
    ax = len(dims) - 1 - j
    v = Qx.reshape(tuple(a_dims) + tuple(Qx.shape[1:]))
    axes = tuple(k for k in range(len(a_dims)) if k != ax)
    return v.sum(dim=axes) if axes else v


def _reduce_a_joint(Wa: torch.Tensor, ja: int, jb: int, n: int) -> torch.Tensor:
    """(A,) -> (dim_ja, dim_jb) keeping the two high axes (ja > jb)."""
    dims = gr.group_dims(n)
    a_dims = dims[:-2]
    axa, axb = len(dims) - 1 - ja, len(dims) - 1 - jb
    v = Wa.reshape(a_dims)
    axes = tuple(k for k in range(len(a_dims)) if k not in (axa, axb))
    return v.sum(dim=axes) if axes else v


def _diag_cts_from_Q(run, layer: _Layer, Q, var_cts: Dict[int, torch.Tensor]):
    """Per-gate cotangents of a diagonal run from the kernel's Q pair
    reductions ``(Qsl, Qas, Qal)`` of ``Q = bwd fwd`` taken before the run
    is rolled back. Uncomputing gate ``g`` divides fwd by ``d_g``, which
    lives on ``g``'s own axes only, so its gradient source is the reduction
    of Q onto those axes times ``d_g^-1``: a block on one group closes in
    :func:`diag_block_var_cts`, a gate across two groups through the
    transpose of its joint table (a gather, so a scatter-add)."""
    ftape = layer.ftape
    n = ftape.n
    sizes = gr.group_sizes_low_first(n)
    Qsl, Qas, Qal = Q
    for i in run:
        fi = ftape.instructions[i]
        if isinstance(fi, FBlock):
            if not fi.has_var:
                continue
            g = sizes[fi.group]
            inv_tab = layer._on_device(_block_operator(
                fi, layer.var_gates, layer.const_gates, g, inverse=True)
            ).reshape(-1).to(C64)
            if fi.group == 0:
                W = Qsl.sum(0) * inv_tab
            elif fi.group == 1:
                W = Qsl.sum(1) * inv_tab
            else:
                W = _reduce_a_rows(Qas.sum(1), fi.group, n) * inv_tab
            diag_block_var_cts(fi, layer.ops(i), W, layer.var_gates,
                               layer.const_gates, g, C64, var_cts)
        elif fi.var:
            d = _cross_gate(fi, layer.var_gates, layer.const_gates).reshape(-1)
            inv_t2, ja, jb = gr.cross_diag_table(
                _inv_diag(d, fi.unitary, _cross_ctx(fi)), fi.positions, n)
            if (ja, jb) == (1, 0):
                Wred = Qsl
            elif jb == 0:
                Wred = _reduce_a_rows(Qal, ja, n)
            elif jb == 1:
                Wred = _reduce_a_rows(Qas, ja, n)
            else:
                Wred = _reduce_a_joint(Qas.sum(1), ja, jb, n)
            var_cts[fi.queue_idx] = gr.cross_diag_table_vjp(
                Wred * layer._on_device(inv_t2).to(C64), fi.positions, n)


def _diag_run_backward(fxr, fxi, bxr, bxi, run, layer: _Layer,
                       var_cts: Dict[int, torch.Tensor]):
    """One in-place kernel pass rolling (fwd, bwd) back through a diagonal
    run (uncompute + cotangent transport); a run with variable gates also
    yields the kernel's Q reductions, from which the gates' cotangents
    close (:func:`_diag_cts_from_Q`)."""
    with_q = _run_has_var(run, layer.ftape)
    fxr, fxi, bxr, bxi, Q = pl.backward_diag_run(
        fxr, fxi, bxr, bxi, layer.run_tables(run, True), layer.run_tables(run),
        with_q=with_q, kernels=layer.kernels)
    if with_q:
        _diag_cts_from_Q(run, layer, Q, var_cts)
    return fxr, fxi, bxr, bxi


def _backward_hpair(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a merged (top, top-1) dense sweep in ONE kernel pass. With
    forward order [low, top] (they commute) the two blocks' pair grams are
    restrictions of the merged pair gram ``T0m[(x d), (y d')] = sum_b
    bwd[..] fwd_in[..]``: ``T0_top`` sees fwd with only the top block
    uncomputed (``El`` applied to fwd_in), ``T0_low`` the cotangent after
    the top transport (``Et^T`` bwd),

    ``T0_top[x, y] = sum_{a b} El[a, b] T0m[(x a), (y b)]``,
    ``T0_low[x, y] = sum_{e d} Et[e, d] T0m[(e x), (d y)]``.

    The factorized kernel (block_backward_merged_fact, the default) returns
    both restrictions itself; the expanded sweep (block_backward_high on the
    merged axis) returns ``T0m``, and they are extracted here."""
    El, Et = _hpair_ops(item, layer)
    Eli, Eti = _hpair_ops(item, layer, inverse=True)
    n = layer.ftape.n
    if config.hpair_factorized():
        fxr, fxi, bxr, bxi, T0_top, T0_low = pl.backward_merged_top_fact(
            fxr, fxi, bxr, bxi, Et, El, Eti, Eli, n, kernels=layer.kernels)
        _close_block_cts(layer, item[2], T0_top, var_cts)
        _close_block_cts(layer, item[1], T0_low, var_cts)
        return fxr, fxi, bxr, bxi
    fxr, fxi, bxr, bxi, T0m = pl.backward_merged_top(
        fxr, fxi, bxr, bxi, pl.kron_ops(Eti, Eli), pl.kron_ops(Et, El), n,
        kernels=layer.kernels)
    X, Xl = 1 << layer.group_size(item[2]), 1 << layer.group_size(item[1])
    T4 = T0m.reshape(X, Xl, X, Xl)
    _close_block_cts(layer, item[2], torch.einsum("ab,xayb->xy", El, T4), var_cts)
    _close_block_cts(layer, item[1], torch.einsum("ed,exdy->xy", Et, T4), var_cts)
    return fxr, fxi, bxr, bxi


def _backward_dense_cross(fxr, fxi, bxr, bxi, i: int, layer: _Layer,
                          var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a dense cross-group gate. A span view without lane bits:
    uncompute, transport and the gate cotangent in ONE block_backward_high
    pass (planes.backward_cross_span). Otherwise: uncompute with G^-1, the
    pair gradient on the restored planes (a variable gate:
    _plane_pair_grad), and transport with G^T, each a fused one-pass
    apply."""
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
    inv_plan = layer._const(("dcross", i, "inverse"), fi.var, lambda: (
        _cross_plan(_cross_gates(layer, i)[1], pos, n, dev)))
    fxr, fxi = _apply_dense_cross(fxr, fxi, None, pos, n, layer.kernels,
                                  alias=True, plan=inv_plan)
    if fi.var:
        var_cts[fi.queue_idx] = _plane_pair_grad(fxr, fxi, bxr, bxi, pos, n)
    tr_plan = layer._const(("dcross", i, "transpose"), fi.var, lambda: (
        _cross_plan(_cross_gates(layer, i)[0].T, pos, n, dev)))
    bxr, bxi = _apply_dense_cross(bxr, bxi, None, pos, n, layer.kernels,
                                  alias=True, plan=tr_plan)
    return fxr, fxi, bxr, bxi


def _backward_dhigh(fxr, fxi, bxr, bxi, item, layer: _Layer,
                    var_cts: Dict[int, torch.Tensor]):
    """Adjoint of a fused [diag run + dense high-group sweep] in ONE kernel
    pass: uncompute + transport + the dense block's T0 pair gram, and the
    run's Q reductions when it holds variable gates (pl.backward_dhigh)."""
    run, i = item[1], item[2]
    fi = layer.ftape.instructions[i]
    with_q = _run_has_var(run, layer.ftape)
    fxr, fxi, bxr, bxi, T0, Q = pl.backward_dhigh(
        fxr, fxi, bxr, bxi, layer.operator(i, inverse=True), layer.operator(i),
        layer.run_tables(run, True), layer.run_tables(run), fi.group,
        layer.ftape.n, diag_first=item[3], with_q=with_q, kernels=layer.kernels)
    _close_block_cts(layer, i, T0, var_cts)
    if with_q:
        _diag_cts_from_Q(run, layer, Q, var_cts)
    return fxr, fxi, bxr, bxi


# ---------------------------------------------------------------------------
# The layer loop
# ---------------------------------------------------------------------------

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


def use_plane_epilogue(epi_ftape: FusedTape, dtype) -> bool:
    """The density epilogue on the planes, by the rule of use_plane_engine."""
    return (config.plane_engine() is not False
            and plane_epilogue_eligible(epi_ftape, dtype))


def _plane_gram(xr, xi, j: int, n: int, kernels: KernelSet) -> torch.Tensor:
    """Complex group Gram in one read of the planes (the Gram kernel)."""
    return pl.gram_axis(xr, xi, j, n, kernels=kernels)


def _density_groups(fi: FDensity, n: int) -> set:
    return {gr.group_of_bit(n, p)[0] for p in fi.positions}


def _cross_density(xr, xi, positions, n: int) -> torch.Tensor:
    """Reduced density over positions spanning several groups:
    ``rho[p, q] = sum_b psi[p, b] conj(psi[q, b])`` from the real-pair
    sub-block matrices ``Sr``, ``Si`` (groups.subblocks), as the JAX package
    leaves it to XLA: both are copied once per density into one buffer
    ``S = [Sr; Si]``, and one product ``S S^T`` holds the four real
    products. It sums in two levels, matrix products over 1024-amplitude
    chunks and then a sum of the chunks, so that f32 sums of up to 2^28
    terms stay short."""
    k = len(positions)
    R = 1 << k
    S = torch.empty((2, R, xr.numel() // R), dtype=torch.float32, device=xr.device)
    for dst, plane in zip(S, (xr, xi)):
        view = gr.subblock_view(plane, positions, n)
        dst.view(view.shape).copy_(view)
    chunk = min(1024, S.shape[2])
    C = S.view(2 * R, -1, chunk).transpose(0, 1)
    G = torch.matmul(C, C.transpose(1, 2)).sum(0)
    Dr = G[:R, :R] + G[R:, R:]
    Di = G[R:, :R] - G[:R, R:]
    return torch.complex(Dr, Di)


def _density_for(grams: Dict, xr, xi, fi: FDensity, n: int,
                 kernels: KernelSet) -> torch.Tensor:
    groups = _density_groups(fi, n)
    if len(groups) != 1:
        return _cross_density(xr, xi, fi.positions, n)
    j = groups.pop()
    G = _gram_for(grams, xr, xi, j, n, kernels)
    rels = tuple(p % gr.GROUP_BITS for p in fi.positions)
    return gr.density_from_gram(G, rels, gr.group_sizes_low_first(n)[j])


def _epilogue_density_list(epi_ftape: FusedTape, xr, xi, n: int,
                           kernels: KernelSet = KERNELS):
    """Diff-density matrices of a density-only tape from cached per-group
    Grams (one kernel read per group; a sub-block contraction for a
    density across groups)."""
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
    requests sum per-group expanded operators ``(L + L^H)`` (key = group);
    cross-group requests keep their ``sym`` per positions tuple (key =
    positions), applied as a dense cross-group gate."""
    sizes = gr.group_sizes_low_first(n)
    d = 1 << len(fi.positions)
    ct_m = ct.reshape(d, d).to(C64)
    sym = ct_m + ct_m.conj().T
    groups = _density_groups(fi, n)
    if len(groups) == 1:
        j = groups.pop()
        rels = tuple(p % gr.GROUP_BITS for p in fi.positions)
        E = gr.expand_in_group(sym, rels, sizes[j])
        pending[j] = E if j not in pending else pending[j] + E
    else:
        key = tuple(fi.positions)
        pending[key] = sym if key not in pending else pending[key] + sym


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
                kernels: KernelSet = KERNELS, bxr=None, bxi=None):
    """The density seeds ``sum_j M_j conj(psi)`` as cotangent planes,
    computed as ``conj(sum_j conj(M_j) psi)``: one apply per group that
    READS the forward planes (``alias=False``) and accumulates into one
    set of cotangent planes (``acc``: ``(bxr, bxi)`` when given). Returns
    ``(bxr, bxi)`` as given without seeds. When the top group is tiny, the top two groups' seeds (a sum of
    per-group operators) combine into ONE merged-axis operator
    ``kron(M_top, I) + kron(I, M_low)`` and one pass, first. A seed across
    groups (key = positions) applies ``conj(M)`` as a dense cross-group
    gate in the same seed form (_apply_dense_cross: the multi-term kernels,
    a span view or per-term sweeps); one over more than two groups without
    a span view as ``conj(_apply_xcross(conj(M)))`` on a copy of the
    forward planes, added into the accumulator."""
    pending = dict(pending)
    njg = len(gr.group_dims(n))
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
        acc = None if bxr is None else (bxr, bxi)
        bxr, bxi = pl.apply_merged_top(fxr, fxi, Mm.conj(), n, alias=False,
                                       conj=True, acc=acc, kernels=kernels)
    for key, M in pending.items():
        acc = None if bxr is None else (bxr, bxi)
        if isinstance(key, tuple):
            groups = {gr.group_of_bit(n, p)[0] for p in key}
            if len(groups) <= 2 or pl.cross_span_eligible(key, n):
                bxr, bxi = _apply_dense_cross(fxr, fxi, M.conj(), key, n,
                                              kernels, conj=True, acc0=acc)
                continue
            yr, yi = _apply_xcross(fxr.clone(), fxi.clone(), M.conj(), key, n,
                                   kernels)
            if acc is None:
                bxr, bxi = yr, -yi
            else:
                bxr, bxi = bxr + yr, bxi - yi
            continue
        bxr, bxi = pl.apply_block(fxr, fxi, M.conj(), key, n, alias=False,
                                  conj=True, acc=acc, kernels=kernels)
    return bxr, bxi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _tape_all_const(ftape: FusedTape) -> bool:
    for fi in ftape.instructions:
        if isinstance(fi, FBlock) and fi.has_var:
            return False
        if isinstance(fi, FCross) and fi.var:
            return False
        if isinstance(fi, FDensity):
            return False
    return True


def _ct_to_planes(ct: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A state cotangent (the JAX package's convention) -> cotangent planes.
    f32 storage only, the one ported: the f16 storage's prescale has no
    counterpart yet."""
    return pl.to_planes(ct.to(C64), n)


def _state_grad(bxr, bxi, n: int, ref_dtype, ref_shape) -> torch.Tensor:
    """Cotangent planes -> the torch gradient of an initial state of
    ``ref_dtype`` and ``ref_shape`` (the conjugate of the cotangent)."""
    from dqc_tpu_torch.circuit.autograd import match_grad

    ref = torch.empty(ref_shape, dtype=ref_dtype, device="meta")
    return match_grad(pl.from_planes(bxr, bxi, n), ref)


def _take_planes(ctx, what: str):
    """The planes a forward kept for its backward, which consumes them (the
    O(1)-memory adjoint rolls them back in place)."""
    if ctx.planes is None:
        raise RuntimeError(
            f"{what}: the final planes were consumed by an earlier backward "
            "(the O(1)-memory adjoint rolls them back in place); run the "
            "forward again for another gradient")
    planes, ctx.planes = ctx.planes, None
    return planes


class _PlaneScannedLayers(torch.autograd.Function):
    """The final flat complex64 state after L layers of ``ftape`` run on the
    planes from ``initial_state``, differentiable in the initial state and
    the stacked var gates. The forward keeps the final planes, which the
    backward consumes; density gradients, the state gradient and the gate
    cotangents cross the boundary conjugated (torch's gradient of a complex
    tensor is the conjugate of the JAX package's cotangent)."""

    @staticmethod
    def forward(ctx, ftape, const_gates, kernels, initial_state,
                *stacked_var_gates):
        n = ftape.n
        xr, xi = pl.to_planes(initial_state.to(C64), n)
        xr, xi = _scan_layers_forward(xr, xi, ftape, plane_program(ftape),
                                      stacked_var_gates, const_gates,
                                      kernels=kernels)
        ctx.statics = (ftape, const_gates, kernels, initial_state.dtype,
                       tuple(initial_state.shape))
        ctx.planes = (xr, xi) if any(ctx.needs_input_grad) else None
        ctx.save_for_backward(*stacked_var_gates)
        return pl.from_planes(xr, xi, n)

    @staticmethod
    def backward(ctx, grad_state):
        ftape, const_gates, kernels, state_dtype, state_shape = ctx.statics
        fxr, fxi = _take_planes(ctx, "plane_scanned_layers")
        n = ftape.n
        bxr, bxi = _ct_to_planes(grad_state.conj(), n)
        (_, _, bxr, bxi), stacked_cts = _scan_layers_backward(
            fxr, fxi, bxr, bxi, ftape, plane_program(ftape), ctx.saved_tensors,
            const_gates, kernels=kernels)
        state_grad = None
        if ctx.needs_input_grad[3]:
            state_grad = _state_grad(bxr, bxi, n, state_dtype, state_shape)
        return (None, None, None, state_grad) + tuple(ct.conj().resolve_conj()
                                                      for ct in stacked_cts)


def plane_scanned_layers(ftape: FusedTape, initial_state: torch.Tensor,
                         stacked_var_gates, const_gates, *,
                         kernels: KernelSet = KERNELS) -> torch.Tensor:
    """L layers of ``ftape`` on the planes from an arbitrary complex64 state
    (flat), returning the final flat state: the contract of
    scan.scanned_layers."""
    return _PlaneScannedLayers.apply(ftape, tuple(const_gates), kernels,
                                     initial_state, *stacked_var_gates)


class _PlaneDensityEpilogue(torch.autograd.Function):
    """The diff densities of a density-only tape on a flat complex64 state,
    from the planes (Gram kernels), differentiable in the state: the
    backward seeds ``(L + L^H) conj(psi)`` with one plane apply per group."""

    @staticmethod
    def forward(ctx, epi_ftape, kernels, state):
        n = epi_ftape.n
        xr, xi = pl.to_planes(state.to(C64), n)
        ctx.statics = (epi_ftape, kernels, state.dtype, tuple(state.shape))
        ctx.planes = (xr, xi) if ctx.needs_input_grad[2] else None
        return _epilogue_density_list(epi_ftape, xr, xi, n, kernels)

    @staticmethod
    def backward(ctx, *density_grads):
        epi_ftape, kernels, state_dtype, state_shape = ctx.statics
        xr, xi = _take_planes(ctx, "plane_density_epilogue")
        n = epi_ftape.n
        pending = _collect_seed_pending(
            epi_ftape, tuple(g.conj() for g in density_grads), n)
        bxr, bxi = _seed_apply(xr, xi, pending, n, kernels)
        if bxr is None:
            return None, None, torch.zeros(state_shape, dtype=state_dtype,
                                           device=xr.device)
        return None, None, _state_grad(bxr, bxi, n, state_dtype, state_shape)


def plane_density_epilogue(epi_ftape: FusedTape, state: torch.Tensor, *,
                           kernels: KernelSet = KERNELS):
    """The plane counterpart of ``fused_tape_forward(epi_ftape, state, (),
    ())`` for a density-only tape."""
    return _PlaneDensityEpilogue.apply(epi_ftape, kernels, state)


def epilogue_densities(epi_ftape: FusedTape, state: torch.Tensor, *,
                       kernels: KernelSet = KERNELS):
    """The epilogue models run on a final state: on the planes when
    use_plane_epilogue holds, else the fused engine."""
    from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward

    if use_plane_epilogue(epi_ftape, state.dtype):
        return plane_density_epilogue(epi_ftape, state, kernels=kernels)
    return fused_tape_forward(epi_ftape, state, (), ())


class _ScanDensities(torch.autograd.Function):
    """The densities of ``epi_ftape`` after L layers of ``ftape`` on the
    planes, from ``initial_state`` (a flat complex64 state, differentiable)
    or, when it is None, from |0..0> built as planes and the const prologue
    ``pro`` (``(pro_ftape, const gates)`` or None) run on them: no 2^n
    complex buffer at all. Differentiable in the stacked var gates.

    The forward keeps only the final planes (and the gate values); the
    backward consumes them in place, so a second backward through the same
    graph raises. Density gradients are conjugated on the way in, the gate
    cotangents and the state's on the way out. From |0..0> the reverse
    layer loop stops at the prologue: it is const-only, and the initial
    state needs no cotangent."""

    @staticmethod
    def forward(ctx, pro, ftape, epi_ftape, const_gates, device, kernels,
                initial_state, *stacked_var_gates):
        n = ftape.n
        if initial_state is None:
            xr, xi = pl.standard_planes(n, device)
            if pro is not None:
                pro_ftape, pro_const_gates = pro
                xr, xi = _apply_forward(xr, xi, plane_program(pro_ftape), _Layer(
                    pro_ftape, (), pro_const_gates, xr.device, kernels, {}))
            ctx.state_ref = None
        else:
            xr, xi = pl.to_planes(initial_state.to(C64), n)
            ctx.state_ref = (initial_state.dtype, tuple(initial_state.shape))
        xr, xi = _scan_layers_forward(xr, xi, ftape, plane_program(ftape),
                                      stacked_var_gates, const_gates,
                                      kernels=kernels)
        densities = _epilogue_density_list(epi_ftape, xr, xi, n, kernels)
        ctx.statics = (ftape, epi_ftape, const_gates, kernels)
        ctx.planes = (xr, xi) if any(ctx.needs_input_grad) else None
        ctx.save_for_backward(*stacked_var_gates)
        return densities

    @staticmethod
    def backward(ctx, *density_grads):
        ftape, epi_ftape, const_gates, kernels = ctx.statics
        fxr, fxi = _take_planes(ctx, "plane_scan_densities")
        stacked = ctx.saved_tensors
        n = ftape.n
        want_state = ctx.state_ref is not None and ctx.needs_input_grad[6]
        pending = _collect_seed_pending(
            epi_ftape, tuple(g.conj() for g in density_grads), n)
        if not pending:
            state_grad = (torch.zeros(ctx.state_ref[1], dtype=ctx.state_ref[0],
                                      device=fxr.device) if want_state else None)
            return ((None,) * 6 + (state_grad,)
                    + tuple(torch.zeros_like(g) for g in stacked))
        bxr, bxi = _seed_apply(fxr, fxi, pending, n, kernels)
        (_, _, bxr, bxi), stacked_cts = _scan_layers_backward(
            fxr, fxi, bxr, bxi, ftape, plane_program(ftape), stacked,
            const_gates, kernels=kernels)
        state_grad = (_state_grad(bxr, bxi, n, *ctx.state_ref) if want_state
                      else None)
        return ((None,) * 6 + (state_grad,)
                + tuple(ct.conj().resolve_conj() for ct in stacked_cts))


def plane_scan_densities(ftape: FusedTape, epi_ftape: FusedTape,
                         initial_state: torch.Tensor, stacked_var_gates,
                         const_gates, *, kernels: KernelSet = KERNELS):
    """Diff densities of ``epi_ftape`` after L layers of ``ftape`` from an
    arbitrary flat complex64 state, plane-resident from the state to the
    densities and back: ``plane_density_epilogue(epi_ftape,
    plane_scanned_layers(...))`` without the complex state between them.
    Differentiable in the initial state and the stacked gates."""
    return _ScanDensities.apply(None, ftape, epi_ftape, tuple(const_gates),
                                initial_state.device, kernels, initial_state,
                                *stacked_var_gates)


def plane_std_scan_densities(pro_ftape: Optional[FusedTape], ftape: FusedTape,
                             epi_ftape: FusedTape, pro_const_gates,
                             stacked_var_gates, const_gates, *, device=None,
                             kernels: KernelSet = KERNELS):
    """Diff densities of ``epi_ftape`` after ``pro_ftape`` (const-only, may
    be None) then L layers of ``ftape``, starting from |0..0> — fully
    plane-resident, no 2^n complex buffer — and differentiable in
    ``stacked_var_gates`` with torch autograd."""
    pro = None if pro_ftape is None else (pro_ftape, tuple(pro_const_gates))
    return _ScanDensities.apply(pro, ftape, epi_ftape, tuple(const_gates),
                                device, kernels, None, *stacked_var_gates)


def scan_with_epilogue(ftape: FusedTape, epi_ftape: FusedTape,
                       initial_state: torch.Tensor, stacked_var_gates,
                       const_gates, *, kernels: KernelSet = KERNELS):
    """The densities of ``epi_ftape`` after L layers of ``ftape`` from
    ``initial_state``: the fused plane-resident op when both tapes are plane
    eligible and use_plane_engine holds, else scan.scanned_layers composed
    with epilogue_densities (each on the planes where it may be)."""
    from dqc_tpu_torch.circuit.scan import scanned_layers

    dtype = initial_state.dtype
    if (use_plane_engine(ftape, dtype)
            and plane_epilogue_eligible(epi_ftape, dtype)):
        return plane_scan_densities(ftape, epi_ftape, initial_state,
                                    stacked_var_gates, const_gates,
                                    kernels=kernels)
    state = scanned_layers(ftape, initial_state, stacked_var_gates,
                           const_gates, kernels=kernels)
    return epilogue_densities(epi_ftape, state, kernels=kernels)


def std_scan_with_epilogue(pro_ftape: Optional[FusedTape], ftape: FusedTape,
                           epi_ftape: FusedTape, pro_const_gates,
                           stacked_var_gates, const_gates, *,
                           dtype=C64, device=None,
                           kernels: KernelSet = KERNELS):
    """Models whose circuit starts from |0..0>: the fully plane-resident op
    when every stage is eligible and use_plane_engine holds, else the
    composed fallback: |0..0> as a complex state, the const prologue by
    ``fused_run``, then scan_with_epilogue (n < 14, complex128, or
    ``config.set_plane_engine(False)``)."""
    from dqc_tpu_torch.circuit.fused_autograd import fused_run
    from dqc_tpu_torch.ops.statevector import standard_state

    pro_ok = pro_ftape is None or (plane_tape_eligible(pro_ftape, dtype)
                                   and _tape_all_const(pro_ftape))
    if (pro_ok and use_plane_engine(ftape, dtype)
            and plane_epilogue_eligible(epi_ftape, dtype)):
        return plane_std_scan_densities(pro_ftape, ftape, epi_ftape,
                                        pro_const_gates, stacked_var_gates,
                                        const_gates, device=device,
                                        kernels=kernels)
    state = standard_state(ftape.n, dtype, device)
    if pro_ftape is not None:
        _, state = fused_run(pro_ftape, state, (), tuple(pro_const_gates))
    return scan_with_epilogue(ftape, epi_ftape, state, stacked_var_gates,
                              const_gates, kernels=kernels)


# ---------------------------------------------------------------------------
# The generic plane tape: a whole fused tape (gates and density requests
# interleaved) on the planes, the engine of AutoGradCircuit.build's
# autodiff_run for any circuit the plane layout holds
# ---------------------------------------------------------------------------

def plane_full_tape_eligible(ftape: FusedTape, dtype) -> bool:
    """Every instruction kind runs on the planes; only the layout's
    prerequisites remain (n >= 14, complex64)."""
    return pl.plane_eligible(ftape.n, dtype)


def use_plane_tape(ftape: FusedTape, dtype, device) -> bool:
    """The plane tape for ``autodiff_run``: ``config.plane_engine()`` True
    (on any device, the CPU through the plain versions), or "auto" with
    the state on a CUDA device — the card's counterpart of the JAX
    package's TPU backend test."""
    mode = config.plane_engine()
    if mode is False or not plane_full_tape_eligible(ftape, dtype):
        return False
    if mode is True:
        return True
    return torch.device(device).type == "cuda"


def _trim_program(program, stop_after: Optional[int]):
    """Restrict a program to instructions with index <= stop_after. A diag
    run straddling the cut keeps only its early members (diagonals commute,
    so a subset composes exactly); a dense pair loses a late partner."""
    if stop_after is None:
        return program
    out = []
    for item in program:
        if item[0] == "diag":
            keep = tuple(i for i in item[1] if i <= stop_after)
            if keep:
                out.append(("diag", keep))
        elif item[0] in ("dens", "dcross", "mdiag", "xcross"):
            if item[1] <= stop_after:
                out.append(item)
        elif item[0] == "ddual":
            keep_run = tuple(x for x in item[1] if x <= stop_after)
            keep_dense = [x for x in (item[2], item[3])
                          if x is not None and x <= stop_after]
            whole = (keep_run == tuple(item[1])
                     and len(keep_dense) == (2 if item[3] is not None else 1))
            if whole:
                out.append(item)
            else:
                parts = []
                if keep_run:
                    parts.append(("diag", keep_run))
                if keep_dense:
                    dense = ("dense", keep_dense[0],
                             keep_dense[1] if len(keep_dense) > 1 else None)
                    parts = (parts + [dense] if _ddual_order(item)
                             else [dense] + parts)
                out.extend(parts)
        elif item[0] == "dhigh":
            keep_run = tuple(x for x in item[1] if x <= stop_after)
            keep_dense = item[2] <= stop_after
            if keep_run == tuple(item[1]) and keep_dense:
                out.append(item)
            else:
                parts = []
                if keep_run:
                    parts.append(("diag", keep_run))
                if keep_dense:
                    dense = ("dense", item[2], None)
                    parts = [dense] + parts if not item[3] else parts + [dense]
                out.extend(parts)
        elif item[0] == "hpair":
            keep = [x for x in (item[1], item[2]) if x <= stop_after]
            if len(keep) == 2:
                out.append(item)
            elif keep:
                out.append(("dense", keep[0], None))
        else:
            i, j = item[1], item[2]
            if i > stop_after:
                continue
            out.append(("dense", i, j if (j is not None and j <= stop_after) else None))
    return tuple(out)


def _plane_run_diff(ftape: FusedTape, state: torch.Tensor, layer: _Layer, *,
                    stop_after: Optional[int] = None):
    """Forward of a whole tape on planes, collecting the diff densities;
    returns ``(densities, (xr, xi))`` with the planes at the stop point."""
    n = ftape.n
    program = _trim_program(plane_program(ftape), stop_after)
    xr, xi = pl.to_planes(state.to(C64), n)
    densities = []
    grams: Dict[int, torch.Tensor] = {}
    for item in program:
        if item[0] == "dens":
            fi = ftape.instructions[item[1]]
            if fi.diff:
                densities.append(_density_for(grams, xr, xi, fi, n,
                                              layer.kernels))
            continue
        grams.clear()
        xr, xi = _apply_item(xr, xi, item, layer)
    return tuple(densities), (xr, xi)


def _uncompute_only(fxr, fxi, i: int, layer: _Layer):
    """Roll the forward planes back through one instruction without a
    cotangent (the zero-gradient trailing gates)."""
    fi = layer.ftape.instructions[i]
    n = layer.ftape.n
    if isinstance(fi, FCross):
        groups = {gr.group_of_bit(n, p)[0] for p in fi.positions}
        if not fi.diag:
            minv = _cross_gates(layer, i)[1]
            if len(groups) > 2:
                return _apply_xcross(fxr, fxi, minv, fi.positions, n,
                                     layer.kernels)
            return _apply_dense_cross(fxr, fxi, minv, fi.positions, n,
                                      layer.kernels, alias=True)
        d = _cross_gate(fi, layer.var_gates, layer.const_gates).reshape(-1)
        dinv = _inv_diag(d, fi.unitary, _cross_ctx(fi))
        if len(groups) > 2:
            return pl.apply_multi_diag(fxr, fxi, dinv, fi.positions, n)
        inv_t2, ja, jb = gr.cross_diag_table(dinv, fi.positions, n)
        return pl.apply_cross_diag(fxr, fxi, inv_t2, ja, jb, n)
    if fi.all_diag:
        return pl.apply_diag_axis(fxr, fxi, layer.operator(i, inverse=True),
                                  fi.group, n)
    return pl.apply_block(fxr, fxi, layer.operator(i, inverse=True), fi.group,
                          n, kernels=layer.kernels)


def _uncompute_program(fxr, fxi, program, layer: _Layer):
    """Roll the forward planes back through a program without a cotangent
    (the zero-gradient region after the last seed)."""
    for item in reversed(program):
        if item[0] == "diag":
            fxr, fxi = pl.apply_diag_run(fxr, fxi, layer.run_tables(item[1], True),
                                         kernels=layer.kernels)
        elif item[0] == "ddual":
            fxr, fxi = _apply_ddual(fxr, fxi, item, layer, inverse=True)
        elif item[0] == "dhigh":
            fxr, fxi = _apply_dhigh_item(fxr, fxi, item, layer, inverse=True)
        else:
            fxr, fxi = _uncompute_only(fxr, fxi, item[1], layer)
            if len(item) > 2 and item[2] is not None:
                fxr, fxi = _uncompute_only(fxr, fxi, item[2], layer)
    return fxr, fxi


class _PlaneTapeForward(torch.autograd.Function):
    """The diff densities of a fused tape run on the planes from
    ``initial_state``, differentiable in the initial state and the var
    gates. The forward keeps only the planes at the last differentiated
    density (or the initial state's); the backward consumes them in place,
    so a second backward through the same graph raises. Density gradients
    are conjugated on the way in and the cotangents on the way out (torch's
    gradient of a complex tensor is the conjugate of the JAX package's
    cotangent)."""

    @staticmethod
    def forward(ctx, ftape, const_gates, kernels, initial_state, *var_gates):
        last = ftape.last_diff_density_index()
        layer = _Layer(ftape, var_gates, const_gates, initial_state.device,
                       kernels, {})
        densities, (xr, xi) = _plane_run_diff(
            ftape, initial_state, layer, stop_after=last if last >= 0 else -1)
        if last < 0:
            xr, xi = pl.to_planes(initial_state.to(C64), ftape.n)
        ctx.statics = (ftape, const_gates, kernels, initial_state.dtype,
                       tuple(initial_state.shape))
        ctx.planes = (xr, xi) if any(ctx.needs_input_grad) else None
        ctx.save_for_backward(*var_gates)
        return densities

    @staticmethod
    def backward(ctx, *density_grads):
        from dqc_tpu_torch.circuit.autograd import match_grad

        ftape, const_gates, kernels, state_dtype, state_shape = ctx.statics
        if ctx.planes is None:
            raise RuntimeError(
                "plane_tape_forward: the planes were consumed by an earlier "
                "backward (the O(1)-memory adjoint rolls them back in place); "
                "run the forward again for another gradient")
        (fxr, fxi), ctx.planes = ctx.planes, None
        var_gates = ctx.saved_tensors
        n = ftape.n
        last = ftape.last_diff_density_index()
        diff_indices = [i for i, fi in enumerate(ftape.instructions)
                        if isinstance(fi, FDensity) and fi.diff]
        ct_of = dict(zip(diff_indices, (g.conj() for g in density_grads)))
        layer = _Layer(ftape, var_gates, const_gates, fxr.device, kernels, {})
        bxr = bxi = None
        var_cts: Dict[int, torch.Tensor] = {}
        pending: Dict = {}
        program = _trim_program(plane_program(ftape), last if last >= 0 else -1)
        for item in reversed(program):
            if item[0] == "dens":
                fi = ftape.instructions[item[1]]
                if fi.diff:
                    _add_seed(pending, fi, ct_of[item[1]], n)
                continue
            bxr, bxi = _seed_apply(fxr, fxi, pending, n, kernels, bxr, bxi)
            pending.clear()
            if bxr is None:
                # before any seed: uncompute only (zero-gradient gates)
                fxr, fxi = _uncompute_program(fxr, fxi, (item,), layer)
                continue
            fxr, fxi, bxr, bxi = _backward_program(fxr, fxi, bxr, bxi, (item,),
                                                   layer, var_cts)
        bxr, bxi = _seed_apply(fxr, fxi, pending, n, kernels, bxr, bxi)
        state_grad = None
        if ctx.needs_input_grad[3]:
            ref = torch.empty(state_shape, dtype=state_dtype, device="meta")
            state_grad = (torch.zeros(state_shape, dtype=state_dtype,
                                      device=fxr.device) if bxr is None
                          else match_grad(pl.from_planes(bxr, bxi, n), ref))
        grads = tuple(torch.zeros_like(ref) if q not in var_cts
                      else match_grad(var_cts[q], ref)
                      for q, ref in enumerate(var_gates))
        return (None, None, None, state_grad) + grads


def plane_tape_forward(ftape: FusedTape, initial_state: torch.Tensor, var_gates,
                       const_gates, *, kernels: KernelSet = KERNELS):
    """Differentiable plane-engine execution of a whole fused tape from
    ``initial_state`` (a flat complex64 tensor), returning the diff-density
    matrices: the plane counterpart of fused_autograd.fused_tape_forward,
    with the same contract. ``kernels=ops.kernels.PLAIN`` runs the plain
    versions."""
    return _PlaneTapeForward.apply(ftape, tuple(const_gates), kernels,
                                   initial_state, *var_gates)
