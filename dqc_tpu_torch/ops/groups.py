"""Qubit groups: host helpers of the grouped-axis layout.

Counterpart of the host-side helpers of ``dqc_tpu/ops/groups.py``. The
``2^n`` amplitudes are viewed as ``(2^g_{G-1}, ..., 2^g_1, 2^g_0)`` with
qubit groups of at most 7 bits (group 0 = qubits 0..6 is the minor axis); a
k-qubit gate inside group ``j`` is expanded to a full ``2^g x 2^g`` group
operator, and a diagonal spanning two groups to a joint table.

Gates come in two kinds, as in the JAX package: constant gates are host
numpy arrays (expanded once, memoised by value), variable gates are torch
tensors on the run's device (expanded there with torch ops).
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dqc_tpu_torch.ops.kernels.gram import pair_sum

GROUP_BITS = 7


@lru_cache(maxsize=None)
def group_sizes_low_first(n: int) -> Tuple[int, ...]:
    """Bits per group indexed by group number (group 0 = lowest bits)."""
    sizes = []
    b = 0
    while b < n:
        sizes.append(min(GROUP_BITS, n - b))
        b += GROUP_BITS
    return tuple(sizes)


@lru_cache(maxsize=None)
def group_dims(n: int) -> Tuple[int, ...]:
    """Array shape, most-significant group first."""
    return tuple(1 << g for g in reversed(group_sizes_low_first(n)))


def group_of_bit(n: int, bit: int) -> Tuple[int, int]:
    """(group index, bit position within the group) of a qubit."""
    if not (0 <= bit < n):
        raise ValueError(f"bit {bit} out of range for {n} qubits")
    return bit // GROUP_BITS, bit % GROUP_BITS


# ---------------------------------------------------------------------------
# Host constants: value-memoised expansion of constant gates. Entries are up
# to 2^g x 2^g complex (256 KB at g=7); 512 entries cap the cache at ~128 MB.
# ---------------------------------------------------------------------------

_EXPAND_CACHE: "OrderedDict" = OrderedDict()
_EXPAND_CACHE_MAX = 512


def concrete_or_none(x):
    """Host numpy view of ``x`` when it is a constant (numpy array, list or
    number); None for a torch tensor, which is a variable on its device."""
    if isinstance(x, torch.Tensor):
        return None
    return np.asarray(x)


def _cached(key, build):
    hit = _EXPAND_CACHE.get(key)
    if hit is None:
        hit = build()
        if len(_EXPAND_CACHE) >= _EXPAND_CACHE_MAX:
            _EXPAND_CACHE.popitem(last=False)
        _EXPAND_CACHE[key] = hit
    else:
        _EXPAND_CACHE.move_to_end(key)
    return hit


def _expand_perm(rel_positions: Tuple[int, ...], g: int) -> List[int]:
    others = [b for b in range(g - 1, -1, -1) if b not in rel_positions]
    current = list(rel_positions) + others  # bit label of each out axis
    perm_out = [current.index(b) for b in range(g - 1, -1, -1)]
    return perm_out + [g + p for p in perm_out]


def _expand_in_group_np(gate, rel_positions, g: int):
    k = len(rel_positions)
    gate = gate.reshape(1 << k, 1 << k)
    eye = np.eye(1 << (g - k), dtype=gate.dtype)
    D = np.einsum("ab,cd->acbd", gate, eye).reshape((2,) * (2 * g))
    return D.transpose(_expand_perm(rel_positions, g)).reshape(1 << g, 1 << g)


def _expand_in_group_torch(gate: torch.Tensor, rel_positions, g: int):
    k = len(rel_positions)
    gate = gate.reshape(1 << k, 1 << k)
    eye = torch.eye(1 << (g - k), dtype=gate.dtype, device=gate.device)
    D = torch.einsum("ab,cd->acbd", gate, eye).reshape((2,) * (2 * g))
    return D.permute(_expand_perm(rel_positions, g)).reshape(1 << g, 1 << g)


def _expand_diag_shape(rel_positions, g: int):
    desc = sorted(rel_positions, reverse=True)
    order = [rel_positions.index(b) for b in desc]
    shape = tuple(2 if b in rel_positions else 1 for b in range(g - 1, -1, -1))
    return order, shape


def expand_in_group(gate, rel_positions: Sequence[int], g: int):
    """k-qubit gate -> full ``2^g x 2^g`` group operator.

    ``rel_positions``: target bits inside the group, msb-first (the gate's
    index convention, reference primitives.cu:596).
    """
    rel_positions = tuple(int(p) for p in rel_positions)
    c = concrete_or_none(gate)
    if c is not None:
        key = ("E", c.tobytes(), c.dtype.str, rel_positions, g)
        return _cached(key, lambda: np.ascontiguousarray(
            _expand_in_group_np(c, rel_positions, g)))
    return _expand_in_group_torch(gate, rel_positions, g)


def expand_diag_in_group(diag, rel_positions: Sequence[int], g: int):
    """k-bit diagonal -> full ``2^g`` diagonal table of its group."""
    rel_positions = tuple(int(p) for p in rel_positions)
    k = len(rel_positions)
    order, shape = _expand_diag_shape(rel_positions, g)
    c = concrete_or_none(diag)
    if c is not None:
        key = ("D", c.tobytes(), c.dtype.str, rel_positions, g)
        return _cached(key, lambda: np.ascontiguousarray(np.broadcast_to(
            c.reshape((2,) * k).transpose(order).reshape(shape),
            (2,) * g).reshape(1 << g)))
    d = diag.reshape((2,) * k).permute(order).reshape(shape)
    return d.expand((2,) * g).reshape(1 << g)


def cross_diag_table(diag, positions: Sequence[int], n: int):
    """Joint full-group table of a diagonal spanning exactly two groups:
    ``(table2, ja, jb)`` with ``table2[A, B]`` the diagonal entry for
    full-group indices A (group ja, the higher group) and B (group jb)."""
    positions = tuple(int(p) for p in positions)
    diag = diag.reshape(-1)
    sizes = group_sizes_low_first(n)
    by_group: Dict[int, List[int]] = {}
    for i, p in enumerate(positions):
        by_group.setdefault(group_of_bit(n, p)[0], []).append(i)
    if len(by_group) != 2:
        raise ValueError(f"positions {positions} do not span two groups")
    (ja, ia), (jb, ib) = sorted(by_group.items(), key=lambda kv: -kv[0])
    # joint table over a virtual register [bits of ja cluster, bits of jb cluster]
    k = len(positions)
    order = ia + ib
    ka, kb = len(ia), len(ib)
    rels_a = tuple(positions[i] % GROUP_BITS for i in ia)
    rels_b = tuple(positions[i] % GROUP_BITS for i in ib)
    ea = _selector_matrix(rels_a, sizes[ja])  # (2^ga,) packed target bits
    eb = _selector_matrix(rels_b, sizes[jb])
    if isinstance(diag, torch.Tensor):
        d2 = diag.reshape((2,) * k).permute(order).reshape(1 << ka, 1 << kb)
        ea_t = selector_tensor(rels_a, sizes[ja], diag.device)
        eb_t = selector_tensor(rels_b, sizes[jb], diag.device)
        return d2[ea_t[:, None], eb_t[None, :]], ja, jb
    d2 = np.asarray(diag).reshape((2,) * k).transpose(order).reshape(
        1 << ka, 1 << kb)
    return d2[ea[:, None], eb[None, :]], ja, jb


def schmidt_terms(gate4):
    """``G = sum_i A_i (x) B_i``, A on the msb qubit (pos2): stacked
    ``(4, 2, 2)`` factors from the SVD of the 4 x 4 gate reshuffled to
    ``[(q2 p2), (q1 p1)]``. Host numpy (memoised) for a constant gate, torch
    on the gate's device for a variable one; the adjoint never
    differentiates through it (gate cotangents come from pair grams)."""
    c = concrete_or_none(gate4)
    if c is not None:
        key = ("S", c.tobytes(), c.dtype.str)

        def build():
            M = np.ascontiguousarray(
                c.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3)).reshape(4, 4)
            u, s, vh = np.linalg.svd(M)
            sq = np.sqrt(s).astype(M.dtype)
            return (np.ascontiguousarray((u * sq[None, :]).T.reshape(4, 2, 2)),
                    np.ascontiguousarray((sq[:, None] * vh).reshape(4, 2, 2)))

        return _cached(key, build)
    M = gate4.reshape(2, 2, 2, 2).permute(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = torch.linalg.svd(M)
    sq = torch.sqrt(s).to(M.dtype)
    return ((u * sq[None, :]).T.reshape(4, 2, 2),
            (sq[:, None] * vh).reshape(4, 2, 2))


@lru_cache(maxsize=None)
def _selector_matrix(rel_positions: Tuple[int, ...], g: int) -> np.ndarray:
    """For each full-group index, the packed value of the target bits
    (msb-first) — a static numpy lookup used to build joint diag tables."""
    idx = np.arange(1 << g)
    out = np.zeros(1 << g, dtype=np.int64)
    k = len(rel_positions)
    for i, r in enumerate(rel_positions):
        out |= ((idx >> r) & 1) << (k - 1 - i)
    return out


@lru_cache(maxsize=None)
def selector_tensor(rel_positions: Tuple[int, ...], g: int,
                    device: torch.device) -> torch.Tensor:
    """:func:`_selector_matrix` as a long tensor on ``device``, made once:
    the gathers of a variable gate's tables run every layer, and a host
    array copied to the card per use would stall the host behind the
    queued kernels."""
    return torch.as_tensor(_selector_matrix(rel_positions, g), dtype=torch.long,
                           device=device)


@lru_cache(maxsize=None)
def _bit_permutation_index(new_order_msb: Tuple[int, ...], g: int) -> np.ndarray:
    """``old[new]``: the old axis index that new index ``new`` reads, where
    the new index reads the old bits in ``new_order_msb`` order (the row
    lookup of the JAX package's permutation matrix ``P[new, old] = 1``)."""
    size = 1 << g
    old = np.arange(size)
    new = np.zeros(size, dtype=np.int64)
    for i, b in enumerate(new_order_msb):
        new |= ((old >> b) & 1) << (g - 1 - i)
    out = np.empty(size, dtype=np.int64)
    out[new] = old
    return out


@lru_cache(maxsize=None)
def _bit_permutation_tensor(new_order_msb: Tuple[int, ...], g: int,
                            device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_bit_permutation_index(new_order_msb, g), device=device)


def density_from_gram(G: torch.Tensor, rel_positions: Sequence[int], g: int) -> torch.Tensor:
    """k-qubit density from its group's Gram: rotate the Gram's bits so the
    targets are on top, then trace the rest. The rotation ``P G P^T`` with a
    permutation ``P`` is an exact index gather here."""
    rel_positions = tuple(int(p) for p in rel_positions)
    k = len(rel_positions)
    order = tuple(rel_positions) + tuple(
        b for b in range(g - 1, -1, -1) if b not in rel_positions
    )
    if order != tuple(range(g - 1, -1, -1)):
        idx = _bit_permutation_tensor(order, g, G.device)
        G = G[idx][:, idx]
    R = 1 << (g - k)
    return torch.einsum("arbr->ab", G.reshape(1 << k, R, 1 << k, R))


def bits_sum(ct: torch.Tensor, bit_axes: Sequence[int], nbits: int) -> torch.Tensor:
    """The transpose of a gather by target bits: ``ct`` (``2^nbits``
    entries, bit axis 0 the most significant) summed over every bit axis
    not in ``bit_axes``, leaving ``2^k`` entries indexed by the target bits
    msb-first in ``bit_axes`` order (``_selector_matrix``'s packing). A sum,
    not a scatter with atomics: the result does not depend on the order
    the card adds in."""
    others = [a for a in range(nbits) if a not in bit_axes]
    t = ct.reshape((2,) * nbits).permute(list(bit_axes) + others)
    return t.reshape(1 << len(bit_axes), -1).sum(1)


def cross_diag_table_vjp(ct_table: torch.Tensor, positions: Sequence[int],
                         n: int) -> torch.Tensor:
    """The transpose of :func:`cross_diag_table` (a gather): the flat
    ``2^k`` cotangent of the diagonal from the cotangent of its joint table,
    each table entry added to the diagonal entry it reads."""
    positions = tuple(int(p) for p in positions)
    sizes = group_sizes_low_first(n)
    by_group: Dict[int, List[int]] = {}
    for i, p in enumerate(positions):
        by_group.setdefault(group_of_bit(n, p)[0], []).append(i)
    (ja, ia), (jb, ib) = sorted(by_group.items(), key=lambda kv: -kv[0])
    ga, gb, k = sizes[ja], sizes[jb], len(positions)
    # table axes: group ja's bits, then group jb's, each msb first
    axes = ([ga - 1 - positions[i] % GROUP_BITS for i in ia]
            + [ga + gb - 1 - positions[i] % GROUP_BITS for i in ib])
    d2 = bits_sum(ct_table, axes, ga + gb)
    order = ia + ib
    inv = [order.index(i) for i in range(k)]
    return d2.reshape((2,) * k).permute(inv).reshape(-1)


# ---------------------------------------------------------------------------
# Sub-block extraction for reductions
# ---------------------------------------------------------------------------

def subblocks(t: torch.Tensor, positions: Sequence[int], n: int) -> torch.Tensor:
    """(2^k, 2^(n-k)) matrix whose row ``r`` is the sub-state with the target
    bits fixed to the bits of ``r`` (msb-first in ``positions`` order), and
    whose column reads the other bits msb-first.

    The JAX package rotates each group's bits with a permutation-matrix
    product and transposes the group clusters to the front; the same bit
    permutation here is one strided view of the flat index (the runs of
    other bits between the targets stay whole) and one copy."""
    return subblock_view(t, positions, n).reshape(1 << len(positions), -1)


def subblock_view(t: torch.Tensor, positions: Sequence[int], n: int) -> torch.Tensor:
    """The strided view behind :func:`subblocks`: the target bits' axes of
    size 2 first (in ``positions`` order), then the runs of other bits in
    order. Copying it into a contiguous buffer gives the sub-block matrix."""
    positions = tuple(int(p) for p in positions)
    if len(set(positions)) != len(positions) or not all(0 <= p < n for p in positions):
        raise ValueError(f"positions {positions} for {n} qubits")
    desc = sorted(positions, reverse=True)
    shape, target_axis, rest = [], {}, []
    top = n
    for p in desc:
        if top - 1 > p:
            rest.append(len(shape))
            shape.append(1 << (top - 1 - p))
        target_axis[p] = len(shape)
        shape.append(2)
        top = p
    if top > 0:
        rest.append(len(shape))
        shape.append(1 << top)
    return t.reshape(shape).permute([target_axis[p] for p in positions] + rest)


def subblocks_with_restore(t: torch.Tensor, positions: Sequence[int], n: int):
    """Like :func:`subblocks`, also returning ``restore(S') -> t'``, which
    writes a modified sub-block matrix back into the layout of ``t`` (the
    generic-gate path: a k-qubit gate at any positions is
    ``restore(G @ subblocks(t))``). The JAX package restores with the
    inverse permutation-matrix products; here the same strided view of a
    fresh buffer takes the copy."""
    S = subblocks(t, positions, n)
    shape = t.shape

    def restore(S2: torch.Tensor) -> torch.Tensor:
        out = torch.empty(shape, dtype=S2.dtype, device=S2.device)
        view = subblock_view(out, positions, n)
        view.copy_(S2.reshape(view.shape))
        return out

    return S, restore


# ---------------------------------------------------------------------------
# The grouped complex engine (circuit/fused_autograd.py): a complex state in
# the grouped shape group_dims(n), every group op one product or broadcast
# multiply over its axis. Constant operators (host numpy) are staged on the
# state's device per use. Reductions over the other amplitudes (Grams,
# densities, pair grams) sum in two levels (ops.kernels.gram.pair_sum):
# one f32 product over 2^22-2^28 columns drifts ~1e-3 at 29 qubits.
# ---------------------------------------------------------------------------

def to_grouped(state: torch.Tensor, n: int) -> torch.Tensor:
    return state.reshape(group_dims(n))


def from_grouped(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1)


def _on(x, t: torch.Tensor) -> torch.Tensor:
    """An operator or table (numpy or tensor) as a tensor like ``t``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=t.device, dtype=t.dtype)
    return torch.as_tensor(np.ascontiguousarray(x), device=t.device).to(t.dtype)


def _group_view(t: torch.Tensor, j: int):
    """``t`` as ``(pre, X, post)`` with group ``j`` on the middle axis."""
    ax = t.dim() - 1 - j
    pre = int(np.prod(t.shape[:ax], dtype=np.int64))
    return t.reshape(pre, t.shape[ax], -1)


def apply_group_matrix(t: torch.Tensor, E, j: int) -> torch.Tensor:
    """Contract group axis ``j`` with a full-group operator:
    ``out[.., y, ..] = sum_x E[y, x] t[.., x, ..]`` (one batched product)."""
    return torch.matmul(_on(E, t), _group_view(t, j)).reshape(t.shape)


def apply_group_diag(t: torch.Tensor, table, j: int) -> torch.Tensor:
    """A full-group diagonal table on group axis ``j``."""
    return (_group_view(t, j) * _on(table, t).reshape(1, -1, 1)).reshape(t.shape)


def apply_cross_diag(t: torch.Tensor, table2, j2: int, j1: int) -> torch.Tensor:
    """Joint diagonal over two group axes; ``table2``: (dim_j2, dim_j1)."""
    a2, a1 = t.dim() - 1 - j2, t.dim() - 1 - j1
    table2 = _on(table2, t)
    if a2 > a1:
        table2 = table2.T
        a2, a1 = a1, a2
    shape = [1] * t.dim()
    shape[a2] = t.shape[a2]
    shape[a1] = t.shape[a1]
    return t * table2.reshape(shape)


def apply_dense(t: torch.Tensor, gate, positions: Sequence[int], n: int) -> torch.Tensor:
    """Dense k-qubit gate at arbitrary positions (grouped state in and
    out): one group product in a group, the Schmidt terms of a 2-qubit gate
    across two groups, or a sub-block product for k >= 3 across groups."""
    positions = tuple(int(p) for p in positions)
    k = len(positions)
    groups = {group_of_bit(n, p)[0] for p in positions}
    sizes = group_sizes_low_first(n)
    if len(groups) == 1:
        j = groups.pop()
        rels = tuple(p % GROUP_BITS for p in positions)
        return apply_group_matrix(t, expand_in_group(_host_or(gate, t), rels,
                                                     sizes[j]), j)
    if k == 2:
        p2, p1 = positions
        j2, r2 = group_of_bit(n, p2)
        j1, r1 = group_of_bit(n, p1)
        As, Bs = schmidt_terms(_host_or(gate, t))
        out = None
        for i in range(4):
            EA = expand_in_group(As[i], (r2,), sizes[j2])
            EB = expand_in_group(Bs[i], (r1,), sizes[j1])
            term = apply_group_matrix(apply_group_matrix(t, EB, j1), EA, j2)
            out = term if out is None else out + term
        return out
    S, restore = subblocks_with_restore(t, positions, n)
    return restore(torch.matmul(_on(gate, t).reshape(1 << k, 1 << k), S))


def _host_or(x, t: torch.Tensor):
    """A constant stays host numpy in ``t``'s complex precision (so that it
    keeps value-memoisation); a tensor is cast to ``t``'s dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=t.dtype)
    np_dt = np.complex128 if t.dtype == torch.complex128 else np.complex64
    return np.asarray(x).astype(np_dt)


def apply_diag(t: torch.Tensor, diag, positions: Sequence[int], n: int) -> torch.Tensor:
    """Diagonal k-qubit gate at arbitrary positions, one broadcast multiply
    (a sub-block scale across more than two groups)."""
    positions = tuple(int(p) for p in positions)
    diag = _host_or(diag, t).reshape(-1)
    sizes = group_sizes_low_first(n)
    groups = {group_of_bit(n, p)[0] for p in positions}
    if len(groups) == 1:
        j = groups.pop()
        rels = tuple(p % GROUP_BITS for p in positions)
        return apply_group_diag(t, expand_diag_in_group(diag, rels, sizes[j]), j)
    if len(groups) == 2:
        table2, ja, jb = cross_diag_table(diag, positions, n)
        return apply_cross_diag(t, table2, ja, jb)
    S, restore = subblocks_with_restore(t, positions, n)
    return restore(S * _on(diag, t)[:, None])


def group_pair_gram(fwd_t: torch.Tensor, bwd_t: torch.Tensor, j: int) -> torch.Tensor:
    """Full-group pair contraction ``T0[x, y] = sum_b bwd[x, b] fwd[y, b]``
    over group axis ``j``."""
    return pair_sum(_group_view(bwd_t, j), _group_view(fwd_t, j))


def group_diag_gram(fwd_t: torch.Tensor, bwd_t: torch.Tensor, j: int) -> torch.Tensor:
    """Diagonal of the group pair gram: ``W[x] = sum_b bwd[x, b] fwd[x, b]``."""
    return (_group_view(bwd_t, j) * _group_view(fwd_t, j)).sum(dim=(0, 2))


def group_gram(t: torch.Tensor, j: int) -> torch.Tensor:
    """Full-group Gram ``G[x, y] = sum_b t[x, b] conj(t[y, b])``."""
    return group_pair_gram(t.conj(), t, j)


def density(t: torch.Tensor, positions: Sequence[int], n: int) -> torch.Tensor:
    """Reduced density matrix: through the group Gram for targets in one
    group, a sub-block product across groups."""
    return density_cached(t, positions, n, {})


def density_cached(t: torch.Tensor, positions: Sequence[int], n: int,
                   cache: dict) -> torch.Tensor:
    """Density with per-group Gram sharing: requests at one circuit point
    reuse one Gram per group. ``cache`` must be cleared whenever the state
    changes."""
    positions = tuple(int(p) for p in positions)
    groups = {group_of_bit(n, p)[0] for p in positions}
    if len(groups) == 1:
        j = groups.pop()
        G = cache.get(j)
        if G is None:
            G = cache[j] = group_gram(t, j)
        rels = tuple(p % GROUP_BITS for p in positions)
        return density_from_gram(G, rels, group_sizes_low_first(n)[j])
    S = subblocks(t, positions, n)
    return pair_sum(S[None], S.conj()[None])


def pair_grad(fwd_t: torch.Tensor, bwd_t: torch.Tensor, positions: Sequence[int],
              n: int) -> torch.Tensor:
    """Dense-gate cotangent ``sum_b bwd[p, b] fwd[q, b]``."""
    return pair_sum(subblocks(bwd_t, positions, n)[None],
                    subblocks(fwd_t, positions, n)[None])


def diag_pair_grad(fwd_t: torch.Tensor, bwd_t: torch.Tensor,
                   positions: Sequence[int], n: int) -> torch.Tensor:
    """Diagonal-gate cotangent ``sum_b bwd[p, b] fwd[p, b]``."""
    return (subblocks(bwd_t, positions, n) * subblocks(fwd_t, positions, n)).sum(1)
