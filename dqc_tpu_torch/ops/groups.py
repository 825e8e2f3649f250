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
        ea_t = torch.as_tensor(ea, dtype=torch.long, device=diag.device)
        eb_t = torch.as_tensor(eb, dtype=torch.long, device=diag.device)
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
        idx = torch.as_tensor(_bit_permutation_index(order, g), device=G.device)
        G = G[idx][:, idx]
    R = 1 << (g - k)
    return torch.einsum("arbr->ab", G.reshape(1 << k, R, 1 << k, R))
