"""Gate-fusion compiler: Tape -> FusedTape.

Counterpart of the pure-Python path of ``dqc_tpu/circuit/fusion.py``
(``_fuse_tape_py``). Consecutive gates that act within one 7-bit qubit group
compose into a single full-group operator (ops/groups.py), so one sweep
applies up to 7 qubits' worth of gates; blocks on *different* groups commute
(disjoint qubits), so a pending block is only flushed when an instruction
actually needs its group:

* a dense gate spanning several groups flushes those groups and becomes a
  cross instruction;
* a diagonal gate never forces dense work: in-group it joins the block,
  cross-group it is emitted without flushing when the affected groups hold
  only diagonals;
* a density op observes the state, so it flushes everything.

All compilation is static Python and the FusedTape is hashable. The native
C++ planner of the JAX package is not bound here (ROADMAP.md queue A).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from dqc_tpu_torch.circuit.ir import InstrKind, Tape
from dqc_tpu_torch.ops.groups import GROUP_BITS, group_of_bit


@dataclass(frozen=True)
class GateRef:
    """A gate occurrence inside a fused block."""
    var: bool
    queue_idx: int
    rel_positions: Tuple[int, ...]  # bits within the group, msb-first
    diag: bool
    unitary: bool


@dataclass(frozen=True)
class FBlock:
    group: int
    gates: Tuple[GateRef, ...]

    @property
    def all_diag(self) -> bool:
        return all(g.diag for g in self.gates)

    @property
    def has_var(self) -> bool:
        return any(g.var for g in self.gates)


@dataclass(frozen=True)
class FCross:
    """A gate spanning multiple groups."""
    positions: Tuple[int, ...]
    var: bool
    unitary: bool
    queue_idx: int
    diag: bool


@dataclass(frozen=True)
class FDensity:
    positions: Tuple[int, ...]
    diff: bool


@dataclass(frozen=True)
class FusedTape:
    n: int
    instructions: Tuple[object, ...]
    num_var_gates: int
    num_const_gates: int
    var_shapes: Tuple[Tuple[str, int], ...]  # per var gate: (kind, k)

    def last_diff_density_index(self) -> int:
        for i in range(len(self.instructions) - 1, -1, -1):
            fi = self.instructions[i]
            if isinstance(fi, FDensity) and fi.diff:
                return i
        return -1


def fuse_tape(tape: Tape) -> FusedTape:
    """Compile a tape into fused per-group blocks and cross instructions."""
    n = tape.n
    pending: Dict[int, List[GateRef]] = {}
    out: List[object] = []
    var_idx = const_idx = 0
    var_shapes: List[Tuple[str, int]] = []

    def flush(groups: Optional[List[int]] = None) -> None:
        targets = sorted(pending) if groups is None else [j for j in sorted(set(groups)) if j in pending]
        for j in targets:
            gates = pending.pop(j)
            if gates:
                out.append(FBlock(j, tuple(gates)))

    for inst in tape.instructions:
        if inst.kind is InstrKind.DENSITY:
            flush()
            out.append(FDensity(inst.positions, inst.diff))
            continue

        diag = inst.kind is InstrKind.DIAG
        if inst.is_gate:
            if inst.var:
                qidx = var_idx
                var_idx += 1
                var_shapes.append(("diag" if diag else "dense", inst.k))
            else:
                qidx = const_idx
                const_idx += 1
            groups = {group_of_bit(n, p)[0] for p in inst.positions}
            if len(groups) == 1:
                j = groups.pop()
                rels = tuple(p % GROUP_BITS for p in inst.positions)
                pending.setdefault(j, []).append(
                    GateRef(inst.var, qidx, rels, diag, inst.unitary)
                )
            else:
                affected = sorted(groups)
                if not (diag and all(
                        all(g.diag for g in pending.get(j, ())) for j in affected)):
                    # a cross-group diagonal commutes with pending blocks
                    # that hold only diagonals: emit it without flushing,
                    # so diag ladders keep extending one block per group
                    flush(affected)
                out.append(FCross(inst.positions, inst.var, inst.unitary,
                                  qidx, diag))
    flush()
    return FusedTape(
        n=n,
        instructions=tuple(out),
        num_var_gates=var_idx,
        num_const_gates=const_idx,
        var_shapes=tuple(var_shapes),
    )
