"""Circuit intermediate representation: a hashable instruction tape.

A copy of ``dqc_tpu/circuit/ir.py`` (stdlib only), kept in the port so that
it imports nothing of the JAX package. The analog of the reference's Rust
instruction tape
(``enum Instruction`` with 14 variants, reference src/circuit.rs:53-68).
Instead of 14 ad-hoc variants, an :class:`Instruction` is a small frozen
record of orthogonal attributes:

* ``kind``      — GATE (dense), DIAG (diagonal), or DENSITY (observable),
* ``positions`` — target qubits, most-significant first (``(pos2, pos1)``
  for 2-qubit ops; reference primitives.cu:596),
* ``var``       — gate consumed from the variable queue (gradients flow)
  vs the constant queue (reference circuit.rs:172-173),
* ``unitary``   — backward uncompute via ``G^dagger`` vs ``G^-1``
  (reference circuit.rs:280-295 vs 288-295),
* ``diff``      — DENSITY participates in the adjoint pass
  (``DiffQ1Density`` vs ``Q1Density``, circuit.rs:66-67).

The whole :class:`Tape` is hashable, so it can be a ``static_argnums`` /
``nondiff_argnums`` argument: circuit *structure* is compile-time constant
while gate *values* stay traced — mirroring (and formalizing) the reference's
const/var gate split. Unlike the reference, where mismatched gate counts
panic only at run time (circuit.rs:209-210), :meth:`Tape.validate` checks
arity and shapes before tracing.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


class InstrKind(enum.Enum):
    GATE = "gate"
    DIAG = "diag"
    DENSITY = "density"


@dataclass(frozen=True)
class Instruction:
    kind: InstrKind
    positions: Tuple[int, ...]
    var: bool = False
    unitary: bool = True
    diff: bool = False

    def __post_init__(self):
        object.__setattr__(self, "positions", tuple(int(p) for p in self.positions))
        if len(set(self.positions)) != len(self.positions):
            raise ValueError(f"duplicate positions {self.positions}")
        if self.kind is InstrKind.DENSITY and self.var:
            raise ValueError("density ops are not gates; var flag is invalid")

    @property
    def k(self) -> int:
        """Number of target qubits."""
        return len(self.positions)

    @property
    def is_gate(self) -> bool:
        return self.kind in (InstrKind.GATE, InstrKind.DIAG)

    def gate_size(self) -> int:
        """Expected flat length of this instruction's gate payload."""
        if self.kind is InstrKind.GATE:
            return (1 << self.k) ** 2
        if self.kind is InstrKind.DIAG:
            return 1 << self.k
        raise ValueError("density instructions carry no gate payload")


@dataclass(frozen=True)
class Tape:
    """An ordered, hashable circuit program over ``n`` qubits."""

    n: int
    instructions: Tuple[Instruction, ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "instructions", tuple(self.instructions))
        for inst in self.instructions:
            for p in inst.positions:
                if not (0 <= p < self.n):
                    raise ValueError(
                        f"position {p} out of range for {self.n} qubits in {inst}"
                    )

    # -- structural queries (all pure Python; free at trace time) ----------

    def gates(self, var: Optional[bool] = None) -> Tuple[Instruction, ...]:
        return tuple(
            i for i in self.instructions
            if i.is_gate and (var is None or i.var == var)
        )

    def densities(self, diff: Optional[bool] = None) -> Tuple[Instruction, ...]:
        return tuple(
            i for i in self.instructions
            if i.kind is InstrKind.DENSITY and (diff is None or i.diff == diff)
        )

    @property
    def num_var_gates(self) -> int:
        return len(self.gates(var=True))

    @property
    def num_const_gates(self) -> int:
        return len(self.gates(var=False))

    def last_diff_density_index(self) -> int:
        """Index of the last diff-density instruction, or -1.

        Var gates after this point receive identically-zero gradients
        (the reference's ``bwd_option = None`` branches, circuit.rs:327-332);
        the adjoint pass skips them statically.
        """
        for i in range(len(self.instructions) - 1, -1, -1):
            inst = self.instructions[i]
            if inst.kind is InstrKind.DENSITY and inst.diff:
                return i
        return -1

    def validate(self, var_gates: Sequence, const_gates: Sequence) -> None:
        """Arity + per-gate shape check (upfront, unlike circuit.rs:209-210)."""
        nv, nc = self.num_var_gates, self.num_const_gates
        if len(var_gates) != nv:
            raise ValueError(f"tape needs {nv} var gates, got {len(var_gates)}")
        if len(const_gates) != nc:
            raise ValueError(f"tape needs {nc} const gates, got {len(const_gates)}")
        vi = iter(var_gates)
        ci = iter(const_gates)
        for inst in self.instructions:
            if not inst.is_gate:
                continue
            g = next(vi) if inst.var else next(ci)
            want = inst.gate_size()
            # a torch tensor counts its entries with numel(); numpy with size
            got = g.numel() if hasattr(g, "numel") else getattr(g, "size", None)
            if got is not None and got != want:
                kindname = "diagonal" if inst.kind is InstrKind.DIAG else "dense"
                raise ValueError(
                    f"{kindname} gate at positions {inst.positions} expects "
                    f"{want} entries, got {got}"
                )

    # -- construction helpers ----------------------------------------------

    def append(self, *instructions: Instruction) -> "Tape":
        return Tape(self.n, self.instructions + tuple(instructions))


    def summary(self) -> str:
        """Human-readable tape statistics."""
        from collections import Counter
        kinds = Counter()
        for i in self.instructions:
            tag = i.kind.value
            if i.is_gate:
                tag += f"{i.k}q" + ("/var" if i.var else "/const")
                if not i.unitary:
                    tag += "/nonu"
            else:
                tag += f"{i.k}q" + ("/diff" if i.diff else "")
            kinds[tag] += 1
        lines = [f"Tape({self.n} qubits, {len(self.instructions)} instructions)"]
        for k in sorted(kinds):
            lines.append(f"  {k}: {kinds[k]}")
        return "\n".join(lines)
