"""Layer tapes for the scanned (layer-repeated) execution.

Counterpart of ``fuse_layer`` in ``dqc_tpu/circuit/scan.py``. The port runs
the repeated layer as a Python loop over layers (circuit/plane_scan.py).
"""

from __future__ import annotations

from dqc_tpu_torch.circuit.fusion import FDensity, FusedTape, fuse_tape
from dqc_tpu_torch.circuit.ir import Tape


def fuse_layer(tape: Tape) -> FusedTape:
    """Fuse a gate-only layer tape (rejects density instructions)."""
    ftape = fuse_tape(tape)
    if any(isinstance(fi, FDensity) for fi in ftape.instructions):
        raise ValueError("layer tapes must contain gates only; put density "
                         "ops in an epilogue tape")
    return ftape
