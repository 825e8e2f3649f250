"""Hand-written Hopper kernels of the plane engine, with their plain twins.

Each kernel module holds a wrapper (the kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor) with an integer ``launches`` counter that
counts kernel launches only, and the plain version itself. A wrapper with
modes the engine reaches on some paths only also counts those launches per
mode in ``mode_launches`` (the ``diag_q`` of ``block_backward_dual`` and
``block_backward_high``, ``diag_backward``'s ``with_q``, the multi-term
applies' ``seed``: ``conj``, ``acc`` or ``alias=False``; the merged top
axis, X = 256 / 512: ``high_apply``'s ``wide_inplace`` and
``block_backward_high``'s ``wide``; the storage and dot-mode variants:
"bf16" and "f16" for cotangent planes stored reduced (the seeds of
``dual_apply`` / ``high_apply``, the multi-term applies in place and as
seeds, every adjoint and ``diag_backward``), "bf16x3" for a bf16x3
transport and "gram_bf16x3" for bf16x3 pair grams; "fwd_bf16" for bf16
forward planes ("bf16" storage: every kernel that reads F, the
multi-term applies' seeds) and "fwd_bf16x3" for the forward bf16x3.
Below X = 128 the high apply's "bf16" / bf16x3 variants, the high
multi-term apply's bf16x3 products and the high adjoint are libraries of
their own (``csrc/high_apply_fwd16.cu``, ``csrc/high_multi_apply_x3.cu``,
``csrc/block_backward_high_small.cu``) so that the build's nvcc processes
stay short. ``high_apply`` at X = 128 / 256 / 512 runs on the tensor cores
(``csrc/tc_apply.cuh``, every storage and mode), counted also as
``high_apply[tc]``; so does every product of the dual, lane and sublane
adjoints' one-pass step and of the high adjoint's at X = 8..128
(``csrc/tc_adjoint.cuh``, the lane and sublane adjoints built in the dual
adjoint's library as its lane and sublane steps;
``csrc/block_backward_high_small.cu`` below X = 128), counted as
``block_backward_dual[tc]``, ``block_backward_lane[tc]``,
``block_backward_sublane[tc]`` and ``block_backward_high[tc]``; so do
the Gram at X = 128 / 256 / 512 and the merged-top adjoint (``gram[tc]``,
``block_backward_merged_fact[tc]``) and the dual and merged-top applies
(``dual_apply[tc]``, ``merged_fact_apply[tc]``: ``csrc/tc_adjoint.cuh``'s
tile product); ``_tc`` holds their operand splits and pre-split
operators. ``KERNELS`` is
the set of wrappers the engine runs by default; ``PLAIN`` runs the plain
versions on any device, as the yardstick the kernels are held against.
``_storage`` holds the kernels' storage codec and bf16x3 products as the
plain versions compute them.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from dqc_tpu_torch.ops.kernels.block_backward_dual import (
    block_backward_dual,
    block_backward_dual_plain,
)
from dqc_tpu_torch.ops.kernels.block_backward_high import (
    block_backward_high,
    block_backward_high_plain,
)
from dqc_tpu_torch.ops.kernels.block_backward_lane import (
    block_backward_lane,
    block_backward_lane_plain,
)
from dqc_tpu_torch.ops.kernels.block_backward_merged_fact import (
    block_backward_merged_fact,
    block_backward_merged_fact_plain,
)
from dqc_tpu_torch.ops.kernels.block_backward_sublane import (
    block_backward_sublane,
    block_backward_sublane_plain,
)
from dqc_tpu_torch.ops.kernels.diag import (
    diag_backward,
    diag_backward_plain,
    diag_sweep,
    diag_sweep_plain,
)
from dqc_tpu_torch.ops.kernels.dual_apply import dual_apply, dual_apply_plain
from dqc_tpu_torch.ops.kernels.dual_multi_apply import (
    dual_multi_apply,
    dual_multi_apply_plain,
)
from dqc_tpu_torch.ops.kernels.gram import gram, gram_plain
from dqc_tpu_torch.ops.kernels.high_apply import high_apply, high_apply_plain
from dqc_tpu_torch.ops.kernels.high_multi_apply import (
    high_multi_apply,
    high_multi_apply_plain,
)
from dqc_tpu_torch.ops.kernels.merged_fact_apply import (
    merged_fact_apply,
    merged_fact_apply_plain,
)


class KernelSet(NamedTuple):
    dual_apply: Callable
    high_apply: Callable
    gram: Callable
    block_backward_dual: Callable
    block_backward_high: Callable
    merged_fact_apply: Callable
    block_backward_merged_fact: Callable
    diag_sweep: Callable
    diag_backward: Callable
    dual_multi_apply: Callable
    high_multi_apply: Callable
    block_backward_sublane: Callable
    block_backward_lane: Callable


KERNELS = KernelSet(dual_apply, high_apply, gram, block_backward_dual,
                    block_backward_high, merged_fact_apply,
                    block_backward_merged_fact, diag_sweep, diag_backward,
                    dual_multi_apply, high_multi_apply, block_backward_sublane,
                    block_backward_lane)
PLAIN = KernelSet(dual_apply_plain, high_apply_plain, gram_plain,
                  block_backward_dual_plain, block_backward_high_plain,
                  merged_fact_apply_plain, block_backward_merged_fact_plain,
                  diag_sweep_plain, diag_backward_plain, dual_multi_apply_plain,
                  high_multi_apply_plain, block_backward_sublane_plain,
                  block_backward_lane_plain)


def _mode_counts(w) -> Dict[str, int]:
    return getattr(w, "mode_launches", {})


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0
        modes = _mode_counts(w)
        for m in modes:
            modes[m] = 0


def launch_counts() -> Dict[str, int]:
    """Launches per kernel, then per counted mode as ``"kernel[mode]"``."""
    counts = {w.__name__: w.launches for w in KERNELS}
    for w in KERNELS:
        for m, c in _mode_counts(w).items():
            counts[f"{w.__name__}[{m}]"] = c
    return counts
