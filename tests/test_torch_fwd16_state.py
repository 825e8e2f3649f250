""""bf16" storage and the forward bf16x3 on the cz path from a random
state, and at n = 22: the cases of tests/test_torch_fwd16_models.py (whose
docstring states the set-up and the bars) that run in a file of their own,
so that each file stays near two minutes on one core.

* ``scan_with_epilogue`` of ``HardwareEfficientAnsatz(14, 2, "cz")``'s
  layer from a random normalised state, its gates and the state
  differentiated, in the four settings, against the JAX plane engine in
  the same setting and each package against its own f32 run;
* ``HardwareEfficientAnsatz(22, 1, "cz")`` (the merged top) under "bf16",
  "f32" + bf16x3 and "bf16" + bf16x3 against the port's own f32 run.
"""

import pytest

from test_torch_fwd16_models import (IDS, SETTINGS, _restore,  # noqa: F401
                                     check_from_state, check_merged_top_n22)


@pytest.mark.parametrize("storage, dot", SETTINGS, ids=IDS)
def test_cz_from_state(storage, dot):
    check_from_state(14, storage, dot)


def test_merged_top_bf16_n22():
    check_merged_top_n22()
