"""Dispatch parity of the expanded merged top (``set_hpair_factorized(False)``)
under "bf16" storage and the forward bf16x3: the cz ring at n = 22 (the top
two groups merged into X = 256) and the cz and CNOT rings at n = 23 (X =
512), every kernel call's plane shape, storages and dot modes equal to the
JAX package's. Records, stand-ins and settings are
tests/test_torch_fwd16_dispatch_rings.py's (its docstring states them).
"""

import pytest

from test_torch_fwd16_dispatch_rings import FWD16, _restore, check, jax_calls  # noqa: F401


@pytest.mark.parametrize("entangler, n", [("cz", 22), ("cz", 23), ("cnot", 23)])
def test_expanded_top(entangler, n, jax_calls):  # noqa: F811
    check(jax_calls, entangler, (n,), FWD16, factorized=False)
