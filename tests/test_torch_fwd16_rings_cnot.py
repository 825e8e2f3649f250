""""bf16" storage and the forward bf16x3 on the CNOT ring at n = 14 and 15,
against the JAX plane engine: the multi-term dual and high + lane kernels
in place (the uncompute on bf16 forward planes, the transport on the
cotangent), the X = 8 span views and their adjoint, the sublane adjoint,
2 layers; n = 16 and 17 (the X = 8 group 2) in
tests/test_torch_fwd16_rings_cnot16.py. Settings, runs and bars are
tests/test_torch_fwd16_rings.py's (its docstring states them).
"""

import sys

import pytest

from test_torch_fwd16_rings import IDS, SETTINGS, SLOW, _restore, check  # noqa: F401


# n = 15 in the forward bf16x3 (~20 s a case on the CPU) runs the kernels
# n = 14 runs in the same settings, and its 2-wide group 2 is the
# elementwise form "bf16" runs there: slow
@pytest.mark.parametrize("n, L, storage, dot", [
    *[(14, 2, *s) for s in SETTINGS], (15, 2, *SETTINGS[0]),
    *[pytest.param(15, 2, *s, marks=SLOW) for s in SETTINGS[1:]]],
    ids=[f"{n}-{i}" for n in (14, 15) for i in IDS])
def test_cnot_ring(n, L, storage, dot):
    check(("cnot", n, L, True), storage, dot)


if __name__ == "__main__":
    import jax
    from test_torch_fwd16_rings import print_measured
    jax.config.update("jax_platforms", "cpu")
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    print_measured("test_torch_fwd16_rings")
    sys.exit(code)
