""""bf16" storage and the forward bf16x3 on the CNOT ring at n = 16 and 17
(1 layer; at n = 17 group 2 is X = 8 beside the ring's X = 8 span views),
against the JAX plane engine, as tests/test_torch_fwd16_rings_cnot.py runs
n = 14 and 15. n = 16 is marked slow (~1 min a case on the CPU): its group
2 is 4 wide, the elementwise form n = 15 runs at 2 wide, so its kernels
are n = 15's; so are n = 17's bf16x3 settings (~40 s a case), whose X = 8
group 2 tests/test_torch_fwd16_rings.py runs at n = 17 in each setting. Settings, runs and bars are tests/test_torch_fwd16_rings.py's
(its docstring states them).
"""

import sys

import pytest

from test_torch_fwd16_rings import IDS, SETTINGS, SLOW, _restore, check  # noqa: F401


@pytest.mark.parametrize("n, L, storage, dot", [
    *[pytest.param(16, 1, *s, marks=SLOW) for s in SETTINGS], (17, 1, *SETTINGS[0]),
    *[pytest.param(17, 1, *s, marks=SLOW) for s in SETTINGS[1:]]],
    ids=[f"{n}-{i}" for n in (16, 17) for i in IDS])
def test_cnot_ring_16_17(n, L, storage, dot):
    check(("cnot", n, L, True), storage, dot)


if __name__ == "__main__":
    import jax
    from test_torch_fwd16_rings import print_measured
    jax.config.update("jax_platforms", "cpu")
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    print_measured("test_torch_fwd16_rings")
    sys.exit(code)
