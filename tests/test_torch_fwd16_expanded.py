""""bf16" storage and the forward bf16x3 on the expanded merged top
(``set_hpair_factorized(False)``), against the JAX plane engine: at n = 22
the cz ring's top two groups merge into the X = 256 axis, whose dense
sweep runs as the in-place high apply there and whose adjoint is the
X = 256 high adjoint (its cross-Gram decodes F; the uncompute is the wide
apply in place on F). Settings, runs and bars are
tests/test_torch_fwd16_rings.py's (its docstring states them).
"""

import sys

import pytest

from test_torch_fwd16_rings import IDS, SETTINGS, SLOW, _restore, check  # noqa: F401


# both settings together (~50 s on the CPU) run the variants each of the
# other two runs: slow
@pytest.mark.parametrize("storage, dot", SETTINGS[:2] + [
    pytest.param(*SETTINGS[2], marks=SLOW)], ids=IDS)
def test_cz_expanded_top_n22(storage, dot):
    check(("cz", 22, 1, False), storage, dot)


if __name__ == "__main__":
    import jax
    from test_torch_fwd16_rings import print_measured
    jax.config.update("jax_platforms", "cpu")
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    print_measured("test_torch_fwd16_rings")
    sys.exit(code)
