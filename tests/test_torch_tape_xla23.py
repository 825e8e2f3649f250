"""The reference's gauntlet tape through the port's plane tape at n = 23
(a 4-wide top group merged with the group below it: hpair items and the
merged seeds), against the JAX package's XLA engine at complex128, as
tests/test_torch_tape_xla.py does for n = 21, 22. Marked slow: it takes
~70 s on the CPU (the JAX complex128 reference), and n = 22 covers the
same merged-top path at Xt = 2."""

import pytest

from test_torch_tape import gauntlet_parity


@pytest.mark.slow
def test_gauntlet_plane_tape_n23_matches_jax_xla():
    kinds = gauntlet_parity(23, jax_plane=False)
    assert "hpair" in kinds, kinds
