"""The reference's gauntlet tape through the port's ``AutoGradCircuit
.build()`` on the plane tape at n = 15 and 16 (a 2- or 4-wide group 2, the
unpaired lane-block adjoint), against the JAX package's plane tape with
its kernels in interpret mode: densities and gradients within 2e-5
max(1, |x|) (tests/test_torch_tape.py holds n = 14 and the helpers)."""

import pytest

from test_torch_tape import gauntlet_parity


@pytest.mark.parametrize("n", [15, 16])
def test_gauntlet_plane_tape_matches_jax(n):
    kinds = gauntlet_parity(n, jax_plane=True)
    assert {"dens", "dcross", "ddual", "dense"} <= kinds, kinds
