"""The reference's gauntlet tape through the port's plane tape at n = 21
and 22 (a merged tiny top group at 22), against the JAX package's XLA
engine (``set_plane_engine(False)``) at complex128: densities and
gradients within 2e-5 max(1, |x|). The complex128 reference keeps the
comparison to the port's own f32 rounding (at n = 23 the JAX XLA engine
in complex64 is 1.9e-5 from complex128, the port's plane tape 4e-7)."""

import pytest

from test_torch_tape import gauntlet_parity


@pytest.mark.parametrize("n", [21, 22])
def test_gauntlet_plane_tape_matches_jax_xla(n):
    kinds = gauntlet_parity(n, jax_plane=False)
    assert "dens" in kinds and "dcross" in kinds, kinds
