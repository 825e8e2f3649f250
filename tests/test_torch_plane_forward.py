"""The port's forward slice against the JAX package, on the CPU.

* ``plane_program`` (pure host scheduling) equals the JAX package's for the
  cz and cnot hardware-efficient layers at every n from 14 to 30;
* the port's ``HardwareEfficientAnsatz(n, L, "cz")`` — its magnetization
  and its FULL density list — equals ``dqc_tpu``'s scan-mode model, against
  both of the JAX package's engines: the complex XLA engine and the plane
  engine with its Pallas kernels in interpret mode;
* the numpy carry-over (dqc_tpu_torch.convert) feeds one plane state to
  both packages' plane applies.

Inputs come from numpy seeds. Tolerances: f32 rounding over L layers of
~4 full-state sweeps of 128-term sums gives ~1e-6 on O(1) density entries;
the bars are 2e-5 (densities, absolute) and 1e-5 (magnetization, relative
to n).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops import planes as jpl

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.ops import planes as tpl

torch.set_num_threads(2)

C64 = jnp.complex64


def _params(n, L, seed):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((L, n, 3))).astype(np.float32)


def _jax_densities(m, params):
    """dqc_tpu's densities for the model's scan path (the function
    magnetization sums <Z> over)."""
    dens = jps.std_scan_with_epilogue(
        None, m._layer_ftape, m._epi_ftape, (),
        m._stacked_gates(jnp.asarray(params)), m._layer_consts, dtype=m.dtype)
    return np.stack([np.asarray(d) for d in dens])


def _compare(n, L, seed, plane_engine):
    params = _params(n, L, seed)
    jm = JHEA(n, L, entangler="cz", dtype=C64, scan=True)
    jconfig.set_plane_engine(plane_engine)
    try:
        want = _jax_densities(jm, params)
        want_mag = float(jm.magnetization(jnp.asarray(params)))
    finally:
        jconfig.set_plane_engine("auto")

    tm = THEA(n, L, entangler="cz", device="cpu")
    p = convert.params_from_jax(params, device="cpu")
    got = torch.stack(tm.densities(p)).numpy()
    assert got.shape == (n, 2, 2) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(tm.magnetization(p)), want_mag,
                               rtol=0, atol=1e-5 * n)


@pytest.mark.parametrize("entangler", ["cz", "cnot"])
def test_plane_program_matches_jax(entangler):
    """Host-only: the same fused layer tape and the same execution plan
    (dual pairs, sunk and folded diagonal runs, merged top groups) at every
    n the plane layout holds, including the sizes this slice cannot run
    yet."""
    for n in range(14, 31):
        jm = JHEA(n, 1, entangler=entangler, dtype=C64, scan=True)
        tm = THEA(n, 1, entangler=entangler, device="cpu")
        assert len(tm._layer_ftape.instructions) == len(jm._layer_ftape.instructions)
        assert tps.plane_program(tm._layer_ftape) == jps.plane_program(jm._layer_ftape), n
        jrot = jps._rotatable_const_diag(jps.plane_program(jm._layer_ftape),
                                         jm._layer_ftape)
        trot = tps._rotatable_const_diag(tps.plane_program(tm._layer_ftape),
                                         tm._layer_ftape)
        assert trot == jrot, n


@pytest.mark.parametrize("n", [14, 17, 21])
def test_hea_matches_jax_xla_engine(n):
    _compare(n, 3, seed=n, plane_engine=False)


@pytest.mark.parametrize("n", [17, 21])
def test_hea_matches_jax_plane_engine(n):
    """Against dqc_tpu's own plane path: the same dual / dhigh kernel items
    with its Pallas kernels in interpret mode."""
    _compare(n, 3, seed=100 + n, plane_engine=True)


def test_hea_24q_matches_jax():
    """n=24 is the smallest size with the 28-qubit program's shape:
    dense(dual) . dense(high group 2) . dhigh(group 3, run after)."""
    program = tps.plane_program(THEA(24, 1, entangler="cz", device="cpu")._layer_ftape)
    assert [it[0] for it in program] == ["dense", "dense", "dhigh"]
    _compare(24, 2, seed=24, plane_engine=False)


def test_zero_params_known_answer():
    """params = 0: every gate is the identity and CZ leaves |0..0> alone,
    so every density is |0><0| and the magnetization is exactly n."""
    n = 17
    tm = THEA(n, 2, entangler="cz", device="cpu")
    dens = torch.stack(tm.densities(torch.zeros(2, n, 3))).numpy()
    want = np.zeros((n, 2, 2), np.complex64)
    want[:, 0, 0] = 1
    np.testing.assert_array_equal(dens, want)
    assert float(tm.magnetization(torch.zeros(2, n, 3))) == n


def test_params_round_trip():
    params = _params(5, 4, seed=1)
    p = convert.params_from_jax(params, device="cpu")
    assert p.dtype == torch.float32 and tuple(p.shape) == (4, 5, 3)
    np.testing.assert_array_equal(p.numpy(), params)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(p.numpy())), params)  # and back into JAX
    p64 = convert.params_from_jax(jnp.asarray(params), dtype=torch.float64,
                                  device="cpu")
    np.testing.assert_array_equal(p64.numpy(), params.astype(np.float64))
    with pytest.raises(ValueError):
        convert.params_from_jax(np.zeros((4, 5)), device="cpu")


@pytest.mark.parametrize("n", [15, 17])
def test_plane_state_fed_to_both_packages(n):
    """One plane state through both packages' apply_dual (with a fused run
    after the dense step) and apply_high on group 2."""
    rng = np.random.default_rng(200 + n)
    psi = (rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n))
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    xr = np.ascontiguousarray(psi.real.reshape(jpl.plane_shape(n)), np.float32)
    xi = np.ascontiguousarray(psi.imag.reshape(jpl.plane_shape(n)), np.float32)
    A = xr.shape[0]
    E0, E1 = (np.linalg.qr(rng.standard_normal((128, 128))
                           + 1j * rng.standard_normal((128, 128)))[0]
              .astype(np.complex64) for _ in range(2))
    tables = tuple(np.exp(1j * rng.uniform(0, 6.3, s)).astype(np.complex64)
                   for s in ((128, 128), (A, 128), (A, 128)))

    wr, wi = jpl.apply_dual(jnp.asarray(xr), jnp.asarray(xi), E0, E1,
                            diag=tables, diag_first=False, interpret=True)
    tr_, ti_ = convert.planes_from_jax(xr, xi, device="cpu")
    gr_, gi_ = tpl.apply_dual(tr_, ti_, E0, E1, diag=tables, diag_first=False)
    got = convert.planes_to_numpy(gr_, gi_)
    np.testing.assert_allclose(got[0], np.asarray(wr), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got[1], np.asarray(wi), rtol=2e-5, atol=2e-6)

    # group 2: the high kernel at n = 17 (X = 8), the elementwise small-X
    # apply at n = 15 (X = 2)
    X = jpl._high_view(n, 2)[1]
    E = np.linalg.qr(rng.standard_normal((X, X))
                     + 1j * rng.standard_normal((X, X)))[0].astype(np.complex64)
    wr, wi = jpl.apply_high(jnp.asarray(xr), jnp.asarray(xi), E, 2, n,
                            interpret=True)
    tr_, ti_ = convert.planes_from_jax(xr, xi, device="cpu")
    got = convert.planes_to_numpy(*tpl.apply_high(tr_, ti_, E, 2, n))
    np.testing.assert_allclose(got[0], np.asarray(wr), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got[1], np.asarray(wi), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", [14, 24, 28])
def test_diag_run_tables_match_jax(n):
    """The CZ ring's fused run as the three factors the kernels multiply in
    (tsl, tas, tal), built from the same const gates by both packages —
    n = 24 and 28 exercise the joint tables of two high groups."""
    jm = JHEA(n, 1, entangler="cz", dtype=C64, scan=True)
    tm = THEA(n, 1, entangler="cz", device="cpu")
    item = jps.plane_program(jm._layer_ftape)[-1]
    assert item[0] in ("ddual", "dhigh")
    want = jps._diag_run_tables(item[1], jm._layer_ftape, (), jm._layer_consts)
    got = tps._diag_run_tables(item[1], tm._layer_ftape, (), tm._layer_consts,
                               torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_to_from_planes_match_jax():
    n = 15
    rng = np.random.default_rng(7)
    psi = (rng.standard_normal(1 << n)
           + 1j * rng.standard_normal(1 << n)).astype(np.complex64)
    wr, wi = jpl.to_planes(jnp.asarray(psi), n)
    tr_, ti_ = tpl.to_planes(torch.from_numpy(psi), n)
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(ti_.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tpl.from_planes(tr_, ti_, n).numpy(), psi)
    sr, si = tpl.standard_planes(n, device="cpu")
    jr, ji = jpl.standard_planes(n)
    np.testing.assert_array_equal(sr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
