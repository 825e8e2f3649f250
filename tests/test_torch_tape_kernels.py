"""The plain versions of the build() path's kernels against the Pallas
kernels in interpret mode, and the unrolled models against the JAX ones.

* ``block_backward_lane`` (the unpaired lane-block adjoint) at n = 14-16;
* ``block_backward_high`` with ``diag_q``, both run orders, through
  ``planes.backward_dhigh`` at n = 17, 18 (the fused run needs a high
  group of X >= 8, so n >= 17);
* ``diag_backward`` with ``with_q`` through ``planes.backward_diag_run`` at
  n = 14-16;

planes within 1e-5 abs (unit-variance inputs), pair grams and Q within 1e-5
of their largest entry. Then ``scan=False`` of HardwareEfficientAnsatz
(CNOT ring, n = 14), VQEIsing (n = 15) and QAOAMaxCut (n = 16) against the
JAX models with ``scan=False`` (its XLA engine, complex64): value and
gradient within 2e-5 max(1, |x|).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.models.qaoa import QAOAMaxCut as JQAOA
from dqc_tpu.models.vqe_ising import VQEIsing as JVQE
from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.block_backward import block_backward_lane

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import QAOAMaxCut as TQAOA
from dqc_tpu_torch import VQEIsing as TVQE
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl

torch.set_num_threads(2)

PLANE_ATOL = 1e-5
REL = 1e-5
TOL = 2e-5


def _cnormal(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _unitary(rng, X):
    q, _ = np.linalg.qr(_cnormal(rng, (X, X)).astype(np.complex128))
    return q.astype(np.complex64)


def _phases(rng, shape):
    return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)


def _run_tables(rng, A):
    return (_phases(rng, (128, 128)), _phases(rng, (A, 128)),
            _phases(rng, (A, 128)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PLANE_ATOL)


def _assert_rel(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * np.abs(w).max())


@pytest.mark.parametrize("n", [14, 15, 16])
def test_block_backward_lane_matches_pallas(n):
    rng = np.random.default_rng(n)
    A = 1 << (n - 14)
    planes = [rng.standard_normal((A, 128, 128)).astype(np.float32)
              for _ in range(4)]
    Einv, E = _unitary(rng, 128), _unitary(rng, 128)
    ops = [np.ascontiguousarray(x, np.float32)
           for x in (Einv.real, Einv.imag, E.real, E.imag)]
    want = block_backward_lane(*[jnp.asarray(a) for a in planes + ops],
                               dot_mode="f32", gram_dot_mode="f32",
                               interpret=True)
    got = tk.block_backward_lane(*[_t(a) for a in planes + ops])
    assert tk.block_backward_lane.launches == 0  # the plain version ran
    _assert_planes(got[:4], want[:4])
    _assert_rel(got[4:], want[4:])


@pytest.mark.parametrize("n", [17, 18])
@pytest.mark.parametrize("diag_first", [True, False], ids=["run_first", "run_after"])
def test_block_backward_high_diag_q_matches_pallas(n, diag_first):
    """Group 2 (X = 2^(n-14)) with a run folded in: planes, T0 and the Q
    reductions (Qsl, Qas, Qal) on the canonical (A, 128) tables."""
    rng = np.random.default_rng(100 * n + diag_first)
    A = 1 << (n - 14)
    X = 1 << (n - 14)
    planes = [rng.standard_normal((A, 128, 128)).astype(np.float32)
              for _ in range(4)]
    Einv, E = _unitary(rng, X), _unitary(rng, X)
    Tinv, T = _run_tables(rng, A), _run_tables(rng, A)
    jconfig.set_gram_kernel_dot_mode("f32")
    try:
        jout = jpl.backward_dhigh(*[jnp.asarray(a) for a in planes], Einv, E,
                                  Tinv, T, 2, n, diag_first=diag_first,
                                  with_q=True, interpret=True)
    finally:
        jconfig.set_gram_kernel_dot_mode("auto")
    tout = tpl.backward_dhigh(*[_t(a) for a in planes], Einv, E,
                              tuple(_t(t) for t in Tinv), tuple(_t(t) for t in T),
                              2, n, diag_first=diag_first, with_q=True)
    _assert_planes(tout[:4], jout[:4])
    T0, Q = tout[4], tout[5]
    _assert_rel([torch.view_as_real(T0)],
                [np.stack([np.real(jout[4]), np.imag(jout[4])], -1)])
    for g, w in zip(Q, jout[5]):
        _assert_rel([torch.view_as_real(g)], [np.stack([np.real(w), np.imag(w)], -1)])


@pytest.mark.parametrize("n", [14, 15, 16])
def test_diag_backward_with_q_matches_pallas(n):
    rng = np.random.default_rng(7 * n)
    A = 1 << (n - 14)
    planes = [rng.standard_normal((A, 128, 128)).astype(np.float32)
              for _ in range(4)]
    Tinv, T = _run_tables(rng, A), _run_tables(rng, A)
    jout = jpl.backward_diag_run(*[jnp.asarray(a) for a in planes], Tinv, T,
                                 with_q=True, interpret=True)
    tout = tpl.backward_diag_run(*[_t(a) for a in planes],
                                 tuple(_t(t) for t in Tinv),
                                 tuple(_t(t) for t in T), with_q=True)
    _assert_planes(tout[:4], jout[:4])
    for g, w in zip(tout[4], jout[4]):
        _assert_rel([torch.view_as_real(g)], [np.stack([np.real(w), np.imag(w)], -1)])


# ---------------------------------------------------------------------------
# The unrolled models (scan=False) against the JAX package's
# ---------------------------------------------------------------------------

def _hea(n):
    p = (0.3 * np.random.default_rng(1).standard_normal((2, n, 3))).astype(np.float32)
    return (JHEA(n, 2, entangler="cnot", scan=False, dtype=jnp.complex64),
            THEA(n, 2, entangler="cnot", scan=False, device="cpu"),
            "magnetization", "magnetization", p)


def _vqe(n):
    p = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    return (JVQE(n, 2, scan=False, dtype=jnp.complex64),
            TVQE(n, 2, scan=False, device="cpu"), "energy", "energy", p)


def _qaoa(n):
    edges = [(i, (i + 1) % n) for i in range(n)] + [(0, n // 2), (3, n - 2)]
    p = (0.5 * np.random.default_rng(3).standard_normal(4)).astype(np.float32)
    return (JQAOA(n, edges, layers_number=2, scan=False, dtype=jnp.complex64),
            TQAOA(n, edges, layers_number=2, scan=False, device="cpu"),
            "loss", "loss", p)


@pytest.mark.parametrize("n, case", [(14, _hea), (15, _vqe), (16, _qaoa)],
                         ids=["hea14", "vqe15", "qaoa16"])
def test_unrolled_models_match_jax(n, case):
    jm, tm, jloss, tloss, p = case(n)
    jconfig.set_plane_engine(False)
    try:
        want_v, want_g = jax.value_and_grad(getattr(jm, jloss))(jnp.asarray(p))
    finally:
        jconfig.set_plane_engine("auto")
    assert not tm.scan
    tp = torch.tensor(p, requires_grad=True)
    v = getattr(tm, tloss)(tp)
    v.backward()
    assert abs(v.item() - float(want_v)) <= TOL * max(1.0, abs(float(want_v)))
    want_g = np.asarray(want_g)
    err = np.abs(tp.grad.numpy() - want_g)
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(want_g))), err.max()
