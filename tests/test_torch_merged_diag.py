"""The 29-qubit shapes of the port against the JAX package, on the CPU.

* the plain versions of the merged-top kernels (``merged_fact_apply``,
  ``block_backward_merged_fact``) and of the diagonal-run kernels
  (``diag_sweep``, ``diag_backward``) against the JAX package's Pallas
  kernels in interpret mode, with complex non-Hermitian operators at
  Xt = 2 and 4;
* the Gram and the high apply's seed modes at X = 256 and 512 (the merged
  top axis) against ``gram_high`` / ``high_group_apply_planes``;
* ``HardwareEfficientAnsatz(n, L, "cz").magnetization(p).backward()``
  against ``jax.value_and_grad`` of ``dqc_tpu``'s model at n = 15, 16 (a
  2- or 4-wide group 2; the plane engine, Pallas in interpret mode) and
  n = 22, 23 (a 2- or 4-wide top group on the merged axis; the XLA engine),
  at L = 1 (the lone diagonal run in every layer) and L = 3 (the scan
  rotation: head, two rotated bodies, the trailing run); a loss on <Y> at
  n = 22 (the merged seed's conjugation); the 1-layer closed form at n = 22.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's pair grams run in "f32". Tolerances as in
tests/test_torch_backward.py: kernel outputs 2e-5 absolute and relative
(sums of up to 512 products of O(1) values), pair grams and Grams 2e-5 of
their largest entry, gradients 2e-5 absolute per parameter.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops.pallas.block_backward import block_backward_merged_fact
from dqc_tpu.ops.pallas.diag import diag_backward_planes, diag_sweep_planes
from dqc_tpu.ops.pallas.gram import gram_high
from dqc_tpu.ops.pallas.high_apply import (high_group_apply_planes,
                                           merged_fact_apply_planes)

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import convert
from dqc_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_ATOL = 2e-5
C64 = jnp.complex64


@pytest.fixture(autouse=True)
def _jax_gram_f32():
    jconfig.set_gram_kernel_dot_mode("f32")
    yield
    jconfig.set_gram_kernel_dot_mode("auto")


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _pair(c):
    return (np.ascontiguousarray(c.real, dtype=np.float32),
            np.ascontiguousarray(c.imag, dtype=np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _assert_grams(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())


# (A1, Xt Xl, M, 128) merged views: Xt = 2 at 29 qubits' shape, a batch of
# two, and Xt = 4 (the 30-qubit merged axis), with M cut to a few rows
MERGED = [((1, 256, 16, 128), 2), ((2, 256, 8, 128), 2), ((1, 512, 8, 128), 4)]


def _merged_ops(rng, x_top, n_pairs):
    """``n_pairs`` (low (128, 128), top (Xt, Xt)) complex non-Hermitian
    operator pairs as f32 planes: a transpose or adjoint slip shows."""
    out = []
    for _ in range(n_pairs):
        out.append((_pair(_cnormal(rng, (128, 128), 128 ** -0.5)),
                    _pair(_cnormal(rng, (x_top, x_top), x_top ** -0.5))))
    return out


@pytest.mark.parametrize("shape, x_top", MERGED, ids=str)
def test_merged_fact_apply_matches_pallas(shape, x_top):
    rng = np.random.default_rng(700 + shape[0] + x_top)
    x = _pair(_cnormal(rng, shape))
    (el, et), = _merged_ops(rng, x_top, 1)
    want = merged_fact_apply_planes(*_j(x), *_j(el), *_j(et), x_top=x_top,
                                    interpret=True)
    got = tk.merged_fact_apply(*(_t(a) for a in x), *(_t(a) for a in el),
                               *(_t(a) for a in et), x_top=x_top)
    _assert_planes(got, want)


@pytest.mark.parametrize("shape, x_top", MERGED, ids=str)
def test_block_backward_merged_fact_matches_pallas(shape, x_top):
    """All eight outputs: the uncompute, the transport and both pair-gram
    restrictions, whose factor order only the gradient would show."""
    rng = np.random.default_rng(800 + shape[0] + x_top)
    planes = [*_pair(_cnormal(rng, shape)), *_pair(_cnormal(rng, shape))]
    (eli, eti), (el, et) = _merged_ops(rng, x_top, 2)
    ops = (*eli, *el, *eti, *et)
    want = block_backward_merged_fact(*_j(planes), *_j(ops), x_top=x_top,
                                      interpret=True)
    got = tk.block_backward_merged_fact(*(_t(p) for p in planes),
                                        *(_t(o) for o in ops), x_top=x_top)
    assert len(got) == len(want) == 8
    assert tuple(got[4].shape) == (x_top, x_top) and tuple(got[6].shape) == (128, 128)
    _assert_planes(got[:4], want[:4])
    _assert_grams(got[4:], want[4:])


def _table_planes(rng, A):
    out = []
    for shape in ((128, 128), (A, 128), (A, 128)):
        out.extend(_pair(_cnormal(rng, shape, 0.7)))
    return out


@pytest.mark.parametrize("kernel", ["sweep", "backward"])
@pytest.mark.parametrize("A", [4, 16])
def test_diag_kernels_match_pallas(A, kernel):
    rng = np.random.default_rng(900 + A)
    n_planes = 2 if kernel == "sweep" else 4
    planes = [p for _ in range(n_planes // 2)
              for p in _pair(_cnormal(rng, (A, 128, 128)))]
    tabs = _table_planes(rng, A)
    if kernel == "backward":
        tabs += _table_planes(rng, A)
        want = diag_backward_planes(*_j(planes), *_j(tabs), with_q=False,
                                    interpret=True)
        got = tk.diag_backward(*(_t(p) for p in planes), *(_t(t) for t in tabs))
    else:
        want = diag_sweep_planes(*_j(planes), *_j(tabs), interpret=True)
        got = tk.diag_sweep(*(_t(p) for p in planes), *(_t(t) for t in tabs))
    assert len(got) == len(want) == n_planes
    _assert_planes(got, want)


@pytest.mark.parametrize("X", [256, 512])
def test_wide_gram_matches_pallas(X):
    """The Gram on the merged top axis (X = 256 / 512), as gram_high reads
    it."""
    rng = np.random.default_rng(1000 + X)
    shape = (2, X, 8, 128)
    x = _pair(_cnormal(rng, shape, 0.01))
    want = gram_high(*_j(x), interpret=True)
    got = tk.gram(*(_t(a).reshape(2, X, 8 * 128) for a in x))
    _assert_grams(got, want)


SEED_MODES = [dict(conj=True), dict(conj=True, acc=True)]


@pytest.mark.parametrize("mode", SEED_MODES, ids=lambda m: "+".join(m))
@pytest.mark.parametrize("X", [256, 512])
def test_wide_high_apply_seed_matches_pallas(X, mode):
    """The merged-top density seed: ``[acc +] conj(E x)`` at X = 256 / 512
    into fresh or accumulator planes, the input planes left intact."""
    rng = np.random.default_rng(1100 + X)
    shape = (1, X, 8, 128)
    x = _pair(_cnormal(rng, shape))
    acc = _pair(_cnormal(rng, shape)) if mode.get("acc") else None
    e = _pair(_cnormal(rng, (X, X), X ** -0.5))
    want = high_group_apply_planes(*_j(x), *_j(e), alias=False, conj=True,
                                   acc=None if acc is None else tuple(_j(acc)),
                                   interpret=True)
    tx = [_t(a) for a in x]
    got = tk.high_apply(*tx, *(_t(a) for a in e), conj=True, alias=False,
                        acc=None if acc is None else [_t(a) for a in acc])
    _assert_planes(got, want)
    for t, a in zip(tx, x):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# value_and_grad of the hardware-efficient ansatz at the new sizes
# ---------------------------------------------------------------------------

_PAULI = {"x": np.array([[0, 1], [1, 0]], np.complex64),
          "y": np.array([[0, -1j], [1j, 0]], np.complex64),
          "z": np.array([[1, 0], [0, -1]], np.complex64)}


def _params(n, L, seed):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((L, n, 3))).astype(np.float32)


def _observable(weights):
    return sum(w * _PAULI[k] for k, w in weights.items()).astype(np.complex64)


def _jax_value_and_grad(n, L, params, weights, plane_engine):
    """dqc_tpu's value and gradient of sum_i tr(rho_i O), O = sum w P."""
    jm = JHEA(n, L, entangler="cz", dtype=C64, scan=True)
    O = jnp.asarray(_observable(weights))

    def loss(p):
        dens = jps.std_scan_with_epilogue(
            None, jm._layer_ftape, jm._epi_ftape, (), jm._stacked_gates(p),
            jm._layer_consts, dtype=jm.dtype)
        return sum(jnp.real(jnp.einsum("ij,ji->", d, O)) for d in dens)

    jconfig.set_plane_engine(plane_engine)
    try:
        v, g = jax.value_and_grad(loss)(jnp.asarray(params))
    finally:
        jconfig.set_plane_engine("auto")
    return float(v), np.asarray(g)


def _torch_value_and_grad(n, L, params, weights):
    tm = THEA(n, L, entangler="cz", device="cpu")
    p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
    O = torch.from_numpy(_observable(weights))
    loss = sum(torch.einsum("ij,ji->", d, O).real for d in tm.densities(p))
    loss.backward()
    return loss.item(), p.grad.numpy()


MAGNETIZATION = {"z": 1.0}
X_Y_LOSS = {"x": 0.6, "y": 1.0, "z": 0.3}
# (n, the JAX engine): the plane engine (Pallas in interpret mode) where it
# runs in seconds on the CPU, the XLA engine at the merged-top sizes
SIZES = [(15, True), (16, True), (22, False), (23, False)]


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("n, plane_engine", SIZES)
def test_magnetization_grad_matches_jax(n, plane_engine, L):
    params = _params(n, L, seed=1200 + 10 * n + L)
    want_v, want_g = _jax_value_and_grad(n, L, params, MAGNETIZATION, plane_engine)
    got_v, got_g = _torch_value_and_grad(n, L, params, MAGNETIZATION)
    assert got_g.shape == (L, n, 3)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=GRAD_ATOL)
    assert np.abs(want_g).max() > 0.1


def test_x_y_loss_grad_matches_jax_merged_top():
    """<Y> reads Im rho01 of every qubit, the top qubit's through the merged
    seed: a dropped conjugation there would flip its part."""
    n, L = 22, 2
    params = _params(n, L, seed=1300)
    want_v, want_g = _jax_value_and_grad(n, L, params, X_Y_LOSS, False)
    got_v, got_g = _torch_value_and_grad(n, L, params, X_Y_LOSS)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=GRAD_ATOL)
    _, g_no_y = _torch_value_and_grad(n, L, params, {"x": 0.6, "z": 0.3})
    assert np.abs(got_g - g_no_y).max() > 0.1


def test_one_layer_closed_form_merged_top():
    """n = 22, params (alpha, 0, 0): <Z_i> = cos alpha_i, so the gradient is
    (-sin alpha, 0, 0); the top qubit's density comes from the merged
    Gram and its seed from the merged apply."""
    n = 22
    alpha = np.linspace(-1.3, 1.4, n).astype(np.float32)
    p = torch.zeros(1, n, 3)
    p[0, :, 0] = torch.from_numpy(alpha)
    p.requires_grad_(True)
    loss = THEA(n, 1, entangler="cz", device="cpu").magnetization(p)
    loss.backward()
    a = alpha.astype(np.float64)
    np.testing.assert_allclose(loss.item(), np.cos(a).sum(), rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(p.grad[0, :, 0].numpy(), -np.sin(a), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.grad[0, :, 1:].numpy(), 0.0, rtol=0, atol=1e-5)


if __name__ == "__main__":
    # The measured parity of the value_and_grad cases above (max abs
    # difference per parameter, port vs dqc_tpu), on the tests' own inputs:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_merged_diag.py
    jax.config.update("jax_platforms", "cpu")
    jconfig.set_gram_kernel_dot_mode("f32")
    cases = [(n, pe, L, MAGNETIZATION, 1200 + 10 * n + L)
             for n, pe in SIZES for L in (1, 3)]
    cases.append((22, False, 2, X_Y_LOSS, 1300))
    for n, pe, L, weights, seed in cases:
        params = _params(n, L, seed=seed)
        _, want = _jax_value_and_grad(n, L, params, weights, pe)
        _, got = _torch_value_and_grad(n, L, params, weights)
        print(f"n={n} L={L} {'plane' if pe else 'xla'} engine, loss "
              f"{sorted(weights)}: max abs grad diff {np.abs(got - want).max():.3e}")
