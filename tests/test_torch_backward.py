"""The port's gradient against the JAX package, on the CPU.

* the plain versions of the backward kernels (``block_backward_dual``,
  ``block_backward_high``) and the seed modes of the apply kernels against
  the JAX package's Pallas kernels in interpret mode, in every mode the
  gradient uses;
* the per-gate close of the adjoint (``dense_block_var_cts``) and the gate
  inversion against the JAX package's;
* ``HardwareEfficientAnsatz(n, L, "cz").magnetization(p).backward()``
  against ``jax.value_and_grad`` of ``dqc_tpu``'s model, with a loss on
  ``<X>`` and ``<Y>`` (``Im rho01``) that a missing conjugation would show;
  the one-layer closed form; a second backward raises.

Inputs are made with numpy from a seed and handed to both packages. The
JAX package's pair grams run in "f32" (its default is "bf16x3", which the
port does not have yet). Tolerances: kernel outputs are sums of 128-term
f32 products of O(1) values, 2e-5 absolute and relative as in
tests/test_torch_kernels.py; pair grams sum A 128 such products, held
relative to their size; gradients are O(1) sums of per-layer pair-gram
terms, held to 2e-5 absolute per parameter.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import fused_autograd as jfa
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.circuit.fusion import FBlock as JFBlock, GateRef as JGateRef
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops import inversion as jinv
from dqc_tpu.ops.pallas.block_backward import (block_backward_dual,
                                               block_backward_high)
from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import convert
from dqc_tpu_torch.circuit import fused_autograd as tfa
from dqc_tpu_torch.circuit.fusion import FBlock as TFBlock, GateRef as TGateRef
from dqc_tpu_torch.ops import inversion as tinv
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


def _table_planes(rng, A):
    """Six f32 planes of random complex run tables (tsl (128,128),
    tas/tal (A,128))."""
    out = []
    for shape in ((128, 128), (A, 128), (A, 128)):
        out.extend(_pair(_cnormal(rng, shape, 0.7)))
    return out


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _assert_grams(got, want):
    """Pair grams: sums of A 128 products, held to 2e-5 of their largest
    entry."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())


DIAG = [None, "before", "after"]  # the run's place in the forward


@pytest.mark.parametrize("diag", DIAG)
@pytest.mark.parametrize("g0_first", [True, False])
@pytest.mark.parametrize("A", [4, 16])
def test_block_backward_dual_matches_pallas(A, g0_first, diag):
    rng = np.random.default_rng(100 + A + 2 * g0_first)
    planes = [*_pair(_cnormal(rng, (A, 128, 128))),
              *_pair(_cnormal(rng, (A, 128, 128)))]
    # complex non-Hermitian operators: a transpose/adjoint slip shows up
    ops = [p for _ in range(4) for p in _pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    kw = dict(g0_first=g0_first)
    if diag:
        kw.update(diag_first_fwd=(diag == "before"))
        tabs = (_table_planes(rng, A), _table_planes(rng, A))
    want = block_backward_dual(
        *(jnp.asarray(p) for p in planes), *(jnp.asarray(o) for o in ops),
        diag_inv_tables=tuple(jnp.asarray(t) for t in tabs[0]) if diag else None,
        diag_tables=tuple(jnp.asarray(t) for t in tabs[1]) if diag else None,
        interpret=True, **kw)
    got = tk.block_backward_dual(
        *(_t(p) for p in planes), *(_t(o) for o in ops),
        diag_inv_tables=[_t(t) for t in tabs[0]] if diag else None,
        diag_tables=[_t(t) for t in tabs[1]] if diag else None, **kw)
    assert len(got) == len(want) == 8
    _assert_planes(got[:4], want[:4])
    _assert_grams(got[4:], want[4:])


@pytest.mark.parametrize("diag", DIAG)
@pytest.mark.parametrize("shape", [(2, 8, 128, 128), (1, 128, 256, 128)])
def test_block_backward_high_matches_pallas(shape, diag):
    A1, X, M, _ = shape
    post = M // 128
    A = A1 * X * post
    rng = np.random.default_rng(200 + X)
    planes = [*_pair(_cnormal(rng, shape)), *_pair(_cnormal(rng, shape))]
    ops = [p for _ in range(2) for p in _pair(_cnormal(rng, (X, X), X ** -0.5))]
    jtabs = ttabs = (None, None)
    if diag:
        tabs = (_table_planes(rng, A), _table_planes(rng, A))
        v = (A1, X, post, 128)   # the JAX kernel's view-tables
        jtabs = tuple((jnp.asarray(t[0]), jnp.asarray(t[1]),
                       *(jnp.asarray(x.reshape(v)) for x in t[2:])) for t in tabs)
        ttabs = tuple([_t(x) for x in t] for t in tabs)
    first = diag == "before"
    want = block_backward_high(
        *(jnp.asarray(p) for p in planes), *(jnp.asarray(o) for o in ops),
        diag_inv_tables=jtabs[0], diag_tables=jtabs[1], diag_first_fwd=first,
        interpret=True)
    got = tk.block_backward_high(
        *(_t(p) for p in planes), *(_t(o) for o in ops),
        diag_inv_tables=ttabs[0], diag_tables=ttabs[1], diag_first_fwd=first)
    assert len(got) == len(want) == 6
    _assert_planes(got[:4], want[:4])
    _assert_grams(got[4:], want[4:])


SEED_MODES = [dict(conj=True), dict(acc=True), dict(conj=True, acc=True)]


@pytest.mark.parametrize("mode", SEED_MODES, ids=lambda m: "+".join(m))
@pytest.mark.parametrize("kernel", ["dual", "high"])
def test_apply_seed_modes_match_pallas(kernel, mode):
    """``conj``/``acc``/``alias=False``: the density seed's ``acc +
    conj(E x)``, with the input planes left as they were."""
    rng = np.random.default_rng(300)
    shape = (4, 128, 128) if kernel == "dual" else (2, 16, 128, 128)
    X = 128 if kernel == "dual" else 16
    x = _pair(_cnormal(rng, shape))
    acc = _pair(_cnormal(rng, shape)) if mode.get("acc") else None
    n_ops = 2 if kernel == "dual" else 1
    ops = [p for _ in range(n_ops) for p in _pair(_cnormal(rng, (X, X), X ** -0.5))]
    conj = mode.get("conj", False)
    jfn = dual_group_apply_planes if kernel == "dual" else high_group_apply_planes
    tfn = tk.dual_apply if kernel == "dual" else tk.high_apply
    want = jfn(*(jnp.asarray(a) for a in x), *(jnp.asarray(o) for o in ops),
               alias=False, conj=conj,
               acc=None if acc is None else tuple(jnp.asarray(a) for a in acc),
               interpret=True)
    tx = [_t(a) for a in x]
    got = tfn(*tx, *(_t(o) for o in ops), conj=conj,
              acc=None if acc is None else [_t(a) for a in acc], alias=False)
    _assert_planes(got, want)
    for t, a in zip(tx, x):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# The per-gate close and the gate inversion
# ---------------------------------------------------------------------------

# (var, rel_positions, diag, unitary) of each gate of a mixed block on a
# 7-bit group: dense and diagonal, variable and constant, 1 to 3 qubits
BLOCK = [(True, (2,), False, True), (False, (4, 1), False, False),
         (True, (0, 5), True, False), (True, (6, 3, 1), False, False),
         (False, (5,), True, True)]


def test_dense_block_var_cts_matches_jax():
    g = 7
    rng = np.random.default_rng(400)
    gates = [(_cnormal(rng, (1 << len(r),)) if d
              else _cnormal(rng, (1 << (2 * len(r)),)))
             for _, r, d, _ in BLOCK]
    var_q = [i for i, b in enumerate(BLOCK) if b[0]]
    const_q = [i for i, b in enumerate(BLOCK) if not b[0]]
    refs = [(v, (var_q if v else const_q).index(i), r, d, u)
            for i, (v, r, d, u) in enumerate(BLOCK)]
    T0 = _cnormal(rng, (128, 128))
    jblock = JFBlock(1, tuple(JGateRef(*r) for r in refs))
    tblock = TFBlock(1, tuple(TGateRef(*r) for r in refs))
    jvar = tuple(jnp.asarray(gates[i]) for i in var_q)
    tvar = tuple(_t(gates[i]) for i in var_q)
    const = tuple(gates[i] for i in const_q)

    want: dict = {}
    jfa.dense_block_var_cts(jblock, jfa._block_ops(jblock, jvar, const, g, C64),
                            jnp.asarray(T0), jvar, const, g, C64, want)
    got: dict = {}
    tfa.dense_block_var_cts(tblock, tfa._block_ops(tblock, tvar, const, g,
                                                   torch.complex64),
                            _t(T0), tvar, const, g, torch.complex64, got)
    assert sorted(got) == sorted(want) == list(range(len(var_q)))
    for q in want:
        w = np.asarray(want[q])
        assert got[q].shape == w.shape
        np.testing.assert_allclose(got[q].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_inverse_block_operator_undoes_the_block():
    """``_block_operator(inverse=True, reverse=True)`` of a mixed block is
    the inverse of its forward operator, as in the JAX package."""
    from dqc_tpu.circuit import plane_scan as jplane
    from dqc_tpu_torch.circuit import plane_scan as tplane

    rng = np.random.default_rng(410)
    refs = [(False, i, r, d, u) for i, (_, r, d, u) in enumerate(BLOCK)]

    def gate(r, d, u):
        k = 1 << len(r)
        if d:
            return (np.exp(1j * rng.uniform(0, 6.3, k)) if u
                    else _cnormal(rng, (k,))).astype(np.complex64)
        m = np.linalg.qr(_cnormal(rng, (k, k)))[0] if u else _cnormal(rng, (k, k))
        return m.reshape(-1).astype(np.complex64)

    gates = tuple(gate(r, d, u) for _, r, d, u in BLOCK)
    jblock = JFBlock(0, tuple(JGateRef(*r) for r in refs))
    tblock = TFBlock(0, tuple(TGateRef(*r) for r in refs))
    E = tplane._block_operator(tblock, (), gates, 7)
    Einv = tplane._block_operator(tblock, (), gates, 7, inverse=True, reverse=True)
    want = np.asarray(jplane._block_operator(jblock, (), gates, 7, inverse=True,
                                             reverse=True))
    np.testing.assert_allclose(Einv, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(Einv @ E, np.eye(128), atol=1e-3)


INVERT_CASES = ["unitary", "general", "diag_unitary", "diag_general"]


@pytest.mark.parametrize("case", INVERT_CASES)
def test_inversion_matches_jax(case):
    rng = np.random.default_rng(420)
    diag = case.startswith("diag")
    unitary = case.endswith("unitary")
    if diag:
        m = np.exp(1j * rng.uniform(0, 6.3, 4)).astype(np.complex64)
        if not unitary:
            m = (m * rng.uniform(0.5, 2.0, 4)).astype(np.complex64)
        jf, tf = jinv.invert_diag, tinv.invert_diag
    else:
        m = _cnormal(rng, (4, 4))
        if unitary:
            m = np.linalg.qr(m)[0].astype(np.complex64)
        jf, tf = jinv.invert_gate, tinv.invert_gate
    want = np.asarray(jf(m, unitary))
    host = tf(m, unitary)
    assert isinstance(host, np.ndarray)       # a constant stays host numpy
    np.testing.assert_allclose(host, want, rtol=1e-5, atol=1e-6)
    dev = tf(_t(m), unitary)                  # a variable stays a tensor
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_allclose(dev.resolve_conj().numpy(), want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("fn, m", [
    (tinv.invert_gate, np.array([[1, 2], [2, 4]], np.complex64)),
    (tinv.invert_diag, np.array([1, 0], np.complex64)),
])
def test_singular_const_gate_raises(fn, m):
    with pytest.raises(ValueError, match="singular non-unitary gate"):
        fn(m, False, "const gate, queue index 3")


# ---------------------------------------------------------------------------
# value_and_grad of the hardware-efficient ansatz
# ---------------------------------------------------------------------------

def _params(n, L, seed):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((L, n, 3))).astype(np.float32)


_PAULI = {"x": np.array([[0, 1], [1, 0]], np.complex64),
          "y": np.array([[0, -1j], [1j, 0]], np.complex64),
          "z": np.array([[1, 0], [0, -1]], np.complex64)}


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


@pytest.mark.parametrize("n, plane_engine", [(14, True), (17, True), (21, True),
                                             (24, False)])
def test_magnetization_grad_matches_jax(n, plane_engine):
    """n = 14, 17, 21 against dqc_tpu's plane engine (Pallas in interpret
    mode), n = 24 (the 28-qubit program's shape) against its XLA engine."""
    L = 2
    params = _params(n, L, seed=500 + n)
    want_v, want_g = _jax_value_and_grad(n, L, params, MAGNETIZATION, plane_engine)
    tm = THEA(n, L, entangler="cz", device="cpu")
    p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
    loss = tm.magnetization(p)
    loss.backward()
    assert p.grad.shape == (L, n, 3) and p.grad.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want_v, rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0, atol=GRAD_ATOL)
    assert np.abs(want_g).max() > 0.1


@pytest.mark.parametrize("n", [14, 17])
def test_x_y_loss_grad_matches_jax(n):
    """The conjugation test: <Y> reads Im rho01, which a loss on <Z> alone
    (a real, diagonal density cotangent) cannot see."""
    L = 2
    params = _params(n, L, seed=600 + n)
    want_v, want_g = _jax_value_and_grad(n, L, params, X_Y_LOSS, True)
    got_v, got_g = _torch_value_and_grad(n, L, params, X_Y_LOSS)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=GRAD_ATOL)
    # the <Y> part alone moves the gradient: a dropped conj would flip it
    _, g_no_y = _torch_value_and_grad(n, L, params, {"x": 0.6, "z": 0.3})
    assert np.abs(got_g - g_no_y).max() > 0.1


def test_one_layer_closed_form():
    """params (alpha, 0, 0): each qubit is RY(alpha)|0> and the CZ ring
    leaves <Z_i> = cos alpha_i, so the gradient is (-sin alpha, 0, 0)."""
    n = 14
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


def test_second_backward_raises():
    """The backward rolls the saved final planes back in place (O(1)
    memory), so a second backward through the same graph raises."""
    n = 14
    p = convert.params_from_jax(_params(n, 1, seed=7), device="cpu").requires_grad_(True)
    loss = THEA(n, 1, entangler="cz", device="cpu").magnetization(p)
    loss.backward(retain_graph=True)
    first = p.grad.clone()
    with pytest.raises(RuntimeError, match="consumed"):
        loss.backward()
    assert torch.equal(p.grad, first)


def test_gradient_is_deterministic_and_plain_matches_kernels():
    """On a CPU tensor KERNELS and PLAIN run the same plain versions: the
    two paths give the same gradient, and a repeat gives it again."""
    n, L = 17, 2
    params = _params(n, L, seed=8)
    tm = THEA(n, L, entangler="cz", device="cpu")
    grads = []
    for ks in (tk.KERNELS, tk.PLAIN, tk.KERNELS):
        p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
        tm.magnetization(p, kernels=ks).backward()
        grads.append(p.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


if __name__ == "__main__":
    # The measured parity of the value_and_grad cases above (max abs
    # difference per parameter, port vs dqc_tpu), on the tests' own inputs:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_backward.py
    jax.config.update("jax_platforms", "cpu")
    jconfig.set_gram_kernel_dot_mode("f32")
    cases = [(n, pe, MAGNETIZATION, 500 + n)
             for n, pe in ((14, True), (17, True), (21, True), (24, False))]
    cases += [(n, True, X_Y_LOSS, 600 + n) for n in (14, 17)]
    for n, pe, weights, seed in cases:
        params = _params(n, 2, seed=seed)
        _, want = _jax_value_and_grad(n, 2, params, weights, pe)
        _, got = _torch_value_and_grad(n, 2, params, weights)
        print(f"n={n} {'plane' if pe else 'xla'} engine, loss {sorted(weights)}: "
              f"max abs grad diff {np.abs(got - want).max():.3e}")
