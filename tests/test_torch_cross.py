"""The CNOT ring of the port against the JAX package, on the CPU.

* the plain versions of the cross-gate kernels (``dual_multi_apply``,
  ``high_multi_apply``) and of ``block_backward_sublane`` against the JAX
  package's Pallas kernels in interpret mode, with complex non-Hermitian
  factors;
* ``planes.apply_cross_span`` / ``apply_cross_terms`` /
  ``backward_cross_span`` against the JAX functions at n = 15 (Pallas in
  interpret mode), for gates on the (lane, sublane), (sublane, high) and
  (lane, high) boundaries in both position orders, with the CNOT and a
  random unitary;
* the densities, the value and the gradient of
  ``HardwareEfficientAnsatz(n, 2, "cnot")`` against ``jax.value_and_grad``
  of ``dqc_tpu``'s model (the XLA engine) at n = 14, 15, 16, 21, 22 and 23
  (a lone block on the 4-wide top group), with params carried by
  ``convert.params_from_jax``; the one-layer closed form at n = 14-16;
* the shapes off the ring: the per-term fallback of a (sublane, high) gate
  beyond a span view, the slice decomposition of a 3-qubit gate over two
  groups, and VARIABLE span gates, whose cotangent comes out of the span
  view's pair gram (``_span_cotangent``), in both position orders;
* every n in 14..30 passes the support check of the CNOT ring, both ways.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's pair grams run in "f32". Tolerances: kernel planes 1e-5
absolute (sums of up to 4 x 128-term f32 products of O(1) values), pair
grams 1e-5 of their largest entry, densities and gradients 2e-5 absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.circuit.builder import AutoGradCircuit as JCircuit
from dqc_tpu.circuit.fusion import fuse_tape as jfuse_tape
from dqc_tpu.circuit.scan import fuse_layer as jfuse_layer
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.block_backward import block_backward_sublane
from dqc_tpu.ops.pallas.dual_apply import dual_multi_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_multi_apply_planes

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import convert
from dqc_tpu_torch import config as tconfig
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.builder import AutoGradCircuit as TCircuit
from dqc_tpu_torch.circuit.fusion import fuse_tape as tfuse_tape
from dqc_tpu_torch.circuit.scan import fuse_layer as tfuse_layer
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl

torch.set_num_threads(2)

PLANE_ATOL = 1e-5
GRAM_RTOL = 1e-5
ATOL = 2e-5
C64 = jnp.complex64
CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                np.complex64)


@pytest.fixture(autouse=True)
def _jax_gram_f32():
    """Both packages' pair grams in "f32" (their default is "bf16x3")."""
    jconfig.set_gram_kernel_dot_mode("f32")
    tconfig.set_gram_kernel_dot_mode("f32")
    yield
    jconfig.set_gram_kernel_dot_mode("auto")
    tconfig.set_gram_kernel_dot_mode("auto")


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


def _unitary(rng, d):
    q, _ = np.linalg.qr(_cnormal(rng, (d, d)).astype(np.complex128))
    return q.astype(np.complex64)


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PLANE_ATOL)


def _assert_grams(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAM_RTOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# The three kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 4])
def test_dual_multi_apply_matches_pallas(T):
    rng = np.random.default_rng(1500 + T)
    x = _pair(_cnormal(rng, (4, 128, 128)))
    el = _pair(_cnormal(rng, (T, 128, 128), (128 * T) ** -0.5))
    em = _pair(_cnormal(rng, (T, 128, 128), 128 ** -0.5))
    want = dual_multi_apply_planes(*_j(x), *_j(el), *_j(em), interpret=True)
    got = tk.dual_multi_apply(*(_t(a) for a in x), *(_t(a) for a in el),
                              *(_t(a) for a in em))
    _assert_planes(got, want)


@pytest.mark.parametrize("T", [2, 4])
def test_high_multi_apply_matches_pallas(T):
    rng = np.random.default_rng(1600 + T)
    shape = (2, 8, 16, 128)
    x = _pair(_cnormal(rng, shape))
    eh = _pair(_cnormal(rng, (T, 8, 8), (8 * T) ** -0.5))
    el = _pair(_cnormal(rng, (T, 128, 128), 128 ** -0.5))
    want = high_multi_apply_planes(*_j(x), *_j(eh), *_j(el), interpret=True)
    got = tk.high_multi_apply(*(_t(a) for a in x), *(_t(a) for a in eh),
                              *(_t(a) for a in el))
    _assert_planes(got, want)


def test_block_backward_sublane_matches_pallas():
    """The uncompute, the transport and the holomorphic pair gram (B the
    incoming cotangent, F the uncomputed planes), non-Hermitian operators:
    a transpose or a conjugation slip shows."""
    rng = np.random.default_rng(1700)
    planes = [*_pair(_cnormal(rng, (4, 128, 128))),
              *_pair(_cnormal(rng, (4, 128, 128)))]
    ops = [*_pair(_cnormal(rng, (128, 128), 128 ** -0.5)),
           *_pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    want = block_backward_sublane(*_j(planes), *_j(ops), interpret=True)
    got = tk.block_backward_sublane(*(_t(p) for p in planes),
                                    *(_t(o) for o in ops))
    assert len(got) == len(want) == 6
    _assert_planes(got[:4], want[:4])
    _assert_grams(got[4:], want[4:])


def test_new_wrappers_refuse_other_devices():
    """A CUDA-less, CPU-less tensor never reaches a plain version."""
    x = torch.empty((1, 128, 128), device="meta")
    s = torch.empty((1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.dual_multi_apply(x, x, s, s, s, s)
    v = torch.empty((1, 8, 16, 128), device="meta")
    h = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.high_multi_apply(v, v, h, h, s, s)
    e = torch.empty((128, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_sublane(x, x, x, x, e, e, e, e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_lane(x, x, x, x, e, e, e, e)
    assert tk.launch_counts() == {name: 0 for name in (
        *tk.KernelSet._fields, "block_backward_dual[diag_q]",
        "block_backward_high[diag_q]", "diag_backward[with_q]",
        "dual_multi_apply[seed]", "high_multi_apply[seed]",
        "high_apply[wide_inplace]", "high_apply[tc]", "block_backward_high[wide]",
        "block_backward_dual[tc]", "block_backward_lane[tc]",
        "block_backward_sublane[tc]", "block_backward_high[tc]",
        "block_backward_merged_fact[tc]", "gram[tc]", "dual_apply[tc]",
        "merged_fact_apply[tc]",
        *(f"{k}[{m}]" for k in ("dual_apply", "high_apply", "diag_backward",
                                "dual_multi_apply", "high_multi_apply")
          for m in ("bf16", "f16")),
        *(f"{k}[{m}]" for k in ("block_backward_dual", "block_backward_high",
                                "block_backward_merged_fact",
                                "block_backward_lane", "block_backward_sublane")
          for m in ("bf16", "f16", "bf16x3", "gram_bf16x3")),
        *(f"{k}[{m}]" for k in ("dual_apply", "high_apply", "gram",
                                "merged_fact_apply", "block_backward_dual",
                                "block_backward_high", "block_backward_merged_fact",
                                "dual_multi_apply", "high_multi_apply",
                                "block_backward_sublane", "block_backward_lane")
          for m in ("fwd_bf16", "fwd_bf16x3")),
        "diag_sweep[fwd_bf16]", "diag_backward[fwd_bf16]",
        "dual_apply[in_f16]", "high_apply[in_f16]")}


# ---------------------------------------------------------------------------
# The cross-gate plane functions against the JAX package at n = 15
# ---------------------------------------------------------------------------

N15 = 15
POSITIONS = [(6, 7), (7, 6), (13, 14), (14, 13), (0, 14), (14, 0)]


def _gate(name):
    return CNOT if name == "cnot" else _unitary(np.random.default_rng(1800), 4)


def _state(seed, n=N15):
    return _pair(_cnormal(np.random.default_rng(seed), (1 << (n - 14), 128, 128)))


@pytest.mark.parametrize("gate", ["cnot", "unitary"])
@pytest.mark.parametrize("positions", POSITIONS, ids=str)
def test_cross_apply_matches_jax(positions, gate):
    """One fused pass per gate: the span view (the high apply, or the
    multi-term high + lane kernel with a lane bit) or the multi-term dual
    kernel on the Schmidt terms."""
    G = _gate(gate)
    x = _state(1900 + positions[0])
    assert tpl.cross_pair_one_pass(positions, N15)
    assert jpl.cross_pair_one_pass(positions, N15)
    if tpl.cross_span_eligible(positions, N15):
        assert jpl.cross_span_eligible(positions, N15)
        want = jpl.apply_cross_span(*_j(x), jnp.asarray(G), positions, N15,
                                    interpret=True)
        got = tpl.apply_cross_span(*(_t(a) for a in x), G, positions, N15)
    else:
        jterms = jps._dense_cross_expanded_terms(jnp.asarray(G), positions, N15)
        tterms = tps._dense_cross_expanded_terms(G, positions, N15)
        assert len(tterms) == len(jterms) == (2 if gate == "cnot" else 4)
        want = jpl.apply_cross_terms(*_j(x), jterms, N15, interpret=True)
        got = tpl.apply_cross_terms(*(_t(a) for a in x), tterms, N15)
    _assert_planes(got, want)


@pytest.mark.parametrize("gate", ["cnot", "unitary"])
@pytest.mark.parametrize("positions", [(13, 14), (14, 13)], ids=str)
def test_backward_cross_span_matches_jax(positions, gate):
    """The one-pass adjoint on the span view: the planes and the gate
    cotangent in the original position order."""
    G = _gate(gate)
    Ginv = G.conj().T.copy()
    fx, bx = _state(2000 + positions[0]), _state(2100 + positions[0])
    want = jpl.backward_cross_span(*_j(fx), *_j(bx), jnp.asarray(G),
                                   jnp.asarray(Ginv), positions, N15,
                                   interpret=True)
    got = tpl.backward_cross_span(*(_t(a) for a in fx), *(_t(a) for a in bx),
                                  G, Ginv, positions, N15)
    _assert_planes(got[:4], want[:4])
    W, Wj = got[4].numpy(), np.asarray(want[4])
    np.testing.assert_allclose(W, Wj, rtol=0, atol=GRAM_RTOL * np.abs(Wj).max())
    assert not tpl.backward_span_eligible((0, 14), N15)
    assert not tpl.backward_span_eligible((6, 7), N15)


@pytest.mark.parametrize("n, positions", [(16, (7, 15)), (15, (0, 1, 8)),
                                          (15, (8, 0, 1))], ids=str)
def test_dense_cross_fallbacks_match_jax(n, positions):
    """(7, 15) at n = 16 spans 9 bits and has no lane bit: 2 accumulate
    sweeps per Schmidt term (the small-X group 2, the dual apply). A
    3-qubit gate over groups 0 and 1: the slice decomposition over the
    1-bit side, 4 terms, through the multi-term dual kernel."""
    G = _unitary(np.random.default_rng(2300 + n), 1 << len(positions))
    x = _state(2400 + n, n)
    jterms = jps._dense_cross_expanded_terms(jnp.asarray(G), positions, n)
    tterms = tps._dense_cross_expanded_terms(G, positions, n)
    assert [(ja, jb) for _, ja, _, jb in tterms] == [(ja, jb) for _, ja, _, jb in jterms]
    for (ta, _, tb, _), (ja, _, jb, _) in zip(tterms, jterms):
        np.testing.assert_allclose(ta, np.asarray(ja), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb, np.asarray(jb), rtol=0, atol=1e-6)
    kind = tps._cross_plan(G, positions, n, torch.device("cpu"))[0]
    assert kind == ("per_term" if len(positions) == 2 else "terms")
    want = jps._apply_dense_cross(*_j(x), jnp.asarray(G), positions, n, True,
                                  alias=True)
    got = tps._apply_dense_cross(*(_t(a) for a in x), G, positions, n, tk.KERNELS,
                                 alias=True)
    _assert_planes(got, want)


def _euler(xp, t):
    """The ansatz's 1-qubit Euler gate of angles ``t[..., :3]``, (..., 2, 2)."""
    a, b, g = t[..., 0], t[..., 1], t[..., 2]
    c, s = xp.cos(a / 2) + 0j, xp.sin(a / 2) + 0j
    eb, eg = xp.exp(1j * b), xp.exp(1j * g)
    return xp.stack([xp.stack([c, -s * eg], -1),
                     xp.stack([s * eb, c * eb * eg], -1)], -2)


def _two_qubit(xp, t):
    """A variable 2-qubit gate, (R(t[:3]) (x) R(t[3:])) CNOT, flat (L, 16)."""
    r1, r2 = _euler(xp, t[..., :3]), _euler(xp, t[..., 3:])
    k = (r1[..., :, None, :, None] * r2[..., None, :, None, :]).reshape(
        r1.shape[:-2] + (4, 4))
    return (k @ xp.asarray(CNOT)).reshape(k.shape[:-2] + (16,))


VAR_SPAN = [(13, 14), (14, 8)]  # X = 8 and a reversed X = 128 span view


def _var_span_tapes(circuit, fuse_layer, fuse_tape, n):
    layer = circuit(n)
    for q in range(n):
        layer.add_q1_var_gate(q)
    layer.add_q2_const_gate(6, 7)
    for pos in VAR_SPAN:
        layer.add_q2_var_gate(*pos)
    layer.add_q2_const_gate(0, n - 1)
    epi = circuit(n)
    for q in range(n):
        epi.get_q1_dens_op_with_grad(q)
    return fuse_layer(layer.tape), fuse_tape(epi.tape)


def _var_span_loss(xp, scan, ftape, epi, q1, q2, **kw):
    stacked = tuple(_euler(xp, q1[:, q]).reshape(-1, 4) for q in range(q1.shape[1]))
    stacked += tuple(_two_qubit(xp, q2[:, k]) for k in range(q2.shape[1]))
    cnot = np.ascontiguousarray(CNOT.reshape(-1))
    dens = scan(None, ftape, epi, (), stacked, (cnot, cnot), **kw)
    return sum(xp.real(d[0, 0] - d[1, 1]) for d in dens)


def test_var_span_gates_grad_matches_jax():
    """Variable dense cross gates with a span view: the forward runs the
    high apply on the gate expanded over the span, the adjoint one
    block_backward_high pass whose pair gram, partial-traced over the span's
    other bits and put back in the gate's position order, is the gate's
    cotangent. The layer also holds the ring's const (6, 7) and closing
    CNOTs."""
    n, L = 15, 2
    rng = np.random.default_rng(2500)
    q1 = (0.7 * rng.standard_normal((L, n, 3))).astype(np.float32)
    q2 = (0.7 * rng.standard_normal((L, len(VAR_SPAN), 6))).astype(np.float32)
    jft, jepi = _var_span_tapes(JCircuit, jfuse_layer, jfuse_tape, n)
    kinds = [it[0] for it in jps.plane_program(jft)]
    assert kinds.count("dcross") == 4
    jconfig.set_plane_engine(False)
    try:
        want_v, (want_g1, want_g2) = jax.value_and_grad(
            lambda a, b: _var_span_loss(jnp, jps.std_scan_with_epilogue, jft, jepi,
                                        a, b, dtype=C64), argnums=(0, 1))(
            jnp.asarray(q1), jnp.asarray(q2))
    finally:
        jconfig.set_plane_engine("auto")
    tft, tepi = _var_span_tapes(TCircuit, tfuse_layer, tfuse_tape, n)
    t1, t2 = (torch.from_numpy(a).requires_grad_(True) for a in (q1, q2))
    loss = _var_span_loss(torch, tps.std_scan_with_epilogue, tft, tepi, t1, t2,
                          device="cpu")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want_g1), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(want_g2), rtol=0,
                               atol=ATOL)
    assert np.abs(np.asarray(want_g2)).max() > 0.1


# ---------------------------------------------------------------------------
# The CNOT ansatz: densities, value and gradient against jax.value_and_grad
# ---------------------------------------------------------------------------

def _params(n, L, seed):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((L, n, 3))).astype(np.float32)


def _jax_run(n, L, params):
    """dqc_tpu's densities and value_and_grad of the magnetization (the XLA
    engine)."""
    jm = JHEA(n, L, entangler="cnot", dtype=C64, scan=True)
    jconfig.set_plane_engine(False)
    try:
        dens = jps.std_scan_with_epilogue(
            None, jm._layer_ftape, jm._epi_ftape, (),
            jm._stacked_gates(jnp.asarray(params)), jm._layer_consts,
            dtype=jm.dtype)
        dens = [np.asarray(d) for d in dens]
        v, g = jax.value_and_grad(jm.magnetization)(jnp.asarray(params))
    finally:
        jconfig.set_plane_engine("auto")
    return dens, float(v), np.asarray(g)


def _torch_run(n, L, params):
    tm = THEA(n, L, entangler="cnot", device="cpu")
    p = convert.params_from_jax(params, device="cpu")
    dens = [d.numpy() for d in tm.densities(p)]
    p.requires_grad_(True)
    loss = tm.magnetization(p)
    loss.backward()
    return dens, loss.item(), p.grad.numpy()


@pytest.mark.parametrize("n, L", [(14, 2), (15, 2), (16, 2), (21, 2), (22, 2),
                                  (23, 1)])
def test_cnot_ring_matches_jax(n, L):
    """n = 14: both cross gates through dual_multi; 15, 16: span views over
    a 1- and 2-bit group 2; 21: X = 128 group 2 and a 7-bit top group; 22:
    the merged (hpair) top; 23: a lone block on the 4-wide top group (one
    layer, to keep the test short)."""
    params = _params(n, L, seed=2200 + n)
    want_d, want_v, want_g = _jax_run(n, L, params)
    got_d, got_v, got_g = _torch_run(n, L, params)
    assert len(got_d) == len(want_d) == n
    np.testing.assert_allclose(np.stack(got_d), np.stack(want_d), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5 * n)
    assert got_g.shape == (L, n, 3)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=ATOL)
    assert np.abs(want_g).max() > 0.1


@pytest.mark.parametrize("n", [14, 15, 16])
def test_one_layer_closed_form(n):
    """params (alpha, 0, 0): the ring's CNOTs make <Z_k> = prod_{j <= k}
    cos alpha_j for k < n - 1, and the closing CNOT (control 0) gives
    <Z_{n-1}> = prod_{j >= 1} cos alpha_j; beta and gamma get no gradient."""
    alpha = np.linspace(-1.3, 1.4, n).astype(np.float32)
    p = torch.zeros(1, n, 3)
    p[0, :, 0] = torch.from_numpy(alpha)
    p.requires_grad_(True)
    loss = THEA(n, 1, entangler="cnot", device="cpu").magnetization(p)
    loss.backward()
    a = torch.from_numpy(alpha.astype(np.float64)).requires_grad_(True)
    z = torch.cat([torch.cumprod(torch.cos(a), 0)[:n - 1],
                   torch.prod(torch.cos(a[1:]))[None]])
    z.sum().backward()
    np.testing.assert_allclose(loss.item(), z.sum().item(), rtol=0, atol=1e-5 * n)
    np.testing.assert_allclose(p.grad[0, :, 0].numpy(), a.grad.numpy(), rtol=0,
                               atol=1e-5)
    assert p.grad[0, :, 1:].abs().max().item() <= 1e-6


@pytest.mark.parametrize("n", range(14, 31))
def test_every_size_passes_the_cnot_support_check(n):
    """The CNOT ring's layer program runs at every n the plane layout
    holds, forward and backward: no plan item is refused, and every cross
    gate is a dcross item."""
    m = THEA(n, 1, entangler="cnot", device="cpu")
    kinds = [item[0] for item in tps.plane_program(m._layer_ftape)]
    assert set(kinds) <= {"dense", "dcross", "hpair"}, kinds
    # one per group boundary and the ring's closing gate
    assert kinds.count("dcross") == (n + 6) // 7
