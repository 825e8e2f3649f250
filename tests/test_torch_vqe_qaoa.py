"""VQE-Ising and QAOA MaxCut of the port against the JAX package, on the CPU.

* the plain versions of the three kernel modes these models add against
  the JAX package's Pallas kernels in interpret mode: ``block_backward_dual``
  with ``diag_q`` (the Q reductions of a variable diagonal run, both run
  orders and both pair orders) and the density-seed modes (``conj`` with
  ``acc`` or fresh output) of ``dual_multi_apply`` and ``high_multi_apply``;
* ``groups.subblocks`` and the cross-group density against the JAX
  functions at n = 15 on four position pairs;
* ``diag_block_var_cts`` and ``_diag_cts_from_Q`` on a hand-built layer
  whose diagonal run holds a variable all-diagonal block;
* the edge densities, the value and the gradient of ``VQEIsing(n, 2,
  scan=True)`` at n = 14, 15, 16, 21, 22, 23, 24 and of ``QAOAMaxCut`` on
  the example's ``random_graph(n, n // 2, 0)`` at n = 14, 15, 21, 22
  against ``jax.value_and_grad`` of ``dqc_tpu``'s models (the XLA engine,
  complex64), with params carried by ``convert.params_from_jax``;
* every n in 14..30 passes both models' support checks (one ddual item
  with the variable run, dense and hpair sweeps otherwise);
* the closed forms: ``VQEIsing(n, 1)`` at params (gamma, 0) has
  E = -n cos^2(2 gamma), dE/dgamma = 2 n sin(4 gamma) = -dE/dbeta, and
  QAOA at params = 0 cuts half the edge weight with a zero gradient;
* the refusals that stay: ``scan=False``, the distributed energy.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: kernel planes 1e-5 absolute (sums of up to 4 x 128-term f32
products of O(1) values), Q reductions and pair grams 1e-5 of their largest
entry, densities, values and gradients 2e-5 max(1, |x|) (complex64 end to
end, summed in another order).
"""

import math
import sys
import time

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
from dqc_tpu.circuit.fused_autograd import diag_block_var_cts as j_diag_block_var_cts
from dqc_tpu.models.qaoa import QAOAMaxCut as JQAOA
from dqc_tpu.models.vqe_ising import VQEIsing as JVQE
from dqc_tpu.ops import groups as jgr
from dqc_tpu.ops.observables import expval_from_density as j_expval
from dqc_tpu.ops.pallas.block_backward import block_backward_dual
from dqc_tpu.ops.pallas.dual_apply import dual_multi_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_multi_apply_planes

from dqc_tpu_torch import convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.builder import AutoGradCircuit as TCircuit
from dqc_tpu_torch.circuit.fused_autograd import diag_block_var_cts
from dqc_tpu_torch.circuit.fusion import fuse_tape as tfuse_tape
from dqc_tpu_torch.circuit.scan import fuse_layer as tfuse_layer
from dqc_tpu_torch.models.qaoa import QAOAMaxCut as TQAOA
from dqc_tpu_torch.models.vqe_ising import VQEIsing as TVQE
from dqc_tpu_torch.ops import groups as tgr
from dqc_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)

PLANE_ATOL = 1e-5
REL = 1e-5
TOL = 2e-5
C64 = jnp.complex64


def random_graph(n, extra_edges, seed):
    """The example's graph (examples/example_qaoa_maxcut.py): a ring
    backbone plus ``extra_edges`` random chords."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)]
    while len(edges) < n + extra_edges:
        a, b = rng.integers(0, n, 2)
        if a != b and (min(a, b), max(a, b)) not in [tuple(sorted(e)) for e in edges]:
            edges.append((int(min(a, b)), int(max(a, b))))
    return edges


@pytest.fixture(autouse=True)
def _jax_f32_xla():
    """The JAX side's pair grams in "f32" (its "bf16x3" is not ported) and
    its models on the XLA engine (complex64)."""
    jconfig.set_gram_kernel_dot_mode("f32")
    jconfig.set_plane_engine(False)
    yield
    jconfig.set_plane_engine("auto")
    jconfig.set_gram_kernel_dot_mode("auto")


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _pair(c):
    return (np.ascontiguousarray(c.real, dtype=np.float32),
            np.ascontiguousarray(c.imag, dtype=np.float32))


def _phases(rng, shape):
    return _pair(np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64))


def _tables(rng, A):
    return (*_phases(rng, (128, 128)), *_phases(rng, (A, 128)),
            *_phases(rng, (A, 128)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PLANE_ATOL)


def _assert_rel(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * np.abs(w).max())


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    bar = TOL * np.maximum(1.0, np.abs(want))
    err = np.abs(got - want)
    assert np.all(err <= bar), (
        f"{what}: max err {err.max():.3e}, worst err/bar {(err / bar).max():.3f}")


# ---------------------------------------------------------------------------
# The kernel modes' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g0_first", [True, False])
@pytest.mark.parametrize("diag_first_fwd", [True, False])
def test_block_backward_dual_diag_q_matches_pallas(g0_first, diag_first_fwd):
    """The planes, both pair grams and the three Q reductions of a random
    run, with non-Hermitian operators: a transpose, a conjugation or an
    order slip shows."""
    rng = np.random.default_rng(2000 + 2 * g0_first + diag_first_fwd)
    A = 8
    planes = [*_pair(_cnormal(rng, (A, 128, 128))),
              *_pair(_cnormal(rng, (A, 128, 128)))]
    ops = [a for _ in range(4)
           for a in _pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    tinv, tfwd = _tables(rng, A), _tables(rng, A)
    want = block_backward_dual(*_j(planes), *_j(ops), g0_first=g0_first,
                               diag_inv_tables=_j(tinv), diag_tables=_j(tfwd),
                               diag_first_fwd=diag_first_fwd, diag_q=True,
                               dot_mode="f32", interpret=True)
    got = tk.block_backward_dual(
        *(_t(p) for p in planes), *(_t(o) for o in ops), g0_first=g0_first,
        diag_inv_tables=[_t(t) for t in tinv], diag_tables=[_t(t) for t in tfwd],
        diag_first_fwd=diag_first_fwd, diag_q=True)
    assert len(got) == len(want) == 14
    _assert_planes(got[:4], want[:4])
    _assert_rel(got[4:], want[4:])


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("mode", ["acc", "fresh"])
def test_dual_multi_apply_seed_matches_pallas(T, mode):
    """``[acc +] conj(sum_t Em_t X El_t^T)``, the input left intact."""
    rng = np.random.default_rng(2100 + 2 * T + (mode == "acc"))
    x = _pair(_cnormal(rng, (4, 128, 128)))
    acc = _pair(_cnormal(rng, (4, 128, 128))) if mode == "acc" else None
    el = _pair(_cnormal(rng, (T, 128, 128), (128 * T) ** -0.5))
    em = _pair(_cnormal(rng, (T, 128, 128), 128 ** -0.5))
    want = dual_multi_apply_planes(*_j(x), *_j(el), *_j(em), alias=False,
                                   conj=True, acc=None if acc is None else _j(acc),
                                   interpret=True)
    xt = [_t(a) for a in x]
    got = tk.dual_multi_apply(*xt, *(_t(a) for a in el), *(_t(a) for a in em),
                              alias=False, conj=True,
                              acc=None if acc is None else [_t(a) for a in acc])
    _assert_planes(got, want)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(xt, x))


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("mode", ["acc", "fresh"])
def test_high_multi_apply_seed_matches_pallas(T, mode):
    rng = np.random.default_rng(2200 + 2 * T + (mode == "acc"))
    shape = (2, 8, 16, 128)
    x = _pair(_cnormal(rng, shape))
    acc = _pair(_cnormal(rng, shape)) if mode == "acc" else None
    eh = _pair(_cnormal(rng, (T, 8, 8), (8 * T) ** -0.5))
    el = _pair(_cnormal(rng, (T, 128, 128), 128 ** -0.5))
    want = high_multi_apply_planes(*_j(x), *_j(eh), *_j(el), alias=False,
                                   conj=True, acc=None if acc is None else _j(acc),
                                   interpret=True)
    got = tk.high_multi_apply(*(_t(a) for a in x), *(_t(a) for a in eh),
                              *(_t(a) for a in el), alias=False, conj=True,
                              acc=None if acc is None else [_t(a) for a in acc])
    _assert_planes(got, want)


# ---------------------------------------------------------------------------
# Sub-blocks and the cross-group density
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positions", [(6, 7), (13, 14), (0, 14), (3, 9)])
def test_subblocks_and_cross_density_match_jax(positions):
    """The same bits in the same rows and columns as the JAX package's
    permutation-matrix form, and the same reduced density."""
    n = 15
    rng = np.random.default_rng(2300 + positions[0])
    psi = _cnormal(rng, 1 << n, 2 ** (-(n + 1) / 2))
    dims = jgr.group_dims(n)
    want = np.asarray(jgr.subblocks(jnp.asarray(psi).reshape(dims), positions, n))
    got = tgr.subblocks(_t(psi), positions, n).numpy()
    assert np.array_equal(got, want)
    xr, xi = _pair(psi.reshape(-1, 128, 128))
    want = np.asarray(jps._cross_density(*_j((xr, xi)), positions, n))
    got = tps._cross_density(_t(xr), _t(xi), positions, n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# A variable all-diagonal block inside a run
# ---------------------------------------------------------------------------

def test_diag_block_var_cts_matches_jax():
    """The prefix / suffix closure of an all-diagonal block whose gates
    are a const and two variable diagonals on one group."""
    g = 7
    layer = JCircuit(14)
    layer.add_q2_var_gate_diag(3, 5)
    layer.add_q2_const_gate_diag(1, 2)
    layer.add_q2_var_gate_diag(6, 0)
    fi = jfuse_tape(layer.tape).instructions[0]
    assert fi.all_diag and fi.has_var
    tlayer = TCircuit(14)
    tlayer.add_q2_var_gate_diag(3, 5)
    tlayer.add_q2_const_gate_diag(1, 2)
    tlayer.add_q2_var_gate_diag(6, 0)
    tfi = tfuse_tape(tlayer.tape).instructions[0]
    rng = np.random.default_rng(2400)
    var = [np.exp(1j * rng.uniform(0, 6, 4)).astype(np.complex64) for _ in range(2)]
    const = [np.exp(1j * rng.uniform(0, 6, 4)).astype(np.complex64)]
    W = _cnormal(rng, 128)
    from dqc_tpu.circuit.fused_autograd import _block_ops as j_block_ops
    from dqc_tpu_torch.circuit.fused_autograd import _block_ops as t_block_ops
    want = {}
    j_diag_block_var_cts(fi, j_block_ops(fi, var, const, g, C64), jnp.asarray(W),
                         var, const, g, C64, want)
    tvar = [_t(v) for v in var]
    got = {}
    diag_block_var_cts(tfi, t_block_ops(tfi, tvar, const, g, torch.complex64),
                       _t(W), tvar, const, g, torch.complex64, got)
    assert sorted(got) == sorted(want) == [0, 1]
    for q in want:
        np.testing.assert_allclose(got[q].numpy(), np.asarray(want[q]), rtol=1e-5,
                                   atol=1e-5)


# the ZZ pair of the variable all-diagonal block, per group, and the qubits
# of the layer's one-qubit gates (the dense blocks the run is folded into)
VAR_BLOCKS = {0: ((1, 2), (7,)), 1: ((8, 9), (0,)), 2: ((14, 15), (0, 7))}


def _var_block_run_layer(circ_cls, n, group):
    """A layer whose diagonal run, folded into the dual sweep, is a
    variable all-diagonal block on ``group`` (ZZ gates on a qubit pair of
    the group, both ways round), with one-qubit gates on the other minor
    groups."""
    (a, b), singles = VAR_BLOCKS[group]
    c = circ_cls(n)
    c.add_q2_var_gate_diag(a, b)
    c.add_q2_var_gate_diag(b, a)
    for q in singles:
        c.add_q1_var_gate(q)
    epi = circ_cls(n)
    for q in (0, 7, 14):
        epi.get_q1_dens_op_with_grad(q)
    pro = circ_cls(n)  # random one-qubit gates: every Q entry counts
    for q in range(n):
        pro.add_q1_const_gate(q)
    return c, epi, pro


@pytest.mark.parametrize("group", sorted(VAR_BLOCKS))
def test_var_diag_block_in_a_run_matches_jax(group):
    """The gradient of a layer whose ddual run holds a variable diagonal
    block: its cotangents close from the Q reductions (diag_block_var_cts
    through _diag_cts_from_Q: Qsl summed over the lanes for group 0, over
    the sublanes for group 1, the A rows for group 2) as in the JAX
    package."""
    n, L = 16, 2
    jl, je, jp = _var_block_run_layer(JCircuit, n, group)
    tl, te, tp = _var_block_run_layer(TCircuit, n, group)
    jf, jepi, jpro = jfuse_layer(jl.tape), jfuse_tape(je.tape), jfuse_tape(jp.tape)
    tf, tepi, tpro = tfuse_layer(tl.tape), tfuse_tape(te.tape), tfuse_tape(tp.tape)
    prog = tps.plane_program(tf)
    assert [it[0] for it in prog] == ["ddual"], prog
    (run_i,) = prog[0][1]
    assert tf.instructions[run_i].all_diag and tf.instructions[run_i].group == group
    rng = np.random.default_rng(2500 + group)
    zz = np.exp(1j * rng.uniform(0, 6, (2, L, 4))).astype(np.complex64)
    stacked = [zz[0], zz[1]] + [_unitary_stack(rng, L) for _ in VAR_BLOCKS[group][1]]
    pro_gates = tuple(_unitary_stack(rng, n))
    z = np.diag([1, -1]).astype(np.complex64)

    def jloss(*gates):
        d = jps.std_scan_with_epilogue(jpro, jf, jepi, pro_gates, gates, ())
        return sum(j_expval(dm, z) for dm in d)

    v, gj = jax.value_and_grad(jloss, argnums=tuple(range(len(stacked))))(
        *[jnp.asarray(s) for s in stacked])
    ts = [_t(s).requires_grad_(True) for s in stacked]
    d = tps.std_scan_with_epilogue(tpro, tf, tepi, pro_gates, tuple(ts), (),
                                   device="cpu")
    loss = sum(torch.einsum("ij,ji->", dm, _t(z)).real for dm in d)
    loss.backward()
    _assert_close(loss.item(), float(v), "value")
    for t, w in zip(ts, gj):
        # torch's gradient of a complex input is the conjugate of JAX's
        _assert_close(t.grad.resolve_conj().numpy(), np.conj(np.asarray(w)),
                      "gate cotangent")


def _unitary_stack(rng, L):
    out = []
    for _ in range(L):
        q, _ = np.linalg.qr(_cnormal(rng, (2, 2)).astype(np.complex128))
        out.append(q.astype(np.complex64).reshape(-1))
    return np.stack(out)


# ---------------------------------------------------------------------------
# The models against jax.value_and_grad
# ---------------------------------------------------------------------------

def _jax_value_densities_grad(jm, loss_of):
    """One jitted value_and_grad of the JAX model's loss, with its
    densities."""
    def f(params):
        d = jps.std_scan_with_epilogue(jm._pro_ftape, jm._layer_ftape, jm._epi_ftape,
                                       tuple(jm._const_gates), jm._stacked_gates(params),
                                       (), dtype=jm.dtype)
        return loss_of(d), d
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _vqe_loss(jm):
    return lambda d: sum(j_expval(dm, jm.h) for dm in d)


def _qaoa_loss(jm):
    def loss(d):
        cut = 0.0
        for dm, w in zip(d, jm.weights):
            cut = cut + float(w) * (1.0 - j_expval(dm, jm._zz)) / 2.0
        return -cut
    return loss


def _check_model(jm, loss_of, t_loss, t_dens, seed):
    """Densities, value and gradient of the port's model (``t_loss``,
    ``t_dens``) against the JAX model's at N(0, 1) params from ``seed``;
    returns the largest gradient difference."""
    if not hasattr(jm, "_pro_ftape"):
        jm._densities(jnp.zeros(2 * jm.layers))  # builds the JAX prologue tape
    p = np.random.default_rng(seed).standard_normal(2 * jm.layers).astype(np.float32)
    (v, dj), gj = _jax_value_densities_grad(jm, loss_of(jm))(jnp.asarray(p))
    pt = convert.params_from_jax(p, device="cpu").requires_grad_(True)
    dt = t_dens(pt)
    _assert_close(torch.stack([d.detach() for d in dt]).numpy(),
                  np.stack([np.asarray(d) for d in dj]), "densities")
    loss = t_loss(pt)
    loss.backward()
    _assert_close(loss.item(), float(v), "value")
    _assert_close(pt.grad.numpy(), np.asarray(gj), "gradient")
    return np.abs(pt.grad.numpy() - np.asarray(gj)).max()


def _vqe_case(n):
    jm, tm = JVQE(n, 2, scan=True), TVQE(n, 2, scan=True, device="cpu")
    return _check_model(jm, _vqe_loss, tm.energy, tm.densities, 2600 + n)


def _qaoa_case(n):
    edges = random_graph(n, n // 2, 0)
    jm = JQAOA(n, edges, layers_number=2, scan=True)
    tm = TQAOA(n, edges, layers_number=2, scan=True, device="cpu")
    return _check_model(jm, _qaoa_loss, tm.loss,
                        lambda p: tm._densities(p, tk.KERNELS), 2700 + n)


# Marked slow for Tier-1's time: VQE at n = 23 (the X = 512 merged top; [22]
# runs VQE's program on a merged top, test_torch_merged_diag.py's
# test_magnetization_grad_matches_jax[23-False-*] the X = 512 one) and QAOA at
# n = 22 ([21] runs QAOA's program, VQE [22] the merged top's seeds and Q).
@pytest.mark.parametrize("n", [14, 15, 16, 21, 22, pytest.param(23, marks=pytest.mark.slow),
                               24])
def test_vqe_matches_jax_value_and_grad(n):
    _vqe_case(n)


@pytest.mark.parametrize("n", [14, 15, 21, pytest.param(22, marks=pytest.mark.slow)])
def test_qaoa_matches_jax_value_and_grad(n):
    _qaoa_case(n)


# ---------------------------------------------------------------------------
# Closed forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [14, 15, 16])
def test_vqe_closed_form(n):
    """One layer at params (gamma, 0) from |+>^n: every ZZ acts on the
    product state alone, so E = -n cos^2(2 gamma) with dE/dgamma =
    2 n sin(4 gamma) and dE/dbeta = -2 n sin(4 gamma)."""
    gamma = 0.37
    m = TVQE(n, 1, scan=True, device="cpu")
    p = torch.tensor([gamma, 0.0], requires_grad=True)
    e = m.energy(p)
    e.backward()
    s = 2 * n * math.sin(4 * gamma)
    assert abs(e.item() + n * math.cos(2 * gamma) ** 2) <= 1e-5 * n
    assert abs(p.grad[0].item() - s) <= 3e-5 * n
    assert abs(p.grad[1].item() + s) <= 3e-5 * n


@pytest.mark.parametrize("n", [14, 15, 16])
def test_qaoa_zero_params_cut_half(n):
    """params = 0 leaves |+>^n: <ZZ> = 0 on every edge, so the cut is half
    the edge weight and the gradient is exactly 0."""
    edges = random_graph(n, n // 2, 0)
    w = np.linspace(0.5, 1.5, len(edges))
    m = TQAOA(n, edges, weights=w, layers_number=3, device="cpu")
    p = torch.zeros(6, requires_grad=True)
    c = m.expected_cut(p)
    c.backward()
    assert abs(c.item() - w.sum() / 2) <= 1e-5 * len(edges)
    assert p.grad.abs().max().item() <= 1e-5


@pytest.mark.parametrize("model", ["vqe", "qaoa"])
@pytest.mark.parametrize("n", range(14, 31))
def test_every_size_passes_the_support_check(n, model):
    """Both models' programs run forward and backward at every n the plane
    layout holds: one ddual item carries every cost gate across a group
    boundary (the variable run, Q from block_backward_dual), the rest are
    dense and hpair sweeps; no density or seed is refused."""
    if model == "vqe":
        m = TVQE(n, 3, device="cpu")
    else:
        m = TQAOA(n, random_graph(n, n // 2, 0), layers_number=3, device="cpu")
    prog = tps.plane_program(m._layer_ftape)
    assert [item[0] for item in prog].count("ddual") == 1, prog
    assert {item[0] for item in prog} <= {"ddual", "dense", "hpair"}, prog
    run = next(item[1] for item in prog if item[0] == "ddual")
    assert tps._run_has_var(run, m._layer_ftape)


# ---------------------------------------------------------------------------
# What stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda: TVQE(14, 2, device="cpu"),
    lambda: TVQE(14, 5, scan=False, device="cpu"),
    lambda: TQAOA(14, random_graph(14, 7, 0), layers_number=2, device="cpu"),
], ids=["vqe_default_2L", "vqe_scan_false", "qaoa_default_2L"])
def test_unrolled_models_name_the_tape_path(build):
    """The unrolled models (``scan=False``, or fewer than three layers
    without ``scan``) run their reference-compatible circuit through
    ``AutoGradCircuit.build``'s engine and agree with the same model in scan
    mode: value and gradient within 2e-5 max(1, |x|)."""
    m = build()
    assert not m.scan
    p = (0.3 * torch.randn(2 * m.layers, generator=torch.Generator().manual_seed(5))
         ).requires_grad_(True)
    loss = m.energy if isinstance(m, TVQE) else m.loss
    v = loss(p)
    v.backward()
    m.scan = True
    p2 = p.detach().clone().requires_grad_(True)
    v2 = loss(p2)
    v2.backward()
    assert abs(v.item() - v2.item()) <= 2e-5 * max(1.0, abs(v2.item()))
    assert (p.grad - p2.grad).abs().max().item() <= 2e-5 * max(
        1.0, p2.grad.abs().max().item())


def test_distributed_energy_names_parallel():
    with pytest.raises(NotImplementedError, match="parallel/"):
        TVQE(14, 3, device="cpu").build_distributed_energy(None)


if __name__ == "__main__":
    # measured parity per case, for the record
    jconfig.set_gram_kernel_dot_mode("f32")
    jconfig.set_plane_engine(False)
    for name, case, sizes in (("vqe", _vqe_case, [14, 15, 16, 21, 22, 23, 24]),
                              ("qaoa", _qaoa_case, [14, 15, 21, 22])):
        for n in sizes:
            t0 = time.perf_counter()
            err = case(n)
            print(f"{name} n={n}: max |grad - jax| {err:.2e} "
                  f"({time.perf_counter() - t0:.1f} s)")
    sys.exit(0)
