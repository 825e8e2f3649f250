"""The port's ``AutoGradCircuit.build()`` against the JAX package's.

CPU-only: the port runs with ``device="cpu"`` (its kernels' plain
versions), the JAX package on its CPU backend; both get the same seeded
numpy gates (``convert.gates_from_jax``).

* the reference's gauntlet tape (tests/test_autodiff.py: every instruction
  kind, mid-circuit densities, non-unitary gates) at n = 14 on both plane
  tapes (``set_plane_engine(True)``; the JAX kernels in interpret mode, its
  pair grams in "f32"): densities and gradients within 2e-5 max(1, |x|);
  n = 15, 16 in tests/test_torch_tape_planes.py, n = 21-23 against the JAX
  XLA engine in tests/test_torch_tape_xla*.py;
* the specs of tests/test_autodiff.py at complex128 on the port's fused
  and per-gate engines: the 8th-order finite-difference gauntlet below
  1e-9, the custom adjoint vs plain torch autograd, zero gradients for
  trailing var gates, the initial-state gradient;
* the specs of tests/test_circuit_ghz.py, QFT on basis states, and a tape
  with ``mdiag`` and ``xcross`` items both ways against the fused engine.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import oracles
from test_autodiff import av_tsallis, build_gauntlet, gauntlet_gates

from dqc_tpu import AutoGradCircuit as JCircuit
from dqc_tpu import config as jconfig
from dqc_tpu.circuit.ir import InstrKind
from dqc_tpu.ops import gates as JG

from dqc_tpu_torch import GHZ, QFT, AutoGradCircuit, config, convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.autograd import run_tape, tape_forward
from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.ops import statevector as sv

torch.set_num_threads(2)

TOL = 2e-5
C128 = torch.complex128


def port_circuit(jc, dtype=torch.complex64) -> AutoGradCircuit:
    """The port's circuit with the JAX circuit's instructions, through the
    port's builder methods."""
    c = AutoGradCircuit(jc.n, dtype=dtype, device="cpu")
    for inst in jc.tape.instructions:
        if inst.kind is InstrKind.GATE:
            c.add_gate(inst.positions, var=inst.var, unitary=inst.unitary)
        elif inst.kind is InstrKind.DIAG:
            c.add_diag_gate(inst.positions, var=inst.var, unitary=inst.unitary)
        else:
            c.get_dens_op(inst.positions, with_grad=inst.diff)
    return c


def tsallis(dens):
    return sum((1 - torch.einsum("ij,ji->", d, d)).real for d in dens) / len(dens)


def assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    bar = TOL * np.maximum(1.0, np.abs(want))
    assert np.all(err <= bar), f"{what}: max err {err.max():.3e}"


def gauntlet_parity(n: int, jax_plane: bool):
    """Densities and gradients of the gauntlet (2 layers) through the
    port's plane tape vs the JAX package: its plane tape in interpret mode
    (``jax_plane``), or its XLA engine at complex128."""
    rng = np.random.default_rng(42)
    jc = build_gauntlet(n, 2)
    cg = [np.asarray(g) for g in gauntlet_gates(rng, n, 2, var=False)]
    vg = [np.asarray(g) for g in gauntlet_gates(rng, n, 2, var=True)]
    jdt = jnp.complex64 if jax_plane else jnp.complex128
    jref = JCircuit(n, dtype=jdt)
    jref.tape = jc.tape
    jconfig.set_gram_kernel_dot_mode("f32")
    jconfig.set_plane_engine(jax_plane)
    try:
        _, jrun = jref.build()
        jvg = [jnp.asarray(g, jdt) for g in vg]
        jcg = [jnp.asarray(g, jdt) for g in cg]

        def loss_and_densities(a, b):
            dens = jrun(a, b)
            return av_tsallis(lambda *_: dens)(a, b), dens

        (want_v, want_dens), want_g = jax.value_and_grad(
            loss_and_densities, has_aux=True)(jvg, jcg)
    finally:
        jconfig.set_plane_engine("auto")
        jconfig.set_gram_kernel_dot_mode("auto")
    c = port_circuit(jc)
    ftape = fuse_tape(c.tape)
    kinds = {item[0] for item in tps.plane_program(ftape)}
    t_vg, t_cg, _ = convert.gates_from_jax(vg, cg, device="cpu")
    for g in t_vg:
        g.requires_grad_(True)
    # both packages' pair grams in "f32" (their default is "bf16x3")
    config.set_gram_kernel_dot_mode("f32")
    config.set_plane_engine(True)
    try:
        _, run = c.build()
        dens = run(t_vg, t_cg)
    finally:
        config.set_plane_engine("auto")
    try:
        loss = tsallis(dens)
        loss.backward()
    finally:
        config.set_gram_kernel_dot_mode("auto")
    assert_close(torch.stack(dens[:n]).detach().numpy(),
                 np.stack([np.asarray(d) for d in want_dens[:n]]), "1q densities")
    assert_close(loss.item(), float(want_v), "loss")
    # torch's gradient of a complex tensor is the conjugate of JAX's cotangent
    for i, (t, w) in enumerate(zip(t_vg, want_g)):
        assert_close(t.grad.conj().resolve_conj().numpy(), np.asarray(w),
                     f"gradient {i}")
    return kinds


def test_gauntlet_plane_tape_n14_matches_jax():
    """n = 14: the gauntlet's program holds mid-circuit densities, cross
    gates and variable diagonal runs (dens, dcross, ddual items)."""
    kinds = gauntlet_parity(14, jax_plane=True)
    assert {"dens", "dcross", "ddual"} <= kinds, kinds


# ---------------------------------------------------------------------------
# tests/test_autodiff.py's specs at complex128 (fused and per-gate engines)
# ---------------------------------------------------------------------------

def _gauntlet_c128(n, layers, seed):
    rng = np.random.default_rng(seed)
    jc = build_gauntlet(n, layers)
    cg = [np.asarray(g) for g in gauntlet_gates(rng, n, layers, var=False)]
    vg = [np.asarray(g) for g in gauntlet_gates(rng, n, layers, var=True)]
    return rng, port_circuit(jc, C128), vg, cg


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_gate"])
def test_finite_difference_gauntlet(fused):
    """The reference's directional-derivative check: 8th-order central
    finite difference vs the adjoint, relative error below 1e-9 (complex128,
    n = 7, 2 layers)."""
    n, layers, eta = 7, 2, 1e-6
    rng, c, vg, cg = _gauntlet_c128(n, layers, 42)
    pert = [rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape) for g in vg]
    _, run = c.build(fused=fused)

    def at(t):
        with torch.no_grad():
            return tsallis(run([g + t * p for g, p in zip(vg, pert)], cg)).item()

    coeffs = {4: -1 / 280, 3: 4 / 105, 2: -1 / 5, 1: 4 / 5}
    ds_fd = sum(c8 * (at(m * eta) - at(-m * eta)) for m, c8 in coeffs.items()) / eta
    tv = [torch.tensor(g, requires_grad=True) for g in vg]
    tsallis(run(tv, cg)).backward()
    # d loss(g + t p)/dt = Re sum(conj(grad) p) with torch's conjugate gradient
    ds_ad = sum(float(np.real(np.sum(np.conj(t.grad.numpy()) * p)))
                for t, p in zip(tv, pert))
    rel = abs(ds_ad - ds_fd) / min(abs(ds_ad), abs(ds_fd))
    assert rel < 1e-9, f"relative error {rel}"


@pytest.mark.parametrize("engine", [tape_forward, "fused"], ids=["per_gate", "fused"])
def test_custom_adjoint_matches_plain_autograd(engine):
    """The O(1)-memory adjoints (per gate and fused) agree with torch
    autograd through the plain per-gate run, for the gates and the initial
    state (n = 5, 2 layers, complex128)."""
    n = 5
    _, c, vg, cg = _gauntlet_c128(n, 2, 3)
    tape = c.tape
    psi0 = torch.tensor(oracles.random_state(np.random.default_rng(4), n),
                        dtype=C128)
    psi0 = psi0 / torch.linalg.norm(psi0)

    def grads(fn):
        s = psi0.clone().requires_grad_(True)
        v = [torch.tensor(g, requires_grad=True) for g in vg]
        loss = sum((1 - torch.einsum("ij,ji->", d, d)).real for d in fn(s, v))
        loss.backward()
        # plain autograd leaves the trailing gates (after the last diff
        # density) out of the graph: their gradient is zero
        return s.grad, [torch.zeros_like(t) if t.grad is None else t.grad
                        for t in v]

    if engine == "fused":
        ftape = fuse_tape(tape)
        custom = grads(lambda s, v: fused_tape_forward(ftape, s, v, cg))
    else:
        custom = grads(lambda s, v: tape_forward(tape, s, v, cg))
    plain = grads(lambda s, v: run_tape(tape, s, v, cg, only_diff=True)[0])
    torch.testing.assert_close(custom[0], plain[0], rtol=1e-10, atol=1e-10)
    for a, b in zip(custom[1], plain[1]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("layers", [2, 8])
def test_per_gate_adjoint_keeps_two_states(layers):
    """What ``build(fused=False)`` keeps for its backward: the per-gate
    adjoint saves the state at the last diff density and the initial state
    (plus the var gates) whatever the depth, where plain autograd through
    the same run saves at least one state per layer (n = 8, complex128)."""
    n = 8
    rng = np.random.default_rng(5)
    c = AutoGradCircuit(n, dtype=C128, device="cpu")
    for _ in range(layers):
        for q in range(n):
            c.add_q1_var_gate(q)
        for q in range(n - 1):
            c.add_q2_const_gate_diag(q, q + 1)
    c.get_q1_dens_op_with_grad(0)
    vg = [torch.tensor(oracles.random_unitary(rng, 1).reshape(-1), dtype=C128,
                       requires_grad=True) for _ in range(layers * n)]
    cg = layers * (n - 1) * [np.array([1, 1, 1, -1], dtype=np.complex128)]
    psi0 = torch.zeros(1 << n, dtype=C128)
    psi0[0] = 1

    def saved_bytes(fn):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
        return total[0]

    state_bytes = psi0.numel() * psi0.element_size()
    gate_bytes = sum(t.numel() * t.element_size() for t in vg)
    assert saved_bytes(lambda: tape_forward(c.tape, psi0, vg, cg)) \
        == 2 * state_bytes + gate_bytes
    plain = saved_bytes(lambda: run_tape(c.tape, psi0, vg, cg, only_diff=True))
    assert plain >= layers * state_bytes


@pytest.mark.parametrize("plane", [False, True], ids=["fused", "plane"])
def test_trailing_var_gates_zero_grad(plane):
    """Var gates after the last diff density get exactly zero gradient (the
    fused engine at n = 4, complex128; the plane tape at n = 14, where the
    trailing gates are only uncomputed)."""
    n = 14 if plane else 4
    dtype = torch.complex64 if plane else C128
    rng = np.random.default_rng(11)
    c = AutoGradCircuit(n, dtype=dtype, device="cpu")
    c.add_q1_var_gate(0)
    c.get_q1_dens_op_with_grad(0)
    c.add_q1_var_gate(1)          # trailing: no diff density after it
    c.add_q2_var_gate(2, 1)       # trailing
    gates = [oracles.random_unitary(rng, 1), oracles.random_unitary(rng, 1),
             oracles.random_unitary(rng, 2)]
    vg = [torch.tensor(g.reshape(-1), dtype=dtype, requires_grad=True) for g in gates]
    config.set_plane_engine(plane)
    try:
        _, run = c.build()
        d = run(vg, [])[0]
    finally:
        config.set_plane_engine("auto")
    torch.einsum("ij,ji->", d, d).real.backward()
    assert vg[0].grad.abs().max().item() > 1e-3
    assert torch.equal(vg[1].grad, torch.zeros_like(vg[1]))
    assert torch.equal(vg[2].grad, torch.zeros_like(vg[2]))


@pytest.mark.parametrize("engine", ["per_gate", "fused", "plane"])
def test_initial_state_gradient(engine):
    """d(loss)/d(initial state) of each adjoint vs plain autograd (n = 3 at
    complex128; n = 14 at complex64 on the plane tape)."""
    n = 14 if engine == "plane" else 3
    dtype = torch.complex64 if engine == "plane" else C128
    rng = np.random.default_rng(9)
    c = AutoGradCircuit(n, dtype=dtype, device="cpu")
    c.add_q1_const_gate(0)
    c.add_q2_const_gate(n - 1, 1)
    c.get_q1_dens_op_with_grad(2)
    c.get_q2_dens_op_with_grad(0, n - 1)
    cg = [oracles.random_unitary(rng, 1).reshape(-1).astype(np.complex128),
          oracles.random_unitary(rng, 2).reshape(-1).astype(np.complex128)]
    if dtype == torch.complex64:
        cg = [g.astype(np.complex64) for g in cg]
    psi0 = torch.tensor(oracles.random_state(rng, n), dtype=dtype)
    psi0 = psi0 / torch.linalg.norm(psi0)
    ftape = fuse_tape(c.tape)
    fn = {"per_gate": lambda s: tape_forward(c.tape, s, (), cg),
          "fused": lambda s: fused_tape_forward(ftape, s, (), cg),
          "plane": lambda s: tps.plane_tape_forward(ftape, s, (), cg)}[engine]

    def grad(f):
        s = psi0.clone().requires_grad_(True)
        sum(torch.einsum("ij,ji->", d, d).real for d in f(s)).backward()
        return s.grad

    want = grad(lambda s: run_tape(c.tape, s, (), cg, only_diff=True)[0])
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == C128 else dict(rtol=0, atol=1e-5)
    torch.testing.assert_close(grad(fn), want, **tol)


# ---------------------------------------------------------------------------
# tests/test_circuit_ghz.py's specs, QFT, and the >2-group items
# ---------------------------------------------------------------------------

def _ghz_circuit(n, dtype=C128):
    c = AutoGradCircuit(n, dtype=dtype, device="cpu")
    c.add_q1_const_gate(0)
    for i in range(n - 1):
        c.get_q2_dens_op_with_grad(i, i + 1)
    for i in range(n):
        c.get_q1_dens_op_with_grad(i)
    for i in range(n - 1):
        c.add_q2_const_gate(i, i + 1)
    for i in range(n):
        c.get_q1_dens_op(i)
    for i in range(n - 1):
        c.get_q2_dens_op(i, i + 1)
    return c


def _ghz_gates(n):
    return ([np.asarray(JG.hadamard(jnp.complex128)).reshape(-1)]
            + (n - 1) * [np.asarray(JG.cnot(jnp.complex128)).reshape(-1)])


def test_ghz_contract_and_densities():
    """simple_run returns every density, autodiff_run the diff ones, and the
    densities are the GHZ preparation's known values (as the JAX test)."""
    n = 12
    simple_run, autodiff_run = _ghz_circuit(n).build()
    all_dens = simple_run([], _ghz_gates(n))
    diff_dens = autodiff_run([], _ghz_gates(n))
    assert len(all_dens) == 2 * n + 2 * (n - 1)
    assert len(diff_dens) == n + (n - 1)
    for lhs, rhs in zip(all_dens[: n + (n - 1)], diff_dens):
        torch.testing.assert_close(lhs, rhs, rtol=0, atol=1e-12)
    psi01 = np.array([1 / np.sqrt(2), 0, 1 / np.sqrt(2), 0])
    np.testing.assert_allclose(all_dens[0].numpy(), np.outer(psi01, psi01),
                               atol=1e-12)
    zero2 = np.zeros((4, 4))
    zero2[0, 0] = 1
    for d in all_dens[1: n - 1]:
        np.testing.assert_allclose(d.numpy(), zero2, atol=1e-12)
    np.testing.assert_allclose(all_dens[n - 1].numpy(), np.full((2, 2), 0.5),
                               atol=1e-12)
    for d in all_dens[n: 2 * n - 1]:
        np.testing.assert_allclose(d.numpy(), np.diag([1.0, 0.0]), atol=1e-12)
    for d in all_dens[2 * n - 1: 3 * n - 1]:
        np.testing.assert_allclose(d.numpy(), np.eye(2) / 2, atol=1e-12)
    ghz2 = np.zeros((4, 4))
    ghz2[0, 0] = ghz2[3, 3] = 0.5
    for d in all_dens[3 * n - 1:]:
        np.testing.assert_allclose(d.numpy(), ghz2, atol=1e-12)


@pytest.mark.parametrize("n, dtype, atol", [(10, C128, 1e-12),
                                            (16, torch.complex64, 1e-6)])
def test_ghz_final_state(n, dtype, atol):
    """build_state_fn gives (|0..0> + |1..1>) / sqrt 2; the GHZ model's
    densities (through build(), the plane tape at n = 16) are I / 2."""
    g = GHZ(n, dtype=dtype, device="cpu")
    want = np.zeros(1 << n, dtype=complex)
    want[0] = want[-1] = 1 / np.sqrt(2)
    np.testing.assert_allclose(g.state().numpy(), want, atol=atol)
    assert g.fidelity() >= 1 - 10 * atol
    config.set_plane_engine(True)
    try:
        dens = GHZ(n, dtype=dtype, device="cpu").densities()
    finally:
        config.set_plane_engine("auto")
    for d in dens:
        np.testing.assert_allclose(d.numpy(), np.eye(2) / 2, atol=atol)


def test_arity_validation():
    n = 3
    simple_run, _ = _ghz_circuit(n).build()
    with pytest.raises(ValueError):
        simple_run([], _ghz_gates(n)[:-1])
    with pytest.raises(ValueError):
        simple_run([np.zeros(4)], _ghz_gates(n))
    with pytest.raises(ValueError):
        simple_run([], _ghz_gates(n)[:-1] + [torch.zeros(3, dtype=C128)])


@pytest.mark.parametrize("n, x", [(6, 5), (9, 300)])
def test_qft_on_basis_states(n, x):
    """QFT|x> matches exp(2 pi i x y / 2^n) / sqrt(2^n) (complex128)."""
    q = QFT(n, dtype=C128, device="cpu")
    np.testing.assert_allclose(q.apply_to_basis_state(x).numpy(), q.exact(x),
                               atol=1e-12)


def _multi_group_tape(n):
    """A variable 3-qubit diagonal over three groups (mdiag) and a variable
    dense 3-qubit gate over three groups (xcross), among dense blocks and
    mid-circuit densities."""
    c = AutoGradCircuit(n, device="cpu")
    for q in (0, 3, 8, n - 1):
        c.add_q1_var_gate(q)
    c.get_q2_dens_op_with_grad(8, 0)
    c.add_diag_gate((0, 8, n - 1), var=True)
    c.add_q1_var_gate(9)
    c.get_dens_op((n - 1, 3), with_grad=True)
    c.add_gate((3, 9, n - 2), var=True, unitary=False)
    c.add_q1_var_gate(1)
    c.get_q1_dens_op_with_grad(1)
    c.get_q2_dens_op_with_grad(9, 3)
    c.get_dens_op((n - 2, 3, 9), with_grad=True)
    return c


def test_mdiag_and_xcross_both_ways():
    """The >2-group items run forward and backward on the plane tape (plain
    torch on the planes) and agree with the fused engine at n = 17:
    densities and gradients within 2e-5 max(1, |x|)."""
    n = 17
    c = _multi_group_tape(n)
    ftape = fuse_tape(c.tape)
    kinds = [item[0] for item in tps.plane_program(ftape)]
    assert "mdiag" in kinds and "xcross" in kinds, kinds
    rng = np.random.default_rng(17)
    gates = []
    for inst in c.tape.gates(var=True):
        d = 1 << inst.k
        if inst.kind.name == "DIAG":
            gates.append(np.exp(1j * rng.uniform(0, 6.3, d)))
        else:
            g = oracles.random_unitary(rng, inst.k)
            if not inst.unitary:
                g = g + 0.01 * oracles.random_gate(rng, inst.k)
            gates.append(g.reshape(-1))
    gates = [g.astype(np.complex64) for g in gates]
    out = []
    for engine in (tps.plane_tape_forward, fused_tape_forward):
        vg = [torch.tensor(g, requires_grad=True) for g in gates]
        dens = engine(ftape, c.initial_state(), vg, ())
        tsallis(dens).backward()
        out.append(([d.detach() for d in dens], [v.grad for v in vg]))
    for a, b in zip(out[0][0], out[1][0]):
        assert_close(a.numpy(), b.numpy(), "density")
    for i, (a, b) in enumerate(zip(out[0][1], out[1][1])):
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item()), i


def test_statevector_ops_match_the_oracles():
    """apply_gate / apply_diag / density / gate_grad of ops/statevector
    against the dense numpy oracles (n = 5, complex128)."""
    rng = np.random.default_rng(2)
    n = 5
    psi = oracles.random_state(rng, n)
    t = torch.tensor(psi)
    g = oracles.random_gate(rng, 2)
    d = rng.normal(size=4) + 1j * rng.normal(size=4)
    np.testing.assert_allclose(sv.apply_gate(t, g, (3, 1)).numpy(),
                               oracles.apply_oracle(psi, g, (3, 1)), atol=1e-12)
    np.testing.assert_allclose(sv.apply_diag(t, d, (0, 4)).numpy(),
                               oracles.apply_diag_oracle(psi, d, (0, 4)), atol=1e-12)
    np.testing.assert_allclose(sv.density(t, (2, 0)).numpy(),
                               oracles.density_oracle(psi, (2, 0)), atol=1e-12)
    b = torch.tensor(oracles.random_state(rng, n))
    want = np.einsum("pb,qb->pq", *(sv._qubits_to_front(x, (3, 1), n)[0].numpy()
                                    for x in (b, t)))
    np.testing.assert_allclose(sv.gate_grad(t, b, (3, 1)).numpy(), want, atol=1e-12)


@pytest.mark.parametrize("name, args", [
    ("hadamard", ()), ("pauli_x", ()), ("pauli_y", ()), ("pauli_z", ()),
    ("s_gate", ()), ("t_gate", ()), ("identity", (2,)), ("rx", (0.3,)),
    ("ry", (0.7,)), ("rz", (1.1,)), ("phase", (0.4,)), ("x_rotation", (0.2,)),
    ("cnot", ()), ("cz", ()), ("swap", ()), ("cz_diag", ()), ("zz", (0.6,)),
    ("cphase", (0.9,)),
])
def test_gate_library_matches_jax(name, args):
    """ops/gates against the JAX package's gate constructors (complex128)."""
    from dqc_tpu_torch.ops import gates as TG

    want = np.asarray(getattr(JG, name)(*args, dtype=jnp.complex128))
    got = getattr(TG, name)(*args, dtype=C128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-15)


def test_controlled_and_observables_match_jax():
    """gates.controlled, observables.pauli_matrix and fidelity against the
    JAX package; sample_counts of a GHZ state lands on |0..0> and |1..1>
    only, about half each."""
    from dqc_tpu.ops import observables as JO
    from dqc_tpu_torch.ops import gates as TG
    from dqc_tpu_torch.ops import observables as TO

    u = oracles.random_unitary(np.random.default_rng(0), 1)
    np.testing.assert_allclose(TG.controlled(torch.tensor(u), dtype=C128).numpy(),
                               np.asarray(JG.controlled(u, dtype=jnp.complex128)),
                               atol=1e-15)
    for s in ("ZX", "YIZ"):
        np.testing.assert_array_equal(TO.pauli_matrix(s, C128),
                                      JO.pauli_matrix(s, jnp.complex128))
    rng = np.random.default_rng(1)
    a, b = oracles.random_state(rng, 4), oracles.random_state(rng, 4)
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    np.testing.assert_allclose(TO.fidelity(torch.tensor(a), torch.tensor(b)).item(),
                               float(JO.fidelity(a, b)), rtol=1e-12)
    ghz = GHZ(6, dtype=C128, device="cpu").state()
    counts = TO.sample_counts(ghz, 4000, torch.Generator().manual_seed(2))
    assert counts.sum().item() == 4000 and counts[0] + counts[-1] == 4000
    assert 1800 <= counts[0].item() <= 2200
    assert sv.sample_bitstrings(ghz, torch.Generator().manual_seed(3), 10).dtype == torch.int32
