"""Scan mode off the planes, and scans from an arbitrary state, against the
JAX package on the CPU.

* ``VQEIsing(10, 6)``, ``HardwareEfficientAnsatz(10, 4, "cz")``,
  ``HardwareEfficientAnsatz(10, 3, "cnot")`` and ``QAOAMaxCut(10, ..., 3)``
  in scan mode (below the plane size: ``std_scan_with_epilogue``'s
  fallback, ``scan.scanned_layers`` and the fused epilogue) against the
  JAX models' own scan mode (its XLA scan): values and gradients at
  complex64; ``HardwareEfficientAnsatz(14, 3)`` and ``VQEIsing(15, 3)`` at
  complex128; the cz ring at n = 14 under ``set_plane_engine(False)`` in
  both packages;
* ``scan_with_epilogue`` from a random normalised state at n = 14 and 15,
  by the port's three routes (the fused plane op ``plane_scan_densities``,
  ``plane_scanned_layers`` composed with ``plane_density_epilogue``, and
  the off-plane engines), against the JAX plane engine in interpret mode:
  densities, the gate gradients and the state gradient (torch's gradient
  of a complex tensor is the conjugate of the JAX package's cotangent);
* ``scanned_layers``' adjoint keeps two states and the gates whatever the
  depth.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 max(1, |x|) at complex64 (the same functions summed in
another order), 1e-10 max(1, |x|) at complex128.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.models.qaoa import QAOAMaxCut as JQAOA
from dqc_tpu.models.vqe_ising import VQEIsing as JVQE

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit import scan as tscan
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.models.qaoa import QAOAMaxCut as TQAOA
from dqc_tpu_torch.models.vqe_ising import VQEIsing as TVQE

torch.set_num_threads(2)

TOL64 = 2e-5
TOL128 = 1e-10


@pytest.fixture(autouse=True)
def _configs():
    """Both packages' plane-engine modes restored, their pair grams in
    "f32" (their default is "bf16x3")."""
    jconfig.set_gram_kernel_dot_mode("f32")
    config.set_gram_kernel_dot_mode("f32")
    yield
    jconfig.set_plane_engine("auto")
    jconfig.set_gram_kernel_dot_mode("auto")
    config.set_gram_kernel_dot_mode("auto")
    config.set_plane_engine("auto")


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"{what}: max err {err.max():.3e} > {tol:.0e}"


def _graph(n):
    rng = np.random.default_rng(0)
    edges = [(i, (i + 1) % n) for i in range(n)]
    while len(edges) < n + n // 2:
        a, b = sorted(int(v) for v in rng.integers(0, n, 2))
        if a != b and (a, b) not in edges and (b, a) not in edges:
            edges.append((a, b))
    return edges


MODELS = {
    # name: (JAX model, port model, loss, params shape)
    "vqe10_6": (lambda dt: JVQE(10, 6, dtype=dt), lambda dt: TVQE(10, 6, dtype=dt, device="cpu"),
                "energy", (12,)),
    "hea10_4_cz": (lambda dt: JHEA(10, 4, "cz", dtype=dt),
                   lambda dt: THEA(10, 4, "cz", dtype=dt, device="cpu"),
                   "magnetization", (4, 10, 3)),
    "hea10_3_cnot": (lambda dt: JHEA(10, 3, "cnot", dtype=dt),
                     lambda dt: THEA(10, 3, "cnot", dtype=dt, device="cpu"),
                     "magnetization", (3, 10, 3)),
    "qaoa10_3": (lambda dt: JQAOA(10, _graph(10), layers_number=3, dtype=dt),
                 lambda dt: TQAOA(10, _graph(10), layers_number=3, dtype=dt, device="cpu"),
                 "loss", (6,)),
    "hea14_3": (lambda dt: JHEA(14, 3, dtype=dt),
                lambda dt: THEA(14, 3, dtype=dt, device="cpu"),
                "magnetization", (3, 14, 3)),
    "vqe15_3": (lambda dt: JVQE(15, 3, dtype=dt), lambda dt: TVQE(15, 3, dtype=dt, device="cpu"),
                "energy", (6,)),
    "hea14_3_cz": (lambda dt: JHEA(14, 3, "cz", dtype=dt),
                   lambda dt: THEA(14, 3, "cz", dtype=dt, device="cpu"),
                   "magnetization", (3, 14, 3)),
}


def _check_model(name, complex128, seed):
    make_j, make_t, loss, shape = MODELS[name]
    jdt, tdt = ((jnp.complex128, torch.complex128) if complex128
                else (jnp.complex64, torch.complex64))
    rdt = np.float64 if complex128 else np.float32
    jm, tm = make_j(jdt), make_t(tdt)
    assert jm.scan and tm.scan
    p = np.random.default_rng(seed).standard_normal(shape).astype(rdt)
    v, g = jax.jit(jax.value_and_grad(getattr(jm, loss)))(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    value = getattr(tm, loss)(pt)
    value.backward()
    tol = TOL128 if complex128 else TOL64
    _assert_close(value.item(), float(v), tol, f"{name} value")
    _assert_close(pt.grad.numpy(), np.asarray(g), tol, f"{name} gradient")


@pytest.mark.parametrize("name", ["vqe10_6", "hea10_4_cz", "hea10_3_cnot",
                                  "qaoa10_3"])
def test_below_plane_size_matches_jax(name):
    """n = 10, complex64: the models' scan mode runs the fallback."""
    _check_model(name, False, 700)


@pytest.mark.parametrize("name", ["hea14_3", "vqe15_3"])
def test_complex128_scan_matches_jax(name):
    _check_model(name, True, 701)


def test_plane_engine_off_matches_jax():
    """set_plane_engine(False) keeps a plane-eligible model (n = 14,
    complex64) off the planes in both packages."""
    jconfig.set_plane_engine(False)
    config.set_plane_engine(False)
    _check_model("hea14_3_cz", False, 702)


# ---------------------------------------------------------------------------
# From an arbitrary initial state
# ---------------------------------------------------------------------------

_JAX_REF = {}


def _state_case(n):
    """The cz ring's layer and epilogue (2 layers), random SU(2) gate
    stacks, a random normalised state and random complex loss weights."""
    rng = np.random.default_rng(800 + n)
    L = 2
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    stacked = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((L, 2, 2))
                            + 1j * rng.standard_normal((L, 2, 2)))
        stacked.append(q.reshape(L, 4).astype(np.complex64))
    w = (rng.standard_normal((n, 2, 2))
         + 1j * rng.standard_normal((n, 2, 2))).astype(np.complex64)
    return psi, stacked, w


def _jax_reference(n):
    """Densities, the gate cotangents and the state cotangent of the JAX
    plane engine (interpret mode) for _state_case(n)."""
    if n in _JAX_REF:
        return _JAX_REF[n]
    psi, stacked, w = _state_case(n)
    jm = JHEA(n, 2, "cz", scan=True)
    jconfig.set_plane_engine(True)

    def f(stacked_j, state):
        d = jps.scan_with_epilogue(jm._layer_ftape, jm._epi_ftape, state,
                                   stacked_j, jm._layer_consts)
        return sum(jnp.real(jnp.sum(wk * dk)) for wk, dk in zip(w, d)), d

    (_, d), (g_stacked, g_state) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(tuple(jnp.asarray(s) for s in stacked),
                                         jnp.asarray(psi))
    jconfig.set_plane_engine("auto")
    ref = (np.stack([np.asarray(x) for x in d]),
           [np.asarray(x) for x in g_stacked], np.asarray(g_state))
    _JAX_REF[n] = ref
    return ref


def _port_densities(route, tm, state, stacked):
    if route == "fused":
        return tps.scan_with_epilogue(tm._layer_ftape, tm._epi_ftape, state,
                                      stacked, tm._layer_consts)
    if route == "off":
        config.set_plane_engine(False)
    final = tscan.scanned_layers(tm._layer_ftape, state, stacked,
                                 tm._layer_consts)
    return tps.epilogue_densities(tm._epi_ftape, final)


@pytest.mark.parametrize("n", [14, 15])
@pytest.mark.parametrize("route", ["fused", "composed", "off"])
def test_scan_from_a_state_matches_jax_plane_engine(n, route):
    d_ref, g_ref, s_ref = _jax_reference(n)
    psi, stacked, w = _state_case(n)
    tm = THEA(n, 2, "cz", device="cpu")
    state = torch.tensor(psi, requires_grad=True)
    st = [torch.tensor(s, requires_grad=True) for s in stacked]
    d = _port_densities(route, tm, state, st)
    loss = sum(torch.real(torch.sum(torch.tensor(wk) * dk)) for wk, dk in zip(w, d))
    loss.backward()
    _assert_close(torch.stack([x.detach() for x in d]).numpy(), d_ref, TOL64,
                  "densities")
    for q, (got, want) in enumerate(zip(st, g_ref)):
        _assert_close(got.grad.numpy(), np.conj(want), TOL64, f"gate {q} gradient")
    _assert_close(state.grad.numpy(), np.conj(s_ref), TOL64, "state gradient")


@pytest.mark.parametrize("layers", [2, 8])
def test_scanned_layers_adjoint_keeps_two_states(layers):
    """What scan mode off the planes saves for its backward: the final and
    the initial state and the stacked gates, whatever the depth (n = 8,
    complex128)."""
    n = 8
    tm = THEA(n, layers, "cz", dtype=torch.complex128, device="cpu")
    p = torch.tensor(np.random.default_rng(9).standard_normal((layers, n, 3)),
                     requires_grad=True)
    stacked = tm._stacked_gates(p)
    psi0 = torch.zeros(1 << n, dtype=torch.complex128)
    psi0[0] = 1
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        final = tscan._ScannedLayers.apply(tm._layer_ftape, tm._layer_consts,
                                           layers, psi0, *stacked)
    state_bytes = psi0.numel() * psi0.element_size()
    gate_bytes = sum(g.numel() * g.element_size() for g in stacked)
    assert sum(saved) == 2 * state_bytes + gate_bytes
    # the adjoint through it agrees with plain autograd of the same loop
    final.abs().pow(2)[0].backward()
    g_adj = p.grad.clone()
    p.grad = None
    state = psi0
    from dqc_tpu_torch.circuit.fused_autograd import fused_run
    stacked = tm._stacked_gates(p)
    for l in range(layers):
        _, state = fused_run(tm._layer_ftape, state, tuple(g[l] for g in stacked),
                             tm._layer_consts)
    state.abs().pow(2)[0].backward()
    torch.testing.assert_close(g_adj, p.grad, rtol=1e-10, atol=1e-12)
