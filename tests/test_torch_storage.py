"""Reduced cotangent storage ("mixed", "f16") and the bf16x3 backward dots
of the port against the JAX package on the CPU: the counterpart of
tests/test_state_storage.py for the paths the port runs them on.

* mode validation and the dot modes' "auto" resolution, case by case
  against dqc_tpu's config;
* ``plane_scan_densities`` of the hardware-efficient cz layer from a random
  normalised state (the reference test's set-up: random SU(2) gates, a
  density loss with random weights) at n = 14, 15, 16 under "mixed" and
  "f16": the densities bit-identical to f32 storage (the forward planes are
  f32 in both), the gate and state gradients within the storage's error of
  each package's own f32-storage run, and the port within a bar of the JAX
  package in the same mode;
* "mixed" with exact against "auto" (bf16x3) backward dots;
* ``HardwareEfficientAnsatz(n, 2, "cz").magnetization`` from |0..0> (the
  fully plane-resident bench path, the reference's ``std_scan`` case) under
  both modes at n = 14, and at n = 22, the smallest n whose top two groups
  merge (the merged-top seed at X = 256 and block_backward_merged_fact),
  against the port's own f32 storage with the six kernels' storage
  variants counted;
* the default bf16x3 pair grams against the JAX package's defaults;
* f16 planes handed to the forward kernels and the Grams raise (bf16
  ones run since "bf16" storage: tests/test_torch_fwd16_*.py); the kernels
  of the other plane paths run reduced planes and a bf16x3 transport, and
  the CNOT ring runs under both storages (tests/test_torch_storage_models.py
  holds those paths to the JAX package); the kernels and paths that take
  neither bf16 forward planes nor the forward bf16x3 yet raise under
  either.

The JAX side runs its plane engine with the Pallas kernels in interpret
mode; inputs are made with numpy from a seed and handed to both packages.
Bars, as fractions of the largest f32-storage gradient entry: each package
against its own f32 storage within the JAX test's bars (mixed 2e-3, f16
5e-4) or, where the JAX package's own error on these inputs is larger,
within 1.25 times it; port against JAX in the same mode within 5e-4
(mixed) and 1e-4 (f16 with exact transport dots). Under f16 with the
default bf16x3 transport the bar is 3e-4: the JAX kernels split Karatsuba
operands where the port splits the complex product's, and the f16 stores
round a few entries of the two the other way (measured up to 1.24e-4, PERF.md).
The default grams against the JAX defaults: the reference's own bar
(rtol 2e-4, atol 2e-4 of the largest entry; tests/test_plane_scan.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA

from dqc_tpu_torch import config
from dqc_tpu_torch import convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl

torch.set_num_threads(2)

OWN_BAR = {"mixed": 2e-3, "f16": 5e-4}
PORT_VS_JAX = {"mixed": 5e-4, "f16": 1e-4}
F16_BF16X3_VS_JAX = 3e-4


@pytest.fixture(autouse=True)
def _restore():
    yield
    for c in (jconfig, config):
        c.set_state_storage("f32")
        c.set_bwd_kernel_dot_mode("auto")
        c.set_gram_kernel_dot_mode("auto")
        c.set_plane_engine("auto")


def _both(setter, *args):
    getattr(jconfig, setter)(*args)
    getattr(config, setter)(*args)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def test_mode_validation():
    with pytest.raises(ValueError):
        config.set_state_storage("fp8")
    config.set_state_storage("mixed")
    assert config.state_storage() == "mixed"
    assert config.fwd_plane_dtype() == torch.float32
    assert config.bwd_plane_dtype() == torch.bfloat16
    config.set_state_storage("f16")
    assert config.fwd_plane_dtype() == torch.float32
    # the JAX package keeps the same f16 bits in uint16 planes
    assert config.bwd_plane_dtype() == torch.float16
    config.set_state_storage("f32")
    assert config.bwd_plane_dtype() == torch.float32
    with pytest.raises(ValueError):
        config.set_kernel_dot_mode("bf16x6")
    assert config.kernel_dot_mode() == "f32"


def test_bf16_storage_dtypes():
    """"bf16" stores both plane pairs bfloat16, as the JAX package's."""
    _both("set_state_storage", "bf16")
    assert config.state_storage() == jconfig.state_storage() == "bf16"
    assert config.fwd_plane_dtype() == torch.bfloat16
    assert config.bwd_plane_dtype() == torch.bfloat16
    assert str(jconfig.fwd_plane_dtype().__name__) == "bfloat16"


def test_kernel_dot_mode_bf16x3():
    """The forward bf16x3 is accepted and is what the backward "auto"
    resolves to under f32 storage, as in the JAX package."""
    try:
        _both("set_kernel_dot_mode", "bf16x3")
        assert config.kernel_dot_mode() == jconfig.kernel_dot_mode() == "bf16x3"
        assert config.bwd_kernel_dot_mode() == jconfig.bwd_kernel_dot_mode() == "bf16x3"
        _both("set_bwd_kernel_dot_mode", "f32")
        assert config.bwd_kernel_dot_mode() == "f32"
    finally:
        _both("set_kernel_dot_mode", "f32")


@pytest.mark.parametrize("storage", ["f32", "mixed", "f16", "bf16"])
def test_bwd_dot_mode_resolution(storage):
    """Every setting of the two backward modes resolves as dqc_tpu's does."""
    _both("set_state_storage", storage)
    for bwd in ("auto", "f32", "bf16x3"):
        for gram in ("auto", "f32", "bf16x3"):
            _both("set_bwd_kernel_dot_mode", bwd)
            _both("set_gram_kernel_dot_mode", gram)
            assert config.bwd_kernel_dot_mode() == jconfig.bwd_kernel_dot_mode()
            assert config.gram_kernel_dot_mode() == jconfig.gram_kernel_dot_mode()
    _both("set_bwd_kernel_dot_mode", "auto")
    assert config.bwd_kernel_dot_mode() == ("f32" if storage == "f32" else "bf16x3")
    for mode in ("bf16x3", "f32"):
        _both("set_kernel_dot_mode", mode)
        assert config.bwd_kernel_dot_mode() == jconfig.bwd_kernel_dot_mode()
    with pytest.raises(ValueError):
        config.set_bwd_kernel_dot_mode("f64")


# ---------------------------------------------------------------------------
# The scan from a random state
# ---------------------------------------------------------------------------

def _state_case(n):
    rng = np.random.default_rng(900 + n)
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


def _jax_state_run(n):
    """Densities, gate and state cotangents of the JAX plane engine under
    its current storage and dot modes (the cotangents conjugated to torch's
    gradient convention)."""
    psi, stacked, w = _state_case(n)
    jm = JHEA(n, 2, "cz", scan=True)
    jconfig.set_plane_engine(True)

    def f(stacked_j, state):
        d = jps.scan_with_epilogue(jm._layer_ftape, jm._epi_ftape, state,
                                   stacked_j, jm._layer_consts)
        return sum(jnp.real(jnp.sum(wk * dk)) for wk, dk in zip(w, d)), d

    try:
        (_, d), (g_st, g_state) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(
                tuple(jnp.asarray(s) for s in stacked), jnp.asarray(psi))
    finally:
        jconfig.set_plane_engine("auto")
    grads = np.concatenate([np.conj(np.asarray(g)).ravel() for g in g_st]
                           + [np.conj(np.asarray(g_state))])
    return np.stack([np.asarray(x) for x in d]), grads


def _port_state_run(n):
    psi, stacked, w = _state_case(n)
    tm = THEA(n, 2, "cz", device="cpu")
    state = torch.tensor(psi, requires_grad=True)
    st = [torch.tensor(s, requires_grad=True) for s in stacked]
    d = tps.plane_scan_densities(tm._layer_ftape, tm._epi_ftape, state, st,
                                 tm._layer_consts)
    loss = sum(torch.real(torch.sum(torch.tensor(wk) * dk)) for wk, dk in zip(w, d))
    loss.backward()
    grads = np.concatenate([s.grad.numpy().ravel() for s in st]
                           + [state.grad.numpy()])
    return torch.stack([x.detach() for x in d]).numpy(), grads


_RUNS = {}


def _runs(n, storage, bwd="auto"):
    """(JAX densities, JAX grads, port densities, port grads) under a mode,
    cached per test process."""
    key = (n, storage, bwd)
    if key not in _RUNS:
        _both("set_state_storage", storage)
        _both("set_bwd_kernel_dot_mode", bwd)
        try:
            _RUNS[key] = (*_jax_state_run(n), *_port_state_run(n))
        finally:
            _both("set_state_storage", "f32")
            _both("set_bwd_kernel_dot_mode", "auto")
    return _RUNS[key]


def _rel(a, b, scale):
    return float(np.abs(a - b).max() / scale)


def _check_storage(n, storage, bwd="auto"):
    jd0, jg0, td0, tg0 = _runs(n, "f32")
    jd, jg, td, tg = _runs(n, storage, bwd)
    # the forward planes are f32 in both storages: the densities do not move
    np.testing.assert_array_equal(jd, jd0)
    np.testing.assert_array_equal(td, td0)
    scale = np.abs(jg0).max()
    e_jax, e_port = _rel(jg, jg0, scale), _rel(tg, tg0, scale)
    assert 0 < e_jax and 0 < e_port, "the storage must round something"
    bar = max(OWN_BAR[storage], 1.25 * e_jax)
    assert e_port <= bar, (e_port, e_jax)
    vs = PORT_VS_JAX[storage]
    assert _rel(tg, jg, scale) <= vs, (_rel(tg, jg, scale), vs)
    return e_jax, e_port, _rel(tg, jg, scale)


@pytest.mark.parametrize("n", [14, 15, 16])
@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_value_exact_grad_within_storage(storage, n):
    _check_storage(n, storage)


@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_exact_bwd_dots_match_jax(storage):
    """With ``set_bwd_kernel_dot_mode("f32")`` the two packages differ only
    in the order of their f32 sums."""
    _check_storage(14, storage, "f32")


def test_mixed_grad_error_vs_exact_bwd_dots():
    """The auto bf16x3 cotangent dots do not degrade the mixed-storage
    gradient beyond the storage rounding (the JAX test's criterion)."""
    _, jg0, _, tg0 = _runs(14, "f32")
    _, _, _, g_exact = _runs(14, "mixed", "f32")
    _, _, _, g_fast = _runs(14, "mixed", "auto")
    scale = np.abs(tg0).max()
    e_exact, e_fast = _rel(g_exact, tg0, scale), _rel(g_fast, tg0, scale)
    assert e_fast < max(3 * e_exact, 1e-3), (e_fast, e_exact)


def test_default_grams_match_jax_defaults():
    """f32 storage, both packages' default bf16x3 pair grams: the reference's
    own bar for its bf16x3 grams against f32."""
    jd, jg, td, tg = _runs(15, "f32")
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tg, jg, rtol=2e-4, atol=2e-4 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# The bench path from |0..0>
# ---------------------------------------------------------------------------

def _params(n, L, seed):
    return (0.7 * np.random.default_rng(seed).standard_normal((L, n, 3))).astype(np.float32)


def _recording_kernels(calls):
    """The wrappers (their plain versions on the CPU), each call recorded
    as (kernel, storage of its cotangent planes, transport mode, gram
    mode)."""
    def recording(name, wrapper):
        def call(*args, **kw):
            out = wrapper(*args, **kw)
            if name in ("dual_apply", "high_apply"):
                planes = out[0]
            elif name.startswith("block_backward") or name == "diag_backward":
                planes = args[2]
            else:
                planes = args[0]
            calls.append((name, planes.dtype, kw.get("bwd_mode", "f32"),
                          kw.get("gram_mode", "f32")))
            return out
        return call
    return tk.KernelSet(*(recording(f, w) for f, w in
                          zip(tk.KernelSet._fields, tk.KERNELS)))


def _port_model_grad(n, L, params):
    tm = THEA(n, L, "cz", device="cpu")
    p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
    calls = []
    v = tm.magnetization(p, kernels=_recording_kernels(calls))
    v.backward()
    return v.item(), p.grad.numpy(), calls


def _jax_model_grad(n, L, params):
    jm = JHEA(n, L, entangler="cz", dtype=jnp.complex64, scan=True)
    jconfig.set_plane_engine(True)
    try:
        v, g = jax.value_and_grad(jm.magnetization)(jnp.asarray(params))
    finally:
        jconfig.set_plane_engine("auto")
    return float(v), np.asarray(g)


@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_std_scan_reduced(storage):
    """HardwareEfficientAnsatz(14, 2, "cz") from |0..0>: value bit-identical
    to f32 storage in both packages, gradients within the storage's error
    (bars as above), and the seed and backward kernels' storage variants
    counted."""
    n, L = 14, 2
    params = _params(n, L, 1400)
    jv0, jg0 = _jax_model_grad(n, L, params)
    tv0, tg0, c0 = _port_model_grad(n, L, params)
    _both("set_state_storage", storage)
    jv, jg = _jax_model_grad(n, L, params)
    tv, tg, c = _port_model_grad(n, L, params)
    assert jv == jv0 and tv == tv0
    scale = np.abs(jg0).max()
    e_jax, e_port = _rel(jg, jg0, scale), _rel(tg, tg0, scale)
    assert 0 < e_port <= max(OWN_BAR[storage], 1.25 * e_jax), (e_port, e_jax)
    vs = F16_BF16X3_VS_JAX if storage == "f16" else PORT_VS_JAX[storage]
    assert _rel(tg, jg, scale) <= vs
    dt = config_dtype(storage)
    # one seed per minor group: the first creates the cotangent planes in
    # the storage, the second accumulates into them
    assert [k[1] for k in c if k[0] == "dual_apply"][-2:] == [dt, dt]
    backward = [k for k in c if k[0] in ("block_backward_dual", "diag_backward")]
    assert backward and all(k[1] == dt for k in backward)
    assert all(k[2:] == ("bf16x3", "bf16x3") for k in backward
               if k[0] == "block_backward_dual")
    assert all(k[1] == torch.float32 and k[2] == "f32" for k in c0)
    assert all(k[3] == "bf16x3" for k in c0 if k[0] == "block_backward_dual")


def config_dtype(storage):
    return torch.bfloat16 if storage == "mixed" else torch.float16


def test_merged_top_reduced_n22():
    """n = 22, the smallest n whose top two groups merge: the merged-top
    seed (the high apply at X = 256) and block_backward_merged_fact under
    both storages, from a random state as above, against the port's f32
    storage (the JAX plane engine in interpret mode is too slow at this
    size; tests/test_torch_merged_diag.py holds f32 storage to the JAX XLA
    engine at n = 22). The cz layer from |0..0> runs the same kernels."""
    n = 22
    _, g0 = _port_state_run(n)
    scale = np.abs(g0).max()
    for storage in ("mixed", "f16"):
        config.set_state_storage(storage)
        try:
            _, g = _port_state_run(n)
            calls = []
            tm = THEA(n, 1, "cz", device="cpu")
            p = torch.zeros((1, n, 3), requires_grad=True)
            tm.magnetization(p, kernels=_recording_kernels(calls)).backward()
        finally:
            config.set_state_storage("f32")
        assert 0 < _rel(g, g0, scale) <= OWN_BAR[storage], (storage, _rel(g, g0, scale))
        dt = config_dtype(storage)
        assert ("high_apply", dt, "f32", "f32") in calls  # the X = 256 seed
        # the transport clamped to f32, as the JAX package's planes layer
        # hands its kernel (planes.backward_merged_top_fact)
        assert ("block_backward_merged_fact", dt, "f32", "bf16x3") in calls


# ---------------------------------------------------------------------------
# What stays unported refuses reduced planes (ROADMAP.md); the kernels of
# the other plane paths run them
# ---------------------------------------------------------------------------

def _bf16_planes(shape):
    x = torch.zeros(shape, dtype=torch.bfloat16)
    return x, x.clone()


def _rand_planes(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for _ in range(2))


def _rand_ops(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(2))


def test_other_kernels_refuse_reduced_planes():
    """f16 planes into the Grams still raise (ROADMAP.md queue B item 1: a
    cotangent stored "f16" handed to a forward kernel no path runs); into
    the dual apply they run (the per-term fallback's input); bf16 ones run
    since "bf16" storage, as the plain versions on the
    decoded planes. The multi-term applies, the lane, sublane and X = 256
    adjoints and apply_cross_span, which refused reduced planes and a bf16x3
    transport before, now run them: each returns planes in the cotangent's
    storage, its plain version's values, and within two storage ulps of the
    same call on the decoded f32 planes (one encode)."""
    e = torch.zeros((128, 128))
    h = tuple(p.to(torch.float16) for p in _bf16_planes((1, 128, 128)))
    # f16 input to the applies runs (the per-term fallback under "f16"),
    # into planes of its storage; the Grams still refuse it
    assert all(p.dtype == torch.float16 for p in tk.dual_apply(*h, e, e, e, e))
    with pytest.raises(NotImplementedError, match="gram.*ROADMAP"):
        tk.gram(*h)
    b = _rand_planes((1, 128, 128), 0, torch.bfloat16)
    got = tk.gram(*b)
    want = tk.gram(*(p.float() for p in b))
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    dt = torch.bfloat16
    f = _rand_planes((1, 128, 128), 1)
    bb = _rand_planes((1, 128, 128), 2, dt)
    b32 = tuple(p.float() for p in bb)
    ops = _rand_ops((4, 128, 128), 3) + _rand_ops((4, 128, 128), 4)
    # in place on the cotangent, a seed into it, a fresh seed in its storage
    for fn, plain, x, y, kw in (
            (tk.dual_multi_apply, tk.PLAIN.dual_multi_apply, bb, b32, {}),
            (tk.dual_multi_apply, tk.PLAIN.dual_multi_apply, f, f,
             dict(conj=True, acc=bb, alias=False)),
            (tk.dual_multi_apply, tk.PLAIN.dual_multi_apply, f, f,
             dict(conj=True, alias=False, out_dtype=dt))):
        got = fn(*x, *ops, **kw)
        want32 = plain(*y, *ops, **{**kw, "acc": None if "acc" not in kw else b32,
                                   "out_dtype": None})
        assert got[0].dtype == dt
        for g, p in zip(got, plain(*x, *ops, **kw)):
            assert torch.equal(g, p)
        assert tk._storage.ulps_apart(got, want32, dt) <= 2.0
    v = (1, 8, 16, 128)
    hops = _rand_ops((4, 8, 8), 5) + _rand_ops((4, 128, 128), 6)
    bv = tuple(p.reshape(v) for p in _rand_planes(v, 7, dt))
    got = tk.high_multi_apply(*bv, *hops)
    want = tk.PLAIN.high_multi_apply(*(p.float() for p in bv), *hops)
    assert got[0].dtype == dt and tk._storage.ulps_apart(got, want, dt) <= 2.0
    got = tpl.apply_cross_span(
        f[0].view(v), f[1].view(v), None, (14, 15), 15, out_dtype=dt,
        alias=False, conj=True,
        operands=("high", v, *_rand_ops((8, 8), 8)))
    assert got[0].dtype == dt
    # the unpaired adjoints and the X = 256 adjoint, bf16x3 transport
    E = _rand_ops((128, 128), 9) + _rand_ops((128, 128), 10)
    for step in (tk.block_backward_lane, tk.block_backward_sublane):
        got = step(*f, *bb, *E, bwd_mode="bf16x3")
        want = step(*f, *b32, *E, bwd_mode="bf16x3")
        assert got[2].dtype == dt
        assert tk._storage.ulps_apart(got[2:4], want[2:4], dt) <= 2.0
        np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), rtol=0,
                                   atol=1e-5 * float(want[4].abs().max()))
    w = (1, 256, 8, 128)
    fw = _rand_planes(w, 11)
    bw = _rand_planes(w, 12, dt)
    Ew = _rand_ops((256, 256), 13) + _rand_ops((256, 256), 14)
    got = tk.block_backward_high(*fw, *bw, *Ew, bwd_mode="bf16x3")
    want = tk.block_backward_high(*fw, *(p.float() for p in bw), *Ew,
                                  bwd_mode="bf16x3")
    assert got[2].dtype == dt
    assert tk._storage.ulps_apart(got[2:4], want[2:4], dt) <= 2.0


@pytest.mark.parametrize("make, loss", [
    (lambda: THEA(14, 2, "cnot", device="cpu"), "magnetization"),
], ids=["cnot"])
@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_unported_paths_raise_not_run_f32(make, loss, storage):
    """The CNOT ring under reduced storage, which raised before this path's
    kernels took reduced planes, now runs: its value bit-identical to f32
    storage and its gradient within the JAX package's bar for the dense
    cross-group gates under reduced storage (1e-2 of the largest entry,
    tests/test_state_storage.py::test_dense_cross_mixed)."""
    m = make()
    p = m.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    v0 = getattr(m, loss)(p)
    v0.backward()
    g0, p.grad = p.grad.clone(), None
    config.set_state_storage(storage)
    v = getattr(m, loss)(p)
    v.backward()
    assert v.item() == v0.item()
    rel = float((p.grad - g0).abs().max() / g0.abs().max())
    assert 0 < rel < 1e-2, rel


# bf16 forward planes ("bf16" storage) and the forward bf16x3: every kernel,
# mode and path takes them (tests/test_torch_fwd16_*.py hold them against
# the JAX package); off the planes neither setting applies

FWD16 = [("bf16", "f32"), ("f32", "bf16x3")]
FWD16_IDS = ["bf16_planes", "fwd_bf16x3"]


@pytest.mark.parametrize("fwd, dm", FWD16, ids=FWD16_IDS)
def test_fallback_ignores_fwd16(fwd, dm):
    """Scan mode off the planes (n < 14; the plane engine off) takes
    neither setting, as the JAX package's XLA engine: results identical to
    the f32 defaults."""
    from dqc_tpu_torch.models.vqe_ising import VQEIsing
    m = VQEIsing(10, 3, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(1))
    runs = []
    for setting in ((None, "f32"), (fwd, dm)):
        config.set_state_storage(setting[0] or "f32")
        config.set_kernel_dot_mode(setting[1])
        try:
            q = p.clone().requires_grad_(True)
            v = m.energy(q)
            v.backward()
            runs.append((v.item(), q.grad.clone()))
        finally:
            config.set_kernel_dot_mode("f32")
            config.set_state_storage("f32")
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def _measure_model(n, L, params, storage, bwd="auto"):
    """|0..0> HardwareEfficientAnsatz magnetization gradients of both
    packages under a mode (the JAX side on its plane engine)."""
    _both("set_state_storage", storage)
    _both("set_bwd_kernel_dot_mode", bwd)
    try:
        _, jg = _jax_model_grad(n, L, params)
        tm = THEA(n, L, "cz", device="cpu")
        p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
        tm.magnetization(p).backward()
    finally:
        _both("set_state_storage", "f32")
        _both("set_bwd_kernel_dot_mode", "auto")
    return jg, p.grad.numpy()


if __name__ == "__main__":
    # The measured errors behind the bars above and PERF.md's CPU figures,
    # as fractions of the largest f32-storage gradient entry (JAX's plane
    # engine in interpret mode; takes ~15 min):
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_storage.py
    jax.config.update("jax_platforms", "cpu")
    print("scans from a random state (test_value_exact_grad_within_storage):")
    for n in (14, 15, 16):
        for storage in ("mixed", "f16"):
            for bwd in ("auto", "f32"):
                jd0, jg0, td0, tg0 = _runs(n, "f32")
                jd, jg, td, tg = _runs(n, storage, bwd)
                s = np.abs(jg0).max()
                print(f"  n={n} {storage:5s} bwd={bwd:6s} jax-own {_rel(jg, jg0, s):.2e} "
                      f"port-own {_rel(tg, tg0, s):.2e} port-jax {_rel(tg, jg, s):.2e}")
    print("HardwareEfficientAnsatz(n, 2, cz) from |0..0>, params 0.7 N(0, 1):")
    for n in (14, 15, 16):
        for seed in (0, 1):
            params = _params(n, 2, 100 * n + seed)
            jg0, tg0 = _measure_model(n, 2, params, "f32")
            s = np.abs(jg0).max()
            for storage in ("mixed", "f16"):
                for bwd in ("auto", "f32"):
                    jg, tg = _measure_model(n, 2, params, storage, bwd)
                    print(f"  n={n} seed={seed} {storage:5s} bwd={bwd:6s} jax-own "
                          f"{_rel(jg, jg0, s):.2e} port-own {_rel(tg, tg0, s):.2e} "
                          f"port-jax {_rel(tg, jg, s):.2e}")
    print("chip_smoke [storage29]'s model, (n, 4, cz), init_params(seed 1236):")
    for n in (16, 18, 22):
        tm = THEA(n, 4, "cz", device="cpu")
        params = tm.init_params(torch.Generator().manual_seed(1236)).numpy()
        grads = {}
        for storage in ("f32", "mixed", "f16"):
            if n <= 16:
                grads[storage] = _measure_model(n, 4, params, storage)
            else:
                config.set_state_storage(storage)
                try:
                    grads[storage] = (None, _port_model_grad(n, 4, params)[1])
                finally:
                    config.set_state_storage("f32")
        s = np.abs(grads["f32"][1]).max()
        for storage in ("mixed", "f16"):
            for side, k in (("jax", 0), ("port", 1)):
                g, g0 = grads[storage][k], grads["f32"][k]
                if g is None:
                    continue
                d = np.abs(g - g0) / s
                print(f"  n={n} {storage:5s} {side:4s} max {d.max():.2e} "
                      f"rms {np.sqrt((d * d).mean()):.2e}")
    print("the n x 1L closed form (-sin alpha, 0, 0) under each storage:")
    for n in (14, 16, 22):
        alpha = np.linspace(-1.3, 1.4, n)
        p1 = np.zeros((1, n, 3), np.float32)
        p1[0, :, 0] = alpha
        want = -np.sin(alpha.astype(np.float32).astype(np.float64))
        for storage in ("f32", "f16", "mixed"):
            if n <= 16:
                jg, tg = _measure_model(n, 1, p1, storage)
            else:
                config.set_state_storage(storage)
                try:
                    jg, tg = None, _port_model_grad(n, 1, p1)[1]
                finally:
                    config.set_state_storage("f32")
            errs = [np.maximum(np.abs(g[0, :, 0] - want).max(), np.abs(g[0, :, 1:]).max())
                    for g in (jg, tg) if g is not None]
            print(f"  n={n} {storage:5s} " + " ".join(
                f"{side} {e:.3e}" for side, e in zip(("jax", "port") if jg is not None
                                                     else ("port",), errs)))
