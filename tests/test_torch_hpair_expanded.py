"""The expanded merged top (X = 256 / 512) of the port against the JAX
package, on the CPU.

* the plain versions of the high apply in place and of the high adjoint
  (``block_backward_high``) at X = 256 and 512, on ``(1, X, 8, 128)``
  planes with complex non-Hermitian operators, against the JAX package's
  Pallas kernels in interpret mode;
* ``set_hpair_factorized(False)``: the value and the gradient of
  ``HardwareEfficientAnsatz(22, 2, "cz")`` and ``(23, 2, "cnot")`` (the
  merged sweep expanded to X = 256 / 512, and at n = 23 the lone top-group
  block) against ``jax.value_and_grad`` of ``dqc_tpu``'s
  models on its XLA engine (interpret mode above n = 21 is too slow), and
  against the port's factorized route at one layer (the same function);
* the route: on the meta device, through recording plain versions, the
  CNOT ring at n = 23 runs its lone top-group block as the in-place high
  apply and the high adjoint at X = 512 (``mode_launches`` "wide_inplace"
  and "wide"), and only its hpair item on the factorized kernels, as the
  JAX program does; with the hpair expanded, no factorized kernel at all.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's pair grams run in "f32". Tolerances: kernel planes 2e-5
absolute (sums of up to 512 f32 products of O(1) values), pair grams 1e-5
of their largest entry, values and gradients 2e-5 max(1, |x|).
"""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops.pallas.block_backward import block_backward_high
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes

from dqc_tpu_torch import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch import config
from dqc_tpu_torch.ops import kernels as tk

torch.set_num_threads(2)

PLANE_ATOL = 2e-5
GRAM_RTOL = 1e-5
TOL = 2e-5


@pytest.fixture(autouse=True)
def _configs():
    jconfig.set_gram_kernel_dot_mode("f32")
    config.set_gram_kernel_dot_mode("f32")
    yield
    jconfig.set_gram_kernel_dot_mode("auto")
    config.set_gram_kernel_dot_mode("auto")
    jconfig.set_plane_engine("auto")
    config.set_hpair_factorized(True)


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


# ---------------------------------------------------------------------------
# The two wide kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("X", [256, 512])
def test_wide_high_apply_in_place_matches_pallas(X):
    rng = np.random.default_rng(1300 + X)
    x = _pair(_cnormal(rng, (1, X, 8, 128)))
    e = _pair(_cnormal(rng, (X, X), X ** -0.5))
    want = high_group_apply_planes(*_j(x), *_j(e), alias=True, interpret=True)
    got = tk.high_apply(*(_t(a) for a in x), *(_t(a) for a in e))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PLANE_ATOL)


@pytest.mark.parametrize("X", [256, 512])
def test_wide_block_backward_high_matches_pallas(X):
    """F <- Einv F, T0 = B (Einv F)^T (holomorphic), B <- E^T B."""
    rng = np.random.default_rng(1400 + X)
    planes = [a for _ in range(2) for a in _pair(_cnormal(rng, (1, X, 8, 128)))]
    einv = _pair(_cnormal(rng, (X, X), X ** -0.5))
    e = _pair(_cnormal(rng, (X, X), X ** -0.5))
    want = block_backward_high(*_j(planes), *_j(einv), *_j(e), dot_mode="f32",
                               bwd_dot_mode="f32", gram_dot_mode="f32",
                               interpret=True)
    got = tk.block_backward_high(*(_t(a) for a in planes), *(_t(a) for a in einv),
                                 *(_t(a) for a in e))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PLANE_ATOL)
    for g, w in zip(got[4:], want[4:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAM_RTOL * np.abs(w).max())


def test_wide_kernels_refuse_a_diag_run():
    """A diagonal run folds into X <= 128 sweeps only, as in the JAX
    program (_pair_diag_into_high)."""
    x = torch.zeros((1, 256, 128, 128))
    e = torch.zeros((256, 256))
    a = torch.zeros((128, 128))
    tabs = (a, a, x[0, :, 0], x[0, :, 0], x[0, :, 0], x[0, :, 0])
    with pytest.raises(ValueError, match="X <= 128"):
        tk.high_apply(x, x, e, e, tabs)
    with pytest.raises(ValueError, match="X <= 128"):
        tk.block_backward_high(x, x, x, x, e, e, e, e, diag_inv_tables=tabs,
                               diag_tables=tabs)


# ---------------------------------------------------------------------------
# The models under set_hpair_factorized(False)
# ---------------------------------------------------------------------------

def _params(n, L, seed):
    return (0.7 * np.random.default_rng(seed).standard_normal((L, n, 3))
            ).astype(np.float32)


def _jax_run(n, entangler, params):
    """dqc_tpu's value_and_grad of the magnetization (its XLA engine,
    complex64)."""
    jm = JHEA(n, params.shape[0], entangler=entangler, scan=True)
    jconfig.set_plane_engine(False)
    v, g = jax.value_and_grad(jm.magnetization)(jnp.asarray(params))
    return float(v), np.asarray(g)


def _torch_run(n, entangler, params, factorized):
    config.set_hpair_factorized(factorized)
    tm = THEA(n, params.shape[0], entangler=entangler, device="cpu")
    p = torch.tensor(params, requires_grad=True)
    loss = tm.magnetization(p)
    loss.backward()
    return loss.item(), p.grad.numpy()


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= TOL, f"{what}: max err {err:.3e} > {TOL:.0e}"


CASES = [(22, "cz"), (23, "cnot")]


@pytest.mark.parametrize("n, entangler", CASES)
def test_expanded_hpair_matches_jax(n, entangler):
    params = _params(n, 2, 2300 + n)
    want_v, want_g = _jax_run(n, entangler, params)
    got_v, got_g = _torch_run(n, entangler, params, factorized=False)
    _close(got_v, want_v, "value")
    _close(got_g, want_g, "gradient")
    assert np.abs(want_g).max() > 0.1


@pytest.mark.parametrize("n, entangler", CASES)
def test_expanded_hpair_equals_factorized(n, entangler):
    """One layer: the expanded and the factorized sweep are the same
    function."""
    params = _params(n, 1, 2400 + n)
    got_v, got_g = _torch_run(n, entangler, params, factorized=False)
    want_v, want_g = _torch_run(n, entangler, params, factorized=True)
    _close(got_v, want_v, "value")
    _close(got_g, want_g, "gradient")


# ---------------------------------------------------------------------------
# The route, on the meta device
# ---------------------------------------------------------------------------

def _launches(model):
    """(kernel, X, in place) of every kernel call of one value_and_grad of
    ``model``'s magnetization, through recording plain versions on the meta
    device."""
    calls = []

    def recording(name, plain):
        sig = inspect.signature(plain)

        def call(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            inplace = a.get("acc") is None and a.get("alias", True)
            calls.append((name, tuple(args[0].shape)[1], inplace))
            return plain(*args, **kw)
        return call

    kernels = tk.KernelSet(*(recording(f, p) for f, p in
                             zip(tk.KernelSet._fields, tk.PLAIN)))
    p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    model.magnetization(p, kernels=kernels).backward()
    return calls


@pytest.mark.parametrize("factorized", [True, False], ids=["hpair_fact", "hpair_expanded"])
def test_lone_top_block_takes_the_expanded_route(factorized):
    """At n = 23 (a 2-bit top group) the CNOT ring's layer holds an hpair
    item (groups 2 and 3) and a lone dense block on group 3 (the in-group
    CNOT (21, 22)). The lone block runs in place at X = 512 both ways; the
    factorized kernels serve the hpair item only, and nothing when it is
    expanded."""
    L = 2
    config.set_hpair_factorized(factorized)
    calls = _launches(THEA(23, L, "cnot", device="meta"))
    wide = [c for c in calls if c[1] == 512]
    hpair = 0 if factorized else L
    assert wide.count(("high_apply", 512, True)) == L + hpair
    assert wide.count(("block_backward_high", 512, True)) == L + hpair
    assert wide.count(("high_apply", 512, False)) == 1  # the merged seed
    fact = sum(c[0] in ("merged_fact_apply", "block_backward_merged_fact")
               for c in calls)
    assert fact == (2 * L if factorized else 0)
