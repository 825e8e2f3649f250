""""bf16" storage and the forward bf16x3 on the rings at every size the
narrow high groups reach, models against the JAX plane engine (its Pallas
kernels in interpret mode) on the CPU.

``HardwareEfficientAnsatz(n, L, entangler)`` from |0..0> (params ``0.7
N(0, 1)`` from a numpy seed), its n one-qubit densities and
``value_and_grad`` of their magnetization, in three settings: "bf16"
storage; ``set_kernel_dot_mode("bf16x3")`` with "f32" storage; both. Both
packages run each setting on the same inputs, and each its own f32 run.
Here the cz ring at n = 17 (group 2 at X = 8, 2 layers) and n = 20 (X = 64,
1 layer); in tests/test_torch_fwd16_rings_cnot.py and ``_cnot16.py`` the
CNOT ring at n = 14-17 (the multi-term kernels, the X = 8 span views, the
sublane adjoint), and in tests/test_torch_fwd16_expanded.py the expanded
merged top (``set_hpair_factorized(False)``) at n = 22. Errors are of the value
(relative), of the densities (abs) and of the gradient (a fraction of its
largest f32 entry). Bars:

* each package against its own f32 run within the JAX package's bars of
  tests/test_state_storage.py ("bf16": value 2e-3, gradient 5e-3) or its
  bf16x3-gram bar for the forward bf16x3 on f32 planes (2e-4), or 1.25
  times the JAX package's own error on the same inputs where that is
  larger (tests/test_torch_fwd16_models.py's rule);
* the port against the JAX package in the same setting within
  ``VS_JAX``, 1.25 times the largest difference measured over these
  models (``python tests/test_torch_fwd16_rings.py`` prints every case,
  with the JAX package's own error beside it; ``... chip-bars`` its own
  error on chip_smoke's ``[cz_bf16_small]`` and ``[cnot29_bf16]`` models at
  14-17q, the figures those phases' bars rest on).
"""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit.plane_scan import std_scan_with_epilogue as jstd
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA

from dqc_tpu_torch import config, convert
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA

torch.set_num_threads(2)

SETTINGS = [("bf16", "f32"), ("f32", "bf16x3"), ("bf16", "bf16x3")]
IDS = ["bf16", "f32+bf16x3", "bf16+bf16x3"]
# (value, gradient) bars against a package's own f32 run (the JAX
# package's, tests/test_state_storage.py and tests/test_plane_scan.py)
OWN = {("bf16", "f32"): (2e-3, 5e-3), ("f32", "bf16x3"): (2e-4, 2e-4),
       ("bf16", "bf16x3"): (2e-3, 5e-3)}
# the port against the JAX package in the same setting, (value, densities,
# gradient): 1.25 x the largest measured over the models of this file and
# of tests/test_torch_fwd16_rings_cnot*.py / _expanded.py (values 2.65e-6,
# 1.84e-5, 2.77e-5; densities 8.40e-6, 1.59e-5, 3.71e-5; gradients 8.74e-3,
# 8.07e-5, 8.74e-3). The "bf16" gradients differ most at n = 22 (8.74e-3 of
# max |g|, where each package moves 3.4e-2 from its own f32 run): the
# factorized route there differs from the JAX package's by the same
# 8.74e-3, and each package's expanded route from its own factorized one
# by 6.8e-3, so it is the storage's rounding of that model, not the
# expanded kernels; at n = 14-20 the two packages differ by at most 3.5e-3
VS_JAX = {("bf16", "f32"): (3.4e-6, 1.1e-5, 1.1e-2),
          ("f32", "bf16x3"): (2.3e-5, 2.0e-5, 1.01e-4),
          ("bf16", "bf16x3"): (3.5e-5, 4.7e-5, 1.1e-2)}
MEASURED = {}


def _both(setter, *args):
    getattr(jconfig, setter)(*args)
    getattr(config, setter)(*args)


def _set(storage, dot, factorized=True):
    _both("set_state_storage", storage)
    _both("set_kernel_dot_mode", dot)
    _both("set_hpair_factorized", factorized)


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set("f32", "f32")
    jconfig.set_plane_engine("auto")


def params(n, L, seed, scale=0.7):
    return (scale * np.random.default_rng(seed).standard_normal((L, n, 3))).astype(np.float32)


def jax_run(entangler, n, L, p):
    """(magnetization, densities (n, 2, 2), gradient) of the JAX package on
    its plane engine."""
    jm = JHEA(n, L, entangler=entangler, dtype=jnp.complex64, scan=True)

    def f(q):
        dens = jstd(None, jm._layer_ftape, jm._epi_ftape, (), jm._stacked_gates(q),
                    jm._layer_consts, dtype=jnp.complex64)
        z = sum(jnp.real(d[0, 0] - d[1, 1]) for d in dens)
        return z, jnp.stack(dens)

    jconfig.set_plane_engine(True)
    try:
        (v, dens), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(p))
    finally:
        jconfig.set_plane_engine("auto")
    return float(v), np.asarray(dens), np.asarray(g).ravel()


def port_run(entangler, n, L, p):
    tm = THEA(n, L, entangler, device="cpu")
    q = convert.params_from_jax(p, device="cpu").requires_grad_(True)
    dens = torch.stack(tm.densities(q))
    v = (dens[:, 0, 0] - dens[:, 1, 1]).real.sum()
    v.backward()
    return v.item(), dens.detach().numpy(), q.grad.numpy().ravel()


_RUNS = {}


def runs(model, storage, dot):
    """(JAX run, port run) of ``model = (entangler, n, L, factorized)`` in a
    setting, cached per process."""
    key = (model, storage, dot)
    if key not in _RUNS:
        entangler, n, L, factorized = model
        p = params(n, L, 1700 + n + L)
        _set(storage, dot, factorized)
        try:
            _RUNS[key] = (jax_run(entangler, n, L, p), port_run(entangler, n, L, p))
        finally:
            _set("f32", "f32")
    return _RUNS[key]


def errors(model, storage, dot):
    (jv0, _, jg0), (tv0, _, tg0) = runs(model, "f32", "f32")
    (jv, jd, jg), (tv, td, tg) = runs(model, storage, dot)
    scale = np.abs(jg0).max()
    return dict(
        jax_own=(abs(jv - jv0) / abs(jv0), float(np.abs(jg - jg0).max() / scale)),
        port_own=(abs(tv - tv0) / abs(tv0), float(np.abs(tg - tg0).max() / scale)),
        vs_jax=(abs(tv - jv) / abs(jv0), float(np.abs(td - jd).max()),
                float(np.abs(tg - jg).max() / scale)))


def check(model, storage, dot):
    e = errors(model, storage, dot)
    tag = f"{model[0]}{model[1]}{'' if model[3] else ' expanded'} {storage}+{dot}"
    for what, names in (("jax_own", ("value", "grad")), ("port_own", ("value", "grad")),
                        ("vs_jax", ("value", "densities", "grad"))):
        for name, x in zip(names, e[what]):
            MEASURED[f"{what} {name} {tag}"] = x
    assert e["port_own"][1] > 0, "the setting must round something"
    own, vs = OWN[storage, dot], VS_JAX[storage, dot]
    for k in (0, 1):
        bar = max(own[k], 1.25 * e["jax_own"][k])
        assert e["port_own"][k] <= bar, (k, e)
    for k in (0, 1, 2):
        assert e["vs_jax"][k] <= vs[k], (k, e, vs)
    return e


# n = 20 in the forward bf16x3 takes ~1 min a case on the CPU and runs the
# kernels n = 17 runs in the same settings (at X = 64 for X = 8, held at
# both in tests/test_torch_fwd16_small_x.py): slow, as is the CNOT ring at
# n = 16 (tests/test_torch_fwd16_rings_cnot16.py)
SLOW = pytest.mark.slow


@pytest.mark.parametrize("n, L, storage, dot", [
    (17, 2, "bf16", "f32"), (17, 2, "f32", "bf16x3"), (17, 2, "bf16", "bf16x3"),
    (20, 1, "bf16", "f32"),
    pytest.param(20, 1, "f32", "bf16x3", marks=SLOW),
    pytest.param(20, 1, "bf16", "bf16x3", marks=SLOW)],
    ids=[f"{n}-{i}" for n in (17, 20) for i in IDS])
def test_cz_narrow_groups(n, L, storage, dot):
    """Group 2 at X = 8 (n = 17) and X = 64 (n = 20): its apply with the
    ring's run folded in, its Gram and its adjoint, on bf16 planes and in
    bf16x3."""
    check(("cz", n, L, True), storage, dot)


def chip_bars(models=(("cz", (14, 15, 16, 17), 4), ("cnot", (14, 15, 16), 4),
                      ("cnot", (14, 15, 16), 2), ("cnot", (14, 15, 16), 20))):
    """The JAX package's own error, max over n, on chip_smoke's models
    (``HardwareEfficientAnsatz(n, L, entangler)``, params 0.1 N(0, 1), as
    chip_smoke's ``init_params``): (value relative, gradient rms, gradient
    max) of max |g32|, per (entangler, L, storage, dot)."""
    out = {}
    for entangler, ns, L in models:
        for n in ns:
            p = params(n, L, 2900 + n, 0.1)
            _set("f32", "f32")
            v0, _, g0 = jax_run(entangler, n, L, p)
            scale = np.abs(g0).max()
            for storage, dot in SETTINGS:
                _set(storage, dot)
                v, _, g = jax_run(entangler, n, L, p)
                e = (abs(v - v0) / abs(v0), float(np.sqrt(np.mean((g - g0) ** 2)) / scale),
                     float(np.abs(g - g0).max() / scale))
                key = (entangler, L, storage, dot)
                out[key] = tuple(max(a, b) for a, b in zip(out.get(key, (0, 0, 0)), e))
                print(f"chip-bars {entangler} n={n} L={L} {storage}+{dot}: value "
                      f"{e[0]:.3e} grad rms {e[1]:.3e} max {e[2]:.3e}", flush=True)
            _set("f32", "f32")
    return out


def print_measured(module_suffix):
    mod = next(m for k, m in sys.modules.items()
               if k.endswith(module_suffix) and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["chip-bars"]:
        for k, v in chip_bars().items():
            print("chip-bars max over n", k, ["%.3e" % x for x in v])
        sys.exit(0)
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    print_measured("test_torch_fwd16_rings")
    sys.exit(code)
