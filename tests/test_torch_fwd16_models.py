""""bf16" storage and the forward bf16x3 on the cz path, models against the
JAX plane engine (its Pallas kernels in interpret mode) on the CPU.

``HardwareEfficientAnsatz(n, 2, "cz")`` at n = 14, 15, 16, from |0..0>
(``magnetization``, params ``0.7 N(0, 1)`` from a numpy seed) and, in
tests/test_torch_fwd16_state.py (which imports this module's helpers), at
n = 14 from a random normalised state (``scan_with_epilogue`` with random
SU(2) gates and a weighted density loss, the set-up of
tests/test_torch_storage.py), in
four settings: "bf16" storage; ``set_kernel_dot_mode("bf16x3")`` with "f32"
storage; the same with "f16"; "bf16" with bf16x3. Both packages run in the
same setting on the same inputs, and each against its own f32 storage with
f32 dots. Errors are of the value (relative) and of the gradient (as a
fraction of its largest f32 entry; the state gradient included from a
state). Bars:

* each package against its own f32 run within the JAX package's bars of
  tests/test_state_storage.py where they apply ("bf16": value 2e-3,
  gradient 5e-3; "f16": gradient 5e-4), the bf16x3-gram bar for the
  forward bf16x3 on f32 planes (2e-4, tests/test_plane_scan.py), or 1.25
  times the JAX package's own error on the same inputs where that is
  larger: on this model the JAX package itself moves up to 2.0e-2 under
  "bf16" (the value 3.0e-3), past its bars for the layer it tests, and
  1.4e-3 under "f16" with bf16x3;
* the port against the JAX package in the same setting within ``VS_JAX``,
  1.25 times the largest difference measured here (``python
  tests/test_torch_fwd16_models.py`` prints every case; ``... chip-bars``
  the JAX package's own error on chip_smoke's ``[bf16_29]`` / ``[x3_29]``
  model at 14-16q, the figures those phases' bars rest on). Under "bf16"
  the stored planes round with the last bits of the f32 products, which
  the two packages sum in other orders, so the two differ by a fraction of
  the storage's own error (``... f16-depth`` prints the "f16" error at 20
  and 100 layers, why chip_smoke's ``[f16_29]`` keeps 100);
* (tests/test_torch_fwd16_state.py) at n = 22 (the merged top: the
  X = 256 seed, the factorized merged sweep and its adjoint on bf16
  planes) the port against its own f32 storage, as test_torch_storage.py's
  ``test_merged_top_reduced_n22``, within ``OWN_N22_BF16`` under "bf16".
"""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.circuit import plane_scan as jps
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA

from dqc_tpu_torch import config, convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA

torch.set_num_threads(2)

SETTINGS = [("bf16", "f32"), ("f32", "bf16x3"), ("f16", "bf16x3"), ("bf16", "bf16x3")]
IDS = ["bf16", "f32+bf16x3", "f16+bf16x3", "bf16+bf16x3"]
# (value, gradient) bars against a package's own f32 run: the JAX package's
# bars for "bf16" and "f16" (tests/test_state_storage.py), its bf16x3-gram
# bar for the forward bf16x3 on f32 planes (tests/test_plane_scan.py)
OWN = {("bf16", "f32"): (2e-3, 5e-3), ("f32", "bf16x3"): (2e-4, 2e-4),
       ("f16", "bf16x3"): (2e-4, 5e-4), ("bf16", "bf16x3"): (2e-3, 5e-3)}
# port against JAX in the same setting, (value, gradient): 1.25 x the
# largest measured over n = 14-16 and both starts (values 1.78e-5, 3.06e-6,
# 3.06e-6, 5.50e-5; gradients 1.65e-3, 1.86e-4, 1.32e-3, 3.08e-3)
VS_JAX = {("bf16", "f32"): (2.2e-5, 2.1e-3), ("f32", "bf16x3"): (3.8e-6, 2.4e-4),
          ("f16", "bf16x3"): (3.8e-6, 1.7e-3), ("bf16", "bf16x3"): (6.9e-5, 3.9e-3)}
# the port's own error under "bf16" at n = 22 (no JAX run there): twice the
# JAX package's own largest at 14-16q on this model (2.0e-2 gradient,
# 3.0e-3 value; the port's own measured 2.7e-2 and 2.6e-4 at n = 22)
OWN_N22_BF16 = (6e-3, 4e-2)
MEASURED = {}


def _both(setter, *args):
    getattr(jconfig, setter)(*args)
    getattr(config, setter)(*args)


def _set(storage, dot):
    _both("set_state_storage", storage)
    _both("set_kernel_dot_mode", dot)


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set("f32", "f32")
    jconfig.set_plane_engine("auto")


def _params(n, L, seed, scale=0.7):
    return (scale * np.random.default_rng(seed).standard_normal((L, n, 3))).astype(np.float32)


def _jax_std(n, L, params):
    jm = JHEA(n, L, entangler="cz", dtype=jnp.complex64, scan=True)
    jconfig.set_plane_engine(True)
    try:
        v, g = jax.value_and_grad(jm.magnetization)(jnp.asarray(params))
    finally:
        jconfig.set_plane_engine("auto")
    return float(v), np.asarray(g).ravel()


def _port_std(n, L, params):
    tm = THEA(n, L, "cz", device="cpu")
    p = convert.params_from_jax(params, device="cpu").requires_grad_(True)
    v = tm.magnetization(p)
    v.backward()
    return v.item(), p.grad.numpy().ravel()


def _state_case(n):
    rng = np.random.default_rng(1900 + n)
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


def _jax_state(n):
    psi, stacked, w = _state_case(n)
    jm = JHEA(n, 2, "cz", scan=True)
    jconfig.set_plane_engine(True)

    def f(stacked_j, state):
        d = jps.scan_with_epilogue(jm._layer_ftape, jm._epi_ftape, state,
                                   stacked_j, jm._layer_consts)
        return sum(jnp.real(jnp.sum(wk * dk)) for wk, dk in zip(w, d))

    try:
        v, (g_st, g_state) = jax.value_and_grad(f, argnums=(0, 1))(
            tuple(jnp.asarray(s) for s in stacked), jnp.asarray(psi))
    finally:
        jconfig.set_plane_engine("auto")
    return float(v), np.concatenate([np.conj(np.asarray(g)).ravel() for g in g_st]
                                    + [np.conj(np.asarray(g_state))])


def _port_state(n):
    psi, stacked, w = _state_case(n)
    tm = THEA(n, 2, "cz", device="cpu")
    state = torch.tensor(psi, requires_grad=True)
    st = [torch.tensor(s, requires_grad=True) for s in stacked]
    d = tps.scan_with_epilogue(tm._layer_ftape, tm._epi_ftape, state, st,
                               tm._layer_consts)
    loss = sum(torch.real(torch.sum(torch.tensor(wk) * dk)) for wk, dk in zip(w, d))
    loss.backward()
    return loss.item(), np.concatenate([s.grad.numpy().ravel() for s in st]
                                       + [state.grad.numpy()])


_RUNS = {}


def _runs(n, start, storage, dot):
    """(JAX value, JAX grad, port value, port grad), cached per process."""
    key = (n, start, storage, dot)
    if key not in _RUNS:
        _set(storage, dot)
        try:
            if start == "zero":
                params = _params(n, 2, 1400 + n)
                _RUNS[key] = (*_jax_std(n, 2, params), *_port_std(n, 2, params))
            else:
                _RUNS[key] = (*_jax_state(n), *_port_state(n))
        finally:
            _set("f32", "f32")
    return _RUNS[key]


def _errors(n, start, storage, dot):
    jv0, jg0, tv0, tg0 = _runs(n, start, "f32", "f32")
    jv, jg, tv, tg = _runs(n, start, storage, dot)
    scale = np.abs(jg0).max()
    return dict(
        jax_own=(abs(jv - jv0) / abs(jv0), float(np.abs(jg - jg0).max() / scale)),
        port_own=(abs(tv - tv0) / abs(tv0), float(np.abs(tg - tg0).max() / scale)),
        vs_jax=(abs(tv - jv) / abs(jv0), float(np.abs(tg - jg).max() / scale)))


def _check(n, start, storage, dot):
    e = _errors(n, start, storage, dot)
    own, vs = OWN[storage, dot], VS_JAX[storage, dot]
    for what in ("jax_own", "port_own", "vs_jax"):
        for k, x in enumerate(e[what]):
            name = f"{what} {'value' if k == 0 else 'grad'} {storage}+{dot}"
            MEASURED[name] = max(MEASURED.get(name, 0.0), x)
    assert e["port_own"][1] > 0, "the setting must round something"
    for k in (0, 1):
        bar = max(own[k], 1.25 * e["jax_own"][k])
        assert e["port_own"][k] <= bar, (k, e)
        assert e["vs_jax"][k] <= vs[k], (k, e, vs)
    return e


# [16-f16+bf16x3] is marked slow for Tier-1's time: [15-f16+bf16x3] runs the
# f16 cotangent under the forward bf16x3, [16-f32+bf16x3] and
# [16-bf16+bf16x3] the forward bf16x3 on n = 16's merged top.
@pytest.mark.parametrize("n, storage, dot", [
    pytest.param(n, storage, dot, id=f"{n}-{i}",
                 marks=[pytest.mark.slow] if (n, storage) == (16, "f16") else [])
    for n in (14, 15, 16) for (storage, dot), i in zip(SETTINGS, IDS)])
def test_cz_from_zero(n, storage, dot):
    _check(n, "zero", storage, dot)


def check_from_state(n, storage, dot):
    """The random-state start (tests/test_torch_fwd16_state.py runs it)."""
    return _check(n, "state", storage, dot)


def check_merged_top_n22():
    """n = 22 from |0..0> against the port's own f32 run: "bf16" storage
    and the forward bf16x3 on the merged-top kernels
    (tests/test_torch_fwd16_state.py runs it)."""
    n = 22
    params = _params(n, 1, 2200, 0.3)
    v0, g0 = _port_std(n, 1, params)
    scale = np.abs(g0).max()
    for storage, dot in (("bf16", "f32"), ("f32", "bf16x3"), ("bf16", "bf16x3")):
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            v, g = _port_std(n, 1, params)
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")
        own = OWN_N22_BF16 if storage == "bf16" else OWN[storage, dot]
        ev, eg = abs(v - v0) / abs(v0), float(np.abs(g - g0).max() / scale)
        MEASURED[f"n22 value {storage}+{dot}"] = ev
        MEASURED[f"n22 grad {storage}+{dot}"] = eg
        assert 0 < eg and ev <= own[0] and eg <= own[1], (storage, dot, ev, eg)


def chip_bars(layers=20, ns=(14, 15, 16)):
    """The JAX package's own error, max over 14-16q, on chip_smoke's
    [bf16_29] / [x3_29] model (HardwareEfficientAnsatz(n, 20, "cz"),
    params 0.1 N(0, 1) as chip_smoke's ``init_params``) in each setting:
    (value relative, gradient rms, gradient max) of max |g32|."""
    out = {}
    for n in ns:
        params = _params(n, layers, 2900 + n, 0.1)
        _set("f32", "f32")
        v0, g0 = _jax_std(n, layers, params)
        scale = np.abs(g0).max()
        for storage, dot in (("bf16", "f32"), ("f32", "bf16x3"), ("bf16", "bf16x3")):
            _set(storage, dot)
            v, g = _jax_std(n, layers, params)
            e = (abs(v - v0) / abs(v0), float(np.sqrt(np.mean((g - g0) ** 2)) / scale),
                 float(np.abs(g - g0).max() / scale))
            prev = out.get((storage, dot), (0.0, 0.0, 0.0))
            out[storage, dot] = tuple(max(a, b) for a, b in zip(prev, e))
            print(f"chip-bars n={n} {storage}+{dot}: value {e[0]:.3e} grad rms "
                  f"{e[1]:.3e} max {e[2]:.3e}", flush=True)
        _set("f32", "f32")
    return out


def f16_depth_errors(ns=(14, 16), depths=(20, 100)):
    """The "f16" storage's gradient error, rms of max |g32|, on chip_smoke's
    [f16_29] model (HardwareEfficientAnsatz(n, L, "cz"), params 0.1 N(0, 1))
    at two depths, both packages: why [f16_29] keeps its 100 layers."""
    for L in depths:
        for n in ns:
            params = _params(n, L, 2900 + n, 0.1)
            _set("f32", "f32")
            _, jg0 = _jax_std(n, L, params)
            _, tg0 = _port_std(n, L, params)
            _set("f16", "f32")
            _, jg = _jax_std(n, L, params)
            _, tg = _port_std(n, L, params)
            _set("f32", "f32")
            rms = [float(np.sqrt(np.mean((g - g0) ** 2)) / np.abs(g0).max())
                   for g, g0 in ((jg, jg0), (tg, tg0))]
            print(f"f16-depth L={L} n={n}: rms JAX {rms[0]:.3e}, port {rms[1]:.3e}",
                  flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["f16-depth"]:
        f16_depth_errors()
        sys.exit(0)
    if sys.argv[1:2] == ["chip-bars"]:
        for k, v in chip_bars().items():
            print("chip-bars max over n", k, ["%.3e" % x for x in v])
        sys.exit(0)
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_models") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
