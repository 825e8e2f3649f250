""""bf16" storage and the forward bf16x3 on ``VQEIsing`` and ``QAOAMaxCut``
against the JAX plane engine (its Pallas kernels in interpret mode) on the
CPU.

Each model runs in scan mode from |0..0> with params made with numpy from
a seed and handed to both packages (tests/test_torch_storage_models.py's
models: VQE-Ising, whose Ising ring's ZZ runs are variable diagonal runs
folded into the dense sweeps and rolled back with their Q reductions;
QAOA MaxCut on a weighted ring with chords, whose cost layer is a variable
run and whose edges across groups seed through the multi-term applies and
the span views), at n = 14 and at n = 17 (group 2 at X = 8: the high
adjoint there), one layer, in three settings: "bf16" storage;
``set_kernel_dot_mode("bf16x3")`` with f32 storage; both (at n = 17 the
VQE cases in the first two settings; the rest slow). Both packages
run each setting and their own f32 run. Errors are of the value (relative
to the f32 value) and of the gradient (a fraction of its largest f32
entry). Bars:

* each package against its own f32 run within tests/test_torch_fwd16_rings.py's
  ``OWN`` bars, or 1.25 times the JAX package's own error on the same
  inputs where that is larger;
* the port against the JAX package in the same setting within ``VS_JAX``,
  1.25 times the largest difference measured over these models (``python
  tests/test_torch_fwd16_paths.py`` prints every case, with the JAX
  package's own error beside it; ``... chip-bars`` its own error on
  chip_smoke's ``[paths29_bf16]`` and ``[vqe_bf16_small]`` models at
  14-17q, the figures those phases' bars rest on).
"""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig

from dqc_tpu_torch import config, convert

from test_torch_fwd16_rings import IDS, OWN, SETTINGS
from test_torch_storage_models import _models

torch.set_num_threads(2)

# the port against the JAX package in the same setting, (value, gradient):
# 1.25 x the largest measured over the models of this file (values
# 8.94e-7, 2.98e-6, 5.45e-6; gradients 1.15e-4, 3.53e-5, 1.61e-4, the
# "bf16" ones where each package moves up to 4.6e-4 from its own f32 run)
VS_JAX = {("bf16", "f32"): (1.12e-6, 1.44e-4), ("f32", "bf16x3"): (3.72e-6, 4.41e-5),
          ("bf16", "bf16x3"): (6.81e-6, 2.01e-4)}
MEASURED = {}
CASES = [("vqe", 14), ("qaoa", 14), ("vqe", 17), ("qaoa", 17)]


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set("f32", "f32")
    jconfig.set_plane_engine("auto")


def _set(storage, dot):
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)


_RUNS = {}


def _run(kind, n, storage, dot, L=1, models=_models):
    """(JAX value, JAX grad, port value, port grad) of a model in a setting,
    cached per process."""
    key = (kind, n, L, storage, dot, models)
    if key not in _RUNS:
        jm, tm, loss, p = models(kind, n, L)
        _set(storage, dot)
        jconfig.set_plane_engine(True)
        try:
            jv, jg = jax.value_and_grad(getattr(jm, loss))(jnp.asarray(p))
            pt = convert.params_from_jax(p, device="cpu").requires_grad_(True)
            tv = getattr(tm, loss)(pt)
            tv.backward()
        finally:
            _set("f32", "f32")
            jconfig.set_plane_engine("auto")
        _RUNS[key] = (float(jv), np.asarray(jg), tv.item(), pt.grad.numpy())
    return _RUNS[key]


def errors(kind, n, storage, dot):
    jv0, jg0, tv0, tg0 = _run(kind, n, "f32", "f32")
    jv, jg, tv, tg = _run(kind, n, storage, dot)
    s, v = np.abs(jg0).max(), abs(jv0)
    return dict(jax_own=(abs(jv - jv0) / v, float(np.abs(jg - jg0).max() / s)),
                port_own=(abs(tv - tv0) / v, float(np.abs(tg - tg0).max() / s)),
                vs_jax=(abs(tv - jv) / v, float(np.abs(tg - jg).max() / s)))


# ~15-50 s a case on the CPU: at n = 17 the VQE cases in "bf16" and f32 +
# bf16x3 stay (the high kernels at X = 8 on bf16 planes and in bf16x3);
# "bf16" + bf16x3 runs the variants those two run, and QAOA adds to VQE's
# route there the seeds of its chords, which all three n = 14 cases run:
# slow
PARAMS = [pytest.param(kind, n, storage, dot, id=f"{kind}{n}-{i}",
                       marks=[pytest.mark.slow] if n == 17 and (
                           i == IDS[2] or kind == "qaoa") else [])
          for kind, n in CASES for (storage, dot), i in zip(SETTINGS, IDS)]


@pytest.mark.parametrize("kind, n, storage, dot", PARAMS)
def test_model_matches_jax(kind, n, storage, dot):
    e = errors(kind, n, storage, dot)
    tag = f"{kind}{n} {storage}+{dot}"
    for what in ("jax_own", "port_own", "vs_jax"):
        for name, x in zip(("value", "grad"), e[what]):
            MEASURED[f"{what} {name} {tag}"] = x
    assert e["port_own"][1] > 0, "the setting must round something"
    own, vs = OWN[storage, dot], VS_JAX[storage, dot]
    for k in (0, 1):
        assert e["port_own"][k] <= max(own[k], 1.25 * e["jax_own"][k]), (k, e)
        assert e["vs_jax"][k] <= vs[k], (k, e, vs)


def _chip_models(kind, n, L):
    """chip_smoke's models at n qubits, as tests/test_torch_storage_models.py
    makes them: ``VQEIsing(n, L)`` and ``QAOAMaxCut(n, random_graph(n, 14,
    0), L)``, params from the port's ``init_params`` (seed 1234)."""
    from dqc_tpu.models.qaoa import QAOAMaxCut as JQAOA
    from dqc_tpu.models.vqe_ising import VQEIsing as JVQE
    from dqc_tpu_torch.models.qaoa import QAOAMaxCut as TQAOA
    from dqc_tpu_torch.models.vqe_ising import VQEIsing as TVQE
    from test_torch_storage_models import _random_graph

    if kind == "vqe":
        jm, tm, loss = JVQE(n, L, scan=True), TVQE(n, L, scan=True, device="cpu"), "energy"
    else:
        g = _random_graph(n, 14, 0)
        jm, tm, loss = (JQAOA(n, g, layers_number=L, scan=True),
                        TQAOA(n, g, layers_number=L, scan=True, device="cpu"), "loss")
    p = tm.init_params(torch.Generator().manual_seed(1234)).numpy()
    return jm, tm, loss, p


CHIP_MODELS = (("vqe", (14, 15, 16, 17), 4, SETTINGS),
               ("qaoa", (14, 15, 16, 17), 2, SETTINGS),
               ("vqe", (14, 15, 16, 17), 2, SETTINGS[:2]),
               ("vqe", (14, 15, 16), 26, SETTINGS[:1]))


def chip_bars(models=CHIP_MODELS):
    """The JAX package's own error, max over n, on chip_smoke's VQE / QAOA
    models ([paths29_bf16]'s at 4 and 2 layers, [vqe_bf16_small]'s at 2,
    [vqe29_bf16]'s at 26): (value relative, gradient rms, gradient max) of
    max |g32|, per (kind, L, storage, dot)."""
    out = {}
    for kind, ns, L, settings in models:
        for n in ns:
            v0, g0 = _run(kind, n, "f32", "f32", L, _chip_models)[:2]
            scale = np.abs(g0).max()
            for storage, dot in settings:
                v, g = _run(kind, n, storage, dot, L, _chip_models)[:2]
                e = (abs(v - v0) / abs(v0), float(np.sqrt(np.mean((g - g0) ** 2)) / scale),
                     float(np.abs(g - g0).max() / scale))
                key = (kind, L, storage, dot)
                out[key] = tuple(max(a, b) for a, b in zip(out.get(key, (0, 0, 0)), e))
                print(f"chip-bars {kind} n={n} L={L} {storage}+{dot}: value "
                      f"{e[0]:.3e} grad rms {e[1]:.3e} max {e[2]:.3e}", flush=True)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["chip-bars"]:
        picked = [m for m in CHIP_MODELS if not sys.argv[2:] or f"{m[0]}{m[2]}" in sys.argv[2:]]
        for k, v in chip_bars(picked).items():
            print("chip-bars max over n", k, ["%.3e" % x for x in v])
        sys.exit(0)
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_paths") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
