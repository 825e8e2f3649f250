""""bf16" storage and the forward bf16x3 on ``AutoGradCircuit.build()``'s
``autodiff_run`` (the generic plane tape), and "f16" on its per-term
fallback, against the JAX package's plane tape (its Pallas kernels in
interpret mode) on the CPU.

* The reference's gradient gauntlet (tests/test_autodiff.py: every
  instruction kind, mid-circuit densities, non-unitary gates; 2 layers) at
  n = 15 and 14 (slow: the adjoints it runs are a subset of n = 15's) in
  three settings ("bf16" storage; the forward bf16x3 on f32 storage and
  both, slow): its unpaired lane and sublane adjoints, the
  variable diagonal runs' Q reductions (the dual and diag adjoints'), the
  cross-group gates and density seeds, on bf16 planes and in bf16x3.
* Under "bf16", chip_smoke's ``[diagq]`` tape at n = 14: a lone variable
  diagonal run, whose adjoint is the diag adjoint with its Q reductions.
* Under "f16", chip_smoke's per-term tape at n = 17: its variable dense
  gate on qubits (16, 7) (the sublane group and group 2, ten bits apart: no
  span view, no multi-term kernel) runs the per-term fallback, two sweeps
  per Schmidt term on the f16 cotangent through the dual and high applies
  (f16 input planes), beside variable gates on qubits 3 (the lane group),
  7, 10, 15 and 16 and densities with gradient on 7 and 16.

The tsallis loss's gradient of both packages against their own f32 runs
and each other, as fractions of its largest f32 entry, and the densities.
Bars: each package against its own f32 run within
tests/test_torch_fwd16_rings.py's ``OWN`` bars ("f16": 1e-2, the JAX
package's bar for dense cross-group gates under reduced storage), or 1.25
times the JAX package's own error where that is larger; the port against
the JAX package within ``VS_JAX``, 1.25 times the largest difference
measured here (``python tests/test_torch_fwd16_tape.py`` prints every
case; ``... chip-bars`` the JAX package's own error on the gauntlet at
14-16q, which ``[paths29_bf16]``'s tape bars rest on).
"""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_autodiff import av_tsallis, build_gauntlet, gauntlet_gates
from test_torch_tape import port_circuit, tsallis

from dqc_tpu import AutoGradCircuit as JCircuit
from dqc_tpu import config as jconfig

from dqc_tpu_torch import config, convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.ops import kernels as tk

from test_torch_fwd16_rings import IDS, OWN, SETTINGS

torch.set_num_threads(2)

F16_OWN = 1e-2
# the port against the JAX package, (densities abs, gradient of max |g|):
# 1.25 x the largest measured here (densities 1.11e-4, 6.91e-6, 1.93e-4,
# 5.96e-7 (f16), 5.06e-6 (the [diagq] tape); gradients 9.42e-4, 3.16e-5,
# 1.33e-3, 4.14e-6, 8.30e-5). Under "bf16" each package moves its gauntlet
# gradient up to 1.2e-3 from its own f32 run, and the two differ by as
# much: the bf16 rounding of planes whose f32 values differ in their last
# bits (the known difference of ROADMAP.md section C)
VS_JAX = {("bf16", "f32"): (1.39e-4, 1.18e-3), ("f32", "bf16x3"): (8.64e-6, 3.95e-5),
          ("bf16", "bf16x3"): (2.41e-4, 1.66e-3), ("f16", "f32"): (7.45e-7, 5.18e-6),
          ("diagq", "bf16"): (6.33e-6, 1.04e-4)}
MEASURED = {}


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set("f32", "f32")


def _set(storage, dot, engine="auto"):
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)
        c.set_plane_engine(engine)


def _run_tape(jc, vg, cg, storage, dot):
    """(JAX densities, JAX gradient, port densities, port gradient, JAX
    loss) of the tsallis loss of ``jc``'s tape in a setting, every density
    flattened, the gradients in torch's convention."""
    _set(storage, dot, True)
    try:
        _, jrun = jc.build()

        def loss_and_densities(a, b):
            dens = jrun(a, b)
            return av_tsallis(lambda *_: dens)(a, b), dens

        (_, jd), jg = jax.value_and_grad(loss_and_densities, has_aux=True)(
            [jnp.asarray(g) for g in vg], [jnp.asarray(g) for g in cg])
        c = port_circuit(jc)
        t_vg, t_cg, _ = convert.gates_from_jax(vg, cg, device="cpu")
        for g in t_vg:
            g.requires_grad_(True)
        _, run = c.build()
        dens = run(t_vg, t_cg)
        tsallis(dens).backward()
    finally:
        _set("f32", "f32")
    return (np.concatenate([np.asarray(d).ravel() for d in jd]),
            np.concatenate([np.conj(np.asarray(g)).ravel() for g in jg]),
            torch.cat([d.detach().reshape(-1) for d in dens]).numpy(),
            np.concatenate([g.grad.numpy().ravel() for g in t_vg]),
            float(av_tsallis(lambda *_: jd)(None, None)))


_RUNS = {}


GAUNTLET_LAYERS = 2   # the backward of the first layer stops at its
                      # constant prologue; the second runs the adjoints

def gauntlet_run(n, storage, dot):
    key = ("gauntlet", n, storage, dot)
    if key not in _RUNS:
        rng = np.random.default_rng(42)
        L = GAUNTLET_LAYERS
        jc = build_gauntlet(n, L)
        cg = [np.asarray(g) for g in gauntlet_gates(rng, n, L, var=False)]
        vg = [np.asarray(g) for g in gauntlet_gates(rng, n, L, var=True)]
        jref = JCircuit(n, dtype=jnp.complex64)
        jref.tape = jc.tape
        _RUNS[key] = _run_tape(jref, vg, cg, storage, dot)
    return _RUNS[key]


def _errors(run, storage, dot):
    jd0, jg0, td0, tg0 = run("f32", "f32")[:4]
    jd, jg, td, tg = run(storage, dot)[:4]
    s = np.abs(jg0).max()
    return dict(jax_own=float(np.abs(jg - jg0).max() / s),
                port_own=float(np.abs(tg - tg0).max() / s),
                vs_jax=(float(np.abs(td - jd).max()), float(np.abs(tg - jg).max() / s)),
                dens_own=(float(np.abs(jd - jd0).max()), float(np.abs(td - td0).max())))


def _check(tag, e, own_bar, vs):
    MEASURED.update({f"jax_own {tag}": e["jax_own"], f"port_own {tag}": e["port_own"],
                     f"vs_jax densities {tag}": e["vs_jax"][0],
                     f"vs_jax grad {tag}": e["vs_jax"][1]})
    assert 0 < e["port_own"] <= max(own_bar, 1.25 * e["jax_own"]), e
    assert e["vs_jax"][0] <= vs[0] and e["vs_jax"][1] <= vs[1], (e, vs)


# n = 15 runs every adjoint n = 14 runs (the dual adjoint and its Q) and
# the lane, sublane and high ones besides: n = 14 is slow (~100 s); at n =
# 15 "bf16" stays (~75 s), and the forward bf16x3 is slow: the models of
# tests/test_torch_fwd16_paths.py and the kernel tests of
# tests/test_torch_fwd16_q.py run its variants
GAUNTLET = [pytest.param(n, storage, dot, id=f"{n}-{i}",
                         marks=[pytest.mark.slow] if n == 14 or i != IDS[0] else [])
            for n in (14, 15) for (storage, dot), i in zip(SETTINGS, IDS)]


@pytest.mark.parametrize("n, storage, dot", GAUNTLET)
def test_gauntlet_matches_jax(n, storage, dot):
    e = _errors(lambda s, d: gauntlet_run(n, s, d), storage, dot)
    _check(f"gauntlet{n} {storage}+{dot}", e, OWN[storage, dot][1], VS_JAX[storage, dot])


N_PT = 17


def _per_term_circuit(n=N_PT, layers=1):
    """chip_smoke.per_term_tape on the JAX package's circuit."""
    from chip_smoke import per_term_tape
    return per_term_tape(JCircuit(n, dtype=jnp.complex64), layers)


def per_term_run(storage, dot, n=N_PT, layers=1):
    key = ("per_term", n, layers, storage, dot)
    if key not in _RUNS:
        jc = _per_term_circuit(n, layers)
        rng = np.random.default_rng(17)
        vg = []
        for inst in jc.tape.gates(var=True):
            d = 1 << inst.k
            q, _ = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
            vg.append(q.astype(np.complex64).reshape(-1))
        _RUNS[key] = _run_tape(jc, vg, [], storage, dot)
    return _RUNS[key]


def diagq_run(storage, dot, n=14):
    """chip_smoke.diag_q_tape (a lone variable diagonal run: the diag
    adjoint's Q) on both packages' plane tapes."""
    key = ("diagq", n, storage, dot)
    if key not in _RUNS:
        from chip_smoke import diag_q_tape, tape_gates
        jc = diag_q_tape(JCircuit(n, dtype=jnp.complex64), n)
        rng = np.random.default_rng(19)
        vg, cg = tape_gates(rng, jc.tape, True), tape_gates(rng, jc.tape, False)
        _RUNS[key] = _run_tape(jc, vg, cg, storage, dot)
    return _RUNS[key]


def test_diag_q_tape_matches_jax():
    """Under "bf16" the lone run's adjoint (diag_backward with its Q) on
    bf16 forward planes, in a tape."""
    e = _errors(diagq_run, "bf16", "f32")
    _check("diagq14 bf16+f32", e, OWN["bf16", "f32"][1], VS_JAX["diagq", "bf16"])


def test_per_term_tape_takes_the_fallback_and_f16_applies():
    """The (16, 7) gate runs the per-term fallback, and under "f16" its
    sweeps hand the f16 cotangent to the dual and high applies (recorded
    around their plain versions)."""
    c = port_circuit(_per_term_circuit())
    ftape = fuse_tape(c.tape)
    items = [item for item in tps.plane_program(ftape) if item[0] == "dcross"]
    assert len(items) == 1
    fi = ftape.instructions[items[0][1]]
    kind, _ = tps._cross_plan(np.eye(4, dtype=np.complex64), fi.positions, N_PT,
                              torch.device("cpu"))
    assert kind == "per_term"
    seen = []

    def spy(name, plain):
        def call(xr, xi, *a, **kw):
            seen.append((name, xr.dtype))
            return plain(xr, xi, *a, **kw)
        return call

    kernels = tk.PLAIN._replace(dual_apply=spy("dual_apply", tk.PLAIN.dual_apply),
                                high_apply=spy("high_apply", tk.PLAIN.high_apply))
    config.set_state_storage("f16")
    config.set_plane_engine(True)
    rng = np.random.default_rng(1)
    gates = []
    for inst in c.tape.gates(var=True):
        d = 1 << inst.k
        q, _ = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
        gates.append(torch.tensor(q.astype(np.complex64).reshape(-1), requires_grad=True))
    from dqc_tpu_torch.circuit.builder import autodiff_densities
    try:
        dens = autodiff_densities(ftape, c.initial_state(), gates, [], kernels=kernels)
        tsallis(dens).backward()
    finally:
        config.set_state_storage("f32")
        config.set_plane_engine("auto")
    assert ("dual_apply", torch.float16) in seen and ("high_apply", torch.float16) in seen


def test_per_term_fallback_f16_matches_jax():
    e = _errors(per_term_run, "f16", "f32")
    assert e["dens_own"] == (0.0, 0.0), "the forward planes stay f32 under f16"
    _check("per_term17 f16", e, F16_OWN, VS_JAX["f16", "f32"])


def chip_bars(ns=(14, 15, 16), per_term_ns=(17, 18)):
    """The JAX package's own error on chip_smoke's tapes: the gauntlet
    ([tape29]'s, 2 layers) at 14-16q in each setting, (value relative,
    gradient rms, max) of max |g32|; the per-term tape
    (chip_smoke.per_term_tape, 2 layers) under "f16" at 17-18q."""
    out = {}

    def add(key, v0, g0, v, g, label):
        scale = np.abs(g0).max()
        d = np.abs(g - g0) / scale
        e = (abs(v - v0) / abs(v0), float(np.sqrt(np.mean(d * d))), float(d.max()))
        out[key] = tuple(max(a, b) for a, b in zip(out.get(key, (0, 0, 0)), e))
        print(f"chip-bars {label}: value {e[0]:.3e} grad rms {e[1]:.3e} max {e[2]:.3e}",
              flush=True)

    for n in ns:
        r0 = gauntlet_run(n, "f32", "f32")
        for storage, dot in SETTINGS:
            r = gauntlet_run(n, storage, dot)
            add(("gauntlet", storage, dot), r0[4], r0[1], r[4], r[1],
                f"gauntlet n={n} {storage}+{dot}")
    for n in per_term_ns:
        r0, r = per_term_run("f32", "f32", n, 2), per_term_run("f16", "f32", n, 2)
        add(("per_term", "f16", "f32"), r0[4], r0[1], r[4], r[1], f"per_term n={n} f16")
    for n in ns:
        r0, r = diagq_run("f32", "f32", n), diagq_run("bf16", "f32", n)
        add(("diagq", "bf16", "f32"), r0[4], r0[1], r[4], r[1], f"diagq n={n} bf16")
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["chip-bars"]:
        for k, v in chip_bars().items():
            print("chip-bars max over n", k, ["%.3e" % x for x in v])
        sys.exit(0)
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_tape") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
