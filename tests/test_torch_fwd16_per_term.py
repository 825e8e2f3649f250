""""bf16" storage and the forward bf16x3 on the per-term fallback of a dense
cross-group gate, through ``AutoGradCircuit.build()``'s ``autodiff_run``
on both packages' plane tapes (the JAX side's Pallas kernels in interpret
mode), on the CPU.

The tape at n = 17: a variable dense gate on qubits (16, 7), the sublane
group and group 2 ten bits apart, which has no span view and no
multi-term kernel, so both packages run it as two accumulate sweeps per
Schmidt term (``plane_scan._apply_dense_cross``): its forward as seeds
from the forward planes into fresh ones, its uncompute on bf16 F and its
transport on bf16 B through the dual and high applies, each term stored
in the input's storage; a variable gate on qubit 10 and one on 15 around
it and a density with gradient on qubit 9 (tests/test_torch_fwd16_tape.py
runs the per-term fallback under "f16" on a tape whose densities the
gates move, with a lane-group block). Densities and the
tsallis loss's gradient of both packages in three settings ("bf16", f32 +
bf16x3, both) against their own f32 runs and each other; bars as
tests/test_torch_fwd16_rings.py's (its docstring states them), the port
against the JAX package within 1.25 times the largest difference measured
here (``python tests/test_torch_fwd16_per_term.py`` prints them).
"""

import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_autodiff import av_tsallis
from test_torch_tape import port_circuit, tsallis

from dqc_tpu import AutoGradCircuit as JCircuit
from dqc_tpu import config as jconfig

from dqc_tpu_torch import config, convert
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.fusion import fuse_tape

from test_torch_fwd16_rings import IDS, OWN, SETTINGS

torch.set_num_threads(2)

N = 17
# the port against the JAX package, (densities abs, gradient of max |g|):
# 1.25 x the measured (densities 5.96e-8, 9.54e-7, 5.96e-8; gradients
# 5.09e-6, 1.39e-5, 4.27e-6), where each package moves 8.7e-3 ("bf16") and
# 7.1e-6 (f32 + bf16x3) from its own f32 run
VS_JAX = {("bf16", "f32"): (7.5e-8, 6.4e-6), ("f32", "bf16x3"): (1.2e-6, 1.74e-5),
          ("bf16", "bf16x3"): (7.5e-8, 5.4e-6)}
MEASURED = {}


@pytest.fixture(autouse=True)
def _restore():
    yield
    for c in (jconfig, config):
        c.set_state_storage("f32")
        c.set_kernel_dot_mode("f32")
        c.set_plane_engine("auto")


def _jax_circuit():
    jc = JCircuit(N, dtype=jnp.complex64)
    jc.add_q1_var_gate(10)
    jc.add_q2_var_gate(16, 7)
    jc.add_q1_var_gate(15)
    jc.get_q1_dens_op_with_grad(9)
    return jc


def _gates(jc):
    rng = np.random.default_rng(17)
    out = []
    for inst in jc.tape.gates(var=True):
        d = 1 << inst.k
        q, _ = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
        out.append(q.astype(np.complex64).reshape(-1))
    return out


_RUNS = {}


def _run(storage, dot):
    """(JAX densities, JAX gradient, port densities, port gradient), the
    gradients in torch's convention, cached per process."""
    key = (storage, dot)
    if key in _RUNS:
        return _RUNS[key]
    jc = _jax_circuit()
    vg = _gates(jc)
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)
        c.set_plane_engine(True)
    try:
        _, jrun = jc.build()

        def loss_and_densities(a, b):
            dens = jrun(a, b)
            return av_tsallis(lambda *_: dens)(a, b), dens

        (_, jd), jg = jax.value_and_grad(loss_and_densities, has_aux=True)(
            [jnp.asarray(g) for g in vg], [])
        c = port_circuit(jc)
        t_vg, _, _ = convert.gates_from_jax(vg, [], device="cpu")
        for g in t_vg:
            g.requires_grad_(True)
        _, run = c.build()
        dens = run(t_vg, [])
        tsallis(dens).backward()
    finally:
        for c_ in (jconfig, config):
            c_.set_state_storage("f32")
            c_.set_kernel_dot_mode("f32")
            c_.set_plane_engine("auto")
    _RUNS[key] = (np.stack([np.asarray(d) for d in jd]),
                  np.concatenate([np.conj(np.asarray(g)).ravel() for g in jg]),
                  torch.stack([d.detach() for d in dens]).numpy(),
                  np.concatenate([g.grad.numpy().ravel() for g in t_vg]))
    return _RUNS[key]


def test_the_gate_takes_the_per_term_fallback():
    c = port_circuit(_jax_circuit())
    ftape = fuse_tape(c.tape)
    items = [item for item in tps.plane_program(ftape) if item[0] == "dcross"]
    assert len(items) == 1
    fi = ftape.instructions[items[0][1]]
    kind, _ = tps._cross_plan(np.eye(4, dtype=np.complex64), fi.positions, N,
                              torch.device("cpu"))
    assert kind == "per_term"


# both settings together (~25 s on the CPU) run the variants each of the
# other two runs
@pytest.mark.parametrize("storage, dot", SETTINGS[:2] + [
    pytest.param(*SETTINGS[2], marks=pytest.mark.slow)], ids=IDS)
def test_per_term_fallback_matches_jax(storage, dot):
    jd0, jg0, td0, tg0 = _run("f32", "f32")
    jd, jg, td, tg = _run(storage, dot)
    s = np.abs(jg0).max()
    e_jax, e_port = np.abs(jg - jg0).max() / s, np.abs(tg - tg0).max() / s
    vs = (float(np.abs(td - jd).max()), float(np.abs(tg - jg).max() / s))
    tag = f"{storage}+{dot}"
    MEASURED.update({f"jax_own {tag}": e_jax, f"port_own {tag}": e_port,
                     f"vs_jax densities {tag}": vs[0], f"vs_jax grad {tag}": vs[1]})
    assert 0 < e_port <= max(OWN[storage, dot][1], 1.25 * e_jax), (e_port, e_jax)
    assert vs[0] <= VS_JAX[storage, dot][0] and vs[1] <= VS_JAX[storage, dot][1], vs


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_per_term") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
