"""``AutoGradCircuit.build()``'s ``autodiff_run`` on the generic plane tape
under reduced cotangent storage ("mixed", "f16") against the JAX package
on the CPU.

* The reference's gradient gauntlet (tests/test_autodiff.py: every
  instruction kind, mid-circuit densities, non-unitary gates; 2 layers) at
  n = 14, 15 (this file) and 16 (tests/test_torch_storage_tape16.py) on
  both packages' plane tapes, the JAX side's Pallas kernels in interpret
  mode: its cross-group density seeds (the multi-term applies and the X = 8
  span seeds into reduced planes), the adjoints of its cross-group gates
  (the multi-term applies in place on the cotangent, ``_plane_pair_grad``),
  the unpaired lane and sublane adjoints and the variable diagonal runs.
* A tape whose gates and densities span three groups more than eight bits
  apart at n = 19 (tests/test_torch_storage_tape16.py): the plain-torch
  sub-block forms (``_apply_xcross``, its seed and transport, the
  >2-group diagonal), against the port's own f32 storage.

Bars, as fractions of the largest f32-storage gradient entry: densities
bit-identical to f32 storage in each package (the forward planes are f32);
each package against its own f32 storage within 1e-2 (the JAX package's
bar for dense cross-group gates under reduced storage,
tests/test_state_storage.py::test_dense_cross_mixed); the port against the
JAX package in the same mode within tests/test_torch_storage.py's bar for
f16 under the default bf16x3 transport (3e-4), and under "mixed" within
1.25 times the largest measured difference, 8.54e-4 at n = 16 (``python
tests/test_torch_storage_tape.py`` prints them): the bf16 cotangent's
8-bit rounding moves the gradient by up to its own error when the f32
planes it rounds differ in their last bits, as the two packages' do
(tests/test_torch_storage_models.py measures that on the CNOT ring).
"""

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

torch.set_num_threads(2)

OWN_BAR = 1e-2
PORT_VS_JAX = {"mixed": 1.25 * 8.54e-4, "f16": 3e-4}


@pytest.fixture(autouse=True)
def _restore():
    yield
    for c in (jconfig, config):
        c.set_state_storage("f32")
        c.set_plane_engine("auto")


_RUNS = {}


def gauntlet_run(n, storage):
    """(JAX densities, JAX gradients, port densities, port gradients) of the
    gauntlet's tsallis loss under a storage (gradients in torch's
    convention, flattened), cached per test process."""
    key = (n, storage)
    if key in _RUNS:
        return _RUNS[key]
    rng = np.random.default_rng(42)
    jc = build_gauntlet(n, 2)
    cg = [np.asarray(g) for g in gauntlet_gates(rng, n, 2, var=False)]
    vg = [np.asarray(g) for g in gauntlet_gates(rng, n, 2, var=True)]
    jref = JCircuit(n, dtype=jnp.complex64)
    jref.tape = jc.tape
    jconfig.set_state_storage(storage)
    jconfig.set_plane_engine(True)
    try:
        _, jrun = jref.build()

        def loss_and_densities(a, b):
            dens = jrun(a, b)
            return av_tsallis(lambda *_: dens)(a, b), dens

        (_, jd), jg = jax.value_and_grad(loss_and_densities, has_aux=True)(
            [jnp.asarray(g) for g in vg], [jnp.asarray(g) for g in cg])
    finally:
        jconfig.set_state_storage("f32")
        jconfig.set_plane_engine("auto")
    c = port_circuit(jc)
    t_vg, t_cg, _ = convert.gates_from_jax(vg, cg, device="cpu")
    for g in t_vg:
        g.requires_grad_(True)
    config.set_state_storage(storage)
    config.set_plane_engine(True)
    try:
        _, run = c.build()
        dens = run(t_vg, t_cg)
        tsallis(dens).backward()
    finally:
        config.set_state_storage("f32")
        config.set_plane_engine("auto")
    # torch's gradient of a complex tensor is the conjugate of JAX's cotangent
    _RUNS[key] = (np.stack([np.asarray(d) for d in jd[:n]]),
                  np.concatenate([np.conj(np.asarray(g)).ravel() for g in jg]),
                  torch.stack([d.detach() for d in dens[:n]]).numpy(),
                  np.concatenate([g.grad.numpy().ravel() for g in t_vg]))
    return _RUNS[key]


def gauntlet_errors(n, storage):
    jd0, jg0, td0, tg0 = gauntlet_run(n, "f32")
    jd, jg, td, tg = gauntlet_run(n, storage)
    np.testing.assert_array_equal(jd, jd0)
    np.testing.assert_array_equal(td, td0)
    s = np.abs(jg0).max()
    return (np.abs(jg - jg0).max() / s, np.abs(tg - tg0).max() / s,
            np.abs(tg - jg).max() / s)


def check_gauntlet(n, storage):
    e_jax, e_port, e_vs = gauntlet_errors(n, storage)
    assert 0 < e_jax and 0 < e_port, "the storage must round something"
    assert e_port <= max(OWN_BAR, 1.25 * e_jax), (e_port, e_jax)
    assert e_vs <= PORT_VS_JAX[storage], (e_vs, PORT_VS_JAX[storage])


@pytest.mark.parametrize("storage", ["mixed", "f16"])
@pytest.mark.parametrize("n", [14, 15])
def test_gauntlet_reduced_storage_matches_jax(n, storage):
    check_gauntlet(n, storage)


if __name__ == "__main__":
    # The measured errors behind the bars (takes a few minutes):
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_storage_tape.py
    jax.config.update("jax_platforms", "cpu")
    # (the rms of the JAX package's own error bounds chip_smoke.py's
    # [tape29_f16] and [paths29_mixed] tape bars)
    for n in (14, 15, 16):
        for storage in ("mixed", "f16"):
            e_jax, e_port, e_vs = gauntlet_errors(n, storage)
            jg0, jg = gauntlet_run(n, "f32")[1], gauntlet_run(n, storage)[1]
            d = np.abs(jg - jg0) / np.abs(jg0).max()
            print(f"gauntlet n={n} {storage:5s} jax-own {e_jax:.2e} (rms "
                  f"{np.sqrt((d * d).mean()):.2e}) port-own {e_port:.2e} "
                  f"port-jax {e_vs:.2e}", flush=True)
