"""``autodiff_run`` under reduced cotangent storage, continued from
tests/test_torch_storage_tape.py (its docstring gives the cases and the
bars): the gauntlet at n = 16 against the JAX package, and a tape over
three groups more than eight bits apart at n = 19 against the port's own
f32 storage."""

import numpy as np
import pytest
import torch

from test_torch_storage_tape import OWN_BAR, _restore, check_gauntlet  # noqa: F401
from test_torch_tape import tsallis

from dqc_tpu_torch import AutoGradCircuit, config
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.fusion import fuse_tape

torch.set_num_threads(2)


@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_gauntlet_n16_reduced_storage_matches_jax(storage):
    check_gauntlet(16, storage)


def _far_tape(n):
    """A variable diagonal over three groups (mdiag), a variable dense gate
    over three groups whose high bits are nine apart (xcross without a span
    view), a density over the same three qubits and one across two, among
    single-qubit blocks."""
    c = AutoGradCircuit(n, device="cpu")
    for q in (0, 3, 9, n - 1):
        c.add_q1_var_gate(q)
    c.get_q2_dens_op_with_grad(8, 0)
    c.add_diag_gate((0, 8, n - 1), var=True)
    c.add_q1_var_gate(9)
    c.add_gate((3, 9, n - 1), var=True, unitary=False)
    c.add_q1_var_gate(1)
    c.get_q1_dens_op_with_grad(1)
    c.get_dens_op((n - 1, 3, 9), with_grad=True)
    return c


_FAR = {}


def _far_run(storage, n=19):
    if storage not in _FAR:
        c = _far_tape(n)
        kinds = {item[0] for item in tps.plane_program(fuse_tape(c.tape))}
        assert {"mdiag", "xcross"} <= kinds, kinds
        rng = np.random.default_rng(19)
        gates = []
        for inst in c.tape.gates(var=True):
            d = 1 << inst.k
            if inst.kind.name == "DIAG":
                gates.append(np.exp(1j * rng.uniform(0, 6.3, d)))
                continue
            q, _ = np.linalg.qr(rng.standard_normal((d, d))
                                + 1j * rng.standard_normal((d, d)))
            if not inst.unitary:
                q = q + 0.01 * (rng.standard_normal((d, d))
                                + 1j * rng.standard_normal((d, d)))
            gates.append(q.reshape(-1))
        vg = [torch.tensor(g.astype(np.complex64), requires_grad=True) for g in gates]
        config.set_state_storage(storage)
        config.set_plane_engine(True)
        try:
            _, run = c.build()
            dens = run(vg, [])
            tsallis(dens).backward()
        finally:
            config.set_state_storage("f32")
            config.set_plane_engine("auto")
        _FAR[storage] = (torch.stack([d.detach() for d in dens if d.shape == (2, 2)]),
                         torch.cat([g.grad.reshape(-1) for g in vg]))
    return _FAR[storage]


@pytest.mark.parametrize("storage", ["mixed", "f16"])
def test_far_tape_reduced_storage(storage):
    """The sub-block forms decode and encode the cotangent planes with the
    host codec: densities bit-identical to f32 storage, gradients within
    the storage's error of it."""
    d0, g0 = _far_run("f32")
    d, g = _far_run(storage)
    assert torch.equal(d, d0)
    rel = float((g - g0).abs().max() / g0.abs().max())
    assert 0 < rel <= OWN_BAR, rel
