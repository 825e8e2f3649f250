"""Dispatch parity of VQE, QAOA and ``autodiff_run``'s plane tape at the
sizes only the card runs: every kernel call of one value-and-gradient
hands its kernel the same plane shape, storages, dot modes and Q flag in
the port as in the JAX package.

Models: ``VQEIsing(n, 1)``, ``QAOAMaxCut(n, ring + chords, 1)`` and the
reference's gradient gauntlet (2 layers, as chip_smoke's ``[tape29]``) at
n = 20, 24, 27, 29 and 30 (group
2 at X = 64 with its runs' Q at 20; group 3 at X = 8 / 64 beside group 2 at
24 / 27; the merged top at 29 / 30), in "bf16" storage, the forward bf16x3
on f32 planes and on bf16 planes; and under "f16" a tape whose dense gate
on qubits (16, 7) takes the per-term fallback (chip_smoke.per_term_tape:
the f16 cotangent into the dual and high applies) at n = 20 and 29. The JAX side runs under
``jax.eval_shape`` with each kernel wrapped (monkeypatched for the test; no
file of the JAX package changes) by a stand-in that records the call and
hands it on, abstractly, to the kernel; the port runs on the meta device
through recording plain versions. Neither computes a state. Each call is
recorded as

    (kernel, storage of its forward / input planes, storage of its
     cotangent / output planes, forward dot mode, transport mode, gram
     mode, Q (diag_q / with_q), plane shape)

(a Gram's record holds its contracted axis; applies their seed storage),
and the records must be equal, call for call.
"""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_autodiff import build_gauntlet, gauntlet_gates

from dqc_tpu import AutoGradCircuit as JCircuit
from dqc_tpu import config as jconfig
from dqc_tpu.models.qaoa import QAOAMaxCut as JQAOA
from dqc_tpu.models.vqe_ising import VQEIsing as JVQE
from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas import block_backward as jbb

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.models.qaoa import QAOAMaxCut as TQAOA
from dqc_tpu_torch.models.vqe_ising import VQEIsing as TVQE
from dqc_tpu_torch.ops import kernels as tk

from test_torch_fwd16_dispatch import _apply_record, _jname, _tname
from test_torch_tape import port_circuit, tsallis

FWD16 = [("bf16", "f32"), ("f32", "bf16x3"), ("bf16", "bf16x3")]
NS = [20, 24, 27, 29, 30]
APPLIES = ("dual_apply", "high_apply", "merged_fact_apply", "dual_multi_apply",
           "high_multi_apply")
# the JAX kernels each model's dispatch reaches, by namespace, and the
# port's KernelSet field each stands for
JAX_KERNELS = {
    (jpl, "dual_group_apply_planes"): "dual_apply",
    (jpl, "high_group_apply_planes"): "high_apply",
    (jpl, "merged_fact_apply_planes"): "merged_fact_apply",
    (jpl, "dual_multi_apply_planes"): "dual_multi_apply",
    (jpl, "high_multi_apply_planes"): "high_multi_apply",
    (jpl, "gram_lane"): "gram", (jpl, "gram_sublane"): "gram",
    (jpl, "gram_high"): "gram",
    (jpl, "diag_sweep_planes"): "diag_sweep",
    (jpl, "diag_backward_planes"): "diag_backward",
    (jbb, "block_backward_dual"): "block_backward_dual",
    (jbb, "block_backward_high"): "block_backward_high",
    (jpl, "block_backward_high"): "block_backward_high",
    (jpl, "block_backward_merged_fact"): "block_backward_merged_fact",
    (jpl, "block_backward_lane"): "block_backward_lane",
    (jpl, "block_backward_sublane"): "block_backward_sublane",
}


def _record(name, a, dname, port):
    """One call's record from its bound arguments ``a``."""
    x = a["xr"] if "xr" in a else a["fr"]
    if name == "gram":
        shape = (128 if x.ndim == 3 and not port else x.shape[1],)
    else:
        shape = tuple(x.shape)
    if name in APPLIES:
        acc = a.get("acc")
        rec = _apply_record(name, x.dtype, None if acc is None else acc[0].dtype,
                            a.get("out_dtype"), a.get("alias", True),
                            a.get("conj", False), a.get("dot_mode", "f32"), dname)
        return rec + (shape,)
    if name == "gram":
        return ("gram", dname(x.dtype), a.get("dot_mode", "f32"), shape)
    if name == "diag_sweep":
        return ("diag_sweep", dname(x.dtype), shape)
    if name == "diag_backward":
        return ("diag_backward", dname(x.dtype), dname(a["br"].dtype),
                bool(a.get("with_q", False)), shape)
    dot = a.get("dot_mode", "f32")
    if port:
        bwd, gram = a.get("bwd_mode", "f32"), a.get("gram_mode", "f32")
    else:
        bwd = a.get("bwd_dot_mode") or dot
        gram = a.get("gram_dot_mode") or bwd
    return (name, dname(x.dtype), dname(a["br"].dtype), dot, bwd, gram,
            bool(a.get("diag_q", False)), shape)


@pytest.fixture
def jax_calls(monkeypatch):
    calls = []
    for (mod, fn_name), name in JAX_KERNELS.items():
        if not hasattr(mod, fn_name):
            continue
        orig = getattr(mod, fn_name)
        sig = inspect.signature(orig)

        def stand_in(*args, _orig=orig, _sig=sig, _name=name, **kw):
            a = _sig.bind(*args, **kw).arguments
            a.update(a.pop("kwargs", {}))
            calls.append(_record(_name, a, _jname, False))
            return _orig(*args, **kw)
        monkeypatch.setattr(mod, fn_name, stand_in)
    return calls


def _port_kernels(calls):
    def recording(name, plain):
        sig = inspect.signature(plain)

        def call(*args, **kw):
            calls.append(_record(name, sig.bind(*args, **kw).arguments, _tname, True))
            return plain(*args, **kw)
        return call
    return tk.KernelSet(*(recording(f, p) for f, p in
                          zip(tk.KernelSet._fields, tk.PLAIN)))


def _set_both(storage, dot):
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set_both("f32", "f32")
    jconfig.set_plane_engine("auto")


def _edges(n):
    return [(i, (i + 1) % n) for i in range(n)] + [(2, 9), (3, n - 2), (8, n - 5)]


_RECORDS = {}


def _cached(key, make):
    """``make()`` once per key and setting in a process (the reach test
    reads what the parity tests recorded)."""
    key = key + (config.state_storage(), config.kernel_dot_mode())
    if key not in _RECORDS:
        _RECORDS[key] = make()
    return _RECORDS[key]


def _model_records(jax_calls, kind, n):
    return _cached((kind, n), lambda: _model_records_uncached(jax_calls, kind, n))


def _model_records_uncached(jax_calls, kind, n):
    """(the JAX package's records, the port's) of one value-and-gradient of
    ``VQEIsing(n, 1)`` or ``QAOAMaxCut(n, _edges(n), 1)``."""
    jax_calls.clear()
    jconfig.set_plane_engine(True)
    if kind == "vqe":
        jm, tm, loss = JVQE(n, 1, scan=True), TVQE(n, 1, scan=True, device="meta"), "energy"
    else:
        jm = JQAOA(n, _edges(n), layers_number=1, scan=True)
        tm, loss = TQAOA(n, _edges(n), layers_number=1, scan=True, device="meta"), "loss"
    jax.eval_shape(jax.value_and_grad(getattr(jm, loss)),
                   jax.ShapeDtypeStruct((2,), jnp.float32))
    want = list(jax_calls)
    got = []
    p = torch.zeros((2,), device="meta", requires_grad=True)
    getattr(tm, loss)(p, kernels=_port_kernels(got)).backward()
    return want, got


def _tape_records(jax_calls, jc, cg, key=None):
    """The same of ``jc``'s tape through ``build()``'s ``autodiff_run``
    (its tsallis loss; the constant gates given); cached under ``key``."""
    if key is not None:
        return _cached(key, lambda: _tape_records(jax_calls, jc, cg))
    jax_calls.clear()
    jconfig.set_plane_engine(True)
    _, jrun = jc.build()
    var = [jax.ShapeDtypeStruct((inst.gate_size(),), jnp.complex64)
           for inst in jc.tape.gates(var=True)]
    jcg = [jnp.asarray(g) for g in cg]

    def loss(vg):
        dens = jrun(vg, jcg)
        return sum(jnp.real(1 - jnp.einsum("ij,ji->", d, d)) for d in dens) / len(dens)

    jax.eval_shape(jax.value_and_grad(loss), var)
    want = list(jax_calls)
    got = []
    ftape = fuse_tape(port_circuit(jc).tape)
    tv = [torch.zeros(s.shape, dtype=torch.complex64, device="meta").requires_grad_(True)
          for s in var]
    tcg = [torch.as_tensor(np.asarray(g)).to("meta") for g in cg]
    state = torch.zeros(1 << jc.n, dtype=torch.complex64, device="meta")
    tsallis(tps.plane_tape_forward(ftape, state, tv, tcg,
                                   kernels=_port_kernels(got))).backward()
    return want, got


def _gauntlet(n):
    L = 2   # the backward of the first layer stops at its constant prologue
    jc = build_gauntlet(n, L)
    jref = JCircuit(n, dtype=jnp.complex64)
    jref.tape = jc.tape
    cg = [np.asarray(g) for g in gauntlet_gates(np.random.default_rng(42), n, L,
                                                var=False)]
    return jref, cg


def _per_term(n):
    from chip_smoke import per_term_tape
    return per_term_tape(JCircuit(n, dtype=jnp.complex64), 1), []


def _check(records, settings):
    mismatches = []
    for storage, dot in settings:
        _set_both(storage, dot)
        want, got = records()
        if got != want:
            mismatches.append((storage, dot, got, want))
    assert not mismatches, mismatches[0]


# ~10-50 s a case on the CPU, so most are slow: VQE at n = 20 (group 2 at
# X = 64) and 29 (the merged top) run the dispatch code n = 24, 27 and 30
# run at other X; QAOA adds to VQE's the seeds of its chords, held at n =
# 29; the gauntlet at n = 29 runs every adjoint the others run (the lane
# adjoint, the high and dual adjoints' Q); the per-term tape at n = 20
SLOW = {"vqe": (24, 27, 30), "qaoa": (20, 24, 27, 30), "gauntlet": (20, 24, 27, 30)}


def _ns(kind):
    return [pytest.param(n, marks=pytest.mark.slow) if n in SLOW[kind] else n
            for n in NS]


@pytest.mark.parametrize("n", _ns("vqe"))
def test_vqe_dispatch_matches_jax(n, jax_calls):
    _check(lambda: _model_records(jax_calls, "vqe", n), FWD16)


@pytest.mark.parametrize("n", _ns("qaoa"))
def test_qaoa_dispatch_matches_jax(n, jax_calls):
    _check(lambda: _model_records(jax_calls, "qaoa", n), FWD16)


@pytest.mark.parametrize("n", _ns("gauntlet"))
def test_gauntlet_dispatch_matches_jax(n, jax_calls):
    jc, cg = _gauntlet(n)
    _check(lambda: _tape_records(jax_calls, jc, cg, ("gauntlet", n)), FWD16)


@pytest.mark.parametrize("n", [20, pytest.param(29, marks=pytest.mark.slow)])
def test_per_term_f16_dispatch_matches_jax(n, jax_calls):
    jc, cg = _per_term(n)
    _check(lambda: _tape_records(jax_calls, jc, cg, ("per_term", n)),
           [("f16", "f32"), ("f16", "bf16x3")])


def test_paths_reach_the_new_variants(jax_calls):
    """What the records above hold: under "bf16" VQE at n = 20 takes a
    run's Q in the dual adjoint on bf16 planes and runs the high adjoint on
    bf16 planes at X = 64 (group 2); the gauntlet at n = 29 runs
    the lane adjoint and the high adjoint with a run's Q on bf16 planes;
    under "f16" the per-term tape hands f16 planes to the dual and high
    applies."""
    _set_both("bf16", "f32")
    got = _model_records(jax_calls, "vqe", 20)[1]
    assert ("block_backward_dual", "bf16", "bf16", "f32", "bf16x3", "bf16x3", True,
            (64, 128, 128)) in got, got
    assert any(c[0] == "block_backward_high" and c[1] == "bf16"
               and c[-1][1] == 64 for c in got), got
    got = _tape_records(jax_calls, *_gauntlet(29), ("gauntlet", 29))[1]
    assert any(c[0] == "block_backward_lane" and c[1] == "bf16" for c in got), got
    assert any(c[0] == "block_backward_high" and c[1] == "bf16" and c[6]
               for c in got), got
    _set_both("f16", "f32")
    got = _tape_records(jax_calls, *_per_term(20), ("per_term", 20))[1]
    assert ("dual_apply", "f16", "f16", "f32", (64, 128, 128)) in got, got
    assert any(c[0] == "high_apply" and c[1] == "f16" for c in got), got
