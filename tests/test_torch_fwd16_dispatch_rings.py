"""Dispatch parity of the rings at the sizes only the card runs: every
kernel call of one ``HardwareEfficientAnsatz(n, 1, entangler)``
value-and-gradient hands its kernel the same plane shape, storages and dot
modes in the port as in the JAX package.

Models: the cz ring at n = 17, 20, 24 and 27 (the narrow high groups: group
2 at X = 8 / 64, group 3 at X = 8 / 64), the CNOT ring at n = 17, 23, 24 and
30 (the multi-term kernels, the X = 8 span views, the sublane adjoint, at
n = 23 and 30 the lone top-group block at X = 512), and in
tests/test_torch_fwd16_dispatch_expanded.py the expanded merged top
(``set_hpair_factorized(False)``) at n = 22 and 23. Settings: "bf16"
storage, the forward bf16x3 on f32 planes and on bf16 planes, and (the CNOT
ring at n = 17 and 30, whose cross-gate kernels took no bf16x3 before) the
forward bf16x3 under "mixed" and "f16". Each call is recorded as
tests/test_torch_fwd16_dispatch.py records it, with the plane shape beside
it (a Gram's contracted axis X: the two packages view the lane planes
differently), the JAX side under ``jax.eval_shape`` with its kernels
replaced by recording stand-ins (monkeypatched for the test; no file of
the JAX package changes), the port on the meta device through recording
plain versions; neither computes a state. The records must be equal, call
for call.
"""

import inspect

import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu import config as jconfig
from dqc_tpu.models.hardware_efficient import HardwareEfficientAnsatz as JHEA
from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas import block_backward as jbb

from dqc_tpu_torch import config
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk

from test_torch_fwd16_dispatch import _apply_record, _jax_stand_ins, _jname, _tname

FWD16 = [("bf16", "f32"), ("f32", "bf16x3"), ("bf16", "bf16x3")]
CROSS_X3 = [("mixed", "bf16x3"), ("f16", "bf16x3")]
APPLIES = ("dual_apply", "high_apply", "merged_fact_apply", "dual_multi_apply",
           "high_multi_apply")


def _shape_of(name, x, port=False):
    """What a call's record holds of its plane shape: a Gram's contracted
    axis (the port's Gram takes every view as (P, X, Q); the JAX package's
    lane and sublane Grams take the planes, gram_high the (A1, X, M, 128)
    view), else the whole view."""
    if name == "gram":
        return (128 if x.ndim == 3 and not port else x.shape[1],)
    return tuple(x.shape)


def _with_shapes(calls):
    """The JAX stand-ins of tests/test_torch_fwd16_dispatch.py, each record
    followed by its plane shape, and stand-ins for the cross-gate kernels
    and the unpaired minor adjoints."""
    inner = []
    stand = _jax_stand_ins(inner)

    def wrap(name, fn):
        def f(xr, *a, **kw):
            out = fn(xr, *a, **kw)
            calls.append(inner.pop() + (_shape_of(name, xr),))
            return out
        return f

    def multi(name):
        def f(xr, xi, *a, dot_mode="f32", alias=True, conj=False, acc=None,
              out_dtype=None, **kw):
            acc_dt = None if acc is None else acc[0].dtype
            calls.append(_apply_record(name, xr.dtype, acc_dt, out_dtype, alias,
                                       conj, dot_mode, _jname)
                         + (_shape_of(name, xr),))
            out = acc_dt or (jnp.dtype(out_dtype) if out_dtype is not None
                             else xr.dtype)
            return jnp.zeros(xr.shape, out), jnp.zeros(xr.shape, out)
        return f

    def minor(name):
        def f(fr, fi, br, bi, *ops, dot_mode="f32", bwd_dot_mode=None,
              gram_dot_mode=None, **kw):
            calls.append((name, _jname(fr.dtype), _jname(br.dtype), dot_mode,
                          bwd_dot_mode or dot_mode, gram_dot_mode or dot_mode,
                          tuple(fr.shape)))
            return ((jnp.zeros(fr.shape, fr.dtype),) * 2
                    + (jnp.zeros(br.shape, br.dtype),) * 2
                    + (jnp.zeros((128, 128), jnp.float32),) * 2)
        return f

    names = {"dual_group_apply_planes": "dual_apply",
             "high_group_apply_planes": "high_apply",
             "merged_fact_apply_planes": "merged_fact_apply", "gram_lane": "gram",
             "gram_sublane": "gram", "gram_high": "gram",
             "diag_sweep_planes": "diag_sweep", "diag_backward_planes": "diag_backward",
             "block_backward_dual": "block_backward_dual",
             "block_backward_high": "block_backward_high",
             "block_backward_merged_fact": "block_backward_merged_fact"}
    out = {key: wrap(names[key[1]], fn) for key, fn in stand.items()}
    out[jpl, "dual_multi_apply_planes"] = multi("dual_multi_apply")
    out[jpl, "high_multi_apply_planes"] = multi("high_multi_apply")
    out[jpl, "block_backward_sublane"] = minor("block_backward_sublane")
    out[jpl, "block_backward_lane"] = minor("block_backward_lane")
    return out


@pytest.fixture
def jax_calls(monkeypatch):
    calls = []
    for (mod, name), fn in _with_shapes(calls).items():
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, fn)
    return calls


def _port_kernels(calls):
    """The plain versions, each call recorded as the JAX stand-ins do."""
    def recording(name, plain):
        sig = inspect.signature(plain)

        def call(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            x = a["xr"] if "xr" in a else a["fr"]
            if name in APPLIES:
                acc = a.get("acc")
                rec = _apply_record(
                    name, a["xr"].dtype, None if acc is None else acc[0].dtype,
                    a.get("out_dtype"), a.get("alias", True), a.get("conj", False),
                    a.get("dot_mode", "f32"), _tname)
            elif name == "gram":
                rec = ("gram", _tname(a["xr"].dtype), None, a.get("dot_mode", "f32"))
            elif name == "diag_sweep":
                rec = ("diag_sweep", _tname(a["xr"].dtype), None, "f32")
            elif name == "diag_backward":
                rec = ("diag_backward", _tname(a["fr"].dtype), _tname(a["br"].dtype),
                       "f32")
            else:
                rec = (name, _tname(a["fr"].dtype), _tname(a["br"].dtype),
                       a.get("dot_mode", "f32"), a.get("bwd_mode", "f32"),
                       a.get("gram_mode", "f32"))
            calls.append(rec + (_shape_of(name, x, port=True),))
            return plain(*args, **kw)
        return call
    return tk.KernelSet(*(recording(f, p) for f, p in
                          zip(tk.KernelSet._fields, tk.PLAIN)))


def _set_both(storage, dot, factorized=True):
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)
        c.set_hpair_factorized(factorized)


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set_both("f32", "f32")
    jconfig.set_plane_engine("auto")


def records(jax_calls, entangler, n):
    """(the JAX package's records, the port's) of one layer's
    value-and-gradient in the current setting."""
    jax_calls.clear()
    jconfig.set_plane_engine(True)
    m = JHEA(n, 1, entangler=entangler, dtype=jnp.complex64, scan=True)
    jax.eval_shape(jax.value_and_grad(m.magnetization),
                   jax.ShapeDtypeStruct((1, n, 3), jnp.float32))
    want = list(jax_calls)
    got = []
    tm = THEA(n, 1, entangler, device="meta")
    p = torch.zeros((1, n, 3), device="meta", requires_grad=True)
    tm.magnetization(p, kernels=_port_kernels(got)).backward()
    return want, got


def check(jax_calls, entangler, ns, settings, factorized=True):
    mismatches = []
    for n in ns:
        for storage, dot in settings:
            _set_both(storage, dot, factorized)
            want, got = records(jax_calls, entangler, n)
            if got != want:
                mismatches.append((entangler, n, storage, dot, got, want))
    assert not mismatches, mismatches[0]


def test_cz_ring_narrow_groups(jax_calls):
    check(jax_calls, "cz", (17, 20, 24, 27), FWD16)


@pytest.mark.parametrize("n", [17, 23, 24, 30])
def test_cnot_ring(n, jax_calls):
    """The three settings at each size; the forward bf16x3 under "mixed" /
    "f16" at n = 17 and 30 (the same calls at n = 23 and 24 as there)."""
    check(jax_calls, "cnot", (n,), FWD16 + (CROSS_X3 if n in (17, 30) else []))


def test_cnot_ring_reaches_the_new_variants(jax_calls):
    """What the records above hold: under "bf16" the CNOT ring at n = 30
    runs the multi-term applies and the sublane adjoint on bf16 planes, the
    high kernels at X = 8 and the lone top-group block at X = 512 (the
    in-place apply and its adjoint) on bf16 forward planes."""
    _set_both("bf16", "f32")
    _, got = records(jax_calls, "cnot", 30)
    names = {(c[0], c[-1][1] if c[0] != "gram" else c[-1][0]) for c in got}
    for want in (("dual_multi_apply", 128), ("high_multi_apply", 8),
                 ("block_backward_sublane", 128), ("high_apply", 8),
                 ("block_backward_high", 8), ("high_apply", 512),
                 ("block_backward_high", 512)):
        assert want in names, (want, sorted(names))
    assert all(c[1] == "bf16" for c in got if c[0] != "gram")
