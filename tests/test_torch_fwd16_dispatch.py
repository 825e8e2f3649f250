"""Dispatch parity of the cz layer: every kernel call of one
``HardwareEfficientAnsatz(n, 1, "cz")`` value-and-gradient hands its kernel
the same modes and plane storages in the port as in the JAX package.

For each storage ("f32", "mixed", "f16", "bf16") x forward dot mode ("f32",
"bf16x3") x backward and pair-gram modes ("auto", "f32", "bf16x3"), both
packages run the layer at n = 22 (the merged top: the X = 256 seed, the
factorized merged sweep and its adjoint) and n = 21 (group 2 alone at
X = 128: its apply, seed, Gram and adjoint; there in three of the nine
backward / gram pairs, which reach the same dispatch code), and each
kernel call is recorded as

    (kernel, storage of its forward / input planes, storage of its
     cotangent / output planes, forward dot mode, transport mode, gram mode)

The JAX side runs under ``jax.eval_shape`` with its kernels replaced, in
the ``dqc_tpu.ops.planes`` and ``dqc_tpu.ops.pallas.block_backward``
namespaces (monkeypatched for the test; no file of the JAX package
changes), by stand-ins that record the call and return zeros of the
kernel's output shapes; the port runs on the meta device through recording
plain versions. Neither computes a 2^22 state. The records must be equal,
call for call. In particular the factorized merged-top adjoint gets an f32
transport wherever the backward mode resolves to "bf16x3"
(``dqc_tpu/ops/planes.py`` ``backward_merged_top_fact``).
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

STORAGES = ["f32", "mixed", "f16", "bf16"]
DOTS = ["f32", "bf16x3"]
BWD = ["auto", "f32", "bf16x3"]


def _jname(dt):
    return {"float32": "f32", "bfloat16": "bf16", "uint16": "f16"}[jnp.dtype(dt).name]


def _tname(dt):
    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[dt]


def _apply_record(name, xdt, acc_dt, out_dt, alias, conj, dot, dname):
    seed = acc_dt is not None or not alias or conj
    out = acc_dt if acc_dt is not None else (out_dt or xdt)
    return (name, dname(xdt), dname(out) if seed else None, dot)


def _jax_stand_ins(calls):
    """name in the JAX namespaces -> a recording stand-in."""
    def apply(name):
        def f(xr, xi, *a, dot_mode="f32", alias=True, conj=False, acc=None,
              out_dtype=None, **kw):
            acc_dt = None if acc is None else acc[0].dtype
            calls.append(_apply_record(name, xr.dtype, acc_dt, out_dtype, alias,
                                       conj, dot_mode, _jname))
            out = acc_dt or (jnp.dtype(out_dtype) if out_dtype is not None
                             else xr.dtype)
            return jnp.zeros(xr.shape, out), jnp.zeros(xr.shape, out)
        return f

    def gram(xr, xi, *, dot_mode="f32", **kw):
        X = 128 if xr.ndim == 3 else xr.shape[1]
        calls.append(("gram", _jname(xr.dtype), None, dot_mode))
        return jnp.zeros((X, X), jnp.float32), jnp.zeros((X, X), jnp.float32)

    def adjoint(name, extra):
        def f(fr, fi, br, bi, *ops, dot_mode="f32", bwd_dot_mode=None,
              gram_dot_mode=None, **kw):
            calls.append((name, _jname(fr.dtype), _jname(br.dtype), dot_mode,
                          bwd_dot_mode or dot_mode, gram_dot_mode or dot_mode))
            planes = (jnp.zeros(fr.shape, fr.dtype),) * 2 + (
                jnp.zeros(br.shape, br.dtype),) * 2
            return planes + extra(fr, kw)
        return f

    def diag_sweep(xr, xi, *tables, **kw):
        calls.append(("diag_sweep", _jname(xr.dtype), None, "f32"))
        return jnp.zeros(xr.shape, xr.dtype), jnp.zeros(xr.shape, xr.dtype)

    def diag_backward(fr, fi, br, bi, *tables, with_q=False, **kw):
        assert not with_q
        calls.append(("diag_backward", _jname(fr.dtype), _jname(br.dtype), "f32"))
        return (jnp.zeros(fr.shape, fr.dtype),) * 2 + (jnp.zeros(br.shape, br.dtype),) * 2

    sq = lambda X: jnp.zeros((X, X), jnp.float32)  # noqa: E731
    return {
        (jpl, "dual_group_apply_planes"): apply("dual_apply"),
        (jpl, "high_group_apply_planes"): apply("high_apply"),
        (jpl, "merged_fact_apply_planes"): apply("merged_fact_apply"),
        (jpl, "gram_lane"): gram, (jpl, "gram_sublane"): gram,
        (jpl, "gram_high"): gram,
        (jpl, "diag_sweep_planes"): diag_sweep,
        (jpl, "diag_backward_planes"): diag_backward,
        (jbb, "block_backward_dual"): adjoint(
            "block_backward_dual", lambda fr, kw: (sq(128),) * 4),
        (jbb, "block_backward_high"): adjoint(
            "block_backward_high", lambda fr, kw: (sq(fr.shape[1]),) * 2),
        (jpl, "block_backward_high"): adjoint(
            "block_backward_high", lambda fr, kw: (sq(fr.shape[1]),) * 2),
        (jpl, "block_backward_merged_fact"): adjoint(
            "block_backward_merged_fact",
            lambda fr, kw: (sq(kw["x_top"]),) * 2 + (sq(128),) * 2),
    }


@pytest.fixture
def jax_calls(monkeypatch):
    calls = []
    for (mod, name), fn in _jax_stand_ins(calls).items():
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, fn)
    return calls


def _port_kernels(calls):
    """The plain versions, each call recorded as the JAX stand-ins do."""
    def recording(name, plain):
        sig = inspect.signature(plain)

        def call(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            if name in ("dual_apply", "high_apply", "merged_fact_apply"):
                acc = a.get("acc")
                calls.append(_apply_record(
                    name, a["xr"].dtype, None if acc is None else acc[0].dtype,
                    a.get("out_dtype"), a.get("alias", True), a.get("conj", False),
                    a.get("dot_mode", "f32"), _tname))
            elif name == "gram":
                calls.append(("gram", _tname(a["xr"].dtype), None,
                              a.get("dot_mode", "f32")))
            elif name == "diag_sweep":
                calls.append(("diag_sweep", _tname(a["xr"].dtype), None, "f32"))
            elif name == "diag_backward":
                calls.append(("diag_backward", _tname(a["fr"].dtype),
                              _tname(a["br"].dtype), "f32"))
            else:
                calls.append((name, _tname(a["fr"].dtype), _tname(a["br"].dtype),
                              a.get("dot_mode", "f32"), a.get("bwd_mode", "f32"),
                              a.get("gram_mode", "f32")))
            return plain(*args, **kw)
        return call
    return tk.KernelSet(*(recording(f, p) for f, p in
                          zip(tk.KernelSet._fields, tk.PLAIN)))


def _set_both(storage, dot, bwd, gram):
    for c in (jconfig, config):
        c.set_state_storage(storage)
        c.set_kernel_dot_mode(dot)
        c.set_bwd_kernel_dot_mode(bwd)
        c.set_gram_kernel_dot_mode(gram)


@pytest.fixture(autouse=True)
def _restore():
    yield
    _set_both("f32", "f32", "auto", "auto")
    jconfig.set_plane_engine("auto")


def _jax_record(calls, n):
    calls.clear()
    jconfig.set_plane_engine(True)
    m = JHEA(n, 1, entangler="cz", dtype=jnp.complex64, scan=True)
    jax.eval_shape(jax.value_and_grad(m.magnetization),
                   jax.ShapeDtypeStruct((1, n, 3), jnp.float32))
    return list(calls)


def _port_record(n):
    calls = []
    m = THEA(n, 1, "cz", device="meta")
    p = torch.zeros((1, n, 3), device="meta", requires_grad=True)
    m.magnetization(p, kernels=_port_kernels(calls)).backward()
    return calls


@pytest.mark.parametrize("storage", STORAGES)
def test_cz_layer_dispatch_matches_jax(storage, jax_calls):
    """n = 22 and n = 21, every forward dot mode and backward / gram mode."""
    cases = [(22, dot, bwd, gram) for dot in DOTS for bwd in BWD for gram in BWD]
    cases += [(21, dot, bwd, gram) for dot in DOTS for bwd, gram in (
        ("auto", "auto"), ("f32", "bf16x3"), ("bf16x3", "f32"))]
    mismatches = []
    for n, dot, bwd, gram in cases:
        _set_both(storage, dot, bwd, gram)
        want = _jax_record(jax_calls, n)
        got = _port_record(n)
        if got != want:
            mismatches.append((n, dot, bwd, gram, got, want))
    assert not mismatches, mismatches[0]


def test_merged_fact_transport_clamped(jax_calls):
    """The merged-top transport clamp, stated on its own: under "bf16"
    storage (and "mixed", "f16", an explicit bf16x3 backward mode) the
    factorized merged-top adjoint runs an f32 transport in both packages,
    the pair grams and the uncompute as resolved."""
    _set_both("bf16", "bf16x3", "auto", "auto")
    got = [c for c in _port_record(22) if c[0] == "block_backward_merged_fact"]
    assert got == [("block_backward_merged_fact", "bf16", "bf16", "bf16x3", "f32",
                    "bf16x3")]
    assert got == [c for c in _jax_record(jax_calls, 22)
                   if c[0] == "block_backward_merged_fact"]
