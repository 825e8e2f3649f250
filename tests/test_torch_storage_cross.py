"""Reduced cotangent storage in the kernels of the CNOT ring, VQE, QAOA, the
generic plane tape and the expanded merged top, against the JAX package's
Pallas kernels (interpret mode) on the CPU.

The plain versions of the five kernels that take a reduced cotangent since
the storage reached these paths, with the cotangent planes stored as f16
bits (uint16 in the JAX package, float16 here) or bf16:

* ``dual_multi_apply`` (``dual_multi_apply_planes``) and
  ``high_multi_apply`` (``high_multi_apply_planes``, on the X = 8 span view
  of the ring's closing gate): in place on reduced planes (a cross-group
  gate's transport), and the seed from f32 forward planes into reduced
  planes, accumulated and fresh; on the ring's own CNOT terms (T = 2) and a
  random 2-qubit unitary's (T = 4); the products f32 (``kernel_dot_mode``);
* ``block_backward_sublane`` and ``block_backward_lane`` in the three
  pairs of transport and gram dot modes;
* ``block_backward_high`` at X = 256 and 512 on the merged top axis with a
  small M (the expanded hpair and a lone top-group block), its transport
  and cross-Gram in the same modes.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances as in tests/test_torch_storage_codec.py: decoded cotangent
planes within 2 ulps of their storage (``_storage.ulps_apart``), forward
planes (f32) within 2e-5, pair grams within ``_storage.gram_tolerance`` of
their largest entry, 4e-5 where both sides run bf16x3 (two splits of the
same three exact products, summed in another order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dqc_tpu.ops.pallas import common as cm
from dqc_tpu.ops.pallas.block_backward import (block_backward_high,
                                               block_backward_lane,
                                               block_backward_sublane)
from dqc_tpu.ops.pallas.dual_apply import dual_multi_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_multi_apply_planes

from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl
from dqc_tpu_torch.ops.kernels import _storage as st

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
STORAGES = ["f16", "bf16"]
MODES = [("bf16x3", "bf16x3"), ("f32", "bf16x3"), ("f32", "f32")]
CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                np.complex64)


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _pair(c):
    return (np.ascontiguousarray(c.real, dtype=np.float32),
            np.ascontiguousarray(c.imag, dtype=np.float32))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _dtype(storage):
    return torch.float16 if storage == "f16" else torch.bfloat16


def _jdtype(storage):
    return jnp.uint16 if storage == "f16" else jnp.bfloat16


def _store(planes, storage):
    """f32 planes as (JAX arrays, port tensors) in ``storage``: f16 bits in
    uint16 for the JAX package (its codec), float16 with the same bits here;
    bf16 in both."""
    if storage == "f16":
        jb = [cm.store_as(jnp.asarray(p), jnp.uint16) for p in planes]
        return jb, [torch.from_numpy(np.asarray(b).view(np.int16).copy()).view(
            torch.float16) for b in jb]
    jb = [jnp.asarray(p).astype(jnp.bfloat16) for p in planes]
    return jb, [torch.from_numpy(p).to(torch.bfloat16) for p in planes]


def _assert_b(got, want, storage):
    """Decoded cotangent planes within 2 storage ulps."""
    dt = _dtype(storage)
    assert got[0].dtype == got[1].dtype == dt
    w = [torch.from_numpy(np.array(cm.f32_of(x))) for x in want]
    n = st.ulps_apart(got, w, dt)
    assert n <= 2.0, f"{n:.2f} {storage} ulps apart"


def _assert_f(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def _assert_gram(got, want, storage, modes):
    tol = st.gram_tolerance(_dtype(storage))
    if "bf16x3" in modes:
        tol = max(tol, 4e-5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max())


# ---------------------------------------------------------------------------
# The multi-term applies
# ---------------------------------------------------------------------------

def _dual_terms(gate, rng):
    """The stacked lane and sublane factors of a gate on qubits (7, 6) at
    n = 14, as the port stages them (numpy: el_r, el_i, em_r, em_i)."""
    terms = tps._dense_cross_expanded_terms(gate, (7, 6), 14)
    ops = tpl.cross_terms_operands(terms, 14, torch.device("cpu"))
    assert ops[0] == "dual"
    return [o.numpy() for o in ops[1:]]


def _unitary(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
    return q.astype(np.complex64)


def _mode_kwargs(mode, storage, jacc, tacc):
    """(JAX kwargs, port kwargs) of an apply mode: in place on the reduced
    planes, a seed into reduced accumulator planes, or a fresh seed."""
    if mode == "inplace":
        return {}, {}
    if mode == "acc":
        return (dict(conj=True, alias=False, acc=tuple(jacc)),
                dict(conj=True, alias=False, acc=tacc))
    return (dict(conj=True, alias=False, out_dtype=_jdtype(storage)),
            dict(conj=True, alias=False, out_dtype=_dtype(storage)))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("mode", ["inplace", "acc", "fresh"])
@pytest.mark.parametrize("gate", ["cnot", "unitary"])
def test_dual_multi_apply_reduced(gate, mode, storage):
    rng = np.random.default_rng(70 + len(mode) + len(gate))
    ops = _dual_terms(CNOT if gate == "cnot" else _unitary(rng, 4), rng)
    assert ops[0].shape[0] == (2 if gate == "cnot" else 4)
    x = _pair(_cnormal(rng, (2, 128, 128), 0.02))
    jacc, tacc = _store(_pair(_cnormal(rng, (2, 128, 128), 0.02)), storage)
    jkw, tkw = _mode_kwargs(mode, storage, jacc, tacc)
    if mode == "inplace":
        jx, tx = _store(x, storage)
    else:
        jx, tx = _j(x), _t(x)
    want = dual_multi_apply_planes(*jx, *_j(ops), interpret=True, **jkw)
    got = tk.dual_multi_apply(*tx, *_t(ops), **tkw)
    _assert_b(got, want, storage)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("mode", ["inplace", "acc", "fresh"])
def test_high_multi_apply_span_reduced(mode, storage):
    """The X = 8 span view of a gate on qubits (14, 0) at n = 15 (the CNOT
    ring's closing gate): its lane slices as the T terms."""
    rng = np.random.default_rng(80 + len(mode))
    gate = _unitary(rng, 4)
    ops = tpl.cross_span_operands(gate, (14, 0), 15, torch.device("cpu"))
    assert ops[0] == "multi"
    vshape = ops[1]
    factors = [o.numpy() for o in ops[2:]]
    x = _pair(_cnormal(rng, vshape, 0.02))
    jacc, tacc = _store(_pair(_cnormal(rng, vshape, 0.02)), storage)
    jkw, tkw = _mode_kwargs(mode, storage, jacc, tacc)
    if mode == "inplace":
        jx, tx = _store(x, storage)
    else:
        jx, tx = _j(x), _t(x)
    want = high_multi_apply_planes(*jx, *_j(factors), interpret=True, **jkw)
    got = tk.high_multi_apply(*tx, *_t(factors), **tkw)
    _assert_b(got, want, storage)


# ---------------------------------------------------------------------------
# The unpaired lane and sublane adjoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modes", MODES, ids="/".join)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("step", ["lane", "sublane"])
def test_block_backward_minor_reduced(step, storage, modes):
    rng = np.random.default_rng(90 + len(step))
    F = _pair(_cnormal(rng, (2, 128, 128)))
    jB, tB = _store(_pair(_cnormal(rng, (2, 128, 128), 0.5)), storage)
    ops = [p for _ in range(2) for p in _pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    jfn = block_backward_lane if step == "lane" else block_backward_sublane
    tfn = tk.block_backward_lane if step == "lane" else tk.block_backward_sublane
    bm, gm = modes
    want = jfn(*_j(F), *jB, *_j(ops), bwd_dot_mode=bm, gram_dot_mode=gm,
               interpret=True)
    got = tfn(*_t(F), *tB, *_t(ops), bwd_mode=bm, gram_mode=gm)
    _assert_f(got[:2], want[:2])
    _assert_b(got[2:4], want[2:4], storage)
    _assert_gram(got[4:6], want[4:6], storage, modes)


# ---------------------------------------------------------------------------
# The X = 256 / 512 adjoint on the merged top axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modes", MODES[:2], ids="/".join)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("X", [256, 512])
def test_block_backward_high_wide_reduced(X, storage, modes):
    """The merged-axis view (1, X, 8, 128) (a small M): the transport on the
    reduced planes and the pair gram the cross-Gram reads them into."""
    rng = np.random.default_rng(100 + X)
    shape = (1, X, 8, 128)
    F = _pair(_cnormal(rng, shape))
    jB, tB = _store(_pair(_cnormal(rng, shape, 0.5)), storage)
    ops = [p for _ in range(2) for p in _pair(_cnormal(rng, (X, X), X ** -0.5))]
    bm, gm = modes
    want = block_backward_high(*_j(F), *jB, *_j(ops), bwd_dot_mode=bm,
                               gram_dot_mode=gm, interpret=True)
    got = tk.block_backward_high(*_t(F), *tB, *_t(ops), bwd_mode=bm,
                                 gram_mode=gm)
    _assert_f(got[:2], want[:2])
    _assert_b(got[2:4], want[2:4], storage)
    _assert_gram(got[4:6], want[4:6], storage, modes)
