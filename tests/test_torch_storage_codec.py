"""Reduced cotangent storage and bf16x3 at the kernel level, against the JAX
package on the CPU.

* the in-kernel f16 codec (ops/kernels/_storage.py, the plain versions'
  copy of csrc/common.cuh's) bit for bit against ``common.f32_of`` /
  ``store_as`` on all 65536 patterns and on 1.3 M seeded f32 values that
  span the clamp, the flushed subnormal band and its upper edge, ties and
  the normal range; the bf16 store against ``astype(bfloat16)``;
* the host codec (``planes.plane_store`` / ``plane_f32``) against
  ``planes.enc16`` / ``dec16`` (IEEE: subnormals kept, overflow to inf);
* the plain bf16x3 dot against ``dots._dot_bf16x3``;
* the plain versions of the six kernels that meet a reduced plane or a
  bf16x3 dot against their Pallas kernels in interpret mode, with the
  cotangent planes stored as f16 bits (uint16 in the JAX package, float16
  here) or bf16: the seed modes of ``dual_group_apply_planes`` and
  ``high_group_apply_planes`` (X = 16, 128 and the merged X = 256 / 512 on
  a view with a small M), ``block_backward_dual``, ``block_backward_high``,
  ``block_backward_merged_fact`` and ``diag_backward_planes``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the codecs are bit-exact. Decoded cotangent planes agree
within 2 ulps of their storage (``_storage.ulps_apart``: at the larger of
the amplitude's modulus and the planes' rms), since two orders of f32 sums
round a few entries of a store the other way and a later product mixes
them; the forward planes (f32) within
2e-5 as in tests/test_torch_backward.py; pair grams and Q reductions within
``_storage.gram_tolerance`` of their largest entry (half an ulp of the
storage, 2^-(p+1): B itself is only defined to that). The bf16x3 dots of the two packages are
the same three exact products summed in another order (the JAX kernels
split Karatsuba operands), so their bf16x3 outputs are held to 4e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas import common as cm
from dqc_tpu.ops.pallas.block_backward import (block_backward_dual,
                                               block_backward_high,
                                               block_backward_merged_fact)
from dqc_tpu.ops.pallas.diag import diag_backward_planes
from dqc_tpu.ops.pallas.dots import _dot_bf16x3
from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes

from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl
from dqc_tpu_torch.ops.kernels import _storage as st

torch.set_num_threads(2)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
STORAGES = ["f16", "bf16"]


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


# ---------------------------------------------------------------------------
# The codecs
# ---------------------------------------------------------------------------

def _f16_view(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()).view(
        torch.float16)


def test_decode_every_f16_pattern():
    """All 65536 patterns, the subnormal (decoded as signed zeros) and
    exponent-31 ones (decoded finite) included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = np.asarray(cm.f32_of(jnp.asarray(bits)))
    got = st.f32_of(_f16_view(bits)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    sub = (bits & 0x7C00) == 0
    assert (got[sub] == 0).all() and np.isfinite(got).all()


def _encode_cases():
    rng = np.random.default_rng(20)
    tiny = np.float32(2.0 ** -14)
    ulp16 = np.float32(2.0 ** -24)
    fams = {
        "normal": rng.standard_normal(300_000) * 4.0,
        "wide": np.exp(rng.uniform(-25, 12, 300_000)) * rng.choice([-1, 1], 300_000),
        "subnormal band": rng.uniform(-tiny, tiny, 300_000),
        "band edge": tiny + rng.integers(-64, 64, 100_000) * ulp16 / 8,
        "clamp": rng.uniform(6.0e4, 1.0e6, 100_000) * rng.choice([-1, 1], 100_000),
        # exact ties between two halves (round to even) and their neighbours
        "ties": (rng.integers(1024, 2048, 200_000) + 0.5) * 2.0 ** rng.integers(-24, 5, 200_000),
        "specials": np.array([0.0, -0.0, tiny, -tiny, 65504.0, 65520.0, -65520.0,
                              np.inf, -np.inf, 2.0 ** -15, 1.0 - 2.0 ** -12]),
    }
    return {k: v.astype(np.float32) for k, v in fams.items()}


@pytest.mark.parametrize("family", list(_encode_cases()))
def test_encode_matches_store_as(family):
    x = _encode_cases()[family]
    want = np.asarray(cm.store_as(jnp.asarray(x), jnp.uint16))
    got = st.store_as(torch.from_numpy(x), torch.float16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)


def test_encode_count_and_flushed_band():
    """At least 10^6 values over the families; every |x| < 2^-14 is a signed
    zero, which IEEE half conversion does not give."""
    cases = _encode_cases()
    assert sum(v.size for v in cases.values()) >= 1_000_000
    band = cases["subnormal band"]
    bits = st.store_as(torch.from_numpy(band), torch.float16).view(torch.int16).numpy()
    assert ((bits.view(np.uint16) & 0x7FFF) == 0).all()
    assert (np.signbit(band) == ((bits.view(np.uint16) >> 15) == 1)).all()
    assert (band.astype(np.float16) != 0).any()


def test_bf16_store_matches_astype():
    x = _encode_cases()["wide"]
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = st.f32_of(st.store_as(torch.from_numpy(x), torch.bfloat16)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_host_codec_matches_enc16_dec16():
    """Outside the kernels both packages convert IEEE: subnormals kept,
    overflow to inf."""
    x = np.concatenate(list(_encode_cases().values()))
    want = np.asarray(jpl.enc16(jnp.asarray(x)))
    got = tpl.plane_store(torch.from_numpy(x), torch.float16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    back = np.asarray(jpl.dec16(jnp.asarray(bits)))
    mine = tpl.plane_f32(_f16_view(bits)).numpy()
    np.testing.assert_array_equal(np.isnan(mine), np.isnan(back))
    ok = ~np.isnan(back)
    np.testing.assert_array_equal(mine[ok].view(np.uint32), back[ok].view(np.uint32))


@pytest.mark.parametrize("shape", [(64, 128, 32), (128, 128, 128)])
def test_bf16x3_dot_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    m, k, n = shape
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(_dot_bf16x3(jnp.asarray(a), jnp.asarray(b)))
    # real operands: the complex product's imaginary parts are zero
    got = st.cmatmul(torch.from_numpy(a).to(torch.complex64),
                     torch.from_numpy(b).to(torch.complex64), "bf16x3").real.numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    # the same three exact products, f32 sums in another order
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    # and bf16x3-grade: the dropped lo lo term is ~2^-16 of each product
    assert (np.abs(got - exact) <= 2e-5 * scale).all()
    assert np.abs(got - exact).max() > np.abs(a @ b - exact).max()


# ---------------------------------------------------------------------------
# The six kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

def _store(planes, storage):
    """f32 planes as (JAX arrays, port tensors) in ``storage``: f16 bits in
    uint16 for the JAX package (its codec), float16 with the same bits here;
    bf16 in both."""
    if storage == "f16":
        jb = [cm.store_as(jnp.asarray(p), jnp.uint16) for p in planes]
        return jb, [_f16_view(np.asarray(b)) for b in jb]
    jb = [jnp.asarray(p).astype(jnp.bfloat16) for p in planes]
    return jb, [torch.from_numpy(p).to(torch.bfloat16) for p in planes]


def _dtype(storage):
    return torch.float16 if storage == "f16" else torch.bfloat16


def _decode_j(x):
    return torch.from_numpy(np.asarray(cm.f32_of(x)))


def _assert_b(got, want, storage):
    """Decoded cotangent planes within 2 storage ulps."""
    dt = _dtype(storage)
    assert got[0].dtype == got[1].dtype == dt
    n = st.ulps_apart(got, [_decode_j(w) for w in want], dt)
    assert n <= 2.0, f"{n:.2f} {storage} ulps apart"


def _assert_f(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def _assert_gram(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max())


def _gram_tol(storage, modes):
    """The storage's gram tolerance, and 4e-5 for two bf16x3 formulations."""
    tol = st.gram_tolerance(_dtype(storage))
    return max(tol, 4e-5) if "bf16x3" in modes else tol


def _phases(rng, shape):
    """Random unit-modulus entries: the run of a ring of CZ or ZZ-phase
    gates. A run with |D| far from 1 moves an entry across binades between
    the store before it and the one after, where a rounding of the first
    counts as several ulps of the second."""
    return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)


def _table_planes(rng, A):
    out = []
    for shape in ((128, 128), (A, 128), (A, 128)):
        out.extend(_pair(_phases(rng, shape)))
    return out


MODES = [("bf16x3", "bf16x3"), ("f32", "bf16x3"), ("f32", "f32")]


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("kernel, shape", [
    ("dual", (2, 128, 128)), ("high", (1, 16, 128, 128)),
    ("high", (1, 128, 8, 128)), ("high", (1, 256, 8, 128)),
    ("high", (1, 512, 8, 128))], ids=str)
def test_seed_modes_store_reduced(kernel, shape, acc, storage):
    """The density seed ``[acc +] conj(E x)`` from f32 forward planes into
    reduced cotangent planes: fresh (``out_dtype``) or accumulated."""
    rng = np.random.default_rng(40 + shape[1] + acc)
    x = _pair(_cnormal(rng, shape, 0.02))
    X = shape[1]
    n_ops = 2 if kernel == "dual" else 1
    ops = [p for _ in range(n_ops) for p in _pair(_cnormal(rng, (X, X), X ** -0.5))]
    jacc = tacc = None
    if acc:
        jacc, tacc = _store(_pair(_cnormal(rng, shape, 0.02)), storage)
    jdt = jnp.uint16 if storage == "f16" else jnp.bfloat16
    jfn = dual_group_apply_planes if kernel == "dual" else high_group_apply_planes
    tfn = tk.dual_apply if kernel == "dual" else tk.high_apply
    want = jfn(*_j(x), *_j(ops), alias=False, conj=True,
               acc=None if jacc is None else tuple(jacc),
               out_dtype=None if acc else jdt, interpret=True)
    tx = _t(x)
    got = tfn(*tx, *_t(ops), alias=False, conj=True, acc=tacc,
              out_dtype=None if acc else _dtype(storage))
    _assert_b(got, want, storage)
    for t, a in zip(tx, x):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("modes", MODES, ids="/".join)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("diag, g0_first, diag_q", [
    (None, True, False), (None, False, False), ("before", True, True),
    ("after", False, True), ("after", True, False)], ids=str)
def test_block_backward_dual_reduced(diag, g0_first, diag_q, storage, modes):
    A = 4
    rng = np.random.default_rng(50 + 2 * g0_first + (diag == "after"))
    F = _pair(_cnormal(rng, (A, 128, 128)))
    jB, tB = _store(_pair(_cnormal(rng, (A, 128, 128), 0.5)), storage)
    ops = [p for _ in range(4) for p in _pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    kw = dict(g0_first=g0_first, diag_q=diag_q)
    jkw, tkw = {}, {}
    if diag:
        tabs = (_table_planes(rng, A), _table_planes(rng, A))
        jkw = dict(diag_inv_tables=tuple(_j(tabs[0])), diag_tables=tuple(_j(tabs[1])))
        tkw = dict(diag_inv_tables=_t(tabs[0]), diag_tables=_t(tabs[1]))
        kw["diag_first_fwd"] = diag == "before"
    bm, gm = modes
    want = block_backward_dual(*_j(F), *jB, *_j(ops), bwd_dot_mode=bm,
                               gram_dot_mode=gm, interpret=True, **kw, **jkw)
    got = tk.block_backward_dual(*_t(F), *tB, *_t(ops), bwd_mode=bm,
                                 gram_mode=gm, **kw, **tkw)
    assert len(got) == len(want)
    _assert_f(got[:2], want[:2])
    _assert_b(got[2:4], want[2:4], storage)
    _assert_gram(got[4:], want[4:], _gram_tol(storage, modes))


@pytest.mark.parametrize("modes", MODES[:2], ids="/".join)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", [(1, 16, 128, 128), (1, 128, 8, 128)], ids=str)
def test_block_backward_high_reduced(shape, storage, modes):
    rng = np.random.default_rng(60 + shape[1])
    X = shape[1]
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
    _assert_gram(got[4:6], want[4:6], _gram_tol(storage, modes))


def _run_tables(rng, A):
    return tuple(_phases(rng, shape) for shape in ((128, 128), (A, 128), (A, 128)))


def _unitary(rng, X):
    q, _ = np.linalg.qr(_cnormal(rng, (X, X)))
    return q.astype(np.complex64)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("diag_first", [True, False], ids=["run_first", "run_after"])
def test_block_backward_high_diag_q_reduced(diag_first, storage):
    """Group 2 of n = 17 with a variable run folded in (planes.backward_dhigh
    in both packages, their configs' default dot modes under the storage):
    planes, T0 and the Q reductions."""
    from dqc_tpu import config as jconfig
    from dqc_tpu_torch import config as tconfig

    n = 17
    rng = np.random.default_rng(90 + diag_first)
    A = X = 1 << (n - 14)
    F = _pair(_cnormal(rng, (A, 128, 128)))
    jB, tB = _store(_pair(_cnormal(rng, (A, 128, 128), 0.5)), storage)
    Einv, E = _unitary(rng, X), _unitary(rng, X)
    Tinv, T = _run_tables(rng, A), _run_tables(rng, A)
    mode = "mixed" if storage == "bf16" else "f16"
    jconfig.set_state_storage(mode)
    tconfig.set_state_storage(mode)
    try:
        jout = jpl.backward_dhigh(*_j(F), *jB, Einv, E, Tinv, T, 2, n,
                                  diag_first=diag_first, with_q=True,
                                  interpret=True)
        tout = tpl.backward_dhigh(*_t(F), *tB, Einv, E,
                                  tuple(torch.from_numpy(t) for t in Tinv),
                                  tuple(torch.from_numpy(t) for t in T), 2, n,
                                  diag_first=diag_first, with_q=True)
    finally:
        jconfig.set_state_storage("f32")
        tconfig.set_state_storage("f32")
    _assert_f(tout[:2], jout[:2])
    _assert_b(tout[2:4], jout[2:4], storage)
    tol = _gram_tol(storage, ("bf16x3",))
    for g, w in [(tout[4], jout[4]), *zip(tout[5], jout[5])]:
        w = np.asarray(w).reshape(tuple(g.shape))
        _assert_gram([torch.view_as_real(g)], [np.stack([w.real, w.imag], -1)], tol)


MERGED = [((1, 256, 16, 128), 2), ((1, 512, 8, 128), 4)]


@pytest.mark.parametrize("modes", MODES[:2], ids="/".join)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape, x_top", MERGED, ids=str)
def test_block_backward_merged_fact_reduced(shape, x_top, storage, modes):
    """The low transport and T0_low in the dot modes; the top factor and
    T0_top in f32 whatever the modes."""
    rng = np.random.default_rng(70 + x_top)
    F = _pair(_cnormal(rng, shape))
    jB, tB = _store(_pair(_cnormal(rng, shape, 0.5)), storage)
    ops = []
    for _ in range(2):
        ops += [*_pair(_cnormal(rng, (128, 128), 128 ** -0.5))]
    tops = []
    for _ in range(2):
        tops += [*_pair(_cnormal(rng, (x_top, x_top), x_top ** -0.5))]
    args = (*ops, *tops)
    bm, gm = modes
    want = block_backward_merged_fact(*_j(F), *jB, *_j(args), x_top=x_top,
                                      bwd_dot_mode=bm, gram_dot_mode=gm,
                                      interpret=True)
    got = tk.block_backward_merged_fact(*_t(F), *tB, *_t(args), x_top=x_top,
                                        bwd_mode=bm, gram_mode=gm)
    _assert_f(got[:2], want[:2])
    _assert_b(got[2:4], want[2:4], storage)
    _assert_gram(got[4:6], want[4:6], st.gram_tolerance(_dtype(storage)))
    _assert_gram(got[6:8], want[6:8], _gram_tol(storage, modes))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("with_q", [False, True])
def test_diag_backward_reduced(with_q, storage):
    A = 4
    rng = np.random.default_rng(80 + with_q)
    F = _pair(_cnormal(rng, (A, 128, 128)))
    jB, tB = _store(_pair(_cnormal(rng, (A, 128, 128), 0.5)), storage)
    tabs = _table_planes(rng, A) + _table_planes(rng, A)
    want = diag_backward_planes(*_j(F), *jB, *_j(tabs), with_q=with_q,
                                interpret=True)
    got = tk.diag_backward(*_t(F), *tB, *_t(tabs), with_q=with_q)
    _assert_f(got[:2], want[:2])
    _assert_b(got[2:4], want[2:4], storage)
    if with_q:
        _assert_gram(got[4:], want[4:], 1e-5)
