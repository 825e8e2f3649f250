"""The port's kernel modules (dqc_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions (the yardstick the CUDA kernels are
checked against on the card by chip_smoke.py) to the TPU kernels' meaning.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances: every output is a sum of 128 (dual: two chained sums of 128)
f32 products of O(1) values, so f32 rounding gives ~1e-6; the bars are
2e-5 absolute and relative, as for the JAX package's own kernel tests.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dqc_tpu.ops import groups as jgr
from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes

from dqc_tpu_torch.ops import groups as tgr
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _pair(c):
    return (np.ascontiguousarray(c.real, dtype=np.float32),
            np.ascontiguousarray(c.imag, dtype=np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(rng, A):
    """Random complex diag-run tables (tsl (128,128), tas/tal (A,128))."""
    return (_cnormal(rng, (128, 128), 0.7), _cnormal(rng, (A, 128), 0.7),
            _cnormal(rng, (A, 128), 0.7))


def _table_planes(tables):
    out = []
    for c in tables:
        out.extend(_pair(c))
    return out


DIAG_MODES = [None, "first", "after"]


@pytest.mark.parametrize("mode", DIAG_MODES)
def test_dual_apply_matches_pallas(mode):
    A = 4
    rng = np.random.default_rng(10)
    x = _cnormal(rng, (A, 128, 128))
    # complex, non-Hermitian, non-symmetric operators: a transpose/adjoint
    # slip in the lane factor El^T shows up
    el = _cnormal(rng, (128, 128), 128 ** -0.5)
    em = _cnormal(rng, (128, 128), 128 ** -0.5)
    xr, xi = _pair(x)
    ops = _pair(el) + _pair(em)
    tabs = _table_planes(_tables(rng, A)) if mode else None

    wr, wi = dual_group_apply_planes(
        jnp.asarray(xr), jnp.asarray(xi), *(jnp.asarray(o) for o in ops),
        diag_tables=None if tabs is None else tuple(jnp.asarray(t) for t in tabs),
        diag_first=(mode == "first"), interpret=True)

    gr_, gi_ = tk.dual_apply(_t(xr), _t(xi), *(_t(o) for o in ops),
                             None if tabs is None else [_t(t) for t in tabs],
                             mode == "first")
    np.testing.assert_allclose(gr_.numpy(), np.asarray(wr), **TOL)
    np.testing.assert_allclose(gi_.numpy(), np.asarray(wi), **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 128, 128), (1, 128, 256, 128)])
@pytest.mark.parametrize("mode", DIAG_MODES)
def test_high_apply_matches_pallas(shape, mode):
    A1, X, M, _ = shape
    post = M // 128
    A = A1 * X * post
    rng = np.random.default_rng(20 + X)
    x = _cnormal(rng, shape)
    E = _cnormal(rng, (X, X), X ** -0.5)
    xr, xi = _pair(x)
    er, ei = _pair(E)
    tables = _tables(rng, A) if mode else None

    diag_j = None
    if tables is not None:
        # the JAX kernel's view-tables: tas/tal reshaped to (pre, X, post, 128)
        tp = _table_planes(tables)
        v = (A1, X, post, 128)
        diag_j = (jnp.asarray(tp[0]), jnp.asarray(tp[1]),
                  *(jnp.asarray(t.reshape(v)) for t in tp[2:]))
    wr, wi = high_group_apply_planes(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(er), jnp.asarray(ei),
        diag=diag_j, diag_first=(mode == "first"), interpret=True)

    tabs = None if tables is None else [_t(t) for t in _table_planes(tables)]
    gr_, gi_ = tk.high_apply(_t(xr), _t(xi), _t(er), _t(ei), tabs,
                             mode == "first")
    np.testing.assert_allclose(gr_.numpy(), np.asarray(wr), **TOL)
    np.testing.assert_allclose(gi_.numpy(), np.asarray(wi), **TOL)


@pytest.mark.parametrize("n", [16, 21])
@pytest.mark.parametrize("j", [0, 1, 2])
def test_gram_axis_matches_pallas(n, j):
    """The full complex Gram, imaginary part included: <Z> reads only the
    diagonal of a density, so only the full matrix catches a flipped sign of
    ``C^T - C``. Entries are ~1/dim; sums of ~2^n/128 f32 products."""
    rng = np.random.default_rng(30 + n)
    psi = _cnormal(rng, (1 << n,))
    psi /= np.linalg.norm(psi)
    xr, xi = _pair(psi.reshape(tpl.plane_shape(n)))
    want = np.asarray(jpl.gram_axis(jnp.asarray(xr), jnp.asarray(xi), j, n,
                                    interpret=True))
    got = tpl.gram_axis(_t(xr), _t(xi), j, n).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    assert np.abs(want.imag).max() > 1e-4  # the imaginary part is exercised


def test_gram_views_are_one_kernel():
    """The lane, sublane and high views are three shapes of one (P, X, Q)
    function: each agrees with a direct complex Gram of the state."""
    n = 17
    rng = np.random.default_rng(40)
    psi = _cnormal(rng, (1 << n,))
    t = psi.reshape(jgr.group_dims(n))
    xr, xi = _pair(psi.reshape(tpl.plane_shape(n)))
    for j, axis in ((0, 2), (1, 1), (2, 0)):  # group j at axis ndim-1-j
        m = np.moveaxis(t, axis, 0).reshape(t.shape[axis], -1)
        want = m @ m.conj().T
        got = tpl.gram_axis(_t(xr), _t(xi), j, n).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("rels", [(0,), (6,), (3, 1), (2, 5, 4)])
def test_expand_in_group_matches_jax(rels):
    rng = np.random.default_rng(50 + len(rels))
    k = len(rels)
    gate = _cnormal(rng, (1 << k, 1 << k))
    want = np.asarray(jgr.expand_in_group(gate, rels, 7))
    np.testing.assert_array_equal(tgr.expand_in_group(gate, rels, 7), want)
    got_t = tgr.expand_in_group(_t(gate), rels, 7).numpy()
    np.testing.assert_array_equal(got_t, want)
    d = _cnormal(rng, (1 << k,))
    want_d = np.asarray(jgr.expand_diag_in_group(d, rels, 7))
    np.testing.assert_array_equal(tgr.expand_diag_in_group(d, rels, 7), want_d)
    np.testing.assert_array_equal(
        tgr.expand_diag_in_group(_t(d), rels, 7).numpy(), want_d)


@pytest.mark.parametrize("positions", [(6, 7), (0, 27), (20, 21), (13, 3, 9)])
def test_cross_diag_table_matches_jax(positions):
    n = 28
    rng = np.random.default_rng(60)
    d = _cnormal(rng, (1 << len(positions),))
    w2, wa, wb = jgr.cross_diag_table(d, positions, n)
    g2, ga, gb = tgr.cross_diag_table(d, positions, n)
    assert (ga, gb) == (wa, wb)
    np.testing.assert_array_equal(g2, np.asarray(w2))
    t2, _, _ = tgr.cross_diag_table(_t(d), positions, n)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(w2))


@pytest.mark.parametrize("rels", [(0,), (4,), (6,), (5, 2)])
def test_density_from_gram_matches_jax(rels):
    rng = np.random.default_rng(70)
    m = _cnormal(rng, (128, 128))
    G = (m @ m.conj().T).astype(np.complex64)
    want = np.asarray(jgr.density_from_gram(jnp.asarray(G), rels, 7))
    got = tgr.density_from_gram(_t(G), rels, 7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for a CPU tensor; any other
    device launches the kernel or raises — never a silent fallback."""
    x = torch.empty((1, 128, 128), device="meta")
    e = torch.empty((128, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.dual_apply(x, x, e, e, e, e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.high_apply(x.view(1, 8, 16, 128), x.view(1, 8, 16, 128),
                      e[:8, :8].contiguous(), e[:8, :8].contiguous())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.gram(x, x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_dual(x, x, x, x, *[e] * 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_high(*[x.view(1, 8, 16, 128)] * 4,
                               *[e[:8, :8].contiguous()] * 4)
    m = torch.empty((1, 256, 8, 128), device="meta")
    t = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.merged_fact_apply(m, m, e, e, t, t, x_top=2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.block_backward_merged_fact(m, m, m, m, e, e, e, e, t, t, t, t, x_top=2)
    tabs = (e, e, x[0], x[0], x[0], x[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.diag_sweep(x, x, *tabs)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.diag_backward(x, x, x, x, *tabs, *tabs)
    assert tk.launch_counts() == {name: 0 for name in (
        *tk.KernelSet._fields, "block_backward_dual[diag_q]",
        "block_backward_high[diag_q]", "diag_backward[with_q]",
        "dual_multi_apply[seed]", "high_multi_apply[seed]",
        "high_apply[wide_inplace]", "high_apply[tc]", "block_backward_high[wide]",
        "block_backward_dual[tc]", "block_backward_lane[tc]",
        "block_backward_sublane[tc]", "block_backward_high[tc]",
        "block_backward_merged_fact[tc]", "gram[tc]", "dual_apply[tc]",
        "merged_fact_apply[tc]", "dual_multi_apply[tc]", "high_multi_apply[tc]",
        *(f"{k}[{m}]" for k in ("dual_apply", "high_apply", "diag_backward",
                                "dual_multi_apply", "high_multi_apply")
          for m in ("bf16", "f16")),
        *(f"{k}[{m}]" for k in ("block_backward_dual", "block_backward_high",
                                "block_backward_merged_fact",
                                "block_backward_lane", "block_backward_sublane")
          for m in ("bf16", "f16", "bf16x3", "gram_bf16x3")),
        *(f"{k}[{m}]" for k in ("dual_apply", "high_apply", "gram",
                                "merged_fact_apply", "block_backward_dual",
                                "block_backward_high", "block_backward_merged_fact",
                                "dual_multi_apply", "high_multi_apply",
                                "block_backward_sublane", "block_backward_lane")
          for m in ("fwd_bf16", "fwd_bf16x3")),
        "diag_sweep[fwd_bf16]", "diag_backward[fwd_bf16]",
        "dual_apply[in_f16]", "high_apply[in_f16]")}
