"""The sublane adjoint and the high adjoint at X = 128 on the tensor-core
step, on the CPU.

Both run ``csrc/tc_adjoint.cuh``'s one-pass step (``tests/test_torch_tc_adjoint.py``
holds the dual and lane adjoints'): the sublane adjoint as the dual kernel's
sublane step alone (``csrc/block_backward_dual.cu``'s
``dqc_block_backward_sublane``), the high adjoint at X = 128 on 128 x 64
tiles of its view (``csrc/block_backward_high.cu``'s
``dqc_block_backward_high_tc``), with a run rolled back on load or on store
and its Q. No CUDA kernel runs here; these tests hold:

* what the wrappers hand their entries on meta planes with the library
  entries replaced by recorders: ``Einv`` and ``E^T`` pre-split in
  fragment order (``_tc.tc_operator``) in each product's dot mode, in
  three parts where 3xTF32 meets 16-bit planes the step holds exact (not
  after a run the high adjoint rolls back on load: its tiles then hold f32
  values), the kinds and mode flags; every launch counts in
  ``mode_launches["tc"]``; so does the high adjoint at X = 64, to its
  small-X entry (``tests/test_torch_tc_adjoint_small_x.py`` holds X = 8..64);
* each step written out in the kernel's numerics (3xTF32 of
  ``_tc.split_tf32`` parts, bf16x3 pair grams of ``_storage.split`` parts,
  float64 part products) against the JAX package's ``block_backward_sublane``
  (A = 2, n = 15) and ``block_backward_high`` at X = 128 (group 2 at n = 21,
  the smallest view with a run) with a run met before and after the dense
  stage and its Q, in interpret mode: the planes within ``PLANE_TOL`` and
  the pair gram and each Q output within ``GRAM_T0_TOL`` of their largest
  entry (chip_smoke.py's bars for these rows), and against the JAX kernel
  within that plus the JAX kernel's own distance from float64.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.block_backward import block_backward_high as jax_high
from dqc_tpu.ops.pallas.block_backward import block_backward_sublane as jax_sublane

from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from chip_smoke import GRAM_T0_TOL
from test_torch_tc_adjoint import (BF16, F32, IDS, PLANE_TOL, SETTINGS, _cnormal,
                                   _exact_product, _matmul, _meta_planes, _pair,
                                   _run, _split_product, _sublane_step, _unitary,
                                   _want, recorded)  # noqa: F401 (a fixture)

# the modules (the package's names of the same spelling are the wrappers)
bbd = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_dual")
bbl = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_lane")
bbs = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_sublane")
bbh = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_high")


# ---------------------------------------------------------------------------
# What the wrappers hand their libraries
# ---------------------------------------------------------------------------

def _ops(seed, k, X=128):
    """k random (X, X) operators as f32 real / imag CPU tensors (what the
    wrappers hand on needs no unitary)."""
    rng = np.random.default_rng(seed)
    return [p for _ in range(k) for p in _pair(_cnormal(rng, (X, X)))]


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram", SETTINGS, ids=IDS)
def test_sublane_hands_presplit_operators(recorded, fdt, bdt, dot, bwd, gram):
    calls, made = recorded
    einv_r, einv_i, e_r, e_i = ops = _ops(30 + SETTINGS.index((fdt, bdt, dot, bwd, gram)), 2)
    bbs.block_backward_sublane(*_meta_planes(fdt, bdt), *ops, dot_mode=dot,
                               bwd_mode=bwd, gram_mode=gram)
    (lib, fn, args), = calls
    # the dual adjoint's library: the sublane step is built there, once
    assert (lib, fn) == ("block_backward_dual", "dqc_block_backward_sublane")
    assert torch.equal(made[args[6]], _want(einv_r, einv_i, dot, fdt))
    assert torch.equal(made[args[7]], _want(e_r.t(), e_i.t(), bwd, bdt))
    assert args[4:6] == (st.storage_kind(bdt), st.storage_kind(fdt))
    assert args[10:15] == (2, 2, int(bwd == "bf16x3"), int(gram == "bf16x3"),
                           int(dot == "bf16x3"))
    w = bbs.block_backward_sublane
    assert w.launches == w.mode_launches["tc"] == 1
    assert bbd.block_backward_dual.launches == bbl.block_backward_lane.launches == 0


def _high_tables(A):
    return tuple(torch.zeros(s) for s in [(128, 128)] * 2 + [(A, 128)] * 4)


# every setting without a run; with a run met after the block or first, the
# settings where 3xTF32 meets 16-bit planes (three parts unless the run
# leaves f32 tiles) and the f32 one
HIGH_RUNS = ([(*c, None) for c in SETTINGS]
             + [(*SETTINGS[IDS.index(i)], r) for i in ("f32", "f16_f32_transport", "bf16_x3")
                for r in ("before", "after")])


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram, run", HIGH_RUNS,
                         ids=[f"{IDS[SETTINGS.index(c[:5])]}-"
                              f"{'no_run' if c[5] is None else 'run_' + c[5] + '_q'}"
                              for c in HIGH_RUNS])
def test_high_hands_presplit_operators(recorded, fdt, bdt, dot, bwd, gram, run):
    """X = 128: the tensor-core entry, handed Einv and E^T pre-split; a run
    rolled back on load (met first: it followed the block in the forward)
    leaves f32 values in the step's tiles, which the operators then meet in
    two parts."""
    calls, made = recorded
    einv_r, einv_i, e_r, e_i = ops = _ops(40 + SETTINGS.index((fdt, bdt, dot, bwd, gram)), 2)
    kw = dict(dot_mode=dot, bwd_mode=bwd, gram_mode=gram)
    if run:
        tabs = _high_tables(128)
        kw.update(diag_inv_tables=tabs, diag_tables=tabs,
                  diag_first_fwd=run == "before", diag_q=True)
    bbh.block_backward_high(*_meta_planes(fdt, bdt, 1, (128, 128, 128)), *ops, **kw)
    (lib, fn, args), = calls
    assert (lib, fn) == ("block_backward_high", "dqc_block_backward_high_tc")
    f32_tiles = run == "after"
    assert torch.equal(made[args[4]], _want(einv_r, einv_i, dot, F32 if f32_tiles else fdt))
    assert torch.equal(made[args[5]], _want(e_r.t(), e_i.t(), bwd, F32 if f32_tiles else bdt))
    # has_diag, diag_first_fwd, diag_q; A1, Q, nblk; bkind, bwd_x3, gram_x3,
    # fkind, dot_x3
    assert args[18:21] == (int(run is not None), int(run != "after"), int(run is not None))
    assert args[29:32] == (1, 128 * 128, 1 if run else 132)   # nblk: groups or SMs
    assert args[32:37] == (st.storage_kind(bdt), int(bwd == "bf16x3"),
                           int(gram == "bf16x3"), st.storage_kind(fdt),
                           int(dot == "bf16x3"))
    w = bbh.block_backward_high
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["diag_q"] == int(run is not None)


@pytest.mark.parametrize("fdt, dot", [(F32, "f32"), (BF16, "f32"), (F32, "bf16x3")],
                         ids=["f32", "bf16", "f32_dot_x3"])
def test_high_below_128_keeps_its_entries(recorded, fdt, dot):
    """X = 64: the small-X tensor-core entry (a library of its own), handed
    Einv and E^T pre-split in their products' modes (in three parts where
    3xTF32 meets the bf16 planes), X, the blocks (one per SM at X = 64) and
    the pair gram's one slot a block, counted in ``[tc]``."""
    calls, made = recorded
    einv_r, einv_i, e_r, e_i = ops = _ops(50, 2, X=64)
    bbh.block_backward_high(*_meta_planes(fdt, fdt, 1, (64, 256, 128)), *ops,
                            dot_mode=dot)
    (lib, fn, args), = calls
    assert (lib, fn) == ("block_backward_high_small", "dqc_block_backward_high_small")
    assert torch.equal(made[args[4]], _want(einv_r, einv_i, dot, fdt))
    assert torch.equal(made[args[5]], _want(e_r.t(), e_i.t(), "f32", fdt))
    # A1, X, Q, nblk, slots; bkind, bwd_x3, gram_x3, fkind, dot_x3
    assert args[29:34] == (1, 64, 256 * 128, 132, 1)
    assert args[34:39] == (st.storage_kind(fdt), 0, 0, st.storage_kind(fdt),
                           int(dot == "bf16x3"))
    w = bbh.block_backward_high
    assert w.launches == w.mode_launches["tc"] == 1


# ---------------------------------------------------------------------------
# The steps in the kernel's numerics
# ---------------------------------------------------------------------------

def _held(name, got, want, jax_out, tol):
    """``got`` (the kernel's numerics) within ``tol`` of float64 ``want``, and
    of the JAX kernel's output within that plus its own distance from it;
    all relative to the largest entry of ``want``."""
    scale = want.abs().max().item()
    own = (got - want).abs().max().item() / scale
    jax_own = (jax_out - want).abs().max().item() / scale
    vs_jax = (got - jax_out).abs().max().item() / scale
    assert own <= tol, (name, own, tol)
    assert vs_jax <= tol + jax_own, (name, vs_jax, tol, jax_own)


def test_tensor_core_sublane_step_against_pallas():
    """The sublane adjoint: the dual kernel's sublane step alone, no run."""
    A = 2
    rng = np.random.default_rng(310)
    F, B = _cnormal(rng, (A, 128, 128)), _cnormal(rng, (A, 128, 128), 0.5)
    Einv, E = _unitary(rng), _unitary(rng)
    out = jax_sublane(*(np.ascontiguousarray(p) for z in (F, B, Einv, E)
                        for p in (z.real, z.imag)),
                      gram_dot_mode="bf16x3", interpret=True)
    out = [np.asarray(o) for o in out]
    jax_out = [torch.from_numpy(out[2 * k] + 1j * out[2 * k + 1]) for k in range(3)]
    args = [torch.from_numpy(z) for z in (F, B, Einv, E)]
    tc_out = _sublane_step(*args, _split_product, torch.complex64)
    exact = _sublane_step(*(a.to(torch.complex128) for a in args), _exact_product,
                          torch.complex128)
    for name, got, want, jx, tol in zip(("F", "B", "T0"), tc_out, exact, jax_out,
                                        (PLANE_TOL, PLANE_TOL, GRAM_T0_TOL)):
        _held(name, got, want, jx, tol)


def _high_step(F, B, Einv, E, Dinv, D, run_first, prod, dt):
    """The high adjoint at X = 128 on the view (128, Q) of group 2, in the
    kernel's numerics (``prod``) or in float64: the run rolled back where it
    is met (``run_first``: it came before the block in the forward, so after
    the dense stage), the f32 values, unrounded, where Q reads them. Returns
    F, B, T0 and Q's (Qsl, Qas, Qal) over the run's (a = x, s, l)."""
    F, B = F.to(dt), B.to(dt)
    if not run_first:
        Q = B * F
        F, B = (F * Dinv).to(dt), (B * D).to(dt)
    F1 = prod(Einv, F, _tc.split_tf32, _matmul).to(dt)
    T0 = prod(B, F1, st.split, lambda x, y: x @ y.transpose(0, 1))
    B1 = prod(E.transpose(0, 1), B, _tc.split_tf32, _matmul).to(dt)
    if run_first:
        Q = B1 * F1
        F1, B1 = (F1 * Dinv).to(dt), (B1 * D).to(dt)
    Qv = Q.reshape(128, 128, 128)
    return F1, B1, T0, Qv.sum(0), Qv.sum(2), Qv.sum(1)


@pytest.mark.parametrize("run_first", [True, False], ids=["run_before", "run_after"])
def test_tensor_core_high_step_against_pallas(run_first):
    """The high adjoint at X = 128 (group 2 at n = 21: the view (1, 128,
    128, 128), a = x) with a run folded in and its Q, against the JAX
    package's block_backward_high on the view tables its planes hand it."""
    n, X = 21, 128
    rng = np.random.default_rng(320 + run_first)
    F, B = _cnormal(rng, (X, 1 << 14)), _cnormal(rng, (X, 1 << 14), 0.5)
    Einv, E = _unitary(rng), _unitary(rng)

    def phases(shape):
        return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)

    tinv = [phases((128, 128)), phases((X, 128)), phases((X, 128))]
    tfwd = [phases((128, 128)), phases((X, 128)), phases((X, 128))]
    view = (1, X, 128, 128)

    def planes(*zs):
        return [np.ascontiguousarray(p) for z in zs for p in (z.real, z.imag)]

    out = [np.asarray(o) for o in jax_high(
        *(p.reshape(view) for p in planes(F, B)), *planes(Einv, E),
        diag_inv_tables=jpl.dhigh_view_tables(tuple(tinv), 2, n),
        diag_tables=jpl.dhigh_view_tables(tuple(tfwd), 2, n),
        diag_first_fwd=run_first, diag_q=True, dot_mode="f32", bwd_dot_mode="f32",
        gram_dot_mode="bf16x3", interpret=True)]
    # the kernel's Q layouts, read as planes.backward_dhigh reads them: qas
    # (pre, post, k, X, m_blk), qal (pre, post, X, 128), here a = x
    out[8:10] = [np.transpose(q, (0, 3, 1, 2, 4)) for q in out[8:10]]
    out[10:12] = [np.transpose(q, (0, 2, 1, 3)) for q in out[10:12]]
    jax_out = [torch.from_numpy((out[2 * k] + 1j * out[2 * k + 1]).reshape(
        (X, -1) if k < 2 else (128, 128))) for k in range(6)]
    args = [torch.from_numpy(z) for z in (F, B, Einv, E)]
    runs = [_run(t, torch.complex64).reshape(X, -1) for t in (tinv, tfwd)]
    tc_out = _high_step(*args, *runs, run_first, _split_product, torch.complex64)
    exact = _high_step(*(a.to(torch.complex128) for a in args),
                       *(_run(t, torch.complex128).reshape(X, -1) for t in (tinv, tfwd)),
                       run_first, _exact_product, torch.complex128)
    tols = (PLANE_TOL, PLANE_TOL) + (GRAM_T0_TOL,) * 4
    for name, got, want, jx, tol in zip(("F", "B", "T0", "Qsl", "Qas", "Qal"), tc_out,
                                        exact, jax_out, tols):
        _held(name, got, want, jx, tol)
