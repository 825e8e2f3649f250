"""The high adjoint at X = 8..64 on the tensor-core step, on the CPU.

``csrc/block_backward_high_small.cu`` (the C entry
``dqc_block_backward_high_small``, a library of its own) runs the one-pass
adjoint of a high-group block at X = 8, 16, 32 and 64 on the tensor cores:
the uncompute, the transport and the pair gram each 3xTF32 ("f32") or
bf16x3, on tiles of 2048 amplitudes streamed through shared memory, X = 8 as
16 rows (two halves of the tile stacked under ``diag(E, E)``). No CUDA
kernel runs here; these tests hold:

* what the wrapper hands the library on meta planes with its entries
  replaced by recorders: ``Einv`` and ``E^T`` pre-split in fragment order
  (``_tc.tc_operator``) in each product's dot mode, in three parts where
  3xTF32 meets 16-bit planes the step holds exact (not after a run rolled
  back on load, which leaves f32 values), X = 8 as ``diag(E, E)``; X, the
  blocks (two per SM below X = 64, one at 64) and the pair gram's slots a
  block; every launch counted in ``mode_launches["tc"]``;
* the step written out in the kernel's numerics (3xTF32 of
  ``_tc.split_tf32`` parts, three-part operators on exact planes, bf16x3 of
  ``_storage.split`` parts, float64 part products, f32 values rounded to
  their storage only where they are stored) against the JAX package's
  ``block_backward_high`` in interpret mode at X = 8, 16, 32 and 64 (group
  2 at n = 17..20: views (1, X, 128, 128), 2^17..2^20 amplitudes) in
  every storage and dot mode, a run met first or after with its Q and none:
  f32 planes within ``PLANE_TOL`` of their largest entry of the float64
  step (``X3_PLANE_TOL`` where a bf16x3 product made them), 16-bit planes
  within ``STORE_ULPS`` storage ulps (chip_smoke.py's bar), the pair gram
  and each Q output within ``GRAM_T0_TOL`` of their largest entry
  (``gram_tolerance`` next to 16-bit planes, ``X3_GRAM_TOL`` for a bf16x3
  gram), and against the JAX kernel within that plus the JAX kernel's own
  distance from float64.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.block_backward import block_backward_high as jax_high

from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from chip_smoke import GRAM_T0_TOL, STORE_ULPS, X3_GRAM_TOL
from test_torch_tc_adjoint import (BF16, F16, F32, PLANE_TOL, _cnormal, _meta_planes,
                                   _pair, _run, _unitary, _want,
                                   recorded)  # noqa: F401 (a fixture)

bbh = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_high")

X3_PLANE_TOL = 1e-4   # of the largest entry: a bf16x3 product's own error
SMALL_X = (8, 16, 32, 64)


# ---------------------------------------------------------------------------
# What the wrapper hands its library
# ---------------------------------------------------------------------------

def _ops(seed, X):
    rng = np.random.default_rng(seed)
    return [p for _ in range(2) for p in _pair(_cnormal(rng, (X, X)))]


def _tables(A):
    return tuple(torch.zeros(s) for s in [(128, 128)] * 2 + [(A, 128)] * 4)


# (F storage, B storage, dot_mode, bwd_mode, gram_mode, run)
HANDS = [(F32, F32, "f32", "f32", "f32", None), (F32, F32, "f32", "f32", "bf16x3", None),
         (F32, F16, "f32", "f32", "bf16x3", None), (BF16, BF16, "f32", "bf16x3", "bf16x3", None),
         (F32, F32, "bf16x3", "bf16x3", "bf16x3", None),
         (BF16, BF16, "f32", "f32", "f32", "before"), (BF16, BF16, "f32", "f32", "f32", "after"),
         (F32, F16, "f32", "f32", "bf16x3", "after")]
HAND_IDS = ["f32", "f32_gram_x3", "f16_f32_transport", "bf16_x3", "f32_all_x3",
            "bf16_f32_run_before_q", "bf16_f32_run_after_q", "f16_run_after_q"]


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram, run", HANDS, ids=HAND_IDS)
@pytest.mark.parametrize("X", SMALL_X)
def test_small_x_hands_presplit_operators(recorded, X, fdt, bdt, dot, bwd, gram, run):
    calls, made = recorded
    einv_r, einv_i, e_r, e_i = ops = _ops(60 + X, X)
    kw = dict(dot_mode=dot, bwd_mode=bwd, gram_mode=gram)
    M = 128
    if run:
        tabs = _tables(2 * X * M // 128)
        kw.update(diag_inv_tables=tabs, diag_tables=tabs,
                  diag_first_fwd=run == "before", diag_q=True)
    f, _, _, _ = _meta_planes(fdt, fdt, 2, (X, M, 128))
    _, _, b, _ = _meta_planes(bdt, bdt, 2, (X, M, 128))
    bbh.block_backward_high(f, f, b, b, *ops, **kw)
    (lib, fn, args), = calls
    assert (lib, fn) == ("block_backward_high_small", "dqc_block_backward_high_small")
    # a run rolled back on load (met first: it followed the block in the
    # forward) leaves f32 values, which the operators then meet in two parts
    f32_tiles = run == "after"
    assert torch.equal(made[args[4]], _want(einv_r, einv_i, dot, F32 if f32_tiles else fdt))
    assert torch.equal(made[args[5]], _want(e_r.t(), e_i.t(), bwd, F32 if f32_tiles else bdt))
    # has_diag, diag_first_fwd, diag_q
    assert args[18:21] == (int(run is not None), int(run != "after"), int(run is not None))
    # A1, X, Q, nblk (2048-amplitude tiles or (i, p) groups, at most two
    # blocks an SM below X = 64), slots
    tiles = 2 * X * M * 128 // 2048
    nblk = 2 if run else min(tiles, (1 if X == 64 else 2) * 132)
    assert args[29:34] == (2, X, M * 128, nblk, bbh.SMALL_SLOTS[X])
    assert args[34:39] == (st.storage_kind(bdt), int(bwd == "bf16x3"),
                           int(gram == "bf16x3"), st.storage_kind(fdt),
                           int(dot == "bf16x3"))
    w = bbh.block_backward_high
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["diag_q"] == int(run is not None)


def _unpack(op, X, mode):
    """A pre-split operator's (X x X, X = 8: 16 x 16) re hi part as a matrix,
    from its fragment order (k-step, m-tile, part, lane, register)."""
    XR = max(X, 16)
    ks = 8 if mode == "f32" else 16
    out = np.zeros((XR, XR), np.float32)
    regs = op[:, :, 0].numpy()  # the re hi part
    for s in range(XR // ks):
        for mt in range(XR // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for r in range(4):
                    row = mt * 16 + g + 8 * (r & 1)
                    word = np.array([regs[s, mt, lane, r]], np.int32)
                    if ks == 8:
                        out[row, s * ks + t + 4 * (r >> 1)] = word.view(np.float32)[0]
                    else:  # two bf16 values, the lower column low
                        pair = word.view(np.uint16).astype(np.uint32) << 16
                        col = s * ks + 2 * t + 8 * (r >> 1)
                        out[row, col:col + 2] = pair.view(np.float32)
    return out


@pytest.mark.parametrize("mode", ["f32", "bf16x3"])
@pytest.mark.parametrize("X", [8, 16])
def test_small_x_operator_layout(X, mode):
    """The pre-split operator holds E's hi parts at the fragments' rows and
    columns; X = 8 holds diag(E, E), so that rows 8..15 of the stacked tile
    (its columns from 128 on) meet E as rows 0..7 do."""
    rng = np.random.default_rng(70 + X)
    E = _unitary(rng, X)
    er, ei = _pair(E)
    got = _unpack(_tc.tc_operator(er, ei, mode), X, mode)
    hi = (_tc.split_tf32(er)[0] if mode == "f32" else st.split(er)[0]).numpy()
    want = np.kron(np.eye(2, dtype=np.float32), hi) if X == 8 else hi
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The step in the kernel's numerics
# ---------------------------------------------------------------------------

def _parts(z, split):
    return [p.double() for p in (*split(z.real.float().contiguous()),
                                 *split(z.imag.float().contiguous()))]


def _product(a, b, split, mm, b_exact=False):
    """``mm(a, b)`` of complex tensors, each real product as the kernel's
    passes of split parts (hi hi + hi lo + lo hi; with ``b_exact`` and the
    tf32 split, b's lo parts zero and a in three parts), each pass exact
    (float64). complex128."""
    if b_exact and split is _tc.split_tf32:
        ar3 = [p.double() for p in _tc.split_tf32_3(a.real.float().contiguous())]
        ai3 = [p.double() for p in _tc.split_tf32_3(a.imag.float().contiguous())]
        br, bi = b.real.double(), b.imag.double()
        ar, ai = sum(ar3), sum(ai3)
        return torch.complex(mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br))
    arh, arl, aih, ail = _parts(a, split)
    brh, brl, bih, bil = _parts(b, split)

    def mul3(xh, xl, yh, yl):
        return mm(xh, yh) + mm(xh, yl) + mm(xl, yh)

    return torch.complex(mul3(arh, arl, brh, brl) - mul3(aih, ail, bih, bil),
                         mul3(arh, arl, bih, bil) + mul3(aih, ail, brh, brl))


def _exact(a, b, split, mm, b_exact=False):
    return mm(a.to(torch.complex128), b.to(torch.complex128))


def _split_of(mode):
    return _tc.split_tf32 if mode == "f32" else st.split


def _gram(x, y):
    return x @ y.transpose(0, 1)


def _matmul(x, y):
    return x @ y


def _step(F, B, Einv, E, Dinv, D, run, modes, dtypes, prod, dt):
    """The adjoint step on the view (X, Q) in the kernel's numerics
    (``prod``) or in float64: F and B as loaded (decoded), the run rolled
    back where it is met (``run``: "before" the block in the forward, so met
    after the dense stage; "after"; None), Q of the f32 values there. The
    planes an operator meets are exact when stored 16-bit and not rolled
    back on load. Returns F, B, T0 and, with a run, Qsl, Qas, Qal over
    (a = x, s, l)."""
    dot, bwd, gram = modes
    fdt, bdt = dtypes
    F, B = F.to(dt), B.to(dt)
    stored = run != "after"
    Q = None
    if run == "after":
        Q = B * F
        F, B = (F * Dinv).to(dt), (B * D).to(dt)
    F1 = prod(Einv, F, _split_of(dot), _matmul, stored and fdt != F32 and dot == "f32").to(dt)
    T0 = prod(B, F1, _split_of(gram), _gram).to(dt)
    B1 = prod(E.transpose(0, 1), B, _split_of(bwd), _matmul,
              stored and bdt != F32 and bwd == "f32").to(dt)
    if run == "before":
        Q = B1 * F1
        F1, B1 = (F1 * Dinv).to(dt), (B1 * D).to(dt)
    out = [F1, B1, T0]
    if Q is not None:
        X = F.shape[0]
        Qv = Q.reshape(X, 128, 128)
        out += [Qv.sum(0), Qv.sum(2), Qv.sum(1)]
    return out


def _to_jax(z, dtype):
    """A complex plane pair stored as ``dtype`` as the JAX package holds it
    (bf16 arrays, f16 as uint16 bits), and as the port holds it."""
    t = [st.store_as(p, dtype) for p in _pair(z)]
    if dtype == F16:
        j = [p.view(torch.int16).numpy().view(np.uint16) for p in t]
    elif dtype == BF16:
        import jax.numpy as jnp
        j = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16) for p in t]
    else:
        j = [p.numpy() for p in t]
    return j, t


def _dec(x):
    from dqc_tpu.ops.pallas import common as cm
    return torch.from_numpy(np.array(cm.f32_of(x)))


# (X, F storage, B storage, dot, bwd, gram, run)
STEPS = [(8, F32, F32, "f32", "f32", "f32", "after"),
         (8, BF16, BF16, "bf16x3", "bf16x3", "bf16x3", None),
         (16, BF16, BF16, "f32", "bf16x3", "bf16x3", "before"),
         (32, F32, F16, "f32", "f32", "bf16x3", None),
         (32, F32, F32, "f32", "f32", "bf16x3", "before"),
         (64, F32, F32, "bf16x3", "bf16x3", "bf16x3", "after"),
         (64, BF16, BF16, "f32", "f32", "f32", None)]
STEP_IDS = ["X8-f32-run_after_q", "X8-bf16_all_x3", "X16-bf16_x3-run_before_q",
            "X32-f16_f32_transport", "X32-f32_gram_x3-run_before_q",
            "X64-f32_all_x3-run_after_q", "X64-bf16_f32_three_part"]


@pytest.mark.parametrize("X, fdt, bdt, dot, bwd, gram, run", STEPS, ids=STEP_IDS)
def test_small_x_step_against_pallas(X, fdt, bdt, dot, bwd, gram, run):
    """Group 2 at n = 14 + log2 X: the view (1, X, 128, 128), a = x."""
    n = 14 + X.bit_length() - 1
    rng = np.random.default_rng(400 + X + 7 * STEPS.index((X, fdt, bdt, dot, bwd, gram, run)))
    Fz, Bz = _cnormal(rng, (X, 1 << 14)), _cnormal(rng, (X, 1 << 14), 0.5)
    Einv, E = _unitary(rng, X), _unitary(rng, X)
    view = (1, X, 128, 128)
    jf, tf = _to_jax(Fz, fdt)
    jb, tb = _to_jax(Bz, bdt)
    kw = {}
    if run:
        def phases(shape):
            return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)

        tinv = [phases((128, 128)), phases((X, 128)), phases((X, 128))]
        tfwd = [phases((128, 128)), phases((X, 128)), phases((X, 128))]
        kw = dict(diag_inv_tables=jpl.dhigh_view_tables(tuple(tinv), 2, n),
                  diag_tables=jpl.dhigh_view_tables(tuple(tfwd), 2, n),
                  diag_first_fwd=run == "before", diag_q=True)
    ops = [np.ascontiguousarray(p) for z in (Einv, E) for p in (z.real, z.imag)]
    out = list(jax_high(*(p.reshape(view) for p in (*jf, *jb)), *ops,
                        dot_mode=dot, bwd_dot_mode=bwd, gram_dot_mode=gram,
                        interpret=True, **kw))
    if run:
        # the kernel's Q layouts, read as planes.backward_dhigh reads them:
        # qas (pre, post, k, X, m_blk), qal (pre, post, X, 128), here a = x
        out[8:10] = [np.transpose(np.asarray(q), (0, 3, 1, 2, 4)) for q in out[8:10]]
        out[10:12] = [np.transpose(np.asarray(q), (0, 2, 1, 3)) for q in out[10:12]]
    jax_planes = [(out[0], out[1]), (out[2], out[3])]
    jax_red = [torch.from_numpy((np.asarray(out[2 * k]) + 1j * np.asarray(out[2 * k + 1]))
                                .reshape((X, X) if k == 2 else (128, 128) if k == 3
                                         else (X, 128)))
               for k in range(2, 6 if run else 3)]
    # the planes as the kernel loads them (decoded)
    F0 = st.load_b(*tf).reshape(X, -1)
    B0 = st.load_b(*tb).reshape(X, -1)
    runs = ((None, None) if not run else
            tuple(_run(t, torch.complex64).reshape(X, -1) for t in (tinv, tfwd)))
    runs64 = ((None, None) if not run else
              tuple(_run(t, torch.complex128).reshape(X, -1) for t in (tinv, tfwd)))
    Et, Eit = torch.from_numpy(E), torch.from_numpy(Einv)
    args = (run, (dot, bwd, gram), (fdt, bdt))
    got = _step(F0, B0, Eit, Et, *runs, *args, _product, torch.complex64)
    want = _step(F0, B0, Eit, Et, *runs64, *args, _exact, torch.complex128)
    # the planes: stored to their storage
    for name, k, dt, mode in (("F", 0, fdt, dot), ("B", 1, bdt, bwd)):
        g_st = st.store_b(got[k].to(torch.complex64), dt)
        if dt == F32:
            tol = PLANE_TOL if mode == "f32" else X3_PLANE_TOL
            jx = torch.complex(*(torch.from_numpy(np.array(p)).reshape(X, -1)
                                 for p in jax_planes[k]))
            _held(name, got[k].to(torch.complex128), want[k], jx.to(torch.complex128), tol)
            continue
        w_st = st.store_b(want[k].to(torch.complex64), dt)
        j_st = [_dec(p).reshape(X, -1) for p in jax_planes[k]]
        own = st.ulps_apart(g_st, w_st, dt)
        jax_own = st.ulps_apart([st.store_as(p, dt) for p in j_st], w_st, dt)
        vs_jax = st.ulps_apart(g_st, [st.store_as(p, dt) for p in j_st], dt)
        assert own <= STORE_ULPS, (name, own)
        assert vs_jax <= STORE_ULPS + jax_own, (name, vs_jax, jax_own)
    red = [d for d in (bdt, fdt) if d != F32]
    gtol = (st.gram_tolerance(red[0]) if red
            else X3_GRAM_TOL if "bf16x3" in (gram, dot) else GRAM_T0_TOL)
    names = ("T0", "Qsl", "Qas", "Qal")
    for name, g, w, jx in zip(names, got[2:], want[2:], jax_red):
        _held(name, g.to(torch.complex128), w, jx.to(torch.complex128), gtol)


def _held(name, got, want, jax_out, tol):
    """``got`` (the kernel's numerics) within ``tol`` of float64 ``want``,
    and of the JAX kernel's output within that plus its own distance from
    it; all relative to the largest entry of ``want``."""
    scale = want.abs().max().item()
    own = (got - want).abs().max().item() / scale
    jax_own = (jax_out - want).abs().max().item() / scale
    vs_jax = (got - jax_out).abs().max().item() / scale
    assert own <= tol, (name, own, tol)
    assert vs_jax <= tol + jax_own, (name, vs_jax, tol, jax_own)
