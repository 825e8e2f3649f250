"""The high multi-term apply on the dual multi-term kernel and the Gram at
X = 8..64 on the tensor cores, on the CPU.

``csrc/dual_multi_apply.cu``'s C entry ``dqc_high_multi_apply`` runs ``y =
[acc +] conj?(sum_t E_t x El_t^T)`` on the view (A1, X, M, 128) as the dual
form's kernel: a tile of 128 rows (row r = mm X + x of 128 / X consecutive
m of one i) by 128 lanes, per term the lane product ``T_t = El_t Z^T`` and
the group product, block-diagonal (128 / X copies of ``E_t``; X = 8 as
``diag(E_t, E_t)`` on 16-row m-tiles), both on ``mma.sync``.
``csrc/gram.cu``'s ``dqc_gram_tc`` now forms ``(S, C)`` at X = 8..64 too,
one X x X patch a block (``S = P + P^T``). No CUDA kernel runs here; these
tests hold:

* what each wrapper hands its library on meta planes with the entries
  replaced by recorders: the stacked ``El_t`` and ``E_t`` pre-split in
  fragment order (``_tc.tc_operator``; ``El_t`` in three parts where 3xTF32
  meets 16-bit x), the kinds, the mode flags and the view, for each storage
  pair, seed form and dot mode at X = 8, 16 and 128, every launch counted
  in ``mode_launches["tc"]``; the Gram's view, blocks and flags at X = 8
  and 64; the CNOT ring's launches at n = 22 and the cz ring's Grams at
  n = 17 and 20 on the meta device;
* both kernels' arithmetic written out in the kernel's numerics (the row
  map, the block-diagonal group product built from ``diag(E_t, E_t)`` at
  X = 8, 3xTF32 of ``_tc.split_tf32`` parts, the three-part ``El_t`` on
  exact x, bf16x3 of ``_storage.split`` parts, float64 part products, T_t
  and each term in complex64) against the JAX package's
  ``high_multi_apply_planes`` (X = 8, 16, 128; T = 2) and ``gram_high`` (X
  = 8, 16, 64) in interpret mode on small views: f32 planes within
  ``PLANE_TOL`` of the largest entry of the float64 result (``X3_PLANE_TOL``
  in bf16x3), 16-bit planes within ``STORE_ULPS`` storage ulps, the Gram
  within ``GRAM_T0_TOL`` (``X3_GRAM_TOL`` in bf16x3), and against the JAX
  kernel within that plus the JAX kernel's own distance from float64; the
  plain version within the same bars.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas.gram import gram_high as jax_gram
from dqc_tpu.ops.pallas.high_apply import high_multi_apply_planes as jax_multi

from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from chip_smoke import GRAM_T0_TOL, X3_GRAM_TOL
from test_torch_tc_adjoint import (BF16, F16, F32, PLANE_TOL, _cnormal, _pair, _unitary,
                                   recorded)  # noqa: F401 (a fixture)
from test_torch_tc_adjoint_small_x import (X3_PLANE_TOL, _dec, _exact, _held, _product,
                                           _split_of, _to_jax)
from test_torch_tc_fwd_apply import _held_planes, _seeded
from test_torch_tc_gram import _exact_gram, _tc_gram
from test_torch_tc_small_multi import _jax_seed_kw, _seed_kw, _three, _torch_seed_kw

# the modules (the package's names of the same spelling are the wrappers)
hma = importlib.import_module("dqc_tpu_torch.ops.kernels.high_multi_apply")
gm = importlib.import_module("dqc_tpu_torch.ops.kernels.gram")


# ---------------------------------------------------------------------------
# What the wrappers hand their library
# ---------------------------------------------------------------------------

# (x storage, y storage, form, dot): row 9 (f32 in place), 9s (the seeds),
# 9f (16-bit in place: El_t in three parts; seeds into 16-bit planes), 9v
# (bf16 in place, its seed), 9x (bf16x3 on f32 / bf16 planes)
HANDS = [(F32, F32, "inplace", "f32"), (F32, F32, "acc", "f32"),
         (F32, F16, "fresh", "f32"), (F16, F16, "inplace", "f32"),
         (BF16, BF16, "acc", "f32"), (F32, F32, "inplace", "bf16x3"),
         (BF16, BF16, "inplace", "bf16x3")]
HAND_IDS = ["f32", "f32_acc", "f32_fresh_f16", "f16", "bf16_acc", "x3", "x3_bf16"]


@pytest.mark.parametrize("xdt, ydt, form, dot", HANDS, ids=HAND_IDS)
@pytest.mark.parametrize("X", [8, 16, 128])
def test_high_multi_hands_presplit_operators(recorded, X, xdt, ydt, form, dot):
    calls, made = recorded
    T = 2 if X == 8 else 4
    rng = np.random.default_rng(2000 + X)
    e = _pair(_cnormal(rng, (T, X, X)))
    el = _pair(_cnormal(rng, (T, 128, 128)))
    A1, M = 2, 2 * (128 // X)
    shape = (A1, X, M, 128)
    x = torch.empty(shape, dtype=xdt, device="meta")
    out = hma.high_multi_apply(x, x, *e, *el, dot_mode=dot, **_seed_kw(form, ydt, shape))
    (lib, fn, args), = calls
    assert (lib, fn) == ("dual_multi_apply", "dqc_high_multi_apply")
    three = _three(xdt, dot)
    assert torch.equal(made[args[7]], _tc.tc_operator(*el, dot, 6 if three else 4))
    assert torch.equal(made[args[8]], _tc.tc_operator(*e, dot))
    ks = 8 if dot == "f32" else 16
    assert made[args[8]].shape[:3] == (T, max(X, 16) // ks, max(X, 16) // 16)
    # kinds, x3; El_t in three parts; T, conj, has_acc; A1, X, M
    assert args[4:7] == (st.storage_kind(xdt), st.storage_kind(ydt), int(dot == "bf16x3"))
    assert args[9:16] == (int(three), T, int(form != "inplace"), int(form == "acc"),
                          A1, X, M)
    assert out[0].dtype == ydt
    w = hma.high_multi_apply
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["seed"] == int(form != "inplace")


def test_high_multi_refuses_views_the_tiles_do_not_cover(recorded):
    x = torch.empty((1, 8, 8, 128), device="meta")
    e, el = _pair(np.ones((1, 8, 8), np.complex64)), _pair(np.ones((1, 128, 128), np.complex64))
    with pytest.raises(ValueError, match="multiple of 16"):
        hma.high_multi_apply(x, x, *e, *el)


@pytest.mark.parametrize("dtype, dot", [(F32, "f32"), (F32, "bf16x3"), (BF16, "f32")],
                         ids=["f32", "f32_x3", "bf16"])
@pytest.mark.parametrize("X", [8, 64])
def test_gram_hands_the_small_tensor_core_entry(recorded, X, dtype, dot):
    """X <= 64: ``dqc_gram_tc`` with the view, two blocks an SM (at most
    one per 128-column tile, 64 at X = 64), the storage kind and the bf16x3
    flag; counted ``[tc]``."""
    calls, _ = recorded
    view = (4, X, 1 << 14)
    x = torch.empty(view, dtype=dtype, device="meta")
    gm.gram(x, x, dot_mode=dot)
    (lib, fn, args), = calls
    assert (lib, fn) == ("gram", "dqc_gram_tc")
    cols = 64 if X == 64 else 128
    assert gm.tile_columns(X) == cols and gm.k_groups(X) == (2 if X == 64 else 8)
    assert args[5:11] == (*view, min(4 * (1 << 14) // cols, 2 * 132),
                          st.storage_kind(dtype), int(dot == "bf16x3"))
    w = gm.gram
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["fwd_bf16"] == int(dtype == BF16)


@pytest.mark.parametrize("n, entangler", [(22, "cnot"), (17, "cz"), (20, "cz")],
                         ids=["cnot22", "cz17", "cz20"])
def test_models_count_the_tensor_core_routes(recorded, n, entangler):
    """value_and_grad on the meta device, one layer: every high multi-term
    apply reaches ``dqc_high_multi_apply`` and counts ``[tc]`` (the CNOT
    ring's closing edge on its X = 8 span view); every Gram counts ``[tc]``,
    the narrow groups' (X = 8 at n = 17, 64 at n = 20) too."""
    calls, _ = recorded
    model = THEA(n, 1, entangler, device="meta")
    p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    model.magnetization(p, kernels=tk.KERNELS).backward()
    counts = tk.launch_counts()
    for w in ("high_multi_apply", "gram"):
        assert counts[w] == counts[f"{w}[tc]"], counts
    assert (counts["high_multi_apply"] > 0) == (entangler == "cnot")
    multi = [args for _, fn, args in calls if fn == "dqc_high_multi_apply"]
    assert len(multi) == counts["high_multi_apply"]
    assert all(a[14] == 8 for a in multi)
    grams = sorted({args[6] for _, fn, args in calls if fn == "dqc_gram_tc"})
    if entangler == "cz":
        assert grams == sorted([128, 1 << (n - 14)])


# ---------------------------------------------------------------------------
# The products in the kernels' numerics
# ---------------------------------------------------------------------------

def _tiles(X, M):
    """The planes' flat offsets of each tile's rows on the view (A1 = 1, X,
    M, 128) as the kernel reads them: tile b, row r = mm X + x at b (128 /
    X) 128 + (r mod X) Q + (r div X) 128, Q = M 128."""
    Q, gp = M * 128, 128 // X
    r = torch.arange(128)
    return torch.stack([b * gp * 128 + (r % X) * Q + (r // X) * 128
                        for b in range(M // gp)])


def _group_operator(E):
    """The group product's 128 x 128 operator: block-diagonal, 128 / X
    copies of E, X = 8 as the kernel lays it out: 8 copies of diag(E, E)."""
    blk = _tc._diag2(E) if E.shape[-1] == 8 else E
    return torch.block_diag(*[blk] * (128 // blk.shape[-1]))


# (X, x storage, y storage, form, dot): row 9 (X = 8, f32 in place), 9x
# (bf16x3 on bf16 planes), 9f (f16 into an f16 accumulator: El_t in three
# parts), the dual form's width at X = 128 on the high view (M = 2)
NUMERICS = [(8, F32, F32, "inplace", "f32"), (8, BF16, BF16, "inplace", "bf16x3"),
            (16, F16, F16, "acc", "f32"), (128, F32, F32, "fresh", "f32")]
NUMERICS_IDS = ["X8", "X8_bf16_x3", "X16_f16_acc", "X128_fresh"]


@pytest.mark.parametrize("X, xdt, ydt, form, dot", NUMERICS, ids=NUMERICS_IDS)
def test_high_multi_against_pallas(X, xdt, ydt, form, dot):
    T, M = 2, 2 * (128 // X)
    view = (1, X, M, 128)
    rng = np.random.default_rng(2100 + X + (xdt != F32))
    Xz = _cnormal(rng, view)
    E = np.stack([_unitary(rng, X) for _ in range(T)])
    El = np.stack([_unitary(rng) for _ in range(T)])
    jx, tx = _to_jax(Xz, xdt)
    ops = [np.ascontiguousarray(p) for z in (E, El) for p in (z.real, z.imag)]
    jacc = tacc = acc = None
    if form == "acc":
        jacc, tacc = _to_jax(_cnormal(rng, view, 0.5), ydt)
        acc = st.load_b(*tacc).reshape(-1)
    out = jax_multi(*jx, *ops, dot_mode=dot, interpret=True, **_jax_seed_kw(form, ydt, jacc))
    jout = [_dec(np.asarray(p)).reshape(-1) for p in out]
    plain = hma.high_multi_apply_plain(*tx, *(torch.from_numpy(o) for o in ops),
                                       dot_mode=dot, **_torch_seed_kw(form, ydt, tacc))
    assert plain[0].dtype == ydt
    flat = st.load_b(*tx).reshape(-1)
    rows = _tiles(X, M)
    exact_x = xdt != F32 if dot == "f32" else xdt == BF16
    split = _split_of(dot)

    def numerics(prod, dt):  # per tile and term: El_t on its rows, E_t's blocks on T_t
        y = torch.zeros(flat.shape, dtype=dt)
        for idx in rows:
            Z = flat[idx[:, None] + torch.arange(128)].to(dt)   # (128 rows, 128 lanes)
            yb = 0
            for t in range(T):
                el = torch.from_numpy(El[t])
                Tt = prod(el, Z.transpose(0, 1), split, lambda a, b: a @ b, exact_x).to(dt)
                G = _group_operator(torch.from_numpy(E[t]))
                yb = yb + prod(G, Tt.transpose(0, 1), split, lambda a, b: a @ b).to(dt)
            y[idx[:, None] + torch.arange(128)] = yb
        return y

    got = _seeded(numerics(_product, torch.complex64), form, acc)
    want = _seeded(numerics(_exact, torch.complex128), form, acc)
    tol = PLANE_TOL if dot == "f32" else X3_PLANE_TOL
    _held_planes("y", ydt, got, want, jout, [st.f32_of(p).reshape(-1) for p in plain], tol)


GRAMS = [(8, F32, "f32"), (16, F32, "bf16x3"), (64, BF16, "f32")]


@pytest.mark.parametrize("X, dtype, dot", GRAMS,
                         ids=[f"X{X}-{'bf16' if d == BF16 else 'f32'}-{m}" for X, d, m in GRAMS])
def test_small_gram_against_pallas(X, dtype, dot):
    """The view (1, X, 16 128): every X-row column a k of the patch's
    products; X = 8's zero rows add nothing to P, C or their sums."""
    shape = (1, X, 16, 128)
    rng = np.random.default_rng(2200 + X)
    jz, tz = _to_jax(_cnormal(rng, shape), dtype)
    S_j, C_j = (torch.from_numpy(np.asarray(o, np.float64))
                for o in jax_gram(*jz, dot_mode=dot, interpret=True))
    xr, xi = (st.f32_of(t).reshape(1, X, -1) for t in tz)
    if X == 8:  # the A fragments' 16 rows, the last 8 zero
        pad = [torch.cat([v, torch.zeros_like(v)], 1) for v in (xr, xi)]
        S16, C16 = _tc_gram(*pad, dot, dtype != F32)
        assert not S16[8:].any() and not C16[8:].any()
    got = _tc_gram(xr, xi, dot, dtype != F32)
    want = _exact_gram(xr, xi)
    plain = gm.gram_plain(*(t.reshape(1, X, -1) for t in tz), dot)
    tol = X3_GRAM_TOL if dot == "bf16x3" and dtype == F32 else GRAM_T0_TOL
    for name, g, p, w, jx in zip(("S", "C"), got, plain, want, (S_j, C_j)):
        _held(name, g, w, jx, tol)
        _held(f"plain {name}", p.double(), w, jx, tol)
