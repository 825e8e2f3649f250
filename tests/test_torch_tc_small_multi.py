"""The high apply at X = 8..64 and the multi-term dual apply on the tensor
cores, on the CPU.

``csrc/high_apply_small.cu`` (the C entry ``dqc_high_apply_small``, a
library of its own) runs ``y = [acc +] conj?([D] E x [D])`` on the view
(A1, X, Q) at X = 8, 16, 32 and 64 on 2048-amplitude tiles streamed through
shared memory, the product on ``mma.sync`` (3xTF32 or bf16x3), X = 8 as 16
rows under ``diag(E, E)``; ``csrc/dual_multi_apply.cu`` runs ``y = [acc +]
conj?(sum_t Em_t X El_t^T)`` on planes (A, 128, 128), term by term a lane
product ``T_t = El_t X^T`` on a 64-lane column block and a sublane product
``Em_t T_t^T`` summed into registers, both on ``mma.sync``. No CUDA kernel
runs here; these tests hold:

* what each wrapper hands its library on meta planes with the entries
  replaced by recorders: ``E`` (the high apply) and the stacked ``El_t`` and
  ``Em_t`` (the multi-term apply) pre-split in fragment order
  (``_tc.tc_operator``) in the dot mode, ``E`` / ``El_t`` in three parts
  where 3xTF32 meets 16-bit x that no run multiplies first, the kinds and
  the mode flags, for each storage, seed mode, run and dot mode; every
  launch counted in ``mode_launches["tc"]``, and so are the CNOT ring's
  launches at n = 22 and the cz ring's at n = 17 / 24 on the meta device;
* both kernels' arithmetic written out in the kernel's numerics (3xTF32 of
  ``_tc.split_tf32`` parts, the three-part operator on exact x, bf16x3 of
  ``_storage.split`` parts, float64 part products, T_t in complex64)
  against the JAX package's ``high_group_apply_planes`` (X = 8, 16, 64) and
  ``dual_multi_apply_planes`` (T = 2; 4 and 16 marked slow) in interpret
  mode on small views: f32 planes within ``PLANE_TOL`` of the largest entry of the
  float64 result (``X3_PLANE_TOL`` in bf16x3), 16-bit planes within
  ``STORE_ULPS`` storage ulps (chip_smoke.py's bar), and against the JAX
  kernel within that plus the JAX kernel's own distance from float64;
* the plain versions (which the kernels are held to on the card) within the
  same bars.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops import planes as jpl
from dqc_tpu.ops.pallas.dual_apply import dual_multi_apply_planes as jax_multi
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes as jax_high

from dqc_tpu_torch import config
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from test_torch_tc_adjoint import (BF16, F16, F32, PLANE_TOL, _cnormal, _pair, _run,
                                   _unitary, recorded)  # noqa: F401 (a fixture)
from test_torch_tc_adjoint_small_x import (X3_PLANE_TOL, _dec, _exact, _product,
                                           _split_of, _to_jax)
from test_torch_tc_fwd_apply import _held_planes, _seeded

# the modules (the package's names of the same spelling are the wrappers)
ha = importlib.import_module("dqc_tpu_torch.ops.kernels.high_apply")
dma = importlib.import_module("dqc_tpu_torch.ops.kernels.dual_multi_apply")


def _three(xdt, dot, run=None):
    """The operator in three parts: 3xTF32 on 16-bit x no run multiplies first."""
    return dot == "f32" and xdt != F32 and run != "first"


def _seed_kw(form, ydt, shape):
    """A seed form's keywords (conj, acc / out_dtype, alias) on meta planes."""
    if form == "inplace":
        return {}
    if form == "fresh":
        return dict(conj=True, alias=False, out_dtype=ydt)
    acc = torch.empty(shape, dtype=ydt, device="meta")
    return dict(conj=True, acc=(acc, acc), alias=False)


# ---------------------------------------------------------------------------
# What the wrappers hand their library
# ---------------------------------------------------------------------------

# (x storage, y storage, form, run, dot): rows 2x (f32 in place), 2y / 2yf
# (the seeds into f32 / f16 planes), 2v' (bf16 in place, run first; its
# seed), 2x' (bf16x3 on f32 and bf16 planes), 2h (f16 input: fresh, acc)
HIGH_HANDS = [(F32, F32, "inplace", None, "f32"), (F32, F32, "acc", None, "f32"),
              (F32, F16, "acc", "after", "f32"), (BF16, BF16, "inplace", "first", "f32"),
              (BF16, BF16, "acc", None, "f32"), (F32, F32, "inplace", "first", "bf16x3"),
              (BF16, BF16, "acc", "after", "bf16x3"), (F16, F16, "fresh", None, "f32"),
              (F16, F16, "acc", None, "bf16x3")]
HIGH_HAND_IDS = ["f32", "f32_acc", "f32_acc_f16_run_after", "bf16_run_first", "bf16_acc",
                 "x3_run_first", "x3_bf16_acc_run_after", "f16_fresh", "f16_acc_x3"]


@pytest.mark.parametrize("xdt, ydt, form, run, dot", HIGH_HANDS, ids=HIGH_HAND_IDS)
@pytest.mark.parametrize("X", [8, 16, 32, 64])
def test_high_small_hands_presplit_operator(recorded, X, xdt, ydt, form, run, dot):
    calls, made = recorded
    rng = np.random.default_rng(1200 + X)
    ops = _pair(_unitary(rng, X))
    M = 128
    shape = (2, X, M, 128)
    x = torch.empty(shape, dtype=xdt, device="meta")
    kw = dict(dot_mode=dot, **_seed_kw(form, ydt, shape))
    if run is not None:
        kw.update(diag_tables=tuple(torch.zeros(s) for s in [(128, 128)] * 2
                                    + [(2 * X * M // 128, 128)] * 4),
                  diag_first=run == "first")
    out = ha.high_apply(x, x, *ops, **kw)
    (lib, fn, args), = calls
    assert (lib, fn) == ("high_apply_small", "dqc_high_apply_small")
    three = _three(xdt, dot, run)
    assert torch.equal(made[args[6]], _tc.tc_operator(*ops, dot, 6 if three else 4))
    assert args[7] == int(three)
    assert args[4:6] == (st.storage_kind(xdt), st.storage_kind(ydt))
    assert out[0].dtype == ydt
    # has_diag, diag_first, conj, has_acc, x3; A1, X, Q
    assert args[14:22] == (int(run is not None), int(run != "after"), int(form != "inplace"),
                           int(form == "acc"), int(dot == "bf16x3"), 2, X, M * 128)
    w = ha.high_apply
    assert w.launches == w.mode_launches["tc"] == 1


# (x storage, y storage, form, dot): rows 8 (f32 in place), 8s (the seeds),
# 8f (16-bit in place: El_t in three parts; seeds into 16-bit planes), 8v
# (bf16 in place, its seed), 8x (bf16x3 on f32 / bf16 planes)
MULTI_HANDS = [(F32, F32, "inplace", "f32"), (F32, F32, "acc", "f32"),
               (F32, F32, "fresh", "f32"), (F16, F16, "inplace", "f32"),
               (F32, BF16, "acc", "f32"), (F32, F16, "fresh", "f32"),
               (BF16, BF16, "inplace", "f32"), (BF16, BF16, "acc", "f32"),
               (F32, F32, "inplace", "bf16x3"), (BF16, BF16, "acc", "bf16x3"),
               (F16, F16, "inplace", "bf16x3")]
MULTI_HAND_IDS = ["f32", "f32_acc", "f32_fresh", "f16", "f32_acc_bf16", "f32_fresh_f16",
                  "bf16", "bf16_acc", "x3", "x3_bf16_acc", "x3_f16"]


@pytest.mark.parametrize("xdt, ydt, form, dot", MULTI_HANDS, ids=MULTI_HAND_IDS)
@pytest.mark.parametrize("T", [2, 4, 16])
def test_multi_hands_presplit_operators(recorded, T, xdt, ydt, form, dot):
    calls, made = recorded
    rng = np.random.default_rng(1300 + T)
    el, em = _pair(_cnormal(rng, (T, 128, 128))), _pair(_cnormal(rng, (T, 128, 128)))
    A = 2
    shape = (A, 128, 128)
    x = torch.empty(shape, dtype=xdt, device="meta")
    out = dma.dual_multi_apply(x, x, *el, *em, dot_mode=dot, **_seed_kw(form, ydt, shape))
    (lib, fn, args), = calls
    assert (lib, fn) == ("dual_multi_apply", "dqc_dual_multi_apply")
    three = _three(xdt, dot)
    assert torch.equal(made[args[7]], _tc.tc_operator(*el, dot, 6 if three else 4))
    assert torch.equal(made[args[8]], _tc.tc_operator(*em, dot))
    assert made[args[7]].shape[:3] == (T, 16 if dot == "f32" else 8, 8)
    # kinds, x3; El_t in three parts; T, conj, has_acc, A
    assert args[4:7] == (st.storage_kind(xdt), st.storage_kind(ydt), int(dot == "bf16x3"))
    assert args[9:14] == (int(three), T, int(form != "inplace"), int(form == "acc"), A)
    assert out[0].dtype == ydt
    w = dma.dual_multi_apply
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["seed"] == int(form != "inplace")


# the CNOT ring in bf16 / bf16x3 is slow: cnot22 and cz24_x3 take its routes
@pytest.mark.parametrize("n, entangler, storage, dot", [
    (22, "cnot", "f32", "f32"),        # X = 8 span views, the multi-term applies
    pytest.param(22, "cnot", "bf16", "bf16x3", marks=pytest.mark.slow),
    (17, "cz", "f16", "f32"),          # group 2 at X = 8
    (24, "cz", "f32", "bf16x3"),       # group 3 at X = 8
], ids=["cnot22", "cnot22_bf16_x3", "cz17_f16", "cz24_x3"])
def test_models_count_the_tensor_core_applies(recorded, n, entangler, storage, dot):
    """value_and_grad on the meta device: every high apply and every
    multi-term dual apply counts ``[tc]``; the narrow high groups and span
    views reach ``dqc_high_apply_small``."""
    calls, _ = recorded
    config.set_state_storage(storage)
    config.set_kernel_dot_mode(dot)
    try:
        model = THEA(n, 2, entangler, device="meta")
        p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        model.magnetization(p, kernels=tk.KERNELS).backward()
    finally:
        config.set_state_storage("f32")
        config.set_kernel_dot_mode("f32")
    counts = tk.launch_counts()
    for w in ("high_apply", "dual_multi_apply"):
        assert counts[w] == counts[f"{w}[tc]"], counts
    assert counts["high_apply"] > 0
    assert (counts["dual_multi_apply"] > 0) == (entangler == "cnot")
    small = [args for _, fn, args in calls if fn == "dqc_high_apply_small"]
    assert small and all(a[20] in (8, 16, 32, 64) for a in small)


# ---------------------------------------------------------------------------
# The products in the kernels' numerics
# ---------------------------------------------------------------------------

def _jax_seed_kw(form, ydt, jacc):
    import jax.numpy as jnp
    if form == "inplace":
        return {}
    if form == "fresh":
        return dict(conj=True, alias=False,
                    out_dtype={F16: jnp.uint16, BF16: jnp.bfloat16, F32: jnp.float32}[ydt])
    return dict(conj=True, alias=False, acc=tuple(jacc))


def _torch_seed_kw(form, ydt, tacc):
    if form == "inplace":
        return {}
    if form == "fresh":
        return dict(conj=True, alias=False, out_dtype=ydt)
    return dict(conj=True, alias=False, acc=tuple(tacc))


# (X, x storage, y storage, form, run, dot): rows 2x (X = 8 in place), 2y
# (its seed, a run after), 2v' (bf16 in place, run first: E in two parts),
# the f32 rows at X = 16 / 64, 2x' (bf16x3), 2h (f16 into an f16
# accumulator: E in three parts), the seed into f16 planes. Slow: X16_run_first
# (X8_bf16_run_first takes the run first), X64_fresh_f16 (X16_f16_acc and
# X64_bf16_x3_acc take 16-bit y and X = 64), X8_x3_run_first (X64_bf16_x3_acc
# takes bf16x3, X8_bf16_run_first the run first).
SLOW = pytest.mark.slow
HIGH_NUMERICS = [(8, F32, F32, "inplace", None, "f32"),
                 (8, F32, F32, "acc", "after", "f32"),
                 (8, BF16, BF16, "inplace", "first", "f32"),
                 pytest.param(16, F32, F32, "inplace", "first", "f32", marks=SLOW),
                 pytest.param(64, F32, F16, "fresh", None, "f32", marks=SLOW),
                 pytest.param(8, F32, F32, "inplace", "first", "bf16x3", marks=SLOW),
                 (64, BF16, BF16, "acc", None, "bf16x3"),
                 (16, F16, F16, "acc", None, "f32")]
HIGH_NUMERICS_IDS = ["X8", "X8_acc_run_after", "X8_bf16_run_first", "X16_run_first",
                     "X64_fresh_f16", "X8_x3_run_first", "X64_bf16_x3_acc", "X16_f16_acc"]


@pytest.mark.parametrize("X, xdt, ydt, form, run, dot", HIGH_NUMERICS, ids=HIGH_NUMERICS_IDS)
def test_high_small_against_pallas(X, xdt, ydt, form, run, dot):
    """The view (1, X, M, 128): group 2 at n = 14 + log2 X (M = 128, as a run
    needs), or M = 16 without a run."""
    n = 14 + X.bit_length() - 1
    rng = np.random.default_rng(1400 + 7 * X + 3 * (run is not None) + (form == "acc"))
    view = (1, X, 128 if run else 16, 128)
    Xz = _cnormal(rng, view)
    E = _unitary(rng, X)
    jx, tx = _to_jax(Xz, xdt)
    ops = [np.ascontiguousarray(p) for p in (E.real, E.imag)]
    jkw = dict(dot_mode=dot, interpret=True)
    tkw = dict(dot_mode=dot)
    D = None
    if run is not None:
        tables = [np.exp(1j * rng.uniform(0, 2 * np.pi, s)).astype(np.complex64)
                  for s in ((128, 128), (X, 128), (X, 128))]
        jkw.update(diag=jpl.dhigh_view_tables(tuple(tables), 2, n), diag_first=run == "first")
        tkw.update(diag_tables=tuple(p for t in tables for p in _pair(t)),
                   diag_first=run == "first")
        D = _run(tables, torch.complex128).reshape(X, -1)
    jacc = tacc = acc = None
    if form == "acc":
        jacc, tacc = _to_jax(_cnormal(rng, view, 0.5), ydt)
        acc = st.load_b(*tacc).reshape(X, -1)
    out = jax_high(*jx, *ops, **jkw, **_jax_seed_kw(form, ydt, jacc))
    jout = [_dec(np.asarray(p)).reshape(X, -1) for p in out]
    plain = ha.high_apply_plain(*tx, *(torch.from_numpy(o) for o in ops), **tkw,
                                **_torch_seed_kw(form, ydt, tacc))
    assert plain[0].dtype == ydt
    X0 = st.load_b(*tx).reshape(X, -1)
    exact_x = run != "first" and (xdt != F32 if dot == "f32" else xdt == BF16)
    Et = torch.from_numpy(E)

    def numerics(prod, dt):  # the run on the load or the store, E on the tile
        v = X0.to(dt)
        if run == "first":
            v = (v * D.to(dt)).to(dt)
        y = prod(Et, v, _split_of(dot), lambda a, b: a @ b, exact_x).to(dt)
        if run == "after":
            y = (y * D.to(dt)).to(dt)
        return y

    got = _seeded(numerics(_product, torch.complex64), form, acc)
    want = _seeded(numerics(_exact, torch.complex128), form, acc)
    tol = PLANE_TOL if dot == "f32" else X3_PLANE_TOL
    _held_planes("y", ydt, got, want, jout,
                 [st.f32_of(p).reshape(X, -1) for p in plain], tol)


# (T, x storage, y storage, form, dot): rows 8 (T = 2, f32 in place), 8s
# (T = 4 into an accumulator), 8f (f16 in place: El_t in three parts; a
# seed into bf16 planes), 8v (bf16 in place), 8x (bf16x3), and T = 16 (a
# traced k >= 4 gate's terms). Their Pallas interpret compiles take most of
# this file's time under six workers, so only T2 and T2_f16 (the f32 and
# the three-part El_t products; T is a run-time count of the kernel's term
# loop) run in Tier-1; the seeds' and bf16x3's plain versions against Pallas
# are also held by tests/test_torch_vqe_qaoa.py and test_torch_fwd16_cross.py.
MULTI_NUMERICS = [(2, F32, F32, "inplace", "f32"),
                  pytest.param(4, F32, F32, "acc", "f32", marks=SLOW),
                  (2, F16, F16, "inplace", "f32"),
                  pytest.param(2, F32, BF16, "fresh", "f32", marks=SLOW),
                  pytest.param(2, BF16, BF16, "inplace", "bf16x3", marks=SLOW),
                  pytest.param(16, F32, F32, "inplace", "f32", marks=SLOW)]
MULTI_NUMERICS_IDS = ["T2", "T4_acc", "T2_f16", "T2_fresh_bf16", "T2_bf16_x3", "T16"]


@pytest.mark.parametrize("T, xdt, ydt, form, dot", MULTI_NUMERICS, ids=MULTI_NUMERICS_IDS)
def test_multi_against_pallas(T, xdt, ydt, form, dot):
    A = 1 if T > 4 else 2
    rng = np.random.default_rng(1500 + 10 * T + (xdt != F32) + 2 * (form != "inplace"))
    Xz = _cnormal(rng, (A, 128, 128))
    El = np.stack([_unitary(rng) for _ in range(T)])
    Em = np.stack([_unitary(rng) for _ in range(T)])
    jx, tx = _to_jax(Xz, xdt)
    ops = [np.ascontiguousarray(p) for z in (El, Em) for p in (z.real, z.imag)]
    jacc = tacc = acc = None
    if form == "acc":
        jacc, tacc = _to_jax(_cnormal(rng, (A, 128, 128), 0.5), ydt)
        acc = st.load_b(*tacc)
    out = jax_multi(*jx, *ops, dot_mode=dot, interpret=True,
                    **_jax_seed_kw(form, ydt, jacc))
    jout = [_dec(np.asarray(p)) for p in out]
    plain = dma.dual_multi_apply_plain(*tx, *(torch.from_numpy(o) for o in ops),
                                       dot_mode=dot, **_torch_seed_kw(form, ydt, tacc))
    assert plain[0].dtype == ydt
    X0 = st.load_b(*tx)
    exact_x = xdt != F32 if dot == "f32" else xdt == BF16
    split = _split_of(dot)

    def numerics(prod, dt):  # per term: El_t on the slab's rows, Em_t on T_t (f32)
        v = X0.to(dt)
        y = 0
        for t in range(T):
            el, em = torch.from_numpy(El[t]), torch.from_numpy(Em[t])
            Tt = prod(el, v.transpose(1, 2), split, lambda a, b: a @ b, exact_x).to(dt)
            y = y + prod(em, Tt.transpose(1, 2), split, lambda a, b: a @ b).to(dt)
        return y

    got = _seeded(numerics(_product, torch.complex64), form, acc)
    want = _seeded(numerics(_exact, torch.complex128), form, acc)
    tol = PLANE_TOL if dot == "f32" else X3_PLANE_TOL
    _held_planes("y", ydt, got, want, jout, [st.f32_of(p) for p in plain], tol)
