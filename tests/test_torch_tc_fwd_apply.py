"""The dual apply and the merged-top apply on the tensor cores, on the CPU.

``csrc/dual_apply.cu`` runs ``y = [acc +] conj?([D] Em X El^T [D])`` on
planes (A, 128, 128) as ``csrc/tc_adjoint.cuh``'s tile product: the lane
product ``T = X El^T`` on the slab's two 64-row tiles, then ``Em T`` on its
two 64-column tiles, each on ``mma.sync`` (3xTF32 or bf16x3);
``csrc/merged_fact_apply.cu`` runs ``(Et (x) El) x`` on the merged view
(A1, Xt 128, M, 128) as the same product on tiles of the Xt slices, the top
factor combining the slices on the load in f32. No CUDA kernel runs here;
these tests hold:

* what each wrapper hands its library on meta planes with the entries
  replaced by recorders: ``El`` and ``Em`` (the dual apply) and ``El`` (the
  merged apply) pre-split in fragment order (``_tc.tc_operator``) in the
  dot mode, ``El`` in three parts where 3xTF32 meets 16-bit x that no run
  multiplies first, the kinds and the mode flags, for each storage, seed
  mode, run and dot mode (the dual apply) and each Xt, storage and dot mode
  (the merged apply); every launch counted in ``mode_launches["tc"]``, and
  so are the cz ring's launches of both at n = 22 / 23 on the meta device;
* both kernels' arithmetic written out in the kernel's numerics (3xTF32 of
  ``_tc.split_tf32`` parts, the three-part operator on exact x, bf16x3 of
  ``_storage.split`` parts, float64 part products, T and the top factor's
  combinations in complex64) against the JAX package's
  ``dual_group_apply_planes`` and ``merged_fact_apply_planes`` in interpret
  mode, on the views (2, 128, 128) and (1, Xt 128, 2, 128): f32 planes
  within ``PLANE_TOL`` of the largest entry of the float64 result
  (``X3_PLANE_TOL`` in bf16x3), 16-bit planes within ``STORE_ULPS`` storage
  ulps (chip_smoke.py's bar), and against the JAX kernel within that plus
  the JAX kernel's own distance from float64;
* the plain versions (which the kernels are held to on the card) within the
  same bars.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes as jax_dual
from dqc_tpu.ops.pallas.high_apply import merged_fact_apply_planes as jax_merged

from dqc_tpu_torch import config
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from chip_smoke import STORE_ULPS
from test_torch_tc_adjoint import (BF16, F16, F32, PLANE_TOL, _cnormal, _pair, _run,
                                   _unitary, recorded)  # noqa: F401 (a fixture)
from test_torch_tc_adjoint_small_x import (X3_PLANE_TOL, _dec, _exact, _held, _product,
                                           _split_of, _to_jax)

# the modules (the package's names of the same spelling are the wrappers)
da = importlib.import_module("dqc_tpu_torch.ops.kernels.dual_apply")
mfa = importlib.import_module("dqc_tpu_torch.ops.kernels.merged_fact_apply")


def _phases(rng, shape):
    return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)


def _tables(rng, A):
    """A run's factors (tsl, tas, tal) as complex64 arrays."""
    return [_phases(rng, (128, 128)), _phases(rng, (A, 128)), _phases(rng, (A, 128))]


def _table_planes(tables):
    return tuple(p for t in tables for p in _pair(t))


def _three(xdt, dot, run):
    return dot == "f32" and xdt != F32 and run != "first"


# ---------------------------------------------------------------------------
# What the wrappers hand their library
# ---------------------------------------------------------------------------

# (x storage, y storage, form, run, dot): PERF.md's rows 1 (run first, and no
# run), 1s, 1f (acc f16 / bf16, fresh f16), 1v (in place, the seed; a run
# after, so El in three parts), 1x (f32 and bf16 planes, the seeds) and 1h
# (f16 input: fresh, acc)
HANDS = [(F32, F32, "inplace", "first", "f32"), (F32, F32, "inplace", None, "f32"),
         (F32, F32, "acc", None, "f32"), (F32, F16, "acc", None, "f32"),
         (F32, BF16, "acc", None, "f32"), (F32, F16, "fresh", None, "f32"),
         (BF16, BF16, "inplace", "first", "f32"), (BF16, BF16, "acc", None, "f32"),
         (BF16, BF16, "inplace", "after", "f32"), (F32, F32, "inplace", "after", "bf16x3"),
         (BF16, BF16, "inplace", None, "bf16x3"), (F32, BF16, "acc", None, "bf16x3"),
         (F16, F16, "fresh", None, "f32"), (F16, F16, "acc", None, "bf16x3")]
HAND_IDS = ["f32_run_first", "f32", "f32_acc", "f32_acc_f16", "f32_acc_bf16",
            "f32_fresh_f16", "bf16_run_first", "bf16_acc", "bf16_run_after", "x3_run_after",
            "x3_bf16", "x3_acc_bf16", "f16_fresh", "f16_acc_x3"]


@pytest.mark.parametrize("xdt, ydt, form, run, dot", HANDS, ids=HAND_IDS)
def test_dual_hands_presplit_operators(recorded, xdt, ydt, form, run, dot):
    calls, made = recorded
    rng = np.random.default_rng(900 + HANDS.index((xdt, ydt, form, run, dot)))
    A = 2
    ops = [p for _ in range(2) for p in _pair(_unitary(rng))]
    x = torch.empty((A, 128, 128), dtype=xdt, device="meta")
    kw = dict(dot_mode=dot)
    if run is not None:
        kw.update(diag_tables=tuple(torch.zeros(s) for s in [(128, 128)] * 2 + [(A, 128)] * 4),
                  diag_first=run == "first")
    if form == "acc":
        acc = torch.empty((A, 128, 128), dtype=ydt, device="meta")
        kw.update(conj=True, acc=(acc, acc), alias=False)
    elif form == "fresh":
        kw.update(conj=True, alias=False, out_dtype=ydt)
    out = da.dual_apply(x, x, *ops, **kw)
    lib, fn, args = calls[-1]
    assert (lib, fn) == ("dual_apply", "dqc_dual_apply")
    three = _three(xdt, dot, run)
    assert torch.equal(made[args[6]], _tc.tc_operator(*ops[:2], dot, 6 if three else 4))
    assert torch.equal(made[args[7]], _tc.tc_operator(*ops[2:], dot))
    assert args[8] == int(three)
    assert args[4:6] == (st.storage_kind(xdt), st.storage_kind(ydt))
    assert out[0].dtype == ydt
    # has_diag, diag_first, conj, has_acc, x3; A
    assert args[15:21] == (int(run is not None), int(run != "after"), int(form != "inplace"),
                           int(form == "acc"), int(dot == "bf16x3"), A)
    w = da.dual_apply
    assert w.launches == w.mode_launches["tc"] == 1


@pytest.mark.parametrize("x_top", [2, 4])
@pytest.mark.parametrize("fdt, dot", [(F32, "f32"), (BF16, "f32"), (F32, "bf16x3"),
                                      (BF16, "bf16x3")],
                         ids=["f32", "bf16", "x3", "bf16_x3"])
def test_merged_hands_presplit_operator(recorded, x_top, fdt, dot):
    calls, made = recorded
    rng = np.random.default_rng(950 + x_top)
    ops = [*_pair(_unitary(rng)), *_pair(_unitary(rng, x_top))]
    M = 16
    x = torch.empty((1, x_top * 128, M, 128), dtype=fdt, device="meta")
    mfa.merged_fact_apply(x, x, *ops, x_top=x_top, dot_mode=dot)
    lib, fn, args = calls[-1]
    assert (lib, fn) == ("merged_fact_apply", "dqc_merged_fact_apply")
    assert torch.equal(made[args[2]], _tc.tc_operator(*ops[:2], dot))
    assert args[3:5] == (ops[2].data_ptr(), ops[3].data_ptr())
    # A1, Xt, Q, kind, x3
    assert args[5:10] == (1, x_top, M * 128, st.storage_kind(fdt), int(dot == "bf16x3"))
    w = mfa.merged_fact_apply
    assert w.launches == w.mode_launches["tc"] == 1


@pytest.mark.parametrize("n, storage", [(22, "f32"), (23, "bf16")])
def test_models_count_the_tensor_core_applies(recorded, n, storage):
    """The cz ring's value_and_grad at n = 22 (Xt = 2) under f32 storage and
    23 (Xt = 4) under "bf16": every dual and merged-top apply counts
    ``[tc]``, and every merged apply takes the model's Xt."""
    calls, _ = recorded
    config.set_state_storage(storage)
    try:
        model = THEA(n, 2, "cz", device="meta")
        p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        model.magnetization(p, kernels=tk.KERNELS).backward()
    finally:
        config.set_state_storage("f32")
    counts = tk.launch_counts()
    for w in ("dual_apply", "merged_fact_apply"):
        assert counts[w] == counts[f"{w}[tc]"] > 0, counts
    assert counts["dual_apply"] == 2 + 2 and counts["merged_fact_apply"] == 2, counts
    xts = {args[6] for _, fn, args in calls if fn == "dqc_merged_fact_apply"}
    assert xts == {1 << (n - 21)}


# ---------------------------------------------------------------------------
# The products in the kernels' numerics
# ---------------------------------------------------------------------------

def _dual(X, El, Em, D, run, dot, exact_x, prod, dt):
    """[D] Em X El^T [D] on (A, 128, 128) in the kernel's numerics (``prod``,
    T and the run in ``dt``) or in float64: the lane product as El on the
    slab's rows (tiles [l][s]), x exact where it is stored 16-bit and no run
    multiplies it first; the sublane product on T (f32)."""
    split = _split_of(dot)
    X = X.to(dt)
    if run == "first":
        X = (X * D.to(dt)).to(dt)
    Tt = prod(El, X.transpose(1, 2), split, lambda a, b: a @ b, exact_x).to(dt)  # T^T
    Y = prod(Em, Tt.transpose(1, 2), split, lambda a, b: a @ b).to(dt)
    if run == "after":
        Y = (Y * D.to(dt)).to(dt)
    return Y


def _seeded(Y, form, acc):
    """The seed modes on a result: conj for a seed, the accumulator added."""
    if form == "inplace":
        return Y
    Y = Y.conj()
    return Y if acc is None else acc.to(Y.dtype) + Y


def _held_planes(name, dt, got, want, jx, px, tol):
    """A plane pair (complex results ``got`` in the kernel's numerics,
    ``want`` in float64; the JAX kernel's and the plain version's output
    planes decoded, ``jx`` and ``px``) stored as ``dt``: f32 within ``tol``
    of the largest entry, 16-bit within STORE_ULPS storage ulps, and each
    against the JAX kernel within that plus the JAX kernel's own distance."""
    if dt == F32:
        jz = torch.complex(*jx).to(torch.complex128)
        _held(name, got.to(torch.complex128), want, jz, tol)
        _held(f"plain {name}", torch.complex(*px).to(torch.complex128), want, jz, tol)
        return
    w_st = st.store_b(want.to(torch.complex64), dt)
    j_st = [st.store_as(p, dt) for p in jx]
    jax_own = st.ulps_apart(j_st, w_st, dt)
    for who, g_st in (("", st.store_b(got.to(torch.complex64), dt)),
                      ("plain ", [st.store_as(p, dt) for p in px])):
        own = st.ulps_apart(g_st, w_st, dt)
        vs_jax = st.ulps_apart(g_st, j_st, dt)
        assert own <= STORE_ULPS, (who + name, own)
        assert vs_jax <= STORE_ULPS + jax_own, (who + name, vs_jax, jax_own)


# (x storage, y storage, form, run, dot): rows 1 (run first), 1s, 1f (fresh
# f16), 1v (bf16 in place with a run after: El in three parts), 1x (f32
# planes, no run; the bf16 seed), 1h (f16 input into an f16 accumulator:
# three parts)
NUMERICS = [(F32, F32, "inplace", "first", "f32"), (F32, F32, "acc", None, "f32"),
            (F32, F16, "fresh", None, "f32"), (BF16, BF16, "inplace", "after", "f32"),
            (F32, F32, "inplace", None, "bf16x3"), (BF16, BF16, "acc", None, "bf16x3"),
            (F16, F16, "acc", None, "f32")]
NUMERICS_IDS = ["f32_run_first", "f32_acc", "f32_fresh_f16", "bf16_run_after", "x3",
                "x3_bf16_acc", "f16_acc"]


@pytest.mark.parametrize("xdt, ydt, form, run, dot", NUMERICS, ids=NUMERICS_IDS)
def test_dual_apply_against_pallas(xdt, ydt, form, run, dot):
    A = 2
    rng = np.random.default_rng(1000 + NUMERICS.index((xdt, ydt, form, run, dot)))
    Xz = _cnormal(rng, (A, 128, 128))
    El, Em = _unitary(rng), _unitary(rng)
    tables = _tables(rng, A) if run is not None else None
    jx, tx = _to_jax(Xz, xdt)
    ops = [np.ascontiguousarray(p) for z in (El, Em) for p in (z.real, z.imag)]
    tops = [torch.from_numpy(o) for o in ops]
    jkw = dict(dot_mode=dot, interpret=True)
    tkw = dict(dot_mode=dot)
    if run is not None:
        tab = _table_planes(tables)
        jkw.update(diag_tables=tuple(p.numpy() for p in tab), diag_first=run == "first")
        tkw.update(diag_tables=tab, diag_first=run == "first")
    acc = None
    if form != "inplace":
        jkw.update(conj=True, alias=False)
        tkw.update(conj=True, alias=False)
    if form == "acc":
        ja, ta = _to_jax(_cnormal(rng, (A, 128, 128), 0.5), ydt)
        jkw["acc"], tkw["acc"] = tuple(ja), tuple(ta)
        acc = st.load_b(*ta)
    elif form == "fresh":
        import jax.numpy as jnp
        jkw["out_dtype"] = {F16: jnp.uint16, BF16: jnp.bfloat16, F32: jnp.float32}[ydt]
        tkw["out_dtype"] = ydt
    out = jax_dual(*jx, *ops, **jkw)
    jout = [_dec(np.asarray(p)) for p in out]
    plain = da.dual_apply_plain(*tx, *tops, **tkw)
    assert plain[0].dtype == ydt
    X0 = st.load_b(*tx)
    D = _run(tables, torch.complex128) if tables is not None else None
    exact_x = run != "first" and (xdt != F32 if dot == "f32" else xdt == BF16)
    args = (torch.from_numpy(El), torch.from_numpy(Em), D, run, dot, exact_x)
    got = _seeded(_dual(X0, *args, _product, torch.complex64), form, acc)
    want = _seeded(_dual(X0, *args, _exact, torch.complex128), form, acc)
    tol = PLANE_TOL if dot == "f32" else X3_PLANE_TOL
    _held_planes("y", ydt, got, want, jout, [st.f32_of(p) for p in plain], tol)


# (Xt, storage, dot): rows 6 (Xt = 2, 4), 6v (bf16 planes), 6x (f32 and
# bf16 planes)
MERGED = [(2, F32, "f32"), (4, F32, "f32"), (2, BF16, "f32"), (4, F32, "bf16x3"),
          (2, BF16, "bf16x3")]
MERGED_IDS = ["Xt2", "Xt4", "Xt2_bf16", "Xt4_x3", "Xt2_bf16_x3"]


@pytest.mark.parametrize("x_top, fdt, dot", MERGED, ids=MERGED_IDS)
def test_merged_apply_against_pallas(x_top, fdt, dot):
    M = 2
    rng = np.random.default_rng(1100 + MERGED.index((x_top, fdt, dot)))
    view = (1, x_top * 128, M, 128)
    Xz = _cnormal(rng, view)
    El, Et = _unitary(rng), _unitary(rng, x_top)
    jx, tx = _to_jax(Xz, fdt)
    ops = [np.ascontiguousarray(p) for z in (El, Et) for p in (z.real, z.imag)]
    out = jax_merged(*jx, *ops, x_top=x_top, dot_mode=dot, interpret=True)
    jout = [_dec(np.asarray(p)).reshape(x_top, 128, M * 128) for p in out]
    plain = mfa.merged_fact_apply_plain(*tx, *(torch.from_numpy(o) for o in ops),
                                        x_top=x_top, dot_mode=dot)
    assert plain[0].dtype == fdt
    pout = [st.f32_of(p).reshape(x_top, 128, M * 128) for p in plain]
    X0 = st.load_b(*tx).reshape(x_top, 128, M * 128)
    El_t, Et_t = torch.from_numpy(El), torch.from_numpy(Et)

    def numerics(prod, dt):  # the top factor on the load, then El on the tiles
        v = torch.einsum("ab,bdc->adc", Et_t.to(dt), X0.to(dt))
        return prod(El_t, v, _split_of(dot), lambda a, b: a @ b).to(dt)

    got = numerics(_product, torch.complex64)
    want = numerics(_exact, torch.complex128)
    tol = PLANE_TOL if dot == "f32" else X3_PLANE_TOL
    _held_planes("y", fdt, got, want, jout, pout, tol)
