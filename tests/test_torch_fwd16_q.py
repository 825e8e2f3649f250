"""The kernel variants that VQE, QAOA and ``autodiff_run``'s plane tape run
under "bf16" storage and the forward bf16x3, and that the per-term
fallback runs under "f16": their plain versions against the Pallas kernels
in interpret mode, on the CPU.

* ``block_backward_lane`` with F stored bf16 and the uncompute in bf16x3
  (on f32 and on bf16 F), the "auto" transport and gram of the setting;
* a diagonal run's Q reductions (``diag_q``) of ``block_backward_dual``,
  both run orders and both ``g0_first``: where the run is met after the
  dense steps its Pallas kernel takes Q from F and B as stored and reread
  (rounded to bf16 under "bf16"), where it is met first from the decoded
  input;
* the same of ``block_backward_high`` at X = 8, 64 and 128, both run
  orders: its Pallas kernel does not stage, so Q is the product of the f32
  values (after the uncompute and the transport, unrounded, or of the
  decoded input);
* ``diag_backward_planes`` with ``with_q`` on bf16 F;
* ``dual_group_apply_planes`` and ``high_group_apply_planes`` (X = 8 and
  128) on f16 input planes (the JAX package's uint16 bits, float16 with
  the same bits here): a fresh output in the input's storage and a seed
  into an f16 accumulator, in both forward dot modes.

Inputs and tolerances are tests/test_torch_fwd16_kernels.py's (its
docstring states them): bf16 planes within 1 storage ulp (2 where the dual
adjoint stores F or B up to three times, or where bf16x3 products are
rounded to bf16), f32 planes in bf16x3 within ``X3_PLANE_TOL``, pair grams
and Q within half a bf16 ulp of their largest entry on bf16 inputs and
``X3_TOL`` on f32 inputs in bf16x3; f16 planes within 2 f16 ulps (one
encode of two sums of the same products, as tests/test_torch_storage*.py
hold them). ``python tests/test_torch_fwd16_q.py`` prints what each case
measured.
"""

import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dqc_tpu.ops.pallas.block_backward import (block_backward_dual,
                                               block_backward_high,
                                               block_backward_lane)
from dqc_tpu.ops.pallas.diag import diag_backward_planes
from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes
from dqc_tpu.ops.pallas import common as cm
from dqc_tpu import config as jconfig
from dqc_tpu.ops import planes as jpl

from dqc_tpu_torch import config
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl
from dqc_tpu_torch.ops.kernels import _storage as st

from test_torch_fwd16_kernels import (BF, IDS, MEASURED, SETTINGS, _assert_planes,
                                      _assert_rel, _cnormal, _j, _pair, _phases,
                                      _planes, _record, _red_tol, _t, _tables,
                                      _unitary_pair)

F16 = torch.float16
# the settings each Q case runs in: bf16 F with the "auto" bf16x3
# transport, and the uncompute in bf16x3 on f32 F (the third setting, both,
# is held for each kernel by one case)
Q_SETTINGS = [(True, "f32"), (False, "bf16x3")]
Q_IDS = ["bf16", "f32+bf16x3"]


def _x3(fwd16, dm):
    """The backward modes "auto" resolves to in the setting: bf16x3 under
    "bf16" storage, the forward mode otherwise; the pair grams f32 here."""
    return dict(bwd_dot_mode="bf16x3" if fwd16 else dm, gram_dot_mode="f32")


def _tx3(fwd16, dm):
    return dict(bwd_mode="bf16x3" if fwd16 else dm, gram_mode="f32")


def _assert_q(case, got, want, fwd16, dm, staged=False):
    _assert_rel(case + " Q", got, want,
                STAGED_Q_TOL if staged and fwd16 else _red_tol(fwd16, dm == "bf16x3"))


# The dual adjoint's Q of a run met after the dense steps reads F and B
# rounded to bf16 (staged): where the two packages' f32 products of an
# amplitude differ in the last bits, its bf16 value may round the other
# way, one bf16 ulp of that amplitude's product in Q, and Qsl over A = 2
# slabs sums two products per entry. Measured over these cases (``python
# tests/test_torch_fwd16_q.py`` prints it): 3.61e-3 of the largest entry
# (Qsl); the bar is 1.25 times that. On exact operators, where no amplitude
# rounds apart, test_dual_q_reads_staged_planes holds it to EXACT_Q_TOL.
STAGED_Q_TOL = 4.5e-3
EXACT_Q_TOL = 1e-5   # two f32 sums of the same exact products


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
def test_block_backward_lane(fwd16, dm):
    rng = np.random.default_rng(1200 + fwd16 + 2 * (dm == "bf16x3"))
    jf, tf = _planes(rng, (2, 128, 128), fwd16)
    jb, tb = _planes(rng, (2, 128, 128), fwd16, 0.5)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128)]
    want = block_backward_lane(*jf, *jb, *_j(ops), dot_mode=dm, interpret=True,
                               **_x3(fwd16, dm))
    got = tk.block_backward_lane(*tf, *tb, *_t(ops), dot_mode=dm, **_tx3(fwd16, dm))
    x3 = dm == "bf16x3"
    case = f"block_backward_lane {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_rel(case + " T0", got[4:], want[4:], _red_tol(fwd16, x3 or fwd16))


# (first, g0_first, fwd16, dm): both run orders and both g0_first in the
# two Q settings, and bf16 + bf16x3 in one of them. ~15 s a case on the
# CPU, so the bf16x3 ones but the first and the bf16 one with neither the
# staged run nor the first g0 are slow: the kept cases run each route (the
# staged Q on bf16 F both ways, Q on load, the bf16x3 uncompute)
DUAL_Q = [(f, g, fw, dm) for fw, dm in Q_SETTINGS for f in (True, False)
          for g in (True, False)] + [(True, True, True, "bf16x3")]
DUAL_Q_SLOW = [(False, False, True, "f32"), (True, False, False, "bf16x3"),
               (False, True, False, "bf16x3"), (False, False, False, "bf16x3")]


@pytest.mark.parametrize("first, g0_first, fwd16, dm", [
    pytest.param(*c, marks=[pytest.mark.slow] if c in DUAL_Q_SLOW else [],
                 id=f"run_{'before' if c[0] else 'after'}_g{0 if c[1] else 1}-"
                    f"{'bf16' if c[2] else 'f32'}+{c[3]}") for c in DUAL_Q])
def test_block_backward_dual_q(first, g0_first, fwd16, dm):
    """``first``: the run came before the pair in the forward, so it is met
    after the dense steps (the staged Q)."""
    A = 2
    rng = np.random.default_rng(1300 + 2 * first + g0_first)
    jf, tf = _planes(rng, (A, 128, 128), fwd16)
    jb, tb = _planes(rng, (A, 128, 128), fwd16, 0.5)
    ops = [p for _ in range(4) for p in _unitary_pair(rng, 128)]
    tabs = (_tables(rng, A), _tables(rng, A))
    kw = dict(g0_first=g0_first, diag_first_fwd=first, diag_q=True, dot_mode=dm)
    want = block_backward_dual(*jf, *jb, *_j(ops), diag_inv_tables=tuple(_j(tabs[0])),
                               diag_tables=tuple(_j(tabs[1])), interpret=True,
                               **kw, **_x3(fwd16, dm))
    got = tk.block_backward_dual(*tf, *tb, *_t(ops), diag_inv_tables=_t(tabs[0]),
                                 diag_tables=_t(tabs[1]), **kw, **_tx3(fwd16, dm))
    x3 = dm == "bf16x3"
    case = f"block_backward_dual diag_q {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3, ulps=2.0)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16, ulps=2.0)
    _assert_rel(case + " T0", got[4:8], want[4:8], _red_tol(fwd16, x3 or fwd16))
    _assert_q(case, got[8:], want[8:], fwd16, dm, staged=first)


def _exact_ops(rng, X, k=4):
    """``k`` operators ``I + 2^-10 P`` (P a random permutation): on bf16
    planes both packages' products are exact in f32 (each output sums two
    bf16 values 2^10 apart), so whatever one package rounds to bf16 the
    other rounds to the same value, and the staged Q is compared tightly."""
    out = []
    for _ in range(k):
        m = np.eye(X, dtype=np.float32)
        m[np.arange(X), rng.permutation(X)] += 2.0 ** -10
        out += [m, np.zeros((X, X), np.float32)]
    return out


def _narrow_planes(rng, shape, scale):
    """(JAX planes, port planes) stored bf16, each value of magnitude in
    [scale, 2 scale) with a random sign: a sum of two of them, or one and
    2^-10 times another, is exact in f32."""
    p = [(scale * rng.uniform(1, 2, shape) * rng.choice([-1, 1], shape)).astype(np.float32)
         for _ in range(2)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in p],
            [torch.from_numpy(a).to(BF) for a in p])


def _quarter_tables(rng, A):
    """A run's tables of phases 1, i, -1, -i (exact products)."""
    out = []
    for shape in ((128, 128), (A, 128), (A, 128)):
        z = 1j ** rng.integers(0, 4, shape)
        out += list(_pair(z.astype(np.complex64)))
    return out





@pytest.mark.parametrize("g0_first", [True, False], ids=["g0", "g1"])
def test_dual_q_reads_staged_planes(g0_first):
    """Under "bf16" the dual adjoint's Q of a run met after the dense steps
    is the product of F and B rounded to bf16, as its Pallas kernel stages
    them through its output planes: on exact operators the port matches the
    Pallas kernel to f32 summation, and the same step without that rounding
    (the same values as f32 planes) misses it by far more."""
    A = 2
    rng = np.random.default_rng(1390 + g0_first)
    jf, tf = _narrow_planes(rng, (A, 128, 128), 1.0)
    jb, tb = _narrow_planes(rng, (A, 128, 128), 0.5)
    ops = _exact_ops(rng, 128)
    tabs = (_quarter_tables(rng, A), _quarter_tables(rng, A))
    kw = dict(g0_first=g0_first, diag_first_fwd=True, diag_q=True)
    want = block_backward_dual(*jf, *jb, *_j(ops), diag_inv_tables=tuple(_j(tabs[0])),
                               diag_tables=tuple(_j(tabs[1])), interpret=True,
                               bwd_dot_mode="f32", gram_dot_mode="f32", **kw)
    tkw = dict(diag_inv_tables=_t(tabs[0]), diag_tables=_t(tabs[1]), bwd_mode="f32",
               gram_mode="f32", **kw)
    got = tk.block_backward_dual(*tf, *tb, *_t(ops), **tkw)
    _assert_rel("block_backward_dual staged Q exact ops", got[8:], want[8:], EXACT_Q_TOL)
    unrounded = tk.block_backward_dual(*(p.float() for p in (*tf, *tb)), *_t(ops), **tkw)
    miss = max(float(np.abs(u.numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max())
               for u, w in zip(unrounded[8:], want[8:]))
    _record("block_backward_dual unstaged Q vs Pallas rel", miss)
    assert miss > 10 * EXACT_Q_TOL, miss


def _set_modes(fwd16, dm):
    """Both packages' modes of a setting: the storage (for the "auto"
    backward modes), the forward dot mode; the pair grams f32."""
    for c in (jconfig, config):
        c.set_state_storage("bf16" if fwd16 else "f32")
        c.set_kernel_dot_mode(dm)
        c.set_gram_kernel_dot_mode("f32")


@pytest.fixture
def modes():
    yield _set_modes
    for c in (jconfig, config):
        c.set_state_storage("f32")
        c.set_kernel_dot_mode("f32")
        c.set_gram_kernel_dot_mode("auto")


def _dhigh(planes_j, planes_t, ops, tabs, X, first):
    """Both packages' ``planes.backward_dhigh`` on group 2 of n = 14 +
    log2 X (the smallest state with that group at X), with Q."""
    n = 13 + X.bit_length()
    jops = [o[0] + 1j * o[1] for o in (ops[:2], ops[2:])]
    want = jpl.backward_dhigh(*planes_j, *jops, *tabs, 2, n, diag_first=first,
                              with_q=True, interpret=True)
    got = tpl.backward_dhigh(*planes_t, *jops, *(tuple(t) for t in tabs),
                             2, n, diag_first=first, with_q=True)
    return got, want


def _cplx(z):
    """A complex array as its real and imaginary parts."""
    z = np.asarray(z)
    return [np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)]


def _assert_cplx(case, got, want, tol):
    _assert_rel(case, [torch.from_numpy(p) for g in got for p in _cplx(g.numpy())],
                [p for w in want for p in _cplx(w)], tol)


def _run(rng, A):
    return [t[0] + 1j * t[1] for t in (_phases(rng, (128, 128)),
                                                 _phases(rng, (A, 128)),
                                                 _phases(rng, (A, 128)))]


# (X, first, fwd16, dm): X = 8, 64, 128, both run orders, in the two Q
# settings, and bf16 + bf16x3 at X = 8; half of them slow, each X keeping
# both run orders and both settings between its kept cases
HIGH_Q = [(X, f, fw, dm) for X in (8, 64, 128) for fw, dm in Q_SETTINGS
          for f in (True, False)] + [(8, True, True, "bf16x3")]
HIGH_Q_SLOW = [(8, True, False, "bf16x3"), (8, False, False, "bf16x3"),
               (64, False, True, "f32"), (64, True, False, "bf16x3"),
               (128, False, True, "f32"), (128, True, False, "bf16x3")]


@pytest.mark.parametrize("X, first, fwd16, dm", [
    pytest.param(*c, marks=[pytest.mark.slow] if c in HIGH_Q_SLOW else [],
                 id=f"X{c[0]}-run_{'before' if c[1] else 'after'}-"
                    f"{'bf16' if c[2] else 'f32'}+{c[3]}") for c in HIGH_Q])
def test_block_backward_high_q(X, first, fwd16, dm, modes):
    """Group 2 at X (n = 17, 20, 21) with a run folded in, through both
    packages' ``planes.backward_dhigh`` (the modes of the setting as each
    hands its kernel). ``first``: the run came before the block in the
    forward (met after the dense stage: Q of the uncompute's and the
    transport's f32 results, not rounded to storage)."""
    modes(fwd16, dm)
    rng = np.random.default_rng(1400 + X + first)
    A = X
    jf, tf = _planes(rng, (A, 128, 128), fwd16)
    jb, tb = _planes(rng, (A, 128, 128), fwd16, 0.5)
    ops = [*_unitary_pair(rng, X), *_unitary_pair(rng, X)]
    got, want = _dhigh((*jf, *jb), (*tf, *tb), ops, (_run(rng, A), _run(rng, A)), X,
                       first)
    x3 = dm == "bf16x3"
    case = f"block_backward_high X{X} diag_q {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_cplx(case + " T0", [got[4]], [want[4]], _red_tol(fwd16, x3 or fwd16))
    _assert_cplx(case + " Q", got[5], want[5], _red_tol(fwd16, x3))


def test_high_q_takes_f32_values(modes):
    """The high adjoint's Pallas kernel does not stage: Q of a run met
    after the dense stage is the product of the uncompute's and the
    transport's f32 results. On exact operators and inputs (X = 8, "bf16"
    storage) the port matches it to f32 summation, and Q of those results
    rounded to bf16 (what staging would give) misses it by far more."""
    modes(True, "f32")
    for c in (jconfig, config):
        c.set_bwd_kernel_dot_mode("f32")
    try:
        X, A = 8, 8
        rng = np.random.default_rng(1450)
        jf, tf = _narrow_planes(rng, (A, 128, 128), 1.0)
        jb, tb = _narrow_planes(rng, (A, 128, 128), 0.5)
        ops = _exact_ops(rng, X, 2)
        tabs = [[1j ** rng.integers(0, 4, sh) for sh in ((128, 128), (A, 128), (A, 128))]
                for _ in range(2)]
        got, want = _dhigh((*jf, *jb), (*tf, *tb), ops, tabs, X, True)
    finally:
        for c in (jconfig, config):
            c.set_bwd_kernel_dot_mode("auto")
    _assert_cplx("block_backward_high Q exact ops", got[5], want[5], EXACT_Q_TOL)
    # the dense stage alone on the same values as f32, its results rounded
    v = (1, X, 128, 128)
    dense = tk.block_backward_high(*(p.float().view(v) for p in (*tf, *tb)), *_t(ops))
    F = torch.complex(*(st.quantize(p, BF) for p in dense[:2])).reshape(A, 128, 128)
    B = torch.complex(*(st.quantize(p, BF) for p in dense[2:4])).reshape(A, 128, 128)
    Q = B * F
    miss = max(float(np.abs(u.numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max())
               for u, w in zip((Q.sum(0), Q.sum(2), Q.sum(1)), want[5]))
    _record("block_backward_high staged Q vs Pallas rel", miss)
    assert miss > 10 * EXACT_Q_TOL, miss


@pytest.mark.parametrize("bstore", ["bf16", "f16"])
def test_diag_backward_q_bf16(bstore):
    """F stored bf16, B bf16 ("bf16" storage) or f16 bits: Q from the
    decoded planes before the update."""
    A = 2
    rng = np.random.default_rng(1500 + (bstore == "f16"))
    jf, tf = _planes(rng, (A, 128, 128), True)
    b = _pair(_cnormal(rng, (A, 128, 128), 0.5))
    if bstore == "bf16":
        jb, tb = [jnp.asarray(p).astype(jnp.bfloat16) for p in b], [torch.from_numpy(p).to(BF) for p in b]
    else:
        jb = [cm.store_as(jnp.asarray(p), jnp.uint16) for p in b]
        tb = [torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(F16) for x in jb]
    tabs = (_tables(rng, A), _tables(rng, A))
    want = diag_backward_planes(*jf, *jb, *_j(tabs[0]), *_j(tabs[1]), with_q=True,
                                interpret=True)
    got = tk.diag_backward(*tf, *tb, *_t(tabs[0]), *_t(tabs[1]), with_q=True)
    case = f"diag_backward with_q bf16 F, {bstore} B"
    _assert_planes(case + " F", got[:2], want[:2], False)
    if bstore == "bf16":
        _assert_planes(case + " B", got[2:4], want[2:4], False)
    else:
        _assert_f16(case + " B", got[2:4], want[2:4])
    _assert_q(case, got[4:], want[4:], True, "f32")


def _f16_planes(rng, shape, scale=1.0):
    """f16 planes: the JAX package's uint16 bits (its codec) and float16
    with the same bits here."""
    j = [cm.store_as(jnp.asarray(p), jnp.uint16) for p in _pair(_cnormal(rng, shape, scale))]
    return j, [torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(F16) for x in j]


def _assert_f16(case, got, want):
    assert got[0].dtype == got[1].dtype == F16
    w = [torch.from_numpy(np.array(cm.f32_of(x))) for x in want]
    n = st.ulps_apart(got, w, F16)
    _record(case + " f16 ulps", n)
    assert n <= 2.0, f"{case}: {n:.2f} f16 ulps"


# the f16 input forms: each kernel and X in both forms, each form in both
# dot modes among the kept cases; the rest slow
F16_KEPT = [("dual", "fresh", "f32"), ("dual", "acc", "bf16x3"),
            ("high_X8", "acc", "f32"), ("high_X8", "fresh", "bf16x3"),
            ("high_X128", "fresh", "f32"), ("high_X128", "acc", "bf16x3")]


@pytest.mark.parametrize("kernel, mode, dm", [
    pytest.param(k, m, d, marks=[] if (k, m, d) in F16_KEPT else [pytest.mark.slow],
                 id=f"{k}-{m}-{d}")
    for k in ("dual", "high_X8", "high_X128") for m in ("fresh", "acc")
    for d in ("f32", "bf16x3")])
def test_f16_input(kernel, mode, dm):
    """The per-term fallback's two sweeps on an "f16" cotangent: a fresh
    temporary in the input's storage (``alias=False``), then a seed into the
    f16 accumulator (``conj`` as the density seed's)."""
    rng = np.random.default_rng(1600 + 2 * (mode == "acc") + (dm == "bf16x3"))
    X = 128 if kernel == "dual" else int(kernel.split("X")[1])
    shape = (2, 128, 128) if kernel == "dual" else (1, X, 1024 // X * 8, 128)
    jx, tx = _f16_planes(rng, shape)
    if kernel == "dual":
        ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128)]
        jfn, tfn = dual_group_apply_planes, tk.dual_apply
    else:
        ops = list(_unitary_pair(rng, X))
        jfn, tfn = high_group_apply_planes, tk.high_apply
    jkw, tkw = dict(alias=False), dict(alias=False)
    if mode == "acc":
        ja, ta = _f16_planes(rng, shape, 0.5)
        jkw.update(conj=True, acc=tuple(ja))
        tkw.update(conj=True, acc=tuple(ta))
    want = jfn(*jx, *_j(ops), dot_mode=dm, interpret=True, **jkw)
    got = tfn(*tx, *_t(ops), dot_mode=dm, **tkw)
    _assert_f16(f"{kernel} f16 {mode} {dm}", got, want)


def test_f16_refused_where_no_path_hands_it():
    """The Grams, the merged-top apply and the diagonal sweep still refuse
    f16 input planes (ROADMAP.md queue B item 1: no path hands them a
    cotangent), on the CPU as on the card."""
    h = tuple(torch.zeros((1, 128, 128), dtype=F16) for _ in range(2))
    m = tuple(torch.zeros((1, 256, 8, 128), dtype=F16) for _ in range(2))
    e = torch.zeros((128, 128))
    tabs = (e, e, e[:1], e[:1], e[:1], e[:1])
    calls = (lambda: tk.gram(*h),
             lambda: tk.merged_fact_apply(*m, e, e, e[:2, :2], e[:2, :2], x_top=2),
             lambda: tk.diag_sweep(*h, *tabs))
    for call in calls:
        with pytest.raises(NotImplementedError, match="queue B item 1"):
            call()


if __name__ == "__main__":
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"] + sys.argv[1:])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_kernels") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        if "diag_q" in k or "lane" in k or "f16" in k or "with_q" in k:
            print(f"{k}: {v:.3e}")
    sys.exit(code)
