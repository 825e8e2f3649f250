""""bf16" forward storage and the forward bf16x3 at the kernel level: the
plain versions of the nine kernels of the cz path against their Pallas
kernels in interpret mode, on the CPU.

* ``dual_group_apply_planes``: in place on bf16 planes (with a diagonal
  run before and after), the seed from bf16 planes into bf16 cotangent
  planes (fresh and accumulated), and the same calls in bf16x3, on f32
  planes too (seeds into each cotangent storage);
* ``high_group_apply_planes`` at X = 128 in place and as seeds, and its
  seeds at X = 256 / 512 (the merged top, a small M);
* ``merged_fact_apply_planes`` at Xt = 2, 4;
* ``gram_lane`` / ``gram_sublane`` / ``gram_high`` at X = 128 and on the
  merged axis (X = 256 / 512);
* ``diag_sweep_planes`` and ``diag_backward_planes`` on bf16 forward
  planes;
* (tests/test_torch_fwd16_adjoints.py, with this module's helpers)
  ``block_backward_dual``, ``block_backward_high`` (X = 128) and
  ``block_backward_merged_fact`` with bf16 forward planes (and bf16
  cotangent planes, as "bf16" storage stores both) and a bf16x3
  uncompute.

Inputs are made with numpy from a seed, stored as bf16 by both packages'
own downcast (round to nearest even) and handed to both. Tolerances:

* bf16 planes within 1 storage ulp (``_storage.ulps_apart``: at the larger
  of the amplitude's modulus and the planes' rms) in f32 dots, and within
  2 where the kernel stores F or B up to three times (the dual adjoint,
  which stages both through its planes as its Pallas kernel does; B is
  held so in tests/test_torch_storage_codec.py) or where bf16x3 products
  are rounded to bf16 (two orders of the same three exact products);
* f32 planes, Grams, pair grams and Q reductions in f32 dots within half
  a bf16 ulp (2^-9) of their largest entry on bf16 inputs (f32 planes in
  f32 dots: 2e-5, as tests/test_torch_backward.py);
* on f32 planes in bf16x3, f32 planes within ``X3_PLANE_TOL`` abs
  (unit-variance planes through unitary operators) and reductions within
  ``X3_TOL`` of their largest entry: the JAX kernels split Karatsuba
  operands (``br + bi``, ...) where the port splits the real and imaginary
  parts, so the two sum different exact products. Measured (``python
  tests/test_torch_fwd16_kernels.py`` prints every case): planes up to
  4.92e-5 (the dual adjoint's F; the applies 3.9e-5-4.7e-5), reductions
  up to 6.9e-6; the bars are 1e-4 and 4e-5, the latter the
  reduced-storage tests' bar for their bf16x3 grams.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dqc_tpu.ops.pallas.diag import diag_backward_planes, diag_sweep_planes
from dqc_tpu.ops.pallas.dual_apply import dual_group_apply_planes
from dqc_tpu.ops.pallas.gram import gram_high, gram_lane, gram_sublane
from dqc_tpu.ops.pallas.high_apply import (high_group_apply_planes,
                                           merged_fact_apply_planes)
from dqc_tpu.ops.pallas import common as cm

from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st

torch.set_num_threads(2)

BF = torch.bfloat16
HALF_ULP = 2.0 ** -9      # half a bf16 ulp, relative to the largest entry
F32_TOL = 2e-5
X3_TOL = 4e-5
X3_PLANE_TOL = 1e-4
MEASURED = {}             # what each case measured, printed by __main__


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _pair(c):
    return (np.ascontiguousarray(c.real, dtype=np.float32),
            np.ascontiguousarray(c.imag, dtype=np.float32))


def _unitary_pair(rng, X):
    q, _ = np.linalg.qr(_cnormal(rng, (X, X)))
    return _pair(q.astype(np.complex64))


def _phases(rng, shape):
    return _pair(np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64))


def _tables(rng, A):
    return [p for s in ((128, 128), (A, 128), (A, 128)) for p in _phases(rng, s)]


def _planes(rng, shape, fwd16, scale=1.0):
    """(JAX planes, port planes): f32, or stored bf16 by each package."""
    p = _pair(_cnormal(rng, shape, scale))
    if not fwd16:
        return [jnp.asarray(a) for a in p], [torch.from_numpy(a.copy()) for a in p]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in p],
            [torch.from_numpy(a).to(BF) for a in p])


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _dec(x):
    return torch.from_numpy(np.asarray(cm.f32_of(x)))


def _record(case, value):
    MEASURED[case] = max(MEASURED.get(case, 0.0), value)


def _assert_planes(case, got, want, x3: bool, ulps: float = 1.0):
    """A plane pair: bf16 within ``ulps`` storage ulps (2 in bf16x3), f32
    within F32_TOL (X3_TOL in bf16x3) abs."""
    if got[0].dtype == BF:
        assert str(want[0].dtype) == "bfloat16"
        n = st.ulps_apart(got, [_dec(w) for w in want], BF)
        _record(case + " ulps", n)
        assert n <= (max(ulps, 2.0) if x3 else ulps), f"{case}: {n:.2f} bf16 ulps"
        return
    err = max(float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got, want))
    _record(case + " abs", err)
    assert err <= (X3_PLANE_TOL if x3 else F32_TOL), f"{case}: {err:.3e}"


def _assert_rel(case, got, want, tol):
    """Reductions within ``tol`` of their largest entry."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        _record(case + " rel", err)
        assert err <= tol, f"{case}: {err:.3e} of the largest entry"


def _red_tol(fwd16, x3):
    """On bf16 inputs half a bf16 ulp whatever the dot mode; on f32 inputs
    the bf16x3 bar or 1e-5."""
    return HALF_ULP if fwd16 else (X3_TOL if x3 else 1e-5)


SETTINGS = [(True, "f32"), (True, "bf16x3"), (False, "bf16x3")]
IDS = ["bf16", "bf16+bf16x3", "f32+bf16x3"]


# ---------------------------------------------------------------------------
# The applies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("diag", [None, True, False], ids=["plain", "run_first", "run_after"])
def test_dual_apply_in_place(diag, fwd16, dm):
    A = 4
    rng = np.random.default_rng(100 + (diag is None) + 2 * bool(diag))
    jx, tx = _planes(rng, (A, 128, 128), fwd16)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128)]
    kw, tkw = {}, {}
    if diag is not None:
        tabs = _tables(rng, A)
        kw = dict(diag_tables=tuple(_j(tabs)), diag_first=diag)
        tkw = dict(diag_tables=_t(tabs), diag_first=diag)
    want = dual_group_apply_planes(*jx, *_j(ops), dot_mode=dm, interpret=True, **kw)
    got = tk.dual_apply(*tx, *_t(ops), dot_mode=dm, **tkw)
    _assert_planes(f"dual_apply {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm, out", [
    (True, "f32", "bf16"), (True, "bf16x3", "bf16"), (False, "bf16x3", "f32"),
    (False, "bf16x3", "bf16"), (False, "bf16x3", "f16")], ids=str)
@pytest.mark.parametrize("kernel, shape, acc", [
    ("dual", (2, 128, 128), False), ("dual", (2, 128, 128), True),
    ("high", (1, 128, 8, 128), False), ("high", (1, 128, 8, 128), True),
    ("high", (1, 256, 8, 128), False), ("high", (1, 512, 8, 128), False)], ids=str)
def test_seeds(kernel, shape, acc, fwd16, dm, out):
    """``[acc +] conj(E x)`` from the forward planes into the cotangent
    planes of a storage: fresh, or accumulated (the merged top's seed at
    X = 256 / 512 is always the first, fresh one)."""
    rng = np.random.default_rng(200 + shape[1] + acc)
    X = shape[1]
    jx, tx = _planes(rng, shape, fwd16, 0.05)
    n_ops = 2 if kernel == "dual" else 1
    ops = [p for _ in range(n_ops) for p in _unitary_pair(rng, X)]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.uint16}[out]
    tdt = {"f32": torch.float32, "bf16": BF, "f16": torch.float16}[out]
    jacc = tacc = None
    if acc:
        a = _pair(_cnormal(rng, shape, 0.05))
        jacc = tuple(cm.store_as(jnp.asarray(p), jdt) for p in a)
        tacc = tuple(st.store_as(torch.from_numpy(p), tdt) for p in a)
    jfn = dual_group_apply_planes if kernel == "dual" else high_group_apply_planes
    tfn = tk.dual_apply if kernel == "dual" else tk.high_apply
    want = jfn(*jx, *_j(ops), alias=False, conj=True, acc=jacc,
               out_dtype=None if acc else jdt, dot_mode=dm, interpret=True)
    got = tfn(*tx, *_t(ops), alias=False, conj=True, acc=tacc,
              out_dtype=None if acc else tdt, dot_mode=dm)
    assert got[0].dtype == tdt
    case = f"seed {kernel} X{X} {dm} {fwd16}->{out}"
    if out == "f16":
        n = st.ulps_apart(got, [_dec(w) for w in want], torch.float16)
        _record(case + " ulps", n)
        assert n <= 2.0, n
    else:
        _assert_planes(case, got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("diag", [None, True, False], ids=["plain", "run_first", "run_after"])
def test_high_apply_x128_in_place(diag, fwd16, dm):
    """Group 2 of n = 21 (view (1, 128, 128, 128)), with a folded run."""
    rng = np.random.default_rng(300 + (diag is None) + 2 * bool(diag))
    shape = (1, 128, 128, 128)
    jx, tx = _planes(rng, shape, fwd16)
    E = _unitary_pair(rng, 128)
    jkw, tkw = {}, {}
    if diag is not None:
        from dqc_tpu.ops import planes as jpl
        from dqc_tpu_torch.ops import planes as tpl
        tabs = [t[0] + 1j * t[1] for t in (_phases(rng, (128, 128)), _phases(rng, (128, 128)),
                                           _phases(rng, (128, 128)))]
        jkw = dict(diag=jpl.dhigh_view_tables(tabs, 2, 21), diag_first=diag)
        tkw = dict(diag_tables=tpl.dhigh_view_tables(tabs, 2, 21, "cpu"), diag_first=diag)
    want = high_group_apply_planes(*jx, *_j(E), dot_mode=dm, interpret=True, **jkw)
    got = tk.high_apply(*tx, *_t(E), dot_mode=dm, **tkw)
    _assert_planes(f"high_apply X128 {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("shape, x_top", [((1, 256, 16, 128), 2), ((1, 512, 8, 128), 4)],
                         ids=["Xt2", "Xt4"])
def test_merged_fact_apply(shape, x_top, fwd16, dm):
    rng = np.random.default_rng(400 + x_top)
    jx, tx = _planes(rng, shape, fwd16)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, x_top)]
    want = merged_fact_apply_planes(*jx, *_j(ops), x_top=x_top, dot_mode=dm,
                                    interpret=True)
    got = tk.merged_fact_apply(*tx, *_t(ops), x_top=x_top, dot_mode=dm)
    _assert_planes(f"merged_fact_apply Xt{x_top} {dm} {fwd16}", got, want,
                   dm == "bf16x3")


# ---------------------------------------------------------------------------
# The Grams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("kind", ["lane", "sublane", "high128", "merged256", "merged512"])
def test_gram(kind, fwd16, dm):
    rng = np.random.default_rng(500 + len(kind))
    shape = {"lane": (4, 128, 128), "sublane": (4, 128, 128),
             "high128": (1, 128, 4, 128), "merged256": (1, 256, 8, 128),
             "merged512": (1, 512, 8, 128)}[kind]
    jx, tx = _planes(rng, shape, fwd16, 2 ** -8)
    if kind == "lane":
        want = gram_lane(*jx, dot_mode=dm, interpret=True)
        got = tk.gram(*(t.reshape(-1, 128, 1) for t in tx), dot_mode=dm)
    elif kind == "sublane":
        want = gram_sublane(*jx, dot_mode=dm, interpret=True)
        got = tk.gram(*tx, dot_mode=dm)
    else:
        want = gram_high(*jx, dot_mode=dm, interpret=True)
        got = tk.gram(*(t.reshape(1, shape[1], -1) for t in tx), dot_mode=dm)
    _assert_rel(f"gram {kind} {dm} {fwd16}", got, want,
                _red_tol(fwd16, dm == "bf16x3"))


# ---------------------------------------------------------------------------
# The diagonal runs
# ---------------------------------------------------------------------------

def test_diag_sweep_bf16():
    A = 4
    rng = np.random.default_rng(600)
    jx, tx = _planes(rng, (A, 128, 128), True)
    tabs = _tables(rng, A)
    want = diag_sweep_planes(*jx, *_j(tabs), interpret=True)
    got = tk.diag_sweep(*tx, *_t(tabs))
    _assert_planes("diag_sweep", got, want, False)


@pytest.mark.parametrize("bstore", ["bf16", "f32"])
def test_diag_backward_bf16_forward(bstore):
    A = 4
    rng = np.random.default_rng(610)
    jf, tf = _planes(rng, (A, 128, 128), True)
    jb, tb = _planes(rng, (A, 128, 128), bstore == "bf16", 0.5)
    tabs = _tables(rng, A) + _tables(rng, A)
    want = diag_backward_planes(*jf, *jb, *_j(tabs), interpret=True)
    got = tk.diag_backward(*tf, *tb, *_t(tabs))
    _assert_planes("diag_backward F", got[:2], want[:2], False)
    _assert_planes("diag_backward B", got[2:4], want[2:4], False)


def test_modes_counted():
    """The wrappers count the new variants (the plain versions on the CPU
    do not launch; the counts are the card's): a seed from bf16 planes is
    a seed into bf16 planes, and the checks of the card path hold on the
    CPU too (the lane adjoint on bf16 forward planes and the X = 64 high
    apply run; an f16 seed from bf16 planes is refused)."""
    x = torch.zeros((1, 128, 128), dtype=BF)
    e = torch.zeros((128, 128))
    out = tk.block_backward_lane(x, x.clone(), x.clone(), x.clone(), e, e, e, e)
    assert [p.dtype for p in out] == [BF] * 4 + [torch.float32] * 2
    x64 = torch.zeros((1, 64, 128, 128), dtype=BF)
    assert tk.high_apply(x64, x64.clone(), e[:64, :64], e[:64, :64])[0].dtype == BF
    with pytest.raises(TypeError):
        tk.dual_apply(*(torch.zeros((1, 128, 128), dtype=BF),) * 2,
                      *(torch.zeros((128, 128)),) * 4, alias=False,
                      out_dtype=torch.float16)


if __name__ == "__main__":
    import sys
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_kernels") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
