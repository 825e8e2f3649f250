""""bf16" storage and the forward bf16x3 on the narrow high groups: the
plain versions of ``high_group_apply_planes``, ``gram_high`` and
``block_backward_high`` at X = 8, 16, 32 and 64 against the Pallas kernels
in interpret mode, on the CPU.

These are the shapes of group 2 at n = 17-20, of group 3 at n = 24-27 and
of the CNOT ring's X = 8 span views, on views of 2^17 amplitudes (a
diagonal run folded in at X = 8, where M = 128): the apply in place and as
seeds (accumulated and fresh), the Gram, and the adjoint with the "auto"
transport of the setting. Settings, inputs and tolerances are
tests/test_torch_fwd16_kernels.py's (its docstring states them): bf16
planes within 1 storage ulp (2 in bf16x3), f32 planes in bf16x3 within
``X3_PLANE_TOL``, reductions within half a bf16 ulp of their largest entry
on bf16 inputs and ``X3_TOL`` on f32 inputs in bf16x3. ``python
tests/test_torch_fwd16_small_x.py`` prints what each case measured.
"""

import sys

import numpy as np
import pytest

from dqc_tpu.ops.pallas.block_backward import block_backward_high
from dqc_tpu.ops.pallas.gram import gram_high
from dqc_tpu.ops.pallas.high_apply import high_group_apply_planes
from dqc_tpu.ops.pallas import common as cm
import jax.numpy as jnp
import torch

from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st

from test_torch_fwd16_kernels import (BF, IDS, MEASURED, SETTINGS, _assert_planes,
                                      _assert_rel, _cnormal, _j, _pair, _phases,
                                      _planes, _red_tol, _t, _unitary_pair)

AMPS = 1 << 17
XS = [8, 16, 32, 64]


def _shape(X):
    return (1, X, AMPS // (X * 128), 128)


def _run_tables(rng, X, n_sets):
    """``n_sets`` diagonal runs on the view of ``_shape(X)`` (M = 128): the
    JAX package's view tables and the port's, from the same phases (the
    planes' group 2 of a 17-qubit state at X = 8)."""
    from dqc_tpu.ops import planes as jpl
    from dqc_tpu_torch.ops import planes as tpl
    n = 14 + X.bit_length() - 1
    out = []
    for _ in range(n_sets):
        tabs = [t[0] + 1j * t[1] for t in (_phases(rng, (128, 128)),
                                           _phases(rng, (AMPS // (128 * 128), 128)),
                                           _phases(rng, (AMPS // (128 * 128), 128)))]
        out.append((jpl.dhigh_view_tables(tabs, 2, n), tpl.dhigh_view_tables(tabs, 2, n, "cpu")))
    return out


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("X", XS)
def test_high_apply_in_place(X, fwd16, dm):
    rng = np.random.default_rng(1100 + X)
    jx, tx = _planes(rng, _shape(X), fwd16)
    E = _unitary_pair(rng, X)
    want = high_group_apply_planes(*jx, *_j(E), dot_mode=dm, interpret=True)
    got = tk.high_apply(*tx, *_t(E), dot_mode=dm)
    _assert_planes(f"high_apply X{X} {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("first", [True, False], ids=["run_first", "run_after"])
def test_high_apply_x8_with_run(first, fwd16, dm):
    rng = np.random.default_rng(1150 + first)
    jx, tx = _planes(rng, _shape(8), fwd16)
    E = _unitary_pair(rng, 8)
    (jt, tt), = _run_tables(rng, 8, 1)
    want = high_group_apply_planes(*jx, *_j(E), diag=jt, diag_first=first,
                                   dot_mode=dm, interpret=True)
    got = tk.high_apply(*tx, *_t(E), tt, first, dot_mode=dm)
    _assert_planes(f"high_apply X8 run {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm, out", [
    (True, "f32", "bf16"), (True, "bf16x3", "bf16"), (False, "bf16x3", "f32"),
    (False, "bf16x3", "f16")], ids=str)
@pytest.mark.parametrize("X, acc", [(8, True), (8, False), (64, True), (16, False)],
                         ids=str)
def test_high_apply_seeds(X, acc, fwd16, dm, out):
    """``[acc +] conj(E x)`` from the forward planes into the cotangent
    planes (the seeds of a group-2 / group-3 density and of the X = 8 span
    densities)."""
    rng = np.random.default_rng(1200 + X + acc)
    shape = _shape(X)
    jx, tx = _planes(rng, shape, fwd16, 0.05)
    E = _unitary_pair(rng, X)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.uint16}[out]
    tdt = {"f32": torch.float32, "bf16": BF, "f16": torch.float16}[out]
    jacc = tacc = None
    if acc:
        a = _pair(_cnormal(rng, shape, 0.05))
        jacc = tuple(cm.store_as(jnp.asarray(p), jdt) for p in a)
        tacc = tuple(st.store_as(torch.from_numpy(p), tdt) for p in a)
    want = high_group_apply_planes(*jx, *_j(E), alias=False, conj=True, acc=jacc,
                                   out_dtype=None if acc else jdt, dot_mode=dm,
                                   interpret=True)
    got = tk.high_apply(*tx, *_t(E), alias=False, conj=True, acc=tacc,
                        out_dtype=None if acc else tdt, dot_mode=dm)
    assert got[0].dtype == tdt
    case = f"seed X{X} {dm} {fwd16}->{out}"
    if out == "f16":
        n = st.ulps_apart(got, [torch.from_numpy(np.asarray(cm.f32_of(w))) for w in want],
                          torch.float16)
        MEASURED[case + " ulps"] = max(MEASURED.get(case + " ulps", 0.0), n)
        assert n <= 2.0, n
    else:
        _assert_planes(case, got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("X", XS)
def test_gram_high(X, fwd16, dm):
    rng = np.random.default_rng(1300 + X)
    shape = _shape(X)
    jx, tx = _planes(rng, shape, fwd16, 2 ** -8)
    want = gram_high(*jx, dot_mode=dm, interpret=True)
    got = tk.gram(*(t.reshape(1, X, -1) for t in tx), dot_mode=dm)
    _assert_rel(f"gram X{X} {dm} {fwd16}", got, want, _red_tol(fwd16, dm == "bf16x3"))


def _adjoint(X, fwd16, dm, rng, runs=None):
    shape = _shape(X)
    jf, tf = _planes(rng, shape, fwd16)
    jb, tb = _planes(rng, shape, fwd16, 0.5)
    ops = [*_unitary_pair(rng, X), *_unitary_pair(rng, X)]
    jkw, tkw = {}, {}
    if runs is not None:
        first, ((ji, ti), (jd, td)) = runs
        jkw = dict(diag_inv_tables=ji, diag_tables=jd, diag_first_fwd=first)
        tkw = dict(diag_inv_tables=ti, diag_tables=td, diag_first_fwd=first)
    bm = "bf16x3" if fwd16 else dm   # the "auto" transport of the setting
    want = block_backward_high(*jf, *jb, *_j(ops), dot_mode=dm, bwd_dot_mode=bm,
                               gram_dot_mode="f32", interpret=True, **jkw)
    got = tk.block_backward_high(*tf, *tb, *_t(ops), dot_mode=dm, bwd_mode=bm,
                                 gram_mode="f32", **tkw)
    x3 = dm == "bf16x3"
    case = f"block_backward_high X{X} {dm} {fwd16}" + ("" if runs is None else " run")
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_rel(case + " T0", got[4:6], want[4:6], _red_tol(fwd16, x3 or fwd16))


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("X", XS)
def test_block_backward_high(X, fwd16, dm):
    _adjoint(X, fwd16, dm, np.random.default_rng(1400 + X))


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("first", [True, False], ids=["run_first", "run_after"])
def test_block_backward_high_x8_with_run(first, fwd16, dm):
    rng = np.random.default_rng(1450 + first)
    _adjoint(8, fwd16, dm, rng, (first, _run_tables(rng, 8, 2)))


if __name__ == "__main__":
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_kernels") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
