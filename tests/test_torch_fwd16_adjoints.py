"""The adjoints of the cz path on bf16 forward planes and with a bf16x3
uncompute, their plain versions against the Pallas kernels in interpret
mode: ``block_backward_dual`` (with a diagonal run both ways),
``block_backward_high`` at X = 128 and ``block_backward_merged_fact`` at
Xt = 2, 4, with F and B stored bf16 ("bf16" storage) or f32 (the forward
bf16x3 on f32 planes). Inputs, settings and tolerances are
tests/test_torch_fwd16_kernels.py's (its docstring states them); this file
holds the adjoints so that each file stays near two minutes on one core.
"""

import numpy as np
import pytest

from dqc_tpu.ops.pallas.block_backward import (block_backward_dual,
                                               block_backward_high,
                                               block_backward_merged_fact)

from dqc_tpu_torch.ops import kernels as tk

from test_torch_fwd16_kernels import (IDS, SETTINGS, _assert_planes,
                                      _assert_rel, _j, _phases, _planes,
                                      _red_tol, _t, _tables, _unitary_pair)


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("diag, g0_first", [
    (None, True), (None, False), ("before", True), ("after", False),
    ("after", True)], ids=str)
def test_block_backward_dual(diag, g0_first, fwd16, dm):
    A = 4
    rng = np.random.default_rng(700 + 2 * g0_first + (diag == "after"))
    jf, tf = _planes(rng, (A, 128, 128), fwd16)
    jb, tb = _planes(rng, (A, 128, 128), fwd16, 0.5)
    ops = [p for _ in range(4) for p in _unitary_pair(rng, 128)]
    kw = dict(g0_first=g0_first)
    jkw, tkw = {}, {}
    if diag:
        tabs = (_tables(rng, A), _tables(rng, A))
        jkw = dict(diag_inv_tables=tuple(_j(tabs[0])), diag_tables=tuple(_j(tabs[1])))
        tkw = dict(diag_inv_tables=_t(tabs[0]), diag_tables=_t(tabs[1]))
        kw["diag_first_fwd"] = diag == "before"
    bm = "bf16x3" if fwd16 else dm   # the "auto" transport of the setting
    want = block_backward_dual(*jf, *jb, *_j(ops), dot_mode=dm, bwd_dot_mode=bm,
                               gram_dot_mode="f32", interpret=True, **kw, **jkw)
    got = tk.block_backward_dual(*tf, *tb, *_t(ops), dot_mode=dm, bwd_mode=bm,
                                 gram_mode="f32", **kw, **tkw)
    x3 = dm == "bf16x3"
    case = f"block_backward_dual {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3, ulps=2.0)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16, ulps=2.0)
    _assert_rel(case + " T0", got[4:], want[4:], _red_tol(fwd16, x3 or fwd16))


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("diag", [None, True, False], ids=["plain", "run_first", "run_after"])
def test_block_backward_high_x128(diag, fwd16, dm):
    rng = np.random.default_rng(800 + (diag is None) + 2 * bool(diag))
    shape = (1, 128, 128, 128)
    jf, tf = _planes(rng, shape, fwd16)
    jb, tb = _planes(rng, shape, fwd16, 0.5)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128)]
    jkw, tkw = {}, {}
    if diag is not None:
        from dqc_tpu.ops import planes as jpl
        from dqc_tpu_torch.ops import planes as tpl
        tabs = [[t[0] + 1j * t[1] for t in (_phases(rng, (128, 128)),) * 3]
                for _ in range(2)]
        jkw = dict(diag_inv_tables=jpl.dhigh_view_tables(tabs[0], 2, 21),
                   diag_tables=jpl.dhigh_view_tables(tabs[1], 2, 21),
                   diag_first_fwd=diag)
        tkw = dict(diag_inv_tables=tpl.dhigh_view_tables(tabs[0], 2, 21, "cpu"),
                   diag_tables=tpl.dhigh_view_tables(tabs[1], 2, 21, "cpu"),
                   diag_first_fwd=diag)
    bm = "bf16x3" if fwd16 else dm
    want = block_backward_high(*jf, *jb, *_j(ops), dot_mode=dm, bwd_dot_mode=bm,
                               gram_dot_mode="f32", interpret=True, **jkw)
    got = tk.block_backward_high(*tf, *tb, *_t(ops), dot_mode=dm, bwd_mode=bm,
                                 gram_mode="f32", **tkw)
    x3 = dm == "bf16x3"
    case = f"block_backward_high {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_rel(case + " T0", got[4:6], want[4:6], _red_tol(fwd16, x3 or fwd16))


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("shape, x_top", [((1, 256, 16, 128), 2), ((1, 512, 8, 128), 4)],
                         ids=["Xt2", "Xt4"])
def test_block_backward_merged_fact(shape, x_top, fwd16, dm):
    """The modes ops/planes hands the kernel: the transport f32 whatever
    the backward mode resolves to, the pair grams f32 here."""
    rng = np.random.default_rng(900 + x_top)
    jf, tf = _planes(rng, shape, fwd16)
    jb, tb = _planes(rng, shape, fwd16, 0.5)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128),
           *_unitary_pair(rng, x_top), *_unitary_pair(rng, x_top)]
    want = block_backward_merged_fact(*jf, *jb, *_j(ops), x_top=x_top, dot_mode=dm,
                                      bwd_dot_mode="f32", gram_dot_mode="f32",
                                      interpret=True)
    got = tk.block_backward_merged_fact(*tf, *tb, *_t(ops), x_top=x_top,
                                        dot_mode=dm, bwd_mode="f32", gram_mode="f32")
    x3 = dm == "bf16x3"
    case = f"block_backward_merged_fact Xt{x_top} {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], False)
    _assert_rel(case + " T0_top", got[4:6], want[4:6], _red_tol(fwd16, False))
    _assert_rel(case + " T0_low", got[6:8], want[6:8], _red_tol(fwd16, x3))
