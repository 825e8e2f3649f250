""""bf16" storage and the forward bf16x3 on the CNOT ring's kernels and the
expanded merged top: plain versions against the Pallas kernels in
interpret mode, on the CPU.

* ``dual_multi_apply_planes`` (the (6, 7) edge's CNOT, T = 2, and a random
  2-qubit unitary, T = 4) and ``high_multi_apply_planes`` (the closing
  edge's X = 8 span view at n = 15, T = 4 lane slices): in place on bf16
  forward planes (the uncompute) and on f32 planes in bf16x3, and as seeds
  from bf16 forward planes into bf16 cotangent planes (accumulated and
  fresh) and from f32 planes in bf16x3 into each cotangent storage;
* ``block_backward_sublane``: F and B stored bf16 with the "auto"
  transport of "bf16", and the bf16x3 uncompute on f32 and bf16 planes;
* ``high_group_apply_planes`` in place and ``block_backward_high`` on the
  merged top axis, X = 256 / 512 (the smallest view that tiles, M = 8): the
  in-place apply on bf16 planes and in bf16x3, the adjoint with F and B
  bf16 and with the bf16x3 uncompute. The port's kernel forms this
  adjoint's pair gram as ``(B F^T) Einv^T``, the Pallas kernel as ``B
  (Einv F)^T``; its plain version as the Pallas kernel.

Settings, inputs and tolerances are tests/test_torch_fwd16_kernels.py's
(its docstring states them). ``python tests/test_torch_fwd16_cross.py``
prints what each case measured.
"""

import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dqc_tpu.ops.pallas.block_backward import (block_backward_high,
                                               block_backward_sublane)
from dqc_tpu.ops.pallas.dual_apply import dual_multi_apply_planes
from dqc_tpu.ops.pallas.high_apply import (high_group_apply_planes,
                                           high_multi_apply_planes)
from dqc_tpu.ops.pallas import common as cm

from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops import planes as tpl
from dqc_tpu_torch.ops.kernels import _storage as st

from test_torch_fwd16_kernels import (BF, IDS, MEASURED, SETTINGS, _assert_planes,
                                      _assert_rel, _cnormal, _dec, _j, _pair, _planes,
                                      _red_tol, _t, _unitary_pair)

CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                np.complex64)


def _unitary(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
    return q.astype(np.complex64)


def _dual_factors(gate):
    terms = tps._dense_cross_expanded_terms(gate, (7, 6), 14)
    ops = tpl.cross_terms_operands(terms, 14, torch.device("cpu"))
    assert ops[0] == "dual"
    return ("dual", (2, 128, 128), [o.numpy() for o in ops[1:]])


def _span_factors(gate):
    ops = tpl.cross_span_operands(gate, (14, 0), 15, torch.device("cpu"))
    assert ops[0] == "multi"
    return ("high", ops[1], [o.numpy() for o in ops[2:]])


def _factors(kernel, rng):
    if kernel == "dual_cnot":
        return _dual_factors(CNOT)
    if kernel == "dual_unitary":
        return _dual_factors(_unitary(rng, 4))
    return _span_factors(_unitary(rng, 4))


def _fns(kind):
    if kind == "dual":
        return dual_multi_apply_planes, tk.dual_multi_apply
    return high_multi_apply_planes, tk.high_multi_apply


KERNELS = ["dual_cnot", "dual_unitary", "span"]


@pytest.mark.parametrize("fwd16, dm", SETTINGS, ids=IDS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_multi_apply_in_place(kernel, fwd16, dm):
    """The uncompute on the forward planes (G^-1 in place)."""
    rng = np.random.default_rng(2000 + len(kernel))
    kind, shape, ops = _factors(kernel, rng)
    jx, tx = _planes(rng, shape, fwd16)
    jfn, tfn = _fns(kind)
    want = jfn(*jx, *_j(ops), dot_mode=dm, interpret=True)
    got = tfn(*tx, *_t(ops), dot_mode=dm)
    _assert_planes(f"{kernel} in place {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("fwd16, dm, out", [
    (True, "f32", "bf16"), (True, "bf16x3", "bf16"), (False, "bf16x3", "f32"),
    (False, "bf16x3", "bf16"), (False, "bf16x3", "f16")], ids=str)
@pytest.mark.parametrize("kernel, acc", [("dual_unitary", True), ("span", False)],
                         ids=["dual_acc", "span_fresh"])
def test_multi_apply_seeds(kernel, acc, fwd16, dm, out):
    """An edge density's seed: ``[acc +] conj(sum_t ...)`` from the forward
    planes into the cotangent planes."""
    rng = np.random.default_rng(2100 + len(kernel) + acc)
    kind, shape, ops = _factors(kernel, rng)
    jx, tx = _planes(rng, shape, fwd16, 0.05)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.uint16}[out]
    tdt = {"f32": torch.float32, "bf16": BF, "f16": torch.float16}[out]
    jacc = tacc = None
    if acc:
        a = _pair(_cnormal(rng, shape, 0.05))
        jacc = tuple(cm.store_as(jnp.asarray(p), jdt) for p in a)
        tacc = tuple(st.store_as(torch.from_numpy(p), tdt) for p in a)
    jfn, tfn = _fns(kind)
    want = jfn(*jx, *_j(ops), alias=False, conj=True, acc=jacc,
               out_dtype=None if acc else jdt, dot_mode=dm, interpret=True)
    got = tfn(*tx, *_t(ops), alias=False, conj=True, acc=tacc,
              out_dtype=None if acc else tdt, dot_mode=dm)
    assert got[0].dtype == tdt
    case = f"{kernel} seed {dm} {fwd16}->{out}"
    if out == "f16":
        n = st.ulps_apart(got, [_dec(w) for w in want], torch.float16)
        MEASURED[case + " ulps"] = max(MEASURED.get(case + " ulps", 0.0), n)
        assert n <= 2.0, n
    else:
        _assert_planes(case, got, want, dm == "bf16x3")


@pytest.mark.parametrize("storage", ["f16", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_multi_apply_transport_bf16x3(kernel, storage):
    """The G^T transport in place on a reduced cotangent in the forward
    bf16x3 ("mixed" / "f16" storage with set_kernel_dot_mode("bf16x3"))."""
    rng = np.random.default_rng(2200 + len(kernel))
    kind, shape, ops = _factors(kernel, rng)
    b = _pair(_cnormal(rng, shape, 0.5))
    jdt = jnp.uint16 if storage == "f16" else jnp.bfloat16
    tdt = torch.float16 if storage == "f16" else BF
    jb = [cm.store_as(jnp.asarray(p), jdt) for p in b]
    tb = [st.store_as(torch.from_numpy(p), tdt) for p in b]
    jfn, tfn = _fns(kind)
    want = jfn(*jb, *_j(ops), dot_mode="bf16x3", interpret=True)
    got = tfn(*tb, *_t(ops), dot_mode="bf16x3")
    n = st.ulps_apart(got, [_dec(w) for w in want], tdt)
    MEASURED[f"{kernel} transport {storage} ulps"] = n
    assert got[0].dtype == tdt and n <= 2.0, n


@pytest.mark.parametrize("fwd16, dm, gram", [
    (*SETTINGS[0], "bf16x3"), (*SETTINGS[1], "f32"), (*SETTINGS[2], "bf16x3")],
    ids=[f"{i}-gram_{g}" for i, g in zip(IDS, ("bf16x3", "f32", "bf16x3"))])
def test_block_backward_sublane(fwd16, dm, gram):
    """The pair gram in bf16x3 (the "auto" mode) under "bf16" storage and on
    f32 planes, in f32 on bf16 planes in bf16x3."""
    rng = np.random.default_rng(2300 + len(gram))
    jf, tf = _planes(rng, (2, 128, 128), fwd16)
    jb, tb = _planes(rng, (2, 128, 128), fwd16, 0.5)
    ops = [*_unitary_pair(rng, 128), *_unitary_pair(rng, 128)]
    bm = "bf16x3" if fwd16 else dm   # the "auto" transport of the setting
    want = block_backward_sublane(*jf, *jb, *_j(ops), dot_mode=dm, bwd_dot_mode=bm,
                                  gram_dot_mode=gram, interpret=True)
    got = tk.block_backward_sublane(*tf, *tb, *_t(ops), dot_mode=dm, bwd_mode=bm,
                                    gram_mode=gram)
    x3 = dm == "bf16x3"
    case = f"block_backward_sublane {dm} {fwd16} gram {gram}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_rel(case + " T0", got[4:6], want[4:6],
                _red_tol(fwd16, x3 or fwd16 or gram == "bf16x3"))


# X = 512 takes 15-40 s a case on the CPU and runs the templates X = 256
# runs in each setting (the wide apply's operator passes, the cross-Gram's
# patches): slow but for the adjoint on bf16 planes
def _wide(keep_512):
    return [(256, *s) for s in SETTINGS] + [
        pytest.param(512, *s, marks=() if keep_512 and k == 0 else pytest.mark.slow)
        for k, s in enumerate(SETTINGS)]


WIDE_IDS = [f"{X}-{i}" for X in (256, 512) for i in IDS]


@pytest.mark.parametrize("X, fwd16, dm", _wide(False), ids=WIDE_IDS)
def test_wide_apply_in_place(X, fwd16, dm):
    """A lone top-group block ``E (x) I`` / the expanded hpair's merged
    operator, in place on the merged top axis."""
    rng = np.random.default_rng(2400 + X)
    jx, tx = _planes(rng, (1, X, 8, 128), fwd16)
    E = _unitary_pair(rng, X)
    want = high_group_apply_planes(*jx, *_j(E), dot_mode=dm, interpret=True)
    got = tk.high_apply(*tx, *_t(E), dot_mode=dm)
    _assert_planes(f"wide apply X{X} {dm} {fwd16}", got, want, dm == "bf16x3")


@pytest.mark.parametrize("X, fwd16, dm", _wide(True), ids=WIDE_IDS)
def test_block_backward_high_wide(X, fwd16, dm):
    rng = np.random.default_rng(2500 + X)
    shape = (1, X, 8, 128)
    jf, tf = _planes(rng, shape, fwd16)
    jb, tb = _planes(rng, shape, fwd16, 0.5)
    ops = [*_unitary_pair(rng, X), *_unitary_pair(rng, X)]
    bm = "bf16x3" if fwd16 else dm
    want = block_backward_high(*jf, *jb, *_j(ops), dot_mode=dm, bwd_dot_mode=bm,
                               gram_dot_mode="f32", interpret=True)
    got = tk.block_backward_high(*tf, *tb, *_t(ops), dot_mode=dm, bwd_mode=bm,
                                 gram_mode="f32")
    x3 = dm == "bf16x3"
    case = f"block_backward_high X{X} {dm} {fwd16}"
    _assert_planes(case + " F", got[:2], want[:2], x3)
    _assert_planes(case + " B", got[2:4], want[2:4], x3 or fwd16)
    _assert_rel(case + " T0", got[4:6], want[4:6], _red_tol(fwd16, x3 or fwd16))


if __name__ == "__main__":
    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for k, m in sys.modules.items()
               if k.endswith("test_torch_fwd16_kernels") and k != "__main__")
    for k, v in sorted(mod.MEASURED.items()):
        print(f"{k}: {v:.3e}")
    sys.exit(code)
