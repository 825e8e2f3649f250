"""The tensor-core routes of the high apply and the wide adjoint, on the CPU.

``csrc/tc_apply.cuh`` (the high apply at X = 128 / 256 / 512, every
storage and mode, and the two updates of the X = 256 / 512 adjoint) and the
X = 256 / 512 cross-Gram run "f32" products as 3xTF32 and bf16x3 as three
bf16 products, on operands split by ``ops/kernels/_tc.py``. No CUDA kernel
runs here; these tests hold what surrounds them:

* the splits: tf32 hi + lo reconstructs a value within 2^-21 of it (hi
  keeps 11 significant bits, rounded to nearest with ties away from zero,
  as ``cvt.rna.tf32``; lo 11 more), bf16 hi + lo within 2^-16;
* the pre-split operator: every part of every fragment of
  ``_tc.tc_operator`` is the split of the entry of E that the mma
  fragment layout puts there;
* the 3xTF32 complex product at X = 128 and 256 on numpy-seeded
  unit-variance planes and a random unitary stays within 1e-6 relative of
  float64 (the split's own error, ~2^-21: HIGH_TOL 1e-4 on planes and
  GRAM_T0_TOL 1e-5 on pair grams in chip_smoke.py hold unchanged);
* the dispatch: which X, storages and dot modes reach the tensor-core
  apply (``high_apply.kernel_route``), counted in
  ``high_apply.mode_launches["tc"]`` by the wrapper itself on meta tensors
  (its library entry points replaced by recorders), and the launches of
  the cz and CNOT models' value_and_grad on the meta device.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from dqc_tpu_torch import config
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _launch, _tc
from dqc_tpu_torch.ops.kernels import _storage as st

# the modules (the package's names of the same spelling are the wrappers)
ha = importlib.import_module("dqc_tpu_torch.ops.kernels.high_apply")
bbh = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_high")

torch.set_num_threads(2)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _values(seed, n=1 << 14):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
    return torch.from_numpy(v.astype(np.float32))


def _unitary(rng, X):
    q, _ = np.linalg.qr(rng.standard_normal((X, X)) + 1j * rng.standard_normal((X, X)))
    return q.astype(np.complex64)


# ---------------------------------------------------------------------------
# The splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_reconstructs(seed):
    a = _values(seed)
    hi, lo = _tc.split_tf32(a)
    for p in (hi, lo):  # tf32: the 13 low bits of the f32 pattern are zero
        assert (p.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - a).abs() <= a.abs() * 2.0 ** -11).all()
    err = (hi.double() + lo.double() - a.double()).abs()
    assert (err <= a.abs().double() * 2.0 ** -21).all()


def test_tf32_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between the tf32 values 1 and 1 + 2^-10
    a = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 - 2 ** -23], dtype=F32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0])
    assert torch.equal(_tc.tf32_round(a), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_split_reconstructs(seed):
    a = _values(seed)
    hi, lo = _tc.split_parts(a, "bf16x3")
    for p in (hi, lo):
        assert torch.equal(p.to(BF16).float(), p)
    err = (hi.double() + lo.double() - a.double()).abs()
    assert (err <= a.abs().double() * 2.0 ** -16).all()


# ---------------------------------------------------------------------------
# The pre-split operator in fragment order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("X", [128, 256])
@pytest.mark.parametrize("dot_mode", ["f32", "bf16x3"])
def test_tc_operator_is_the_fragment_layout(X, dot_mode):
    """Entry (s, mt, part, lane, r) of the operator is part `part` of E at
    the A fragment's row mt 16 + g + 8 (r & 1) and column s ks + t + 4 (r
    >> 1) (tf32, ks = 8), or the bf16 pair at columns s ks + 2 t + 8 (r >>
    1) + {0, 1} (bf16x3, ks = 16), lane = 4 g + t."""
    rng = np.random.default_rng(X)
    E = _unitary(rng, X)
    er, ei = torch.from_numpy(E.real.copy()), torch.from_numpy(E.imag.copy())
    op = _tc.tc_operator(er, ei, dot_mode)
    ks = 8 if dot_mode == "f32" else 16
    assert op.shape == (X // ks, X // 16, 4, 32, 4) and op.dtype == torch.int32
    parts = [*_tc.split_parts(er, dot_mode), *_tc.split_parts(ei, dot_mode)]
    s, mt, lane, r = np.meshgrid(np.arange(X // ks), np.arange(X // 16),
                                 np.arange(32), np.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    row = torch.from_numpy(mt * 16 + g + 8 * (r & 1))
    for k, p in enumerate(parts):
        words = op[:, :, k]
        if dot_mode == "f32":
            col = torch.from_numpy(s * ks + t + 4 * (r >> 1))
            assert torch.equal(words.view(F32), p[row, col])
        else:
            col = torch.from_numpy(s * ks + 2 * t + 8 * (r >> 1))
            low = (words & 0xFFFF).to(torch.int32) << 16
            high = words & -65536
            assert torch.equal(low.view(F32), p[row, col])
            assert torch.equal(high.view(F32), p[row, col + 1])


# ---------------------------------------------------------------------------
# The 3xTF32 product
# ---------------------------------------------------------------------------

def _cmatmul_tf32x3(a, b):
    """``a @ b`` of complex tensors in 3xTF32, as the kernels split it: each
    real product of the complex one as ``ah bh + ah bl + al bh`` of the tf32
    parts, each part product exact (float64 here) and summed in float64, so
    that what is left is the split's own error. Returns complex128."""
    def parts(z):
        rh, rl = _tc.split_tf32(z.real.float().contiguous())
        ih, il = _tc.split_tf32(z.imag.float().contiguous())
        return [p.double() for p in (rh, rl, ih, il)]

    arh, arl, aih, ail = parts(a)
    brh, brl, bih, bil = parts(b)

    def mul3(xh, xl, yh, yl):
        return xh @ yh + xh @ yl + xl @ yh

    re = mul3(arh, arl, brh, brl) - mul3(aih, ail, bih, bil)
    im = mul3(arh, arl, bih, bil) + mul3(aih, ail, brh, brl)
    return torch.complex(re, im)


@pytest.mark.parametrize("X", [128, 256])
def test_3xtf32_product_within_1e6_of_float64(X):
    rng = np.random.default_rng(7 + X)
    E = torch.from_numpy(_unitary(rng, X))
    x = torch.from_numpy(((rng.standard_normal((X, 2048))
                           + 1j * rng.standard_normal((X, 2048))) / np.sqrt(2))
                         .astype(np.complex64))
    exact = E.to(torch.complex128) @ x.to(torch.complex128)
    got = _cmatmul_tf32x3(E, x)
    rel = ((got - exact).abs().max() / exact.abs().max()).item()
    assert rel <= 1e-6, rel
    # one pass of TF32 alone is ~1e-3 off: the "f32" mode never takes it
    one = (_tc.tf32_round(E.real.contiguous()).double()
           @ _tc.tf32_round(x.real.contiguous()).double())
    assert (one - (E.real.double() @ x.real.double())).abs().max().item() > 1e-5


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

def test_kernel_route_table():
    for X in (8, 16, 32, 64):
        assert ha.kernel_route(X, F32, "f32") == "high_apply"
        for dt, dot in ((F32, "bf16x3"), (BF16, "f32"), (F16, "f32"), (BF16, "bf16x3")):
            assert ha.kernel_route(X, dt, dot) == "high_apply_fwd16"
    for X in (128, 256, 512):
        for dt in (F32, BF16, F16):
            for dot in ("f32", "bf16x3"):
                assert ha.kernel_route(X, dt, dot) == "tc"


@pytest.fixture
def meta_launches(monkeypatch):
    """The wrappers on meta tensors with their libraries replaced by
    recorders: a list of (library entry point, X, xkind / bkind) per call."""
    calls = []

    def entry(lib, fn, argtypes):
        def call(*args):
            calls.append((fn, args))
            return 0
        return call

    monkeypatch.setattr(_launch, "check_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "check_tables", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "entry", entry)
    monkeypatch.setattr(_launch, "stream", lambda device: 0)
    monkeypatch.setattr(_launch, "sm_count", lambda device: 132)
    tk.reset_launch_counts()
    yield calls
    tk.reset_launch_counts()


@pytest.mark.parametrize("dot", ["f32", "bf16x3"])
def test_high_apply_counts_the_tensor_core_route(meta_launches, dot):
    want_tc = 0
    for X in (8, 64, 128, 256, 512):
        E = torch.empty((X, X), device="meta")
        for dt in (F32, BF16, F16):
            x = torch.empty((1, X, 128, 128), dtype=dt, device="meta")
            ha.high_apply(x, x, E, E, dot_mode=dot)                       # in place
            acc = torch.empty(x.shape, dtype=dt, device="meta")
            ha.high_apply(x, x, E, E, conj=True, acc=(acc, acc), alias=False,
                          dot_mode=dot)                                  # seed
            want_tc += 2 * (X >= 128)
            fns = [fn for fn, _ in meta_launches[-2:]]
            want = ("dqc_tc_apply" if X >= 128 else
                    "dqc_high_apply" if dt == F32 and dot == "f32"
                    else "dqc_high_apply_fwd16")
            assert fns == [want, want], (X, dt, dot, fns)
            kinds = meta_launches[-1][1][4:6]
            assert kinds == (st.storage_kind(dt), st.storage_kind(dt))
    assert ha.high_apply.mode_launches["tc"] == want_tc == 18
    assert ha.high_apply.launches == 30


@pytest.mark.parametrize("X", [256, 512])
def test_wide_adjoint_takes_presplit_operators(meta_launches, X):
    """The X = 256 / 512 adjoint hands its library the planes and Einv as
    f32 for the cross-Gram and T0, then updates F and B in place through
    the high apply's tensor-core entry, Einv and E^T pre-split for the
    uncompute's and the transport's dot modes; only the adjoint counts."""
    p = torch.empty((1, X, 64, 128), device="meta")
    b16 = torch.empty((1, X, 64, 128), dtype=BF16, device="meta")
    E = torch.empty((X, X), device="meta")
    bbh.block_backward_high(p, p, b16, b16, E, E, E, E, bwd_mode="bf16x3",
                            gram_mode="bf16x3", dot_mode="f32")
    (fn, args), (un, un_args), (tr, tr_args) = meta_launches[-3:]
    assert fn == "dqc_block_backward_high_wide"
    assert args[4:6] == (st.storage_kind(BF16), st.storage_kind(F32))
    assert args[-2] == 1                                  # gram_x3
    assert un == tr == "dqc_tc_apply"
    assert un_args[4:6] == (st.storage_kind(F32),) * 2    # F in place, "f32"
    assert tr_args[4:6] == (st.storage_kind(BF16),) * 2   # B in place, bf16x3
    assert (un_args[-5], tr_args[-5]) == (0, 1)            # x3 flags
    assert (un_args[-3], tr_args[-3]) == (X, X)
    assert bbh.block_backward_high.mode_launches["wide"] == 1
    assert bbh.block_backward_high.mode_launches["gram_bf16x3"] == 1
    assert ha.high_apply.launches == ha.high_apply.mode_launches["tc"] == 0


def _model_high_applies(model, loss="magnetization"):
    """(X, input storage, dot mode, route) of every high_apply call of one
    value_and_grad of ``model`` on the meta device."""
    calls = []
    sig = inspect.signature(tk.PLAIN.high_apply)

    def recording(name, plain):
        def call(*args, **kw):
            if name == "high_apply":
                a = sig.bind(*args, **kw).arguments
                X, dt = args[0].shape[1], args[0].dtype
                dot = a.get("dot_mode", "f32")
                calls.append((X, dt, dot, ha.kernel_route(X, dt, dot)))
            return plain(*args, **kw)
        return call

    kernels = tk.KernelSet(*(recording(f, p) for f, p in
                             zip(tk.KernelSet._fields, tk.PLAIN)))
    p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
    getattr(model, loss)(p, kernels=kernels).backward()
    return calls


@pytest.fixture
def restore_config():
    yield
    config.set_state_storage("f32")
    config.set_kernel_dot_mode("f32")
    config.set_hpair_factorized(True)


@pytest.mark.parametrize("n, entangler, storage, dot, factorized", [
    (21, "cz", "f32", "f32", True),       # group 2 at X = 128
    (22, "cz", "bf16", "bf16x3", False),  # the expanded top at X = 256
    (23, "cnot", "f16", "f32", True),     # the lone top block at X = 512
    (17, "cnot", "f32", "bf16x3", True),  # X = 8 / 16 only
], ids=["cz21", "cz22_bf16_x3_expanded", "cnot23_f16", "cnot17_x3"])
def test_models_reach_the_tensor_cores(restore_config, n, entangler, storage,
                                       dot, factorized):
    config.set_state_storage(storage)
    config.set_kernel_dot_mode(dot)
    config.set_hpair_factorized(factorized)
    calls = _model_high_applies(THEA(n, 2, entangler, device="meta"))
    assert calls
    for X, dt, d, route in calls:
        assert (route == "tc") == (X >= 128), (X, dt, d, route)
    wide = {X for X, *_ in calls if X >= 128}
    # n = 22 expanded: groups 2 and 3 are one merged axis of 256
    want = {21: {128}, 22: {256}, 23: {128, 512}, 17: set()}[n]
    assert wide == want
