"""The dual and lane adjoints' tensor-core step, on the CPU.

``csrc/tc_adjoint.cuh`` (built in ``csrc/block_backward_dual.cu``'s library,
the lane and sublane adjoints as the dual kernel's lane or sublane step
alone; the high adjoint at X = 128 runs it too,
``tests/test_torch_tc_adjoint_high.py``) runs every product of the one-pass
adjoint on the tensor cores: the uncomputes and the transports as 3xTF32 in
the "f32" dot mode (three bf16 products in bf16x3), the pair grams bf16x3
(the default) or 3xTF32. No CUDA kernel runs here; these tests hold what
surrounds it and its arithmetic:

* the wrappers hand their library entry the planes, the storage kinds, the
  mode flags and the operators pre-split in fragment order, each equal to
  ``_tc.tc_operator`` of the matrix its product reads (``E1inv``, ``E1^T``,
  ``E0inv``, ``E0^T``; the lane adjoint ``Einv`` and ``E^T``) in that
  product's dot mode, on meta planes with the library entries replaced by
  recorders; the lane adjoint's entry lives in the dual adjoint's library,
  and every launch counts in ``mode_launches["tc"]``;
* the dual step written out in the kernel's numerics (the four products as
  3xTF32 of ``_tc.split_tf32`` parts, the pair grams as bf16x3 of
  ``_storage.split`` parts, each part product exact: float64) against the
  JAX package's ``block_backward_dual`` in interpret mode at A = 2 (n =
  15), both step orders, a run met before and after the pair: the planes
  within 1e-6 of their largest entry of the float64 step (the split's own
  error), the pair grams within ``GRAM_T0_TOL`` (chip_smoke.py's 1e-5 of
  the largest entry); against the JAX kernel each within that plus the JAX
  kernel's own distance from float64 (its f32 sums);
* the cz ring, the CNOT ring and the gauntlet tape's value_and_grad on the
  meta device through the wrappers under f32, "f16" and "bf16" storage at
  n = 15, and the rings at n = 21 (group 2 at X = 128): every launch of the
  dual, lane and sublane adjoints counts ``[tc]``, and so does every launch
  of the high adjoint at X <= 128, which are the launches it hands its
  tensor-core entries.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas.block_backward import block_backward_dual as jax_dual

from dqc_tpu_torch import config
from dqc_tpu_torch.circuit import plane_scan as tps
from dqc_tpu_torch.circuit.builder import AutoGradCircuit
from dqc_tpu_torch.circuit.fusion import fuse_tape
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _launch, _tc
from dqc_tpu_torch.ops.kernels import _storage as st

from chip_smoke import GRAM_T0_TOL, gauntlet_tape

# the modules (the package's names of the same spelling are the wrappers)
bbd = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_dual")
bbl = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_lane")

torch.set_num_threads(2)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
PLANE_TOL = 1e-6   # of the largest entry: the 3xTF32 split's own error


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _unitary(rng, X=128):
    q, _ = np.linalg.qr(_cnormal(rng, (X, X)))
    return q.astype(np.complex64)


def _pair(c):
    return (torch.from_numpy(np.ascontiguousarray(c.real)),
            torch.from_numpy(np.ascontiguousarray(c.imag)))


# ---------------------------------------------------------------------------
# What the wrappers hand their library
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta planes with their library entries replaced by
    recorders: (library, entry point, arguments) per call, and each
    pre-split operator the launch made, by its data pointer."""
    calls, made = [], {}
    tc_operator = _tc.tc_operator

    def entry(lib, fn, argtypes):
        def call(*args):
            assert len(args) == len(argtypes), (fn, len(args), len(argtypes))
            calls.append((lib, fn, args))
            return 0
        return call

    def presplit(e_r, e_i, dot_mode, parts=4):
        op = tc_operator(e_r, e_i, dot_mode, parts)
        made[op.data_ptr()] = op
        return op

    monkeypatch.setattr(_launch, "check_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "check_tables", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "entry", entry)
    monkeypatch.setattr(_launch, "stream", lambda device: 0)
    monkeypatch.setattr(_launch, "sm_count", lambda device: 132)
    monkeypatch.setattr(_tc, "tc_operator", presplit)
    tk.reset_launch_counts()
    yield calls, made
    tk.reset_launch_counts()


# (F storage, B storage, dot_mode, bwd_mode, gram_mode)
SETTINGS = [(F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
            (F32, F16, "f32", "bf16x3", "bf16x3"), (F32, F16, "f32", "f32", "bf16x3"),
            (BF16, BF16, "f32", "bf16x3", "bf16x3"), (F32, F32, "bf16x3", "f32", "f32"),
            (BF16, BF16, "bf16x3", "bf16x3", "bf16x3")]
IDS = ["f32", "f32_gram_x3", "f16_x3", "f16_f32_transport", "bf16_x3",
       "f32_dot_x3", "bf16_all_x3"]


def _ops(seed, k):
    """k random (128, 128) operators as f32 real / imag CPU tensors."""
    rng = np.random.default_rng(seed)
    return [p for _ in range(k) for p in _pair(_unitary(rng))]


def _meta_planes(fdt, bdt, A=2, shape=(128, 128)):
    f = torch.empty((A, *shape), dtype=fdt, device="meta")
    b = torch.empty((A, *shape), dtype=bdt, device="meta")
    return f, f, b, b


def _want(e_r, e_i, mode, planes_dtype):
    """The operator of a product in ``mode`` on planes of ``planes_dtype``:
    in three parts where 3xTF32 meets 16-bit planes (exact in tf32)."""
    parts = 6 if mode == "f32" and planes_dtype != F32 else 4
    return _tc.tc_operator(e_r.contiguous(), e_i.contiguous(), mode, parts)


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram", SETTINGS, ids=IDS)
@pytest.mark.parametrize("run", [False, True], ids=["no_run", "run_q"])
def test_dual_hands_presplit_operators(recorded, fdt, bdt, dot, bwd, gram, run):
    calls, made = recorded
    ops = _ops(10 + SETTINGS.index((fdt, bdt, dot, bwd, gram)), 4)
    e0inv_r, e0inv_i, e0_r, e0_i, e1inv_r, e1inv_i, e1_r, e1_i = ops
    kw = dict(g0_first=False, dot_mode=dot, bwd_mode=bwd, gram_mode=gram)
    if run:
        tabs = tuple(torch.zeros(s) for s in [(128, 128)] * 2 + [(2, 128)] * 4)
        kw.update(diag_inv_tables=tabs, diag_tables=tabs, diag_first_fwd=True,
                  diag_q=True)
    bbd.block_backward_dual(*_meta_planes(fdt, bdt), *ops, **kw)
    (lib, fn, args), = calls
    assert (lib, fn) == ("block_backward_dual", "dqc_block_backward_dual")
    want = (_want(e0inv_r, e0inv_i, dot, fdt), _want(e0_r.t(), e0_i.t(), bwd, bdt),
            _want(e1inv_r, e1inv_i, dot, fdt), _want(e1_r.t(), e1_i.t(), bwd, bdt))
    for got_ptr, w in zip(args[4:8], want):
        assert torch.equal(made[got_ptr], w)
    # has_diag, diag_first_fwd, g0_first, diag_q; A, nblk
    assert args[20:24] == (int(run), 1, 0, int(run))
    assert args[30:32] == (2, 2)
    # bkind, bwd_x3, gram_x3, fkind, dot_x3
    assert args[32:37] == (st.storage_kind(bdt), int(bwd == "bf16x3"),
                           int(gram == "bf16x3"), st.storage_kind(fdt),
                           int(dot == "bf16x3"))
    w = bbd.block_backward_dual
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["diag_q"] == int(run)


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram", SETTINGS, ids=IDS)
def test_lane_hands_presplit_operators(recorded, fdt, bdt, dot, bwd, gram):
    calls, made = recorded
    einv_r, einv_i, e_r, e_i = ops = _ops(20 + SETTINGS.index((fdt, bdt, dot, bwd, gram)), 2)
    bbl.block_backward_lane(*_meta_planes(fdt, bdt), *ops, dot_mode=dot,
                            bwd_mode=bwd, gram_mode=gram)
    (lib, fn, args), = calls
    # the dual adjoint's library: the lane step is built there, once
    assert (lib, fn) == ("block_backward_dual", "dqc_block_backward_lane")
    assert torch.equal(made[args[6]], _want(einv_r, einv_i, dot, fdt))
    assert torch.equal(made[args[7]], _want(e_r.t(), e_i.t(), bwd, bdt))
    assert args[4:6] == (st.storage_kind(bdt), st.storage_kind(fdt))
    assert args[10:15] == (2, 2, int(bwd == "bf16x3"), int(gram == "bf16x3"),
                           int(dot == "bf16x3"))
    w = bbl.block_backward_lane
    assert w.launches == w.mode_launches["tc"] == 1
    assert bbd.block_backward_dual.launches == 0


def test_three_part_operator():
    """Where 3xTF32 meets exact planes the operator comes in three tf32
    parts: they hold it within ~2^-33, its lo2 parts follow its four parts
    in the fragment layout, and a product on bf16 planes is then as close
    to float64 as an f32 product (the two-part split leaves ~2^-22)."""
    rng = np.random.default_rng(5)
    E = _unitary(rng)
    er, ei = _pair(E)
    hi, lo, lo2 = _tc.split_tf32_3(er)
    for p in (hi, lo, lo2):
        assert (p.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (hi.double() + lo.double() + lo2.double() - er.double()).abs()
    assert (err <= er.abs().double() * 2.0 ** -32).all()
    op6 = _tc.tc_operator(er, ei, "f32", 6)
    assert op6.shape == (16, 8, 6, 32, 4)
    assert torch.equal(op6[:, :, :4], _tc.tc_operator(er, ei, "f32"))
    assert torch.equal(op6[:, :, 4:], _tc.tc_operator(lo2, _tc.split_tf32_3(ei)[2],
                                                     "f32")[:, :, ::2])
    with pytest.raises(ValueError, match="three parts"):
        _tc.tc_operator(er, ei, "bf16x3", 6)
    x = torch.from_numpy(_cnormal(rng, (128, 512))).to(torch.complex128)
    x = torch.complex(x.real.to(BF16).double(), x.imag.to(BF16).double())
    exact = torch.from_numpy(E).to(torch.complex128) @ x

    def product(parts):  # each part times the exact planes, float64
        return sum(torch.complex(pr.double(), pi.double()) @ x for pr, pi in parts)

    two = product(zip(_tc.split_tf32(er), _tc.split_tf32(ei)))
    three = product(zip(_tc.split_tf32_3(er), _tc.split_tf32_3(ei)))
    scale = exact.abs().max().item()
    assert (three - exact).abs().max().item() / scale <= 2.0 ** -28
    assert (two - exact).abs().max().item() / scale > 2.0 ** -26


# ---------------------------------------------------------------------------
# The dual step in the kernel's numerics
# ---------------------------------------------------------------------------

def _parts(z, split):
    return [p.double() for p in (*split(z.real.float().contiguous()),
                                 *split(z.imag.float().contiguous()))]


def _split_product(a, b, split, mm):
    """``mm(a, b)`` of complex tensors with each real product as three passes
    of the split parts (hi hi + hi lo + lo hi), each pass exact (float64):
    what is left is the split's own error. complex128."""
    arh, arl, aih, ail = _parts(a, split)
    brh, brl, bih, bil = _parts(b, split)

    def mul3(xh, xl, yh, yl):
        return mm(xh, yh) + mm(xh, yl) + mm(xl, yh)

    return torch.complex(mul3(arh, arl, brh, brl) - mul3(aih, ail, bih, bil),
                         mul3(arh, arl, bih, bil) + mul3(aih, ail, brh, brl))


def _exact_product(a, b, split, mm):
    return mm(a.to(torch.complex128), b.to(torch.complex128))


def _matmul(x, y):
    return x @ y


def _gram_sub(x, y):  # T0_sub[x, y] = sum over a, c of B[a, x, c] F[a, y, c]
    return torch.einsum("axc,ayc->xy", x, y)


def _gram_lane(x, y):  # T0_lane[x, y] = sum over a, r of B[a, r, x] F[a, r, y]
    return torch.einsum("arx,ary->xy", x, y)


def _run(tables, dtype):
    tsl, tas, tal = (torch.from_numpy(t).to(dtype) for t in tables)
    return (tas[:, :, None] * tal[:, None, :]) * tsl[None]


def _sublane_step(F, B, Einv, E, prod, dt):
    """The sublane step (contract the middle axis) in the kernel's numerics
    (``prod``: split or exact products): fin, bout, T0."""
    F1 = prod(Einv, F, _tc.split_tf32, _matmul).to(dt)
    B1 = prod(E.transpose(0, 1), B, _tc.split_tf32, _matmul).to(dt)
    return F1, B1, prod(B, F1, st.split, _gram_sub)


def _dual_step(F, B, E0inv, E0, E1inv, E1, g0_first, run, tinv, tfwd, exact):
    """The dual adjoint's step on complex planes (A, 128, 128) as the kernel
    computes it (``exact``: in float64 instead): the uncomputes and
    transports 3xTF32, the pair grams bf16x3; F and B stored f32 between
    the steps and next to the run (``run``: "first", the run came before the
    pair in the forward and is met after it; "after"; or None)."""
    prod = _exact_product if exact else _split_product
    dt = torch.complex128 if exact else torch.complex64
    F, B = F.to(dt), B.to(dt)
    if run == "after":
        F, B = (F * _run(tinv, dt)).to(dt), (B * _run(tfwd, dt)).to(dt)

    def sublane(F, B):
        return _sublane_step(F, B, E1inv, E1, prod, dt)

    def lane(F, B):
        F1 = prod(F, E0inv.transpose(0, 1), _tc.split_tf32, _matmul).to(dt)
        B1 = prod(B, E0, _tc.split_tf32, _matmul).to(dt)
        return F1, B1, prod(B, F1, st.split, _gram_lane)

    if g0_first:
        F, B, Ts = sublane(F, B)
        F, B, Tl = lane(F, B)
    else:
        F, B, Tl = lane(F, B)
        F, B, Ts = sublane(F, B)
    if run == "first":
        F, B = (F * _run(tinv, dt)).to(dt), (B * _run(tfwd, dt)).to(dt)
    return F, B, Tl, Ts


@pytest.mark.parametrize("run", ["first", "after"], ids=["run_before", "run_after"])
@pytest.mark.parametrize("g0_first", [True, False], ids=["g0_first", "g1_first"])
def test_tensor_core_dual_step_against_pallas(g0_first, run):
    A = 2
    rng = np.random.default_rng(300 + 2 * g0_first + (run == "first"))
    F, B = _cnormal(rng, (A, 128, 128)), _cnormal(rng, (A, 128, 128), 0.5)
    E0inv, E0, E1inv, E1 = (_unitary(rng) for _ in range(4))

    def phases(shape):
        return np.exp(1j * rng.uniform(0, 2 * np.pi, shape)).astype(np.complex64)

    tinv = [phases((128, 128)), phases((A, 128)), phases((A, 128))]
    tfwd = [phases((128, 128)), phases((A, 128)), phases((A, 128))]

    def planes(*zs):
        return [np.ascontiguousarray(p) for z in zs for p in (z.real, z.imag)]

    out = jax_dual(*planes(F, B, E0inv, E0, E1inv, E1), g0_first=g0_first,
                   diag_inv_tables=tuple(planes(*tinv)),
                   diag_tables=tuple(planes(*tfwd)), diag_first_fwd=run == "first",
                   gram_dot_mode="bf16x3", interpret=True)
    out = [np.asarray(o) for o in out]
    jax_out = [torch.from_numpy(out[2 * k] + 1j * out[2 * k + 1]) for k in range(4)]
    args = (*(torch.from_numpy(z) for z in (F, B, E0inv, E0, E1inv, E1)),
            g0_first, run, tinv, tfwd)
    tc_out = _dual_step(*args, exact=False)
    exact = _dual_step(*args, exact=True)
    for name, got, want, jx, tol in zip(("F", "B", "T0_lane", "T0_sub"), tc_out,
                                        exact, jax_out, (PLANE_TOL,) * 2
                                        + (GRAM_T0_TOL,) * 2):
        scale = want.abs().max().item()
        own = (got - want).abs().max().item() / scale
        jax_own = (jx - want).abs().max().item() / scale
        vs_jax = (got - jx).abs().max().item() / scale
        assert own <= tol, (name, own, tol)
        assert vs_jax <= tol + jax_own, (name, vs_jax, tol, jax_own)


# ---------------------------------------------------------------------------
# The models on the meta device through the wrappers
# ---------------------------------------------------------------------------

@pytest.fixture
def meta_kernels(monkeypatch):
    """The wrappers on the meta device, their library entries replaced by
    stand-ins that launch nothing; yields the high adjoint's launches as
    (entry, X)."""
    high = []
    x_arg = {"dqc_block_backward_high_small": 30, "dqc_block_backward_high_wide": 12}

    def entry(lib, fn, argtypes):
        def call(*args):
            if fn == "dqc_block_backward_high_tc":
                high.append((fn, 128))
            elif fn.startswith("dqc_block_backward_high"):
                high.append((fn, args[x_arg[fn]]))
            return 0
        return call

    monkeypatch.setattr(_launch, "check_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "check_tables", lambda *a, **k: None)
    monkeypatch.setattr(_launch, "entry", entry)
    monkeypatch.setattr(_launch, "stream", lambda device: 0)
    monkeypatch.setattr(_launch, "sm_count", lambda device: 132)
    tk.reset_launch_counts()
    yield high
    tk.reset_launch_counts()
    config.set_state_storage("f32")


def _model_counts(kind, n):
    if kind == "gauntlet":
        tape = gauntlet_tape(AutoGradCircuit(n, device="cpu"), n, 2).tape
        var = [torch.zeros(inst.gate_size(), dtype=torch.complex64, device="meta")
               .requires_grad_(True) for inst in tape.gates(var=True)]
        const = [torch.zeros(inst.gate_size(), dtype=torch.complex64, device="meta")
                 for inst in tape.gates(var=False)]
        state = torch.zeros(1 << n, dtype=torch.complex64, device="meta")
        dens = tps.plane_tape_forward(fuse_tape(tape), state, var, const,
                                      kernels=tk.KERNELS)
        sum(torch.einsum("ii->", d).real for d in dens).backward()
    else:
        model = THEA(n, 2, kind, device="meta")
        p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        model.magnetization(p, kernels=tk.KERNELS).backward()
    return tk.launch_counts()


@pytest.mark.parametrize("storage", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("kind, n", [("cz", 15), ("cnot", 15), ("gauntlet", 15),
                                     ("cz", 21), ("cnot", 21)])
def test_models_count_the_tensor_core_adjoints(meta_kernels, kind, n, storage):
    """Every launch of the dual, lane and sublane adjoints counts ``[tc]``;
    the high adjoint's launches count it exactly when they take a
    tensor-core entry, which they do at every X up to 128 (the X = 128 step,
    group 2 at n = 21; the small-X step below) and not on the X = 256 / 512
    merged top axis."""
    config.set_state_storage(storage)
    counts = _model_counts(kind, n)
    adjoint = "block_backward_lane" if kind == "gauntlet" else "block_backward_dual"
    assert counts[adjoint] > 0, counts
    for k in ("block_backward_dual", "block_backward_lane", "block_backward_sublane"):
        assert counts[f"{k}[tc]"] == counts[k], (k, counts)
    high = meta_kernels
    tc = sum(fn in ("dqc_block_backward_high_tc", "dqc_block_backward_high_small")
             for fn, _ in high)
    assert len(high) == counts["block_backward_high"]
    assert counts["block_backward_high[tc]"] == tc
    assert tc == sum(X <= 128 for _, X in high)
    if n == 21:
        assert tc > 0, high
    if kind == "cnot":
        assert counts["block_backward_sublane"] > 0
    if storage != "f32":
        assert counts[f"{adjoint}[{storage}]"] == counts[adjoint]
