"""The merged-top adjoint on the tensor-core step, on the CPU.

``csrc/block_backward_merged_fact.cu`` runs the Kronecker-factorized adjoint
of ``Et (x) El`` on the merged view (A1, Xt 128, M, 128) as
``csrc/tc_adjoint.cuh``'s one-pass step on tiles of Xt slices of 64 / Xt
columns: the low factor's uncompute, transport and ``T0_low`` on the tensor
cores (3xTF32 or bf16x3, each mode on its own), the raw tiles' slice gram
(``T0_top = P Eti^T``) and the top factor as two passes of its own on the
CUDA cores. No CUDA kernel runs here; these tests hold:

* what the wrapper hands its library on meta planes with the entries
  replaced by recorders: ``Eli`` and ``El^T`` pre-split in fragment order
  (``_tc.tc_operator``) in each product's dot mode, in three parts where
  3xTF32 meets 16-bit planes, the top operators as they are, the view, the
  blocks, the kinds and the mode flags (seven storage / mode settings, at
  Xt = 2 and 4 in turn), a bf16x3 uncompute beside a bf16x3 transport
  among them; every launch counted in ``mode_launches["tc"]``,
  and so are the cz ring's merged-top adjoints at n = 22 / 23 on the meta
  device;
* the step written out in the kernel's numerics (3xTF32 of
  ``_tc.split_tf32`` parts, three-part operators on exact planes, bf16x3 of
  ``_storage.split`` parts, float64 part products; the top factor and
  T0_top in complex64) against the JAX package's ``block_backward_merged_fact``
  in interpret mode on the views (1, 256, 1, 128) and (1, 512, 1, 128), with
  B f32 / bf16 / f16, F f32 / bf16 and each dot mode: f32 planes within
  ``PLANE_TOL`` of their largest entry of the float64 step (``X3_PLANE_TOL``
  where a bf16x3 product made them), 16-bit planes within ``STORE_ULPS``
  storage ulps, T0_top and T0_low within ``GRAM_T0_TOL`` of their largest
  entry (``gram_tolerance`` next to 16-bit planes, ``X3_GRAM_TOL`` with a
  bf16x3 gram or uncompute), and against the JAX kernel within that plus the
  JAX kernel's own distance from float64; the plain version (which the
  kernel is held to on the card) within the same bars, a bf16x3 uncompute
  beside a bf16x3 transport among the cases.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas.block_backward import block_backward_merged_fact as jax_merged

from dqc_tpu_torch import config
from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st

from chip_smoke import GRAM_T0_TOL, STORE_ULPS, X3_GRAM_TOL
from test_torch_tc_adjoint import (BF16, F16, F32, IDS, PLANE_TOL, SETTINGS, _cnormal,
                                   _gram_sub, _matmul, _pair, _unitary, _want,
                                   recorded)  # noqa: F401 (a fixture)
from test_torch_tc_adjoint_small_x import (X3_PLANE_TOL, _dec, _exact, _held, _product,
                                           _split_of, _to_jax)

# the module (the package's name of the same spelling is the wrapper)
bbm = importlib.import_module("dqc_tpu_torch.ops.kernels.block_backward_merged_fact")


# ---------------------------------------------------------------------------
# What the wrapper hands its library
# ---------------------------------------------------------------------------

def _ops(seed, x_top):
    rng = np.random.default_rng(seed)
    return ([p for _ in range(2) for p in _pair(_unitary(rng))]
            + [p for _ in range(2) for p in _pair(_unitary(rng, x_top))])


# each setting at one top width: Xt = 2 and 4 in turn
HANDS = [(*c, 2 + 2 * (k % 2)) for k, c in enumerate(SETTINGS)]


@pytest.mark.parametrize("fdt, bdt, dot, bwd, gram, x_top", HANDS,
                         ids=[f"{i}-Xt{c[-1]}" for i, c in zip(IDS, HANDS)])
def test_merged_hands_presplit_operators(recorded, fdt, bdt, dot, bwd, gram, x_top):
    calls, made = recorded
    ops = _ops(80 + HANDS.index((fdt, bdt, dot, bwd, gram, x_top)), x_top)
    eli_r, eli_i, el_r, el_i = ops[:4]
    M = 16
    f = torch.empty((1, x_top * 128, M, 128), dtype=fdt, device="meta")
    b = torch.empty((1, x_top * 128, M, 128), dtype=bdt, device="meta")
    bbm.block_backward_merged_fact(f, f, b, b, *ops, x_top=x_top, dot_mode=dot,
                                   bwd_mode=bwd, gram_mode=gram)
    lib, fn, args = calls[-1]
    assert (lib, fn) == ("block_backward_merged_fact", "dqc_block_backward_merged_fact")
    assert torch.equal(made[args[4]], _want(eli_r, eli_i, dot, fdt))
    assert torch.equal(made[args[5]], _want(el_r.t(), el_i.t(), bwd, bdt))
    assert args[6:10] == tuple(t.data_ptr() for t in ops[4:])
    # A1, Xt, Q, nblk (one block an SM, at most one a tile of 8192
    # amplitudes); bkind, bwd_x3, gram_x3, fkind, dot_x3
    assert args[14:18] == (1, x_top, M * 128, min(x_top * 128 * M * 128 // 8192, 132))
    assert args[18:23] == (st.storage_kind(bdt), int(bwd == "bf16x3"),
                           int(gram == "bf16x3"), st.storage_kind(fdt),
                           int(dot == "bf16x3"))
    w = bbm.block_backward_merged_fact
    assert w.launches == w.mode_launches["tc"] == 1


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("n", [22, 23])
def test_models_count_the_tensor_core_merged_adjoint(recorded, n, storage):
    """The cz ring's value_and_grad at n = 22 (Xt = 2) and 23 (Xt = 4): every
    merged-top adjoint launch counts ``[tc]``."""
    calls, _ = recorded
    config.set_state_storage(storage)
    try:
        model = THEA(n, 2, "cz", device="meta")
        p = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        model.magnetization(p, kernels=tk.KERNELS).backward()
    finally:
        config.set_state_storage("f32")
    counts = tk.launch_counts()
    w = "block_backward_merged_fact"
    assert counts[w] == counts[f"{w}[tc]"] == 2, counts
    xts = {args[15] for _, fn, args in calls if fn == "dqc_block_backward_merged_fact"}
    assert xts == {1 << (n - 21)}


# ---------------------------------------------------------------------------
# The step in the kernel's numerics
# ---------------------------------------------------------------------------

def _merged_step(F, B, Eli, El, Eti, Et, modes, dtypes, prod, dt):
    """The step on the merged view as (Xt, 128, Q) in the kernel's numerics
    (``prod``, the top factor and T0_top in ``dt``) or in float64: F and B as
    loaded (decoded); the planes an operator meets are exact when stored
    16-bit. Returns fin, bout, T0_top, T0_low."""
    dot, bwd, gram = modes
    fdt, bdt = dtypes
    F, B, Eti, Et = F.to(dt), B.to(dt), Eti.to(dt), Et.to(dt)
    T0_top = torch.einsum("xdc,bdc->xb", B, F) @ Eti.transpose(0, 1)
    fB = prod(Eli, F, _split_of(dot), _matmul, fdt != F32 and dot == "f32").to(dt)
    T0_low = prod(B, fB, _split_of(gram), _gram_sub).to(dt)
    bl = prod(El.transpose(0, 1), B, _split_of(bwd), _matmul,
              bdt != F32 and bwd == "f32").to(dt)
    return (torch.einsum("ab,bdc->adc", Eti, fB), torch.einsum("ba,bdc->adc", Et, bl),
            T0_top, T0_low)


# (Xt, F storage, B storage, dot, bwd, gram): PERF.md's rows 12, 12b, 12f,
# 12f', 12v, 12x and a bf16x3 uncompute beside a bf16x3 transport; two
# cases run with -m slow only, each covered by kept ones: Xt4-bf16_f32_transport
# (the three-part f32 transport on bf16 B: Xt2-bf16B_f32_transport; bf16 F
# and B at Xt = 4: Xt4-bf16_all_x3) and Xt2-f32_dot_x3 (the bf16x3 uncompute
# on f32 planes: Xt2-f32_all_x3; the f32 transport beside a bf16x3 gram:
# Xt2-f32_gram_x3)
_SLOW = pytest.mark.slow
STEPS = [(2, F32, F32, "f32", "f32", "f32"), (2, F32, F32, "f32", "f32", "bf16x3"),
         (4, F32, F16, "f32", "bf16x3", "bf16x3"), (2, F32, BF16, "f32", "f32", "bf16x3"),
         pytest.param(4, BF16, BF16, "f32", "f32", "bf16x3", marks=_SLOW),
         pytest.param(2, F32, F32, "bf16x3", "f32", "bf16x3", marks=_SLOW),
         (4, BF16, BF16, "bf16x3", "bf16x3", "bf16x3"),
         (2, F32, F32, "bf16x3", "bf16x3", "bf16x3")]
STEP_IDS = ["Xt2-f32", "Xt2-f32_gram_x3", "Xt4-f16_x3", "Xt2-bf16B_f32_transport",
            "Xt4-bf16_f32_transport", "Xt2-f32_dot_x3", "Xt4-bf16_all_x3",
            "Xt2-f32_all_x3"]


@pytest.mark.parametrize("x_top, fdt, bdt, dot, bwd, gram", STEPS, ids=STEP_IDS)
def test_merged_step_against_pallas(x_top, fdt, bdt, dot, bwd, gram):
    M = 1
    rng = np.random.default_rng(600 + 7 * x_top + 3 * (fdt == BF16) + 5 * (bdt == F16)
                                + (dot == "bf16x3") + 2 * (bwd == "bf16x3")
                                + 4 * (gram == "bf16x3"))
    view = (1, x_top * 128, M, 128)
    Fz, Bz = _cnormal(rng, view), _cnormal(rng, view, 0.5)
    Eli, El = _unitary(rng), _unitary(rng)
    Eti, Et = _unitary(rng, x_top), _unitary(rng, x_top)
    jf, tf = _to_jax(Fz, fdt)
    jb, tb = _to_jax(Bz, bdt)
    ops = [np.ascontiguousarray(p) for z in (Eli, El, Eti, Et) for p in (z.real, z.imag)]
    out = list(jax_merged(*jf, *jb, *ops, x_top=x_top, dot_mode=dot, bwd_dot_mode=bwd,
                          gram_dot_mode=gram, interpret=True))
    tops = [torch.from_numpy(o) for o in ops]
    plain = bbm.block_backward_merged_fact_plain(*tf, *tb, *tops, x_top=x_top,
                                                 dot_mode=dot, bwd_mode=bwd,
                                                 gram_mode=gram)
    sv = (x_top, 128, M * 128)   # the view the step works on
    F0, B0 = st.load_b(*tf).reshape(sv), st.load_b(*tb).reshape(sv)
    args = (*(torch.from_numpy(z) for z in (Eli, El, Eti, Et)), (dot, bwd, gram),
            (fdt, bdt))
    got = _merged_step(F0, B0, *args, _product, torch.complex64)
    want = _merged_step(F0, B0, *args, _exact, torch.complex128)
    for name, k, dt, mode in (("F", 0, fdt, dot), ("B", 1, bdt, bwd)):
        jx = [_dec(np.asarray(p)).reshape(sv) for p in out[2 * k:2 * k + 2]]
        px = [st.f32_of(p).reshape(sv) for p in plain[2 * k:2 * k + 2]]
        if dt == F32:
            tol = PLANE_TOL if mode == "f32" else X3_PLANE_TOL
            jz = torch.complex(*jx).to(torch.complex128)
            _held(name, got[k].to(torch.complex128), want[k], jz, tol)
            _held(f"plain {name}", torch.complex(*px).to(torch.complex128), want[k], jz, tol)
            continue
        w_st = st.store_b(want[k].to(torch.complex64), dt)
        j_st = [st.store_as(p, dt) for p in jx]
        jax_own = st.ulps_apart(j_st, w_st, dt)
        for who, g_st in (("", st.store_b(got[k].to(torch.complex64), dt)),
                          ("plain ", [st.store_as(p, dt) for p in px])):
            own = st.ulps_apart(g_st, w_st, dt)
            vs_jax = st.ulps_apart(g_st, j_st, dt)
            assert own <= STORE_ULPS, (who + name, own)
            assert vs_jax <= STORE_ULPS + jax_own, (who + name, vs_jax, jax_own)
    red = [d for d in (bdt, fdt) if d != F32]
    gtol = (st.gram_tolerance(red[0]) if red
            else X3_GRAM_TOL if "bf16x3" in (gram, dot) else GRAM_T0_TOL)
    for j, name in ((0, "T0_top"), (1, "T0_low")):
        jx = torch.from_numpy(np.asarray(out[4 + 2 * j]) + 1j * np.asarray(out[5 + 2 * j]))
        px = torch.complex(plain[4 + 2 * j], plain[5 + 2 * j])
        jx = jx.to(torch.complex128)
        _held(name, got[2 + j].to(torch.complex128), want[2 + j], jx, gtol)
        _held(f"plain {name}", px.to(torch.complex128), want[2 + j], jx, gtol)
