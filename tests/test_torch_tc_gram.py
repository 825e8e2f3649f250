"""The group Gram at X = 128, 256 and 512 on the tensor cores, on the CPU.

``csrc/gram.cu``'s C entry ``dqc_gram_tc`` forms ``(S, C)`` of the lane,
sublane and high views at X = 128 and of the merged top axis at X = 256 /
512 on the tensor cores: 3xTF32 in the "f32" dot mode, three bf16 passes in
bf16x3, one bf16 pass on bf16 planes (exact in both formats); S as ``P +
P^T``, a patch's P taking the hi hi product at half weight and one of the
two cross passes. No CUDA kernel runs here; these tests hold:

* what the wrapper hands its library on meta planes with the entries
  replaced by recorders: the view ``(P, X, Q)``, the column groups, the
  storage kind and the bf16x3 flag to ``dqc_gram_tc`` at X >= 128, every
  such launch counted in ``mode_launches["tc"]``; X = 64 to the same
  entry, counted there too; the cz ring's Grams at n = 22 and 23
  (the merged top at X = 256 / 512) on the meta device;
* the Gram written out in the kernel's numerics (``_tc.split_tf32`` or
  ``_storage.split`` parts, float64 part products, S = P + P^T) against the
  JAX package's ``gram_lane``, ``gram_sublane`` and ``gram_high`` (X = 128,
  and the merged top at X = 256 and 512) in interpret mode at n = 15-16, on
  f32 planes in both dot modes and on bf16 planes: S and C within
  ``GRAM_T0_TOL`` (``X3_GRAM_TOL`` in bf16x3) of their largest entry of the
  float64 Gram, and against the JAX kernel within that plus the JAX
  kernel's own distance from float64.
"""

import importlib

import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas.gram import gram_high as jax_high
from dqc_tpu.ops.pallas.gram import gram_lane as jax_lane
from dqc_tpu.ops.pallas.gram import gram_sublane as jax_sublane

from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz as THEA
from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st
from dqc_tpu_torch.ops.kernels import _tc

from chip_smoke import GRAM_T0_TOL, X3_GRAM_TOL
from test_torch_tc_adjoint import BF16, F32, _cnormal, recorded  # noqa: F401 (a fixture)
from test_torch_tc_adjoint_small_x import _held, _to_jax

# the module (the package's name of the same spelling is the wrapper)
gm = importlib.import_module("dqc_tpu_torch.ops.kernels.gram")


# ---------------------------------------------------------------------------
# What the wrapper hands its library
# ---------------------------------------------------------------------------

# the views of the 29-qubit Grams: lane, sublane, group 2, the merged top at
# 29 and 30 qubits
VIEWS = [(1 << 22, 128, 1), (1 << 15, 128, 128), (256, 128, 1 << 14),
         (1, 256, 1 << 21), (1, 512, 1 << 21)]
VIEW_IDS = ["lane", "sublane", "high_X128", "merged_X256", "merged_X512"]


def _meta(view, dtype):
    x = torch.empty(view, dtype=dtype, device="meta")
    return x, x


@pytest.mark.parametrize("dtype, dot", [(F32, "f32"), (F32, "bf16x3"), (BF16, "f32")],
                         ids=["f32", "f32_x3", "bf16"])
@pytest.mark.parametrize("view", VIEWS, ids=VIEW_IDS)
def test_gram_hands_the_tensor_core_entry(recorded, view, dtype, dot):
    """X >= 128: ``dqc_gram_tc`` with the view, the column groups (four
    blocks an SM over the (X / 128)^2 patches, at most one per 32-column
    tile), the storage kind and the bf16x3 flag; counted ``[tc]``."""
    calls, _ = recorded
    gm.gram(*_meta(view, dtype), dot_mode=dot)
    (lib, fn, args), = calls
    assert (lib, fn) == ("gram", "dqc_gram_tc")
    P, X, Q = view
    nblk = min(P * Q // 32, 65535, 4 * 132 // (X // 128) ** 2)
    assert args[5:11] == (P, X, Q, nblk, st.storage_kind(dtype), int(dot == "bf16x3"))
    w = gm.gram
    assert w.launches == w.mode_launches["tc"] == 1
    assert w.mode_launches["fwd_bf16"] == int(dtype == BF16)
    assert w.mode_launches["fwd_bf16x3"] == int(dot == "bf16x3")


def test_gram_below_128_hands_the_tensor_core_entry(recorded):
    """X = 64: ``dqc_gram_tc`` too, one 64 x 64 patch a block over 64-column
    tiles, two blocks an SM; counted ``[tc]``."""
    calls, _ = recorded
    gm.gram(*_meta((4, 64, 1 << 14), F32))
    (lib, fn, args), = calls
    assert (lib, fn) == ("gram", "dqc_gram_tc")
    assert args[5:9] == (4, 64, 1 << 14, 2 * 132)
    assert gm.gram.launches == gm.gram.mode_launches["tc"] == 1


def test_gram_refuses_views_the_tiles_do_not_cover(recorded):
    for view in ((1, 256, 1), (3, 128, 48)):
        with pytest.raises(ValueError, match="does not tile"):
            gm.gram(*_meta(view, F32))


@pytest.mark.parametrize("n, merged_x", [(22, 256), (23, 512)])
def test_models_count_the_tensor_core_grams(recorded, n, merged_x):
    """The cz ring's densities at n = 22 / 23: the lane and sublane Grams at
    X = 128 and one merged-top Gram at X = 256 / 512 (group 2 and the tiny
    top group from one read), each to ``dqc_gram_tc`` and counted
    ``[tc]``."""
    calls, _ = recorded
    model = THEA(n, 1, "cz", device="meta")
    model.magnetization(model.init_params(torch.Generator().manual_seed(0)),
                        kernels=tk.KERNELS)
    grams = [args for lib, fn, args in calls if fn == "dqc_gram_tc"]
    assert sorted(a[6] for a in grams) == [128, 128, merged_x]
    assert not [fn for _, fn, _ in calls if fn == "dqc_gram"]
    counts = tk.launch_counts()
    assert counts["gram"] == counts["gram[tc]"] == 3


# ---------------------------------------------------------------------------
# The Gram in the kernel's numerics
# ---------------------------------------------------------------------------

def _tc_gram(xr, xi, mode, exact):
    """(S, C) of real planes (P, X, Q) as the kernel forms them: each plane
    split into hi and lo parts for ``mode`` (bf16 planes: the values, exact),
    float64 part products, P = Hr (Hr / 2)^T + Hr Lr^T + (Hi / 2) Hi^T +
    Li Hi^T and S = P + P^T, C = Lr Hi^T + Hr Li^T + Hr Hi^T."""
    if exact:
        hr, lr, hi, li = xr.double(), 0 * xr.double(), xi.double(), 0 * xi.double()
    else:
        split = _tc.split_tf32 if mode == "f32" else st.split
        (hr, lr), (hi, li) = split(xr), split(xi)
        hr, lr, hi, li = (t.double() for t in (hr, lr, hi, li))

    def g(a, b):
        return torch.einsum("pxq,pyq->xy", a, b)

    P = g(hr, hr) / 2 + g(hr, lr) + g(hi, hi) / 2 + g(li, hi)
    return P + P.T, g(lr, hi) + g(hr, li) + g(hr, hi)


def _exact_gram(xr, xi):
    xr, xi = xr.double(), xi.double()
    return (torch.einsum("pxq,pyq->xy", xr, xr) + torch.einsum("pxq,pyq->xy", xi, xi),
            torch.einsum("pxq,pyq->xy", xr, xi))


# (JAX kernel, the planes' shape, the port's view)
KERNELS = {"lane": (jax_lane, (2, 128, 128), (256, 128, 1)),
           "sublane": (jax_sublane, (2, 128, 128), (2, 128, 128)),
           "high_X128": (jax_high, (1, 128, 2, 128), (1, 128, 256)),
           "merged_X256": (jax_high, (1, 256, 1, 128), (1, 256, 128)),
           "merged_X512": (jax_high, (1, 512, 1, 128), (1, 512, 128))}
CASES = [("lane", F32, "f32"), ("lane", BF16, "f32"), ("sublane", F32, "bf16x3"),
         ("sublane", F32, "f32"), ("high_X128", F32, "f32"), ("high_X128", BF16, "bf16x3"),
         ("merged_X256", F32, "f32"), ("merged_X256", F32, "bf16x3"),
         ("merged_X512", F32, "f32"), ("merged_X512", BF16, "f32")]


@pytest.mark.parametrize("view, dtype, dot", CASES,
                         ids=[f"{v}-{'bf16' if d == BF16 else 'f32'}-{m}" for v, d, m in CASES])
def test_tensor_core_gram_against_pallas(view, dtype, dot):
    fn, shape, tview = KERNELS[view]
    rng = np.random.default_rng(500 + CASES.index((view, dtype, dot)))
    z = _cnormal(rng, shape)
    jz, tz = _to_jax(z, dtype)
    S_j, C_j = (torch.from_numpy(np.asarray(o, np.float64))
                for o in fn(*jz, dot_mode=dot, interpret=True))
    xr, xi = (st.f32_of(t).reshape(tview) for t in tz)
    got = _tc_gram(xr, xi, dot, dtype != F32)
    want = _exact_gram(xr, xi)
    tol = X3_GRAM_TOL if dot == "bf16x3" and dtype == F32 else GRAM_T0_TOL
    for name, g, w, jx in zip(("S", "C"), got, want, (S_j, C_j)):
        _held(name, g, w, jx, tol)
