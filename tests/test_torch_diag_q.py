"""The diagonal run's adjoint with Q (``csrc/diag.cu``
``diag_backward_q_kernel``), on the CPU.

No CUDA kernel runs here; these tests hold what surrounds it and its
arithmetic:

* what ``diag_backward(with_q=True)`` hands its library entry
  ``dqc_diag_backward_q``, on meta planes with the entry replaced by a
  recorder, for F stored f32 / bf16 and B f32 / bf16 / f16: the grid (one
  persistent block an SM, at most one a slab), the storage kinds, the
  scratch (one whole Qsl slot a block) and the outputs' shapes, and that
  each launch counts ``with_q`` and its storage modes;
* the kernel's summation order written out in float32 (:func:`kernel_q`):
  each block's Qsl partial over its slabs in walk order, the slots added
  in block order as ``common.cuh``'s ``adjoint_reduce_kernel`` adds them,
  each row's Qas as its lanes' four-term sums ((q0 + q1) + q2) + q3 over a
  butterfly of xor offsets 16, 8, 4, 2, 1, and each column's Qal as the
  16 warps' partials (rows s = w + 16 k summed in k order) added in warp
  order; with the updated planes, against the JAX package's
  ``diag_backward_planes`` in interpret mode at A = 4 and 16, with the
  grid the wrapper takes and with three blocks (a walk of five or six
  slabs a block), within chip_smoke.py's bars: f32 planes within
  ``DIAG_TOL``, 16-bit planes within their storage ulps, Q within
  ``_storage.gram_tolerance`` of each output's largest entry.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqc_tpu.ops.pallas import common as cm
from dqc_tpu.ops.pallas.diag import diag_backward_planes

from dqc_tpu_torch.ops import kernels as tk
from dqc_tpu_torch.ops.kernels import _storage as st

from chip_smoke import DIAG_TOL, FWD16_ULPS, STORE_ULPS
from test_torch_tc_adjoint import recorded  # noqa: F401  (the fixture)

tdiag = importlib.import_module("dqc_tpu_torch.ops.kernels.diag")

torch.set_num_threads(2)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
SMS = 132          # the recorder's SM count (an H100's)
WARPS = 16         # the kernel's 512 threads; warp w owns rows w + 16 k
ROWS = 128 // WARPS


# ---------------------------------------------------------------------------
# What the wrapper hands its entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A", [4, 300])
@pytest.mark.parametrize("fdt", [F32, BF16], ids=["F_f32", "F_bf16"])
@pytest.mark.parametrize("bdt", [F32, BF16, F16], ids=["B_f32", "B_bf16", "B_f16"])
def test_hand_off(recorded, monkeypatch, A, fdt, bdt):
    calls, _ = recorded
    made = []

    def buffers(A_, dev):
        out = q_buffers(A_, dev)
        made.append(out)
        return out

    q_buffers = tdiag._q_buffers
    monkeypatch.setattr(tdiag, "_q_buffers", buffers)
    f = torch.empty((A, 128, 128), dtype=fdt, device="meta")
    b = torch.empty((A, 128, 128), dtype=bdt, device="meta")
    tabs = [torch.empty(shape, device="meta")
            for shape in [(128, 128)] * 2 + [(A, 128)] * 4]
    out = tk.diag_backward(f, f, b, b, *tabs, *tabs, with_q=True)

    assert [(lib, fn) for lib, fn, _ in calls] == [("diag", "dqc_diag_backward_q")]
    args = calls[0][2]
    nblk, rows, part, qsl = made[0]
    assert nblk == min(A, SMS)
    assert args[22:26] == (A, nblk, st.storage_kind(bdt), st.storage_kind(fdt))
    assert rows.shape == (4, A, 128) and rows.dtype == F32
    assert part.shape == (nblk, 2, 128, 128) and part.dtype == F32
    assert qsl.shape == (2, 128, 128) and qsl.dtype == F32
    assert [tuple(t.shape) for t in out] == [(A, 128, 128)] * 4 + [(128, 128)] * 2 + [(A, 128)] * 4
    assert all(o is p for o, p in zip(out[:4], (f, f, b, b)))
    counts = {k: v for k, v in tk.launch_counts().items() if v}
    want = {"diag_backward": 1, "diag_backward[with_q]": 1}
    if bdt != F32:
        want["diag_backward[" + ("bf16" if bdt == BF16 else "f16") + "]"] = 1
    if fdt == BF16:
        want["diag_backward[fwd_bf16]"] = 1
    assert counts == want


# ---------------------------------------------------------------------------
# The kernel's summation order
# ---------------------------------------------------------------------------

def _seq(x, axis):
    """The sum over ``axis`` of float32 ``x``, one term after another from
    zero."""
    x = np.moveaxis(x, axis, 0)
    t = np.zeros(x.shape[1:], np.float32)
    for term in x:
        t = t + term
    return t


def _lanes(p):
    """The butterfly over the last axis (32 lanes): lane t with t + 16,
    then with t + 8, ... ."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def kernel_q(qr, qi, nblk):
    """(Qsl, Qas, Qal), each as (re, im) float32, of Q = qr + i qi (A,
    128, 128) in the order the kernel and its slot sum add them on a grid
    of ``nblk`` blocks."""
    A = qr.shape[0]
    out = []
    for q in (qr, qi):
        slots = np.stack([_seq(q[b::nblk], 0) for b in range(nblk)])
        part = np.stack([_seq(slots[y::32], 0) if y < nblk
                         else np.zeros((128, 128), np.float32) for y in range(32)])
        lane4 = q.reshape(A, 128, 32, 4)
        lane4 = ((lane4[..., 0] + lane4[..., 1]) + lane4[..., 2]) + lane4[..., 3]
        cols = _seq(q.reshape(A, ROWS, WARPS, 128), 1)    # s = 16 k + w
        out.append((_seq(part, 0), _lanes(lane4), _seq(cols, 1)))
    return [(re, im) for re, im in zip(*out)]


def _phases(rng, shape):
    z = np.exp(2j * np.pi * rng.random(shape))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _tables(rng, A):
    return (*_phases(rng, (128, 128)), *_phases(rng, (A, 128)), *_phases(rng, (A, 128)))


def _diag(t):
    tsl, tas, tal = (t[k] + 1j * t[k + 1] for k in (0, 2, 4))
    return ((tas[:, :, None] * tal[:, None, :]) * tsl).astype(np.complex64)


STORAGES = {"f32": (F32, F32), "bf16": (BF16, BF16), "f16": (F32, F16)}


def _stored(x, dt):
    """float32 ``x`` as the JAX package stores it and as the port does."""
    t = st.store_as(torch.from_numpy(x), dt)
    if dt == F32:
        return jnp.asarray(x), t
    if dt == BF16:
        return jnp.asarray(x).astype(jnp.bfloat16), t
    return cm.store_as(jnp.asarray(x), jnp.uint16), t


@functools.lru_cache(maxsize=None)
def _case(A, storage):
    """The inputs (the port's stored planes and the tables) and the JAX
    kernel's outputs, decoded to float32."""
    fdt, bdt = STORAGES[storage]
    rng = np.random.default_rng(2100 + 10 * A + len(storage))
    raw = [rng.standard_normal((A, 128, 128)).astype(np.float32) * s
           for s in (1.0, 1.0, 0.5, 0.5)]
    stored = [_stored(x, dt) for x, dt in zip(raw, (fdt, fdt, bdt, bdt))]
    tabs = _tables(rng, A), _tables(rng, A)
    want = diag_backward_planes(*(j for j, _ in stored),
                                *(jnp.asarray(t) for t in tabs[0] + tabs[1]),
                                with_q=True, interpret=True)
    want = [torch.from_numpy(np.array(cm.f32_of(w), dtype=np.float32)) for w in want]
    return [t for _, t in stored], tabs, want


def _planes_held(case, got, want, dt):
    if dt == F32:
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        assert err <= DIAG_TOL, f"{case}: {err:.3e} abs"
    else:
        ulps = st.ulps_apart(got, want, dt)
        bar = FWD16_ULPS if dt == BF16 else STORE_ULPS
        assert ulps <= bar, f"{case}: {ulps:.2f} {dt} ulps"


@pytest.mark.parametrize("grid", ["wrapper", "three"])
@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("A", [4, 16])
def test_summation_order_matches_pallas(A, storage, grid):
    fdt, bdt = STORAGES[storage]
    planes, tabs, want = _case(A, storage)
    nblk = min(A, SMS) if grid == "wrapper" else 3
    fr, fi, br, bi = (st.f32_of(p).numpy() for p in planes)
    F, B = fr + 1j * fi, br + 1j * bi
    qr = br * fr - bi * fi
    qi = br * fi + bi * fr
    assert qr.dtype == np.float32
    case = f"A = {A}, {storage}, {nblk} blocks"
    for k, (x, d, dt) in enumerate(((F, _diag(tabs[0]), fdt), (B, _diag(tabs[1]), bdt))):
        y = (x.astype(np.complex64) * d).astype(np.complex64)
        got = [st.store_as(torch.from_numpy(np.ascontiguousarray(p, np.float32)), dt)
               for p in (y.real, y.imag)]
        _planes_held(f"{case} plane {k}", got, want[2 * k:2 * k + 2], dt)
    tol = st.gram_tolerance(bdt)
    for name, (re, im), wr, wi in zip(("Qsl", "Qas", "Qal"), kernel_q(qr, qi, nblk),
                                      want[4::2], want[5::2]):
        for got, w in ((re, wr), (im, wi)):
            assert got.shape == tuple(w.shape)
            rel = (torch.from_numpy(got) - w).abs().max().item() / w.abs().max().item()
            assert rel <= tol, f"{case} {name}: {rel:.3e} of its largest entry"
