#!/usr/bin/env python3
"""Build-and-check of the high multi-term apply on the dual multi-term
kernel and of the Gram at X = 8..64 on the tensor cores, on one CUDA card.

    python3 tools/torch_tc_multi_gram_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_multi_gram_check.py
    CHECK=0 ...        # times only
    TIMES=0 ...        # checks only; TIMES=quick: rows 9, 9x and the Gram at X = 8, 64
    MODELS=1 ...       # and the models' steps

Builds the library of csrc/dual_multi_apply.cu (the C entries
``dqc_dual_multi_apply`` and ``dqc_high_multi_apply``) and of csrc/gram.cu
and prints the registers and spills of their kernels; holds
``high_multi_apply`` at X = 8, 16, 32, 64 and 128 with T = 2 and 4 terms on
views (2, X, 2 (128 / X), 128), x f32 / bf16 / f16, in place, fresh and into
an accumulator of each storage it takes (conj), in both dot modes,
``dual_multi_apply`` with T = 1, 2 and 4 on planes (4, 128, 128) the same
way, and ``gram`` at X = 8, 16, 32 and 64 on f32 and bf16 planes in both
dot modes on views (8, X, 8192) and (1, X, 2^26 / X), to their plain
versions (f32 planes within 1e-4 abs, 16-bit planes within 2 storage ulps,
(S, C) within 1e-5 of their largest entry, 4e-5 in bf16x3 on f32 planes).
Then times one launch (CUDA events, five launches after one) at 2^29
amplitudes: PERF.md's rows 9, 9s, 9f, 9v and 9x (the closing CNOT's X = 8
span view (1, 8, 2^19, 128): its T = 2 terms in place, the T = 4 lane
slices of a 4 x 4 Hermitian as seeds), the high multi-term apply at X =
16, 32, 64 and 128 with T = 4 random terms on views (1, X, 2^22 / X, 128),
row 8 at T = 2 and 4 (planes (2^15, 128, 128)), and the Gram at X = 8, 16,
32 and 64 on views (1, X, 2^29 / X) (rows 5, 5v' and 5x'); each f32 row
beside the PyTorch call computing the same function (``library``: one
``einsum``), and each row's bound (the larger of its bytes at 3.35 TB/s and
its tensor-core passes: tf32 at 495 TFLOP/s, bf16 at 989; the high apply's
128 + X complex multiply-adds a term, the Gram's 2 X + 1 real ones). With
MODELS=1 it also times one warm value_and_grad of chip_smoke.py's [cnot29]
model (HardwareEfficientAnsatz(29, 20, "cnot")) and its forward, the same
under "f16" and "bf16" storage ([cnot29_f16], [cnot29_bf16]), its 2-layer
form under "bf16" with the forward bf16x3 ([cnot29_x3]), and [grad29]'s
(HardwareEfficientAnsatz(29, 100, "cz")), on the same params (0.1 N(0, 1),
seed 1234). With PARENT, a checkout of another commit: its libraries build
beside this one's (a tree from before the high multi-term apply moved onto
the dual kernel builds csrc/high_multi_apply.cu and
csrc/high_multi_apply_x3.cu), and its times are taken before and after two
runs of this one's, in the same process tree. Prints the card's name and
power limit; exits 1 if any check fails.
"""
import json, os, subprocess, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.environ.get("ROOT") or os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import numpy as np
import torch
from dqc_tpu_torch.ops.kernels import _build, _storage as st

ROLE = os.environ.get("ROLE", "change")
PARENT = os.environ.get("PARENT")
CHECK = os.environ.get("CHECK", "1") == "1"
TIMES = os.environ.get("TIMES", "1")
MODELS = os.environ.get("MODELS", "0") == "1"
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(20)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
if not MODELS:  # the models launch every library
    _build.LIBRARIES = tuple(n for n in ("dual_multi_apply", "gram", "high_multi_apply",
                                         "high_multi_apply_x3")
                             if (_build.CSRC_DIR / f"{n}.cu").exists())
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s {json.dumps(_build.build_seconds)}",
          flush=True)
    sys.exit(0)
from dqc_tpu_torch import config
from dqc_tpu_torch.ops import planes as pl
from dqc_tpu_torch.ops.kernels.dual_multi_apply import (dual_multi_apply,
                                                        dual_multi_apply_plain)
from dqc_tpu_torch.ops.kernels.gram import gram, gram_plain
from dqc_tpu_torch.ops.kernels.high_multi_apply import (high_multi_apply,
                                                        high_multi_apply_plain)

pb = None
if ROLE == "change" and PARENT:
    pb = subprocess.Popen([sys.executable, __file__],
                          env={**os.environ, "ROLE": "parent-build", "ROOT": PARENT})
_build.build_all()
print(f"[{ROLE} build] {time.perf_counter() - t0:.1f} s {json.dumps(_build.build_seconds)}",
      flush=True)
if ROLE == "change":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    for lib, ks in _build.kernel_resources(("dual_multi_apply_tc_kernel",
                                            "gram_tc_small_kernel")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def unitary(X, T=None):
    shape = (X, X) if T is None else (T, X, X)
    q, _ = torch.linalg.qr(torch.complex(randn(*shape), randn(*shape)).to(torch.complex128))
    q = q.to(torch.complex64)
    return q.real.contiguous(), q.imag.contiguous()


fails = []
worst = {"abs": 0.0, "ulps": 0.0, "rel": 0.0, "n": 0}


def held(name, got, want):
    if got[0].dtype != want[0].dtype:
        fails.append((name, "dtype", str(got[0].dtype)))
        return None
    worst["n"] += 1
    if got[0].dtype == F32:
        e = max((a - b).abs().max().item() for a, b in zip(got, want))
        worst["abs"] = max(worst["abs"], e)
        if not e <= 1e-4:
            fails.append((name, e))
        return {"abs": e}
    u = st.ulps_apart(got, want, got[0].dtype)
    worst["ulps"] = max(worst["ulps"], u)
    if not u <= 2:
        fails.append((name, u))
    return {"ulps": u}


def ms(fn, reps=5):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps


STORES = {F32: (F32, BF16, F16), BF16: (BF16,), F16: (F16,)}


def forms(xdt):
    return [("inplace", xdt)] + [(f, y) for f in ("fresh", "acc") for y in STORES[xdt]]


def seed_kw(form, ydt, shape):
    """The keywords of a seed form, and the accumulator planes (or None)."""
    if form == "fresh":
        return dict(conj=True, alias=False, out_dtype=ydt), None
    if form == "acc":
        acc = tuple(st.store_as(0.5 * randn(*shape), ydt) for _ in range(2))
        return dict(conj=True, acc=acc, alias=False), acc
    return {}, None


def check_one(tag, fn, plain, xs, ops, kw, acc):
    want = plain(*xs, *ops, **kw)
    if acc is not None:
        kw = dict(kw, acc=tuple(a.clone() for a in acc))
    got = fn(*[x.clone() for x in xs], *ops, **kw)
    torch.cuda.synchronize()
    err = held(tag, got, want)
    if fails and fails[-1][0] == tag:
        print(f"[check] FAIL {tag} {json.dumps(err)}", flush=True)


def check_gram(tag, xs, dot, tol):
    want = gram_plain(*xs, dot)
    got = gram(*xs, dot_mode=dot)
    torch.cuda.synchronize()
    rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want))
    worst["rel"] = max(worst["rel"], rel)
    worst["n"] += 1
    if not rel <= tol:
        fails.append((tag, rel))
        print(f"[check] FAIL {tag} {rel:.3e}", flush=True)


if ROLE == "change" and CHECK:
    for X in (8, 16, 32, 64, 128):
        shape = (2, X, 2 * (128 // X), 128)
        for T in (2, 4):
            ops = (*unitary(X, T), *unitary(128, T))
            for xdt in STORES:
                for dot in ("f32", "bf16x3"):
                    for form, ydt in forms(xdt):
                        xs = [st.store_as(randn(*shape), xdt) for _ in range(2)]
                        kw, acc = seed_kw(form, ydt, shape)
                        kw["dot_mode"] = dot
                        check_one(f"high_multi X{X} T{T} {xdt} -> {ydt} {form} {dot}",
                                  high_multi_apply, high_multi_apply_plain, xs, ops, kw, acc)
    shape = (4, 128, 128)
    for T in (1, 2, 4):
        ops = (*unitary(128, T), *unitary(128, T))
        for xdt in STORES:
            for dot in ("f32", "bf16x3"):
                for form, ydt in forms(xdt):
                    xs = [st.store_as(randn(*shape), xdt) for _ in range(2)]
                    kw, acc = seed_kw(form, ydt, shape)
                    kw["dot_mode"] = dot
                    check_one(f"dual_multi T{T} {xdt} -> {ydt} {form} {dot}",
                              dual_multi_apply, dual_multi_apply_plain, xs, ops, kw, acc)
    for X in (8, 16, 32, 64):
        for view in ((8, X, 8192), (1, X, (1 << 26) // X)):
            for fdt in (F32, BF16):
                for dot in ("f32", "bf16x3"):
                    xs = [st.store_as(randn(*view), fdt) for _ in range(2)]
                    tol = 4e-5 if (fdt, dot) == (F32, "bf16x3") else 1e-5
                    check_gram(f"gram {view} {fdt} {dot}", xs, dot, tol)
                    xs = None
    print(f"[check] {worst['n']} variants against their plain versions; worst "
          f"{json.dumps(worst)}; {len(fails)} outside their bars", flush=True)

PEAK_HBM, PEAK_TF32, PEAK_BF16 = 3.35e12, 495e12, 989e12
AMPS = float(1 << 29)
CNOT = np.array(((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0)), np.complex64)


def tc_ms(cmacs, x3, passes):
    """The mma passes' flops over their rate, ms."""
    return 8 * cmacs * passes / (PEAK_BF16 if x3 else PEAK_TF32) * 1e3


def nbytes(dt):
    return 4 if dt == F32 else 2


def hermitian4():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    return (0.25 * (z + z.conj().T)).astype(np.complex64)


def io_bytes(xdt, ydt, form):
    """Bytes a launch moves: x read, y written, the accumulator read."""
    per = 2 * AMPS
    return per * (nbytes(xdt) + nbytes(ydt) * (2 if form == "acc" else 1))


def lane_passes(xdt, x3):
    """The mma passes of the lane product on x stored as xdt: two where x's
    lo parts are zero in bf16x3 (bf16 x); in 3xTF32 16-bit x meets a
    three-part El_t, still three."""
    return 2 if x3 and xdt == BF16 else 3


def multi_bound(X, T, xdt, ydt, form, x3):
    """A multi-term apply's bound: its bytes, or its lane product (128
    complex multiply-adds a term) and its group product (X) on the tensor
    cores, the larger."""
    return max(io_bytes(xdt, ydt, form) / PEAK_HBM * 1e3,
               tc_ms(AMPS * 128 * T, x3, lane_passes(xdt, x3))
               + tc_ms(AMPS * X * T, x3, 3))


# (row, gate, T, x storage, y storage, form, dot) on the closing edge's X = 8
# span view (1, 8, 2^19, 128)
SPAN_TIMED = (("9", "cnot", F32, F32, "inplace", "f32"),
              ("9s_acc", "seed", F32, F32, "acc", "f32"),
              ("9s_fresh", "seed", F32, F32, "fresh", "f32"),
              ("9f_f16", "cnot", F16, F16, "inplace", "f32"),
              ("9f_bf16", "cnot", BF16, BF16, "inplace", "f32"),
              ("9f_seed_f16_acc", "seed", F32, F16, "acc", "f32"),
              ("9f_seed_f16_fresh", "seed", F32, F16, "fresh", "f32"),
              ("9f_seed_bf16_acc", "seed", F32, BF16, "acc", "f32"),
              ("9f_seed_bf16_fresh", "seed", F32, BF16, "fresh", "f32"),
              ("9v_seed", "seed", BF16, BF16, "acc", "f32"),
              ("9x_f32", "cnot", F32, F32, "inplace", "bf16x3"),
              ("9x_bf16", "cnot", BF16, BF16, "inplace", "bf16x3"),
              ("9x_seed_bf16", "seed", BF16, BF16, "acc", "bf16x3"))
QUICK = {"9", "9x_f32"}


def record(out, bounds, key, t, b):
    out[key] = t
    bounds[key] = b


def times(tag):
    out, bounds = {}, {}
    quick = TIMES == "quick"
    M4 = hermitian4()
    for row, gate, xdt, ydt, form, dot in SPAN_TIMED:
        if quick and row not in QUICK:
            continue
        kind, vshape, *ops = pl.cross_span_operands(CNOT if gate == "cnot" else M4.conj(),
                                                    (0, 28), 29, dev)
        T = ops[0].shape[0]
        xs = [st.store_as(randn(*vshape), xdt) for _ in range(2)]
        kw, acc = seed_kw(form, ydt, vshape)
        kw["dot_mode"] = dot
        key = f"high_multi {row} X8 T{T}"
        x3 = dot == "bf16x3"
        record(out, bounds, key, ms(lambda: high_multi_apply(*xs, *ops, **kw)),
               multi_bound(8, T, xdt, ydt, form, x3))
        if tag == "change" and xdt == ydt == F32 and dot == "f32":
            out[f"{key} library"] = ms(high_multi_library(xs, ops, form, acc), reps=3)
        xs = acc = kw = None
        torch.cuda.empty_cache()
    for X in (16, 32, 64, 128):
        if quick:
            break
        vshape = (1, X, (1 << 22) // X, 128)
        ops = (*unitary(X, 4), *unitary(128, 4))
        xs = [randn(*vshape) for _ in range(2)]
        key = f"high_multi 9n X{X} T4"
        record(out, bounds, key, ms(lambda: high_multi_apply(*xs, *ops)),
               multi_bound(X, 4, F32, F32, "inplace", False))
        if tag == "change":
            out[f"{key} library"] = ms(high_multi_library(xs, ops, "inplace", None), reps=3)
        xs = None
        torch.cuda.empty_cache()
    for T in (2, 4):
        if quick:
            break
        shape = (1 << 15, 128, 128)
        ops = (*unitary(128, T), *unitary(128, T))
        xs = [randn(*shape) for _ in range(2)]
        record(out, bounds, f"dual_multi 8 T{T}", ms(lambda: dual_multi_apply(*xs, *ops)),
               multi_bound(128, T, F32, F32, "inplace", False))
        xs = None
        torch.cuda.empty_cache()
    for X in (8, 16, 32, 64):
        if quick and X not in (8, 64):
            continue
        view = (1, X, (1 << 29) // X)
        for row, fdt, dot in (("5", F32, "f32"), ("5v'", BF16, "f32"),
                              ("5x'", F32, "bf16x3")):
            xs = [st.store_as(randn(*view), fdt) for _ in range(2)]
            key = f"gram {row} X{X}"
            x3 = dot == "bf16x3" or fdt == BF16
            b = max(2 * AMPS * nbytes(fdt) / PEAK_HBM * 1e3,
                    tc_ms(AMPS * (2 * X + 1) / 4, x3, 1 if fdt == BF16 else 3))
            record(out, bounds, key, ms(lambda: gram(*xs, dot_mode=dot)), b)
            if tag == "change" and fdt == F32 and dot == "f32":
                x = torch.complex(*xs)
                out[f"{key} library"] = ms(lambda: torch.einsum("pxq,pyq->xy", x, x.conj()))
                x = None
            xs = None
            torch.cuda.empty_cache()
    for k, v in out.items():
        extra = (f" (bound {bounds[k]:.3f} ms, {100 * bounds[k] / v:.1f}%)"
                 if k in bounds else "")
        print(f"[time] {tag} {k}: {v:.3f} ms{extra}", flush=True)
    if MODELS:
        model_times(tag)
    return out


def high_multi_library(xs, ops, form, acc):
    """One einsum computing the high multi-term apply (its seed: conj and
    the accumulator's add)."""
    x = torch.complex(*xs)
    ec, elc = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
    if form == "inplace":
        return lambda: torch.einsum("txy,iymk,tlk->ixml", ec, x, elc)
    a = torch.complex(*acc) if acc is not None else None
    if a is None:
        return lambda: torch.einsum("txy,iymk,tlk->ixml", ec, x, elc).conj()
    return lambda: a + torch.einsum("txy,iymk,tlk->ixml", ec, x, elc).conj()


def model_times(tag):
    """One warm value_and_grad (and forward) of the CNOT ring's models and
    of [grad29], in seconds."""
    from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz
    for name, layers, ent, storage, dot in (
            ("cnot29", 20, "cnot", "f32", "f32"), ("cnot29_f16", 20, "cnot", "f16", "f32"),
            ("cnot29_bf16", 20, "cnot", "bf16", "f32"),
            ("cnot29_x3", 2, "cnot", "bf16", "bf16x3"), ("grad29", 100, "cz", "f32", "f32")):
        model = HardwareEfficientAnsatz(29, layers, entangler=ent)
        params = model.init_params(torch.Generator().manual_seed(1234))
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            def step():
                q = params.detach().clone().requires_grad_(True)
                model.magnetization(q).backward()
                torch.cuda.synchronize()

            step()
            t0 = time.perf_counter()
            step()
            vg = time.perf_counter() - t0
            msg = f"[model] {tag} {name} value_and_grad {vg:.4f} s"
            if name == "cnot29":
                t0 = time.perf_counter()
                model.magnetization(params).item()
                msg += f", forward {time.perf_counter() - t0:.4f} s"
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")
        print(msg, flush=True)
        del model, params
        torch.cuda.empty_cache()


def parent_times():
    return subprocess.run([sys.executable, __file__],
                          env={**os.environ, "ROLE": "parent", "ROOT": PARENT})


if ROLE == "parent":
    times("parent")
    sys.exit(0)
if pb is not None:
    pb.wait()
if TIMES != "0":
    if pb is not None:
        parent_times()
    times("change")
    if pb is not None:
        times("change2")
        parent_times()
print(json.dumps({"fails": fails}), flush=True)
sys.exit(1 if fails else 0)
