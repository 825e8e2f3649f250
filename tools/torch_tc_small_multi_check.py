#!/usr/bin/env python3
"""Build-and-check of the high apply at X = 8..64 and the multi-term dual
apply on the tensor cores, on one CUDA card.

    python3 tools/torch_tc_small_multi_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_small_multi_check.py
    CHECK=0 ...        # times only
    TIMES=0 ...        # checks only; TIMES=quick: rows 2x, 8, 8f and 8x only
    MODELS=1 ...       # and the models' steps

Builds the libraries of csrc/high_apply_small.cu and csrc/dual_multi_apply.cu
(and csrc/high_apply.cu's, whose wrapper routes X >= 128) and prints the
registers and spills of their kernels; holds ``high_apply`` at X = 8, 16, 32
and 64 on views (2, X, 128, 128) with x f32 / bf16 / f16, in place, fresh and
into an accumulator of each storage it takes (conj), no run or one
multiplied first or after, in both dot modes, and ``dual_multi_apply`` with
T = 1, 2, 4 and 16 terms on views (4, 128, 128), x f32 / bf16 / f16, in
place, fresh and into an accumulator of each storage, in both dot modes, to
their plain versions (f32 planes within 1e-4 abs, 16-bit planes within 2
storage ulps); then times one launch (CUDA events, five launches after one)
at 2^29 amplitudes in the settings of PERF.md's rows 2x, 2y, 2yf, 2v', 2x',
2h and the f32 rows at X = 16 / 32 / 64 (``high_apply``), 8, 8s, 8f, 8v and
8x (``dual_multi_apply``), each f32 row beside the PyTorch call computing
the same function (``library``), and prints each row's bound (the larger
of its bytes at 3.35 TB/s and its tensor-core passes: tf32 at 495 TFLOP/s,
bf16 at 989). With MODELS=1 it also times one warm value_and_grad of
chip_smoke.py's [cnot29] model (HardwareEfficientAnsatz(29, 20, "cnot")) and
its forward, and of [grad29]'s (HardwareEfficientAnsatz(29, 100, "cz")), on
the same params (0.1 N(0, 1), seed 1234). With PARENT, a checkout of another
commit: its libraries build beside this one's, and its times are taken
before and after two runs of this one's, in the same process tree. Prints
the card's name and power limit; exits 1 if any check fails.
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
g = torch.Generator(device=dev).manual_seed(19)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
CHANGE_LIBRARIES = ("high_apply_small", "dual_multi_apply", "high_apply")
PARENT_LIBRARIES = ("high_apply", "high_apply_fwd16", "dual_multi_apply")
if not MODELS:  # the models launch every library
    _build.LIBRARIES = PARENT_LIBRARIES if ROLE.startswith("parent") else CHANGE_LIBRARIES
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops import planes as pl
from dqc_tpu_torch.ops.kernels.dual_multi_apply import (dual_multi_apply,
                                                        dual_multi_apply_plain)
from dqc_tpu_torch.ops.kernels.high_apply import high_apply, high_apply_plain

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
    for lib, ks in _build.kernel_resources(("high_apply_small_kernel",
                                            "dual_multi_apply_tc_kernel")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def unitary(X, T=None):
    shape = (X, X) if T is None else (T, X, X)
    q, _ = torch.linalg.qr(torch.complex(randn(*shape), randn(*shape)).to(torch.complex128))
    q = q.to(torch.complex64)
    return q.real.contiguous(), q.imag.contiguous()


def phases(*shape):
    z = torch.polar(torch.ones(shape, device=dev),
                    6.2832 * torch.rand(shape, generator=g, device=dev))
    return z.real.contiguous(), z.imag.contiguous()


def tables(a_rows):
    return (*phases(128, 128), *phases(a_rows, 128), *phases(a_rows, 128))


fails = []
worst = {"abs": 0.0, "ulps": 0.0, "n": 0}


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


if ROLE == "change" and CHECK:
    for X in (8, 16, 32, 64):
        shape = (2, X, 128, 128)
        E = unitary(X)
        tab = tables(2 * X)
        for xdt in STORES:
            for dot in ("f32", "bf16x3"):
                for run in (None, "first", "after"):
                    for form, ydt in forms(xdt):
                        xs = [st.store_as(randn(*shape), xdt) for _ in range(2)]
                        kw, acc = seed_kw(form, ydt, shape)
                        kw["dot_mode"] = dot
                        if run is not None:
                            kw.update(diag_tables=tab, diag_first=run == "first")
                        check_one(f"high X{X} {xdt} -> {ydt} {form} run {run} {dot}",
                                  high_apply, high_apply_plain, xs, E, kw, acc)
    shape = (4, 128, 128)
    for T in (1, 2, 4, 16):
        ops = (*unitary(128, T), *unitary(128, T))
        for xdt in STORES:
            for dot in ("f32", "bf16x3"):
                for form, ydt in forms(xdt):
                    if T == 16 and form != "acc":
                        continue
                    xs = [st.store_as(randn(*shape), xdt) for _ in range(2)]
                    kw, acc = seed_kw(form, ydt, shape)
                    kw["dot_mode"] = dot
                    check_one(f"multi T{T} {xdt} -> {ydt} {form} {dot}", dual_multi_apply,
                              dual_multi_apply_plain, xs, ops, kw, acc)
    print(f"[check] {worst['n']} variants against their plain versions; worst "
          f"{json.dumps(worst)}; {len(fails)} outside their bars", flush=True)

PEAK_HBM, PEAK_TF32, PEAK_BF16 = 3.35e12, 495e12, 989e12
AMPS = float(1 << 29)
CNOT = np.array(((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0)), np.complex64)
SPANS = ((13, 14), (20, 21), (27, 28))


def bound(bytes_moved, cmacs, x3, passes):
    """max(bytes over HBM, the mma passes' flops over their rate), ms."""
    flops = 8 * cmacs * passes
    return max(bytes_moved / PEAK_HBM, flops / (PEAK_BF16 if x3 else PEAK_TF32)) * 1e3


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


def passes(xdt, x3, run_first=False):
    """The mma passes a product on x stored as xdt runs: three, two where
    x's lo parts are zero in bf16x3 (bf16 x); in 3xTF32 16-bit x meets a
    three-part operator, still three."""
    return 2 if x3 and xdt == BF16 and not run_first else 3


# (row, X, x storage, y storage, form, run, dot) on views (1, X, 2^22 / X, 128)
HIGH_TIMED = (("2_f32", 16, F32, F32, "inplace", None, "f32"),
              ("2_f32", 32, F32, F32, "inplace", None, "f32"),
              ("2_f32", 64, F32, F32, "inplace", None, "f32"),
              ("2v'", 8, BF16, BF16, "inplace", "first", "f32"),
              ("2v'", 16, BF16, BF16, "inplace", "first", "f32"),
              ("2v'", 32, BF16, BF16, "inplace", "first", "f32"),
              ("2v'", 64, BF16, BF16, "inplace", "first", "f32"),
              ("2v'_seed", 8, BF16, BF16, "acc", None, "f32"),
              ("2v'_seed", 64, BF16, BF16, "acc", None, "f32"),
              ("2x'_f32", 8, F32, F32, "inplace", "first", "bf16x3"),
              ("2x'_f32_seed", 8, F32, F32, "acc", None, "bf16x3"),
              ("2x'_f32", 64, F32, F32, "inplace", "first", "bf16x3"),
              ("2x'_f32_seed", 64, F32, F32, "acc", None, "bf16x3"),
              ("2x'_bf16", 8, BF16, BF16, "inplace", "first", "bf16x3"),
              ("2x'_bf16_seed", 8, BF16, BF16, "acc", None, "bf16x3"),
              ("2x'_bf16", 64, BF16, BF16, "inplace", "first", "bf16x3"),
              ("2x'_bf16_seed", 64, BF16, BF16, "acc", None, "bf16x3"),
              ("2h_fresh", 8, F16, F16, "fresh", None, "f32"),
              ("2h_acc", 8, F16, F16, "acc", None, "f32"))
# (row, T, x storage, y storage, form, dot) on planes (2^15, 128, 128)
MULTI_TIMED = (("8", 2, F32, F32, "inplace", "f32"),
               ("8", 4, F32, F32, "inplace", "f32"),
               ("8s_acc", 4, F32, F32, "acc", "f32"),
               ("8s_fresh", 4, F32, F32, "fresh", "f32"),
               ("8f_f16", 2, F16, F16, "inplace", "f32"),
               ("8f_bf16", 2, BF16, BF16, "inplace", "f32"),
               ("8f_f16", 4, F16, F16, "inplace", "f32"),
               ("8f_seed_f16_acc", 4, F32, F16, "acc", "f32"),
               ("8f_seed_f16_fresh", 4, F32, F16, "fresh", "f32"),
               ("8f_seed_bf16_acc", 4, F32, BF16, "acc", "f32"),
               ("8v", 2, BF16, BF16, "inplace", "f32"),
               ("8v_seed", 4, BF16, BF16, "acc", "f32"),
               ("8x_f32", 2, F32, F32, "inplace", "bf16x3"),
               ("8x_bf16", 2, BF16, BF16, "inplace", "bf16x3"),
               ("8x_seed_bf16", 4, BF16, BF16, "acc", "bf16x3"))
QUICK = {"2x", "8", "8x_f32", "8f_f16"}


def record(out, bounds, key, t, b):
    out[key] = t
    bounds[key] = b


def times(tag):
    out, bounds = {}, {}
    quick = TIMES == "quick"
    # rows 2x, 2y, 2yf: the X = 8 span views of the CNOT ring, in place and
    # its seed (acc + conj(E x)) into f32 / f16 planes, beside matmul
    M4 = hermitian4()
    for pos in SPANS:
        for row, gate, ydt in (("2x", CNOT, F32), ("2y", M4.conj(), F32),
                               ("2yf", M4.conj(), F16)):
            if (quick and row not in QUICK) or (row == "2yf" and pos != SPANS[0]):
                continue
            kind, vshape, er, ei = pl.cross_span_operands(gate, pos, 29, dev)
            xs = [randn(*vshape) for _ in range(2)]
            A1, X, Mv, _ = vshape
            form = "inplace" if row == "2x" else "acc"
            key = f"high {row} span{pos[0]}"
            if row == "2x":
                t = ms(lambda: high_apply(*xs, er, ei))
            else:
                acc = tuple(st.store_as(randn(*vshape), ydt) for _ in range(2))
                t = ms(lambda: high_apply(*xs, er, ei, conj=True, acc=acc, alias=False))
            record(out, bounds, key, t, bound(io_bytes(F32, ydt, form), AMPS * X, False, 3))
            if tag == "change" and ydt == F32:
                ec = torch.complex(er, ei)
                x = torch.complex(*xs).view(A1, X, Mv * 128)
                if row == "2x":
                    lib = lambda: torch.matmul(ec, x)  # noqa: E731
                else:
                    a = torch.complex(*acc).view(A1, X, Mv * 128)
                    lib = lambda: a + torch.matmul(ec, x).conj()  # noqa: E731
                out[f"{key} library"] = ms(lib)
                x = a = lib = None
            xs = acc = None
            torch.cuda.empty_cache()
    for row, X, xdt, ydt, form, run, dot in HIGH_TIMED:
        if quick:
            break
        vshape = (1, X, (1 << 22) // X, 128)
        E = unitary(X)
        xs = [st.store_as(randn(*vshape), xdt) for _ in range(2)]
        kw, acc = seed_kw(form, ydt, vshape)
        kw["dot_mode"] = dot
        if run is not None:
            kw.update(diag_tables=tables(X * vshape[2] // 128), diag_first=run == "first")
        key = f"high {row} X{X}"
        x3 = dot == "bf16x3"
        record(out, bounds, key, ms(lambda: high_apply(*xs, *E, **kw)),
               bound(io_bytes(xdt, ydt, form), AMPS * X, x3, passes(xdt, x3, run == "first")))
        if tag == "change" and xdt == F32 and dot == "f32" and run is None:
            ec = torch.complex(*E)
            x = torch.complex(*xs).view(1, X, -1)
            out[f"{key} library"] = ms(lambda: torch.matmul(ec, x))
            x = None
        xs = acc = kw = None
        torch.cuda.empty_cache()
    A29 = 1 << 15
    for row, T, xdt, ydt, form, dot in MULTI_TIMED:
        if quick and row not in QUICK:
            continue
        shape = (A29, 128, 128)
        el, em = unitary(128, T), unitary(128, T)
        xs = [st.store_as(randn(*shape), xdt) for _ in range(2)]
        kw, acc = seed_kw(form, ydt, shape)
        kw["dot_mode"] = dot
        key = f"multi {row} T{T}"
        x3 = dot == "bf16x3"
        b = max(bound(io_bytes(xdt, ydt, form), 0, x3, 3),
                bound(0, AMPS * 128 * T, x3, passes(xdt, x3))
                + bound(0, AMPS * 128 * T, x3, 3))
        record(out, bounds, key, ms(lambda: dual_multi_apply(*xs, *el, *em, **kw)), b)
        if tag == "change" and xdt == F32 and ydt == F32 and dot == "f32":
            x = torch.complex(*xs)
            elc, emc = torch.complex(*el), torch.complex(*em)
            if form == "acc":
                a = torch.complex(*acc)
                lib = lambda: a + torch.einsum("tsk,akm,tlm->asl", emc, x, elc).conj()  # noqa: E731
            elif form == "fresh":
                lib = lambda: torch.einsum("tsk,akm,tlm->asl", emc, x, elc).conj()  # noqa: E731
            else:
                lib = lambda: torch.einsum("tsk,akm,tlm->asl", emc, x, elc)  # noqa: E731
            out[f"{key} library"] = ms(lib, reps=3)
            x = a = lib = None
        xs = acc = kw = None
        torch.cuda.empty_cache()
    for k, v in out.items():
        extra = (f" (bound {bounds[k]:.3f} ms, {100 * bounds[k] / v:.1f}%)"
                 if k in bounds else "")
        print(f"[time] {tag} {k}: {v:.3f} ms{extra}", flush=True)
    if MODELS:
        model_times(tag)
    return out


def model_times(tag):
    """One warm value_and_grad (and forward) of the [cnot29] and [grad29]
    models, in seconds."""
    from dqc_tpu_torch.models.hardware_efficient import HardwareEfficientAnsatz
    for name, layers, ent in (("cnot29", 20, "cnot"), ("grad29", 100, "cz")):
        model = HardwareEfficientAnsatz(29, layers, entangler=ent)
        params = model.init_params(torch.Generator().manual_seed(1234))

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
