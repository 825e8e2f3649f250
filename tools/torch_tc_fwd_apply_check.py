#!/usr/bin/env python3
"""Build-and-check of the dual apply and the merged-top apply on the tensor
cores, on one CUDA card.

    python3 tools/torch_tc_fwd_apply_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_fwd_apply_check.py
    CHECK=0 ...   # times only

Builds the two libraries (csrc/dual_apply.cu and csrc/merged_fact_apply.cu on
csrc/tc_adjoint.cuh) and the high apply's, and prints the registers and
spills of the new kernels; holds ``dual_apply`` on views (4, 128, 128) with x
f32 / bf16 / f16, in place, fresh and into an accumulator of each storage it
takes (conj), no run or one multiplied first or after, in both dot modes, and
``merged_fact_apply`` at Xt = 2 and 4 on views (1, Xt 128, 16, 128), f32 and
bf16 planes, both dot modes, to their plain versions (f32 planes within 1e-4
abs, 16-bit planes within 2 storage ulps); then times one launch (CUDA events,
five launches after one) at 2^29 amplitudes in the settings of PERF.md's rows
1, 1s, 1f, 1v, 1x, 1h, 6, 6v, 6x, and of rows 2x and 2y (the high apply on
the CNOT ring's X = 8 span views, in place and its seed; csrc/high_apply.cu,
unchanged), each f32 row beside the PyTorch calls computing the same
function (``library``). With PARENT, a checkout of another commit: its
libraries build beside this one's, and its times are taken before and after
two runs of this one's, in the same process tree. Prints the card's name and
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
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(13)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
_build.LIBRARIES = ("dual_apply", "merged_fact_apply", "high_apply")
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops import planes as pl
from dqc_tpu_torch.ops.kernels.dual_apply import dual_apply, dual_apply_plain
from dqc_tpu_torch.ops.kernels.high_apply import high_apply
from dqc_tpu_torch.ops.kernels.merged_fact_apply import (merged_fact_apply,
                                                         merged_fact_apply_plain)

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
    for lib, ks in _build.kernel_resources(("dual_apply_tc_kernel", "dual_load_slab",
                                            "dual_store_slab", "merged_fact_apply_tc_kernel",
                                            "merged_load_top", "tc_op_tile",
                                            "tc_load_tiles", "tc_store_tile")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def unitary(X):
    q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X)).to(torch.complex128))
    q = q.to(torch.complex64)
    return q.real.contiguous(), q.imag.contiguous()


def phases(*shape):
    z = torch.polar(torch.ones(shape, device=dev),
                    6.2832 * torch.rand(shape, generator=g, device=dev))
    return z.real.contiguous(), z.imag.contiguous()


def tables(a_rows):
    return (*phases(128, 128), *phases(a_rows, 128), *phases(a_rows, 128))


fails = []


def held(name, got, want):
    if got[0].dtype != want[0].dtype:
        fails.append((name, "dtype", str(got[0].dtype)))
        return None
    if got[0].dtype == F32:
        e = max((a - b).abs().max().item() for a, b in zip(got, want))
        if e > 1e-4:
            fails.append((name, e))
        return {"abs": e}
    u = st.ulps_apart(got, want, got[0].dtype)
    if u > 2:
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

if ROLE == "change" and CHECK:
    A = 4
    ops = (*unitary(128), *unitary(128))
    tab = tables(A)
    for xdt, ydts in STORES.items():
        for dot in ("f32", "bf16x3"):
            for run in (None, "first", "after"):
                rkw = dict(dot_mode=dot)
                if run is not None:
                    rkw.update(diag_tables=tab, diag_first=run == "first")
                for form, ydt in [("inplace", xdt)] + [(f, y) for f in ("fresh", "acc")
                                                      for y in ydts]:
                    xs = [st.store_as(randn(A, 128, 128), xdt) for _ in range(2)]
                    kw = dict(rkw)
                    if form == "fresh":
                        kw.update(conj=True, alias=False, out_dtype=ydt)
                    elif form == "acc":
                        acc = [st.store_as(0.5 * randn(A, 128, 128), ydt) for _ in range(2)]
                        kw.update(conj=True, acc=tuple(acc), alias=False)
                    want = dual_apply_plain(*xs, *ops, **kw)
                    if form == "acc":
                        kw["acc"] = tuple(a.clone() for a in acc)
                    got = dual_apply(*[x.clone() for x in xs], *ops, **kw)
                    torch.cuda.synchronize()
                    tag = f"dual {xdt} -> {ydt} {form} run {run} {dot}"
                    print(f"[check] {tag} {json.dumps(held(tag, got, want))}", flush=True)
    for xt in (2, 4):
        shape = (1, xt * 128, 16, 128)
        mops = (*unitary(128), *unitary(xt))
        for fdt in (F32, BF16):
            for dot in ("f32", "bf16x3"):
                xs = [st.store_as(randn(*shape), fdt) for _ in range(2)]
                want = merged_fact_apply_plain(*xs, *mops, x_top=xt, dot_mode=dot)
                got = merged_fact_apply(*[x.clone() for x in xs], *mops, x_top=xt,
                                        dot_mode=dot)
                torch.cuda.synchronize()
                tag = f"merged Xt{xt} {fdt} {dot}"
                print(f"[check] {tag} {json.dumps(held(tag, got, want))}", flush=True)

# the rows at 2^29 amplitudes: (name, x storage, y storage, form, run, dot)
A29 = 1 << 15
DUAL_TIMED = (("1", F32, F32, "inplace", "first", "f32"),
              ("1_norun", F32, F32, "inplace", None, "f32"),
              ("1s", F32, F32, "acc", None, "f32"),
              ("1f_acc_f16", F32, F16, "acc", None, "f32"),
              ("1f_acc_bf16", F32, BF16, "acc", None, "f32"),
              ("1f_fresh_f16", F32, F16, "fresh", None, "f32"),
              ("1v", BF16, BF16, "inplace", "first", "f32"),
              ("1v_seed", BF16, BF16, "acc", None, "f32"),
              ("1x_f32", F32, F32, "inplace", "first", "bf16x3"),
              ("1x_bf16", BF16, BF16, "inplace", "first", "bf16x3"),
              ("1x_seed_f32", F32, F32, "acc", None, "bf16x3"),
              ("1x_seed_bf16", BF16, BF16, "acc", None, "bf16x3"),
              ("1h_fresh", F16, F16, "fresh", None, "f32"),
              ("1h_acc", F16, F16, "acc", None, "f32"))
# (name, Xt, storage, dot)
MERGED_TIMED = (("6", 2, F32, "f32"), ("6", 4, F32, "f32"), ("6v", 2, BF16, "f32"),
                ("6v", 4, BF16, "f32"), ("6x", 2, F32, "bf16x3"), ("6x", 4, F32, "bf16x3"),
                ("6x_bf16", 2, BF16, "bf16x3"))
CNOT = np.array(((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0)), np.complex64)
SPANS = ((13, 14), (20, 21), (27, 28))


def hermitian4():
    rng = np.random.default_rng(7)
    z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    return (0.25 * (z + z.conj().T)).astype(np.complex64)


def times(tag):
    out = {}
    el, em = unitary(128), unitary(128)
    tab = tables(A29)
    for name, xdt, ydt, form, run, dot in DUAL_TIMED:
        xs = [st.store_as(randn(A29, 128, 128), xdt) for _ in range(2)]
        kw = dict(dot_mode=dot)
        if run is not None:
            kw.update(diag_tables=tab, diag_first=run == "first")
        if form == "fresh":
            kw.update(conj=True, alias=False, out_dtype=ydt)
        elif form == "acc":
            acc = tuple(st.store_as(0.5 * randn(A29, 128, 128), ydt) for _ in range(2))
            kw.update(conj=True, acc=acc, alias=False)
        out[f"dual {name}"] = ms(lambda: dual_apply(*xs, *el, *em, **kw))
        if tag == "change" and xdt == F32 and ydt == F32 and dot == "f32" and run is None:
            x = torch.complex(*xs)
            elc, emc = torch.complex(*el), torch.complex(*em)
            if form == "acc":
                a = torch.complex(*acc)
                lib = lambda: a + torch.einsum("sk,akm,lm->asl", emc, x, elc).conj()  # noqa: E731
            else:
                lib = lambda: torch.einsum("sk,akm,lm->asl", emc, x, elc)  # noqa: E731
            out[f"dual {name} library"] = ms(lib, reps=3)
            del x
        kw = xs = acc = None
        torch.cuda.empty_cache()
    for name, xt, fdt, dot in MERGED_TIMED:
        shape = (1, xt * 128, (1 << 29) // (xt * 128 * 128), 128)
        El, Et = unitary(128), unitary(xt)
        xs = [st.store_as(randn(*shape), fdt) for _ in range(2)]
        out[f"merged {name} Xt{xt}"] = ms(
            lambda: merged_fact_apply(*xs, *El, *Et, x_top=xt, dot_mode=dot))
        if tag == "change" and name == "6":
            x = torch.complex(*xs).view(1, xt, 128, shape[2] * 128)
            elc, etc = torch.complex(*El), torch.complex(*Et)
            out[f"merged {name} Xt{xt} library"] = ms(
                lambda: torch.einsum("ab,dk,ibkq->iadq", etc, elc, x), reps=3)
            del x
        xs = None
        torch.cuda.empty_cache()
    # rows 2x and 2y: the high apply on the X = 8 span views, in place and the
    # seed (acc + conj(E x)), beside their matmul calls
    M = hermitian4()
    for pos in SPANS:
        for row, gate in (("2x", CNOT), ("2y", M.conj())):
            kind, vshape, er, ei = pl.cross_span_operands(gate, pos, 29, dev)
            xs = [randn(*vshape) for _ in range(2)]
            A1, X, Mv, _ = vshape
            ec = torch.complex(er, ei)
            x = torch.complex(*xs).view(A1, X, Mv * 128)
            if row == "2x":
                out[f"high {row} span{pos[0]}"] = ms(lambda: high_apply(*xs, er, ei))
                lib = lambda: torch.matmul(ec, x)  # noqa: E731
            else:
                acc = [randn(*vshape) for _ in range(2)]
                out[f"high {row} span{pos[0]}"] = ms(lambda: high_apply(
                    *xs, er, ei, conj=True, acc=tuple(acc), alias=False))
                a = torch.complex(*acc).view(A1, X, Mv * 128)
                lib = lambda: a + torch.matmul(ec, x).conj()  # noqa: E731
            out[f"high {row} span{pos[0]} library"] = ms(lib, reps=5)
            xs = acc = x = a = lib = None
            torch.cuda.empty_cache()
    for k, v in out.items():
        print(f"[time] {tag} {k}: {v:.3f} ms", flush=True)
    return out


def parent_times():
    return subprocess.run([sys.executable, __file__],
                          env={**os.environ, "ROLE": "parent", "ROOT": PARENT})


if ROLE == "parent":
    print(json.dumps({"parent_times": times("parent")}), flush=True)
    sys.exit(0)
if pb is not None:
    pb.wait()
    parent_times()
times("change")
if pb is not None:
    times("change2")
    parent_times()
print(json.dumps({"fails": fails}), flush=True)
sys.exit(1 if fails else 0)
