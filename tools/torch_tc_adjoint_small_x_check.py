#!/usr/bin/env python3
"""Build-and-check of the high adjoint at X = 8..64 on the tensor cores, on
one CUDA card.

    python3 tools/torch_tc_adjoint_small_x_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_adjoint_small_x_check.py
    CHECK=0 ...   # times only

Builds the high adjoint's libraries (and the other adjoints', which share
its headers) and prints the registers and spills of the small-X kernel;
holds ``block_backward_high`` at X = 8, 16, 32 and 64 on views (2, X, 256,
128) to its plain version in every storage (F f32 / bf16, B f32 / bf16 /
f16) and dot mode, without a run and with a run met first or after, with
and without its Q (planes within 1e-4 or 2 storage ulps, pair grams and Q
within the storage's gram tolerance, 1e-5 / 4e-5 of their largest entry on
f32 planes); then times one launch (CUDA events, five launches after one)
at 2^29 amplitudes, the views (1, X, 2^22 / X, 128), in the settings of
PERF.md's rows: f32 planes with f32 and with bf16x3 pair grams (the CNOT
ring's X = 8 span launch), F and B bf16 with the transport and the pair gram
bf16x3 ("auto" under "bf16"), every mode bf16x3 on f32 and on bf16 planes,
and with a run's Q met first and after (bf16 planes; f32 planes in bf16x3),
with the time of three PyTorch calls computing the same step on f32 planes
(``library``). With PARENT, a checkout of another commit: its high-adjoint
libraries build beside this one's, and its times are taken before and after
two runs of this one's, in the same process tree. Prints the card's name and
power limit; exits 1 if any check fails.
"""
import json, os, subprocess, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.environ.get("ROOT") or os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import torch
from dqc_tpu_torch.ops.kernels import _build, _storage as st

ROLE = os.environ.get("ROLE", "change")
PARENT = os.environ.get("PARENT")
CHECK = os.environ.get("CHECK", "1") == "1"
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(7)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
SMALL_X = (8, 16, 32, 64)
# the libraries each checkout builds: the high adjoint's (below X = 128 a
# library of its own; the parent's "bf16" / bf16x3 variants are theirs), and
# here the others that share its headers
CHANGE_LIBRARIES = ("block_backward_high_small", "block_backward_high",
                    "block_backward_dual", "block_backward_merged_fact")
PARENT_LIBRARIES = ("block_backward_high", "block_backward_high_fwd16")
_build.LIBRARIES = PARENT_LIBRARIES if ROLE.startswith("parent") else CHANGE_LIBRARIES
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops.kernels.block_backward_high import (
    block_backward_high, block_backward_high_plain)

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
    for lib, ks in _build.kernel_resources(("block_backward_high_small_kernel",
                                            "block_backward_high_tc_kernel")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def unitary(X):
    q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X)).to(torch.complex128))
    q = q.to(torch.complex64)
    return q.real.contiguous(), q.imag.contiguous()


def phase_tables(A):
    def ph(*s):
        t = randn(*s)
        return torch.cos(t), torch.sin(t)
    a, b, c = ph(128, 128), ph(A, 128), ph(A, 128)
    return (*a, *b, *c)


fails = []


def compare(name, got, want, dtype_b, dtype_f, x3):
    worst = {}
    for k in range(2):
        gk, wk = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2]
        if gk[0].dtype in (BF16, F16):
            u = st.ulps_apart(gk, wk, gk[0].dtype)
            worst[f"p{k}_ulps"] = u
            if u > 2:
                fails.append((name, f"p{k}", u))
        else:
            e = max((a - b).abs().max().item() for a, b in zip(gk, wk))
            worst[f"p{k}_abs"] = e
            if e > 1e-4:
                fails.append((name, f"p{k}", e))
    red = [d for d in (dtype_b, dtype_f) if d != F32]
    gtol = st.gram_tolerance(red[0]) if red else (4e-5 if x3 else 1e-5)
    for j, (a, b) in enumerate(zip(got[4:], want[4:])):
        r = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst[f"r{j}"] = r
        if r > gtol:
            fails.append((name, f"r{j}", r, gtol))
    print(f"[check] {name} {json.dumps(worst)}", flush=True)


def ms(fn, reps=5):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps


# (B storage, F storage, dot, bwd, gram)
SETTINGS = ((F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
            (F16, F32, "f32", "bf16x3", "bf16x3"), (F16, F32, "f32", "f32", "bf16x3"),
            (BF16, F32, "f32", "bf16x3", "bf16x3"), (BF16, BF16, "f32", "bf16x3", "bf16x3"),
            (F32, F32, "bf16x3", "bf16x3", "bf16x3"), (BF16, BF16, "bf16x3", "bf16x3", "bf16x3"),
            (F32, F32, "bf16x3", "f32", "f32"), (BF16, BF16, "f32", "f32", "f32"),
            (F16, BF16, "f32", "f32", "f32"))


def planes_of(shape, fdt, bdt):
    return ([st.store_as(randn(*shape), fdt) for _ in range(2)]
            + [st.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])


if ROLE == "change" and CHECK:
    A1, M = 2, 256
    for X in SMALL_X:
        a_rows = A1 * X * M // 128
        for bdt, fdt, dot, bwd, gram in SETTINGS:
            for run in (None, "first", "after"):
                for q in ((False, True) if run else (False,)):
                    planes = planes_of((A1, X, M, 128), fdt, bdt)
                    E, Ei = unitary(X), unitary(X)
                    kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
                    if run:
                        kw.update(diag_inv_tables=phase_tables(a_rows),
                                  diag_tables=phase_tables(a_rows),
                                  diag_first_fwd=run == "first", diag_q=q)
                    want = block_backward_high_plain(*planes, *Ei, *E, **kw)
                    got = block_backward_high(*[p.clone() for p in planes], *Ei, *E, **kw)
                    torch.cuda.synchronize()
                    compare(f"X{X} b={bdt} f={fdt} dot={dot} bwd={bwd} gram={gram} "
                            f"run={run} q={q}", got, want, bdt, fdt,
                            gram == "bf16x3" or dot == "bf16x3")

# the rows' settings at 2^29 amplitudes: (F, B, dot, bwd, gram)
TIMED = (("f32", (F32, F32, "f32", "f32", "f32")),
         ("f32_gram_x3", (F32, F32, "f32", "f32", "bf16x3")),
         ("bf16", (BF16, BF16, "f32", "bf16x3", "bf16x3")),
         ("x3_f32", (F32, F32, "bf16x3", "bf16x3", "bf16x3")),
         ("x3_bf16", (BF16, BF16, "bf16x3", "bf16x3", "bf16x3")))
Q_TIMED = (("q_bf16", (BF16, BF16, "f32", "bf16x3", "bf16x3")),
           ("q_x3", (F32, F32, "bf16x3", "bf16x3", "bf16x3")))


def library(planes, E, Ei):
    """Three PyTorch calls computing the step on f32 planes."""
    fr, fi, br, bi = planes
    A1, X, M, _ = fr.shape
    F = torch.complex(fr, fi).view(A1, X, M * 128)
    B = torch.complex(br, bi).view(A1, X, M * 128)
    Ec, Eic = torch.complex(*E), torch.complex(*Ei)

    def run():
        Fi = torch.matmul(Eic, F)
        return Fi, torch.einsum("axq,ayq->xy", B, Fi), torch.matmul(Ec.T, B)
    return run


def times(tag):
    out = {}
    for X in SMALL_X:
        shape = (1, X, (1 << 22) // X, 128)
        E, Ei = unitary(X), unitary(X)
        for name, (fdt, bdt, dot, bwd, gram) in TIMED:
            planes = planes_of(shape, fdt, bdt)
            kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
            out[f"X{X} {name}"] = ms(lambda: block_backward_high(*planes, *E, *Ei, **kw))
            if name == "f32" and tag == "change":
                out[f"X{X} library"] = ms(library(planes, E, Ei), reps=3)
            del planes
            torch.cuda.empty_cache()
        if X in (8, 64):
            tabs = (phase_tables(1 << 15), phase_tables(1 << 15))
            for name, (fdt, bdt, dot, bwd, gram) in Q_TIMED:
                planes = planes_of(shape, fdt, bdt)
                kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot,
                          diag_inv_tables=tabs[0], diag_tables=tabs[1], diag_q=True)
                for first in (True, False):
                    out[f"X{X} {name} first={first}"] = ms(
                        lambda: block_backward_high(*planes, *E, *Ei,
                                                    diag_first_fwd=first, **kw))
                del planes
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
t1 = times("change")
if pb is not None:
    times("change2")
    parent_times()
print(json.dumps({"fails": fails}), flush=True)
sys.exit(1 if fails else 0)
