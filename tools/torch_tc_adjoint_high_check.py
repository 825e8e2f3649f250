#!/usr/bin/env python3
"""Build-and-check of the sublane adjoint and the X = 128 high adjoint on
the tensor cores, on one CUDA card.

    python3 tools/torch_tc_adjoint_high_check.py                # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_adjoint_high_check.py

Builds the port's kernels and prints the registers and spills of the dual
adjoint's library (which builds the sublane step) and of the high adjoint's
(the tensor-core kernel at X = 128); holds
``block_backward_sublane`` at A = 1024 slabs (24 qubits) and
``block_backward_high`` at X = 128 on the view (4, 128, 256, 128) to their
plain versions in every storage (F f32 / bf16, B f32 / bf16 / f16) and dot
mode, the high adjoint also without a run and with a run met first or after,
with and without its Q (planes within 1e-4 or 2 storage ulps, pair grams
and Q within the storage's gram tolerance, 1e-5 / 4e-5 of their largest
entry on f32 planes); then the X = 64 high adjoint (its small-X step,
tools/torch_tc_adjoint_small_x_check.py checks every variant) and the dual
adjoint with a run's Q, both orders, f32 and bf16; then the time of one launch at 29
qubits (CUDA events, five launches after one) of each kernel in four
settings, the high adjoint also with a run's Q, and of the dual adjoint (no
run, the ring's run, with bf16x3 grams) and the merged-top adjoint (Xt = 2,
f32 and bf16x3 grams), which share code with them. With PARENT, a checkout of
another commit: its two libraries build beside this one's, and its times
are taken between two runs of this one's, in the same process tree. Exits 1
if any check fails.
"""
import json, os, subprocess, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.environ.get("ROOT") or os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import torch
from dqc_tpu_torch.ops.kernels import _build, _storage as st

ROLE = os.environ.get("ROLE", "change")
PARENT = os.environ.get("PARENT")
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(7)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# the libraries another checkout builds for its times
PARENT_LIBRARIES = ("block_backward_sublane", "block_backward_high",
                    "block_backward_dual", "block_backward_merged_fact")
if ROLE == "parent":
    _build.LIBRARIES = PARENT_LIBRARIES
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.LIBRARIES = PARENT_LIBRARIES
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops.kernels.block_backward_sublane import (
    block_backward_sublane, block_backward_sublane_plain)
from dqc_tpu_torch.ops.kernels.block_backward_high import (
    block_backward_high, block_backward_high_plain)
from dqc_tpu_torch.ops.kernels.block_backward_dual import (
    block_backward_dual, block_backward_dual_plain)
from dqc_tpu_torch.ops.kernels.block_backward_merged_fact import (
    block_backward_merged_fact)

pb = None
if ROLE == "change" and PARENT:
    pb = subprocess.Popen([sys.executable, __file__], env={**os.environ, "ROLE": "parent-build",
                                                         "ROOT": PARENT})
_build.build_all()
print(f"[{ROLE} build] {time.perf_counter() - t0:.1f} s {json.dumps(_build.build_seconds)}",
      flush=True)
if ROLE == "change":
    for lib, ks in _build.kernel_resources((
            "block_backward_dual_kernel", "block_backward_high_tc_kernel",
            "tc_op_tile", "pair_gram", "tc_load_tiles",
            "tc_store_tile")).items():
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


def compare(name, got, want, n_planes, dtype_b, dtype_f, x3gram, q=False):
    worst = {}
    for k in range(n_planes):
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
    gtol = st.gram_tolerance(red[0]) if red else (4e-5 if x3gram else 1e-5)
    for j, (a, b) in enumerate(zip(got[2 * n_planes:], want[2 * n_planes:])):
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


SETTINGS = ((F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
            (F16, F32, "f32", "bf16x3", "bf16x3"), (F16, F32, "f32", "f32", "bf16x3"),
            (BF16, F32, "f32", "bf16x3", "bf16x3"), (BF16, BF16, "f32", "bf16x3", "bf16x3"),
            (F32, F32, "bf16x3", "bf16x3", "bf16x3"), (BF16, BF16, "bf16x3", "bf16x3", "bf16x3"),
            (F32, F32, "bf16x3", "f32", "f32"), (BF16, BF16, "f32", "f32", "f32"))


def planes_of(shape, fdt, bdt):
    return ([st.store_as(randn(*shape), fdt) for _ in range(2)]
            + [st.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])


if ROLE == "change":
    A = 1024
    for bdt, fdt, dot, bwd, gram in SETTINGS:
        planes = planes_of((A, 128, 128), fdt, bdt)
        E, Ei = unitary(128), unitary(128)
        kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
        want = block_backward_sublane_plain(*planes, *Ei, *E, **kw)
        got = block_backward_sublane(*[p.clone() for p in planes], *Ei, *E, **kw)
        torch.cuda.synchronize()
        compare(f"sublane b={bdt} f={fdt} dot={dot} bwd={bwd} gram={gram}", got, want, 2,
                bdt, fdt, gram == "bf16x3" or dot == "bf16x3")
    A1, M = 4, 256
    a_rows = A1 * 128 * M // 128
    for bdt, fdt, dot, bwd, gram in SETTINGS:
        for run in (None, "first", "after"):
            for q in ((False, True) if run else (False,)):
                planes = planes_of((A1, 128, M, 128), fdt, bdt)
                E, Ei = unitary(128), unitary(128)
                kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
                if run:
                    kw.update(diag_inv_tables=phase_tables(a_rows),
                              diag_tables=phase_tables(a_rows),
                              diag_first_fwd=run == "first", diag_q=q)
                want = block_backward_high_plain(*planes, *Ei, *E, **kw)
                got = block_backward_high(*[p.clone() for p in planes], *Ei, *E, **kw)
                torch.cuda.synchronize()
                compare(f"high128 b={bdt} f={fdt} dot={dot} bwd={bwd} gram={gram} run={run} "
                        f"q={q}", got, want, 2, bdt, fdt, gram == "bf16x3" or dot == "bf16x3")
    # the X = 64 step and the dual adjoint's Q
    for bdt, fdt, dot, bwd, gram in SETTINGS[:1] + SETTINGS[5:6]:
        for first in (True, False):
            planes = planes_of((2, 64, 2048, 128), fdt, bdt)
            E, Ei = unitary(64), unitary(64)
            kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot,
                      diag_inv_tables=phase_tables(2048), diag_tables=phase_tables(2048),
                      diag_first_fwd=first, diag_q=True)
            want = block_backward_high_plain(*planes, *Ei, *E, **kw)
            got = block_backward_high(*[p.clone() for p in planes], *Ei, *E, **kw)
            torch.cuda.synchronize()
            compare(f"high64 b={bdt} f={fdt} first={first}", got, want, 2, bdt, fdt, False)
            planes = planes_of((256, 128, 128), fdt, bdt)
            ops = [t for _ in range(4) for t in unitary(128)]
            kw = dict(g0_first=first, bwd_mode=bwd, gram_mode=gram, dot_mode=dot,
                      diag_inv_tables=phase_tables(256), diag_tables=phase_tables(256),
                      diag_first_fwd=first, diag_q=True)
            want = block_backward_dual_plain(*planes, *ops, **kw)
            got = block_backward_dual(*[p.clone() for p in planes], *ops, **kw)
            torch.cuda.synchronize()
            compare(f"dual b={bdt} f={fdt} first={first}", got, want, 2, bdt, fdt,
                    gram == "bf16x3")

# the 29q main-path shapes: times
A29 = 1 << 15


def times(tag):
    out = {}
    E, Ei = unitary(128), unitary(128)
    for fdt, bdt, dot, bwd, gram in ((F32, F32, "f32", "f32", "f32"),
                                     (F32, F32, "f32", "f32", "bf16x3"),
                                     (F32, F16, "f32", "bf16x3", "bf16x3"),
                                     (BF16, BF16, "f32", "bf16x3", "bf16x3")):
        planes = planes_of((A29, 128, 128), fdt, bdt)
        kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
        out[f"sublane {fdt} {bdt} {dot}/{bwd}/{gram}"] = ms(
            lambda: block_backward_sublane(*planes, *Ei, *E, **kw))
        vshape = (A29 // 128, 128, 128, 128)
        vp = [p.view(vshape) for p in planes]
        out[f"high128 {fdt} {bdt} {dot}/{bwd}/{gram}"] = ms(
            lambda: block_backward_high(*vp, *Ei, *E, **kw))
        if fdt == F32 and gram == "bf16x3" and bdt == F32:
            tabs = (phase_tables(A29 * 128 // 128), phase_tables(A29 * 128 // 128))
            for first in (True, False):
                out[f"high128_q first={first} {fdt} {bdt} {dot}/{bwd}/{gram}"] = ms(
                    lambda: block_backward_high(*vp, *Ei, *E, diag_inv_tables=tabs[0],
                                                diag_tables=tabs[1], diag_first_fwd=first,
                                                diag_q=True, **kw))
        del planes, vp
        torch.cuda.empty_cache()
    # the other adjoints of the [grad29] step, which share the step's code
    # (the dual) or adjoint.cuh (the merged top's X = 128 low step)
    planes = planes_of((A29, 128, 128), F32, F32)
    ops = [t for _ in range(4) for t in unitary(128)]
    tabs = (phase_tables(A29), phase_tables(A29))
    for tag2, kw in (("no run", {}),
                     ("run first", dict(diag_inv_tables=tabs[0], diag_tables=tabs[1])),
                     ("run first, bf16x3 grams",
                      dict(diag_inv_tables=tabs[0], diag_tables=tabs[1],
                           gram_mode="bf16x3"))):
        out[f"dual g0_first {tag2}"] = ms(
            lambda: block_backward_dual(*planes, *ops, g0_first=True, **kw))
    mshape = (1, 256, 1 << 14, 128)
    mplanes = [p.view(mshape) for p in planes]
    mops = [*unitary(128), *unitary(128), *unitary(2), *unitary(2)]
    for gram in ("f32", "bf16x3"):
        out[f"merged_fact Xt2 gram={gram}"] = ms(
            lambda: block_backward_merged_fact(*mplanes, *mops, x_top=2, gram_mode=gram))
    del planes, mplanes
    torch.cuda.empty_cache()
    for k, v in out.items():
        print(f"[time] {tag} {k}: {v:.3f} ms", flush=True)
    return out


if ROLE == "parent":
    print(json.dumps({"parent_times": times("parent")}), flush=True)
    sys.exit(0)
t1 = times("change")
if pb is not None:
    pb.wait()
    r = subprocess.run([sys.executable, __file__], env={**os.environ, "ROLE": "parent",
                                                      "ROOT": PARENT})
    t2 = times("change2")
print(json.dumps({"fails": fails}), flush=True)
sys.exit(1 if fails else 0)
