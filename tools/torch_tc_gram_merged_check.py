#!/usr/bin/env python3
"""Build-and-check of the tensor-core Gram (X = 128 / 256 / 512) and the
merged-top adjoint on the tensor cores, on one CUDA card.

    python3 tools/torch_tc_gram_merged_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_tc_gram_merged_check.py
    CHECK=0 ...   # times only

Builds the Gram's library and the adjoints' (which share csrc/tc_adjoint.cuh)
and prints the registers and spills of the new kernels; holds ``gram`` on
small views (the lane, sublane and high views at X = 128 and the merged top
at X = 256 / 512) on f32 and bf16 planes in both dot modes to its plain
version (within 1e-5 of the largest entry; 4e-5 in bf16x3), and
``block_backward_merged_fact`` at Xt = 2 and 4 on views (2, Xt 128, 16, 128)
in every storage (F f32 / bf16, B f32 / bf16 / f16) and every combination of
the three dot modes (planes within 1e-4 or 2 storage ulps, T0_top and T0_low
within the storage's gram tolerance, 1e-5 / 4e-5 of their largest entry on
f32 planes); then times one launch (CUDA events, five launches after one)
at 2^29 amplitudes in the settings of PERF.md's rows 3, 4, 5, 3-5v, 3-5x, 12,
12b, 12f, 12f', 12v, 12x, with the time of the PyTorch calls computing the
same function (``library``). With PARENT, a checkout of another commit: its
two libraries build beside this one's, and its times are taken before and
after two runs of this one's, in the same process tree. Prints the card's
name and power limit; exits 1 if any check fails.
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
g = torch.Generator(device=dev).manual_seed(11)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
CHANGE_LIBRARIES = ("gram", "block_backward_merged_fact", "block_backward_high",
                    "block_backward_dual")
PARENT_LIBRARIES = ("gram", "block_backward_merged_fact")
_build.LIBRARIES = PARENT_LIBRARIES if ROLE.startswith("parent") else CHANGE_LIBRARIES
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops.kernels.block_backward_merged_fact import (
    block_backward_merged_fact, block_backward_merged_fact_plain)
from dqc_tpu_torch.ops.kernels.gram import gram, gram_plain

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
    for lib, ks in _build.kernel_resources(("gram_tc_kernel",
                                            "block_backward_merged_fact_kernel",
                                            "merged_slice_gram", "merged_top_factor",
                                            "block_backward_high_tc_kernel",
                                            "tc_load_tiles", "tc_store_tile")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def unitary(X):
    q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X)).to(torch.complex128))
    q = q.to(torch.complex64)
    return q.real.contiguous(), q.imag.contiguous()


fails = []


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def compare_planes(name, got, want, worst):
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


def ms(fn, reps=5):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps


MODES = [(d, b, gm) for d in ("f32", "bf16x3") for b in ("f32", "bf16x3")
         for gm in ("f32", "bf16x3")]
GRAM_VIEWS = (("lane", (512, 128, 1)), ("sublane", (4, 128, 128)),
              ("high", (2, 128, 32 * 128)), ("merged256", (1, 256, 64 * 128)),
              ("merged512", (1, 512, 32 * 128)))

if ROLE == "change" and CHECK:
    for name, view in GRAM_VIEWS:
        for fdt in (F32, BF16):
            for dot in ("f32", "bf16x3"):
                xr, xi = (st.store_as(randn(*view), fdt) for _ in range(2))
                want = gram_plain(xr, xi, dot)
                got = gram(xr, xi, dot)
                torch.cuda.synchronize()
                r = max(rel(a, b) for a, b in zip(got, want))
                tol = 4e-5 if dot == "bf16x3" and fdt == F32 else 1e-5
                print(f"[check] gram {name} {fdt} {dot}: {r:.3e} (tol {tol:.0e})", flush=True)
                if r > tol:
                    fails.append((f"gram {name} {fdt} {dot}", r))
    for xt in (2, 4):
        shape = (2, xt * 128, 16, 128)
        Eli, El, Eti, Et = unitary(128), unitary(128), unitary(xt), unitary(xt)
        ops = (*Eli, *El, *Eti, *Et)
        for fdt in (F32, BF16):
            for bdt in (F32, BF16, F16):
                for dot, bwd, gm in MODES:
                    planes = ([st.store_as(randn(*shape), fdt) for _ in range(2)]
                              + [st.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])
                    kw = dict(x_top=xt, dot_mode=dot, bwd_mode=bwd, gram_mode=gm)
                    want = block_backward_merged_fact_plain(*planes, *ops, **kw)
                    got = block_backward_merged_fact(*[p.clone() for p in planes], *ops, **kw)
                    torch.cuda.synchronize()
                    tag = f"merged Xt{xt} F {fdt} B {bdt} {dot}/{bwd}/{gm}"
                    worst = {}
                    compare_planes(tag, got, want, worst)
                    red = [d for d in (bdt, fdt) if d != F32]
                    gtol = (st.gram_tolerance(red[0]) if red else
                            4e-5 if "bf16x3" in (dot, gm) else 1e-5)
                    for j, nm in ((0, "top"), (1, "low")):
                        a = torch.complex(got[4 + 2 * j], got[5 + 2 * j])
                        b = torch.complex(want[4 + 2 * j], want[5 + 2 * j])
                        worst[nm] = rel(a, b)
                        if worst[nm] > gtol:
                            fails.append((tag, nm, worst[nm], gtol))
                    print(f"[check] {tag} {json.dumps(worst)}", flush=True)
                    del planes, want, got
        torch.cuda.empty_cache()

# the rows at 2^29 amplitudes
A29 = 1 << 15
GRAM_TIMED = (("lane", (A29 * 128, 128, 1)), ("sublane", (A29, 128, 128)),
              ("high_g2", (1 << 8, 128, 1 << 14)), ("merged_X256", (1, 256, 1 << 21)),
              ("merged_X512", (1, 512, 1 << 20)))
# (name, F, B, dot, bwd, gram)
MERGED_TIMED = (("12", F32, F32, "f32", "f32", "f32"),
                ("12b", F32, F32, "f32", "f32", "bf16x3"),
                ("12f_f16", F32, F16, "f32", "bf16x3", "bf16x3"),
                ("12f_bf16", F32, BF16, "f32", "bf16x3", "bf16x3"),
                ("12f'_f16", F32, F16, "f32", "f32", "bf16x3"),
                ("12f'_bf16", F32, BF16, "f32", "f32", "bf16x3"),
                ("12v", BF16, BF16, "f32", "f32", "bf16x3"),
                ("12x_f32", F32, F32, "bf16x3", "f32", "bf16x3"),
                ("12x_bf16", BF16, BF16, "bf16x3", "f32", "bf16x3"),
                ("x3x3_f32", F32, F32, "bf16x3", "bf16x3", "bf16x3"))


def gram_library(xr, xi):
    x = torch.complex(xr, xi)
    return lambda: torch.einsum("pxq,pyq->xy", x, x.conj())


def merged_library(planes, ops, xt):
    fr, fi, br, bi = planes
    A1, _, M, _ = fr.shape
    v = (A1, xt, 128, M * 128)
    F, B = torch.complex(fr, fi).view(v), torch.complex(br, bi).view(v)
    lic, lc, tic, tc = (torch.complex(ops[2 * k], ops[2 * k + 1]) for k in range(4))

    def run():  # six cuBLAS-backed matmul / einsum calls
        fB = torch.matmul(lic, F)
        t_low = torch.einsum("iaxq,iayq->xy", B, fB)
        t_top = torch.einsum("ixdq,yb,ibdq->xy", B, tic, F)
        fin = torch.einsum("ab,ibdq->iadq", tic, fB)
        bout = torch.einsum("ba,ibdq->iadq", tc, torch.matmul(lc.T, B))
        return fin, bout, t_top, t_low
    return run


def times(tag):
    out = {}
    for name, view in GRAM_TIMED:
        for fdt, dot, lab in ((F32, "f32", "f32"), (BF16, "f32", "bf16"),
                              (F32, "bf16x3", "x3")):
            xr, xi = (st.store_as(randn(*view), fdt) for _ in range(2))
            out[f"gram {name} {lab}"] = ms(lambda: gram(xr, xi, dot))
            if lab == "f32" and tag == "change":
                out[f"gram {name} library"] = ms(gram_library(xr, xi), reps=3)
            del xr, xi
            torch.cuda.empty_cache()
    for xt, shape in ((2, (1, 256, 1 << 14, 128)), (4, (1, 512, 1 << 13, 128))):
        ops = (*unitary(128), *unitary(128), *unitary(xt), *unitary(xt))
        for name, fdt, bdt, dot, bwd, gm in MERGED_TIMED:
            planes = ([st.store_as(randn(*shape), fdt) for _ in range(2)]
                      + [st.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])
            kw = dict(x_top=xt, dot_mode=dot, bwd_mode=bwd, gram_mode=gm)
            try:
                out[f"merged Xt{xt} {name}"] = ms(
                    lambda: block_backward_merged_fact(*planes, *ops, **kw))
            except ValueError as e:  # a mode pair that commit refuses
                print(f"[time] {tag} merged Xt{xt} {name}: refused ({e})", flush=True)
            if name == "12" and tag == "change":
                out[f"merged Xt{xt} library"] = ms(merged_library(planes, ops, xt), reps=3)
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
times("change")
if pb is not None:
    times("change2")
    parent_times()
print(json.dumps({"fails": fails}), flush=True)
sys.exit(1 if fails else 0)
