#!/usr/bin/env python3
"""Build-and-check of the dual and lane adjoints' tensor-core step on one
CUDA card.

    python3 tools/torch_tc_adjoint_check.py        # from the repo root

Builds the port's kernels, prints the dual adjoint library's registers and
spills (its kernels and the step's functions not inlined), holds
``block_backward_dual`` and ``block_backward_lane`` to their plain versions
at A = 1024 slabs (24 qubits) in every storage (F f32 / bf16, B f32 / bf16 /
f16), dot mode, step order and run order, with and without a run's Q
(planes within 1e-4 or 3 storage ulps, pair grams and Q within the
storage's gram tolerance, 1e-5 / 4e-5 of their largest entry on f32 planes),
then at 29 qubits the main path's variants against their plain versions
and the time of one launch (CUDA events, five launches after one), and the
host time of a dual launch's four operator pre-splits. Exits 1 if any
check fails.
"""
import json, os, sys, time
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import torch
from dqc_tpu_torch.ops.kernels import _build, _storage as st
from dqc_tpu_torch.ops.kernels.block_backward_dual import (
    block_backward_dual, block_backward_dual_plain, step_operators)
from dqc_tpu_torch.ops.kernels.block_backward_lane import (
    block_backward_lane, block_backward_lane_plain)

def main() -> int:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s {json.dumps(_build.build_seconds)}", flush=True)
    for lib, ks in _build.kernel_resources(("block_backward_dual_kernel", "tc_op_tile", "pair_gram", "tc_load_tiles", "tc_store_tile")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)

    def unitary(X):
        q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X)))
        return q.real.contiguous(), q.imag.contiguous()

    def tables(A):
        return (randn(128, 128) * 0.7, randn(128, 128) * 0.7, randn(A, 128) * 0.7,
                randn(A, 128) * 0.7, randn(A, 128) * 0.7, randn(A, 128) * 0.7)

    def phase_tables(A):
        def ph(*s):
            t = randn(*s)
            return torch.cos(t), torch.sin(t)
        a, b, c = ph(128, 128), ph(A, 128), ph(A, 128)
        return (*a, *b, *c)

    fails = []

    def compare(name, got, want, n_planes, dtype_b, dtype_f, x3gram):
        worst = {}
        for k in range(n_planes):
            gk, wk = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2]
            if gk[0].dtype in (BF16, F16):
                u = st.ulps_apart(gk, wk, gk[0].dtype)
                worst[f"p{k}_ulps"] = u
                if u > 3:
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

    A = int(os.environ.get("CHECK_A", "1024"))
    ops = [t for _ in range(4) for t in unitary(128)]
    cases = []
    for bdt, fdt, dot, bwd, gram in ((F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
                                     (F16, F32, "f32", "bf16x3", "bf16x3"), (BF16, F32, "f32", "bf16x3", "bf16x3"),
                                     (F16, F32, "f32", "f32", "bf16x3"),
                                     (BF16, BF16, "f32", "bf16x3", "bf16x3"), (F32, F32, "bf16x3", "bf16x3", "bf16x3"),
                                     (BF16, BF16, "bf16x3", "bf16x3", "bf16x3"), (F32, F32, "bf16x3", "f32", "f32")):
        for g0 in (True, False):
            for run in (None, "first", "after"):
                for q in ((False, True) if run else (False,)):
                    cases.append((bdt, fdt, dot, bwd, gram, g0, run, q))
    for bdt, fdt, dot, bwd, gram, g0, run, q in cases:
        planes = [st.store_as(randn(A, 128, 128), fdt) for _ in range(2)] + \
                 [st.store_as(0.5 * randn(A, 128, 128), bdt) for _ in range(2)]
        kw = dict(g0_first=g0, bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
        if run:
            kw.update(diag_inv_tables=phase_tables(A), diag_tables=phase_tables(A),
                      diag_first_fwd=run == "first", diag_q=q)
        want = block_backward_dual_plain(*planes, *ops, **kw)
        got = block_backward_dual(*[p.clone() for p in planes], *ops, **kw)
        torch.cuda.synchronize()
        name = f"dual b={bdt} f={fdt} dot={dot} bwd={bwd} gram={gram} g0={g0} run={run} q={q}"
        compare(name, got, want, 2, bdt, fdt, gram == "bf16x3" or dot == "bf16x3")
    for bdt, fdt, dot, bwd, gram in ((F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
                                     (F16, F32, "f32", "bf16x3", "bf16x3"), (F16, F32, "f32", "f32", "bf16x3"),
                                     (BF16, BF16, "f32", "bf16x3", "bf16x3"), (F32, F32, "bf16x3", "bf16x3", "bf16x3"),
                                     (BF16, BF16, "bf16x3", "bf16x3", "bf16x3")):
        planes = [st.store_as(randn(A, 128, 128), fdt) for _ in range(2)] + \
                 [st.store_as(0.5 * randn(A, 128, 128), bdt) for _ in range(2)]
        kw = dict(bwd_mode=bwd, gram_mode=gram, dot_mode=dot)
        E, Ei = unitary(128), unitary(128)
        want = block_backward_lane_plain(*planes, *Ei, *E, **kw)
        got = block_backward_lane(*[p.clone() for p in planes], *Ei, *E, **kw)
        torch.cuda.synchronize()
        compare(f"lane b={bdt} f={fdt} dot={dot} bwd={bwd} gram={gram}", got, want, 2, bdt, fdt,
                gram == "bf16x3" or dot == "bf16x3")

    # the 29q main-path shapes: correctness of two variants and times
    A29 = 1 << 15
    planes = [randn(A29, 128, 128) for _ in range(4)]
    for kw in (dict(g0_first=True, gram_mode="bf16x3", diag_inv_tables=tables(A29),
                    diag_tables=tables(A29), diag_first_fwd=True),
               dict(g0_first=True)):
        want = block_backward_dual_plain(*planes, *ops, **kw)
        got = block_backward_dual(*[p.clone() for p in planes], *ops, **kw)
        torch.cuda.synchronize()
        compare(f"dual29 {sorted(kw)} gram={kw.get('gram_mode', 'f32')}", got, want, 2, F32, F32,
                kw.get("gram_mode") == "bf16x3")
        del got, want
        work = [p.clone() for p in planes]
        t = ms(lambda: block_backward_dual(*work, *ops, **kw))
        print(f"[time] dual29 {sorted(kw)} gram={kw.get('gram_mode', 'f32')}: {t:.3f} ms", flush=True)
        del work
        torch.cuda.empty_cache()
    E, Ei = unitary(128), unitary(128)
    work = [p.clone() for p in planes]
    for gram in ("f32", "bf16x3"):
        t = ms(lambda: block_backward_lane(*work, *Ei, *E, gram_mode=gram))
        print(f"[time] lane29 gram={gram}: {t:.3f} ms", flush=True)
    for dot, bwd, gram in (("f32", "bf16x3", "bf16x3"), ("bf16x3", "bf16x3", "bf16x3")):
        t = ms(lambda: block_backward_dual(*work, *ops, g0_first=True, dot_mode=dot, bwd_mode=bwd,
                                           gram_mode=gram))
        print(f"[time] dual29 f32 planes dot={dot} bwd={bwd} gram={gram}: {t:.3f} ms", flush=True)
    # the host's pre-split, per launch
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(50):
        step_operators(*ops[:4], "f32", "f32"); step_operators(*ops[4:], "f32", "f32")
    torch.cuda.synchronize()
    print(f"[host] four pre-splits: {(time.perf_counter() - h0) / 50 * 1e3:.3f} ms", flush=True)
    print(json.dumps({"fails": fails}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
