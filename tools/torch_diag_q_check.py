#!/usr/bin/env python3
"""Build-and-check of the diagonal run's kernels (csrc/diag.cu), the
backward with the Q reductions above all, on one CUDA card.

    python3 tools/torch_diag_q_check.py             # from the repo root
    PARENT=<checkout> python3 tools/torch_diag_q_check.py
    CHECK=0 ...        # times only
    TIMES=0 ...        # checks only; TIMES=quick: rows 13q, 13qv, 13f with Q

Builds the library of csrc/diag.cu and prints the registers and spills of
its kernels; holds ``diag_backward`` with and without Q, F stored f32 /
bf16 and B f32 / bf16 / f16, on planes (A, 128, 128) at A = 1, 5, 300 and
2^14 (a grid walk of one to 125 slabs a block), and ``diag_sweep`` on f32 /
bf16 planes, to their plain versions: f32 planes within 1e-5 abs (chip_smoke's
DIAG_TOL), 16-bit planes within 2 storage ulps (bf16 F: 1), Q within 1e-5
of each output's largest entry. Then times one launch (CUDA events, ten
launches after one) at 2^29 amplitudes (A = 2^15; 2^28 for row 13q in
brackets) of PERF.md's rows 13q, 13qv and 13f with Q, and as controls rows
7, 7v, 13, 13v and 13f (B f16 and bf16) without Q, each beside its bound
(the bytes: each plane read and written once, the tables, Q's outputs, at
3.35 TB/s) and, on f32 planes, beside the PyTorch calls computing the same
function (``library``: the run's multiplies, Q = B F and its three sums).
With PARENT, a checkout of another commit: its library builds beside this
one's, and its times are taken before and after two runs of this one's, in
the same process tree. Prints the card's name and power limit; exits 1 if
any check fails.
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
TIMES = os.environ.get("TIMES", "1")
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(21)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
_build.LIBRARIES = ("diag",)
t0 = time.perf_counter()
if ROLE == "parent-build":
    _build.build_all()
    print(f"[parent build] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
from dqc_tpu_torch.ops.kernels.diag import (diag_backward, diag_backward_plain,
                                            diag_sweep, diag_sweep_plain)

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
    for lib, ks in _build.kernel_resources(("diag_backward_q_kernel",
                                            "diag_backward_kernel",
                                            "diag_sweep_kernel")).items():
        for k in ks:
            print(f"[regs] {lib} {json.dumps(k)}", flush=True)


def randn(*s):
    return torch.randn(*s, generator=g, device=dev)


def phases(*shape):
    z = torch.polar(torch.ones(shape, device=dev),
                    6.2832 * torch.rand(shape, generator=g, device=dev))
    return z.real.contiguous(), z.imag.contiguous()


def tables(a_rows):
    return (*phases(128, 128), *phases(a_rows, 128), *phases(a_rows, 128))


fails = []
worst = {"abs": 0.0, "ulps": 0.0, "q_rel": 0.0, "n": 0}


def held(tag, got, want, dts, n_planes):
    """Planes of each pair held to its storage's bar, then Q to 1e-5 of
    each output's largest entry."""
    worst["n"] += 1
    errs = {}
    for k in range(n_planes):
        g2, w2, dt = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2], dts[k]
        if g2[0].dtype != w2[0].dtype:
            fails.append((tag, "dtype", str(g2[0].dtype)))
            continue
        if dt == F32:
            e = max((a - b).abs().max().item() for a, b in zip(g2, w2))
            worst["abs"] = max(worst["abs"], e)
            ok = e <= 1e-5
        else:
            e = st.ulps_apart(g2, w2, dt)
            worst["ulps"] = max(worst["ulps"], e)
            ok = e <= (1.0 if k == 0 else 2.0)
        errs[f"plane{k}"] = e
        if not ok:
            fails.append((tag, f"plane{k}", e))
    for j, (a, b) in enumerate(zip(got[2 * n_planes:], want[2 * n_planes:])):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        worst["q_rel"] = max(worst["q_rel"], rel)
        errs[f"q{j}"] = rel
        if not rel <= 1e-5:
            fails.append((tag, f"q{j}", rel))
    if fails and fails[-1][0] == tag:
        print(f"[check] FAIL {tag} {json.dumps(errs)}", flush=True)


def planes(A, dt, scale=1.0):
    return [st.store_as(scale * randn(A, 128, 128), dt) for _ in range(2)]


if ROLE == "change" and CHECK:
    for A in (1, 5, 300, 1 << 14):
        ti, tf = tables(A), tables(A)
        for fdt in (F32, BF16):
            for bdt in (F32, BF16, F16):
                for with_q in (True, False):
                    xs = planes(A, fdt) + planes(A, bdt, 0.5)
                    want = diag_backward_plain(*xs, *ti, *tf, with_q=with_q)
                    got = diag_backward(*[x.clone() for x in xs], *ti, *tf, with_q=with_q)
                    torch.cuda.synchronize()
                    held(f"diag_backward A{A} F {fdt} B {bdt} q={with_q}", got, want,
                         (fdt, bdt), 2)
                    xs = want = got = None
            xs = planes(A, fdt)
            held(f"diag_sweep A{A} {fdt}", diag_sweep(*[x.clone() for x in xs], *tf),
                 diag_sweep_plain(*xs, *tf), (fdt,), 1)
        torch.cuda.empty_cache()
    print(f"[check] {worst['n']} variants against their plain versions; worst "
          f"{json.dumps(worst)}; {len(fails)} outside their bars", flush=True)

PEAK_HBM = 3.35e12


def nbytes(dt):
    return 4 if dt == F32 else 2


def bound_ms(A, dts, with_q):
    """Each plane read and written once, the tables read once (the sweep's
    one set, the backward's two), Q's outputs written once."""
    amps = A * 128 * 128
    tab = 2 * 4 * (128 * 128 + 2 * A * 128)
    b = sum(2 * 2 * amps * nbytes(dt) for dt in dts) + len(dts) * tab
    if with_q:
        b += 2 * 4 * (128 * 128 + 2 * A * 128)
    return b / PEAK_HBM * 1e3


def ms(fn, reps=10):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / reps


def library(xs, tabs, with_q):
    """The run's multiplies of each plane pair of ``xs`` by its tables' D
    (and Q = B F with its three sums): the PyTorch calls computing the same
    function."""
    d = [(torch.complex(t[0], t[1]), torch.complex(t[2], t[3]), torch.complex(t[4], t[5]))
         for t in tabs]
    cs = [torch.complex(xs[k], xs[k + 1]) for k in range(0, len(xs), 2)]

    def run():
        out = [x * ((tas[:, :, None] * tal[:, None, :]) * tsl)
               for x, (tsl, tas, tal) in zip(cs, d)]
        if with_q:
            Q = cs[1] * cs[0]
            out += [Q.sum(0), Q.sum(2), Q.sum(1)]
        return out
    return run


# (row, A, F storage, B storage or None for the sweep, with Q)
TIMED = (("13q", 1 << 15, F32, F32, True), ("13q 28q", 1 << 14, F32, F32, True),
         ("13qv", 1 << 15, BF16, BF16, True), ("13f with_q", 1 << 15, F32, F16, True),
         ("7", 1 << 15, F32, None, False), ("7v", 1 << 15, BF16, None, False),
         ("13", 1 << 15, F32, F32, False), ("13v", 1 << 15, BF16, BF16, False),
         ("13f f16", 1 << 15, F32, F16, False), ("13f bf16", 1 << 15, F32, BF16, False))
QUICK = {"13q", "13qv", "13f with_q"}


def times(tag):
    for row, A, fdt, bdt, with_q in TIMED:
        if TIMES == "quick" and row not in QUICK:
            continue
        ti, tf = tables(A), tables(A)
        if bdt is None:
            xs = planes(A, fdt)
            t = ms(lambda: diag_sweep(*xs, *tf))
            b = bound_ms(A, (fdt,), False)
        else:
            xs = planes(A, fdt) + planes(A, bdt, 0.5)
            t = ms(lambda: diag_backward(*xs, *ti, *tf, with_q=with_q))
            b = bound_ms(A, (fdt, bdt), with_q)
        msg = f"[time] {tag} {row}: {t:.3f} ms (bound {b:.3f} ms, {100 * b / t:.1f}%)"
        if tag == "change" and fdt == F32 and bdt in (F32, None):
            lib = library(xs, (ti, tf) if bdt is not None else (tf,), with_q)
            msg += f"; library {ms(lib, reps=3):.3f} ms"
        print(msg, flush=True)
        xs = ti = tf = None
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
