#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dqc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment: torch, the card, its power limit, nvcc, triton;
2. build: every CUDA kernel of the port from dqc_tpu_torch/csrc (nvcc, one
   process per source, in parallel);
3. kernel checks at the 28-qubit shapes of the 28-qubit path: each kernel
   against its plain PyTorch version on the same inputs — the forward
   applies and Grams, the seed modes of the applies, and the two backward
   kernels in every mode the path uses — with its time, the plain
   version's and, where PyTorch calls compute the same function, theirs
   (library_ms); then the same at the 29- and 30-qubit shapes: the kernels
   of the 29-qubit path at its shapes, and the merged-top kernels
   (merged_fact_apply, block_backward_merged_fact, the Gram and the seed
   apply at X = 256 / 512) and the diagonal-run kernels;
4. the 28-qubit forward: HardwareEfficientAnsatz(28, 100, entangler="cz")
   .densities through the kernels, with the launch counters set to 0 just
   before and read just after; the params = 0 known answer (magnetization
   28); a 28-qubit x 20-layer run held against the plain-version path on
   the card; a timed step and its peak memory;
5. the 28-qubit gradient: value_and_grad of the same model's magnetization
   (loss.backward()) through the kernels, counters set to 0 just before and
   read just after, with its warm step time and peak memory; the 28q x 1L
   closed form (<Z_i> = cos alpha_i, so the gradient is -sin alpha_i in
   alpha and 0 in beta, gamma); 28q x 4L gradients through the kernels
   against the plain-version path on the card;
6. the 29-qubit path, the JAX package's bench workload uncut: the forward
   and the value_and_grad of HardwareEfficientAnsatz(29, 100, "cz"), each
   with the counters set to 0 just before and read just after and held to
   the launch counts of its program, with warm step times and peak memory;
   the 29q and 30q x 1L closed forms (the lone diagonal run in the layer);
   30q x 3L at params = 0 (the scan rotation at Xt = 4); 29q x 4L gradients
   through the kernels against the plain-version path on the card;
7. the CNOT ring, the JAX class's default entangler: the kernel checks of
   its cross-gate kernels (dual_multi_apply and high_multi_apply on the
   ring's own CNOT operators and on a random 2-qubit unitary's,
   block_backward_sublane, and the high apply and its adjoint on the X = 8
   span views) at 28q and 29q shapes in phase 3; then the forward and the
   value_and_grad of HardwareEfficientAnsatz(29, 20, "cnot") (depth cut
   from 100 for time: every layer runs the same program), counters set to
   0 just before and read just after and held to the program's counts,
   with warm step times, peak memory and the kernel time per step; the 29q
   and 30q x 1L closed forms of the ring; 30q x 2L at params = 0; 28q and
   29q x 4L gradients through the kernels against the plain-version path;
8. a JSON line of the kernels, the card's nvidia-smi name and power limit,
   and as the last line {"ok": true, "device": {...}}.

It exits non-zero without a result when torch.cuda.is_available() is false
or the dqc_tpu_torch package is not beside it. The run takes several
minutes on an H100 plus the kernels' build.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

N_QUBITS = 28
LAYERS = 100
CHECK_LAYERS = 20
SEED = 1234
N29 = 29            # the JAX package's bench workload: 29q x 100L value_and_grad
N30 = 30
CNOT_LAYERS = 20    # the CNOT ring at 29q: depth cut from 100 for time
CNOT = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0))

# Published H100 SXM peaks (dense): FP32 on the CUDA cores and HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

DUAL_TOL = 1e-4     # abs, unit-variance amplitudes through unitary operators
HIGH_TOL = 1e-4
GRAM_TOL = 2e-6     # abs on Gram entries of a unit-norm state
SLICE_TOL = 5e-5    # abs on density entries, kernel path vs plain path
ZERO_TOL = 1e-5     # params = 0: magnetization vs 28
GRAM_T0_TOL = 1e-5  # pair grams: abs err over the largest |T0| (2^21-term sums)
GRAD_LAYERS = 4
CLOSED_TOL = 1e-5   # 28q x 1L gradient vs (-sin alpha, 0, 0), and the value
CNOT_CLOSED_TOL = 3e-5  # the CNOT ring's 1L closed form, per parameter:
                        # products of up to n cosines through 2n f32 sweeps
ZERO_GRAD_TOL = 1e-6    # beta, gamma of the CNOT ring's closed form
GRAD_TOL = 1e-4     # abs per parameter, kernel path vs plain path, 28q and
                    # 29q x 4L: O(1) gradients from pair grams summed in
                    # another order
DIAG_TOL = 1e-5     # abs, unit-variance planes times unit-modulus phases


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from dqc_tpu_torch import HardwareEfficientAnsatz
    from dqc_tpu_torch.ops import kernels as K
    from dqc_tpu_torch.ops import planes as pl
    from dqc_tpu_torch.ops.kernels import _build
    from dqc_tpu_torch.ops.kernels.block_backward_dual import (
        block_backward_dual, block_backward_dual_plain)
    from dqc_tpu_torch.ops.kernels.block_backward_high import (
        block_backward_high, block_backward_high_plain)
    from dqc_tpu_torch.ops.kernels.block_backward_merged_fact import (
        block_backward_merged_fact, block_backward_merged_fact_plain)
    from dqc_tpu_torch.ops.kernels.block_backward_sublane import (
        block_backward_sublane, block_backward_sublane_plain)
    from dqc_tpu_torch.ops.kernels.dual_multi_apply import (
        dual_multi_apply, dual_multi_apply_plain)
    from dqc_tpu_torch.ops.kernels.high_multi_apply import (
        high_multi_apply, high_multi_apply_plain)
    from dqc_tpu_torch.circuit import plane_scan as ps
    from dqc_tpu_torch.ops.kernels.diag import (
        diag_backward, diag_backward_plain, diag_sweep, diag_sweep_plain)
    from dqc_tpu_torch.ops.kernels.dual_apply import dual_apply, dual_apply_plain
    from dqc_tpu_torch.ops.kernels.gram import gram, gram_plain
    from dqc_tpu_torch.ops.kernels.high_apply import high_apply, high_apply_plain
    from dqc_tpu_torch.ops.kernels.merged_fact_apply import (
        merged_fact_apply, merged_fact_apply_plain)

    # the yardsticks run in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. environment --------------------------------------------------------
    smi = nvidia_smi_line()
    try:
        import triton  # noqa: F401  (reported only; the port does not use it)
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    nvcc = _build.nvcc_path()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}")
    log(f"[env] nvcc {nvcc}: {nvcc_version(nvcc)}; triton importable: {has_triton}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f} s "
        f"into {_build.BUILD_DIR}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernel checks at the 28-qubit shapes -------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = 1 << (N_QUBITS - 14)
    amps = float(1 << N_QUBITS)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def unitary(X):
        q, _ = torch.linalg.qr(torch.complex(randn(X, X), randn(X, X))
                               .to(torch.complex128))
        q = q.to(torch.complex64)
        return q.real.contiguous(), q.imag.contiguous()

    def phases(*shape):
        z = torch.polar(torch.ones(shape, device=dev), 6.2832 * torch.rand(
            shape, generator=gen, device=dev))
        return z.real.contiguous(), z.imag.contiguous()

    def tables(a_rows):
        return (*phases(128, 128), *phases(a_rows, 128), *phases(a_rows, 128))

    def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def max_err(got, want) -> float:
        return max((got[0] - want[0]).abs().max().item(),
                   (got[1] - want[1]).abs().max().item())

    rows = []  # one per (kernel, variant)

    def check(kernel, variant, shape, fn_kernel, fn_plain, args, tol,
              flops, bytes_moved, library=None, normalize=False,
              dense_flops=None):
        xr, xi = randn(*shape), randn(*shape)
        if normalize:
            scale = (xr.double().pow(2).sum() + xi.double().pow(2).sum()).rsqrt()
            xr, xi = (xr * scale).float(), (xi * scale).float()
        want = fn_plain(xr, xi, *args)
        got = fn_kernel(xr.clone(), xi.clone(), *args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        del got, want
        require(err <= tol, f"{kernel}[{variant}] disagrees with its plain "
                            f"version: max abs err {err:.3e} > {tol:.1e}")
        work_r, work_i = xr.clone(), xi.clone()  # in place, norm-preserving
        ms = cuda_ms(lambda: fn_kernel(work_r, work_i, *args), reps=10)
        plain_ms = cuda_ms(lambda: fn_plain(xr, xi, *args), reps=3)
        lib_ms = cuda_ms(library(xr, xi), reps=3) if library else None
        b_ms, b_by = bound_ms(bytes_moved, flops)
        row = dict(kernel=kernel, variant=variant, shape=list(shape),
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if dense_flops is not None:
            # what the kernel computes: dense products, whatever the zeros
            row["dense_bound_ms"] = bound_ms(bytes_moved, dense_flops)[0]
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del xr, xi, work_r, work_i
        torch.cuda.empty_cache()

    def check_many(kernel, variant, shape, n_in, n_planes_out, fn_kernel,
                   fn_plain, tol, flops, bytes_moved, library=None,
                   intact=0, dense_flops=None):
        """A kernel of ``n_in`` input planes whose outputs are
        ``n_planes_out`` planes (held to ``tol`` abs) and then pair grams
        (held to GRAM_T0_TOL times their largest entry). ``intact``: how many
        leading inputs the kernel must leave as they were."""
        ins = [randn(*shape) for _ in range(n_in)]
        want = fn_plain(*ins)
        work = [t.clone() for t in ins]
        got = fn_kernel(*work)
        torch.cuda.synchronize()
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        plane_err = max(errs[:n_planes_out])
        gram_err = max(errs[n_planes_out:], default=0.0)
        gram_max = max((w.abs().max().item() for w in want[n_planes_out:]),
                       default=1.0)
        moved = max(((a - b).abs().max().item()
                     for a, b in zip(work[:intact], ins[:intact])), default=0.0)
        del got, want
        require(plane_err <= tol and gram_err <= GRAM_T0_TOL * gram_max,
                f"{kernel}[{variant}] disagrees with its plain version: planes "
                f"{plane_err:.3e} (tol {tol:.1e}), pair grams {gram_err:.3e} "
                f"of {gram_max:.3e} (tol {GRAM_T0_TOL:.0e} relative)")
        require(moved == 0.0, f"{kernel}[{variant}] changed its input planes")
        ms = cuda_ms(lambda: fn_kernel(*work), reps=10)
        plain_ms = cuda_ms(lambda: fn_plain(*ins), reps=3)
        lib_ms = cuda_ms(library(*ins), reps=3) if library else None
        b_ms, b_by = bound_ms(bytes_moved, flops)
        row = dict(kernel=kernel, variant=variant, shape=list(shape),
                   max_abs_err=max(errs), plane_err=plane_err,
                   gram_rel_err=gram_err / gram_max, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        if dense_flops is not None:
            row["dense_bound_ms"] = bound_ms(bytes_moved, dense_flops)[0]
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del ins, work
        torch.cuda.empty_cache()

    state_bytes = 2 * amps * 4
    table_bytes = lambda a_rows: 2 * 4 * (128 * 128 + 2 * a_rows * 128)

    # dual_apply: y = Em X El^T per slab, planes (A, 128, 128)
    el, em = unitary(128), unitary(128)

    def dual_library(xr, xi):
        x = torch.complex(xr, xi)
        elc, emc = torch.complex(*el), torch.complex(*em)
        return lambda: torch.einsum("sk,akm,lm->asl", emc, x, elc)

    for variant, tab, first in (("plain", None, True),
                                ("diag_first", tables(A), True),
                                ("diag_after", tables(A), False)):
        extra = table_bytes(A) if tab is not None else 0
        check("dual_apply", variant, (A, 128, 128), dual_apply, dual_apply_plain,
              (*el, *em, tab, first), DUAL_TOL,
              flops=amps * 2 * 128 * 8, bytes_moved=2 * state_bytes + extra,
              library=dual_library if tab is None else None)

    # high_apply: y = E x along X of the view (A1, X, M, 128)
    def high_library(E):
        def make(xr, xi):
            A1, X, M, _ = xr.shape
            x = torch.complex(xr, xi).view(A1, X, M * 128)
            Ec = torch.complex(*E)
            return lambda: torch.matmul(Ec, x)
        return make

    g2 = pl._high_view(N_QUBITS, 2)   # (128, 128, 128): the plain group-2 sweep
    g3 = pl._high_view(N_QUBITS, 3)   # (1, 128, 16384): the dhigh group-3 sweep
    x8 = (16, 8, (1 << N_QUBITS) // (16 * 8 * 128))
    for (pre, X, M), tags in ((g2, ("plain",)),
                              (g3, ("diag_first", "diag_after")),
                              (x8, ("plain", "diag_first", "diag_after"))):
        E = unitary(X)
        a_rows = pre * X * M // 128
        for tag in tags:
            tab = tables(a_rows) if tag != "plain" else None
            check("high_apply", f"X{X}_{tag}", (pre, X, M, 128), high_apply,
                  high_apply_plain, (*E, tab, tag == "diag_first"), HIGH_TOL,
                  flops=amps * X * 8,
                  bytes_moved=2 * state_bytes + (table_bytes(a_rows) if tab else 0),
                  library=high_library(E) if tab is None else None)

    # gram: (S, C) over the views (P, X, Q) of the epilogue
    def gram_library(xr, xi):
        x = torch.complex(xr, xi)
        return lambda: torch.einsum("pxq,pyq->xy", x, x.conj())

    # S is symmetric: per column of X amplitudes the function needs X(X+1)/2
    # entries of S at 2 multiply-adds each and X^2 of C, (2X + 1) per amplitude
    for variant, view in (("lane", (A * 128, 128, 1)), ("sublane", (A, 128, 128)),
                          ("high_g2", (g2[0], 128, g2[2] * 128)),
                          ("high_g3", (g3[0], 128, g3[2] * 128))):
        check("gram", variant, view, gram, gram_plain, (), GRAM_TOL,
              flops=amps * (2 * view[1] + 1) * 2, bytes_moved=state_bytes,
              library=gram_library, normalize=True)

    # the seed modes: y = acc + conj(E x) into the accumulator planes, the
    # input planes (the forward state) left intact
    def seed(apply, *ops):
        return lambda xr, xi, ar, ai: apply(xr, xi, *ops, conj=True,
                                            acc=(ar, ai), alias=False)

    # the seeds' yardsticks: the product, its conjugate and the add
    def seed_library(E):
        def make(xr, xi, ar, ai):
            A1, X, M, _ = xr.shape
            x = torch.complex(xr, xi).view(A1, X, M * 128)
            acc = torch.complex(ar, ai).view(A1, X, M * 128)
            ec = torch.complex(*E)
            return lambda: acc + torch.matmul(ec, x).conj()
        return make

    def dual_seed_library(El, Em):
        def make(xr, xi, ar, ai):
            x, acc = torch.complex(xr, xi), torch.complex(ar, ai)
            elc, emc = torch.complex(*El), torch.complex(*Em)
            return lambda: acc + torch.einsum("sk,akm,lm->asl", emc, x, elc).conj()
        return make

    check_many("dual_apply", "seed", (A, 128, 128), 4, 2,
               seed(dual_apply, *el, *em), seed(dual_apply_plain, *el, *em),
               DUAL_TOL, flops=amps * 2 * 128 * 8,
               bytes_moved=3 * state_bytes, intact=2,
               library=dual_seed_library(el, em))
    E = unitary(128)
    check_many("high_apply", "X128_seed", (g2[0], 128, g2[2], 128), 4, 2,
               seed(high_apply, *E), seed(high_apply_plain, *E), HIGH_TOL,
               flops=amps * 128 * 8, bytes_moved=3 * state_bytes, intact=2,
               library=seed_library(E))

    # block_backward_dual: (F, B) planes (A, 128, 128) rolled back through a
    # lane + sublane pair, two pair grams; 768 complex MACs per amplitude
    e0inv, e0, e1inv, e1 = unitary(128), unitary(128), unitary(128), unitary(128)
    bwd_ops = (*e0inv, *e0, *e1inv, *e1)

    def dual_bwd(fn, **kw):
        return lambda *planes: fn(*planes, *bwd_ops, **kw)

    def dual_bwd_library(fr, fi, br, bi):
        F, B = torch.complex(fr, fi), torch.complex(br, bi)
        L0i, L0, S1i, S1 = (torch.complex(*o) for o in (e0inv, e0, e1inv, e1))

        def run():  # six cuBLAS-backed complex calls, g0_first order
            F1 = torch.matmul(S1i, F)
            Ts = torch.einsum("axc,ayc->xy", B, F1)
            B1 = torch.matmul(S1.T, B)
            F0 = torch.matmul(F1, L0i.T)
            Tl = torch.einsum("arx,ary->xy", B1, F0)
            return F0, torch.matmul(B1, L0), Tl, Ts
        return run

    for variant, kw in (
            ("g0_first", dict(g0_first=True)),
            ("g1_first", dict(g0_first=False)),
            ("g0_first_diag_after", dict(g0_first=True, diag_first_fwd=False)),
            ("g0_first_diag_first", dict(g0_first=True, diag_first_fwd=True))):
        extra = 0
        if "diag_first_fwd" in kw:
            kw.update(diag_inv_tables=tables(A), diag_tables=tables(A))
            extra = 2 * table_bytes(A)
        check_many("block_backward_dual", variant, (A, 128, 128), 4, 4,
                   dual_bwd(block_backward_dual, **kw),
                   dual_bwd(block_backward_dual_plain, **kw), DUAL_TOL,
                   flops=amps * 768 * 8, bytes_moved=4 * state_bytes + extra,
                   library=dual_bwd_library if len(kw) == 1 else None)

    # block_backward_high: the same step on X of (A1, X, M, 128); 3 X
    # complex MACs per amplitude
    def high_bwd_library(E, Einv):
        def make(fr, fi, br, bi):
            A1, X, M, _ = fr.shape
            F = torch.complex(fr, fi).view(A1, X, M * 128)
            B = torch.complex(br, bi).view(A1, X, M * 128)
            Ec, Eic = torch.complex(*E), torch.complex(*Einv)

            def run():  # three cuBLAS-backed complex calls
                Fi = torch.matmul(Eic, F)
                return Fi, torch.einsum("axq,ayq->xy", B, Fi), torch.matmul(Ec.T, B)
            return run
        return make

    for (pre, X, M), tags in ((g2, ("plain",)), (g3, ("diag_after", "diag_first"))):
        E, Einv = unitary(X), unitary(X)
        a_rows = pre * X * M // 128
        for tag in tags:
            kw, extra = {}, 0
            if tag != "plain":
                kw = dict(diag_inv_tables=tables(a_rows), diag_tables=tables(a_rows),
                          diag_first_fwd=tag == "diag_first")
                extra = 2 * table_bytes(a_rows)
            check_many("block_backward_high", f"X{X}_{tag}", (pre, X, M, 128), 4, 4,
                       lambda *p: block_backward_high(*p, *Einv, *E, **kw),
                       lambda *p: block_backward_high_plain(*p, *Einv, *E, **kw),
                       HIGH_TOL, flops=amps * 3 * X * 8,
                       bytes_moved=4 * state_bytes + extra,
                       library=high_bwd_library(E, Einv) if tag == "plain" else None)

    # 3b. kernel checks at the 29- and 30-qubit shapes ------------------------
    A29 = 1 << (N29 - 14)
    amps29 = float(1 << N29)
    state29 = 2 * amps29 * 4

    # the 28-qubit path's kernels at the 29-qubit path's own shapes: the
    # rotated body's dual sweep (the ring's run folded first) and its
    # adjoint, the group-2 sweep and its adjoint, the Grams of groups 0-2 and
    # the seeds of groups 0-2
    el29, em29 = unitary(128), unitary(128)
    check("dual_apply", "29q_diag_first", (A29, 128, 128), dual_apply,
          dual_apply_plain, (*el29, *em29, tables(A29), True), DUAL_TOL,
          flops=amps29 * 2 * 128 * 8, bytes_moved=2 * state29 + table_bytes(A29))
    g2_29 = pl._high_view(N29, 2)   # (32768, 128, 128): the group-2 sweep
    E = unitary(128)
    check("high_apply", "29q_X128_plain", (g2_29[0], 128, g2_29[2], 128),
          high_apply, high_apply_plain, (*E, None, True), HIGH_TOL,
          flops=amps29 * 128 * 8, bytes_moved=2 * state29, library=high_library(E))
    for variant, view in (("29q_lane", (A29 * 128, 128, 1)),
                          ("29q_sublane", (A29, 128, 128)),
                          ("29q_high_g2", (g2_29[0], 128, g2_29[2] * 128))):
        check("gram", variant, view, gram, gram_plain, (), GRAM_TOL,
              flops=amps29 * (2 * view[1] + 1) * 2, bytes_moved=state29,
              library=gram_library, normalize=True)
    check_many("dual_apply", "29q_seed", (A29, 128, 128), 4, 2,
               seed(dual_apply, *el29, *em29), seed(dual_apply_plain, *el29, *em29),
               DUAL_TOL, flops=amps29 * 2 * 128 * 8,
               bytes_moved=3 * state29, intact=2,
               library=dual_seed_library(el29, em29))
    check_many("high_apply", "29q_X128_seed", (g2_29[0], 128, g2_29[2], 128), 4, 2,
               seed(high_apply, *E), seed(high_apply_plain, *E), HIGH_TOL,
               flops=amps29 * 128 * 8, bytes_moved=3 * state29, intact=2,
               library=seed_library(E))
    kw = dict(g0_first=True, diag_first_fwd=True, diag_inv_tables=tables(A29),
              diag_tables=tables(A29))
    check_many("block_backward_dual", "29q_g0_first_diag_first", (A29, 128, 128),
               4, 4, dual_bwd(block_backward_dual, **kw),
               dual_bwd(block_backward_dual_plain, **kw), DUAL_TOL,
               flops=amps29 * 768 * 8,
               bytes_moved=4 * state29 + 2 * table_bytes(A29))
    E, Einv = unitary(128), unitary(128)
    check_many("block_backward_high", "29q_X128_plain",
               (g2_29[0], 128, g2_29[2], 128), 4, 4,
               lambda *p: block_backward_high(*p, *Einv, *E),
               lambda *p: block_backward_high_plain(*p, *Einv, *E), HIGH_TOL,
               flops=amps29 * 3 * 128 * 8, bytes_moved=4 * state29,
               library=high_bwd_library(E, Einv))

    # the merged top axis: (1, Xt 128, M, 128) at 2^29 amplitudes, Xt = 2 as
    # at 29 qubits and Xt = 4 as at 30 (its M cut to half, so that the plain
    # versions fit beside the kernel's planes)
    merged_shapes = ((2, (1, 256, 1 << 14, 128)), (4, (1, 512, 1 << 13, 128)))

    def merged_library(El, Et, x_top):
        def make(xr, xi):
            A1, _, M, _ = xr.shape
            x = torch.complex(xr, xi).view(A1, x_top, 128, M * 128)
            elc, etc = torch.complex(*El), torch.complex(*Et)
            return lambda: torch.einsum("ab,dk,ibkq->iadq", etc, elc, x)
        return make

    def merged_bwd_library(Eli, El, Eti, Et, x_top):
        def make(fr, fi, br, bi):
            A1, _, M, _ = fr.shape
            v = (A1, x_top, 128, M * 128)
            F, B = torch.complex(fr, fi).view(v), torch.complex(br, bi).view(v)
            lic, lc, tic, tc = (torch.complex(*o) for o in (Eli, El, Eti, Et))

            def run():  # six cuBLAS-backed matmul / einsum calls
                fB = torch.matmul(lic, F)
                t_low = torch.einsum("iaxq,iayq->xy", B, fB)
                t_top = torch.einsum("ixdq,yb,ibdq->xy", B, tic, F)
                fin = torch.einsum("ab,ibdq->iadq", tic, fB)
                bout = torch.einsum("ba,ibdq->iadq", tc, torch.matmul(lc.T, B))
                return fin, bout, t_top, t_low
            return run
        return make

    for x_top, shape in merged_shapes:
        X = shape[1]
        El, Et = unitary(128), unitary(x_top)
        check("merged_fact_apply", f"Xt{x_top}", shape,
              lambda xr, xi, *a, xt=x_top: merged_fact_apply(xr, xi, *a, x_top=xt),
              lambda xr, xi, *a, xt=x_top: merged_fact_apply_plain(xr, xi, *a,
                                                                   x_top=xt),
              (*El, *Et), HIGH_TOL, flops=amps29 * (128 + x_top) * 8,
              bytes_moved=2 * state29, library=merged_library(El, Et, x_top))
        Eli, Eti = unitary(128), unitary(x_top)
        ops = (*Eli, *El, *Eti, *Et)
        check_many("block_backward_merged_fact", f"Xt{x_top}", shape, 4, 4,
                   lambda *p, xt=x_top: block_backward_merged_fact(*p, *ops, x_top=xt),
                   lambda *p, xt=x_top: block_backward_merged_fact_plain(
                       *p, *ops, x_top=xt), HIGH_TOL,
                   flops=amps29 * 3 * (128 + x_top) * 8, bytes_moved=4 * state29,
                   library=merged_bwd_library(Eli, El, Eti, Et, x_top))
        check("gram", f"merged_X{X}", (1, X, shape[2] * 128), gram, gram_plain, (),
              GRAM_TOL, flops=amps29 * (2 * X + 1) * 2, bytes_moved=state29,
              library=gram_library, normalize=True)
        E = unitary(X)
        check_many("high_apply", f"X{X}_seed", shape, 4, 2, seed(high_apply, *E),
                   seed(high_apply_plain, *E), HIGH_TOL, flops=amps29 * X * 8,
                   bytes_moved=3 * state29, intact=2, library=seed_library(E))

    # the diagonal-run kernels on the 29-qubit planes: x *= D, and (F, B) <-
    # (F Dinv, B D); D = (tas tal) tsl is 18 real flops per amplitude
    def diag_library(*tabs):
        def make(*planes):
            d = []
            for t in tabs:
                tsl, tas, tal = (torch.complex(t[k], t[k + 1]) for k in (0, 2, 4))
                d.append((tsl, tas, tal))
            xs = [torch.complex(planes[k], planes[k + 1])
                  for k in range(0, len(planes), 2)]
            return lambda: [x * ((tas[:, :, None] * tal[:, None, :]) * tsl)
                            for x, (tsl, tas, tal) in zip(xs, d)]
        return make

    tab, tab_inv = tables(A29), tables(A29)
    check("diag_sweep", "29q", (A29, 128, 128), diag_sweep, diag_sweep_plain, tab,
          DIAG_TOL, flops=amps29 * 18, bytes_moved=2 * state29 + table_bytes(A29),
          library=diag_library(tab))
    check_many("diag_backward", "29q", (A29, 128, 128), 4, 4,
               lambda *p: diag_backward(*p, *tab_inv, *tab),
               lambda *p: diag_backward_plain(*p, *tab_inv, *tab), DIAG_TOL,
               flops=amps29 * 36, bytes_moved=4 * state29 + 2 * table_bytes(A29),
               library=diag_library(tab_inv, tab))
    del tab, tab_inv

    # 3c. the CNOT ring's kernels ---------------------------------------------
    # on the operators the port stages for the ring's gates: the Schmidt terms
    # of the (6, 7) CNOT (T = 2) and of a random 2-qubit unitary (T = 4) for
    # dual_multi_apply, the span terms of the closing (0, n - 1) CNOT for
    # high_multi_apply, the X = 8 span operators of the high-boundary CNOTs
    # for the high apply and its adjoint. Their factors are sparse (a 2 x 2
    # factor expanded over a group, a projector on one lane bit), so the
    # bound counts the nonzeros this run's operators have; the kernels do
    # dense products (dense_bound_ms).
    cnot = np.array(CNOT, np.complex64)
    rng = np.random.default_rng(SEED)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))
    rand_gate = q.astype(np.complex64)

    def macs(op_r, op_i) -> float:
        """Complex multiply-adds per amplitude of applying an operator (or
        a stack of them, summed) along its axis: its nonzeros per row."""
        return ((op_r != 0) | (op_i != 0)).sum().item() / op_r.shape[-2]

    def dual_multi_library(ops):
        def make(xr, xi):
            x = torch.complex(xr, xi)
            elc, emc = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
            return lambda: torch.einsum("tsk,akm,tlm->asl", emc, x, elc)
        return make

    def high_multi_library(ops):
        def make(xr, xi):
            x = torch.complex(xr, xi)
            ehc, elc = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
            return lambda: torch.einsum("txy,iymk,tlk->ixml", ehc, x, elc)
        return make

    def sublane_library(E, Einv):
        def make(fr, fi, br, bi):
            F, B = torch.complex(fr, fi), torch.complex(br, bi)
            Ec, Eic = torch.complex(*E), torch.complex(*Einv)

            def run():  # three cuBLAS-backed complex calls
                F1 = torch.matmul(Eic, F)
                return F1, torch.einsum("axc,ayc->xy", B, F1), torch.matmul(Ec.T, B)
            return run
        return make

    for nq in (N_QUBITS, N29):
        a_n, amps_n = 1 << (nq - 14), float(1 << nq)
        st = 2 * amps_n * 4
        for tag, gate in (("T2_cnot", cnot), ("T4_unitary", rand_gate)):
            kind, *ops = pl.cross_terms_operands(
                ps._dense_cross_expanded_terms(gate, (6, 7), nq), nq, dev)
            T = ops[0].shape[0]
            require(kind == "dual" and T == int(tag[1]), f"dual_multi terms {kind} {T}")
            check("dual_multi_apply", f"{nq}q_{tag}", (a_n, 128, 128),
                  dual_multi_apply, dual_multi_apply_plain, ops, DUAL_TOL,
                  flops=amps_n * (macs(*ops[:2]) + macs(*ops[2:])) * 8,
                  bytes_moved=2 * st, library=dual_multi_library(ops),
                  dense_flops=amps_n * 2 * 128 * T * 8)
        kind, vshape, *ops = pl.cross_span_operands(cnot, (0, nq - 1), nq, dev)
        require(kind == "multi" and vshape == (1, 8, 1 << (nq - 10), 128),
                f"closing CNOT span view {kind} {vshape}")
        T = ops[0].shape[0]
        check("high_multi_apply", f"{nq}q_T{T}_cnot", vshape, high_multi_apply,
              high_multi_apply_plain, ops, HIGH_TOL,
              flops=amps_n * (macs(*ops[:2]) + macs(*ops[2:])) * 8,
              bytes_moved=2 * st, library=high_multi_library(ops),
              dense_flops=amps_n * (128 + 8) * T * 8)
        E, Einv = unitary(128), unitary(128)
        check_many("block_backward_sublane", f"{nq}q", (a_n, 128, 128), 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_sublane(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_sublane_plain(
                       *p, *Einv, *E), DUAL_TOL,
                   flops=amps_n * 384 * 8, bytes_moved=4 * st,
                   library=sublane_library(E, Einv))

    # the 29q path's high boundaries (13, 14), (20, 21), (27, 28): the high
    # apply and its adjoint on X = 8 span views
    cnot_inv = cnot.conj().T.copy()
    for pos in ((13, 14), (20, 21), (27, 28)):
        kind, vshape, er, ei = pl.cross_span_operands(cnot, pos, N29, dev)
        require(kind == "high" and vshape[1] == 8, f"span view {kind} {vshape}")
        check("high_apply", f"29q_X8_span{pos[0]}", vshape, high_apply,
              high_apply_plain, (er, ei, None, True), HIGH_TOL,
              flops=amps29 * macs(er, ei) * 8, bytes_moved=2 * state29,
              library=high_library((er, ei)), dense_flops=amps29 * 8 * 8)
        _, _, _, *bops = pl.backward_span_operands(cnot, cnot_inv, pos, N29, dev)
        check_many("block_backward_high", f"29q_X8_span{pos[0]}", vshape, 4, 4,
                   lambda *p, b=bops: block_backward_high(*p, *b),
                   lambda *p, b=bops: block_backward_high_plain(*p, *b), HIGH_TOL,
                   flops=amps29 * (macs(*bops[:2]) + macs(*bops[2:]) + 8) * 8,
                   bytes_moved=4 * state29,
                   library=high_bwd_library(bops[2:], bops[:2]),
                   dense_flops=amps29 * 3 * 8 * 8)

    # the 29q cnot path's other sweeps: the dual pair without a run, group 3's
    # X = 128 sweep (view (2, 128, 16384, 128)) and their adjoints
    el29b, em29b = unitary(128), unitary(128)
    check("dual_apply", "29q_plain", (A29, 128, 128), dual_apply,
          dual_apply_plain, (*el29b, *em29b, None, True), DUAL_TOL,
          flops=amps29 * 2 * 128 * 8, bytes_moved=2 * state29,
          library=lambda xr, xi: dual_multi_library(
              [o[None] for o in (*el29b, *em29b)])(xr, xi))
    g3_29 = pl._high_view(N29, 3)
    E, Einv = unitary(128), unitary(128)
    check("high_apply", "29q_X128_g3", (g3_29[0], 128, g3_29[2], 128), high_apply,
          high_apply_plain, (*E, None, True), HIGH_TOL, flops=amps29 * 128 * 8,
          bytes_moved=2 * state29, library=high_library(E))
    check_many("block_backward_high", "29q_X128_g3", (g3_29[0], 128, g3_29[2], 128),
               4, 4, lambda *p: block_backward_high(*p, *Einv, *E),
               lambda *p: block_backward_high_plain(*p, *Einv, *E), HIGH_TOL,
               flops=amps29 * 3 * 128 * 8, bytes_moved=4 * state29,
               library=high_bwd_library(E, Einv))
    check_many("block_backward_dual", "29q_g0_first", (A29, 128, 128), 4, 4,
               dual_bwd(block_backward_dual, g0_first=True),
               dual_bwd(block_backward_dual_plain, g0_first=True), DUAL_TOL,
               flops=amps29 * 768 * 8, bytes_moved=4 * state29,
               library=dual_bwd_library)

    # 4. the forward: 28 qubits x 100 layers, cz ring --------------------------
    model = HardwareEfficientAnsatz(N_QUBITS, LAYERS, entangler="cz")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dens = model.densities(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fwd_counts = K.launch_counts()
    log(f"[slice] {N_QUBITS}q x {LAYERS}L forward through the kernels: "
        f"{first_s:.3f} s (first call); launches {json.dumps(fwd_counts)}")
    for name in ("dual_apply", "high_apply", "gram"):
        require(fwd_counts[name] > 0,
                f"kernel {name} was not launched on the forward path")
    D = torch.stack(dens)
    require(tuple(D.shape) == (N_QUBITS, 2, 2), f"densities of shape {tuple(D.shape)}")
    require(bool(torch.isfinite(torch.view_as_real(D)).all()), "non-finite densities")
    herm = (D - D.conj().transpose(1, 2)).abs().max().item()
    trace = (torch.diagonal(D, dim1=1, dim2=2).sum(-1) - 1).abs().max().item()
    mag = model.magnetization(params).item()
    log(f"[slice] magnetization {mag:.6f}; max |rho - rho^H| {herm:.2e}; "
        f"max |tr rho - 1| {trace:.2e}")
    require(herm <= 1e-6 and trace <= 1e-4 and abs(mag) <= N_QUBITS,
            "densities are not unit-trace Hermitian matrices")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.magnetization(params).item()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] step (warm) {step_s:.4f} s = {step_s / LAYERS * 1e3:.2f} ms/layer; "
        f"{model.num_gates / step_s:.1f} gates/s; peak memory {peak / 2**30:.3f} GiB")
    # where the step goes: each layer is one dual sweep, one plain group-2
    # sweep and one group-3 sweep with the ring's run after it; the epilogue
    # is one Gram per group
    per_launch = {(r["kernel"], r["variant"]): r["ms"] for r in rows}
    kernel_ms = (LAYERS * (per_launch["dual_apply", "plain"]
                           + per_launch["high_apply", "X128_plain"]
                           + per_launch["high_apply", "X128_diag_after"])
                 + sum(per_launch["gram", v]
                       for v in ("lane", "sublane", "high_g2", "high_g3")))
    log(f"[slice] kernel time per step (launches x per-launch ms above): "
        f"{kernel_ms:.1f} ms = {100 * kernel_ms / (step_s * 1e3):.1f}% of the step; "
        f"the rest ({step_s * 1e3 - kernel_ms:.1f} ms) is host work and launch gaps")

    zero = model.magnetization(torch.zeros(LAYERS, N_QUBITS, 3)).item()
    log(f"[slice] params = 0: magnetization {zero!r} (want {N_QUBITS})")
    require(abs(zero - N_QUBITS) <= ZERO_TOL, "params = 0 known answer failed")

    short = HardwareEfficientAnsatz(N_QUBITS, CHECK_LAYERS, entangler="cz")
    p20 = 7.0 * short.init_params(torch.Generator().manual_seed(SEED + 1))
    d_k = torch.stack(short.densities(p20))
    d_p = torch.stack(short.densities(p20, kernels=K.PLAIN))
    slice_err = (d_k - d_p).abs().max().item()
    m_k = sum(float((d[0, 0] - d[1, 1]).real) for d in d_k)
    m_p = sum(float((d[0, 0] - d[1, 1]).real) for d in d_p)
    log(f"[slice] {N_QUBITS}q x {CHECK_LAYERS}L kernels vs plain path: max abs "
        f"density err {slice_err:.3e} (tol {SLICE_TOL:.0e}); magnetization "
        f"{m_k:.7f} vs {m_p:.7f}")
    require(slice_err <= SLICE_TOL, "kernel path disagrees with the plain path")
    require(abs(m_k - m_p) <= SLICE_TOL * N_QUBITS, "magnetization disagrees")

    # 5. the gradient: value_and_grad of the magnetization, 28q x 100L --------
    params.requires_grad_(True)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss = model.magnetization(params)
    loss.backward()
    torch.cuda.synchronize()
    vg_first_s = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[grad] {N_QUBITS}q x {LAYERS}L value_and_grad through the kernels: "
        f"{vg_first_s:.3f} s (first call); launches {json.dumps(counts)}")
    # per step: the forward's sweeps, one seed apply per group (two dual, two
    # high), and one backward sweep per forward sweep
    want = dict.fromkeys(counts, 0)
    want.update({"dual_apply": LAYERS + 2, "high_apply": 2 * LAYERS + 2,
                 "gram": 4, "block_backward_dual": LAYERS,
                 "block_backward_high": 2 * LAYERS})
    require(counts == want, f"launch counts {counts}, want {want}")
    grad = params.grad.detach().clone()
    require(bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0,
            "gradient is not finite and nonzero")
    log(f"[grad] value {loss.item():.6f}; |grad| max {grad.abs().max().item():.4e}, "
        f"rms {grad.pow(2).mean().sqrt().item():.4e}")

    params.grad = None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = model.magnetization(params)
    loss.backward()
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    vg_peak = torch.cuda.max_memory_allocated()
    drift = (params.grad - grad).abs().max().item()
    with torch.no_grad():
        t0 = time.perf_counter()
        model.magnetization(params).item()
        fwd_s = time.perf_counter() - t0
    log(f"[grad] value_and_grad step (warm) {vg_s:.4f} s = "
        f"{vg_s / LAYERS * 1e3:.2f} ms/layer; forward-only step {fwd_s:.4f} s; "
        f"ratio {vg_s / fwd_s:.2f}; peak memory {vg_peak / 2**30:.3f} GiB; "
        f"grad vs first call max abs {drift:.3e}")
    require(drift <= GRAD_TOL, "two value_and_grad steps disagree")
    bwd_ms = (LAYERS * (per_launch["block_backward_dual", "g0_first"]
                        + per_launch["block_backward_high", "X128_plain"]
                        + per_launch["block_backward_high", "X128_diag_after"])
              + 2 * per_launch["dual_apply", "seed"]
              + 2 * per_launch["high_apply", "X128_seed"])
    log(f"[grad] kernel time per step (launches x per-launch ms above): forward "
        f"{kernel_ms:.1f} ms + seeds and backward {bwd_ms:.1f} ms = "
        f"{100 * (kernel_ms + bwd_ms) / (vg_s * 1e3):.1f}% of the step")
    del params, grad, loss
    torch.cuda.empty_cache()

    def closed_form(n: int, tag: str) -> float:
        """n x 1L at params (alpha, 0, 0): <Z_i> = cos alpha_i, so the
        gradient is (-sin alpha, 0, 0). Returns the gradient error."""
        one = HardwareEfficientAnsatz(n, 1, entangler="cz")
        alpha = torch.linspace(-1.3, 1.4, n, dtype=torch.float64)
        p1 = torch.zeros(1, n, 3, dtype=torch.float64)
        p1[0, :, 0] = alpha
        p1 = p1.float().to(dev).requires_grad_(True)
        v1 = one.magnetization(p1)
        v1.backward()
        g1 = p1.grad[0].double().cpu()
        a32 = alpha.float().double()
        val_err = abs(v1.item() - torch.cos(a32).sum().item())
        closed_err = max((g1[:, 0] + torch.sin(a32)).abs().max().item(),
                         g1[:, 1:].abs().max().item())
        log(f"[{tag}] {n}q x 1L closed form: value err {val_err:.3e}, gradient "
            f"err {closed_err:.3e} vs (-sin alpha, 0, 0) (tol {CLOSED_TOL:.0e})")
        require(val_err <= CLOSED_TOL * n and closed_err <= CLOSED_TOL,
                f"the {n}-qubit 1-layer closed-form gradient failed")
        return closed_err

    def kernels_vs_plain(n: int, tag: str, entangler: str = "cz") -> float:
        """n x GRAD_LAYERS gradients through the kernels and through the
        plain versions, on the card."""
        four = HardwareEfficientAnsatz(n, GRAD_LAYERS, entangler=entangler)
        p4 = (7.0 * four.init_params(torch.Generator().manual_seed(SEED + 2))
              ).requires_grad_(True)
        four.magnetization(p4).backward()
        g_k = p4.grad.clone()
        p4.grad = None
        four.magnetization(p4, kernels=K.PLAIN).backward()
        grad_err = (g_k - p4.grad).abs().max().item()
        log(f"[{tag}] {n}q x {GRAD_LAYERS}L {entangler} gradient, kernels vs plain "
            f"path: max abs err {grad_err:.3e} (tol {GRAD_TOL:.0e}); |grad| max "
            f"{g_k.abs().max().item():.3e}")
        require(grad_err <= GRAD_TOL,
                f"{n}-qubit kernel-path gradient disagrees with the plain path")
        torch.cuda.empty_cache()
        return grad_err

    closed_form(N_QUBITS, "grad")
    kernels_vs_plain(N_QUBITS, "grad")

    # 6. the 29-qubit path: 29 qubits x 100 layers, the bench workload -------
    m29 = HardwareEfficientAnsatz(N29, LAYERS, entangler="cz")
    p29 = m29.init_params(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dens29 = m29.densities(p29)
    torch.cuda.synchronize()
    first29_s = time.perf_counter() - t0
    fwd29 = K.launch_counts()
    log(f"[slice29] {N29}q x {LAYERS}L forward through the kernels: "
        f"{first29_s:.3f} s (first call); launches {json.dumps(fwd29)}")
    # the rotated program: the head [dual, high g2, merged] and L - 1 bodies
    # [dual with the ring's run folded first, high g2, merged], then the run
    # on its own; one Gram each for groups 0, 1, 2 and one merged-axis Gram
    # for groups 3 and 4
    want29 = dict.fromkeys(fwd29, 0)
    want29.update({"dual_apply": LAYERS, "high_apply": LAYERS,
                   "merged_fact_apply": LAYERS, "diag_sweep": 1, "gram": 4})
    require(fwd29 == want29, f"29q forward launch counts {fwd29}, want {want29}")
    D = torch.stack(dens29)
    require(tuple(D.shape) == (N29, 2, 2), f"densities of shape {tuple(D.shape)}")
    require(bool(torch.isfinite(torch.view_as_real(D)).all()), "non-finite densities")
    herm = (D - D.conj().transpose(1, 2)).abs().max().item()
    trace = (torch.diagonal(D, dim1=1, dim2=2).sum(-1) - 1).abs().max().item()
    require(herm <= 1e-6 and trace <= 1e-4,
            "29q densities are not unit-trace Hermitian matrices")
    del dens29, D
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mag29 = m29.magnetization(p29).item()
    step29_s = time.perf_counter() - t0
    peak29 = torch.cuda.max_memory_allocated()
    log(f"[slice29] magnetization {mag29:.6f}; max |rho - rho^H| {herm:.2e}; "
        f"max |tr rho - 1| {trace:.2e}; step (warm) {step29_s:.4f} s = "
        f"{step29_s / LAYERS * 1e3:.2f} ms/layer; {m29.num_gates / step29_s:.1f} "
        f"gates/s; peak memory {peak29 / 2**30:.3f} GiB")
    fwd29_ms = (LAYERS * (per_launch["dual_apply", "29q_diag_first"]
                          + per_launch["high_apply", "29q_X128_plain"]
                          + per_launch["merged_fact_apply", "Xt2"])
                + per_launch["diag_sweep", "29q"]
                + sum(per_launch["gram", v] for v in
                      ("29q_lane", "29q_sublane", "29q_high_g2", "merged_X256")))
    log(f"[slice29] kernel time per step (launches x per-launch ms above): "
        f"{fwd29_ms:.1f} ms = {100 * fwd29_ms / (step29_s * 1e3):.1f}% of the step")

    p29.requires_grad_(True)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss29 = m29.magnetization(p29)
    loss29.backward()
    torch.cuda.synchronize()
    vg29_first_s = time.perf_counter() - t0
    counts29 = K.launch_counts()
    log(f"[grad29] {N29}q x {LAYERS}L value_and_grad through the kernels: "
        f"{vg29_first_s:.3f} s (first call); launches {json.dumps(counts29)}")
    # per step: the forward's launches, the seeds (two dual for groups 0 and
    # 1, one high for group 2, one merged-axis high apply at X = 256 for
    # groups 3 and 4), the run's adjoint and one backward sweep per sweep;
    # the CNOT ring's kernels not at all
    want29 = dict.fromkeys(counts29, 0)
    want29.update({"dual_apply": LAYERS + 2, "high_apply": LAYERS + 2, "gram": 4,
                   "block_backward_dual": LAYERS, "block_backward_high": LAYERS,
                   "merged_fact_apply": LAYERS, "block_backward_merged_fact": LAYERS,
                   "diag_sweep": 1, "diag_backward": 1})
    require(counts29 == want29, f"29q launch counts {counts29}, want {want29}")
    grad29 = p29.grad.detach().clone()
    require(bool(torch.isfinite(grad29).all()) and grad29.abs().max().item() > 0,
            "29q gradient is not finite and nonzero")
    log(f"[grad29] value {loss29.item():.6f}; |grad| max "
        f"{grad29.abs().max().item():.4e}, rms {grad29.pow(2).mean().sqrt().item():.4e}")
    p29.grad = None
    del loss29
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss29 = m29.magnetization(p29)
    loss29.backward()
    torch.cuda.synchronize()
    vg29_s = time.perf_counter() - t0
    vg29_peak = torch.cuda.max_memory_allocated()
    drift29 = (p29.grad - grad29).abs().max().item()
    log(f"[grad29] value_and_grad step (warm) {vg29_s:.4f} s = "
        f"{vg29_s / LAYERS * 1e3:.2f} ms/layer; forward-only step {step29_s:.4f} s; "
        f"ratio {vg29_s / step29_s:.2f}; peak memory {vg29_peak / 2**30:.3f} GiB; "
        f"grad vs first call max abs {drift29:.3e}")
    require(drift29 <= GRAD_TOL, "two 29q value_and_grad steps disagree")
    bwd29_ms = (LAYERS * (per_launch["block_backward_dual", "29q_g0_first_diag_first"]
                          + per_launch["block_backward_high", "29q_X128_plain"]
                          + per_launch["block_backward_merged_fact", "Xt2"])
                + per_launch["diag_backward", "29q"]
                + 2 * per_launch["dual_apply", "29q_seed"]
                + per_launch["high_apply", "29q_X128_seed"]
                + per_launch["high_apply", "X256_seed"])
    log(f"[grad29] kernel time per step (launches x per-launch ms above): forward "
        f"{fwd29_ms:.1f} ms + seeds and backward {bwd29_ms:.1f} ms = "
        f"{100 * (fwd29_ms + bwd29_ms) / (vg29_s * 1e3):.1f}% of the step")
    del m29, p29, grad29, loss29
    torch.cuda.empty_cache()

    closed_form(N29, "grad29")
    closed_form(N30, "grad29")
    three = HardwareEfficientAnsatz(N30, 3, entangler="cz")
    p3 = torch.zeros(3, N30, 3, device=dev, requires_grad=True)
    K.reset_launch_counts()
    v3 = three.magnetization(p3)
    v3.backward()
    c3 = K.launch_counts()
    g3_max = p3.grad.abs().max().item()
    log(f"[grad29] {N30}q x 3L params = 0: magnetization {v3.item()!r} (want "
        f"{N30}); |grad| max {g3_max:.3e}; launches {json.dumps(c3)}")
    require(abs(v3.item() - N30) <= ZERO_TOL and g3_max <= CLOSED_TOL,
            "the 30q params = 0 known answer failed")
    require(c3["merged_fact_apply"] == 3 and c3["block_backward_merged_fact"] == 3,
            "the 30q run did not go through the merged kernels")
    del three, p3, v3
    torch.cuda.empty_cache()
    kernels_vs_plain(N29, "grad29")

    # 7. the CNOT ring: 29 qubits x 20 layers ---------------------------------
    mc = HardwareEfficientAnsatz(N29, CNOT_LAYERS, entangler="cnot")
    pc = mc.init_params(torch.Generator().manual_seed(SEED))

    def cnot_program(model, n: int):
        """Per-layer (kernel, variant) launches of the ring's layer program,
        forward and backward, from its plan items and the port's dispatch
        (variants name the kernel rows above)."""
        ftape = model._layer_ftape
        fwd, bwd = [], []
        for item in ps.plane_program(ftape):
            fi = ftape.instructions[item[1]]
            if item[0] == "dense" and (item[2] is not None or fi.group < 2):
                fwd.append(("dual_apply", f"{n}q_plain"))
                require(item[2] is not None or fi.group == 1, f"item {item}")
                bwd.append(("block_backward_dual", f"{n}q_g0_first")
                           if item[2] is not None
                           else ("block_backward_sublane", f"{n}q"))
            elif item[0] == "dense":
                pre, X, M = pl._high_view(n, fi.group)
                require(X == 128, f"item {item} at X = {X}")
                v = f"{n}q_X128_plain" if fi.group == 2 else f"{n}q_X128_g{fi.group}"
                fwd.append(("high_apply", v))
                bwd.append(("block_backward_high", v))
            elif item[0] == "hpair":
                fwd.append(("merged_fact_apply", "Xt2"))
                bwd.append(("block_backward_merged_fact", "Xt2"))
            else:
                require(item[0] == "dcross", f"item {item}")
                kind, ops = ps._cross_plan(cnot, fi.positions, n, dev)
                sub = ops[0]
                if kind == "span" and sub == "high":
                    v = ("high_apply", f"{n}q_X8_span{min(fi.positions)}")
                elif kind == "span" and sub == "multi":
                    v = ("high_multi_apply", f"{n}q_T2_cnot")
                else:
                    require(kind == "terms" and sub == "dual", f"plan {kind} {sub}")
                    v = ("dual_multi_apply", f"{n}q_T2_cnot")
                fwd.append(v)
                if pl.backward_span_eligible(fi.positions, n):
                    bwd.append(("block_backward_high", v[1]))
                else:  # uncompute with G^-1, transport with G^T
                    bwd += [v, v]
        return fwd, bwd

    fwd_items, bwd_items = cnot_program(mc, N29)
    # the epilogue: a Gram each for groups 0, 1, 2 and one merged-axis Gram
    # for groups 3 and 4; the seeds: two dual, one high (group 2), one
    # merged-axis high apply at X = 256
    grams = [("gram", v) for v in ("29q_lane", "29q_sublane", "29q_high_g2",
                                   "merged_X256")]
    seeds = [("dual_apply", "29q_seed")] * 2 + [("high_apply", "29q_X128_seed"),
                                               ("high_apply", "X256_seed")]
    fwd_step = CNOT_LAYERS * fwd_items + grams
    vg_step = CNOT_LAYERS * (fwd_items + bwd_items) + grams + seeds
    names = list(K.launch_counts())
    want_fwd = dict.fromkeys(names, 0)
    want_fwd.update(Counter(k for k, _ in fwd_step))
    want_vg = dict.fromkeys(names, 0)
    want_vg.update(Counter(k for k, _ in vg_step))
    log(f"[cnot29] per layer: forward {json.dumps(Counter(k for k, _ in fwd_items))}; "
        f"backward {json.dumps(Counter(k for k, _ in bwd_items))}")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    densc = mc.densities(pc)
    torch.cuda.synchronize()
    firstc_s = time.perf_counter() - t0
    fwdc = K.launch_counts()
    log(f"[cnot29] {N29}q x {CNOT_LAYERS}L cnot forward through the kernels: "
        f"{firstc_s:.3f} s (first call); launches {json.dumps(fwdc)}")
    require(fwdc == want_fwd, f"cnot29 forward launch counts {fwdc}, want {want_fwd}")
    D = torch.stack(densc)
    require(tuple(D.shape) == (N29, 2, 2), f"densities of shape {tuple(D.shape)}")
    require(bool(torch.isfinite(torch.view_as_real(D)).all()), "non-finite densities")
    herm = (D - D.conj().transpose(1, 2)).abs().max().item()
    trace = (torch.diagonal(D, dim1=1, dim2=2).sum(-1) - 1).abs().max().item()
    require(herm <= 1e-6 and trace <= 1e-4,
            "cnot29 densities are not unit-trace Hermitian matrices")
    del densc, D
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    magc = mc.magnetization(pc).item()
    stepc_s = time.perf_counter() - t0
    peakc = torch.cuda.max_memory_allocated()
    fwdc_ms = sum(per_launch[kv] for kv in fwd_step)
    log(f"[cnot29] magnetization {magc:.6f}; max |rho - rho^H| {herm:.2e}; "
        f"max |tr rho - 1| {trace:.2e}; step (warm) {stepc_s:.4f} s = "
        f"{stepc_s / CNOT_LAYERS * 1e3:.2f} ms/layer; peak memory "
        f"{peakc / 2**30:.3f} GiB; kernel time per step (launches x per-launch "
        f"ms above) {fwdc_ms:.1f} ms = {100 * fwdc_ms / (stepc_s * 1e3):.1f}% of the step")

    pc.requires_grad_(True)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lossc = mc.magnetization(pc)
    lossc.backward()
    torch.cuda.synchronize()
    vgc_first_s = time.perf_counter() - t0
    countsc = K.launch_counts()
    log(f"[cnot29] {N29}q x {CNOT_LAYERS}L cnot value_and_grad through the "
        f"kernels: {vgc_first_s:.3f} s (first call); launches {json.dumps(countsc)}")
    require(countsc == want_vg, f"cnot29 launch counts {countsc}, want {want_vg}")
    gradc = pc.grad.detach().clone()
    require(bool(torch.isfinite(gradc).all()) and gradc.abs().max().item() > 0,
            "cnot29 gradient is not finite and nonzero")
    pc.grad = None
    del lossc
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lossc = mc.magnetization(pc)
    lossc.backward()
    torch.cuda.synchronize()
    vgc_s = time.perf_counter() - t0
    vgc_peak = torch.cuda.max_memory_allocated()
    driftc = (pc.grad - gradc).abs().max().item()
    vgc_ms = sum(per_launch[kv] for kv in vg_step)
    log(f"[cnot29] value {lossc.item():.6f}; |grad| max {gradc.abs().max().item():.4e}, "
        f"rms {gradc.pow(2).mean().sqrt().item():.4e}; value_and_grad step (warm) "
        f"{vgc_s:.4f} s = {vgc_s / CNOT_LAYERS * 1e3:.2f} ms/layer; forward-only "
        f"step {stepc_s:.4f} s; ratio {vgc_s / stepc_s:.2f}; peak memory "
        f"{vgc_peak / 2**30:.3f} GiB; grad vs first call max abs {driftc:.3e}")
    require(driftc <= GRAD_TOL, "two cnot29 value_and_grad steps disagree")
    by_kernel = Counter()
    for k, v in vg_step:
        by_kernel[k] += per_launch[k, v]
    log(f"[cnot29] kernel time per step (launches x per-launch ms above): "
        f"{vgc_ms:.1f} ms = {100 * vgc_ms / (vgc_s * 1e3):.1f}% of the step; by "
        f"kernel {json.dumps({k: round(t, 2) for k, t in by_kernel.most_common()})}")
    del mc, pc, gradc, lossc
    torch.cuda.empty_cache()

    def cnot_closed_form(n: int) -> None:
        """n x 1L at params (alpha, 0, 0): the ring's CNOTs (control first)
        give <Z_k> = prod_{j <= k} cos alpha_j for k < n - 1, and the
        closing CNOT <Z_{n-1}> = prod_{j >= 1} cos alpha_j; the beta and
        gamma gradients are 0."""
        one = HardwareEfficientAnsatz(n, 1, entangler="cnot")
        alpha = torch.linspace(-1.3, 1.4, n, dtype=torch.float64)
        p1 = torch.zeros(1, n, 3, dtype=torch.float64)
        p1[0, :, 0] = alpha
        p1 = p1.float().to(dev).requires_grad_(True)
        v1 = one.magnetization(p1)
        v1.backward()
        g1 = p1.grad[0].double().cpu()
        a = alpha.float().double().requires_grad_(True)
        z = torch.cat([torch.cumprod(torch.cos(a), 0)[:n - 1],
                       torch.prod(torch.cos(a[1:]))[None]]).sum()
        z.backward()
        val_err = abs(v1.item() - z.item())
        a_err = (g1[:, 0] - a.grad).abs().max().item()
        bg = g1[:, 1:].abs().max().item()
        log(f"[cnot29] {n}q x 1L cnot closed form: value err {val_err:.3e} (tol "
            f"{CLOSED_TOL * n:.1e}), alpha gradient err {a_err:.3e} (tol "
            f"{CNOT_CLOSED_TOL:.0e}), |beta, gamma gradient| max {bg:.3e} (tol "
            f"{ZERO_GRAD_TOL:.0e})")
        require(val_err <= CLOSED_TOL * n and a_err <= CNOT_CLOSED_TOL
                and bg <= ZERO_GRAD_TOL,
                f"the {n}-qubit 1-layer CNOT closed form failed")
        torch.cuda.empty_cache()

    cnot_closed_form(N29)
    cnot_closed_form(N30)
    two = HardwareEfficientAnsatz(N30, 2, entangler="cnot")
    p2 = torch.zeros(2, N30, 3, device=dev, requires_grad=True)
    v2 = two.magnetization(p2)
    v2.backward()
    g2_max = p2.grad.abs().max().item()
    log(f"[cnot29] {N30}q x 2L cnot params = 0: magnetization {v2.item()!r} "
        f"(want {N30}, tol {CLOSED_TOL * N30:.1e}: the CNOT's f32 Schmidt terms); "
        f"|grad| max {g2_max:.3e} (tol {CLOSED_TOL:.0e})")
    require(abs(v2.item() - N30) <= CLOSED_TOL * N30 and g2_max <= CLOSED_TOL,
            "the 30q CNOT params = 0 known answer failed")
    del two, p2, v2
    torch.cuda.empty_cache()
    kernels_vs_plain(N_QUBITS, "cnot29", "cnot")
    kernels_vs_plain(N29, "cnot29", "cnot")

    # 8. result lines ---------------------------------------------------------
    # each kernel's row at the 29-qubit path's shape of its most launched
    # variant; launches from the 29q x 100L cz value_and_grad (and its
    # forward), and for the CNOT ring's kernels from the 29q x 20L cnot
    # value_and_grad (and its forward)
    sources = {
        "dual_apply": ("dqc_tpu_torch/csrc/dual_apply.cu",
                       "dqc_tpu/ops/pallas/dual_apply.py:232", "29q_diag_first"),
        "high_apply": ("dqc_tpu_torch/csrc/high_apply.cu",
                       "dqc_tpu/ops/pallas/high_apply.py:76", "29q_X128_plain"),
        "gram": ("dqc_tpu_torch/csrc/gram.cu",
                 "dqc_tpu/ops/pallas/gram.py:58,97,134", "29q_lane"),
        "block_backward_dual": ("dqc_tpu_torch/csrc/block_backward_dual.cu",
                                "dqc_tpu/ops/pallas/block_backward.py:437",
                                "29q_g0_first_diag_first"),
        "block_backward_high": ("dqc_tpu_torch/csrc/block_backward_high.cu",
                                "dqc_tpu/ops/pallas/block_backward.py:906",
                                "29q_X128_plain"),
        "merged_fact_apply": ("dqc_tpu_torch/csrc/merged_fact_apply.cu",
                              "dqc_tpu/ops/pallas/high_apply.py:190", "Xt2"),
        "block_backward_merged_fact": (
            "dqc_tpu_torch/csrc/block_backward_merged_fact.cu",
            "dqc_tpu/ops/pallas/block_backward.py:670", "Xt2"),
        "diag_sweep": ("dqc_tpu_torch/csrc/diag.cu",
                       "dqc_tpu/ops/pallas/diag.py:75", "29q"),
        "diag_backward": ("dqc_tpu_torch/csrc/diag.cu",
                          "dqc_tpu/ops/pallas/diag.py:154", "29q"),
        "dual_multi_apply": ("dqc_tpu_torch/csrc/dual_multi_apply.cu",
                             "dqc_tpu/ops/pallas/dual_apply.py:165",
                             "29q_T2_cnot"),
        "high_multi_apply": ("dqc_tpu_torch/csrc/high_multi_apply.cu",
                             "dqc_tpu/ops/pallas/high_apply.py:273",
                             "29q_T2_cnot"),
        "block_backward_sublane": ("dqc_tpu_torch/csrc/block_backward_sublane.cu",
                                   "dqc_tpu/ops/pallas/block_backward.py:184",
                                   "29q"),
    }
    cnot_kernels = ("dual_multi_apply", "high_multi_apply", "block_backward_sublane")
    out = []
    for name, (src, replaces, variant) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["variant"] == variant)
        main_vg, main_fwd = ((countsc, fwdc) if name in cnot_kernels
                             else (counts29, fwd29))
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": main_vg[name],
                    "launches_forward": main_fwd[name],
                    "launches_cnot29": countsc[name],
                    "launches_28q": counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"], "variant": variant,
                    "shape": rep["shape"],
                    "dense_bound_ms": rep.get("dense_bound_ms")})
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
