#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dqc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment: torch, the card, its power limit, nvcc, triton;
2. build: every CUDA kernel of the port from dqc_tpu_torch/csrc (nvcc);
3. kernel checks at the 28-qubit shapes of the main path: each kernel
   against its plain PyTorch version on the same inputs, with its time,
   the plain version's and, where one PyTorch call computes the same
   function, that call's (library_ms);
4. the slice: HardwareEfficientAnsatz(28, 100, entangler="cz").densities
   through the kernels, with the launch counters set to 0 just before and
   read just after; the params = 0 known answer (magnetization 28); a
   28-qubit x 20-layer run held against the plain-version path on the card;
   a timed step and its peak memory;
5. a JSON line of the kernels, the card's nvidia-smi name and power limit,
   and as the last line {"ok": true, "device": {...}}.

It exits non-zero without a result when torch.cuda.is_available() is false
or the dqc_tpu_torch package is not beside it. The run takes about a minute
on an H100 plus the kernels' build.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_QUBITS = 28
LAYERS = 100
CHECK_LAYERS = 20
SEED = 1234

# Published H100 SXM peaks (dense): FP32 on the CUDA cores and HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

DUAL_TOL = 1e-4     # abs, unit-variance amplitudes through unitary operators
HIGH_TOL = 1e-4
GRAM_TOL = 2e-6     # abs on Gram entries of a unit-norm state
SLICE_TOL = 5e-5    # abs on density entries, kernel path vs plain path
ZERO_TOL = 1e-5     # params = 0: magnetization vs 28


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
    from dqc_tpu_torch.ops.kernels.dual_apply import dual_apply, dual_apply_plain
    from dqc_tpu_torch.ops.kernels.gram import gram, gram_plain
    from dqc_tpu_torch.ops.kernels.high_apply import high_apply, high_apply_plain

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
              flops, bytes_moved, library=None, normalize=False):
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
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del xr, xi, work_r, work_i
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

    # 4. the slice: 28 qubits x 100 layers, cz ring ---------------------------
    model = HardwareEfficientAnsatz(N_QUBITS, LAYERS, entangler="cz")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dens = model.densities(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[slice] {N_QUBITS}q x {LAYERS}L forward through the kernels: "
        f"{first_s:.3f} s (first call); launches {json.dumps(counts)}")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the main path")
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

    # 5. result lines ---------------------------------------------------------
    sources = {
        "dual_apply": ("dqc_tpu_torch/csrc/dual_apply.cu",
                       "dqc_tpu/ops/pallas/dual_apply.py:232", "plain"),
        "high_apply": ("dqc_tpu_torch/csrc/high_apply.cu",
                       "dqc_tpu/ops/pallas/high_apply.py:76", "X128_plain"),
        "gram": ("dqc_tpu_torch/csrc/gram.cu",
                 "dqc_tpu/ops/pallas/gram.py:58,97,134", "lane"),
    }
    out = []
    for name, (src, replaces, variant) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["variant"] == variant)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"], "variant": variant,
                    "shape": rep["shape"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
