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
8. VQE-Ising and QAOA MaxCut: the kernel checks of their modes in phase 3
   (block_backward_dual with the Q reductions of a variable run, both run
   orders; the seed modes of dual_multi_apply and high_multi_apply, with
   an accumulator and fresh; the high apply's seed on the X = 8 span
   views) on the operators the port stages for an edge density's seed;
   then the forward and the value_and_grad of VQEIsing(26, 26) (the
   reference's headline workload, uncut), VQEIsing(29, 26) and
   QAOAMaxCut(29, random_graph(29, 14, 0), 6), each with the counters set
   to 0 just before and read just after and held, per kernel and per
   counted mode, to the launches of the port's own dispatch for the same
   model run on the meta device (program_launches), with warm step times
   and peak memory; the VQE closed
   form at 29q and 30q x 1L, QAOA at params = 0, and 29q VQE (4L) and
   QAOA (2L) gradients through the kernels against the plain-version path;
9. AutoGradCircuit.build(), the reference-compatible API: the kernel checks
   of its kernels in phase 3 (block_backward_lane at 28q and 29q,
   block_backward_high with the Q reductions of a run on the 28q and 29q
   group-2 and group-3 views in both run orders, diag_backward with Q);
   then [tape29], the reference's gradient gauntlet (every instruction
   kind, mid-circuit densities, non-unitary gates) at 29q x 2 layers
   through autodiff_run, forward and value_and_grad with the counters held
   per kernel and per mode to the port's dispatch of the same tape on the
   meta device (block_backward_lane and block_backward_high[diag_q] at
   least once per differentiated layer), zero gradients for the var gates
   after the last diff density, simple_run's densities (the fused engine)
   against autodiff_run's, and the gradient against the fused engine's
   (fused_tape_forward) and the plain path's; [diagq], a 28q tape with a
   lone variable diagonal run (diag_backward[with_q] once a step), against
   the plain path; [ghz29], GHZ(29)'s densities (I / 2) and fidelity;
   [qft28], QFT|x> against its closed form through build_state_fn;
10. the expanded merged top and scan mode wherever the JAX package runs
   it: the kernel checks of the in-place high apply and of
   block_backward_high on the merged axis (X = 256 at the 29q shape, 512
   at the 30q shape) in phase 3; [hpair29], HardwareEfficientAnsatz(29, 20,
   "cz") under set_hpair_factorized(False) (the merged sweep expanded to
   X = 256 both ways), forward and value_and_grad with the counters held
   to the port's dispatch on the meta device, against the factorized
   route on the same params and the 29q x 1L closed form; [hpair30], the
   CNOT ring at 30q x 2L (its lone 2-bit top-group block at X = 512 both
   ways), by default and with the hpair expanded, at params = 0, and
   against the plain path at 23q x 2L (the same X = 512 kernels: the 30q
   plain path does not fit in the card's memory); [fallback], scan mode off the planes (plain
   torch on the card: VQEIsing(10, 6), HardwareEfficientAnsatz(20, 4, "cz")
   at complex128, HardwareEfficientAnsatz(24, 4) under
   set_plane_engine(False)) against the unrolled models and the plane
   path; [init28], scan_with_epilogue from a random 28q state, 4 cz
   layers, the kernels against the plain path (densities, gate and state
   gradients), counters held to the meta-device dry run;
11. a JSON line of the kernels and of the modes checked (their launches
   counted per mode by the wrappers), the card's nvidia-smi
   name and power limit, and as the last line {"ok": true, "device": {...}}.

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
HPAIR_LAYERS = 20   # [hpair29]: depth cut from 100 for chip time only
CHECK_LAYERS = 20
SEED = 1234
N29 = 29            # the JAX package's bench workload: 29q x 100L value_and_grad
N30 = 30
CNOT_LAYERS = 20    # the CNOT ring at 29q: depth cut from 100 for time
CNOT = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0))
VQE_LAYERS = 26     # VQEIsing(26, 26): the reference's headline workload
QAOA_LAYERS = 6
QAOA_EXTRA_EDGES = 14   # random_graph(29, 14, 0), the example's graph at 29q

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
VQE_VALUE_TOL = 1e-5    # VQE closed form: value within 1e-5 n, each
VQE_GRAD_TOL = 3e-5     # gradient within 3e-5 n (sums of n edge terms)
QAOA_ZERO_TOL = 1e-5    # QAOA at params = 0: cut within 1e-5 |E|, |grad|
FALLBACK_TOL = 1e-5     # densities: scan mode off the planes vs the routes
                        # beside it (plain torch both, f32 or f64)
MODEL_GRAD_TOL = 1e-4   # relative to max(1, |g|) per parameter, kernel path
                        # vs plain path (sums of 2^27-term f32 reductions)


def random_graph(n, extra_edges, seed):
    """The QAOA example's graph (examples/example_qaoa_maxcut.py): a ring
    backbone plus ``extra_edges`` random chords."""
    import numpy as np
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)]
    while len(edges) < n + extra_edges:
        a, b = rng.integers(0, n, 2)
        if a != b and (min(a, b), max(a, b)) not in [tuple(sorted(e)) for e in edges]:
            edges.append((int(min(a, b)), int(max(a, b))))
    return edges


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


def call_modes(name: str, a) -> tuple:
    """The counted modes (ops.kernels' ``mode_launches``) of a call of
    kernel ``name`` with bound arguments ``a``."""
    if name == "block_backward_dual":
        return ("diag_q",) if a.get("diag_q") else ()
    if name == "block_backward_high":
        return (("diag_q",) if a.get("diag_q") else ()) + (
            ("wide",) if a["fr"].shape[1] > 128 else ())
    if name == "high_apply":
        inplace = a.get("acc") is None and a.get("alias", True)
        return ("wide_inplace",) if inplace and a["xr"].shape[1] > 128 else ()
    if name == "diag_backward":
        return ("with_q",) if a.get("with_q") else ()
    if name in ("dual_multi_apply", "high_multi_apply"):
        seed = a.get("conj") or a.get("acc") is not None or not a.get("alias", True)
        return ("seed",) if seed else ()
    return ()


def call_tag(a) -> str:
    """What sets a launch's time apart beside its kernel and plane shape:
    a seed form, a diagonal run and its order, the run's Q outputs."""
    tags = []
    if a.get("conj") or a.get("acc") is not None or not a.get("alias", True):
        tags.append("seed")
    if a.get("diag_tables") is not None:
        first = a.get("diag_first", a.get("diag_first_fwd", True))
        tags.append("diag_first" if first else "diag_after")
    if a.get("diag_q") or a.get("with_q"):
        tags.append("q")
    return "+".join(tags)


def variant_tag(variant: str) -> str:
    """call_tag of the launches a kernel check's variant stands for."""
    tags = [t for t in ("seed", "diag_first", "diag_after") if t in variant]
    if variant.endswith("_q"):
        tags.append("q")
    return "+".join(tags)


def dry_run_launches(run):
    """The launches of ``run(kernels)`` (a forward returning a scalar
    loss) and of its backward, as the port's own dispatch plans them: run
    on the meta device (shapes, no data) through recording plain versions
    of the kernels. Returns (forward counts, forward-and-backward counts,
    forward-and-backward launches), the counts keyed as
    ops.kernels.launch_counts keys them, one (kernel, call_tag, plane shape)
    per launch."""
    import inspect
    from dqc_tpu_torch.ops import kernels as K

    calls = []

    def recording(name, plain):
        sig = inspect.signature(plain)

        def call(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            calls.append((name, call_modes(name, a), call_tag(a),
                          tuple(args[0].shape)))
            return plain(*args, **kw)
        return call

    def counts():
        out = dict.fromkeys(K.launch_counts(), 0)
        for name, modes, _, _ in calls:
            out[name] += 1
            for m in modes:
                out[f"{name}[{m}]"] += 1
        return out

    kernels = K.KernelSet(*(recording(f, p) for f, p in
                            zip(K.KernelSet._fields, K.PLAIN)))
    value = run(kernels)
    fwd = counts()
    value.backward()
    return fwd, counts(), [c[0:1] + c[2:] for c in calls]


def program_launches(build, loss: str):
    """dry_run_launches of one forward and one value_and_grad of the model
    ``build(device)`` makes."""
    import torch

    def run(kernels):
        model = build("meta")
        params = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        return getattr(model, loss)(params, kernels=kernels)
    return dry_run_launches(run)


def our_kernel_names():
    """The names of the port's CUDA kernels (every __global__ function of
    dqc_tpu_torch/csrc), to pick them out of a profiler's events."""
    import re

    names = set()
    for path in sorted(os.listdir(os.path.join(HERE, "dqc_tpu_torch", "csrc"))):
        with open(os.path.join(HERE, "dqc_tpu_torch", "csrc", path)) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                f.read()))
    return names


def profile_device_ms(fn, names):
    """Run ``fn`` once under torch.profiler: (device ms of the port's
    kernels by name, device ms of every kernel), or None when the profiler
    saw no device time (then the split is not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours, total = Counter(), 0.0
    for ev in prof.key_averages():
        # the kernels' own events (a CPU op's entry repeats its kernels' time)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        total += us / 1e3
        name = next((k for k in sorted(names, key=len, reverse=True)
                     if k in ev.key), None)
        if name is not None:
            ours[name] += us / 1e3
    return (ours, total) if total > 0 else None


def gauntlet_tape(circuit, n: int, layers: int):
    """The reference's gradient gauntlet (tests/test_autodiff.py): every
    instruction kind — var / const x 1q / 2q x unitary / non-unitary /
    diagonal — with diff densities at each layer's start, non-diff ones
    after it and at the end."""
    c = circuit
    for _ in range(layers):
        for i in range(n):
            c.get_q1_dens_op_with_grad(i)
        for i in range(0, n - 1, 2):
            c.get_q2_dens_op_with_grad(i + 1, i)
        for i in range(n):
            c.add_q1_var_gate(i)
        for i in range(0, n - 1, 2):
            c.add_q2_var_gate(i + 1, i)
        for i in range(0, n - 1, 2):
            c.add_q2_var_gate_diag(i + 1, i)
        for i in range(n):
            c.add_q1_const_gate(i)
        for i in range(1, n - 1, 2):
            c.add_q2_const_gate(i + 1, i)
        for i in range(1, n - 1, 2):
            c.add_q2_const_gate_diag(i + 1, i)
        for i in range(n):
            c.add_q1_var_gate_nonu(i)
        for i in range(0, n - 1, 2):
            c.add_q2_var_gate_nonu(i + 1, i)
        for i in range(n):
            c.add_q1_const_gate_nonu(i)
        for i in range(1, n - 1, 2):
            c.add_q2_const_gate_nonu(i + 1, i)
        for i in range(n):
            c.get_q1_dens_op(i)
    for i in range(n):
        c.get_q1_dens_op(i)
    return c


def tape_gates(rng, tape, var: bool):
    """Gate values for one queue of a tape, in consumption order, as
    tests/test_autodiff.py's gauntlet_gates makes them: random unitaries
    (QR of a complex normal matrix), random unit-modulus diagonals, and
    non-unitary gates as unitaries perturbed by 0.01 times a complex normal
    matrix (a well-conditioned inverse). complex64 numpy."""
    import numpy as np

    out = []
    for inst in tape.gates(var=var):
        d = 1 << inst.k
        if inst.kind.name == "DIAG":
            out.append(np.exp(1j * rng.uniform(0, 2 * np.pi, d)).astype(np.complex64))
            continue
        q, _ = np.linalg.qr(rng.standard_normal((d, d))
                            + 1j * rng.standard_normal((d, d)))
        if not inst.unitary:
            q = q + 0.01 * (rng.standard_normal((d, d))
                            + 1j * rng.standard_normal((d, d)))
        out.append(q.astype(np.complex64).reshape(-1))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from dqc_tpu_torch import HardwareEfficientAnsatz
    from dqc_tpu_torch.models.qaoa import QAOAMaxCut
    from dqc_tpu_torch.models.vqe_ising import VQEIsing
    from dqc_tpu_torch.ops import groups as gr
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
    from dqc_tpu_torch.ops.kernels.dual_apply import (
        diag_run, dual_apply, dual_apply_plain)
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
                   intact=0, dense_flops=None, rel_each=False, reuse=False):
        """A kernel of ``n_in`` input planes whose outputs are
        ``n_planes_out`` planes (held to ``tol`` abs) and then pair grams
        (held to GRAM_T0_TOL times their largest entry; with ``rel_each``
        each output to GRAM_T0_TOL times its own largest entry, for outputs
        of unlike scale: pair grams and Q reductions). ``intact``: how many
        leading inputs the kernel must leave as they were. ``reuse``: the
        kernel runs on the inputs themselves, not on copies (30q planes, so
        that the plain version fits beside them; the times then run on the
        kernel's outputs, of the same shapes and scale)."""
        ins = [randn(*shape) for _ in range(n_in)]
        want = fn_plain(*ins)
        work = ins if reuse else [t.clone() for t in ins]
        got = fn_kernel(*work)
        torch.cuda.synchronize()
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        plane_err = max(errs[:n_planes_out])
        gram_err = max(errs[n_planes_out:], default=0.0)
        gram_max = max((w.abs().max().item() for w in want[n_planes_out:]),
                       default=1.0)
        if rel_each and len(want) > n_planes_out:
            gram_err = max(e / max(w.abs().max().item(), 1e-30)
                           for e, w in zip(errs[n_planes_out:], want[n_planes_out:]))
            gram_max = 1.0
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

    def dual_bwd_library(diag_inv_tables=None, diag_tables=None,
                         diag_first_fwd=True, diag_q=False, **_):
        """The pair's yardstick: six cuBLAS-backed complex calls (g0_first
        order); with a run, its multiply where the run is met, and with
        ``diag_q`` the product Q = B F there and its three sums."""
        def make(fr, fi, br, bi):
            F0, B0 = torch.complex(fr, fi), torch.complex(br, bi)
            L0i, L0, S1i, S1 = (torch.complex(*o) for o in (e0inv, e0, e1inv, e1))

            def roll_back_run(F, B):
                Q = B * F if diag_q else None
                sums = () if Q is None else (Q.sum(0), Q.sum(2), Q.sum(1))
                return F * diag_run(diag_inv_tables), B * diag_run(diag_tables), sums

            def run():
                F, B, sums = F0, B0, ()
                if diag_tables is not None and not diag_first_fwd:
                    F, B, sums = roll_back_run(F, B)
                F1 = torch.matmul(S1i, F)
                Ts = torch.einsum("axc,ayc->xy", B, F1)
                B1 = torch.matmul(S1.T, B)
                F = torch.matmul(F1, L0i.T)
                Tl = torch.einsum("arx,ary->xy", B1, F)
                B = torch.matmul(B1, L0)
                if diag_tables is not None and diag_first_fwd:
                    F, B, sums = roll_back_run(F, B)
                return F, B, Tl, Ts, *sums
            return run
        return make

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
                   library=dual_bwd_library(**kw))

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
               library=dual_bwd_library())

    # 3d. the VQE / QAOA kernel modes -----------------------------------------
    # block_backward_dual with the Q reductions of a random run (both run
    # orders): 768 complex MACs per amplitude, plus the product Q = B F and
    # its three sums (12 real flops); outputs 2 x (128 x 128 + 2 A x 128)
    # floats more. The seed modes on the operands the port stages for an
    # edge density's seed conj(M), M a random Hermitian 4 x 4: the (6, 7)
    # edge's four Schmidt terms for dual_multi_apply, the closing (0, n - 1)
    # edge's four lane slices on the X = 8 span view for high_multi_apply,
    # the high-boundary edges' X = 8 span operators for the high apply.
    def hermitian4():
        z = torch.complex(randn(4, 4), randn(4, 4))
        return 0.25 * (z + z.conj().T)

    def seed_multi(apply, ops, acc):
        if acc:
            return lambda xr, xi, ar, ai: apply(xr, xi, *ops, conj=True,
                                                acc=(ar, ai), alias=False)
        return lambda xr, xi: apply(xr, xi, *ops, conj=True, alias=False)

    def multi_seed_library(spec, f1, f2, acc):
        """The seed's yardstick: one einsum, its conjugate and the add."""
        def make(xr, xi, *a):
            x = torch.complex(xr, xi)
            c1, c2 = torch.complex(*f1), torch.complex(*f2)
            if acc:
                y0 = torch.complex(*a)
                return lambda: y0 + torch.einsum(spec, c1, x, c2).conj()
            return lambda: torch.einsum(spec, c1, x, c2).conj()
        return make

    for nq in (N_QUBITS, N29):
        a_n, amps_n = 1 << (nq - 14), float(1 << nq)
        st = 2 * amps_n * 4
        q_bytes = 2 * 4 * (128 * 128 + 2 * a_n * 128)
        for order in ("first", "after"):
            kw = dict(g0_first=True, diag_first_fwd=order == "first",
                      diag_inv_tables=tables(a_n), diag_tables=tables(a_n),
                      diag_q=True)
            check_many("block_backward_dual", f"{nq}q_g0_first_diag_{order}_q",
                       (a_n, 128, 128), 4, 4, dual_bwd(block_backward_dual, **kw),
                       dual_bwd(block_backward_dual_plain, **kw), DUAL_TOL,
                       flops=amps_n * (768 * 8 + 12),
                       bytes_moved=4 * st + 2 * table_bytes(a_n) + q_bytes,
                       library=dual_bwd_library(**kw), rel_each=True)
        M = hermitian4()
        kind, *ops = pl.cross_terms_operands(
            ps._dense_cross_expanded_terms(M.conj(), (6, 7), nq), nq, dev)
        require(kind == "dual" and ops[0].shape[0] == 4,
                f"(6, 7) seed terms {kind} {ops[0].shape}")
        for acc in (True, False):
            check_many("dual_multi_apply", f"{nq}q_seed_T4_{'acc' if acc else 'fresh'}",
                       (a_n, 128, 128), 4 if acc else 2, 2,
                       seed_multi(dual_multi_apply, ops, acc),
                       seed_multi(dual_multi_apply_plain, ops, acc), DUAL_TOL,
                       flops=amps_n * (macs(*ops[:2]) + macs(*ops[2:])) * 8,
                       bytes_moved=(3 if acc else 2) * st, intact=2,
                       library=multi_seed_library("tsk,akm,tlm->asl", ops[2:],
                                                  ops[:2], acc),
                       dense_flops=amps_n * 2 * 128 * 4 * 8)
        kind, vshape, *ops = pl.cross_span_operands(M.conj(), (0, nq - 1), nq, dev)
        require(kind == "multi" and vshape == (1, 8, 1 << (nq - 10), 128)
                and ops[0].shape[0] == 4, f"closing seed span view {kind} {vshape}")
        for acc in (True, False):
            check_many("high_multi_apply", f"{nq}q_seed_T4_{'acc' if acc else 'fresh'}",
                       vshape, 4 if acc else 2, 2,
                       seed_multi(high_multi_apply, ops, acc),
                       seed_multi(high_multi_apply_plain, ops, acc), HIGH_TOL,
                       flops=amps_n * (macs(*ops[:2]) + macs(*ops[2:])) * 8,
                       bytes_moved=(3 if acc else 2) * st, intact=2,
                       library=multi_seed_library("txy,iymk,tlk->ixml", ops[:2],
                                                  ops[2:], acc),
                       dense_flops=amps_n * (128 + 8) * 4 * 8)
    M = hermitian4()
    for pos in ((13, 14), (20, 21), (27, 28)):
        kind, vshape, er, ei = pl.cross_span_operands(M.conj(), pos, N29, dev)
        require(kind == "high" and vshape[1] == 8, f"seed span view {kind} {vshape}")
        check_many("high_apply", f"29q_X8_span{pos[0]}_seed", vshape, 4, 2,
                   seed(high_apply, er, ei), seed(high_apply_plain, er, ei),
                   HIGH_TOL, flops=amps29 * macs(er, ei) * 8,
                   bytes_moved=3 * state29, intact=2,
                   library=seed_library((er, ei)), dense_flops=amps29 * 8 * 8)

    # 3e. the kernels of AutoGradCircuit.build() on the plane tape -----------
    # block_backward_lane, the unpaired lane block's adjoint (384 complex MACs
    # per amplitude); block_backward_high with the Q reductions of a run
    # folded into a high sweep, both run orders, on the 29q path's group-2
    # and group-3 views; diag_backward with the Q reductions of a lone run.
    # Q adds the product Q = B F and its three sums (12 real flops per
    # amplitude) and 2 x (128 x 128 + 2 A x 128) floats of outputs.
    from dqc_tpu_torch.ops.kernels.block_backward_lane import (
        block_backward_lane, block_backward_lane_plain)
    from dqc_tpu_torch.ops.kernels.high_apply import view_diag_run

    def lane_library(E, Einv):
        def make(fr, fi, br, bi):
            F, B = torch.complex(fr, fi), torch.complex(br, bi)
            Ec, Eic = torch.complex(*E), torch.complex(*Einv)

            def run():  # three cuBLAS-backed complex calls and the gram product
                F1 = torch.matmul(F, Eic.T)
                return F1, torch.einsum("asx,asy->xy", B, F1), torch.matmul(B, Ec)
            return run
        return make

    def q_sums(Q):
        Q = Q.reshape(-1, 128, 128)
        return Q.sum(0), Q.sum(2), Q.sum(1)

    def high_q_library(E, Einv, ti, tf, first):
        """Row 11's three calls, the run's multiplies where it is met, the
        product Q = B F there and its three sums."""
        def make(fr, fi, br, bi):
            A1, X, M, _ = fr.shape
            v = (A1, X, M * 128)
            F0, B0 = torch.complex(fr, fi).view(v), torch.complex(br, bi).view(v)
            Ec, Eic = torch.complex(*E), torch.complex(*Einv)

            def roll(F, B):
                Dinv = view_diag_run(ti, fr.shape).view(v)
                D = view_diag_run(tf, fr.shape).view(v)
                return F * Dinv, B * D, q_sums(B * F)

            def run():
                F, B, sums = F0, B0, ()
                if not first:
                    F, B, sums = roll(F, B)
                F = torch.matmul(Eic, F)
                T0 = torch.einsum("axq,ayq->xy", B, F)
                B = torch.matmul(Ec.T, B)
                if first:
                    F, B, sums = roll(F, B)
                return F, B, T0, *sums
            return run
        return make

    def diag_q_library(ti, tf):
        def make(fr, fi, br, bi):
            rows13 = diag_library(ti, tf)(fr, fi, br, bi)
            F, B = torch.complex(fr, fi), torch.complex(br, bi)
            # row 13's multiplies, Q = B F and its three sums
            return lambda: (*rows13(), *q_sums(B * F))
        return make

    for nq in (N_QUBITS, N29):
        a_n, amps_n = 1 << (nq - 14), float(1 << nq)
        st = 2 * amps_n * 4
        q_bytes = 2 * 4 * (128 * 128 + 2 * a_n * 128)
        E, Einv = unitary(128), unitary(128)
        check_many("block_backward_lane", f"{nq}q", (a_n, 128, 128), 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_lane(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_lane_plain(
                       *p, *Einv, *E), DUAL_TOL,
                   flops=amps_n * 384 * 8, bytes_moved=4 * st,
                   library=lane_library(E, Einv))
        for j in (2, 3):
            pre, X, M = pl._high_view(nq, j)
            E, Einv = unitary(X), unitary(X)
            for order in ("first", "after"):
                ti, tf = tables(a_n), tables(a_n)
                kw = dict(diag_inv_tables=ti, diag_tables=tf,
                          diag_first_fwd=order == "first", diag_q=True)
                check_many("block_backward_high", f"{nq}q_X{X}_g{j}_diag_{order}_q",
                           (pre, X, M, 128), 4, 4,
                           lambda *p, kw=kw, E=E, Einv=Einv: block_backward_high(
                               *p, *Einv, *E, **kw),
                           lambda *p, kw=kw, E=E, Einv=Einv: block_backward_high_plain(
                               *p, *Einv, *E, **kw), HIGH_TOL,
                           flops=amps_n * (3 * X * 8 + 12),
                           bytes_moved=4 * st + 2 * table_bytes(a_n) + q_bytes,
                           library=high_q_library(E, Einv, ti, tf, order == "first"),
                           rel_each=True)
        ti, tf = tables(a_n), tables(a_n)
        check_many("diag_backward", f"{nq}q_q", (a_n, 128, 128), 4, 4,
                   lambda *p, ti=ti, tf=tf: diag_backward(*p, *ti, *tf, with_q=True),
                   lambda *p, ti=ti, tf=tf: diag_backward_plain(*p, *ti, *tf,
                                                                with_q=True),
                   DIAG_TOL, flops=amps_n * (36 + 12),
                   bytes_moved=4 * st + 2 * table_bytes(a_n) + q_bytes,
                   library=diag_q_library(ti, tf), rel_each=True)
        del ti, tf

    # 3f. the expanded merged top ----------------------------------------------
    # the in-place high apply (X complex MACs per amplitude) and
    # block_backward_high (3 X) on the merged axis of a tiny top group:
    # X = 256 at the 29q shape (1, 256, 16384, 128), X = 512 at the 30q shape
    # (1, 512, 16384, 128); the yardsticks row 2's matmul and row 11's three
    # calls
    for nq, X in ((N29, 256), (N30, 512)):
        amps_n = float(1 << nq)
        st = 2 * amps_n * 4
        shape = (1, X, (1 << nq) // (X * 128), 128)
        E = unitary(X)
        check("high_apply", f"{nq}q_X{X}_inplace", shape, high_apply,
              high_apply_plain, (*E, None, True), HIGH_TOL, flops=amps_n * X * 8,
              bytes_moved=2 * st, library=high_library(E))
        E, Einv = unitary(X), unitary(X)
        check_many("block_backward_high", f"{nq}q_X{X}_wide", shape, 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_high(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_high_plain(
                       *p, *Einv, *E), HIGH_TOL, flops=amps_n * 3 * X * 8,
                   bytes_moved=4 * st, library=high_bwd_library(E, Einv),
                   reuse=nq == N30)
        del E, Einv
        torch.cuda.empty_cache()

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
    per_bound = {(r["kernel"], r["variant"]): r["bound_ms"] for r in rows}
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

    def kernels_vs_plain(n: int, tag: str, entangler: str = "cz",
                         layers: int = GRAD_LAYERS) -> float:
        """n x ``layers`` gradients through the kernels and through the
        plain versions, on the card."""
        four = HardwareEfficientAnsatz(n, layers, entangler=entangler)
        p4 = (7.0 * four.init_params(torch.Generator().manual_seed(SEED + 2))
              ).requires_grad_(True)
        four.magnetization(p4).backward()
        g_k = p4.grad.clone()
        p4.grad = None
        four.magnetization(p4, kernels=K.PLAIN).backward()
        grad_err = (g_k - p4.grad).abs().max().item()
        log(f"[{tag}] {n}q x {layers}L {entangler} gradient, kernels vs plain "
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

    # 8. VQE-Ising and QAOA MaxCut ---------------------------------------------
    # the kernel phase's per-launch times by what sets a launch's time apart
    per_call = {}
    for r in rows:
        per_call.setdefault((r["kernel"], variant_tag(r["variant"]), tuple(r["shape"])),
                            (r["ms"], r["bound_ms"]))

    def model_phase(tag: str, build, dens_of, loss: str, L: int):
        """The forward and the value_and_grad of a VQE / QAOA model through
        the kernels, the counters set to 0 just before each and read just
        after and held to the launches of the port's dispatch for the same
        model (program_launches); warm step times, peak memory and the
        kernel time per step where the kernel phase timed every launch."""
        want_fwd, want_vg, vg_calls = program_launches(build, loss)
        model = build(dev)
        loss_fn = getattr(model, loss)
        log(f"[{tag}] program: forward {json.dumps(want_fwd)}; value_and_grad "
            f"{json.dumps(want_vg)}")
        params = model.init_params(torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        dens = dens_of(model, params)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got_fwd = K.launch_counts()
        log(f"[{tag}] forward through the kernels: {first_s:.3f} s (first call); "
            f"launches {json.dumps(got_fwd)}")
        require(got_fwd == want_fwd, f"{tag} forward launch counts {got_fwd}, "
                                     f"want {want_fwd}")
        D = torch.stack(dens)
        require(D.dim() == 3 and D.shape[1] == D.shape[2] in (2, 4),
                f"densities {tuple(D.shape)}")
        require(bool(torch.isfinite(torch.view_as_real(D)).all()), "non-finite densities")
        herm = (D - D.conj().transpose(1, 2)).abs().max().item()
        trace = (torch.diagonal(D, dim1=1, dim2=2).sum(-1) - 1).abs().max().item()
        require(herm <= 1e-6 and trace <= 1e-4,
                f"{tag} densities are not unit-trace Hermitian matrices")
        del dens
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = loss_fn(params).item()
        fwd_s = time.perf_counter() - t0
        fwd_peak = torch.cuda.max_memory_allocated()
        params.requires_grad_(True)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        loss.backward()
        torch.cuda.synchronize()
        vg_first_s = time.perf_counter() - t0
        got_vg = K.launch_counts()
        log(f"[{tag}] value_and_grad through the kernels: {vg_first_s:.3f} s "
            f"(first call); launches {json.dumps(got_vg)}")
        require(got_vg == want_vg, f"{tag} launch counts {got_vg}, want {want_vg}")
        grad = params.grad.detach().clone()
        require(bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0,
                f"{tag} gradient is not finite and nonzero")
        params.grad = None
        del loss
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        loss.backward()
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t0
        vg_peak = torch.cuda.max_memory_allocated()
        drift = (params.grad - grad).abs().max().item()
        log(f"[{tag}] value {value:.6f}; |grad| max {grad.abs().max().item():.4e}; "
            f"forward step (warm) {fwd_s:.4f} s, peak {fwd_peak / 2**30:.3f} GiB; "
            f"value_and_grad step (warm) {vg_s:.4f} s = {vg_s / L * 1e3:.2f} ms/layer, "
            f"peak {vg_peak / 2**30:.3f} GiB; grad vs first call max abs {drift:.3e}")
        require(drift <= GRAD_TOL * max(1.0, grad.abs().max().item()),
                f"two {tag} value_and_grad steps disagree")
        out = dict(fwd_s=fwd_s, vg_s=vg_s, fwd_peak=fwd_peak, vg_peak=vg_peak,
                   counts=got_vg, counts_fwd=got_fwd, dens=D, grad=grad)
        n_fwd = sum(want_fwd[k] for k in K.KernelSet._fields)
        timed = [per_call.get(c) for c in vg_calls]
        missing = Counter(c for c, t in zip(vg_calls, timed) if t is None)
        if missing:
            log(f"[{tag}] kernel time per step not estimated: no kernel check "
                f"at {len(missing)} launch kinds, e.g. {next(iter(missing))}")
        else:
            by_kernel = Counter()
            for c, (ms, _) in zip(vg_calls, timed):
                by_kernel[c[0]] += ms
            fwd_ms = sum(ms for ms, _ in timed[:n_fwd])
            vg_ms = sum(by_kernel.values())
            floor_fwd = sum(b for _, b in timed[:n_fwd])
            floor_vg = sum(b for _, b in timed)
            log(f"[{tag}] kernel time per step (launches x per-launch ms above): "
                f"forward {fwd_ms:.1f} ms = {100 * fwd_ms / (fwd_s * 1e3):.1f}% of its "
                f"step; value_and_grad {vg_ms:.1f} ms = "
                f"{100 * vg_ms / (vg_s * 1e3):.1f}% of its step; floors (launches x "
                f"bound_ms) forward {floor_fwd:.1f} ms, value_and_grad "
                f"{floor_vg:.1f} ms; by kernel "
                f"{json.dumps({k: round(t, 2) for k, t in by_kernel.most_common()})}")
            out.update(fwd_kernel_ms=fwd_ms, vg_kernel_ms=vg_ms)
        del params, grad, loss
        torch.cuda.empty_cache()
        return out

    model_phase("vqe26", lambda d: VQEIsing(26, VQE_LAYERS, device=d),
                lambda m, p: m.densities(p), "energy", VQE_LAYERS)
    vqe29 = model_phase("vqe29", lambda d: VQEIsing(N29, VQE_LAYERS, device=d),
                        lambda m, p: m.densities(p), "energy", VQE_LAYERS)
    graph = random_graph(N29, QAOA_EXTRA_EDGES, 0)
    qaoa29 = model_phase(
        "qaoa29", lambda d: QAOAMaxCut(N29, graph, layers_number=QAOA_LAYERS, device=d),
        lambda m, p: m._densities(p, K.KERNELS), "loss", QAOA_LAYERS)

    def vqe_closed_form(n: int) -> None:
        """VQEIsing(n, 1) at params (gamma, 0) from |+>^n: E = -n cos^2(2
        gamma), dE/dgamma = 2 n sin(4 gamma) = -dE/dbeta."""
        gamma = float(np.float32(0.37))  # the f32 angle, exactly
        one = VQEIsing(n, 1, scan=True)
        p1 = torch.tensor([gamma, 0.0], device=dev, requires_grad=True)
        v1 = one.energy(p1)
        v1.backward()
        s4 = 2 * n * np.sin(4 * gamma)
        val_err = abs(v1.item() + n * np.cos(2 * gamma) ** 2)
        g = p1.grad.double().cpu()
        g_err = max(abs(g[0].item() - s4), abs(g[1].item() + s4))
        log(f"[vqe29] {n}q x 1L closed form: value err {val_err:.3e} (tol "
            f"{VQE_VALUE_TOL * n:.1e}), gradient err {g_err:.3e} (tol "
            f"{VQE_GRAD_TOL * n:.1e}) vs 2 n sin(4 gamma) = {s4:.4f}")
        require(val_err <= VQE_VALUE_TOL * n and g_err <= VQE_GRAD_TOL * n,
                f"the {n}-qubit VQE closed form failed")
        torch.cuda.empty_cache()

    vqe_closed_form(N29)
    vqe_closed_form(N30)
    zero = QAOAMaxCut(N29, graph, layers_number=2, scan=True)
    pz = torch.zeros(4, device=dev, requires_grad=True)
    cut = zero.expected_cut(pz)
    cut.backward()
    cut_err = abs(cut.item() - len(graph) / 2)
    gz = pz.grad.abs().max().item()
    log(f"[qaoa29] {N29}q x 2L params = 0: cut {cut.item()!r} (want {len(graph) / 2}, "
        f"tol {QAOA_ZERO_TOL * len(graph):.1e}); |grad| max {gz:.3e} (tol "
        f"{QAOA_ZERO_TOL:.0e})")
    require(cut_err <= QAOA_ZERO_TOL * len(graph) and gz <= QAOA_ZERO_TOL,
            "the QAOA params = 0 known answer failed")
    del zero, pz, cut
    torch.cuda.empty_cache()

    def model_vs_plain(tag: str, model, loss_fn) -> float:
        p = (model.init_params(torch.Generator().manual_seed(SEED + 3))
             / (0.1 if isinstance(model, QAOAMaxCut) else 1.0)).requires_grad_(True)
        loss_fn(p).backward()
        g_k = p.grad.clone()
        p.grad = None
        loss_fn(p, kernels=K.PLAIN).backward()
        rel = ((g_k - p.grad).abs() / p.grad.abs().clamp(min=1.0)).max().item()
        log(f"[{tag}] {model.n}q x {model.layers}L gradient, kernels vs plain path: "
            f"max err / max(1, |g|) {rel:.3e} (tol {MODEL_GRAD_TOL:.0e}); |grad| "
            f"max {g_k.abs().max().item():.3e}")
        require(rel <= MODEL_GRAD_TOL,
                f"{tag} kernel-path gradient disagrees with the plain path")
        torch.cuda.empty_cache()
        return rel

    four = VQEIsing(N29, GRAD_LAYERS, scan=True)
    model_vs_plain("vqe29", four, four.energy)
    del four
    two = QAOAMaxCut(N29, graph, layers_number=2, scan=True)
    model_vs_plain("qaoa29", two, two.loss)
    del two
    torch.cuda.empty_cache()

    # 9. AutoGradCircuit.build() on the plane tape ---------------------------
    # the reference-compatible API a qdc user writes: the circuit's
    # autodiff_run (the plane tape and its kernels on the card), simple_run
    # (the fused engine, plain torch on the card) and build_state_fn
    from dqc_tpu_torch import GHZ, QFT, AutoGradCircuit
    from dqc_tpu_torch.circuit.builder import autodiff_densities
    from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward
    from dqc_tpu_torch.circuit.fusion import fuse_tape

    def tsallis(dens):
        return torch.stack([1 - torch.einsum("ij,ji->", d, d).real
                            for d in dens]).mean()

    kernel_names = our_kernel_names()

    def tape_phase(tag, circuit, rng, layers):
        """One build() step of a tape: forward and value_and_grad through
        autodiff_run, each with the counters set to 0 just before and read
        just after and held to the port's dispatch of the same tape on the
        meta device, warm step times, peak memory and the kernel time per
        step; returns the gates, the gradients and the counts."""
        n, tape = circuit.n, circuit.tape
        ftape = fuse_tape(tape)
        vg_np, cg = tape_gates(rng, tape, True), tape_gates(rng, tape, False)
        items = Counter(it[0] for it in ps.plane_program(ftape))
        log(f"[{tag}] {n}q x {layers}L: {len(vg_np)} var and {len(cg)} const gates, "
            f"{len(tape.densities(diff=True))} diff densities; plan items "
            f"{json.dumps(items)}")

        def dry(kernels):
            tv = [torch.tensor(g).to("meta").requires_grad_(True) for g in vg_np]
            state = torch.zeros(1 << n, dtype=torch.complex64, device="meta")
            return tsallis(ps.plane_tape_forward(ftape, state, tv, cg,
                                                 kernels=kernels))

        want_fwd, want_vg, vg_calls = dry_run_launches(dry)
        _, autodiff_run = circuit.build()
        tv = [torch.tensor(g, device=dev, requires_grad=True) for g in vg_np]
        with torch.no_grad():
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            dens = autodiff_run(tv, cg)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        got_fwd = K.launch_counts()
        log(f"[{tag}] forward (autodiff_run) through the kernels: {first_s:.3f} s "
            f"(first call); launches {json.dumps(got_fwd)}")
        require(got_fwd == want_fwd, f"{tag} forward launch counts {got_fwd}, "
                                     f"want {want_fwd}")
        D = torch.stack([d for d in dens if d.shape == (2, 2)])
        require(bool(torch.isfinite(torch.view_as_real(D)).all()), "non-finite densities")
        # Hermitian; the trace is the squared norm, which the non-unitary
        # gates move away from 1
        herm = (D - D.conj().transpose(1, 2)).abs().max().item()
        require(herm <= 1e-6, f"{tag} densities are not Hermitian ({herm:.2e})")
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            t0 = time.perf_counter()
            value = tsallis(autodiff_run(tv, cg)).item()
            fwd_s = time.perf_counter() - t0
        fwd_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tsallis(autodiff_run(tv, cg)).backward()
        torch.cuda.synchronize()
        vg_first_s = time.perf_counter() - t0
        got_vg = K.launch_counts()
        log(f"[{tag}] value_and_grad through the kernels: {vg_first_s:.3f} s "
            f"(first call); launches {json.dumps(got_vg)}")
        require(got_vg == want_vg, f"{tag} launch counts {got_vg}, want {want_vg}")
        grads = [t.grad.detach().clone() for t in tv]
        for t in tv:
            t.grad = None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tsallis(autodiff_run(tv, cg)).backward()
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t0
        vg_peak = torch.cuda.max_memory_allocated()
        drift = max((t.grad - g).abs().max().item() for t, g in zip(tv, grads))
        gmax = max(g.abs().max().item() for g in grads)
        log(f"[{tag}] value {value:.6f}; |grad| max {gmax:.4e}; forward step (warm) "
            f"{fwd_s:.4f} s, peak {fwd_peak / 2**30:.3f} GiB; value_and_grad step "
            f"(warm) {vg_s:.4f} s, peak {vg_peak / 2**30:.3f} GiB; grad vs first "
            f"call max abs {drift:.3e}")
        require(drift <= GRAD_TOL * max(1.0, gmax), f"two {tag} steps disagree")
        # the device time of one more step, by kernel, from torch.profiler
        # (the tape's launches come at many shapes the kernel phase does not
        # time one by one)
        try:
            prof = profile_device_ms(
                lambda: tsallis(autodiff_run(tv, cg)).backward(), kernel_names)
        except (RuntimeError, OSError) as e:  # the profiler itself, not a check
            prof, why = None, f"the profiler failed: {e}"
        else:
            why = "the profiler saw no device time"
        if prof is None:
            log(f"[{tag}] kernel time per step: not measured ({why})")
        else:
            ours, total = prof
            mine = sum(ours.values())
            log(f"[{tag}] device time of one value_and_grad step (torch.profiler): "
                f"all kernels {total:.1f} ms = {100 * total / (vg_s * 1e3):.1f}% of "
                f"the step; the port's kernels {mine:.1f} ms; by kernel "
                f"{json.dumps({k: round(t, 2) for k, t in ours.most_common()})}")
        return dict(ftape=ftape, vg=vg_np, cg=cg, grads=grads, counts=got_vg,
                    counts_fwd=got_fwd, fwd_s=fwd_s, vg_s=vg_s, tv=tv,
                    simple_autodiff=circuit.build())

    def grad_vs(tag, what, ftape, vg_np, cg, grads, fn):
        """The gradients of the same tsallis loss through ``fn(tv)``
        (another engine or the plain path) against the kernels' ones."""
        tv = [torch.tensor(g, device=dev, requires_grad=True) for g in vg_np]
        tsallis(fn(tv)).backward()
        rel = max(((a - t.grad).abs() / t.grad.abs().clamp(min=1.0)).max().item()
                  for a, t in zip(grads, tv))
        log(f"[{tag}] gradient, kernels vs {what}: max err / max(1, |g|) {rel:.3e} "
            f"(tol {MODEL_GRAD_TOL:.0e})")
        require(rel <= MODEL_GRAD_TOL, f"{tag}: the kernels' gradient disagrees "
                                       f"with {what}")
        del tv
        torch.cuda.empty_cache()

    # [tape29]: the reference's gauntlet tape at 29q x 2 layers. Its second
    # layer's gates follow its last differentiated density: they get a zero
    # gradient and are not run, so one layer is differentiated.
    TAPE_LAYERS = 2
    gcirc = gauntlet_tape(AutoGradCircuit(N29), N29, TAPE_LAYERS)
    t29 = tape_phase("tape29", gcirc, np.random.default_rng(SEED), TAPE_LAYERS)
    c29 = t29["counts"]
    require(c29["block_backward_lane"] >= TAPE_LAYERS - 1
            and c29["block_backward_high[diag_q]"] >= TAPE_LAYERS - 1,
            f"tape29 does not reach block_backward_lane / block_backward_high "
            f"diag_q: {c29}")
    n_trail = 2 * N29 + 3 * len(range(0, N29 - 1, 2))  # layer 2's var gates
    trail = max(g.abs().max().item() for g in t29["grads"][-n_trail:])
    log(f"[tape29] the {n_trail} var gates after the last diff density: |grad| max "
        f"{trail!r} (want 0)")
    require(trail == 0.0, "trailing var gates got a nonzero gradient")
    simple_run, autodiff_run = t29["simple_autodiff"]
    with torch.no_grad():
        all_dens = simple_run(t29["tv"], t29["cg"])
        diff_dens = autodiff_run(t29["tv"], t29["cg"])
    diff_idx = [k for k, inst in enumerate(gcirc.tape.densities()) if inst.diff]
    dens_err = max((all_dens[k] - d).abs().max().item()
                   for k, d in zip(diff_idx, diff_dens))
    log(f"[tape29] simple_run (the fused engine) vs autodiff_run densities: max "
        f"abs {dens_err:.3e} (tol {SLICE_TOL:.0e}) over {len(diff_dens)} densities "
        f"of {len(all_dens)}")
    require(len(all_dens) == len(gcirc.tape.densities()) and dens_err <= SLICE_TOL,
            "simple_run and autodiff_run disagree")
    del all_dens, diff_dens, simple_run, autodiff_run
    t29.pop("simple_autodiff")
    t29.pop("tv")
    torch.cuda.empty_cache()
    init29 = torch.zeros(1 << N29, dtype=torch.complex64, device=dev)
    init29[0] = 1
    ft29 = t29["ftape"]
    grad_vs("tape29", "the fused engine (fused_tape_forward)", ft29, t29["vg"],
            t29["cg"], t29["grads"],
            lambda tv: fused_tape_forward(ft29, init29, tv, t29["cg"]))
    grad_vs("tape29", "the plain path", ft29, t29["vg"], t29["cg"], t29["grads"],
            lambda tv: autodiff_densities(ft29, init29, tv, t29["cg"],
                                          kernels=K.PLAIN))
    del init29
    torch.cuda.empty_cache()

    # [diagq]: a lone variable diagonal run (no dense sweep to fold into), its
    # Q reductions from diag_backward
    N_DQ = N_QUBITS
    dq = AutoGradCircuit(N_DQ)
    for i in range(N_DQ):
        dq.add_q1_const_gate(i)
    for i in range(N_DQ):
        dq.get_q1_dens_op_with_grad(i)
    for i in range(N_DQ - 1):
        dq.add_q2_var_gate_diag(i + 1, i)
    for i in range(N_DQ):
        dq.get_q1_dens_op_with_grad(i)
    for i in range(N_DQ):
        dq.add_q1_var_gate(i)
    for i in range(N_DQ):
        dq.get_q1_dens_op_with_grad(i)
    dq_items = [it for it in ps.plane_program(fuse_tape(dq.tape)) if it[0] != "dens"]
    lone = [it for it in dq_items if it[0] == "diag"
            and ps._run_has_var(it[1], fuse_tape(dq.tape))]
    log(f"[diagq] {N_DQ}q program (densities left out): {[it[0] for it in dq_items]}")
    require(len(lone) == 1, f"[diagq] wants one lone variable diag run: {dq_items}")
    tdq = tape_phase("diagq", dq, np.random.default_rng(SEED + 1), 1)
    require(tdq["counts"]["diag_backward[with_q]"] == 1,
            f"diag_backward[with_q] launches {tdq['counts']}, want 1")
    tdq.pop("simple_autodiff")
    tdq.pop("tv")
    initdq = torch.zeros(1 << N_DQ, dtype=torch.complex64, device=dev)
    initdq[0] = 1
    grad_vs("diagq", "the plain path", tdq["ftape"], tdq["vg"], tdq["cg"],
            tdq["grads"], lambda tv: autodiff_densities(
                tdq["ftape"], initdq, tv, tdq["cg"], kernels=K.PLAIN))
    del initdq
    torch.cuda.empty_cache()

    # [ghz29]: known answers through build() and build_state_fn(): every
    # one-qubit density of the GHZ state is I / 2, and the prepared state is
    # (|0..0> + |1..1>) / sqrt 2
    t0 = time.perf_counter()
    ghz = GHZ(N29)
    gd = torch.stack(ghz.densities())
    g_err = (gd - 0.5 * torch.eye(2, device=dev)).abs().max().item()
    g_fid = ghz.fidelity()
    log(f"[ghz29] {N29} one-qubit densities through autodiff_run: max |rho - I/2| "
        f"{g_err:.3e} (tol 1e-5); fidelity through build_state_fn {g_fid!r} (want "
        f">= 1 - 1e-5); {time.perf_counter() - t0:.2f} s")
    require(g_err <= 1e-5 and g_fid >= 1 - 1e-5, "the GHZ known answer failed")
    del ghz, gd
    torch.cuda.empty_cache()

    # [qft28]: QFT|x> against the closed form exp(2 pi i x y / 2^n) / sqrt 2^n
    N_QFT = N_QUBITS
    t0 = time.perf_counter()
    qft = QFT(N_QFT)
    x_in = 0x5A5A5A5 % (1 << N_QFT)
    psi = qft.apply_to_basis_state(x_in)
    y = torch.arange(1 << N_QFT, device=dev, dtype=torch.int64)
    ph = ((x_in * y) % (1 << N_QFT)).to(torch.float64) * (2 * np.pi / (1 << N_QFT))
    exact = torch.polar(torch.full_like(ph, 2.0 ** (-N_QFT / 2)), ph)
    q_fid = (torch.vdot(exact, psi.to(torch.complex128)).abs() ** 2).item()
    log(f"[qft28] QFT|{x_in}> ({qft.num_gates()} gates) through build_state_fn: "
        f"fidelity to the closed form {q_fid!r} (want >= 1 - 1e-4); "
        f"{time.perf_counter() - t0:.2f} s")
    require(q_fid >= 1 - 1e-4, "the QFT known answer failed")
    del qft, psi, y, ph, exact
    torch.cuda.empty_cache()

    # 10. the expanded merged top, and scan mode off the planes ----------------
    from dqc_tpu_torch import config
    from dqc_tpu_torch.ops.observables import expval_from_density

    def wide_counts(c) -> tuple:
        return c["high_apply[wide_inplace]"], c["block_backward_high[wide]"]

    # [hpair29]: the cz ring with the merged (groups 3, 4) sweep expanded to
    # X = 256 both ways, the counters held to the dry run under the same
    # setting; then the factorized route on the same params
    config.set_hpair_factorized(False)
    try:
        hp29 = model_phase(
            "hpair29", lambda d: HardwareEfficientAnsatz(N29, HPAIR_LAYERS,
                                                         entangler="cz", device=d),
            lambda m, p: m.densities(p), "magnetization", HPAIR_LAYERS)
        closed_form(N29, "hpair29")
    finally:
        config.set_hpair_factorized(True)
    hp_wide = wide_counts(hp29["counts"])
    log(f"[hpair29] the new kernels' launches per value_and_grad step: "
        f"high_apply[wide_inplace] {hp_wide[0]}, block_backward_high[wide] "
        f"{hp_wide[1]}; peak memory forward {hp29['fwd_peak'] / 2**30:.3f} GiB, "
        f"value_and_grad {hp29['vg_peak'] / 2**30:.3f} GiB")
    require(hp_wide == (HPAIR_LAYERS, HPAIR_LAYERS)
            and hp29["counts"]["merged_fact_apply"] == 0,
            f"[hpair29] did not run the expanded sweep: {hp29['counts']}")
    fact = HardwareEfficientAnsatz(N29, HPAIR_LAYERS, entangler="cz")
    pf = fact.init_params(torch.Generator().manual_seed(SEED))
    d_f = torch.stack(fact.densities(pf))
    pf.requires_grad_(True)
    fact.magnetization(pf).backward()
    hp_d = (hp29["dens"] - d_f).abs().max().item()
    hp_g = ((hp29["grad"] - pf.grad).abs() / pf.grad.abs().clamp(min=1.0)).max().item()
    log(f"[hpair29] expanded vs factorized route, same params: max abs density "
        f"err {hp_d:.3e} (tol {SLICE_TOL:.0e}), max gradient err / max(1, |g|) "
        f"{hp_g:.3e} (tol {MODEL_GRAD_TOL:.0e})")
    require(hp_d <= SLICE_TOL and hp_g <= MODEL_GRAD_TOL,
            "[hpair29] the expanded sweep disagrees with the factorized one")
    del fact, pf, d_f
    torch.cuda.empty_cache()

    # [hpair30]: the CNOT ring at 30q x 2L, whose lone top-group block (the
    # in-group CNOT (28, 29)) runs at X = 512 both ways by default; with the
    # hpair expanded the merged sweep too. The plain path does not fit in the
    # card's memory at 30q (its plain versions return fresh planes while the
    # layer loop still holds the planes it started from: 72 GiB live at the
    # first pair gram's 8 GiB copy), so the gradient is held against it at
    # 23q, where the same lone block runs on the same X = 512 kernels; the
    # 30q shapes are held kernel by kernel in phase 3f
    L30 = 2
    N23 = 23
    for factorized in (True, False):
        config.set_hpair_factorized(factorized)
        try:
            tag = f"hpair30 {'factorized' if factorized else 'expanded'} hpair"
            two = HardwareEfficientAnsatz(N30, L30, entangler="cnot")
            p2 = torch.zeros(L30, N30, 3, device=dev, requires_grad=True)
            K.reset_launch_counts()
            v2 = two.magnetization(p2)
            v2.backward()
            c2 = wide_counts(K.launch_counts())
            g2_max = p2.grad.abs().max().item()
            want_wide = L30 if factorized else 2 * L30
            log(f"[{tag}] {N30}q x {L30}L cnot params = 0: magnetization "
                f"{v2.item()!r} (want {N30}, tol {CLOSED_TOL * N30:.1e}); |grad| "
                f"max {g2_max:.3e} (tol {CLOSED_TOL:.0e}); wide launches {c2} "
                f"(want {(want_wide, want_wide)})")
            require(abs(v2.item() - N30) <= CLOSED_TOL * N30
                    and g2_max <= CLOSED_TOL, f"[{tag}] params = 0 failed")
            require(c2 == (want_wide, want_wide),
                    f"[{tag}] wide launches {c2}, want {want_wide} each")
            del two, p2, v2
            torch.cuda.empty_cache()
            kernels_vs_plain(N23, tag, "cnot", layers=L30)
        finally:
            config.set_hpair_factorized(True)

    # [fallback]: scan mode off the planes, plain torch on the card, against
    # the unrolled model (build()'s engine) or the plane path
    def dens_and_grad(model, loss: str, p):
        dens = torch.stack(model.densities(p))
        p = p.clone().requires_grad_(True)
        value = getattr(model, loss)(p)
        value.backward()
        return dens.detach(), value.item(), p.grad

    def fallback(tag, a, b, loss, p, plane_off_a=False):
        t0 = time.perf_counter()
        K.reset_launch_counts()
        config.set_plane_engine(False if plane_off_a else "auto")
        try:
            d_a, v_a, g_a = dens_and_grad(a, loss, p)
        finally:
            config.set_plane_engine("auto")
        launched = {k: v for k, v in K.launch_counts().items() if v}
        d_b, v_b, g_b = dens_and_grad(b, loss, p)
        d_err = (d_a - d_b).abs().max().item()
        g_err = ((g_a - g_b).abs() / g_b.abs().clamp(min=1.0)).max().item()
        log(f"[fallback] {tag}: value {v_a:.8f} vs {v_b:.8f}; max abs density err "
            f"{d_err:.3e} (tol {FALLBACK_TOL:.0e}); max gradient err / max(1, |g|) "
            f"{g_err:.3e} (tol {MODEL_GRAD_TOL:.0e}); kernel launches of the "
            f"fallback {launched}; {time.perf_counter() - t0:.2f} s")
        require(not launched, f"[fallback] {tag} launched kernels: {launched}")
        require(d_err <= FALLBACK_TOL and g_err <= MODEL_GRAD_TOL,
                f"[fallback] {tag} disagrees")

    vq = VQEIsing(10, 6)
    fallback("VQEIsing(10, 6) scan vs scan=False", vq,
             VQEIsing(10, 6, scan=False), "energy",
             vq.init_params(torch.Generator().manual_seed(SEED)))
    c128 = torch.complex128
    hz = HardwareEfficientAnsatz(20, 4, entangler="cz", dtype=c128)
    fallback("HardwareEfficientAnsatz(20, 4, cz) complex128 scan vs scan=False",
             hz, HardwareEfficientAnsatz(20, 4, entangler="cz", dtype=c128,
                                         scan=False), "magnetization",
             7.0 * hz.init_params(torch.Generator().manual_seed(SEED)))
    h24 = HardwareEfficientAnsatz(24, 4)
    fallback("HardwareEfficientAnsatz(24, 4) set_plane_engine(False) vs the plane "
             "path", h24, h24, "magnetization",
             7.0 * h24.init_params(torch.Generator().manual_seed(SEED)),
             plane_off_a=True)
    del vq, hz, h24
    torch.cuda.empty_cache()

    # [init28]: scan_with_epilogue from a seeded random normalised 28q state,
    # 4 cz layers, through the kernels and through the plain versions
    L_INIT = 4
    m28 = HardwareEfficientAnsatz(N_QUBITS, L_INIT, entangler="cz")
    zop = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex64, device=dev)
    g28 = torch.Generator(device=dev).manual_seed(SEED + 5)
    psi = torch.complex(torch.randn(1 << N_QUBITS, generator=g28, device=dev),
                        torch.randn(1 << N_QUBITS, generator=g28, device=dev))
    psi = psi / psi.abs().pow(2).sum().sqrt()
    p28 = 7.0 * m28.init_params(torch.Generator().manual_seed(SEED + 5))

    def init_run(kernels, state0, p0, z):
        state = state0.detach().clone().requires_grad_(True)
        p = p0.detach().clone().requires_grad_(True)
        dens = ps.scan_with_epilogue(m28._layer_ftape, m28._epi_ftape, state,
                                     m28._stacked_gates(p), m28._layer_consts,
                                     kernels=kernels)
        loss = torch.stack([expval_from_density(d, z) for d in dens]).sum()
        return loss, dens, state, p

    def init_meta(kernels):
        meta = torch.empty(1 << N_QUBITS, dtype=torch.complex64, device="meta")
        return init_run(kernels, meta, p28.to("meta"), zop.to("meta"))[0]

    want_fwd, want_vg, _ = dry_run_launches(init_meta)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss_k, dens_k, st_k, p_k = init_run(K.KERNELS, psi, p28, zop)
    fwd_init = K.launch_counts()
    loss_k.backward()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got_init = K.launch_counts()
    log(f"[init28] {N_QUBITS}q x {L_INIT}L cz from a random state through the "
        f"kernels: value_and_grad {init_s:.3f} s (first call); launches "
        f"{json.dumps(got_init)}")
    require(fwd_init == want_fwd and got_init == want_vg,
            f"[init28] launch counts {got_init}, want {want_vg}")
    loss_p, dens_p, st_p, p_p = init_run(K.PLAIN, psi, p28, zop)
    loss_p.backward()
    d_err = (torch.stack(dens_k) - torch.stack(dens_p)).abs().max().item()
    g_err = ((p_k.grad - p_p.grad).abs() / p_p.grad.abs().clamp(min=1.0)).max().item()
    s_max = st_p.grad.abs().max().item()
    s_err = (st_k.grad - st_p.grad).abs().max().item() / s_max
    log(f"[init28] kernels vs plain path: value {loss_k.item():.7f} vs "
        f"{loss_p.item():.7f}; max abs density err {d_err:.3e} (tol "
        f"{FALLBACK_TOL:.0e}); gate gradient err / max(1, |g|) {g_err:.3e} (tol "
        f"{MODEL_GRAD_TOL:.0e}); state gradient max err / its largest entry "
        f"{s_err:.3e} (tol {MODEL_GRAD_TOL:.0e}, largest {s_max:.3e})")
    require(d_err <= FALLBACK_TOL and g_err <= MODEL_GRAD_TOL
            and s_err <= MODEL_GRAD_TOL, "[init28] kernels disagree with the plain path")
    require(bool(torch.isfinite(torch.view_as_real(st_k.grad)).all()) and s_max > 0,
            "[init28] the state gradient is not finite and nonzero")
    del m28, psi, loss_k, dens_k, st_k, p_k, loss_p, dens_p, st_p, p_p
    torch.cuda.empty_cache()

    # 11. result lines --------------------------------------------------------
    # each kernel's row at the 29-qubit path's shape of its most launched
    # variant; launches from the 29q x 100L cz value_and_grad (and its
    # forward), for the CNOT ring's kernels from the 29q x 20L cnot
    # value_and_grad (and its forward), for block_backward_lane from
    # [tape29]'s value_and_grad (and its forward)
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
        "block_backward_lane": ("dqc_tpu_torch/csrc/block_backward_lane.cu",
                                "dqc_tpu/ops/pallas/block_backward.py:88", "29q"),
    }
    cnot_kernels = ("dual_multi_apply", "high_multi_apply", "block_backward_sublane")
    # the modes the VQE / QAOA slice ported, with their launches counted
    # per mode (ops.kernels' mode_launches): "launches" from the 29q x 26L
    # VQE value_and_grad; the build() slice's Q modes from [tape29] (the
    # high adjoint's) and [diagq] (the diag adjoint's)
    modes = {
        "block_backward_dual[diag_q]": (
            "dqc_tpu_torch/csrc/block_backward_dual.cu",
            "dqc_tpu/ops/pallas/block_backward.py:437 (diag_q)",
            "29q_g0_first_diag_first_q", "_q"),
        "dual_multi_apply[seed]": (
            "dqc_tpu_torch/csrc/dual_multi_apply.cu",
            "dqc_tpu/ops/pallas/dual_apply.py:165 (conj/acc/alias=False)",
            "29q_seed_T4_acc", "_seed_"),
        "high_multi_apply[seed]": (
            "dqc_tpu_torch/csrc/high_multi_apply.cu",
            "dqc_tpu/ops/pallas/high_apply.py:273 (conj/acc/alias=False)",
            "29q_seed_T4_acc", "_seed_"),
        "block_backward_high[diag_q]": (
            "dqc_tpu_torch/csrc/block_backward_high.cu",
            "dqc_tpu/ops/pallas/block_backward.py:906 (diag_q)",
            "29q_X128_g2_diag_first_q", "_q"),
        "diag_backward[with_q]": (
            "dqc_tpu_torch/csrc/diag.cu", "dqc_tpu/ops/pallas/diag.py:154 (with_q)",
            "29q_q", "_q"),
        "high_apply[wide_inplace]": (
            "dqc_tpu_torch/csrc/wide_apply.cuh",
            "dqc_tpu/ops/pallas/high_apply.py:76 (alias=True, X = 256 / 512)",
            "29q_X256_inplace", "_inplace"),
        "block_backward_high[wide]": (
            "dqc_tpu_torch/csrc/block_backward_high.cu",
            "dqc_tpu/ops/pallas/block_backward.py:906 (X = 256 / 512)",
            "29q_X256_wide", "_wide"),
    }
    mode_runs = {"block_backward_high[diag_q]": t29, "diag_backward[with_q]": tdq,
                 "high_apply[wide_inplace]": hp29, "block_backward_high[wide]": hp29}
    out = []

    def row_of(name, src, replaces, mine, variant, launches, launches_forward):
        rep = next(r for r in mine if r["variant"] == variant)
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "launches_forward": launches_forward,
                "launches_cnot29": countsc.get(name),
                "launches_28q": counts.get(name),
                "launches_vqe29": vqe29["counts"].get(name),
                "launches_qaoa29": qaoa29["counts"].get(name),
                "launches_tape29": t29["counts"].get(name),
                "launches_diagq": tdq["counts"].get(name),
                "launches_hpair29": hp29["counts"].get(name),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"], "variant": variant,
                "shape": rep["shape"], "dense_bound_ms": rep.get("dense_bound_ms")}

    for name, (src, replaces, variant) in sources.items():
        mine = [r for r in rows if r["kernel"] == name and not (
            name in ("block_backward_dual", "block_backward_high", "diag_backward",
                     "dual_multi_apply", "high_multi_apply")
            and r["variant"].endswith(("_q", "_acc", "_fresh")))]
        main_vg, main_fwd = ((countsc, fwdc) if name in cnot_kernels
                             else (t29["counts"], t29["counts_fwd"])
                             if name == "block_backward_lane" else (counts29, fwd29))
        out.append(row_of(name, src, replaces, mine, variant, main_vg[name],
                          main_fwd[name]))
    for name, (src, replaces, variant, tag) in modes.items():
        kernel = name.split("[")[0]
        mine = [r for r in rows if r["kernel"] == kernel and tag in r["variant"]]
        run = mode_runs.get(name, vqe29)
        out.append(row_of(name, src, replaces, mine, variant,
                          run["counts"][name], run["counts_fwd"][name]))
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
