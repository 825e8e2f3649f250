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
   apply at X = 256 / 512) and the diagonal-run kernels; and the six
   kernels that meet reduced cotangent storage or a bf16x3 dot, in their
   f16, bf16 and bf16x3 variants (the seeds of the dual and high applies at
   X = 128, 256, 512, the dual, high and merged-top adjoints, the diag
   adjoint), with the lane, sublane and X = 256 adjoints' bf16x3 pair
   grams;
4. the 28-qubit forward: HardwareEfficientAnsatz(28, 10, entangler="cz")
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
   at the 30q shape) in phase 3; [hpair29], HardwareEfficientAnsatz(29, 5,
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
11. reduced cotangent storage (run beside phase 6): [f16_29], the 29-qubit
   x 100-layer value_and_grad of phase 6 under "f16", once (its value
   bit-identical to f32 storage's, the gradient's rms error, counts with the
   f16 and bf16x3 variants, the step and peak memory); [storage29], 29q x 4L under
   "mixed" and "f16" against f32 storage, counts held to the meta-device
   dry run; [f16_30], 30q x 20L under "f16": warm steps, peak memory,
   params = 0 and the one-layer closed form;
12. reduced cotangent storage on the other plane paths: in phase 3 the
   multi-term applies in place on f16 / bf16 cotangent planes and as seeds
   into them (acc and fresh), the lane and sublane adjoints and the X = 256
   (29q) / 512 (30q) adjoint with bf16x3 transport (and in f16 with an f32
   transport beside it), the X = 8 span seed into f16 planes, each against
   its plain version; then [cnot29_f16], [vqe29_f16], [qaoa29_f16] and
   [tape29_f16] (the models of phases 7-9 and the gauntlet tape under
   "f16" on the same params: values bit-identical to f32 storage's, the
   gradient's rms error within its bar, counts held to the dry run under
   the same storage, warm steps and peak memory), [paths29_mixed] (the CNOT
   ring, VQE, QAOA and the tape under "mixed", the X = 256 wide adjoint
   under "mixed" and "f16", each against f32 storage, whose runs launch
   none of the storage variants) and [hpair30_f16] (the CNOT ring at 30q x
   2L under "f16", both hpair settings, params = 0);
13. "bf16" forward storage and the forward bf16x3 on the cz path: in phase
   3 the nine kernels of the path on bf16 forward planes and in bf16x3
   (3i: the dual and X = 128 applies in place and as seeds, the X = 256 /
   512 seeds, the Grams, the merged sweep and its adjoint, the dual and
   X = 128 adjoints, the diagonal runs), each against its plain version,
   and the merged-top adjoint again under "f16" / "mixed" with the f32
   transport the port hands it since; then [bf16_29] (the [ref29] model
   under "bf16": value and gradient against the reference within 2.5
   times the JAX package's own error at 14-16q, counts held to the dry
   run, warm step and peak memory), [x3_29] (the same under
   set_kernel_dot_mode("bf16x3") with "f32" and with "bf16" storage, and
   the 29q x 1L closed form under it) and [bf16_30] (30q x 4L under
   "bf16" at params = 0: the X = 512 seed and Xt = 4 on bf16 planes);
14. "bf16" storage and the forward bf16x3 at every ring size, on the CNOT
   ring and on the expanded merged top: in phase 3 (3j) the high apply,
   Gram and adjoint at X = 8..64 (views of 2^29 amplitudes), the in-place
   apply and the adjoint on the merged top axis (X = 256 at 29q, 512 at
   30q), the multi-term applies (in place on the ring's CNOT terms, an edge
   density's seed) and the sublane adjoint, on bf16 planes and in bf16x3,
   each against its plain version; then [cz_bf16_small]
   (HardwareEfficientAnsatz(n, 4, "cz") at n = 20 and 27 under "bf16" and
   the forward bf16x3 against its f32 run: value and gradient rms within
   2.5 times the JAX package's own error on the model at 14-17q, counts
   held to the dry run), [cnot29_bf16] ([cnot29]'s model and params under
   "bf16" against its f32 gradient; the forward bf16x3 at 29q x 4L on f32
   and bf16 planes against an f32 run), [hpair29_bf16] (cz 29q x 4L with the
   hpair expanded, under "bf16" and the forward bf16x3, against the
   factorized route) and [cnot30_bf16] (30q x 2L cnot under "bf16" at
   params = 0: the lone X = 512 top block on bf16 planes);
15. "bf16" storage and the forward bf16x3 on VQE, QAOA and the plane tape,
   and "f16" on the per-term fallback: in phase 3 (3k) the lane adjoint on
   bf16 F and with the uncompute bf16x3, the dual adjoint's and the high
   adjoint's (X = 8, 64, 128) Q reductions in both run orders and the diag
   adjoint's on bf16 F and (the first two) with the uncompute bf16x3, and
   the dual and high applies on f16 input planes (fresh, acc), each
   against its plain version; then [paths29_bf16] ([paths29_mixed]'s VQE
   29q x 4L and QAOA 29q x 2L and [tape29]'s tape under "bf16", f32 +
   bf16x3 and bf16 + bf16x3 against their f32 runs, the [diagq] tape under
   "bf16"), [vqe_bf16_small] (VQEIsing(n, 2) at n = 20 and 27 under "bf16"
   and the forward bf16x3), [vqe29_bf16] ([vqe29]'s VQEIsing(29, 26) under
   "bf16": its step and peak memory against f32's) and [per_term29_f16] (a
   29q x 2L build() tape whose dense gate on qubits (16, 7) takes the
   per-term fallback, under "f16" against f32 storage); each against the
   JAX package's own error on the same model at 14-17q (2.5 times, capped),
   counts held to the meta-device dry run;
16. the high adjoint at X = 8..64 on the tensor cores (3m,
   csrc/block_backward_high_small.cu): every variant its entry takes (F
   f32 / bf16, B f32 / bf16 / f16, each product 3xTF32 or bf16x3, no run
   or a run met first or after, with and without Q) against its plain
   version on views (2, X, 256, 128), and f32 planes at X = 16, 32, 64 on
   views of 2^29 amplitudes with their times (the X = 8 span views in
   phase 7, with the default bf16x3 pair gram too); then [cz_f32_small]
   (HardwareEfficientAnsatz(n, 4, "cz") on f32 planes at n = 20, group 2
   at X = 64, and 25, group 3 at X = 16: densities and gradients through
   the kernels against the plain path, counts held to the dry run, every
   high adjoint launch counted block_backward_high[tc]);
17. the Gram at X = 128 / 256 / 512 and the merged-top adjoint on the
   tensor cores (3n, csrc/gram.cu's dqc_gram_tc and
   csrc/block_backward_merged_fact.cu on csrc/tc_adjoint.cuh's step): every
   variant their entries take (the Gram's lane, sublane, high and merged-top
   views on f32 and bf16 planes in both dot modes; the merged adjoint at
   Xt = 2 and 4 with F f32 / bf16, B f32 / bf16 / f16 and every
   combination of the three dot modes, a bf16x3 uncompute beside a bf16x3
   transport among them) against their plain versions on small views, that
   pair also timed at 2^29; every launch of both counted gram[tc] /
   block_backward_merged_fact[tc] and held to the dry runs;
18. the tensor-core routes (3l, after phase 3): the high apply at every X
   (csrc/tc_apply.cuh at X = 128 / 256 / 512, csrc/high_apply_small.cu
   below, every storage and mode, counted as high_apply[tc]), the
   multi-term applies (dual_multi_apply[tc], high_multi_apply[tc]: the
   dual multi-term kernel at every X), the X = 256 / 512
   adjoint (its cross-Gram and its two updates on the tensor cores), the
   dual, lane and sublane adjoints
   and the high adjoint at X <= 128 (their one-pass step,
   csrc/tc_adjoint.cuh and csrc/block_backward_high_small.cu, every
   storage, mode, run and Q, counted as block_backward_dual[tc],
   block_backward_lane[tc], block_backward_sublane[tc] and
   block_backward_high[tc]; the lane and sublane adjoints built in the
   dual adjoint's library), the Gram at every X and the merged-top
   adjoint (gram[tc], block_backward_merged_fact[tc]; its top factor's f32
   work on the CUDA cores at the FP32 rate), the dual apply and the
   merged-top apply (dual_apply[tc], merged_fact_apply[tc]; the merged top
   factor's f32 work likewise): each of their phase-3 rows again with
   its bound on the tensor cores (tc_bound_ms: the mma passes the kernel
   runs, three per real product, one fewer for each planes operand whose
   lo parts are zero — 16-bit planes in 3xTF32, bf16 planes in bf16x3 —
   tf32 at 495 TFLOP/s, bf16 at 989), which is then the row's bound_ms,
   and its share of it, and the kernels' registers and spills from this
   run's build;
19. the dual apply and the merged-top apply on the tensor cores (3o, after
   3n: csrc/dual_apply.cu and csrc/merged_fact_apply.cu on
   csrc/tc_adjoint.cuh's tile product): every variant their entries take
   (the dual apply with x f32 / bf16 / f16, in place, fresh and into an
   accumulator of each storage, no run or one first or after, both dot
   modes; the merged apply at Xt = 2 and 4 on f32 and bf16 planes, both dot
   modes) against their plain versions on small views; their phase-3 rows
   timed at 29q with their tensor-core bounds in phase 3l, every launch of
   both counted dual_apply[tc] / merged_fact_apply[tc] and held to the dry
   runs;
20. the high apply at X = 8..64 and the multi-term dual apply on the tensor
   cores (3p, after 3o: csrc/high_apply_small.cu, 2048-amplitude tiles
   streamed through a cp.async ring with E pre-split in shared memory, and
   csrc/dual_multi_apply.cu, term by term a lane and a sublane product
   summed in registers, the operators streamed by bulk copies): every
   variant their entries take (the high apply at X = 8, 16, 32, 64 with x
   f32 / bf16 / f16, in place, fresh and into an accumulator of each
   storage, no run or one first or after, both dot modes; the multi-term
   apply with T = 1, 2, 4, 16 in the same storages, forms and dot modes)
   against their plain versions on small views; the f32 high apply in
   place at X = 16 / 32 / 64 timed at 29q; their other rows timed in the
   earlier phases with their tensor-core bounds in phase 3l; every launch of
   both counted high_apply[tc] / dual_multi_apply[tc] and held to the dry
   runs;
21. the high multi-term apply on the dual multi-term kernel and the Gram at
   X = 8..64 on the tensor cores (3q, after 3p: csrc/dual_multi_apply.cu's
   entry dqc_high_multi_apply, a tile of 128 / X consecutive m of one i,
   the group product block-diagonal, X = 8 as diag(E, E); csrc/gram.cu's
   dqc_gram_tc, one X x X patch a block streamed through a cp.async ring):
   every variant their entries take (the high multi-term apply at X = 8,
   16, 32, 64, 128 with T = 2 and 4 terms, x f32 / bf16 / f16, in place,
   fresh and into an accumulator of each storage, both dot modes; the Gram
   at X = 8, 16, 32, 64 on f32 and bf16 planes in both dot modes) against
   their plain versions on small views; the f32 Gram at X = 8 and 64 timed
   at 29q; the multi-term apply's other rows timed in the earlier phases
   with their tensor-core bounds in phase 3l; every launch of both counted
   high_multi_apply[tc] / gram[tc] and held to the dry runs;
22. a JSON line of the kernels and of the modes checked (their launches
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
L28 = 10            # [slice] / [grad] (the 28q comparison phases): depth cut
                    # from 100 for chip time (the run's 1200 s)
HPAIR_LAYERS = 5    # [hpair29]: depth cut from 100 for chip time only
CHECK_LAYERS = 20
SEED = 1234
N29 = 29            # the JAX package's bench workload: 29q x 100L value_and_grad
N30 = 30
CNOT_LAYERS = 20    # the CNOT ring at 29q: depth cut from 100 for time
CNOT = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0))
VQE_LAYERS = 26     # VQEIsing(26, 26): the reference's headline workload
QAOA_LAYERS = 6
QAOA_EXTRA_EDGES = 14   # random_graph(29, 14, 0), the example's graph at 29q

# Published H100 SXM peaks (dense): FP32 on the CUDA cores, bf16 on the
# tensor cores (the rate of bf16x3's three bf16 products) and HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12   # the tensor cores' TF32 rate (3xTF32's products)
PEAK_BF16_FLOPS = 989e12
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
STORE_ULPS = 2.0        # reduced cotangent planes, kernel vs plain: storage
                        # ulps at max(|amplitude|, the planes' rms)
                        # (_storage.ulps_apart)
FWD16_ULPS = 1.0        # bf16 forward planes, kernel vs plain: storage ulps
X3_GRAM_TOL = 4e-5      # reductions in bf16x3 on f32 planes, kernel vs plain
F16_29_RMS_TOL = 2e-3   # [f16_29]: rms |g - g32| / max |g32| (29q x 100L)
MODES29_L = 20          # [ref29], [bf16_29], [x3_29]: 29q depth cut from the
                        # bench's 100 for chip time
BF16_30_L = 4           # [bf16_30]
FWD16_JAX_BARS = (2e-3, 5e-3)   # "bf16": value (relative), gradient (of max
                        # |g32|): the JAX package's (tests/test_state_storage.py)
# the JAX package's own error on [bf16_29] / [x3_29]'s model and depth
# (HardwareEfficientAnsatz(n, 20, "cz"), params 0.1 N(0, 1)), the largest
# over 14-16q (CPU, its plane engine; printed by
# tests/test_torch_fwd16_models.py chip-bars): (value relative, gradient rms
# of max |g32|); fwd16_bars makes the phases' bars of them
JAX_OWN_FWD16 = {("bf16", "f32"): (1.465e-2, 1.678e-2),
                 ("f32", "bf16x3"): (5.001e-5, 4.391e-5),
                 ("bf16", "bf16x3"): (1.507e-2, 1.926e-2)}
STORAGE29_TOL = {"mixed": 5e-2, "f16": 5e-3}  # [storage29]: rms |g - g32| /
                        # max |g32|; the JAX package's own on the same model
                        # and params is 9.65e-3 and 1.19e-3 at 16q (max 5.0e-2
                        # and 6.3e-3, the port's the same), the port's
                        # 5.5e-3-2.1e-2 and 1.1e-3-1.4e-3 at 18-22q (CPU)
F16_CLOSED_TOL = 4e-3   # [f16_30]: 30q x 1L closed form under f16 storage; the
                        # JAX package's own error there is 1.1e-3 at 14q and
                        # 1.3e-3 at 16q (CPU), the port's the same to 4
                        # digits, 2.0e-3 at 22q
BF16X3_GRAM_TOL = 2e-4  # the closed forms under the default bf16x3 pair grams,
                        # per parameter over max(1, |g|): the JAX package's
                        # own bar for its bf16x3 grams against f32
                        # (tests/test_plane_scan.py); with f32 grams they
                        # keep their own bars
REDUCED_TOL = {"f16": 5e-3, "mixed": 5e-2}  # [storage29]'s rms bars, and
# the JAX package's own largest max |g - g32| / max |g32| on each reduced
# phase's model at 14-16q (CPU, its plane engine; printed by
# tests/test_torch_storage_models.py chip-bars and
# tests/test_torch_storage_tape.py): a phase's rms bar is the smaller of
# the two bars and 2.5 times this figure
JAX_OWN_ERR = {("cnot", "f16"): 2.792e-3, ("vqe", "f16"): 3.505e-4,
               ("qaoa", "f16"): 1.321e-4, ("tape", "f16"): 1.06e-4,
               ("cnot", "mixed"): 5.379e-3, ("vqe", "mixed"): 1.830e-3,
               ("qaoa", "mixed"): 7.559e-4, ("tape", "mixed"): 1.05e-3,
               ("hpair", "mixed"): 5.297e-2, ("hpair", "f16"): 5.246e-3,
               ("per_term", "f16"): 4.756e-4}   # per_term_tape x 2L at 17-18q
                                                # (tests/test_torch_fwd16_tape.py)


def own_bars(own):
    """(value, gradient rms) bars of a phase from the JAX package's own error
    ``own`` = (value, rms) on its model: 2.5 times it, capped by
    FWD16_JAX_BARS; where the JAX package's own error is already past that
    cap (its bars are for another model), 2.5 times it."""
    return tuple(2.5 * o if o >= cap else min(cap, 2.5 * o)
                 for o, cap in zip(own, FWD16_JAX_BARS))


def fwd16_bars(storage: str, dot: str):
    """own_bars of [bf16_29] / [x3_29]'s model."""
    return own_bars(JAX_OWN_FWD16[storage, dot])


# this slice's phases: [cz_bf16_small] (HardwareEfficientAnsatz(n, 4, "cz")
# at n = 20 and 27: group 2 at X = 64; group 3 at X = 64 beside the X = 128
# group 2), [cnot29_bf16] ([cnot29]'s model under "bf16"; the forward
# bf16x3 at 29q x CNOT_X3_L), [cnot30_bf16] (the CNOT ring at 30q x 2L,
# params = 0, its lone top-group block at X = 512), [hpair29_bf16] (cz 29q x
# HPAIR_BF16_L with the hpair expanded)
CZ_SMALL_NS = (20, 27)
CZ_SMALL_L = 4
CZ_F32_SMALL_NS = (20, 25)  # [cz_f32_small]: group 2 at X = 64, group 3 at X = 16
CNOT_X3_L = 2           # depth cut for chip time: the run's 1200 s
CNOT30_L = 2
HPAIR_BF16_L = 4
# the JAX package's own error on those models at 14-17q (CPU, its plane
# engine; printed by tests/test_torch_fwd16_rings.py chip-bars): (value
# relative, gradient rms of max |g32|) per (entangler, layers, storage,
# forward dot mode); own_bars makes the phases' bars of them
JAX_OWN_RINGS = {("cz", 4, "bf16", "f32"): (1.204e-2, 1.430e-2),
                 ("cz", 4, "f32", "bf16x3"): (1.118e-5, 3.081e-5),
                 ("cnot", 20, "bf16", "f32"): (1.280e-2, 4.645e-3),
                 ("cnot", 4, "f32", "bf16x3"): (4.203e-5, 1.107e-5),
                 ("cnot", 4, "bf16", "bf16x3"): (6.211e-3, 2.043e-3),
                 ("cnot", 2, "f32", "bf16x3"): (2.103e-5, 1.274e-5),
                 ("cnot", 2, "bf16", "bf16x3"): (5.741e-3, 2.730e-3)}


def reduced_tol(model: str, storage: str) -> float:
    return min(REDUCED_TOL[storage], 2.5 * JAX_OWN_ERR[model, storage])



PATHS_L = {"cnot": 4, "vqe": 4, "qaoa": 2, "hpair": 4}  # [paths29_mixed] depths
# the phases of VQE, QAOA and the tapes under "bf16" / the forward
# bf16x3 and of the per-term fallback under "f16": [paths29_bf16]
# ([paths29_mixed]'s VQE and QAOA, [tape29]'s tape and [diagq]'s),
# [vqe_bf16_small] (VQEIsing(n, VQE_SMALL_L) at n = VQE_SMALL_NS),
# [vqe29_bf16] ([vqe29]'s model under "bf16"), [per_term29_f16]
# (per_term_tape at 29q x PER_TERM_L under "f16")
VQE_SMALL_NS = (20, 27)
VQE_SMALL_L = 2
PER_TERM_L = 2
# the JAX package's own error on those models at 14-17q (CPU, its plane
# engine; printed by tests/test_torch_fwd16_paths.py chip-bars and
# tests/test_torch_fwd16_tape.py chip-bars): (value relative, gradient rms
# of max |g32|), max over n, per (model, layers, storage, dot); own_bars
# makes the phases' bars of them
JAX_OWN_PATHS = {("vqe", 4, "bf16", "f32"): (3.944e-4, 1.655e-3),
                 ("vqe", 4, "f32", "bf16x3"): (1.282e-5, 4.237e-5),
                 ("vqe", 4, "bf16", "bf16x3"): (4.827e-4, 1.201e-3),
                 ("qaoa", 2, "bf16", "f32"): (2.179e-4, 1.564e-3),
                 ("qaoa", 2, "f32", "bf16x3"): (3.135e-7, 1.503e-5),
                 ("qaoa", 2, "bf16", "bf16x3"): (2.236e-4, 1.542e-3),
                 ("vqe", 2, "bf16", "f32"): (3.357e-4, 4.494e-4),
                 ("vqe", 2, "f32", "bf16x3"): (1.064e-5, 1.514e-5),
                 ("vqe", 26, "bf16", "f32"): (1.075e-3, 1.059e-3),
                 ("tape", 2, "bf16", "f32"): (9.756e-4, 2.544e-4),
                 ("tape", 2, "f32", "bf16x3"): (9.832e-6, 4.126e-6),
                 ("tape", 2, "bf16", "bf16x3"): (5.652e-4, 2.769e-4),
                 ("diagq", 1, "bf16", "f32"): (8.657e-4, 1.042e-4)}
F16_L = 6               # [f16_30]: 30q depth cut from the bench's for chip
                        # time (the run's 1200 s)
STORAGE_L = 4           # [storage29]
BWD_KERNELS = ("block_backward_dual", "block_backward_high",
               "block_backward_merged_fact", "block_backward_lane",
               "block_backward_sublane")
# the adjoints whose one-pass step runs on the tensor cores
# (csrc/tc_adjoint.cuh), every launch counted as "tc"; block_backward_high
# runs it at X = 128 (TC_HIGH_X) and its small-X counterpart
# (csrc/block_backward_high_small.cu) at X = 8..64, those launches counted
# as "tc" (not the X = 256 / 512 wide adjoint's)
TC_ADJOINTS = ("block_backward_dual", "block_backward_lane",
               "block_backward_sublane")
TC_HIGH_X = 128


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


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_time(phase: str) -> None:
    """When a phase starts, in seconds of the run (the chip-time budget)."""
    log(f"[time] {phase} at {time.perf_counter() - T_START:.1f} s")


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


def bound_ms(bytes_moved: float, flops: float, bf16_flops: float = 0.0):
    """The least time for the work: the bytes over the HBM rate, or the f32
    flops over the FP32 rate plus the bf16 flops (bf16x3's three bf16
    products per real multiply-add) over the bf16 rate, the larger."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tc_product(cmacs: float, x3: bool, *planes) -> tuple:
    """(tf32 flops, bf16 flops) that the tensor cores run for a split
    complex product of ``cmacs`` complex multiply-adds (csrc/mma.cuh cmma3):
    8 flops a pass, three passes (hi hi, hi lo, lo hi), one fewer for each
    planes operand in ``planes`` whose lo parts are zero: 16-bit planes in
    3xTF32, bf16 planes in bf16x3. ``planes``: the storage dtypes (or
    their names) of the planes operands; the operator's are never zero.
    Planes a folded run multiplies before the product count as float32."""
    names = [str(p).split(".")[-1] for p in planes]
    exact = sum(n == "bfloat16" or (not x3 and n == "float16") for n in names)
    fl = 8 * cmacs * (3 - exact)
    return (0.0, fl) if x3 else (fl, 0.0)


def adjoint_tc(cmacs: float, fdt="float32", bdt="float32", dot="f32",
               bwd="f32", gram="f32") -> list:
    """The tensor-core work of an adjoint launch on csrc/tc_adjoint.cuh,
    ``cmacs`` complex multiply-adds per product kind (the dual's two steps:
    256 per amplitude; the lane and sublane adjoints' one: 128; the high
    adjoint's: X, its operators' dense width):
    the uncomputes on F (stored ``fdt``) in ``dot``, the transports on B
    (``bdt``) in ``bwd``, the pair grams of B and the f32 uncompute in
    ``gram``. In 3xTF32 an operator meets 16-bit planes in three parts, so
    those products keep their three passes. A run folded into the dual
    adjoint rounds its planes back to their storage (the TPU kernel's
    staging), so they count at their storage; a run the high adjoint meets
    first leaves f32 values in its tiles (no staging): such rows pass
    "float32"."""
    def product(mode, dt):
        x3 = mode == "bf16x3"
        return tc_product(cmacs, x3, dt if x3 else "float32")
    return [product(dot, fdt), product(bwd, bdt),
            tc_product(cmacs, gram == "bf16x3", bdt, "float32")]


def dual_apply_tc(amps: float, xdt="float32", dot="f32", run_first=False) -> list:
    """The tensor-core work of a dual apply launch (csrc/dual_apply.cu) on
    ``amps`` amplitudes: its lane product on x (stored ``xdt``; a run
    multiplied in first leaves f32 values) and its sublane product on the
    f32 T, 128 complex multiply-adds per amplitude each. In 3xTF32 El meets
    16-bit x in three parts, so that product keeps its three passes."""
    x3 = dot == "bf16x3"
    lane = xdt if x3 and not run_first else "float32"
    return [tc_product(amps * 128, x3, lane), tc_product(amps * 128, x3, "float32")]


def high_apply_tc(amps: float, X: int, xdt="float32", dot="f32",
                  run_first=False) -> list:
    """The tensor-core work of a high apply launch: X complex multiply-adds
    per amplitude (csrc/tc_apply.cuh at X >= 128, csrc/high_apply_small.cu
    below), a pass fewer where x's lo parts are zero: bf16 x in bf16x3, and
    16-bit x in 3xTF32 at X >= 128 (below, E meets it in three parts and
    keeps three passes). A run multiplied in first leaves f32 values."""
    x3 = dot == "bf16x3"
    planes = "float32" if run_first or (X < 128 and not x3) else xdt
    return [tc_product(amps * X, x3, planes)]


def multi_apply_tc(amps: float, T: int, xdt="float32", dot="f32") -> list:
    """The tensor-core work of a multi-term dual apply launch
    (csrc/dual_multi_apply.cu): each term's lane and sublane products, as
    the dual apply's (dual_apply_tc), whatever zeros its factors hold."""
    return dual_apply_tc(amps * T, xdt, dot)


def high_multi_tc(amps: float, X: int, T: int, xdt="float32", dot="f32") -> list:
    """The tensor-core work of a high multi-term apply launch (the dual
    multi-term kernel's entry dqc_high_multi_apply in
    csrc/dual_multi_apply.cu): per term the lane product on x (stored
    ``xdt``) as the dual apply's, 128 complex multiply-adds per amplitude,
    and the group product on the f32 T, X (the function's; the kernel runs
    16 at X = 8, as diag(E, E)), whatever zeros its factors hold."""
    x3 = dot == "bf16x3"
    return [tc_product(amps * T * 128, x3, xdt if x3 else "float32"),
            tc_product(amps * T * X, x3, "float32")]


def merged_apply_tc(amps: float, x_top: int, dot="f32") -> list:
    """The work of a merged-top apply launch (csrc/merged_fact_apply.cu):
    its low factor on the tensor cores on the f32 combinations of the top
    factor, which takes Xt complex multiply-adds per amplitude on the CUDA
    cores."""
    return [tc_product(amps * 128, dot == "bf16x3", "float32"), cuda_core(amps * x_top * 8)]


def gram_tc(amps: float, X: int, dt="float32", dot="f32") -> list:
    """The tensor-core work of a Gram launch (csrc/gram.cu's dqc_gram_tc, at
    every X): the function's 2 X + 1 real multiply-adds per amplitude,
    three tf32 passes ("f32") or three bf16 passes (bf16x3) on f32 planes,
    one bf16 pass on bf16 planes (exact in both formats: the kernel runs
    them as bf16 products whatever the mode)."""
    bf = str(dt).split(".")[-1] == "bfloat16"
    return [tc_product(amps * (2 * X + 1) / 4, bf or dot == "bf16x3", dt, dt)]


def cuda_core(flops: float) -> tuple:
    """Work of a tensor-core route that stays on the CUDA cores (f32 FMA):
    the merged adjoint's top factor and T0_top."""
    return (0.0, 0.0, flops)


def tc_fields(tc) -> dict:
    """A row's tensor-core work: ``tc``, the tc_product of each of its
    products (and its cuda_core work), summed as tc_flops = [tf32 flops,
    bf16 flops, f32 flops on the CUDA cores]; {} for a row off the tensor
    cores (tc None)."""
    if tc is None:
        return {}
    return {"tc_flops": [sum(t[k] if len(t) > k else 0.0 for t in tc)
                         for k in range(3)]}


def tc_bound_ms(bytes_moved: float, tf32_flops: float, bf16_flops: float,
                fp32_flops: float = 0.0):
    """bound_ms of a tensor-core route from the passes it runs (tc_product):
    the tf32 flops at the TF32 rate plus the bf16 flops at the bf16 rate
    (plus the f32 flops it runs on the CUDA cores at the FP32 rate), or the
    bytes over the HBM rate, the larger."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = (tf32_flops / PEAK_TF32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
             + fp32_flops / PEAK_FP32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def storage_modes(dtype) -> tuple:
    """The storage mode a launch counts for planes of ``dtype``."""
    import torch
    return {torch.bfloat16: ("bf16",), torch.float16: ("f16",)}.get(dtype, ())


def dot_modes(a) -> tuple:
    return ((("bf16x3",) if a.get("bwd_mode") == "bf16x3" else ())
            + (("gram_bf16x3",) if a.get("gram_mode") == "bf16x3" else ()))


def fwd_modes(dtype, a) -> tuple:
    """The forward storage and dot-mode counts of a launch on forward planes
    of ``dtype``: "fwd_bf16" (bf16 planes), "fwd_bf16x3" (the forward
    bf16x3)."""
    import torch
    return ((("fwd_bf16",) if dtype == torch.bfloat16 else ())
            + (("fwd_bf16x3",) if a.get("dot_mode") == "bf16x3" else ()))


def call_modes(name: str, a) -> tuple:
    """The counted modes (ops.kernels' ``mode_launches``) of a call of
    kernel ``name`` with bound arguments ``a``."""
    import torch
    # the dual, lane and sublane adjoints run their one-pass step on the
    # tensor cores in every storage and mode, the high adjoint at X <= 128
    if name == "block_backward_dual":
        return (("diag_q", "tc") if a.get("diag_q") else ("tc",)) + storage_modes(
            a["br"].dtype) + dot_modes(a) + fwd_modes(a["fr"].dtype, a)
    if name == "block_backward_high":
        return ((("diag_q",) if a.get("diag_q") else ()) + (
            ("wide",) if a["fr"].shape[1] > 128 else ()) + (
            ("tc",) if a["fr"].shape[1] <= TC_HIGH_X else ())
            + storage_modes(a["br"].dtype) + dot_modes(a)
            + fwd_modes(a["fr"].dtype, a))
    if name == "block_backward_merged_fact":
        return (("tc",) + storage_modes(a["br"].dtype) + dot_modes(a)
                + fwd_modes(a["fr"].dtype, a))
    if name == "block_backward_lane":
        return (("tc",) + storage_modes(a["br"].dtype) + dot_modes(a)
                + fwd_modes(a["fr"].dtype, a))
    if name == "block_backward_sublane":
        return (("tc",) + storage_modes(a["br"].dtype) + dot_modes(a)
                + fwd_modes(a["fr"].dtype, a))
    if name in ("dual_apply", "high_apply"):
        acc = a.get("acc")
        out = (acc[0].dtype if acc is not None
               else a.get("out_dtype") or a["xr"].dtype)
        inplace = acc is None and a.get("alias", True)
        wide = (("wide_inplace",) if name == "high_apply" and inplace
                and a["xr"].shape[1] > 128 else ())
        seed = acc is not None or not a.get("alias", True)
        in16 = ("in_f16",) if a["xr"].dtype == torch.float16 else ()
        # both run on the tensor cores at every X, in every storage and mode
        return (in16 + wide + ("tc",) + (storage_modes(out) if seed else ())
                + fwd_modes(a["xr"].dtype, a))
    if name == "gram":  # the tensor-core Gram at every X
        return ("tc",) + fwd_modes(a["xr"].dtype, a)
    if name == "merged_fact_apply":  # its low factor on the tensor cores
        return ("tc",) + fwd_modes(a["xr"].dtype, a)
    if name == "diag_sweep":
        return fwd_modes(a["xr"].dtype, a)
    if name == "diag_backward":
        return ((("with_q",) if a.get("with_q") else ()) + storage_modes(a["br"].dtype)
                + fwd_modes(a["fr"].dtype, a))
    if name in ("dual_multi_apply", "high_multi_apply"):
        acc, alias = a.get("acc"), a.get("alias", True)
        seed = a.get("conj") or acc is not None or not alias
        out = (acc[0].dtype if acc is not None else a["xr"].dtype if alias
               else a.get("out_dtype") or a["xr"].dtype)
        # a seed reads the forward planes; in place, bf16 planes count as
        # "bf16" whichever pair they are; both run on the tensor cores
        return (("tc",) + (("seed",) if seed else ()) + storage_modes(out)
                + fwd_modes(a["xr"].dtype if seed else None, a))
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


def model_dry_run(build, loss: str):
    """The run of dry_run_launches for the model ``build(device)`` makes:
    its ``loss`` on the meta device."""
    import torch

    def run(kernels):
        model = build("meta")
        params = model.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        return getattr(model, loss)(params, kernels=kernels)
    return run


def program_launches(build, loss: str):
    """dry_run_launches of one forward and one value_and_grad of the model
    ``build(device)`` makes."""
    return dry_run_launches(model_dry_run(build, loss))


def with_gram_modes(want: dict) -> dict:
    """Launch counts of a run under the default dot modes: every launch of
    an adjoint kernel with a pair gram counts in its "gram_bf16x3" mode when
    config.gram_kernel_dot_mode() is "bf16x3" (the default), and every
    launch of the dual, lane, sublane and merged-top adjoints in its "tc"
    mode (their one-pass step runs on the tensor cores in every mode), as
    does every high adjoint launch, every Gram (at every X), every dual and
    merged-top apply and every multi-term apply (all on the tensor cores in
    every storage and mode)."""
    from dqc_tpu_torch import config
    x3 = config.gram_kernel_dot_mode() == "bf16x3"
    for k in BWD_KERNELS:
        want[f"{k}[gram_bf16x3]"] = want.get(k, 0) if x3 else 0
    for k in (*TC_ADJOINTS, "block_backward_high", "block_backward_merged_fact", "gram",
              "dual_apply", "merged_fact_apply", "dual_multi_apply", "high_multi_apply"):
        want[f"{k}[tc]"] = want.get(k, 0)
    return want


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


def diag_q_tape(circuit, n: int):
    """A tape with a lone variable diagonal run (no dense sweep to fold
    into): its adjoint is diag_backward with the Q reductions."""
    c = circuit
    for i in range(n):
        c.add_q1_const_gate(i)
    for i in range(n):
        c.get_q1_dens_op_with_grad(i)
    for i in range(n - 1):
        c.add_q2_var_gate_diag(i + 1, i)
    for i in range(n):
        c.get_q1_dens_op_with_grad(i)
    for i in range(n):
        c.add_q1_var_gate(i)
    for i in range(n):
        c.get_q1_dens_op_with_grad(i)
    return c


def per_term_tape(circuit, layers: int):
    """A tape whose variable dense gate on qubits (16, 7), the sublane group
    and group 2 ten bits apart, has no span view and no multi-term kernel:
    it runs the per-term fallback (plane_scan._apply_dense_cross), two
    sweeps of the dual and high applies per Schmidt term, on the cotangent
    in its storage. Each layer: densities with gradient on qubits 7 and 16,
    variable gates on qubits 3 (the lane group), 7, 10 and 16, the dense
    gate, a variable gate on 15; the densities again at the end."""
    c = circuit
    for _ in range(layers):
        c.get_q1_dens_op_with_grad(7)
        c.get_q1_dens_op_with_grad(16)
        for q in (3, 7, 10, 16):
            c.add_q1_var_gate(q)
        c.add_q2_var_gate(16, 7)
        c.add_q1_var_gate(15)
    c.get_q1_dens_op_with_grad(7)
    c.get_q1_dens_op_with_grad(16)
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
    from dqc_tpu_torch import HardwareEfficientAnsatz, config
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
        f"into {_build.BUILD_DIR}; nvcc seconds per library (all started at "
        f"once) {json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernel checks at the 28-qubit shapes -------------------------------
    log_time("kernel checks")
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
              dense_flops=None, tc=None):
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
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bf16_flops=0.0, bytes=bytes_moved,
                   **tc_fields(tc))
        if dense_flops is not None:
            # what the kernel computes: dense products, whatever the zeros
            row["dense_bound_ms"] = bound_ms(bytes_moved, dense_flops)[0]
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del xr, xi, work_r, work_i
        torch.cuda.empty_cache()

    def check_many(kernel, variant, shape, n_in, n_planes_out, fn_kernel,
                   fn_plain, tol, flops, bytes_moved, library=None,
                   intact=0, dense_flops=None, rel_each=False, reuse=False,
                   tc=None):
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
                   bound_by=b_by, flops=flops, bf16_flops=0.0, bytes=bytes_moved,
                   **tc_fields(tc))
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
              library=dual_library if tab is None else None,
              tc=dual_apply_tc(amps, run_first=tab is not None and first))

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
                  library=high_library(E) if tab is None else None,
                  tc=high_apply_tc(amps, X))

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
              library=gram_library, normalize=True, tc=gram_tc(amps, view[1]))

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
               library=dual_seed_library(el, em), tc=dual_apply_tc(amps))
    E = unitary(128)
    check_many("high_apply", "X128_seed", (g2[0], 128, g2[2], 128), 4, 2,
               seed(high_apply, *E), seed(high_apply_plain, *E), HIGH_TOL,
               flops=amps * 128 * 8, bytes_moved=3 * state_bytes, intact=2,
               library=seed_library(E), tc=[tc_product(amps * 128, False, "float32")])

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
                   library=dual_bwd_library(**kw), tc=adjoint_tc(amps * 256))

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
                       library=high_bwd_library(E, Einv) if tag == "plain" else None,
                       tc=adjoint_tc(amps * 128))

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
          flops=amps29 * 2 * 128 * 8, bytes_moved=2 * state29 + table_bytes(A29),
          tc=dual_apply_tc(amps29, run_first=True))
    g2_29 = pl._high_view(N29, 2)   # (32768, 128, 128): the group-2 sweep
    E = unitary(128)
    check("high_apply", "29q_X128_plain", (g2_29[0], 128, g2_29[2], 128),
          high_apply, high_apply_plain, (*E, None, True), HIGH_TOL,
          flops=amps29 * 128 * 8, bytes_moved=2 * state29, library=high_library(E),
          tc=[tc_product(amps29 * 128, False, "float32")])
    for variant, view in (("29q_lane", (A29 * 128, 128, 1)),
                          ("29q_sublane", (A29, 128, 128)),
                          ("29q_high_g2", (g2_29[0], 128, g2_29[2] * 128))):
        check("gram", variant, view, gram, gram_plain, (), GRAM_TOL,
              flops=amps29 * (2 * view[1] + 1) * 2, bytes_moved=state29,
              library=gram_library, normalize=True, tc=gram_tc(amps29, view[1]))
    check_many("dual_apply", "29q_seed", (A29, 128, 128), 4, 2,
               seed(dual_apply, *el29, *em29), seed(dual_apply_plain, *el29, *em29),
               DUAL_TOL, flops=amps29 * 2 * 128 * 8,
               bytes_moved=3 * state29, intact=2,
               library=dual_seed_library(el29, em29), tc=dual_apply_tc(amps29))
    check_many("high_apply", "29q_X128_seed", (g2_29[0], 128, g2_29[2], 128), 4, 2,
               seed(high_apply, *E), seed(high_apply_plain, *E), HIGH_TOL,
               flops=amps29 * 128 * 8, bytes_moved=3 * state29, intact=2,
               library=seed_library(E), tc=[tc_product(amps29 * 128, False, "float32")])
    kw = dict(g0_first=True, diag_first_fwd=True, diag_inv_tables=tables(A29),
              diag_tables=tables(A29))
    check_many("block_backward_dual", "29q_g0_first_diag_first", (A29, 128, 128),
               4, 4, dual_bwd(block_backward_dual, **kw),
               dual_bwd(block_backward_dual_plain, **kw), DUAL_TOL,
               flops=amps29 * 768 * 8,
               bytes_moved=4 * state29 + 2 * table_bytes(A29),
               library=dual_bwd_library(**kw), tc=adjoint_tc(amps29 * 256))
    E, Einv = unitary(128), unitary(128)
    check_many("block_backward_high", "29q_X128_plain",
               (g2_29[0], 128, g2_29[2], 128), 4, 4,
               lambda *p: block_backward_high(*p, *Einv, *E),
               lambda *p: block_backward_high_plain(*p, *Einv, *E), HIGH_TOL,
               flops=amps29 * 3 * 128 * 8, bytes_moved=4 * state29,
               library=high_bwd_library(E, Einv), tc=adjoint_tc(amps29 * 128))

    # the merged top axis: (1, Xt 128, M, 128) at 2^29 amplitudes, Xt = 2 as
    # at 29 qubits and Xt = 4 as at 30 (its M cut to half, so that the plain
    # versions fit beside the kernel's planes)
    merged_shapes = ((2, (1, 256, 1 << 14, 128)), (4, (1, 512, 1 << 13, 128)))

    def merged_tc(x_top, fdt="float32", bdt="float32", dot="f32", bwd="f32",
                  gram="f32"):
        """The merged adjoint's work at 2^29 amplitudes: its low factor on
        the tensor cores (adjoint_tc at X = 128), its top factor and T0_top
        (3 Xt complex multiply-adds per amplitude) on the CUDA cores."""
        return (adjoint_tc(amps29 * 128, fdt, bdt, dot, bwd, gram)
                + [cuda_core(amps29 * 3 * x_top * 8)])

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
              bytes_moved=2 * state29, library=merged_library(El, Et, x_top),
              tc=merged_apply_tc(amps29, x_top))
        Eli, Eti = unitary(128), unitary(x_top)
        ops = (*Eli, *El, *Eti, *Et)
        check_many("block_backward_merged_fact", f"Xt{x_top}", shape, 4, 4,
                   lambda *p, xt=x_top: block_backward_merged_fact(*p, *ops, x_top=xt),
                   lambda *p, xt=x_top: block_backward_merged_fact_plain(
                       *p, *ops, x_top=xt), HIGH_TOL,
                   flops=amps29 * 3 * (128 + x_top) * 8, bytes_moved=4 * state29,
                   library=merged_bwd_library(Eli, El, Eti, Et, x_top),
                   tc=merged_tc(x_top))
        check("gram", f"merged_X{X}", (1, X, shape[2] * 128), gram, gram_plain, (),
              GRAM_TOL, flops=amps29 * (2 * X + 1) * 2, bytes_moved=state29,
              library=gram_library, normalize=True, tc=gram_tc(amps29, X))
        E = unitary(X)
        check_many("high_apply", f"X{X}_seed", shape, 4, 2, seed(high_apply, *E),
                   seed(high_apply_plain, *E), HIGH_TOL, flops=amps29 * X * 8,
                   bytes_moved=3 * state29, intact=2, library=seed_library(E),
                   tc=[tc_product(amps29 * X, False, "float32")])

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
                  dense_flops=amps_n * 2 * 128 * T * 8, tc=multi_apply_tc(amps_n, T))
        kind, vshape, *ops = pl.cross_span_operands(cnot, (0, nq - 1), nq, dev)
        require(kind == "multi" and vshape == (1, 8, 1 << (nq - 10), 128),
                f"closing CNOT span view {kind} {vshape}")
        T = ops[0].shape[0]
        check("high_multi_apply", f"{nq}q_T{T}_cnot", vshape, high_multi_apply,
              high_multi_apply_plain, ops, HIGH_TOL,
              flops=amps_n * (macs(*ops[:2]) + macs(*ops[2:])) * 8,
              bytes_moved=2 * st, library=high_multi_library(ops),
              dense_flops=amps_n * (128 + 8) * T * 8, tc=high_multi_tc(amps_n, 8, T))
        E, Einv = unitary(128), unitary(128)
        check_many("block_backward_sublane", f"{nq}q", (a_n, 128, 128), 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_sublane(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_sublane_plain(
                       *p, *Einv, *E), DUAL_TOL,
                   flops=amps_n * 384 * 8, bytes_moved=4 * st,
                   library=sublane_library(E, Einv), tc=adjoint_tc(amps_n * 128))

    # the 29q path's high boundaries (13, 14), (20, 21), (27, 28): the high
    # apply and its adjoint on X = 8 span views
    cnot_inv = cnot.conj().T.copy()
    for pos in ((13, 14), (20, 21), (27, 28)):
        kind, vshape, er, ei = pl.cross_span_operands(cnot, pos, N29, dev)
        require(kind == "high" and vshape[1] == 8, f"span view {kind} {vshape}")
        check("high_apply", f"29q_X8_span{pos[0]}", vshape, high_apply,
              high_apply_plain, (er, ei, None, True), HIGH_TOL,
              flops=amps29 * macs(er, ei) * 8, bytes_moved=2 * state29,
              library=high_library((er, ei)), dense_flops=amps29 * 8 * 8,
              tc=high_apply_tc(amps29, 8))
        _, _, _, *bops = pl.backward_span_operands(cnot, cnot_inv, pos, N29, dev)
        check_many("block_backward_high", f"29q_X8_span{pos[0]}", vshape, 4, 4,
                   lambda *p, b=bops: block_backward_high(*p, *b),
                   lambda *p, b=bops: block_backward_high_plain(*p, *b), HIGH_TOL,
                   flops=amps29 * (macs(*bops[:2]) + macs(*bops[2:]) + 8) * 8,
                   bytes_moved=4 * state29,
                   library=high_bwd_library(bops[2:], bops[:2]),
                   dense_flops=amps29 * 3 * 8 * 8, tc=adjoint_tc(amps29 * 8))
        if pos == (13, 14):  # the launch [cnot29] runs: the default bf16x3 pair gram
            # (its inputs drawn apart, so that every later row sees the data
            # it saw before this row was added)
            gen_state = gen.get_state()
            check_many("block_backward_high", f"29q_X8_span{pos[0]}_gram_bf16x3", vshape,
                       4, 4, lambda *p, b=bops: block_backward_high(*p, *b, gram_mode="bf16x3"),
                       lambda *p, b=bops: block_backward_high_plain(*p, *b,
                                                                   gram_mode="bf16x3"),
                       HIGH_TOL, flops=amps29 * (macs(*bops[:2]) + macs(*bops[2:]) + 8) * 8,
                       bytes_moved=4 * state29, dense_flops=amps29 * 3 * 8 * 8,
                       tc=adjoint_tc(amps29 * 8, gram="bf16x3"))
            gen.set_state(gen_state)

    # the 29q cnot path's other sweeps: the dual pair without a run, group 3's
    # X = 128 sweep (view (2, 128, 16384, 128)) and their adjoints
    el29b, em29b = unitary(128), unitary(128)
    check("dual_apply", "29q_plain", (A29, 128, 128), dual_apply,
          dual_apply_plain, (*el29b, *em29b, None, True), DUAL_TOL,
          flops=amps29 * 2 * 128 * 8, bytes_moved=2 * state29,
          library=lambda xr, xi: dual_multi_library(
              [o[None] for o in (*el29b, *em29b)])(xr, xi), tc=dual_apply_tc(amps29))
    g3_29 = pl._high_view(N29, 3)
    E, Einv = unitary(128), unitary(128)
    check("high_apply", "29q_X128_g3", (g3_29[0], 128, g3_29[2], 128), high_apply,
          high_apply_plain, (*E, None, True), HIGH_TOL, flops=amps29 * 128 * 8,
          bytes_moved=2 * state29, library=high_library(E),
          tc=[tc_product(amps29 * 128, False, "float32")])
    check_many("block_backward_high", "29q_X128_g3", (g3_29[0], 128, g3_29[2], 128),
               4, 4, lambda *p: block_backward_high(*p, *Einv, *E),
               lambda *p: block_backward_high_plain(*p, *Einv, *E), HIGH_TOL,
               flops=amps29 * 3 * 128 * 8, bytes_moved=4 * state29,
               library=high_bwd_library(E, Einv), tc=adjoint_tc(amps29 * 128))
    check_many("block_backward_dual", "29q_g0_first", (A29, 128, 128), 4, 4,
               dual_bwd(block_backward_dual, g0_first=True),
               dual_bwd(block_backward_dual_plain, g0_first=True), DUAL_TOL,
               flops=amps29 * 768 * 8, bytes_moved=4 * state29,
               library=dual_bwd_library(), tc=adjoint_tc(amps29 * 256))

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
                       library=dual_bwd_library(**kw), rel_each=True,
                       tc=adjoint_tc(amps_n * 256))
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
                       dense_flops=amps_n * 2 * 128 * 4 * 8, tc=multi_apply_tc(amps_n, 4))
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
                       dense_flops=amps_n * (128 + 8) * 4 * 8,
                       tc=high_multi_tc(amps_n, 8, 4))
    M = hermitian4()
    for pos in ((13, 14), (20, 21), (27, 28)):
        kind, vshape, er, ei = pl.cross_span_operands(M.conj(), pos, N29, dev)
        require(kind == "high" and vshape[1] == 8, f"seed span view {kind} {vshape}")
        check_many("high_apply", f"29q_X8_span{pos[0]}_seed", vshape, 4, 2,
                   seed(high_apply, er, ei), seed(high_apply_plain, er, ei),
                   HIGH_TOL, flops=amps29 * macs(er, ei) * 8,
                   bytes_moved=3 * state29, intact=2,
                   library=seed_library((er, ei)), dense_flops=amps29 * 8 * 8,
                   tc=high_apply_tc(amps29, 8))

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
                   library=lane_library(E, Einv), tc=adjoint_tc(amps_n * 128))
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
                           rel_each=True, tc=adjoint_tc(amps_n * X))
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
              bytes_moved=2 * st, library=high_library(E),
              tc=[tc_product(amps_n * X, False, "float32")])
        E, Einv = unitary(X), unitary(X)
        check_many("block_backward_high", f"{nq}q_X{X}_wide", shape, 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_high(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_high_plain(
                       *p, *Einv, *E), HIGH_TOL, flops=amps_n * 3 * X * 8,
                   bytes_moved=4 * st, library=high_bwd_library(E, Einv),
                   reuse=nq == N30,
                   # the cross-Gram B F^T, then the two in-place updates
                   tc=[tc_product(amps_n * X, False, "float32", "float32"),
                       tc_product(2 * amps_n * X, False, "float32")])
        del E, Einv
        torch.cuda.empty_cache()

    # 3g. reduced cotangent storage and bf16x3 --------------------------------
    # the six kernels that meet a reduced plane or a bf16x3 dot on the cz
    # path under "mixed" (bf16 cotangent planes) and "f16", at the 29q path's
    # shapes (the X = 512 seed and the Xt = 4 merged adjoint at 30q's): the
    # forward planes F stay f32, the cotangent planes B are stored reduced,
    # the transports and pair grams run bf16x3 (the "auto" modes under those
    # storages), the uncomputes f32; and under f32 storage the pair grams
    # alone in bf16x3, the new default. Decoded B within STORE_ULPS ulps of
    # the storage, grams and Q within _storage.gram_tolerance of their
    # largest entry. The bound counts the bytes the reduced planes move (2
    # per element of B) and bf16x3's three bf16 products per real
    # multiply-add at the bf16 rate.
    from dqc_tpu_torch.ops.kernels import _storage as stc

    STORES = {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32}

    def check_reduced(kernel, variant, shape, n_f, n_b, n_f_out, n_b_out,
                      fn_kernel, fn_plain, dtype, f32_flops, bf16_flops,
                      bytes_moved, b_scale=0.5, g_tol=None, ulps=STORE_ULPS,
                      tc=None):
        """Inputs: n_f f32 planes, then n_b planes stored as ``dtype``;
        outputs: n_f_out f32 planes, n_b_out planes of ``dtype``, then grams
        or Q reductions. The kernel runs on the inputs themselves after the
        plain version (the times then run on its outputs, of the same
        shapes and scale). f32 cotangent planes are held to HIGH_TOL abs.
        plain_ms is the one plain call that makes the reference outputs."""
        ins = [randn(*shape) for _ in range(n_f)]
        ins += [stc.store_as(b_scale * randn(*shape), dtype) for _ in range(n_b)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fn_plain(*ins)
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        got = fn_kernel(*ins)
        torch.cuda.synchronize()
        f_err = max(((g - w).abs().max().item()
                     for g, w in zip(got[:n_f_out], want[:n_f_out])), default=0.0)
        b_ulps = (stc.ulps_apart(got[n_f_out:n_f_out + 2],
                                 want[n_f_out:n_f_out + 2], dtype)
                  if n_b_out else 0.0)
        b_err = max(((g.float() - w.float()).abs().max().item()
                     for g, w in zip(got[n_f_out:n_f_out + n_b_out],
                                     want[n_f_out:n_f_out + n_b_out])), default=0.0)
        g_rel = max(((g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                     for g, w in zip(got[n_f_out + n_b_out:],
                                     want[n_f_out + n_b_out:])), default=0.0)
        dtypes_ok = all(g.dtype == dtype for g in got[n_f_out:n_f_out + n_b_out])
        del got, want
        g_tol = g_tol or stc.gram_tolerance(dtype)
        if dtype == torch.float32:
            f_err, b_ulps = max(f_err, b_err), 0.0
        require(dtypes_ok, f"{kernel}[{variant}] did not keep the {dtype} storage")
        require(f_err <= HIGH_TOL and b_ulps <= ulps and g_rel <= g_tol,
                f"{kernel}[{variant}] disagrees with its plain version: f32 "
                f"planes {f_err:.3e} (tol {HIGH_TOL:.0e}), {dtype} planes "
                f"{b_ulps:.2f} ulps (tol {ulps}), grams {g_rel:.3e} "
                f"relative (tol {g_tol:.1e})")
        ms = cuda_ms(lambda: fn_kernel(*ins), reps=5)
        b_ms, b_by = bound_ms(bytes_moved, f32_flops, bf16_flops)
        row = dict(kernel=kernel, variant=variant, shape=list(shape),
                   storage=str(dtype).split(".")[-1], max_abs_err=max(f_err, b_err),
                   store_ulps=b_ulps, gram_rel_err=g_rel, tol=HIGH_TOL, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, flops=f32_flops, bf16_flops=bf16_flops,
                   bytes=bytes_moved, **tc_fields(tc))
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del ins
        torch.cuda.empty_cache()

    def cmac_flops(cmacs: float, x3: bool):
        """(f32 flops, bf16 flops) of ``cmacs`` complex multiply-adds per
        amplitude of the 29q planes in a dot mode: 8 f32 flops each, or
        in bf16x3 4 real products of three bf16 products each."""
        return (0.0, amps29 * cmacs * 4 * 3 * 2) if x3 else (amps29 * cmacs * 8, 0.0)

    def b_bytes(dtype) -> float:
        return 2 * amps29 * (4 if dtype == torch.float32 else 2)

    x3_modes = dict(bwd_mode="bf16x3", gram_mode="bf16x3")
    gram_x3 = dict(gram_mode="bf16x3")

    # 1-2. the seeds: acc + conj(E x) into the cotangent planes (acc), or
    # fresh planes of the storage (the first seed; at n >= 22 the merged
    # top's, at X = 256 / 512)
    for store in ("f16", "bf16"):
        dt = STORES[store]
        check_reduced("dual_apply", f"29q_seed_{store}", (A29, 128, 128), 2, 2, 0, 2,
                      lambda xr, xi, ar, ai: dual_apply(
                          xr, xi, *el29, *em29, conj=True, acc=(ar, ai), alias=False),
                      lambda xr, xi, ar, ai: dual_apply_plain(
                          xr, xi, *el29, *em29, conj=True, acc=(ar, ai)),
                      dt, amps29 * 2 * 128 * 8, 0.0, state29 + 2 * b_bytes(dt),
                      tc=dual_apply_tc(amps29))
        E = unitary(128)
        check_reduced("high_apply", f"29q_X128_seed_{store}",
                      (g2_29[0], 128, g2_29[2], 128), 2, 2, 0, 2,
                      lambda xr, xi, ar, ai, E=E: high_apply(
                          xr, xi, *E, conj=True, acc=(ar, ai), alias=False),
                      lambda xr, xi, ar, ai, E=E: high_apply_plain(
                          xr, xi, *E, conj=True, acc=(ar, ai)),
                      dt, amps29 * 128 * 8, 0.0, state29 + 2 * b_bytes(dt),
                      tc=[tc_product(amps29 * 128, False, "float32")])
    check_reduced("dual_apply", "29q_seed_fresh_f16", (A29, 128, 128), 2, 0, 0, 2,
                  lambda xr, xi: dual_apply(xr, xi, *el29, *em29, conj=True,
                                            alias=False, out_dtype=torch.float16),
                  lambda xr, xi: dual_apply_plain(xr, xi, *el29, *em29, conj=True,
                                                  out_dtype=torch.float16),
                  torch.float16, amps29 * 2 * 128 * 8, 0.0,
                  state29 + b_bytes(torch.float16), tc=dual_apply_tc(amps29))
    for nq, X, stores in ((N29, 256, ("f16", "bf16")), (N30, 512, ("f16",))):
        amps_n = float(1 << nq)
        shape = (1, X, (1 << nq) // (X * 128), 128)
        E = unitary(X)
        for store in stores:
            dt = STORES[store]
            check_reduced("high_apply", f"{nq}q_X{X}_seed_fresh_{store}", shape, 2, 0,
                          0, 2, lambda xr, xi, E=E, dt=dt: high_apply(
                              xr, xi, *E, conj=True, alias=False, out_dtype=dt),
                          lambda xr, xi, E=E, dt=dt: high_apply_plain(
                              xr, xi, *E, conj=True, out_dtype=dt),
                          dt, amps_n * X * 8, 0.0,
                          2 * amps_n * 4 + 2 * amps_n * 2,
                          tc=[tc_product(amps_n * X, False, "float32")])
        del E
        torch.cuda.empty_cache()

    # 3. block_backward_dual: the rotated body's ddual (the ring's run met
    # after the pair), and with a variable run's Q (met first)
    e0inv29, e029, e1inv29, e129 = (unitary(128) for _ in range(4))
    ops29 = (*e0inv29, *e029, *e1inv29, *e129)
    for store, modes, variant in (
            ("f16", x3_modes, "29q_f16_g0_first_diag_first"),
            ("bf16", x3_modes, "29q_bf16_g0_first_diag_first"),
            ("f32", gram_x3, "29q_gram_bf16x3_g0_first_diag_first"),
            ("f16", dict(x3_modes, diag_q=True, diag_first_fwd=False),
             "29q_f16_g0_first_diag_after_q")):
        dt = STORES[store]
        kw = dict(g0_first=True, diag_first_fwd=True, diag_inv_tables=tables(A29),
                  diag_tables=tables(A29))
        kw.update(modes)
        x3 = kw.get("bwd_mode") == "bf16x3"
        f_un, _ = cmac_flops(256, False)
        f_tr, b_tr = cmac_flops(256, x3)
        f_gr, b_gr = cmac_flops(256, True)
        # B passes up to three stores here (between the steps and beside
        # the run, as the TPU kernel stages it): one ulp more
        check_reduced("block_backward_dual", variant, (A29, 128, 128), 2, 2, 2, 2,
                      lambda *p, kw=kw: block_backward_dual(*p, *ops29, **kw),
                      lambda *p, kw=kw: block_backward_dual_plain(*p, *ops29, **kw),
                      dt, f_un + f_tr + f_gr, b_tr + b_gr,
                      state29 * 2 + b_bytes(dt) * 2 + 2 * table_bytes(A29),
                      ulps=STORE_ULPS + 1,
                      tc=adjoint_tc(amps29 * 256, "float32", dt,
                                    bwd=kw.get("bwd_mode", "f32"),
                                    gram=kw.get("gram_mode", "f32")))
    del ops29

    # 4. block_backward_high on the 29q group-2 view, and with a run's Q
    E, Einv = unitary(128), unitary(128)
    view = (g2_29[0], 128, g2_29[2], 128)
    a_rows = g2_29[0] * 128 * g2_29[2] // 128
    for store, modes, variant in (
            ("f16", x3_modes, "29q_X128_f16"), ("bf16", x3_modes, "29q_X128_bf16"),
            ("f32", gram_x3, "29q_X128_gram_bf16x3"),
            ("f16", dict(x3_modes, diag_q=True, diag_first_fwd=True,
                         diag_inv_tables=tables(a_rows), diag_tables=tables(a_rows)),
             "29q_X128_f16_diag_first_q")):
        dt = STORES[store]
        x3 = modes.get("bwd_mode") == "bf16x3"
        f_tr, b_tr = cmac_flops(128, x3)
        f_gr, b_gr = cmac_flops(128, True)
        check_reduced("block_backward_high", variant, view, 2, 2, 2, 2,
                      lambda *p, kw=modes: block_backward_high(*p, *Einv, *E, **kw),
                      lambda *p, kw=modes: block_backward_high_plain(*p, *Einv, *E, **kw),
                      dt, amps29 * 128 * 8 + f_tr + f_gr, b_tr + b_gr,
                      state29 * 2 + b_bytes(dt) * 2,
                      tc=adjoint_tc(amps29 * 128, "float32", dt,
                                    bwd=modes.get("bwd_mode", "f32"),
                                    gram=modes.get("gram_mode", "f32")))
    # the wide adjoint (X = 256, a lone top-group block) takes the bf16x3
    # pair gram under f32 storage
    shape256 = (1, 256, 1 << 14, 128)
    E, Einv = unitary(256), unitary(256)
    check_reduced("block_backward_high", "29q_X256_wide_gram_bf16x3", shape256,
                  2, 2, 2, 2,
                  lambda *p: block_backward_high(*p, *Einv, *E, **gram_x3),
                  lambda *p: block_backward_high_plain(*p, *Einv, *E, **gram_x3),
                  torch.float32, amps29 * 2 * 256 * 8, amps29 * 256 * 24,
                  4 * state29, g_tol=4e-5,  # G = B F^T split, not B (Einv F)
                  tc=[tc_product(amps29 * 256, True, "float32", "float32"),
                      tc_product(2 * amps29 * 256, False, "float32")])
    del E, Einv

    # 5. block_backward_merged_fact (Xt = 2 at 29q, Xt = 4 on the 30q merged
    # axis with its M halved)
    for x_top, shape in merged_shapes:
        Eli, El = unitary(128), unitary(128)
        Eti, Et = unitary(x_top), unitary(x_top)
        mops = (*Eli, *El, *Eti, *Et)
        cases = ((("f16", x3_modes), ("bf16", x3_modes), ("f32", gram_x3))
                 if x_top == 2 else (("f16", x3_modes),))
        for store, modes in cases:
            dt = STORES[store]
            x3 = modes.get("bwd_mode") == "bf16x3"
            f_tr, b_tr = cmac_flops(128, x3)
            f_gr, b_gr = cmac_flops(128, True)
            tag = store if store != "f32" else "gram_bf16x3"
            check_reduced("block_backward_merged_fact", f"Xt{x_top}_{tag}", shape,
                          2, 2, 2, 2,
                          lambda *p, kw=modes, xt=x_top: block_backward_merged_fact(
                              *p, *mops, x_top=xt, **kw),
                          lambda *p, kw=modes, xt=x_top: block_backward_merged_fact_plain(
                              *p, *mops, x_top=xt, **kw),
                          dt, amps29 * (128 + 3 * x_top) * 8 + f_tr + f_gr,
                          b_tr + b_gr, state29 * 2 + b_bytes(dt) * 2,
                          tc=merged_tc(x_top, "float32", dt, "f32",
                                       modes.get("bwd_mode", "f32"), "bf16x3"))
        del mops
        torch.cuda.empty_cache()

    # 6. diag_backward: elementwise, B decoded and encoded (with Q: its
    # outputs written once too)
    tab, tab_inv = tables(A29), tables(A29)
    q_bytes = 2 * 4 * (128 * 128 + 2 * A29 * 128)
    for store, with_q in (("f16", False), ("bf16", False), ("f16", True)):
        dt = STORES[store]
        check_reduced("diag_backward", f"29q_{store}" + ("_q" if with_q else ""),
                      (A29, 128, 128), 2, 2, 2, 2,
                      lambda *p, q=with_q: diag_backward(*p, *tab_inv, *tab, with_q=q),
                      lambda *p, q=with_q: diag_backward_plain(*p, *tab_inv, *tab,
                                                               with_q=q),
                      dt, amps29 * (36 + (12 if with_q else 0)), 0.0,
                      state29 * 2 + b_bytes(dt) * 2 + 2 * table_bytes(A29)
                      + (q_bytes if with_q else 0))
    del tab, tab_inv

    # the lane and sublane adjoints' bf16x3 pair grams (f32 storage, the
    # default modes of the CNOT ring and the plane tape)
    for name, fn, fn_plain in (
            ("block_backward_sublane", block_backward_sublane, block_backward_sublane_plain),
            ("block_backward_lane", K.block_backward_lane, K.PLAIN.block_backward_lane)):
        E, Einv = unitary(128), unitary(128)
        check_reduced(name, "29q_gram_bf16x3", (A29, 128, 128), 2, 2, 2, 2,
                      lambda *p, fn=fn: fn(*p, *Einv, *E, **gram_x3),
                      lambda *p, fn=fn_plain: fn(*p, *Einv, *E, **gram_x3),
                      torch.float32, amps29 * 2 * 128 * 8, amps29 * 128 * 24,
                      4 * state29, tc=adjoint_tc(amps29 * 128, gram="bf16x3"))
    torch.cuda.empty_cache()

    # 3h. reduced cotangent storage on the other plane paths ----------------
    # the kernels that take a reduced cotangent on the CNOT ring, VQE, QAOA,
    # the plane tape and the expanded merged top, at the 29q path's shapes
    # (the X = 512 adjoint at 30q's), in f16 and bf16 storage: the multi-term
    # applies in place on the cotangent (the ring's G^T transports) and as
    # seeds from the f32 forward planes (acc and fresh), on the ring's CNOT
    # terms (T = 2) and an edge density's seed terms (T = 4; the random
    # unitary's T = 4 in place); the lane and sublane adjoints and the
    # X = 256 / 512 adjoint with bf16x3 transport and grams (the "auto" modes
    # under reduced storage) and, in f16, with an f32 transport beside them;
    # the X = 8 span seed into f16 planes. Bounds as in 3g: 2 bytes per
    # element of a 16-bit plane; the multi-term applies' operations from
    # their factors' nonzeros, as their f32 rows.
    log_time("3h")
    M4 = hermitian4()
    for store in ("f16", "bf16"):
        dt = STORES[store]
        for tag, gate in (("T2_cnot", cnot), ("T4_unitary", rand_gate)):
            kind, *ops = pl.cross_terms_operands(
                ps._dense_cross_expanded_terms(gate, (6, 7), N29), N29, dev)
            flops = amps29 * (macs(*ops[:2]) + macs(*ops[2:])) * 8
            check_reduced("dual_multi_apply", f"29q_{tag}_{store}", (A29, 128, 128),
                          0, 2, 0, 2,
                          lambda br, bi, o=ops: dual_multi_apply(br, bi, *o),
                          lambda br, bi, o=ops: dual_multi_apply_plain(br, bi, *o),
                          dt, flops, 0.0, 2 * b_bytes(dt),
                          tc=multi_apply_tc(amps29, ops[0].shape[0], dt))
        kind, *ops = pl.cross_terms_operands(
            ps._dense_cross_expanded_terms(M4.conj(), (6, 7), N29), N29, dev)
        flops = amps29 * (macs(*ops[:2]) + macs(*ops[2:])) * 8
        check_reduced("dual_multi_apply", f"29q_seed_T4_acc_{store}", (A29, 128, 128),
                      2, 2, 0, 2,
                      lambda xr, xi, ar, ai, o=ops: dual_multi_apply(
                          xr, xi, *o, conj=True, acc=(ar, ai), alias=False),
                      lambda xr, xi, ar, ai, o=ops: dual_multi_apply_plain(
                          xr, xi, *o, conj=True, acc=(ar, ai)),
                      dt, flops, 0.0, state29 + 2 * b_bytes(dt),
                      tc=multi_apply_tc(amps29, 4))
        check_reduced("dual_multi_apply", f"29q_seed_T4_fresh_{store}",
                      (A29, 128, 128), 2, 0, 0, 2,
                      lambda xr, xi, o=ops, dt=dt: dual_multi_apply(
                          xr, xi, *o, conj=True, alias=False, out_dtype=dt),
                      lambda xr, xi, o=ops, dt=dt: dual_multi_apply_plain(
                          xr, xi, *o, conj=True, out_dtype=dt),
                      dt, flops, 0.0, state29 + b_bytes(dt),
                      tc=multi_apply_tc(amps29, 4))
        kind, vshape, *ops = pl.cross_span_operands(cnot, (0, N29 - 1), N29, dev)
        check_reduced("high_multi_apply", f"29q_T2_cnot_{store}", vshape, 0, 2, 0, 2,
                      lambda br, bi, o=ops: high_multi_apply(br, bi, *o),
                      lambda br, bi, o=ops: high_multi_apply_plain(br, bi, *o),
                      dt, amps29 * (macs(*ops[:2]) + macs(*ops[2:])) * 8, 0.0,
                      2 * b_bytes(dt), tc=high_multi_tc(amps29, 8, 2, dt))
        kind, vshape, *ops = pl.cross_span_operands(M4.conj(), (0, N29 - 1), N29, dev)
        flops = amps29 * (macs(*ops[:2]) + macs(*ops[2:])) * 8
        check_reduced("high_multi_apply", f"29q_seed_T4_acc_{store}", vshape, 2, 2, 0, 2,
                      lambda xr, xi, ar, ai, o=ops: high_multi_apply(
                          xr, xi, *o, conj=True, acc=(ar, ai), alias=False),
                      lambda xr, xi, ar, ai, o=ops: high_multi_apply_plain(
                          xr, xi, *o, conj=True, acc=(ar, ai)),
                      dt, flops, 0.0, state29 + 2 * b_bytes(dt),
                      tc=high_multi_tc(amps29, 8, 4))
        check_reduced("high_multi_apply", f"29q_seed_T4_fresh_{store}", vshape,
                      2, 0, 0, 2,
                      lambda xr, xi, o=ops, dt=dt: high_multi_apply(
                          xr, xi, *o, conj=True, alias=False, out_dtype=dt),
                      lambda xr, xi, o=ops, dt=dt: high_multi_apply_plain(
                          xr, xi, *o, conj=True, out_dtype=dt),
                      dt, flops, 0.0, state29 + b_bytes(dt),
                      tc=high_multi_tc(amps29, 8, 4))
        del ops
        torch.cuda.empty_cache()
    # the X = 8 span seed into f16 planes (the seed of a density across the
    # sublane group and group 2, in every VQE and QAOA step)
    kind, vshape, er, ei = pl.cross_span_operands(M4.conj(), (13, 14), N29, dev)
    check_reduced("high_apply", "29q_X8_span13_seed_f16", vshape, 2, 2, 0, 2,
                  lambda xr, xi, ar, ai: high_apply(xr, xi, er, ei, conj=True,
                                                    acc=(ar, ai), alias=False),
                  lambda xr, xi, ar, ai: high_apply_plain(xr, xi, er, ei, conj=True,
                                                          acc=(ar, ai)),
                  torch.float16, amps29 * macs(er, ei) * 8, 0.0,
                  state29 + 2 * b_bytes(torch.float16), tc=high_apply_tc(amps29, 8))
    # the unpaired sublane and lane adjoints
    f32_bwd = dict(bwd_mode="f32", gram_mode="bf16x3")
    for name, fn, fn_plain in (
            ("block_backward_sublane", block_backward_sublane, block_backward_sublane_plain),
            ("block_backward_lane", K.block_backward_lane, K.PLAIN.block_backward_lane)):
        E, Einv = unitary(128), unitary(128)
        for store, modes, tag in (("f16", x3_modes, "f16"), ("bf16", x3_modes, "bf16"),
                                  ("f16", f32_bwd, "f16_f32_transport")):
            dt = STORES[store]
            x3 = modes["bwd_mode"] == "bf16x3"
            f_un, _ = cmac_flops(128, False)
            f_tr, b_tr = cmac_flops(128, x3)
            f_gr, b_gr = cmac_flops(128, True)
            check_reduced(name, f"29q_{tag}", (A29, 128, 128), 2, 2, 2, 2,
                          lambda *p, fn=fn, kw=modes: fn(*p, *Einv, *E, **kw),
                          lambda *p, fn=fn_plain, kw=modes: fn(*p, *Einv, *E, **kw),
                          dt, f_un + f_tr + f_gr, b_tr + b_gr,
                          state29 * 2 + b_bytes(dt) * 2,
                          tc=adjoint_tc(amps29 * 128, "float32", dt,
                                        bwd=modes["bwd_mode"],
                                        gram=modes["gram_mode"]))
    # the X = 256 (29q) / 512 (30q) adjoint on the merged top axis: the
    # cross-Gram reads B stored reduced, the transport is the wide apply in
    # place on it; the pair gram as G = B F^T is held at 4e-5 (3g)
    for nq, X, cases in ((N29, 256, (("f16", x3_modes, "f16"), ("bf16", x3_modes, "bf16"),
                                     ("f16", f32_bwd, "f16_f32_transport"))),
                         (N30, 512, (("f16", x3_modes, "f16"),))):
        amps_n = float(1 << nq)
        shape = (1, X, (1 << nq) // (X * 128), 128)
        E, Einv = unitary(X), unitary(X)
        torch.cuda.empty_cache()
        for store, modes, tag in cases:
            dt = STORES[store]
            x3 = modes["bwd_mode"] == "bf16x3"
            f32_fl = amps_n * X * 8 * (1 if x3 else 2)
            bf16_fl = amps_n * X * 24 * (2 if x3 else 1)
            check_reduced("block_backward_high", f"{nq}q_X{X}_wide_{tag}", shape,
                          2, 2, 2, 2,
                          lambda *p, kw=modes: block_backward_high(*p, *Einv, *E, **kw),
                          lambda *p, kw=modes: block_backward_high_plain(
                              *p, *Einv, *E, **kw),
                          dt, f32_fl, bf16_fl, 2 * 2 * amps_n * 4 + 2 * 2 * amps_n * 2,
                          g_tol=4e-5,
                          # the cross-Gram (bf16x3), the uncompute on F, the
                          # transport on B
                          tc=[tc_product(amps_n * X, True, dt, "float32"),
                              tc_product(amps_n * X, False, "float32"),
                              tc_product(amps_n * X, x3, dt)])
        del E, Einv
        torch.cuda.empty_cache()

    # 3i. "bf16" forward storage and the forward bf16x3 --------------------
    # the nine kernels of the cz path at the 29q path's shapes (the X = 512
    # seed at 30q's; Xt = 4 on the 29q-amplitude merged view as in 3b), in
    # three settings: "bf16" (F stored bf16, and B under "bf16" storage; the
    # forward products f32, the backward's transports and grams in bf16x3 as
    # "auto" resolves them there), "x3" (f32 planes, every product bf16x3:
    # "auto" under f32 storage follows the forward mode) and "bf16x3" on
    # bf16 planes. Decoded bf16 planes within FWD16_ULPS storage ulps of the
    # plain version (the dual adjoint, which stages F and B through its
    # planes: one more), f32 planes within HIGH_TOL, grams within
    # _storage.gram_tolerance(bf16) of their largest entry on bf16 planes
    # and X3_GRAM_TOL on f32 planes. The bf16 rows' library time: the f32
    # rows' PyTorch calls (for the fresh merged-top seeds the product and its
    # conjugate) on the decoded planes, their plane results stored back as
    # bf16; bf16x3 rows have none (no PyTorch call computes that split). The
    # bound counts 2 bytes per element of a bf16 plane and bf16x3's three
    # bf16 products per real multiply-add at the bf16 rate. Then row 12f
    # again: the factorized merged-top adjoint under "f16" / "mixed" with the
    # f32 transport ops/planes hands it.
    log_time("3i")
    BF16 = torch.bfloat16
    FWD16 = {"bf16": (BF16, "f32"), "x3": (torch.float32, "bf16x3"),
             "bf16x3": (BF16, "bf16x3")}

    def plane_bytes(dt) -> float:
        return 2 * amps29 * (4 if dt == torch.float32 else 2)

    def bf16_library(make):
        """The f32 row's PyTorch calls on the decoded planes, their plane
        results stored back as bf16."""
        def wrapped(*planes):
            def run():
                out = make(*(p.float() for p in planes))()
                outs = out if isinstance(out, (list, tuple)) else (out,)
                return [(o.real.to(BF16), o.imag.to(BF16)) if o.dim() >= 3 else o
                        for o in outs]
            return run
        return wrapped

    def check_fwd16(kernel, variant, shape, ins, fn_kernel, fn_plain, n_planes,
                    f32_flops, bf16_flops, bytes_moved, library=None, ulps=FWD16_ULPS,
                    reuse=True, phase=None, tc=None):
        """``ins``: (dtype, scale) of each input plane; outputs: ``n_planes``
        plane pairs, then reductions. bf16x3 on bf16 planes: one ulp more
        (the kernel and its plain version sum the same products in two
        orders before the bf16 store). Planes stored bf16 or f16 are held
        in ulps of their storage. ``phase`` tags the row with the phase
        that checked it."""
        if variant.endswith("_bf16x3"):
            ulps += 1
        xs = [stc.store_as(s * randn(*shape), dt) for dt, s in ins]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fn_plain(*xs)
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        got = fn_kernel(*(xs if reuse else [x.clone() for x in xs]))
        torch.cuda.synchronize()
        worst_ulps, f_err, g_rel, bf = 0.0, 0.0, 0.0, False
        for k in range(n_planes):
            g2, w2 = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2]
            require(g2[0].dtype == w2[0].dtype, f"{kernel}[{variant}] output dtype "
                                                f"{g2[0].dtype}, want {w2[0].dtype}")
            if g2[0].dtype in (BF16, torch.float16):
                bf = True
                worst_ulps = max(worst_ulps, stc.ulps_apart(g2, w2, g2[0].dtype))
            else:
                f_err = max(f_err, max((a - b).abs().max().item() for a, b in zip(g2, w2)))
        for g_, w_ in zip(got[2 * n_planes:], want[2 * n_planes:]):
            g_rel = max(g_rel, (g_ - w_).abs().max().item()
                        / max(w_.abs().max().item(), 1e-30))
        del got, want
        red = [dt for dt, _ in ins if dt != torch.float32]
        bf_in = bool(red)
        g_tol = stc.gram_tolerance(red[0]) if bf_in else X3_GRAM_TOL
        require(worst_ulps <= ulps and f_err <= HIGH_TOL and g_rel <= g_tol,
                f"{kernel}[{variant}] disagrees with its plain version: bf16 planes "
                f"{worst_ulps:.2f} ulps (tol {ulps}), f32 planes {f_err:.3e} (tol "
                f"{HIGH_TOL:.0e}), reductions {g_rel:.3e} relative (tol {g_tol:.1e})")
        ms = cuda_ms(lambda: fn_kernel(*xs), reps=5)
        lib_ms = cuda_ms(library(*xs), reps=3) if library else None
        b_ms, b_by = bound_ms(bytes_moved, f32_flops, bf16_flops)
        row = dict(kernel=kernel, variant=variant, shape=list(shape),
                   storage=str(red[0]).split(".")[-1] if bf_in else "float32",
                   fwd=variant.split("_")[-1],
                   max_abs_err=f_err, store_ulps=worst_ulps, gram_rel_err=g_rel,
                   tol=HIGH_TOL, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, flops=f32_flops,
                   bf16_flops=bf16_flops, bytes=bytes_moved, **tc_fields(tc))
        if phase:
            row["phase"] = phase
        rows.append(row)
        log(f"[kernel] {json.dumps(row)}")
        del xs
        torch.cuda.empty_cache()

    def fresh_seed_library(E):
        """The fresh seed's yardstick: the product and its conjugate."""
        def make(xr, xi):
            A1, X, M, _ = xr.shape
            x = torch.complex(xr, xi).view(A1, X, M * 128)
            ec = torch.complex(*E)
            return lambda: torch.matmul(ec, x).conj()
        return make

    def fwd_flops(cmacs: float, dot: str, amps_n: float = None):
        return cmac_flops(cmacs * (amps_n or amps29) / amps29, dot == "bf16x3")

    tab29 = tables(A29)
    for tag, (fdt, dot) in FWD16.items():
        bdt = BF16 if fdt == BF16 else torch.float32
        lib = (lambda make: bf16_library(make)) if tag == "bf16" else (lambda make: None)
        f, b = cmac_flops(256, dot == "bf16x3")
        # 1. the dual sweep in place (the body's, the ring's run folded first)
        check_fwd16("dual_apply", f"29q_diag_first_{tag}", (A29, 128, 128),
                    [(fdt, 1.0)] * 2,
                    lambda xr, xi, d=dot: dual_apply(xr, xi, *el29, *em29, tab29, True,
                                                     dot_mode=d),
                    lambda xr, xi, d=dot: dual_apply_plain(xr, xi, *el29, *em29, tab29,
                                                           True, dot_mode=d),
                    1, f, b, 2 * plane_bytes(fdt) + table_bytes(A29),
                    lib(dual_library), tc=dual_apply_tc(amps29, fdt, dot, True))
        # 2. its seed from F into the cotangent planes (acc)
        check_fwd16("dual_apply", f"29q_seed_{tag}", (A29, 128, 128),
                    [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda xr, xi, ar, ai, d=dot: dual_apply(
                        xr, xi, *el29, *em29, conj=True, acc=(ar, ai), alias=False,
                        dot_mode=d),
                    lambda xr, xi, ar, ai, d=dot: dual_apply_plain(
                        xr, xi, *el29, *em29, conj=True, acc=(ar, ai), dot_mode=d),
                    1, f, b, plane_bytes(fdt) + 2 * plane_bytes(bdt),
                    lib(dual_seed_library(el29, em29)), reuse=False,
                    tc=dual_apply_tc(amps29, fdt, dot))
        # 3. the group-2 sweep in place and its seed (X = 128)
        E = unitary(128)
        view = (g2_29[0], 128, g2_29[2], 128)
        f, b = cmac_flops(128, dot == "bf16x3")
        check_fwd16("high_apply", f"29q_X128_{tag}", view, [(fdt, 1.0)] * 2,
                    lambda xr, xi, d=dot, E=E: high_apply(xr, xi, *E, dot_mode=d),
                    lambda xr, xi, d=dot, E=E: high_apply_plain(xr, xi, *E, dot_mode=d),
                    1, f, b, 2 * plane_bytes(fdt), lib(high_library(E)),
                    tc=[tc_product(amps29 * 128, dot == "bf16x3", fdt)])
        check_fwd16("high_apply", f"29q_X128_seed_{tag}", view,
                    [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda xr, xi, ar, ai, d=dot, E=E: high_apply(
                        xr, xi, *E, conj=True, acc=(ar, ai), alias=False, dot_mode=d),
                    lambda xr, xi, ar, ai, d=dot, E=E: high_apply_plain(
                        xr, xi, *E, conj=True, acc=(ar, ai), dot_mode=d),
                    1, f, b, plane_bytes(fdt) + 2 * plane_bytes(bdt),
                    lib(seed_library(E)), reuse=False,
                    tc=[tc_product(amps29 * 128, dot == "bf16x3", fdt)])
        # 4. the merged-top seed, fresh cotangent planes (X = 256 at 29q, 512
        # at 30q)
        for nq, X in ((N29, 256), (N30, 512)):
            if nq == N30 and tag != "bf16":
                continue
            amps_n = float(1 << nq)
            shape = (1, X, (1 << nq) // (X * 128), 128)
            Ew = unitary(X)
            f, b = fwd_flops(X, dot, amps_n)
            check_fwd16("high_apply", f"{nq}q_X{X}_seed_fresh_{tag}", shape,
                        [(fdt, 1.0)] * 2,
                        lambda xr, xi, d=dot, E=Ew, o=bdt: high_apply(
                            xr, xi, *E, conj=True, alias=False, out_dtype=o,
                            dot_mode=d),
                        lambda xr, xi, d=dot, E=Ew, o=bdt: high_apply_plain(
                            xr, xi, *E, conj=True, out_dtype=o, dot_mode=d),
                        1, f, b, 2 * amps_n * (2 if fdt == BF16 else 4) * 2,
                        lib(fresh_seed_library(Ew)),
                        tc=[tc_product(amps_n * X, dot == "bf16x3", fdt)])
            del Ew
            torch.cuda.empty_cache()
        # 5. the Grams of the epilogue (groups 0-2, the merged top two)
        for variant, gview in (("29q_lane", (A29 * 128, 128, 1)),
                               ("29q_sublane", (A29, 128, 128)),
                               ("29q_high_g2", (g2_29[0], 128, g2_29[2] * 128)),
                               ("merged_X256", (1, 256, (1 << 14) * 128)),
                               ("merged_X512", (1, 512, (1 << 13) * 128))):
            X = gview[1]
            flops = amps29 * (2 * X + 1) * 2
            # on bf16 planes the bf16x3 Gram is the f32 one (kernel and sums)
            fl = (0.0, flops * 3) if dot == "bf16x3" and fdt != BF16 else (flops, 0.0)
            check_fwd16("gram", f"{variant}_{tag}", gview, [(fdt, 2 ** -14.5)] * 2,
                        lambda xr, xi, d=dot: gram(xr, xi, dot_mode=d),
                        lambda xr, xi, d=dot: gram_plain(xr, xi, d),
                        0, *fl, plane_bytes(fdt), lib(gram_library),
                        tc=gram_tc(amps29, X, fdt, dot))
        # 6. the factorized merged sweep and its adjoint (the transport f32,
        # the pair grams bf16x3: the modes planes hands it)
        for x_top, shape in merged_shapes:
            El, Et, Eli, Eti = unitary(128), unitary(x_top), unitary(128), unitary(x_top)
            f, b = cmac_flops(128, dot == "bf16x3")
            check_fwd16("merged_fact_apply", f"Xt{x_top}_{tag}", shape, [(fdt, 1.0)] * 2,
                        lambda xr, xi, d=dot, xt=x_top, o=(*El, *Et): merged_fact_apply(
                            xr, xi, *o, x_top=xt, dot_mode=d),
                        lambda xr, xi, d=dot, xt=x_top, o=(*El, *Et): merged_fact_apply_plain(
                            xr, xi, *o, x_top=xt, dot_mode=d),
                        1, f + amps29 * x_top * 8, b, 2 * plane_bytes(fdt),
                        lib(merged_library(El, Et, x_top)),
                        tc=merged_apply_tc(amps29, x_top, dot))
            mops = (*Eli, *El, *Eti, *Et)
            f_un, b_un = cmac_flops(128, dot == "bf16x3")
            f_tr, _ = cmac_flops(128 + 3 * x_top, False)
            f_gr, b_gr = cmac_flops(128, True)
            kw = dict(x_top=x_top, dot_mode=dot, bwd_mode="f32", gram_mode="bf16x3")
            check_fwd16("block_backward_merged_fact", f"Xt{x_top}_{tag}", shape,
                        [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                        lambda *p, kw=kw, o=mops: block_backward_merged_fact(*p, *o, **kw),
                        lambda *p, kw=kw, o=mops: block_backward_merged_fact_plain(
                            *p, *o, **kw),
                        2, f_un + f_tr + f_gr, b_un + b_gr,
                        2 * plane_bytes(fdt) + 2 * plane_bytes(bdt),
                        lib(merged_bwd_library(Eli, El, Eti, Et, x_top)),
                        tc=merged_tc(x_top, fdt, bdt, dot, "f32", "bf16x3"))
            del mops
            torch.cuda.empty_cache()
        # 7. the dual and group-2 adjoints ("auto" transports and grams)
        x3 = dict(bwd_mode="bf16x3", gram_mode="bf16x3", dot_mode=dot)
        kw = dict(g0_first=True, diag_first_fwd=True, diag_inv_tables=tables(A29),
                  diag_tables=tables(A29), **x3)
        e0inv29, e029, e1inv29, e129 = (unitary(128) for _ in range(4))
        ops29 = (*e0inv29, *e029, *e1inv29, *e129)
        f_un, b_un = cmac_flops(256, dot == "bf16x3")
        f_x, b_x = cmac_flops(512, True)
        check_fwd16("block_backward_dual", f"29q_g0_first_diag_first_{tag}",
                    (A29, 128, 128), [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda *p, kw=kw, o=ops29: block_backward_dual(*p, *o, **kw),
                    lambda *p, kw=kw, o=ops29: block_backward_dual_plain(*p, *o, **kw),
                    2, f_un + f_x, b_un + b_x,
                    2 * plane_bytes(fdt) + 2 * plane_bytes(bdt) + 2 * table_bytes(A29),
                    lib(dual_bwd_library(**kw)), ulps=FWD16_ULPS + 1,
                    tc=adjoint_tc(amps29 * 256, fdt, bdt, dot, "bf16x3", "bf16x3"))
        del ops29
        E, Einv = unitary(128), unitary(128)
        f_un, b_un = cmac_flops(128, dot == "bf16x3")
        f_x, b_x = cmac_flops(256, True)
        check_fwd16("block_backward_high", f"29q_X128_{tag}", view,
                    [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high(*p, *Ei, *E, **kw),
                    lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high_plain(
                        *p, *Ei, *E, **kw),
                    2, f_un + f_x, b_un + b_x, 2 * plane_bytes(fdt) + 2 * plane_bytes(bdt),
                    lib(high_bwd_library(E, Einv)),
                    tc=adjoint_tc(amps29 * 128, fdt, bdt, dot, "bf16x3", "bf16x3"))
        # 8. the diagonal runs (no dot): once, on bf16 planes
        if tag == "bf16":
            tab_inv = tables(A29)
            check_fwd16("diag_sweep", "29q_bf16", (A29, 128, 128), [(BF16, 1.0)] * 2,
                        lambda xr, xi: diag_sweep(xr, xi, *tab29),
                        lambda xr, xi: diag_sweep_plain(xr, xi, *tab29),
                        1, amps29 * 18, 0.0, 2 * plane_bytes(BF16) + table_bytes(A29),
                        bf16_library(diag_library(tab29)))
            check_fwd16("diag_backward", "29q_bf16", (A29, 128, 128), [(BF16, 1.0)] * 4,
                        lambda *p: diag_backward(*p, *tab_inv, *tab29),
                        lambda *p: diag_backward_plain(*p, *tab_inv, *tab29),
                        2, amps29 * 36, 0.0, 4 * plane_bytes(BF16) + 2 * table_bytes(A29),
                        bf16_library(diag_library(tab_inv, tab29)))
            del tab_inv
        torch.cuda.empty_cache()
    del tab29
    # row 12f again: B stored f16 / bf16, F f32, the transport f32 and T0_low
    # bf16x3 (the "auto" grams), as ops/planes hands the kernel under "f16"
    # and "mixed" since this slice
    for x_top, shape in merged_shapes[:1]:
        Eli, El = unitary(128), unitary(128)
        Eti, Et = unitary(x_top), unitary(x_top)
        mops = (*Eli, *El, *Eti, *Et)
        clamp = dict(bwd_mode="f32", gram_mode="bf16x3")
        for store in ("f16", "bf16"):
            dt = STORES[store]
            f_tr, _ = cmac_flops(2 * 128 + 3 * x_top, False)
            f_gr, b_gr = cmac_flops(128, True)
            check_reduced("block_backward_merged_fact", f"Xt{x_top}_{store}_f32_transport",
                          shape, 2, 2, 2, 2,
                          lambda *p, o=mops, xt=x_top: block_backward_merged_fact(
                              *p, *o, x_top=xt, **clamp),
                          lambda *p, o=mops, xt=x_top: block_backward_merged_fact_plain(
                              *p, *o, x_top=xt, **clamp),
                          dt, f_tr + f_gr, b_gr, state29 * 2 + b_bytes(dt) * 2,
                          tc=merged_tc(x_top, "float32", dt, "f32", "f32", "bf16x3"))
        del mops
        torch.cuda.empty_cache()

    # 3j. "bf16" storage and the forward bf16x3 on the narrow high groups,
    # the CNOT ring's kernels and the expanded merged top -------------------
    # the new variants in the three settings of 3i, each against its plain
    # version: the high apply (in place with the ring's run folded first,
    # and its seed), the Gram and the high adjoint at X = 8..64 on views of
    # 2^29 amplitudes (1, X, 2^29 / (128 X), 128), the layout of group 3 at
    # n = 24-27 at the 29q amplitude count (X = 16 and 32 in "bf16" only:
    # the CPU tests hold every setting there); the in-place high apply and
    # the adjoint on the merged top axis, X = 256 (29q) and 512 (30q,
    # "bf16" only); the multi-term applies on the ring's own CNOT operators
    # (in place: the uncompute on F, the transport on B) and an edge
    # density's T = 4 seed from F; the sublane adjoint. Tolerances and
    # bounds as 3i's.
    log_time("3j")

    def small_x_view(X):
        return (1, X, (1 << N29) // (X * 128), 128)

    def high_run_library(E, tabs):
        """The in-place sweep with the ring's run first: the run's multiply
        and one matmul."""
        def make(xr, xi):
            A1, X, M, _ = xr.shape
            D = view_diag_run(tabs, xr.shape)
            x = torch.complex(xr, xi)
            Ec = torch.complex(*E)
            return lambda: torch.matmul(Ec, (x * D).view(A1, X, M * 128))
        return make

    for tag, (fdt, dot) in FWD16.items():
        bdt = BF16 if fdt == BF16 else torch.float32
        lib = (lambda make: bf16_library(make)) if tag == "bf16" else (lambda make: None)
        for X in (8, 16, 32, 64):
            if X in (16, 32) and tag != "bf16":
                continue
            view = small_x_view(X)
            a_rows = (1 << N29) // (128 * 128)
            tabs = tuple(t.view(1, X, view[2] // 128, 128) if k >= 2 else t
                         for k, t in enumerate(tables(a_rows)))
            E, Einv = unitary(X), unitary(X)
            f, b = cmac_flops(X, dot == "bf16x3")
            check_fwd16("high_apply", f"29q_X{X}_diag_first_{tag}", view,
                        [(fdt, 1.0)] * 2,
                        lambda xr, xi, d=dot, E=E, t=tabs: high_apply(
                            xr, xi, *E, t, True, dot_mode=d),
                        lambda xr, xi, d=dot, E=E, t=tabs: high_apply_plain(
                            xr, xi, *E, t, True, dot_mode=d),
                        1, f + amps29 * 18, b, 2 * plane_bytes(fdt) + table_bytes(a_rows),
                        lib(high_run_library(E, tabs)),
                        tc=high_apply_tc(amps29, X, fdt, dot, run_first=True))
            if X in (8, 64):
                check_fwd16("high_apply", f"29q_X{X}_seed_{tag}", view,
                            [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                            lambda xr, xi, ar, ai, d=dot, E=E: high_apply(
                                xr, xi, *E, conj=True, acc=(ar, ai), alias=False,
                                dot_mode=d),
                            lambda xr, xi, ar, ai, d=dot, E=E: high_apply_plain(
                                xr, xi, *E, conj=True, acc=(ar, ai), dot_mode=d),
                            1, f, b, plane_bytes(fdt) + 2 * plane_bytes(bdt),
                            lib(seed_library(E)), reuse=False,
                            tc=high_apply_tc(amps29, X, fdt, dot))
                gview = (1, X, view[2] * 128)
                flops = amps29 * (2 * X + 1) * 2
                fl = (0.0, flops * 3) if dot == "bf16x3" and fdt != BF16 else (flops, 0.0)
                check_fwd16("gram", f"29q_X{X}_{tag}", gview, [(fdt, 2 ** -14.5)] * 2,
                            lambda xr, xi, d=dot: gram(xr, xi, dot_mode=d),
                            lambda xr, xi, d=dot: gram_plain(xr, xi, d),
                            0, *fl, plane_bytes(fdt), lib(gram_library),
                            tc=gram_tc(amps29, X, fdt, dot))
            x3 = dict(bwd_mode="bf16x3", gram_mode="bf16x3", dot_mode=dot)
            f_un, b_un = cmac_flops(X, dot == "bf16x3")
            f_x, b_x = cmac_flops(2 * X, True)
            check_fwd16("block_backward_high", f"29q_X{X}_{tag}", view,
                        [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                        lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high(*p, *Ei, *E, **kw),
                        lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high_plain(
                            *p, *Ei, *E, **kw),
                        2, f_un + f_x, b_un + b_x,
                        2 * plane_bytes(fdt) + 2 * plane_bytes(bdt),
                        lib(high_bwd_library(E, Einv)),
                        tc=adjoint_tc(amps29 * X, fdt, bdt, dot, "bf16x3", "bf16x3"))
            del tabs, E, Einv
            torch.cuda.empty_cache()
        # the merged top axis: the in-place apply and the wide adjoint (its
        # pair gram as (B F^T) Einv^T, held as the wide adjoint's: 4e-5 on
        # f32 planes)
        for nq, X in ((N29, 256), (N30, 512)):
            if nq == N30 and tag != "bf16":
                continue
            amps_n = float(1 << nq)
            shape = (1, X, (1 << nq) // (X * 128), 128)
            pb = lambda dt, a=amps_n: 2 * a * (2 if dt == BF16 else 4)  # noqa: E731
            E, Einv = unitary(X), unitary(X)
            f, b = fwd_flops(X, dot, amps_n)
            check_fwd16("high_apply", f"{nq}q_X{X}_inplace_{tag}", shape, [(fdt, 1.0)] * 2,
                        lambda xr, xi, d=dot, E=E: high_apply(xr, xi, *E, dot_mode=d),
                        lambda xr, xi, d=dot, E=E: high_apply_plain(xr, xi, *E,
                                                                    dot_mode=d),
                        1, f, b, 2 * pb(fdt), lib(high_library(E)),
                        tc=[tc_product(amps_n * X, dot == "bf16x3", fdt)])
            x3 = dict(bwd_mode="bf16x3", gram_mode="bf16x3", dot_mode=dot)
            f_un, b_un = fwd_flops(X, dot, amps_n)
            f_x, b_x = fwd_flops(2 * X, "bf16x3", amps_n)
            check_fwd16("block_backward_high", f"{nq}q_X{X}_wide_{tag}", shape,
                        [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                        lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high(*p, *Ei, *E, **kw),
                        lambda *p, kw=x3, E=E, Ei=Einv: block_backward_high_plain(
                            *p, *Ei, *E, **kw),
                        2, f_un + f_x, b_un + b_x, 2 * pb(fdt) + 2 * pb(bdt),
                        lib(high_bwd_library(E, Einv)),
                        # the uncompute on F, the cross-Gram, the transport on B
                        tc=[tc_product(amps_n * X, dot == "bf16x3", fdt),
                            tc_product(amps_n * X, True, bdt, fdt),
                            tc_product(amps_n * X, True, bdt)])
            del E, Einv
            torch.cuda.empty_cache()
        # the multi-term applies: in place on the ring's CNOT terms (the
        # (6, 7) edge, T = 2; the closing edge's X = 8 span view, T = 2 lane
        # slices), and an edge density's T = 4 seed from F into B (acc)
        kind, *dops = pl.cross_terms_operands(
            ps._dense_cross_expanded_terms(cnot, (6, 7), N29), N29, dev)
        kind, vshape, *hops = pl.cross_span_operands(cnot, (0, N29 - 1), N29, dev)
        for name, fn, fn_plain, shape, ops, library in (
                ("dual_multi_apply", dual_multi_apply, dual_multi_apply_plain,
                 (A29, 128, 128), dops, dual_multi_library),
                ("high_multi_apply", high_multi_apply, high_multi_apply_plain,
                 vshape, hops, high_multi_library)):
            n_macs = macs(*ops[:2]) + macs(*ops[2:])
            f, b = cmac_flops(n_macs, dot == "bf16x3")
            check_fwd16(name, f"29q_T2_cnot_{tag}", shape, [(fdt, 1.0)] * 2,
                        lambda xr, xi, o=ops, d=dot, fn=fn: fn(xr, xi, *o, dot_mode=d),
                        lambda xr, xi, o=ops, d=dot, fn=fn_plain: fn(xr, xi, *o,
                                                                     dot_mode=d),
                        1, f, b, 2 * plane_bytes(fdt), lib(library(ops)),
                        tc=(multi_apply_tc(amps29, ops[0].shape[0], fdt, dot)
                            if name == "dual_multi_apply"
                            else high_multi_tc(amps29, 8, ops[0].shape[0], fdt, dot)))
        if tag != "x3":
            M4 = hermitian4()
            kind, *dops = pl.cross_terms_operands(
                ps._dense_cross_expanded_terms(M4.conj(), (6, 7), N29), N29, dev)
            kind, vshape, *hops = pl.cross_span_operands(M4.conj(), (0, N29 - 1), N29,
                                                         dev)
            for name, fn, fn_plain, shape, ops, library in (
                    ("dual_multi_apply", dual_multi_apply, dual_multi_apply_plain,
                     (A29, 128, 128), dops,
                     multi_seed_library("tsk,akm,tlm->asl", dops[2:], dops[:2], True)),
                    ("high_multi_apply", high_multi_apply, high_multi_apply_plain,
                     vshape, hops,
                     multi_seed_library("txy,iymk,tlk->ixml", hops[:2], hops[2:], True))):
                n_macs = macs(*ops[:2]) + macs(*ops[2:])
                f, b = cmac_flops(n_macs, dot == "bf16x3")
                check_fwd16(name, f"29q_seed_T4_acc_{tag}", shape,
                            [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                            lambda xr, xi, ar, ai, o=ops, d=dot, fn=fn: fn(
                                xr, xi, *o, conj=True, acc=(ar, ai), alias=False,
                                dot_mode=d),
                            lambda xr, xi, ar, ai, o=ops, d=dot, fn=fn_plain: fn(
                                xr, xi, *o, conj=True, acc=(ar, ai), dot_mode=d),
                            1, f, b, plane_bytes(fdt) + 2 * plane_bytes(bdt),
                            lib(library), reuse=False,
                            tc=(multi_apply_tc(amps29, 4, fdt, dot)
                                if name == "dual_multi_apply"
                                else high_multi_tc(amps29, 8, 4, fdt, dot)))
        del dops, hops
        torch.cuda.empty_cache()
        # the sublane adjoint ("auto" transport and gram of the setting)
        E, Einv = unitary(128), unitary(128)
        x3 = dict(bwd_mode="bf16x3", gram_mode="bf16x3", dot_mode=dot)
        f_un, b_un = cmac_flops(128, dot == "bf16x3")
        f_x, b_x = cmac_flops(256, True)
        check_fwd16("block_backward_sublane", f"29q_{tag}", (A29, 128, 128),
                    [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda *p, kw=x3: block_backward_sublane(*p, *Einv, *E, **kw),
                    lambda *p, kw=x3: block_backward_sublane_plain(*p, *Einv, *E, **kw),
                    2, f_un + f_x, b_un + b_x, 2 * plane_bytes(fdt) + 2 * plane_bytes(bdt),
                    lib(sublane_library(E, Einv)),
                    tc=adjoint_tc(amps29 * 128, fdt, bdt, dot, "bf16x3", "bf16x3"))
        del E, Einv
        torch.cuda.empty_cache()

    # 3k. "bf16" storage and the forward bf16x3 on VQE, QAOA and the plane
    # tape, and f16 input to the applies (the per-term fallback under
    # "f16") ---------------------------------------------------------------
    # each new variant against its plain version at the 29q path's shapes,
    # in 3i's settings: the lane adjoint (bf16 F; the uncompute bf16x3 on
    # f32 and on bf16 F); the dual adjoint with a run's Q (diag_q), the run
    # met after the pair ("diag_first": Q of F and B as staged, rounded to
    # their storage) and before it, on bf16 F and with the uncompute
    # bf16x3; the high adjoint with Q at X = 8 and 64 (views of 2^29
    # amplitudes, as 3j's) and 128 (group 2 of the 29q planes), both run
    # orders (Q of the f32 values); the diag adjoint's Q on bf16 F; the
    # dual and high (X = 8, 128) applies on f16 input planes, a fresh f16
    # output and a seed into an f16 accumulator. Tolerances as 3i's: planes
    # within FWD16_ULPS storage ulps (the dual adjoint with a run, which
    # stores F and B up to three times, 3: §2's bar for it under reduced
    # storage), Q and the pair grams within half a
    # storage ulp of their largest entry (f32 planes in bf16x3: X3_GRAM_TOL);
    # f16 planes in f16 ulps. Library time: the f32 rows' PyTorch calls on
    # the decoded planes, stored bf16, for bf16 F; none in bf16x3 and for f16
    # input (no PyTorch call stores the JAX codec's f16).
    log_time("3k")
    F16 = torch.float16
    for tag, (fdt, dot) in FWD16.items():
        bdt = BF16 if fdt == BF16 else torch.float32
        lib = (lambda make: bf16_library(make)) if tag == "bf16" else (lambda make: None)
        x3 = dict(bwd_mode="bf16x3", gram_mode="bf16x3", dot_mode=dot)
        f_un, b_un = cmac_flops(128, dot == "bf16x3")
        f_x, b_x = cmac_flops(256, True)
        E, Einv = unitary(128), unitary(128)
        check_fwd16("block_backward_lane", f"29q_{tag}", (A29, 128, 128),
                    [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                    lambda *p, kw=x3: block_backward_lane(*p, *Einv, *E, **kw),
                    lambda *p, kw=x3: block_backward_lane_plain(*p, *Einv, *E, **kw),
                    2, f_un + f_x, b_un + b_x, 2 * plane_bytes(fdt) + 2 * plane_bytes(bdt),
                    lib(lane_library(E, Einv)), phase="3k",
                    tc=adjoint_tc(amps29 * 128, fdt, bdt, dot, "bf16x3", "bf16x3"))
        del E, Einv
        if tag == "bf16x3":
            continue
        q_bytes = 2 * 4 * (128 * 128 + 2 * A29 * 128)
        f_q = amps29 * 12
        # the dual adjoint with a run's Q, both run orders
        for order in ("first", "after"):
            kw = dict(g0_first=True, diag_first_fwd=order == "first",
                      diag_inv_tables=tables(A29), diag_tables=tables(A29), diag_q=True,
                      **x3)
            f_un, b_un = cmac_flops(256, dot == "bf16x3")
            f_x, b_x = cmac_flops(512, True)
            check_fwd16("block_backward_dual", f"29q_g0_first_diag_{order}_q_{tag}",
                        (A29, 128, 128), [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                        lambda *p, kw=kw: block_backward_dual(*p, *bwd_ops, **kw),
                        lambda *p, kw=kw: block_backward_dual_plain(*p, *bwd_ops, **kw),
                        2, f_un + f_x + f_q, b_un + b_x,
                        2 * plane_bytes(fdt) + 2 * plane_bytes(bdt)
                        + 2 * table_bytes(A29) + q_bytes,
                        lib(dual_bwd_library(**kw)), ulps=STORE_ULPS + 1, phase="3k",
                        tc=adjoint_tc(amps29 * 256, fdt, bdt, dot, "bf16x3", "bf16x3"))
            del kw
            torch.cuda.empty_cache()
        # the high adjoint with a run's Q: X = 8, 64 and 128, both orders
        for X in (8, 64, 128):
            view = ((g2_29[0], 128, g2_29[2], 128) if X == 128 else small_x_view(X))
            E, Einv = unitary(X), unitary(X)
            f_un, b_un = cmac_flops(X, dot == "bf16x3")
            f_x, b_x = cmac_flops(2 * X, True)
            for order in ("first", "after"):
                ti, tf = tables(A29), tables(A29)
                kw = dict(diag_inv_tables=ti, diag_tables=tf,
                          diag_first_fwd=order == "first", diag_q=True, **x3)
                check_fwd16("block_backward_high", f"29q_X{X}_diag_{order}_q_{tag}",
                            view, [(fdt, 1.0)] * 2 + [(bdt, 0.5)] * 2,
                            lambda *p, kw=kw, E=E, Ei=Einv: block_backward_high(
                                *p, *Ei, *E, **kw),
                            lambda *p, kw=kw, E=E, Ei=Einv: block_backward_high_plain(
                                *p, *Ei, *E, **kw),
                            2, f_un + f_x + f_q, b_un + b_x,
                            2 * plane_bytes(fdt) + 2 * plane_bytes(bdt)
                            + 2 * table_bytes(A29) + q_bytes,
                            lib(high_q_library(E, Einv, ti, tf, order == "first")),
                            phase="3k",
                            # a run met first leaves f32 values in the
                            # tensor-core step's tiles (no staging)
                            tc=adjoint_tc(amps29 * X,
                                          *((fdt, bdt) if order == "first"
                                            else ("float32", "float32")),
                                          dot, "bf16x3", "bf16x3"))
                del ti, tf, kw
            del E, Einv
            torch.cuda.empty_cache()
        if tag == "bf16":
            # the diag adjoint's Q on bf16 F (no dot)
            ti, tf = tables(A29), tables(A29)
            check_fwd16("diag_backward", "29q_q_bf16", (A29, 128, 128), [(BF16, 1.0)] * 4,
                        lambda *p: diag_backward(*p, *ti, *tf, with_q=True),
                        lambda *p: diag_backward_plain(*p, *ti, *tf, with_q=True),
                        2, amps29 * (36 + 12), 0.0,
                        4 * plane_bytes(BF16) + 2 * table_bytes(A29) + q_bytes,
                        bf16_library(diag_q_library(ti, tf)), phase="3k")
            del ti, tf
    # f16 input planes to the applies, the per-term fallback's forms: a fresh
    # output in the input's storage, and a seed into an f16 accumulator
    f, b = cmac_flops(256, False)
    for form, ins, kw in (("fresh", [(F16, 1.0)] * 2, dict(alias=False)),
                          ("acc", [(F16, 1.0)] * 2 + [(F16, 0.5)] * 2, dict(conj=True))):
        n_io = 2 if form == "fresh" else 3
        if form == "fresh":
            fk = lambda xr, xi, kw=kw: dual_apply(xr, xi, *el29, *em29, **kw)  # noqa: E731
            fp = lambda xr, xi, kw=kw: dual_apply_plain(xr, xi, *el29, *em29, **kw)  # noqa: E731
        else:
            fk = lambda xr, xi, ar, ai: dual_apply(  # noqa: E731
                xr, xi, *el29, *em29, conj=True, acc=(ar, ai), alias=False)
            fp = lambda xr, xi, ar, ai: dual_apply_plain(  # noqa: E731
                xr, xi, *el29, *em29, conj=True, acc=(ar, ai))
        check_fwd16("dual_apply", f"29q_{form}_f16in", (A29, 128, 128), ins, fk, fp, 1,
                    f, b, n_io * plane_bytes(F16), reuse=form == "fresh", phase="3k",
                    tc=dual_apply_tc(amps29, F16))
        for X in (8, 128):
            view = ((g2_29[0], 128, g2_29[2], 128) if X == 128 else small_x_view(X))
            E = unitary(X)
            fx, bx = cmac_flops(X, False)
            if form == "fresh":
                fk = lambda xr, xi, E=E: high_apply(xr, xi, *E, alias=False)  # noqa: E731
                fp = lambda xr, xi, E=E: high_apply_plain(xr, xi, *E, alias=False)  # noqa: E731
            else:
                fk = lambda xr, xi, ar, ai, E=E: high_apply(  # noqa: E731
                    xr, xi, *E, conj=True, acc=(ar, ai), alias=False)
                fp = lambda xr, xi, ar, ai, E=E: high_apply_plain(  # noqa: E731
                    xr, xi, *E, conj=True, acc=(ar, ai))
            check_fwd16("high_apply", f"29q_X{X}_{form}_f16in", view, ins, fk, fp, 1,
                        fx, bx, n_io * plane_bytes(F16), reuse=form == "fresh",
                        phase="3k",
                        tc=high_apply_tc(amps29, X, F16))
            del E
        torch.cuda.empty_cache()

    # 3m. the high adjoint at X = 8..64 on the tensor cores
    # (csrc/block_backward_high_small.cu) -----------------------------------
    # every variant its entry takes (F f32 / bf16, B f32 / bf16 / f16; the
    # uncompute, the transport and the pair gram each 3xTF32 or bf16x3; no
    # run, a run met first or after, with and without its Q) against its
    # plain version on views (2, X, 256, 128), without times: planes within
    # STORE_ULPS storage ulps (f32: HIGH_TOL), the pair grams and Q within
    # their storage's gram tolerance (f32 planes: GRAM_T0_TOL, X3_GRAM_TOL
    # with a bf16x3 gram or uncompute); then the rows kept at 2^29 amplitudes
    # with their times: f32 planes in the "f32" modes at X = 16, 32 and 64
    # (the views (1, X, 2^22 / X, 128); 3j times X = 16 and 32 in "bf16" only)
    log_time("3m")
    gen_state = gen.get_state()  # every later row keeps its data
    F32 = torch.float32
    small_settings = ((F32, F32, "f32", "f32", "f32"), (F32, F32, "f32", "f32", "bf16x3"),
                      (F32, F16, "f32", "bf16x3", "bf16x3"), (F32, F16, "f32", "f32", "bf16x3"),
                      (F32, BF16, "f32", "bf16x3", "bf16x3"), (BF16, BF16, "f32", "bf16x3", "bf16x3"),
                      (F32, F32, "bf16x3", "bf16x3", "bf16x3"), (BF16, BF16, "bf16x3", "bf16x3", "bf16x3"),
                      (F32, F32, "bf16x3", "f32", "f32"), (BF16, BF16, "f32", "f32", "f32"),
                      (BF16, F16, "f32", "f32", "f32"))
    small_runs = ((None, False), ("first", False), ("first", True), ("after", False),
                  ("after", True))
    worst_small = {"ulps": 0.0, "abs": 0.0, "rel": 0.0}
    n_small = 0
    for X in (8, 16, 32, 64):
        shape = (2, X, 256, 128)
        a_rows = 2 * X * 256 // 128
        E, Einv = unitary(X), unitary(X)
        for fdt, bdt, dot, bwd, gram in small_settings:
            for run, q in small_runs:
                kw = dict(dot_mode=dot, bwd_mode=bwd, gram_mode=gram)
                if run:
                    kw.update(diag_inv_tables=tables(a_rows), diag_tables=tables(a_rows),
                              diag_first_fwd=run == "first", diag_q=q)
                ins = ([stc.store_as(randn(*shape), fdt) for _ in range(2)]
                       + [stc.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])
                want = block_backward_high_plain(*ins, *Einv, *E, **kw)
                got = block_backward_high(*[t.clone() for t in ins], *Einv, *E, **kw)
                torch.cuda.synchronize()
                ulps, err = 0.0, 0.0
                for k in range(2):
                    g2, w2 = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2]
                    if g2[0].dtype == F32:
                        err = max(err, max((a - b).abs().max().item() for a, b in zip(g2, w2)))
                    else:
                        ulps = max(ulps, stc.ulps_apart(g2, w2, g2[0].dtype))
                rel = max((g_ - w_).abs().max().item() / max(w_.abs().max().item(), 1e-30)
                          for g_, w_ in zip(got[4:], want[4:]))
                red = [d for d in (bdt, fdt) if d != F32]
                g_tol = (stc.gram_tolerance(red[0]) if red else
                         X3_GRAM_TOL if "bf16x3" in (gram, dot) else GRAM_T0_TOL)
                require(ulps <= STORE_ULPS and err <= HIGH_TOL and rel <= g_tol,
                        f"block_backward_high[X{X} F {fdt} B {bdt} {dot}/{bwd}/{gram} "
                        f"run {run} q {q}] disagrees with its plain version: planes "
                        f"{ulps:.2f} ulps (tol {STORE_ULPS}), {err:.3e} abs (tol "
                        f"{HIGH_TOL:.0e}), grams and Q {rel:.3e} (tol {g_tol:.1e})")
                worst_small = {"ulps": max(worst_small["ulps"], ulps),
                               "abs": max(worst_small["abs"], err),
                               "rel": max(worst_small["rel"], rel)}
                n_small += 1
                del ins, want, got
        torch.cuda.empty_cache()
    log(f"[3m] block_backward_high at X = 8..64: {n_small} variants within their bars "
        f"on views (2, X, 256, 128); worst {json.dumps(worst_small)}")
    for X in (16, 32, 64):
        E, Einv = unitary(X), unitary(X)
        check_many("block_backward_high", f"29q_X{X}_f32", small_x_view(X), 4, 4,
                   lambda *p, E=E, Einv=Einv: block_backward_high(*p, *Einv, *E),
                   lambda *p, E=E, Einv=Einv: block_backward_high_plain(*p, *Einv, *E),
                   HIGH_TOL, flops=amps29 * 3 * X * 8, bytes_moved=4 * state29,
                   library=high_bwd_library(E, Einv), tc=adjoint_tc(amps29 * X))
    del E, Einv
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # 3n. the Gram at X = 128 / 256 / 512 and the merged-top adjoint on the
    # tensor cores (csrc/gram.cu's dqc_gram_tc; csrc/block_backward_merged_fact.cu
    # on csrc/tc_adjoint.cuh's step): every variant their entries take against
    # the plain versions on small views, without times: the Gram of the lane,
    # sublane and high views at X = 128 and of the merged top at X = 256 / 512
    # on f32 and bf16 planes in both dot modes (within GRAM_T0_TOL of the
    # largest entry; X3_GRAM_TOL in bf16x3 on f32 planes), the merged adjoint
    # at Xt = 2 and 4 on views (1, Xt 128, 32, 128) with F f32 / bf16, B f32 /
    # bf16 / f16 and every combination of the three dot modes (planes within
    # HIGH_TOL or STORE_ULPS storage ulps, T0_top and T0_low within their
    # storage's gram tolerance, X3_GRAM_TOL with a bf16x3 gram or uncompute on
    # f32 planes); then the one mode pair no path hands it, a bf16x3
    # uncompute beside a bf16x3 transport, timed at 2^29. The rows of phases 3, 3e and
    # 3i time the rest at 29q, with their tensor-core bounds from phase 3l.
    log_time("3n")
    gen_state = gen.get_state()  # every later row keeps its data
    # (3m's loop variable took the name gram)
    from dqc_tpu_torch.ops.kernels.gram import gram as gram_fn
    worst_gram, n_gram = 0.0, 0
    for view in ((1 << 13, 128, 1), (64, 128, 128), (2, 128, 256 * 128),
                 (2, 256, 256 * 128), (2, 512, 256 * 128)):
        for fdt in (F32, BF16):
            for dot in ("f32", "bf16x3"):
                xr, xi = (stc.store_as(randn(*view), fdt) for _ in range(2))
                want = gram_plain(xr, xi, dot)
                got = gram_fn(xr, xi, dot_mode=dot)
                torch.cuda.synchronize()
                rel = max((g_ - w_).abs().max().item() / w_.abs().max().item()
                          for g_, w_ in zip(got, want))
                tol = X3_GRAM_TOL if (fdt, dot) == (F32, "bf16x3") else GRAM_T0_TOL
                require(rel <= tol, f"gram[{view} {fdt} {dot}] disagrees with its "
                                    f"plain version: {rel:.3e} relative (tol {tol:.0e})")
                worst_gram = max(worst_gram, rel)
                n_gram += 1
                del xr, xi, want, got
    modes3 = [(d, b, g_) for d in ("f32", "bf16x3") for b in ("f32", "bf16x3")
              for g_ in ("f32", "bf16x3")]
    worst_merged = {"ulps": 0.0, "abs": 0.0, "rel": 0.0}
    n_merged = 0
    for x_top in (2, 4):
        shape = (1, x_top * 128, 32, 128)
        mops = (*unitary(128), *unitary(128), *unitary(x_top), *unitary(x_top))
        for fdt in (F32, BF16):
            for bdt in (F32, BF16, F16):
                for dot, bwd, gm_ in modes3:
                    kw = dict(x_top=x_top, dot_mode=dot, bwd_mode=bwd, gram_mode=gm_)
                    ins = ([stc.store_as(randn(*shape), fdt) for _ in range(2)]
                           + [stc.store_as(0.5 * randn(*shape), bdt) for _ in range(2)])
                    want = block_backward_merged_fact_plain(*ins, *mops, **kw)
                    got = block_backward_merged_fact(*[t.clone() for t in ins], *mops, **kw)
                    torch.cuda.synchronize()
                    ulps, err = 0.0, 0.0
                    for k in range(2):
                        g2, w2 = got[2 * k:2 * k + 2], want[2 * k:2 * k + 2]
                        if g2[0].dtype == F32:
                            err = max(err, max((a - b).abs().max().item()
                                               for a, b in zip(g2, w2)))
                        else:
                            ulps = max(ulps, stc.ulps_apart(g2, w2, g2[0].dtype))
                    rel = max((torch.complex(got[j], got[j + 1])
                               - torch.complex(want[j], want[j + 1])).abs().max().item()
                              / torch.complex(want[j], want[j + 1]).abs().max().item()
                              for j in (4, 6))
                    red = [d for d in (bdt, fdt) if d != F32]
                    g_tol = (stc.gram_tolerance(red[0]) if red else
                             X3_GRAM_TOL if "bf16x3" in (gm_, dot) else GRAM_T0_TOL)
                    require(ulps <= STORE_ULPS and err <= HIGH_TOL and rel <= g_tol,
                            f"block_backward_merged_fact[Xt{x_top} F {fdt} B {bdt} "
                            f"{dot}/{bwd}/{gm_}] disagrees with its plain version: "
                            f"planes {ulps:.2f} ulps (tol {STORE_ULPS}), {err:.3e} abs "
                            f"(tol {HIGH_TOL:.0e}), T0 {rel:.3e} (tol {g_tol:.1e})")
                    worst_merged = {"ulps": max(worst_merged["ulps"], ulps),
                                    "abs": max(worst_merged["abs"], err),
                                    "rel": max(worst_merged["rel"], rel)}
                    n_merged += 1
                    del ins, want, got
        del mops
        torch.cuda.empty_cache()
    log(f"[3n] gram at X = 128..512: {n_gram} variants within their bars, worst "
        f"{worst_gram:.3e} relative; block_backward_merged_fact: {n_merged} variants "
        f"within their bars on views (1, Xt 128, 32, 128); worst "
        f"{json.dumps(worst_merged)}")
    x_top, shape = merged_shapes[0]
    mops = (*unitary(128), *unitary(128), *unitary(x_top), *unitary(x_top))
    x3x3 = dict(x_top=x_top, dot_mode="bf16x3", bwd_mode="bf16x3", gram_mode="bf16x3")
    _, b_x3 = cmac_flops(3 * 128, True)
    check_fwd16("block_backward_merged_fact", f"Xt{x_top}_x3x3", shape,
                [(F32, 1.0)] * 2 + [(F32, 0.5)] * 2,
                lambda *p: block_backward_merged_fact(*p, *mops, **x3x3),
                lambda *p: block_backward_merged_fact_plain(*p, *mops, **x3x3),
                2, amps29 * 3 * x_top * 8, b_x3, 4 * state29, phase="3n",
                tc=merged_tc(x_top, dot="bf16x3", bwd="bf16x3", gram="bf16x3"))
    del mops
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # 3o. the dual apply and the merged-top apply on the tensor cores
    # (csrc/dual_apply.cu and csrc/merged_fact_apply.cu on csrc/tc_adjoint.cuh's
    # tile product): every variant their entries take against the plain
    # versions on small views, without times (the rows of phases 3, 3e, 3i
    # and 3k time them at 29q, with their tensor-core bounds from phase 3l):
    # the dual apply on views (8, 128, 128) with x f32, bf16 or f16, in place,
    # fresh and into an accumulator (conj) of each storage it takes, no run
    # or one multiplied first or after, in both dot modes (PERF.md's rows 1,
    # 1s, 1f, 1v, 1x, 1h and the seeds into f16 / bf16 planes); the merged
    # apply at Xt = 2 and 4 on views (1, Xt 128, 32, 128), f32 and bf16
    # planes, both dot modes (rows 6, 6v, 6x). f32 planes within HIGH_TOL abs
    # (unit-variance planes through unitary operators), 16-bit planes within
    # STORE_ULPS storage ulps, as phase 3n's.
    log_time("3o")
    gen_state = gen.get_state()  # every later row keeps its data
    STORES16 = {F32: (F32, BF16, torch.float16), BF16: (BF16,),
                torch.float16: (torch.float16,)}
    worst_fwd = {"ulps": 0.0, "abs": 0.0}
    n_dual = n_mfa = 0

    def held_fwd(what, got, want):
        """A plane pair against its plain version's: STORE_ULPS storage ulps
        when stored 16-bit, HIGH_TOL abs when f32."""
        require(got[0].dtype == want[0].dtype,
                f"{what}: output {got[0].dtype}, want {want[0].dtype}")
        if got[0].dtype == F32:
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            worst_fwd["abs"] = max(worst_fwd["abs"], err)
            require(err <= HIGH_TOL, f"{what} disagrees with its plain version: "
                                     f"{err:.3e} abs (tol {HIGH_TOL:.0e})")
        else:
            ulps = stc.ulps_apart(got, want, got[0].dtype)
            worst_fwd["ulps"] = max(worst_fwd["ulps"], ulps)
            require(ulps <= STORE_ULPS, f"{what} disagrees with its plain version: "
                                        f"{ulps:.2f} ulps (tol {STORE_ULPS})")

    A8 = 8
    dual_ops = (*unitary(128), *unitary(128))
    tab8 = tables(A8)
    for xdt, ydts in STORES16.items():
        for dot in ("f32", "bf16x3"):
            for run in (None, "first", "after"):
                rkw = dict(dot_mode=dot)
                if run is not None:
                    rkw.update(diag_tables=tab8, diag_first=run == "first")
                forms = [("inplace", xdt)] + [(f, y) for f in ("fresh", "acc") for y in ydts]
                for form, ydt in forms:
                    xs = [stc.store_as(randn(A8, 128, 128), xdt) for _ in range(2)]
                    kw = dict(rkw)
                    if form == "fresh":
                        kw.update(conj=True, alias=False, out_dtype=ydt)
                    elif form == "acc":
                        acc = [stc.store_as(0.5 * randn(A8, 128, 128), ydt) for _ in range(2)]
                        kw.update(conj=True, acc=tuple(acc), alias=False)
                    want = dual_apply_plain(*xs, *dual_ops, **kw)
                    if form == "acc":
                        kw["acc"] = tuple(a.clone() for a in acc)
                    got = dual_apply(*[x.clone() for x in xs], *dual_ops, **kw)
                    torch.cuda.synchronize()
                    held_fwd(f"dual_apply[{xdt} -> {ydt} {form} run {run} {dot}]", got, want)
                    n_dual += 1
                    del xs, want, got
    for x_top in (2, 4):
        shape = (1, x_top * 128, 32, 128)
        mops = (*unitary(128), *unitary(x_top))
        for fdt in (F32, BF16):
            for dot in ("f32", "bf16x3"):
                xs = [stc.store_as(randn(*shape), fdt) for _ in range(2)]
                want = merged_fact_apply_plain(*xs, *mops, x_top=x_top, dot_mode=dot)
                got = merged_fact_apply(*[x.clone() for x in xs], *mops, x_top=x_top,
                                        dot_mode=dot)
                torch.cuda.synchronize()
                held_fwd(f"merged_fact_apply[Xt{x_top} {fdt} {dot}]", got, want)
                n_mfa += 1
                del xs, want, got
    log(f"[3o] dual_apply: {n_dual} variants within their bars on views ({A8}, 128, "
        f"128); merged_fact_apply: {n_mfa} on views (1, Xt 128, 32, 128); worst "
        f"{json.dumps(worst_fwd)}")
    del dual_ops, tab8
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # 3p. the high apply at X = 8..64 and the multi-term dual apply on the
    # tensor cores (csrc/high_apply_small.cu, csrc/dual_multi_apply.cu): every
    # variant their entries take against their plain versions on small views,
    # without times (the rows of phases 3, 3c, 3d, 3h, 3j and 3k time them at
    # 29q, with their tensor-core bounds from phase 3l): the high apply at
    # X = 8, 16, 32 and 64 on views (2, X, 128, 128) with x f32, bf16 or f16,
    # in place, fresh and into an accumulator (conj) of each storage it
    # takes, no run or one multiplied first or after, in both dot modes
    # (PERF.md's rows 2x, 2y, 2yf, 2v', 2x', 2h); the multi-term dual apply
    # with T = 1, 2, 4 and 16 terms (16: a traced k >= 4 gate's, into an
    # accumulator only) on views (4, 128, 128) in the same storages, forms
    # and dot modes (rows 8, 8s, 8f, 8v, 8x). f32 planes within HIGH_TOL abs,
    # 16-bit planes within STORE_ULPS storage ulps, as 3o's. Then the f32
    # high apply in place at X = 16, 32 and 64 on views of 2^29 amplitudes
    # (group 2 at n = 17-20 and group 3 at n = 24-27; first timed here),
    # beside its matmul.
    log_time("3p")
    gen_state = gen.get_state()  # every later row keeps its data
    worst_fwd.update({"ulps": 0.0, "abs": 0.0})
    n_high = n_multi = 0

    def seed_forms(xdt):
        return [("inplace", xdt)] + [(f, y) for f in ("fresh", "acc") for y in STORES16[xdt]]

    def held_seed(what, fn, fn_plain, shape, xdt, ydt, form, ops, kw):
        xs = [stc.store_as(randn(*shape), xdt) for _ in range(2)]
        kw = dict(kw)
        acc = None
        if form == "fresh":
            kw.update(conj=True, alias=False, out_dtype=ydt)
        elif form == "acc":
            acc = [stc.store_as(0.5 * randn(*shape), ydt) for _ in range(2)]
            kw.update(conj=True, acc=tuple(acc), alias=False)
        want = fn_plain(*xs, *ops, **kw)
        if acc is not None:
            kw["acc"] = tuple(a.clone() for a in acc)
        got = fn(*[x.clone() for x in xs], *ops, **kw)
        torch.cuda.synchronize()
        held_fwd(what, got, want)

    for X in (8, 16, 32, 64):
        shape = (2, X, 128, 128)
        E = unitary(X)
        tabX = tables(2 * X)
        for xdt in STORES16:
            for dot in ("f32", "bf16x3"):
                for run in (None, "first", "after"):
                    kw = dict(dot_mode=dot)
                    if run is not None:
                        kw.update(diag_tables=tabX, diag_first=run == "first")
                    for form, ydt in seed_forms(xdt):
                        held_seed(f"high_apply[X{X} {xdt} -> {ydt} {form} run {run} {dot}]",
                                  high_apply, high_apply_plain, shape, xdt, ydt, form, E, kw)
                        n_high += 1
        del E, tabX
    for T in (1, 2, 4, 16):
        terms = [unitary(128) for _ in range(2 * T)]
        mops = tuple(torch.stack([terms[k + T * f][p] for k in range(T)])
                     for f in (0, 1) for p in (0, 1))
        for xdt in STORES16:
            for dot in ("f32", "bf16x3"):
                for form, ydt in seed_forms(xdt):
                    if T == 16 and form != "acc":
                        continue
                    held_seed(f"dual_multi_apply[T{T} {xdt} -> {ydt} {form} {dot}]",
                              dual_multi_apply, dual_multi_apply_plain, (4, 128, 128),
                              xdt, ydt, form, mops, dict(dot_mode=dot))
                    n_multi += 1
        del terms, mops
    log(f"[3p] high_apply: {n_high} variants within their bars on views (2, X, 128, "
        f"128), X = 8..64; dual_multi_apply: {n_multi} on views (4, 128, 128), T = 1, "
        f"2, 4, 16; worst {json.dumps(worst_fwd)}")
    for X in (16, 32, 64):
        E = unitary(X)
        check("high_apply", f"29q_X{X}_f32", (1, X, (1 << N29) // (X * 128), 128),
              high_apply, high_apply_plain, (*E, None, True), HIGH_TOL,
              flops=amps29 * X * 8, bytes_moved=2 * state29, library=high_library(E),
              tc=high_apply_tc(amps29, X))
        del E
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # 3q. the high multi-term apply on the dual multi-term kernel and the
    # Gram at X = 8..64 on the tensor cores (csrc/dual_multi_apply.cu's entry
    # dqc_high_multi_apply, csrc/gram.cu's dqc_gram_tc): every variant their
    # entries take against their plain versions on small views, without
    # times (the rows of phases 3c, 3d, 3h and 3j time the multi-term apply
    # at 29q, with their tensor-core bounds from phase 3l): the high
    # multi-term apply at X = 8, 16, 32, 64 and 128 with T = 2 and 4 terms on
    # views (2, X, 2 (128 / X), 128), x f32 / bf16 / f16, in place, fresh and
    # into an accumulator (conj) of each storage it takes, in both dot modes
    # (PERF.md's rows 9, 9s, 9f, 9v, 9x), planes within 3p's bars; the Gram at
    # X = 8, 16, 32 and 64 on views (8, X, 8192) of f32 and bf16 planes in
    # both dot modes (rows 5, 5v', 5x'), (S, C) within GRAM_T0_TOL of their
    # largest entry (X3_GRAM_TOL in bf16x3 on f32 planes). Then the f32 Gram
    # at X = 8 and 64 on views of 2^29 amplitudes (first timed here), beside
    # its einsum.
    log_time("3q")
    gen_state = gen.get_state()  # every later row keeps its data
    worst_fwd.update({"ulps": 0.0, "abs": 0.0})
    n_hm = n_gs = 0
    worst_gs = 0.0
    for X in (8, 16, 32, 64, 128):
        shape = (2, X, 2 * (128 // X), 128)
        for T in (2, 4):
            hops = (*(torch.stack(p) for p in zip(*[unitary(X) for _ in range(T)])),
                    *(torch.stack(p) for p in zip(*[unitary(128) for _ in range(T)])))
            for xdt in STORES16:
                for dot in ("f32", "bf16x3"):
                    for form, ydt in seed_forms(xdt):
                        held_seed(f"high_multi_apply[X{X} T{T} {xdt} -> {ydt} {form} {dot}]",
                                  high_multi_apply, high_multi_apply_plain, shape, xdt,
                                  ydt, form, hops, dict(dot_mode=dot))
                        n_hm += 1
            del hops
    for X in (8, 16, 32, 64):
        for fdt in (F32, BF16):
            for dot in ("f32", "bf16x3"):
                xr, xi = (stc.store_as(randn(8, X, 8192), fdt) for _ in range(2))
                want = gram_plain(xr, xi, dot)
                got = gram_fn(xr, xi, dot_mode=dot)
                torch.cuda.synchronize()
                rel = max((g_ - w_).abs().max().item() / w_.abs().max().item()
                          for g_, w_ in zip(got, want))
                tol = X3_GRAM_TOL if (fdt, dot) == (F32, "bf16x3") else GRAM_T0_TOL
                require(rel <= tol, f"gram[X{X} {fdt} {dot}] disagrees with its plain "
                                    f"version: {rel:.3e} relative (tol {tol:.0e})")
                worst_gs = max(worst_gs, rel)
                n_gs += 1
                del xr, xi, want, got
    log(f"[3q] high_multi_apply: {n_hm} variants within their bars on views (2, X, "
        f"2 (128 / X), 128), X = 8..128, T = 2, 4; worst {json.dumps(worst_fwd)}; gram: "
        f"{n_gs} on views (8, X, 8192), X = 8..64, worst {worst_gs:.3e} relative")
    for X in (8, 64):
        check("gram", f"29q_X{X}_f32", (1, X, (1 << N29) // X), gram_fn, gram_plain, (),
              GRAM_TOL, flops=amps29 * (2 * X + 1) * 2, bytes_moved=state29,
              library=gram_library, normalize=True, tc=gram_tc(amps29, X))
    gen.set_state(gen_state)
    torch.cuda.empty_cache()

    # 3l. the tensor-core routes: csrc/tc_apply.cuh (the high apply at X =
    # 128 / 256 / 512 in every mode and storage, the X = 256 / 512 adjoint's
    # two updates), the X = 256 / 512 cross-Gram and csrc/tc_adjoint.cuh
    # (the one-pass step of the dual, lane and sublane adjoints and of the
    # high adjoint at X = 128, every row of theirs; the tile product of the
    # dual apply and of the merged-top apply, every row of theirs). Each
    # of their rows with its bound on the tensor cores (tc_bound_ms, from the
    # mma passes its storage leaves: tc_product), which becomes its bound_ms
    # (the CUDA-core figure kept as cuda_core_bound_ms), and its share of it;
    # and the kernels' registers and spills from this run's build (with the
    # not-inlined functions of the adjoints' step)
    tc_regs = _build.kernel_resources(("tc_apply_kernel", "cross_gram_tc_kernel",
                                       "high_apply_small_kernel",
                                       "dual_multi_apply_tc_kernel",
                                       "dual_apply_tc_kernel", "dual_load_slab",
                                       "dual_store_slab",
                                       "merged_fact_apply_tc_kernel", "merged_load_top",
                                       "gram_tc_kernel", "gram_tc_small_kernel",
                                       "block_backward_merged_fact_kernel",
                                       "merged_slice_gram", "merged_top_factor",
                                       "block_backward_dual_kernel",
                                       "block_backward_high_tc_kernel",
                                       "block_backward_high_small_kernel", "tc_op_tile",
                                       "pair_gram_tf32_mma128", "pair_gram_x3_tc",
                                       "tc_load_tiles", "tc_store_tile"))
    if not tc_regs:
        log("[tc] registers: no ptxas report (the libraries were built before "
            "this process)")
    for lib_name, kernels_of in tc_regs.items():
        for k in kernels_of:
            log(f"[tc] registers {lib_name}: {json.dumps(k)}")
    for r in rows:
        if r["kernel"] in (*TC_ADJOINTS, "block_backward_high", "gram",
                           "block_backward_merged_fact", "dual_apply",
                           "merged_fact_apply", "high_apply", "dual_multi_apply",
                           "high_multi_apply"):
            require("tc_flops" in r, f"{r['kernel']}[{r['variant']}] runs on the "
                                     "tensor cores but states no tensor-core work")
            r["cuda_core_bound_ms"] = r["bound_ms"]
            r["bound_ms"], r["bound_by"] = tc_bound_ms(r["bytes"], *r["tc_flops"])
            r["tc_bound_ms"] = r["bound_ms"]
            r["tc_share"] = r["tc_bound_ms"] / r["ms"]
            log(f"[tc] {json.dumps({k: r.get(k) for k in ('kernel', 'variant', 'storage', 'fwd', 'ms', 'library_ms', 'bound_ms', 'bound_by', 'cuda_core_bound_ms', 'tc_flops', 'tc_share')})}")

    # 4. the forward: 28 qubits x L28 layers, cz ring ------------------------
    log_time("[slice]")
    model = HardwareEfficientAnsatz(N_QUBITS, L28, entangler="cz")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dens = model.densities(params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fwd_counts = K.launch_counts()
    log(f"[slice] {N_QUBITS}q x {L28}L forward through the kernels: "
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
    log(f"[slice] step (warm) {step_s:.4f} s = {step_s / L28 * 1e3:.2f} ms/layer; "
        f"{model.num_gates / step_s:.1f} gates/s; peak memory {peak / 2**30:.3f} GiB")
    # where the step goes: each layer is one dual sweep, one plain group-2
    # sweep and one group-3 sweep with the ring's run after it; the epilogue
    # is one Gram per group
    per_launch = {(r["kernel"], r["variant"]): r["ms"] for r in rows}
    per_bound = {(r["kernel"], r["variant"]): r["bound_ms"] for r in rows}
    kernel_ms = (L28 * (per_launch["dual_apply", "plain"]
                           + per_launch["high_apply", "X128_plain"]
                           + per_launch["high_apply", "X128_diag_after"])
                 + sum(per_launch["gram", v]
                       for v in ("lane", "sublane", "high_g2", "high_g3")))
    log(f"[slice] kernel time per step (launches x per-launch ms above): "
        f"{kernel_ms:.1f} ms = {100 * kernel_ms / (step_s * 1e3):.1f}% of the step; "
        f"the rest ({step_s * 1e3 - kernel_ms:.1f} ms) is host work and launch gaps")

    zero = model.magnetization(torch.zeros(L28, N_QUBITS, 3)).item()
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

    # 5. the gradient: value_and_grad of the magnetization, 28q x L28 layers
    params.requires_grad_(True)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loss = model.magnetization(params)
    loss.backward()
    torch.cuda.synchronize()
    vg_first_s = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"[grad] {N_QUBITS}q x {L28}L value_and_grad through the kernels: "
        f"{vg_first_s:.3f} s (first call); launches {json.dumps(counts)}")
    # per step: the forward's sweeps, one seed apply per group (two dual, two
    # high), and one backward sweep per forward sweep
    want = dict.fromkeys(counts, 0)
    want.update({"dual_apply": L28 + 2, "high_apply": 2 * L28 + 2,
                 "gram": 4, "block_backward_dual": L28,
                 "block_backward_high": 2 * L28})
    want["high_apply[tc]"] = want["high_apply"]  # X = 128 all: tensor cores
    with_gram_modes(want)
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
        f"{vg_s / L28 * 1e3:.2f} ms/layer; forward-only step {fwd_s:.4f} s; "
        f"ratio {vg_s / fwd_s:.2f}; peak memory {vg_peak / 2**30:.3f} GiB; "
        f"grad vs first call max abs {drift:.3e}")
    require(drift <= GRAD_TOL, "two value_and_grad steps disagree")
    bwd_ms = (L28 * (per_launch["block_backward_dual", "g0_first"]
                        + per_launch["block_backward_high", "X128_plain"]
                        + per_launch["block_backward_high", "X128_diag_after"])
              + 2 * per_launch["dual_apply", "seed"]
              + 2 * per_launch["high_apply", "X128_seed"])
    log(f"[grad] kernel time per step (launches x per-launch ms above, the "
        f"adjoints' f32-gram rows; the step runs the default bf16x3 grams): "
        f"forward {kernel_ms:.1f} ms + seeds and backward {bwd_ms:.1f} ms = "
        f"{100 * (kernel_ms + bwd_ms) / (vg_s * 1e3):.1f}% of the step")
    del params, grad, loss
    torch.cuda.empty_cache()

    def with_gram(mode, fn, *args, **kw):
        """``fn`` under pair grams in ``mode`` ("auto": the default)."""
        config.set_gram_kernel_dot_mode(mode)
        try:
            return fn(*args, **kw)
        finally:
            config.set_gram_kernel_dot_mode("auto")

    def closed_forms(fn, *args, **kw):
        """An exact-answer check twice: with f32 pair grams at its own bar,
        then under the default bf16x3 grams at BF16X3_GRAM_TOL."""
        with_gram("f32", fn, *args, **kw)
        with_gram("auto", fn, *args, **kw, x3=True)

    def closed_form(n: int, tag: str, tol: float = CLOSED_TOL,
                    x3: bool = False) -> float:
        """n x 1L at params (alpha, 0, 0): <Z_i> = cos alpha_i, so the
        gradient is (-sin alpha, 0, 0). Returns the gradient error."""
        tol = max(tol, BF16X3_GRAM_TOL) if x3 else tol
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
        log(f"[{tag}] {n}q x 1L closed form ({config.gram_kernel_dot_mode()} pair "
            f"grams): value err {val_err:.3e}, gradient err {closed_err:.3e} vs "
            f"(-sin alpha, 0, 0) (tol {tol:.0e})")
        require(val_err <= CLOSED_TOL * n and closed_err <= tol,
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

    REDUCED_KEYS = ("[bf16]", "[f16]", "[bf16x3]")

    def storage_phase(tag, run, params, storage, dry, ref=None, rms_tol=None,
                      variants=()):
        """value_and_grad of ``run(params)`` (a scalar loss of a list of
        tensors) under cotangent storage ``storage``, once: the counters set
        to 0 just before and read just after and held, per kernel and mode,
        to the port's dispatch of the same run on the meta device (``dry``)
        under the same storage; its step time and peak memory (every kernel
        and shape it runs has launched before, in the kernel phase or the
        f32 phase of the same model). With ``ref`` (the f32-storage run's
        value and gradient on the same params): the value bit-identical,
        the gradient's rms and max of |g - g32| / max |g32|, the rms within
        ``rms_tol``, and each of the counters ``variants`` launched. An
        f32-storage run launches none of the storage and transport
        variants. Returns (counts, value, flat gradient, step s, peak
        bytes)."""
        config.set_state_storage(storage)
        try:
            t0 = time.perf_counter()
            _, want, _ = dry_run_launches(dry)
            dry_s = time.perf_counter() - t0
            ps_ = [p.detach().clone().requires_grad_(True) for p in params]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            loss = run(ps_)
            loss.backward()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            got = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            value = loss.item()
            grad = torch.cat([p.grad.detach().reshape(-1) for p in ps_])
            del loss, ps_
        finally:
            config.set_state_storage("f32")
        launched = {k: v for k, v in got.items() if k.endswith(REDUCED_KEYS) and v}
        log(f"[{tag}] {storage} storage: value_and_grad step {step_s:.4f} s, peak "
            f"{peak / 2**30:.3f} GiB (meta-device dry run {dry_s:.1f} s); value "
            f"{value!r}; storage and transport variants launched "
            f"{json.dumps(launched)}")
        require(got == want, f"[{tag}] {storage} launch counts {got}, want the "
                             f"dry run's {want}")
        require(bool(torch.isfinite(grad).all()), f"[{tag}] non-finite gradient")
        if storage == "f32":
            require(not launched, f"[{tag}] the f32-storage run launched {launched}")
        if ref is not None:
            v32, g32 = ref[0], ref[1].reshape(-1)
            d = (grad - g32).abs() / g32.abs().max().item()
            rms, mx = d.pow(2).mean().sqrt().item(), d.max().item()
            log(f"[{tag}] {storage} vs f32 storage: value {value!r} vs {v32!r} "
                f"(bit-identical: {value == v32}); gradient |g - g32| / max |g32|: "
                f"rms {rms:.3e} (tol {rms_tol:.1e}), max {mx:.3e}")
            require(value == v32, f"[{tag}] the {storage} value moved with the storage")
            require(rms <= rms_tol, f"[{tag}] {storage} gradient outside its bar")
            require(all(got[k] > 0 for k in variants),
                    f"[{tag}] {storage} did not launch {list(variants)}")
        torch.cuda.empty_cache()
        return got, value, grad, step_s, peak

    closed_forms(closed_form, N_QUBITS, "grad")
    kernels_vs_plain(N_QUBITS, "grad")

    # 6. the 29-qubit path: 29 qubits x 100 layers, the bench workload -------
    log_time("[slice29]")
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
                   "high_apply[tc]": LAYERS, "merged_fact_apply": LAYERS,
                   "diag_sweep": 1, "gram": 4})
    with_gram_modes(want29)  # the Grams' [tc]; no adjoint in a forward
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
    want29.update({"dual_apply": LAYERS + 2, "high_apply": LAYERS + 2,
                   "high_apply[tc]": LAYERS + 2, "gram": 4,
                   "block_backward_dual": LAYERS, "block_backward_high": LAYERS,
                   "merged_fact_apply": LAYERS, "block_backward_merged_fact": LAYERS,
                   "diag_sweep": 1, "diag_backward": 1})
    with_gram_modes(want29)
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
    # the 29q x 20L reference of the "bf16" and bf16x3 phases below: f32
    # storage and f32 dots, params from SEED as [grad29]'s (its depth cut to
    # 20 for chip time; 100 layers ran above)
    loss32_value = loss29.item()
    m20 = HardwareEfficientAnsatz(N29, MODES29_L, entangler="cz")
    p20 = m20.init_params(torch.Generator().manual_seed(SEED)).requires_grad_(True)

    def run29(tag: str, storage: str = "f32", dot: str = "f32", warm: bool = True):
        """One value_and_grad of the 29q x 20L model under a storage and a
        forward dot mode (counters set to 0 just before and read just
        after), and with ``warm`` a second, timed one and its peak memory."""
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            p20.grad = None
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            v = m20.magnetization(p20)
            v.backward()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts_ = K.launch_counts()
            g = p20.grad.detach().clone()
            value = v.item()
            del v
            step_s = peak = None
            if warm:
                p20.grad = None
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                v = m20.magnetization(p20)
                v.backward()
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                del v
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")
        require(bool(torch.isfinite(g).all()), f"[{tag}] non-finite gradient")
        log(f"[{tag}] {N29}q x {MODES29_L}L value_and_grad ({storage} storage, {dot} "
            f"forward dots): {first_s:.3f} s (first call)"
            + (f", {step_s:.4f} s warm = {step_s / MODES29_L * 1e3:.2f} ms/layer, peak "
               f"memory {peak / 2**30:.3f} GiB" if warm else "")
            + f"; launches {json.dumps(counts_)}")
        return dict(value=value, grad=g, counts=counts_, step_s=step_s, peak=peak,
                    first_s=first_s)

    def vs_ref(tag: str, run: dict, ref: dict, bars=None):
        """Value (relative) and gradient (rms and max of |g - g32| / max
        |g32|) against the f32 reference, held to ``bars`` = (value, rms)."""
        scale = ref["grad"].abs().max().item()
        d = (run["grad"] - ref["grad"]).abs()
        rel_v = abs(run["value"] - ref["value"]) / abs(ref["value"])
        rms, mx = d.pow(2).mean().sqrt().item() / scale, d.max().item() / scale
        log(f"[{tag}] value {run['value']!r} vs f32 {ref['value']!r} (relative "
            f"{rel_v:.3e}); gradient |g - g32| / max |g32|: rms {rms:.3e}, max "
            f"{mx:.3e}" + (f" (bars: value {bars[0]:.2e}, rms {bars[1]:.2e})"
                           if bars else ""))
        if bars:
            require(rel_v <= bars[0] and rms <= bars[1],
                    f"[{tag}] outside its bars against f32 storage and f32 dots")
        return dict(rel_value=rel_v, rms=rms, max=mx)

    def dry29(storage: str, dot: str = "f32") -> dict:
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            return program_launches(lambda d: HardwareEfficientAnsatz(
                N29, MODES29_L, entangler="cz", device=d), "magnetization")[1]
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")

    def fwd16_run(tag: str, model, p, build, storage: str = "f32",
                  dot: str = "f32", loss: str = "magnetization") -> dict:
        """One value_and_grad of ``model``'s ``loss`` at ``p`` under a storage
        and a forward dot mode (the hpair setting as config has it), the
        counters set to 0 just before and read just after and held to the
        meta-device dry run of ``build`` in the same setting; its time (the
        port compiles nothing: the kernels it runs have launched above) and
        peak memory."""
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            want = program_launches(build, loss)[1]
            q = p.detach().clone().requires_grad_(True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            v = getattr(model, loss)(q)
            v.backward()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            got = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            value, g = v.item(), q.grad.detach().clone()
            del v, q
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")
        log(f"[{tag}] {storage} storage, {dot} forward dots: value_and_grad "
            f"{step_s:.4f} s, peak memory {peak / 2**30:.3f} GiB; value {value!r}; "
            f"launches {json.dumps({k: c for k, c in got.items() if c})}")
        require(got == want, f"[{tag}] launch counts {got}, want the dry run's {want}")
        require(bool(torch.isfinite(g).all()), f"[{tag}] non-finite gradient")
        torch.cuda.empty_cache()
        return dict(value=value, grad=g, counts=got, step_s=step_s, peak=peak)

    log_time("[ref29]")
    ref29 = run29("ref29", warm=True)
    require(ref29["counts"] == dry29("f32"), "[ref29] launch counts differ from "
                                             "the dry run's")
    fwd16_keys = [k for k in ref29["counts"] if k.endswith(("[fwd_bf16]",
                                                            "[fwd_bf16x3]"))]
    require(fwd16_keys and all(ref29["counts"][k] == 0 for k in fwd16_keys),
            "[ref29] the f32 run launched a forward storage or dot-mode variant")

    # [f16_29]: [grad29]'s model and params (29q x 100L) under "f16" cotangent
    # storage: the forward planes stay f32 (the value bit-identical to
    # [grad29]'s), the cotangent planes are f16 with the prescale S = 256,
    # the transports and pair grams bf16x3 (the merged-top transport f32, as
    # the JAX package's planes hands it); one call (the port compiles
    # nothing: its first call is its warm step). At 20 layers the rms error
    # is 2.47e-3 against 2e-3 (PERF.md §6), so this phase keeps its depth.
    log_time("[f16_29]")
    want16 = dict(want29)
    want16.update({"dual_apply[f16]": 2, "high_apply[f16]": 2,
                   "diag_backward[f16]": 1})
    for k in ("block_backward_dual", "block_backward_high",
              "block_backward_merged_fact"):
        want16[f"{k}[f16]"] = want29[k]
    for k in ("block_backward_dual", "block_backward_high"):
        want16[f"{k}[bf16x3]"] = want29[k]
    config.set_state_storage("f16")
    try:
        p29.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss16 = m29.magnetization(p29)
        loss16.backward()
        torch.cuda.synchronize()
        f16_s = time.perf_counter() - t0
        f16_peak = torch.cuda.max_memory_allocated()
        counts16 = K.launch_counts()
        g16 = p29.grad.detach().clone()
        value16 = loss16.item()
        p29.grad = None
        del loss16
    finally:
        config.set_state_storage("f32")
    require(counts16 == want16, f"[f16_29] launch counts {counts16}, want {want16}")
    scale = grad29.abs().max().item()
    d16 = (g16 - grad29).abs()
    rms16, max16 = d16.pow(2).mean().sqrt().item() / scale, d16.max().item() / scale
    log(f"[f16_29] {N29}q x {LAYERS}L value_and_grad under f16 storage: "
        f"{f16_s:.4f} s = {f16_s / LAYERS * 1e3:.2f} ms/layer (f32 storage "
        f"{vg29_s:.4f} s); peak memory {f16_peak / 2**30:.3f} GiB (f32 storage "
        f"{vg29_peak / 2**30:.3f} GiB); launches {json.dumps(counts16)}")
    log(f"[f16_29] value {value16!r} vs f32 storage {loss32_value!r} (bit-identical: "
        f"{value16 == loss32_value}); gradient vs f32 storage: rms |g - g32| / max "
        f"|g32| {rms16:.3e} (tol {F16_29_RMS_TOL:.0e}), max {max16:.3e}")
    require(value16 == loss32_value, "[f16_29] the value moved with the storage")
    require(bool(torch.isfinite(g16).all()) and rms16 <= F16_29_RMS_TOL,
            "[f16_29] gradient outside the f16 storage's error")
    f16_29 = dict(counts=counts16, step_s=f16_s, peak=f16_peak, rms=rms16, max=max16)
    del g16

    # [bf16_29]: "bf16" storage, both plane pairs bf16: the value carries bf16
    # rounding too; the gradient's rms under 2.5 times the JAX package's own
    # error on this model and depth at 14-16q (JAX_OWN_ERR_FWD16, CPU), capped
    # by its own bars; launches equal to the dry run's under "bf16"
    log_time("[bf16_29]")
    bf16r = run29("bf16_29", "bf16")
    require(bf16r["counts"] == dry29("bf16"), "[bf16_29] launch counts differ from "
                                              "the dry run's")
    require(all(bf16r["counts"][f"{k}[fwd_bf16]"] == bf16r["counts"][k] > 0 for k in (
        "dual_apply", "high_apply", "merged_fact_apply", "gram",
        "block_backward_dual", "block_backward_high", "block_backward_merged_fact",
        "diag_sweep", "diag_backward")), "[bf16_29] a kernel ran off its bf16 variant")
    ebf = vs_ref("bf16_29", bf16r, ref29, fwd16_bars("bf16", "f32"))
    bf16_29 = dict(counts=bf16r["counts"], step_s=bf16r["step_s"], peak=bf16r["peak"],
                   **ebf)
    log(f"[bf16_29] step (warm) {bf16r['step_s']:.4f} s against f32 storage "
        f"{ref29['step_s']:.4f} s; peak {bf16r['peak'] / 2**30:.3f} GiB against "
        f"{ref29['peak'] / 2**30:.3f} GiB")

    # [x3_29]: the forward bf16x3 (set_kernel_dot_mode), under "f32" storage
    # and then "bf16", against the same reference; the 29q x 1L closed form
    # under it at the JAX package's bar for bf16x3 (2e-4 max(1, |g|))
    log_time("[x3_29]")
    x3_29 = {}
    for storage in ("f32", "bf16"):
        r = run29(f"x3_29 {storage}", storage, "bf16x3", warm=False)
        require(r["counts"] == dry29(storage, "bf16x3"),
                f"[x3_29] {storage}: launch counts differ from the dry run's")
        require(all(r["counts"][f"{k}[fwd_bf16x3]"] == r["counts"][k] > 0 for k in (
            "dual_apply", "high_apply", "merged_fact_apply", "gram",
            "block_backward_dual", "block_backward_high",
            "block_backward_merged_fact")), f"[x3_29] {storage}: a kernel ran "
                                            "off its bf16x3 variant")
        e = vs_ref(f"x3_29 {storage}", r, ref29, fwd16_bars(storage, "bf16x3"))
        x3_29[storage] = dict(counts=r["counts"], first_s=r["first_s"], **e)
    del m20, p20
    config.set_kernel_dot_mode("bf16x3")
    try:
        closed_form(N29, "x3_29", tol=BF16X3_GRAM_TOL, x3=True)
    finally:
        config.set_kernel_dot_mode("f32")
    torch.cuda.empty_cache()

    # [bf16_30]: HardwareEfficientAnsatz(30, 4, "cz") under "bf16" (the X =
    # 512 seed and the Xt = 4 merged top on bf16 planes) at params = 0: the
    # identity circuit, magnetization 30 within the bf16 value bar, gradient
    # within the gradient bar; its peak memory
    log_time("[bf16_30]")
    config.set_state_storage("bf16")
    try:
        z30 = HardwareEfficientAnsatz(N30, BF16_30_L, entangler="cz")
        pz = torch.zeros(BF16_30_L, N30, 3, device=dev, requires_grad=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        vz = z30.magnetization(pz)
        vz.backward()
        torch.cuda.synchronize()
        cz30 = K.launch_counts()
        peak30 = torch.cuda.max_memory_allocated()
        gz = pz.grad.abs().max().item()
        value30 = vz.item()
    finally:
        config.set_state_storage("f32")
    vbar, gbar = FWD16_JAX_BARS[0], FWD16_JAX_BARS[1]
    log(f"[bf16_30] {N30}q x {BF16_30_L}L params = 0 under bf16 storage: "
        f"magnetization {value30!r} (want {N30}); |grad| max {gz:.3e}; peak memory "
        f"{peak30 / 2**30:.3f} GiB; launches {json.dumps(cz30)}")
    require(abs(value30 - N30) <= vbar * N30 and gz <= gbar,
            "[bf16_30] the params = 0 known answer failed")
    require(cz30["block_backward_merged_fact[fwd_bf16]"] == BF16_30_L
            and cz30["high_apply[fwd_bf16]"] >= 1,
            f"[bf16_30] did not run the bf16 variants at Xt = 4: {cz30}")
    bf16_30 = dict(counts=cz30, peak=peak30)
    del z30, pz, vz
    torch.cuda.empty_cache()

    # [cz_bf16_small]: HardwareEfficientAnsatz(n, 4, "cz") at n = 20 (group 2
    # at X = 64) and 27 (group 3 at X = 64) under "bf16" and under the forward
    # bf16x3 on f32 planes, against the f32 run on the same params: value and
    # gradient rms within 2.5 times the JAX package's own error on the same
    # model and depth at 14-17q (JAX_OWN_RINGS), launches equal to the dry
    # run's, the X = 8..64 variants launched
    log_time("[cz_bf16_small]")
    cz_small = {}
    for n in CZ_SMALL_NS:
        build = lambda d, n=n: HardwareEfficientAnsatz(n, CZ_SMALL_L,  # noqa: E731
                                                       entangler="cz", device=d)
        model = build(dev)
        p = model.init_params(torch.Generator().manual_seed(SEED + n))
        ref = fwd16_run(f"cz_bf16_small {n}q", model, p, build)
        for storage, dot, mode in (("bf16", "f32", "fwd_bf16"),
                                   ("f32", "bf16x3", "fwd_bf16x3")):
            tag = f"cz_bf16_small {n}q {storage}+{dot}"
            r = fwd16_run(tag, model, p, build, storage, dot)
            e = vs_ref(tag, r, ref, own_bars(JAX_OWN_RINGS["cz", CZ_SMALL_L, storage, dot]))
            require(all(r["counts"][f"{k}[{mode}]"] == r["counts"][k] > 0 for k in (
                "high_apply", "gram", "block_backward_high")),
                f"[{tag}] a high kernel ran off its {mode} variant")
            cz_small[n, storage, dot] = dict(counts=r["counts"], step_s=r["step_s"], **e)
        del model, p, ref
        torch.cuda.empty_cache()

    # [cz_f32_small]: HardwareEfficientAnsatz(n, 4, "cz") on f32 planes at n =
    # 20 (group 2 at X = 64) and 25 (group 3 at X = 16): the high adjoint's
    # small-X step inside a model, the kernels against the plain path
    # (densities within SLICE_TOL, gradients within MODEL_GRAD_TOL of
    # max(1, |g|)), launches equal to the dry run's, every high adjoint
    # launch counted "tc"
    log_time("[cz_f32_small]")
    cz_f32_small = {}
    for n in CZ_F32_SMALL_NS:
        build = lambda d, n=n: HardwareEfficientAnsatz(n, CZ_SMALL_L,  # noqa: E731
                                                       entangler="cz", device=d)
        model = build(dev)
        p = model.init_params(torch.Generator().manual_seed(SEED + 2 * n))
        r = fwd16_run(f"cz_f32_small {n}q", model, p, build)
        c = r["counts"]
        require(c["block_backward_high"] > 0
                and c["block_backward_high[tc]"] == c["block_backward_high"],
                f"[cz_f32_small {n}q] the high adjoint ran off the tensor cores: {c}")
        d_err = (torch.stack(model.densities(p)) - torch.stack(
            model.densities(p, kernels=K.PLAIN))).abs().max().item()
        q = p.detach().clone().requires_grad_(True)
        model.magnetization(q, kernels=K.PLAIN).backward()
        g_err = ((r["grad"] - q.grad).abs() / q.grad.abs().clamp(min=1.0)).max().item()
        log(f"[cz_f32_small {n}q] kernels vs plain path: max abs density err "
            f"{d_err:.3e} (tol {SLICE_TOL:.0e}); gradient err / max(1, |g|) "
            f"{g_err:.3e} (tol {MODEL_GRAD_TOL:.0e}); value_and_grad {r['step_s']:.4f} s")
        require(d_err <= SLICE_TOL and g_err <= MODEL_GRAD_TOL,
                f"[cz_f32_small {n}q] the kernels disagree with the plain path")
        cz_f32_small[n] = dict(counts=c, d_err=d_err, g_err=g_err)
        del model, p, r, q
        torch.cuda.empty_cache()

    # the step runs the default bf16x3 pair grams (the rows "gram_bf16x3"
    # above); the f32-gram rows beside them give the same step with f32 grams
    seeds29_ms = (per_launch["diag_backward", "29q"]
                  + 2 * per_launch["dual_apply", "29q_seed"]
                  + per_launch["high_apply", "29q_X128_seed"]
                  + per_launch["high_apply", "X256_seed"])
    bwd29_ms = seeds29_ms + LAYERS * (
        per_launch["block_backward_dual", "29q_gram_bf16x3_g0_first_diag_first"]
        + per_launch["block_backward_high", "29q_X128_gram_bf16x3"]
        + per_launch["block_backward_merged_fact", "Xt2_gram_bf16x3"])
    bwd29_f32_ms = seeds29_ms + LAYERS * (
        per_launch["block_backward_dual", "29q_g0_first_diag_first"]
        + per_launch["block_backward_high", "29q_X128_plain"]
        + per_launch["block_backward_merged_fact", "Xt2"])
    log(f"[grad29] kernel time per step (launches x per-launch ms above): forward "
        f"{fwd29_ms:.1f} ms + seeds and backward {bwd29_ms:.1f} ms (bf16x3 pair "
        f"grams; {bwd29_f32_ms:.1f} ms with the f32-gram rows) = "
        f"{100 * (fwd29_ms + bwd29_ms) / (vg29_s * 1e3):.1f}% of the step")
    del m29, p29, grad29, loss29
    torch.cuda.empty_cache()

    closed_forms(closed_form, N29, "grad29")
    closed_forms(closed_form, N30, "grad29")
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

    # [storage29]: HardwareEfficientAnsatz(29, 4, "cz") under "mixed" and
    # "f16" against f32 storage on the same params: values bit-identical,
    # gradients within the storage's error, launches per kernel and mode
    # equal to the port's dispatch of the same model on the meta device; the
    # f32-storage run launches none of the storage or transport variants
    m4 = HardwareEfficientAnsatz(N29, STORAGE_L, entangler="cz")
    p4 = m4.init_params(torch.Generator().manual_seed(SEED + 2))
    st_runs = {}
    for storage in ("f32", "mixed", "f16"):
        config.set_state_storage(storage)
        try:
            _, want_vg, _ = program_launches(
                lambda d: HardwareEfficientAnsatz(N29, STORAGE_L, entangler="cz",
                                                  device=d), "magnetization")
            p = p4.clone().requires_grad_(True)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            v = m4.magnetization(p)
            v.backward()
            torch.cuda.synchronize()
            got = K.launch_counts()
        finally:
            config.set_state_storage("f32")
        require(got == want_vg, f"[storage29] {storage} launch counts {got}, "
                                f"want the dry run's {want_vg}")
        st_runs[storage] = (v.item(), p.grad.detach().clone(), got)
        del p, v
    v32, g32, c32 = st_runs["f32"]
    new_variants = [k for k in c32 if k.endswith(("[bf16]", "[f16]", "[bf16x3]"))]
    require(all(c32[k] == 0 for k in new_variants),
            "[storage29] the f32-storage run launched a storage variant")
    for storage in ("mixed", "f16"):
        v, g, c = st_runs[storage]
        d = (g - g32).abs() / g32.abs().max().item()
        rel, rms = d.max().item(), d.pow(2).mean().sqrt().item()
        tag = "bf16" if storage == "mixed" else "f16"
        launched = {k: c[k] for k in c if k.endswith((f"[{tag}]", "[bf16x3]")) and c[k]}
        log(f"[storage29] {N29}q x {STORAGE_L}L {storage}: value {v!r} vs f32 "
            f"{v32!r}; gradient |g - g32| / max |g32|: rms {rms:.3e} (tol "
            f"{STORAGE29_TOL[storage]:.0e}), max {rel:.3e}; variants launched "
            f"{json.dumps(launched)}")
        require(v == v32, f"[storage29] the {storage} value moved with the storage")
        require(rms <= STORAGE29_TOL[storage], f"[storage29] {storage} gradient error")
        require(all(c[f"{k}[{tag}]"] == c[k] and c[k] > 0 for k in (
            "block_backward_dual", "block_backward_high",
            "block_backward_merged_fact", "diag_backward")),
            f"[storage29] {storage} did not run the backward kernels' {tag} variants")
    storage29 = {s_: st_runs[s_][2] for s_ in st_runs}
    del m4, p4, st_runs, g32
    torch.cuda.empty_cache()

    # [f16_30]: HardwareEfficientAnsatz(30, 20, "cz") under "f16", the JAX
    # package's 30-qubit bench line with its depth cut for chip time: warm
    # value_and_grad and forward steps and peak memory (8 GiB of f32 forward
    # planes beside 4 GiB of f16 cotangent planes); params = 0; the 30q x 1L
    # closed form under f16
    config.set_state_storage("f16")
    try:
        m30 = HardwareEfficientAnsatz(N30, F16_L, entangler="cz")
        p30 = m30.init_params(torch.Generator().manual_seed(SEED)).requires_grad_(True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        l30 = m30.magnetization(p30)
        l30.backward()
        torch.cuda.synchronize()
        f30_first_s = time.perf_counter() - t0
        c30 = K.launch_counts()
        require(c30["block_backward_dual[f16]"] == c30["block_backward_dual"] > 0
                and c30["block_backward_merged_fact[f16]"] == F16_L,
                f"[f16_30] did not run the f16 variants: {c30}")
        require(bool(torch.isfinite(p30.grad).all()), "[f16_30] non-finite gradient")
        p30.grad = None
        del l30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        l30 = m30.magnetization(p30)
        l30.backward()
        torch.cuda.synchronize()
        f30_s = time.perf_counter() - t0
        f30_peak = torch.cuda.max_memory_allocated()
        v30 = l30.item()
        del l30
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m30.magnetization(p30).item()
            f30_fwd_s = time.perf_counter() - t0
            f30_fwd_peak = torch.cuda.max_memory_allocated()
        log(f"[f16_30] {N30}q x {F16_L}L under f16 storage: value {v30:.6f}; "
            f"value_and_grad {f30_first_s:.3f} s (first call), {f30_s:.4f} s warm = "
            f"{f30_s / F16_L * 1e3:.2f} ms/layer, peak memory {f30_peak / 2**30:.3f} "
            f"GiB; forward step (warm) {f30_fwd_s:.4f} s, peak {f30_fwd_peak / 2**30:.3f} "
            f"GiB; launches {json.dumps(c30)}")
        del p30, m30
        torch.cuda.empty_cache()
        z30 = HardwareEfficientAnsatz(N30, F16_L, entangler="cz")
        pz = torch.zeros(F16_L, N30, 3, device=dev, requires_grad=True)
        vz = z30.magnetization(pz)
        vz.backward()
        gz = pz.grad.abs().max().item()
        log(f"[f16_30] {N30}q x {F16_L}L params = 0: magnetization {vz.item()!r} "
            f"(want {N30}); |grad| max {gz:.3e}")
        require(abs(vz.item() - N30) <= ZERO_TOL * N30 and gz <= ZERO_TOL,
                "[f16_30] the params = 0 known answer failed")
        del z30, pz, vz
        torch.cuda.empty_cache()
        closed_form(N30, "f16_30", tol=F16_CLOSED_TOL, x3=True)
    finally:
        config.set_state_storage("f32")
    f16_30 = dict(counts=c30, step_s=f30_s, fwd_s=f30_fwd_s, peak=f30_peak)
    torch.cuda.empty_cache()

    # 7. the CNOT ring: 29 qubits x 20 layers ---------------------------------
    log_time("[cnot29]")
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
    # every high apply (the X = 8 span views too) runs on the tensor cores
    for want_, step_ in ((want_fwd, fwd_step), (want_vg, vg_step)):
        want_["high_apply[tc]"] = sum(k == "high_apply" for k, _ in step_)
    # so do the multi-term applies, the high adjoints, the X = 8 span
    # views' too, and the Grams
    with_gram_modes(want_fwd)
    with_gram_modes(want_vg)
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
    # [cnot29_f16]: the same model and params under "f16": the multi-term
    # applies in place on the f16 cotangent (the CNOTs' transports), the
    # sublane adjoint with the bf16x3 transport
    log_time("[cnot29_f16]")
    cnot16 = storage_phase(
        "cnot29_f16", lambda ps_: mc.magnetization(ps_[0]), [pc], "f16",
        model_dry_run(lambda d: HardwareEfficientAnsatz(
            N29, CNOT_LAYERS, entangler="cnot", device=d), "magnetization"),
        ref=(lossc.item(), gradc), rms_tol=reduced_tol("cnot", "f16"),
        variants=("dual_multi_apply[f16]", "high_multi_apply[f16]",
                  "block_backward_sublane[f16]", "block_backward_sublane[bf16x3]"))
    log(f"[cnot29_f16] value_and_grad step {cnot16[3]:.4f} s against f32 storage's "
        f"{vgc_s:.4f} s; peak {cnot16[4] / 2**30:.3f} GiB against "
        f"{vgc_peak / 2**30:.3f} GiB")
    # [cnot29_bf16]: the same model and params under "bf16" (the multi-term
    # applies in place on bf16 F and B, the X = 8 span views, the sublane
    # adjoint on bf16 F), one step (the port compiles nothing), against the
    # f32 run's value and gradient above; then the forward bf16x3 on f32 and
    # bf16 planes at 29q x CNOT_X3_L, against an f32 run there
    log_time("[cnot29_bf16]")
    cbuild = lambda d: HardwareEfficientAnsatz(N29, CNOT_LAYERS,  # noqa: E731
                                               entangler="cnot", device=d)
    cb = fwd16_run("cnot29_bf16", mc, pc, cbuild, "bf16")
    # 2.5 times the JAX package's own error, uncapped: its own rms on this
    # model (4.6e-3 at 15q) is 93% of the "bf16" cap, which then no longer
    # tells a fault from the storage
    ecb = vs_ref("cnot29_bf16", cb, dict(value=lossc.item(), grad=gradc),
                 tuple(2.5 * o for o in JAX_OWN_RINGS["cnot", CNOT_LAYERS, "bf16", "f32"]))
    require(all(cb["counts"][f"{k}[bf16]"] == cb["counts"][k] > 0 for k in (
        "dual_multi_apply", "high_multi_apply", "block_backward_sublane"))
        and cb["counts"]["block_backward_sublane[fwd_bf16]"] > 0
        and cb["counts"]["high_apply[fwd_bf16]"] == cb["counts"]["high_apply"],
        "[cnot29_bf16] a kernel ran off its bf16 variant")
    log(f"[cnot29_bf16] value_and_grad {cb['step_s']:.4f} s against f32's {vgc_s:.4f} "
        f"s; peak {cb['peak'] / 2**30:.3f} GiB against {vgc_peak / 2**30:.3f} GiB")
    cnot29_bf16 = dict(counts=cb["counts"], step_s=cb["step_s"], peak=cb["peak"], **ecb)
    del mc, pc, gradc, lossc, cb
    torch.cuda.empty_cache()
    c4build = lambda d: HardwareEfficientAnsatz(N29, CNOT_X3_L,  # noqa: E731
                                                entangler="cnot", device=d)
    mc4 = c4build(dev)
    pc4 = mc4.init_params(torch.Generator().manual_seed(SEED))
    cref4 = fwd16_run("cnot29_x3 f32", mc4, pc4, c4build)
    cnot29_x3 = {}
    for storage in ("f32", "bf16"):
        tag = f"cnot29_x3 {storage}+bf16x3"
        r = fwd16_run(tag, mc4, pc4, c4build, storage, "bf16x3")
        e = vs_ref(tag, r, cref4, own_bars(JAX_OWN_RINGS["cnot", CNOT_X3_L, storage,
                                                         "bf16x3"]))
        require(all(r["counts"][f"{k}[fwd_bf16x3]"] == r["counts"][k] > 0 for k in (
            "dual_multi_apply", "high_multi_apply", "block_backward_sublane")),
            f"[{tag}] a kernel ran off its bf16x3 variant")
        cnot29_x3[storage] = dict(counts=r["counts"], step_s=r["step_s"], **e)
    del mc4, pc4, cref4
    torch.cuda.empty_cache()

    def cnot_closed_form(n: int, x3: bool = False) -> None:
        """n x 1L at params (alpha, 0, 0): the ring's CNOTs (control first)
        give <Z_k> = prod_{j <= k} cos alpha_j for k < n - 1, and the
        closing CNOT <Z_{n-1}> = prod_{j >= 1} cos alpha_j; the beta and
        gamma gradients are 0."""
        a_tol = max(CNOT_CLOSED_TOL, BF16X3_GRAM_TOL) if x3 else CNOT_CLOSED_TOL
        z_tol = max(ZERO_GRAD_TOL, BF16X3_GRAM_TOL) if x3 else ZERO_GRAD_TOL
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
        log(f"[cnot29] {n}q x 1L cnot closed form ({config.gram_kernel_dot_mode()} "
            f"pair grams): value err {val_err:.3e} (tol {CLOSED_TOL * n:.1e}), alpha "
            f"gradient err {a_err:.3e} (tol {a_tol:.0e}), |beta, gamma gradient| max "
            f"{bg:.3e} (tol {z_tol:.0e})")
        require(val_err <= CLOSED_TOL * n and a_err <= a_tol and bg <= z_tol,
                f"the {n}-qubit 1-layer CNOT closed form failed")
        torch.cuda.empty_cache()

    closed_forms(cnot_closed_form, N29)
    closed_forms(cnot_closed_form, N30)
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
    log_time("[vqe26]")
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
                   counts=got_vg, counts_fwd=got_fwd, dens=D, grad=grad,
                   value_vg=loss.item())
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

    # [vqe29_f16], [qaoa29_f16]: the same models and params under "f16": the
    # cross-group density seeds (the multi-term applies, the X = 8 span
    # seeds) create and accumulate f16 cotangent planes
    def reduced_model(tag, key, build, loss, ref, storage, variants):
        model = build(dev)
        p = model.init_params(torch.Generator().manual_seed(SEED))
        out = storage_phase(tag, lambda ps_: getattr(model, loss)(ps_[0]), [p],
                            storage, model_dry_run(build, loss),
                            ref=(ref["value_vg"], ref["grad"]),
                            rms_tol=reduced_tol(key, storage),
                            variants=variants)
        log(f"[{tag}] value_and_grad step {out[3]:.4f} s against f32 storage's "
            f"{ref['vg_s']:.4f} s; peak {out[4] / 2**30:.3f} GiB against "
            f"{ref['vg_peak'] / 2**30:.3f} GiB")
        return out

    seeds16 = ("dual_multi_apply[f16]", "high_multi_apply[f16]", "high_apply[f16]",
               "block_backward_dual[f16]")
    reduced_model("vqe29_f16", "vqe", lambda d: VQEIsing(N29, VQE_LAYERS, device=d),
                  "energy", vqe29, "f16", seeds16)
    reduced_model(
        "qaoa29_f16", "qaoa",
        lambda d: QAOAMaxCut(N29, graph, layers_number=QAOA_LAYERS, device=d),
        "loss", qaoa29, "f16", seeds16)

    def vqe_closed_form(n: int, x3: bool = False) -> None:
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
        g_tol = VQE_GRAD_TOL * n
        if x3:
            g_tol = max(g_tol, BF16X3_GRAM_TOL * max(1.0, abs(s4)))
        log(f"[vqe29] {n}q x 1L closed form ({config.gram_kernel_dot_mode()} pair "
            f"grams): value err {val_err:.3e} (tol {VQE_VALUE_TOL * n:.1e}), "
            f"gradient err {g_err:.3e} (tol {g_tol:.1e}) vs 2 n sin(4 gamma) = {s4:.4f}")
        require(val_err <= VQE_VALUE_TOL * n and g_err <= g_tol,
                f"the {n}-qubit VQE closed form failed")
        torch.cuda.empty_cache()

    closed_forms(vqe_closed_form, N29)
    closed_forms(vqe_closed_form, N30)
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
    log_time("[tape29]")
    from dqc_tpu_torch import GHZ, QFT, AutoGradCircuit
    from dqc_tpu_torch.circuit.builder import autodiff_densities
    from dqc_tpu_torch.circuit.fused_autograd import fused_tape_forward
    from dqc_tpu_torch.circuit.fusion import fuse_tape

    def tsallis(dens):
        return torch.stack([1 - torch.einsum("ij,ji->", d, d).real
                            for d in dens]).mean()

    kernel_names = our_kernel_names()

    def tape_dry(ftape, vg_np, cg):
        """The run of dry_run_launches for a tape: its tsallis loss through
        plane_tape_forward on the meta device."""
        def dry(kernels):
            tv = [torch.tensor(g).to("meta").requires_grad_(True) for g in vg_np]
            state = torch.zeros(1 << ftape.n, dtype=torch.complex64, device="meta")
            return tsallis(ps.plane_tape_forward(ftape, state, tv, cg,
                                                 kernels=kernels))
        return dry

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

        want_fwd, want_vg, vg_calls = dry_run_launches(tape_dry(ftape, vg_np, cg))
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
        loss = tsallis(autodiff_run(tv, cg))
        loss.backward()
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t0
        vg_peak = torch.cuda.max_memory_allocated()
        value_vg = loss.item()
        del loss
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
                    simple_autodiff=circuit.build(), value_vg=value_vg,
                    vg_peak=vg_peak)

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
    # [tape29_f16]: the same tape and gates through autodiff_run under "f16":
    # the lane and sublane adjoints, the cross-gate transports and the seeds
    # on f16 cotangent planes
    tape_run = t29["simple_autodiff"][1]
    t_vg = [torch.tensor(g, device=dev) for g in t29["vg"]]
    tape16 = storage_phase(
        "tape29_f16", lambda ps_: tsallis(tape_run(ps_, t29["cg"])), t_vg, "f16",
        tape_dry(t29["ftape"], t29["vg"], t29["cg"]),
        ref=(t29["value_vg"], torch.cat([g.reshape(-1) for g in t29["grads"]])),
        rms_tol=reduced_tol("tape", "f16"),
        variants=("block_backward_lane[f16]", "block_backward_lane[bf16x3]",
                  "block_backward_sublane[f16]", "dual_multi_apply[f16]"))
    log(f"[tape29_f16] value_and_grad step {tape16[3]:.4f} s against f32 storage's "
        f"{t29['vg_s']:.4f} s; peak {tape16[4] / 2**30:.3f} GiB against "
        f"{t29['vg_peak'] / 2**30:.3f} GiB")
    del t_vg
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
    dq = diag_q_tape(AutoGradCircuit(N_DQ), N_DQ)
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
    log_time("[hpair29]")
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
        closed_forms(closed_form, N29, "hpair29")
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

    # [hpair29_bf16]: cz 29q x HPAIR_BF16_L with the hpair expanded (the
    # X = 256 in-place apply and adjoint on bf16 planes), under "bf16" and
    # under the forward bf16x3, against the f32 factorized run on the same
    # params within [cz_bf16_small]'s bars; the "bf16" expanded run also
    # against the "bf16" factorized one
    log_time("[hpair29_bf16]")
    hbuild = lambda d: HardwareEfficientAnsatz(N29, HPAIR_BF16_L,  # noqa: E731
                                               entangler="cz", device=d)
    hm = hbuild(dev)
    hpp = hm.init_params(torch.Generator().manual_seed(SEED + 5))
    href = fwd16_run("hpair29_bf16 factorized f32", hm, hpp, hbuild)
    hfact = fwd16_run("hpair29_bf16 factorized bf16", hm, hpp, hbuild, "bf16")
    hpair29_bf16 = {}
    for storage, dot, mode in (("bf16", "f32", "fwd_bf16"), ("f32", "bf16x3", "fwd_bf16x3")):
        tag = f"hpair29_bf16 expanded {storage}+{dot}"
        config.set_hpair_factorized(False)
        try:
            r = fwd16_run(tag, hm, hpp, hbuild, storage, dot)
        finally:
            config.set_hpair_factorized(True)
        e = vs_ref(tag, r, href, own_bars(JAX_OWN_RINGS["cz", CZ_SMALL_L, storage, dot]))
        require(wide_counts(r["counts"]) == (HPAIR_BF16_L, HPAIR_BF16_L)
                and r["counts"][f"high_apply[{mode}]"] == r["counts"]["high_apply"]
                and r["counts"][f"block_backward_high[{mode}]"]
                == r["counts"]["block_backward_high"],
                f"[{tag}] did not run the expanded sweep on its {mode} variants")
        hpair29_bf16[storage, dot] = dict(counts=r["counts"], step_s=r["step_s"],
                                          peak=r["peak"], **e)
        if storage == "bf16":
            hpair29_bf16["vs_factorized"] = vs_ref(
                "hpair29_bf16 expanded vs factorized under bf16", r, hfact,
                own_bars(JAX_OWN_RINGS["cz", CZ_SMALL_L, "bf16", "f32"]))
    del hm, hpp, href, hfact
    torch.cuda.empty_cache()

    # [cnot30_bf16]: HardwareEfficientAnsatz(30, 2, "cnot") under "bf16" at
    # params = 0 (the identity circuit): its lone 2-bit top-group block at
    # X = 512 both ways on bf16 planes; n within 2e-3 n, |grad| <= 5e-3 (as
    # [bf16_30]), the counters held to the dry run, peak memory
    log_time("[cnot30_bf16]")
    c30build = lambda d: HardwareEfficientAnsatz(N30, CNOT30_L,  # noqa: E731
                                                 entangler="cnot", device=d)
    c30 = fwd16_run("cnot30_bf16", c30build(dev), torch.zeros(CNOT30_L, N30, 3, device=dev),
                    c30build, "bf16")
    g30 = c30["grad"].abs().max().item()
    log(f"[cnot30_bf16] {N30}q x {CNOT30_L}L params = 0 under bf16: magnetization "
        f"{c30['value']!r} (want {N30}); |grad| max {g30:.3e}; peak memory "
        f"{c30['peak'] / 2**30:.3f} GiB")
    require(abs(c30["value"] - N30) <= FWD16_JAX_BARS[0] * N30
            and g30 <= FWD16_JAX_BARS[1], "[cnot30_bf16] the params = 0 known answer failed")
    require(wide_counts(c30["counts"]) == (CNOT30_L, CNOT30_L)
            and c30["counts"]["block_backward_high[fwd_bf16]"]
            == c30["counts"]["block_backward_high"],
            f"[cnot30_bf16] did not run the X = 512 block on bf16 planes: {c30['counts']}")
    cnot30_bf16 = dict(counts=c30["counts"], peak=c30["peak"], step_s=c30["step_s"])
    del c30
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

    # [paths29_mixed]: the CNOT ring, VQE, QAOA and the gauntlet tape under
    # "mixed" against f32 storage on the same params (cut to a few layers for
    # chip time), and the X = 256 wide adjoint: HardwareEfficientAnsatz(29,
    # 4, "cz") with the hpair expanded, under "mixed" and "f16". Every run's
    # counters held to its dry run under its storage; the f32 runs launch
    # none of the storage or transport variants
    log_time("[paths29_mixed]")
    paths = {}
    paths_f32 = {}   # the f32 runs [paths29_bf16] holds its settings against
    for tag, build, loss, storages, variants in (
            ("cnot", lambda d: HardwareEfficientAnsatz(N29, PATHS_L["cnot"],
                                                       entangler="cnot", device=d),
             "magnetization", ("mixed",),
             ("dual_multi_apply[bf16]", "high_multi_apply[bf16]",
              "block_backward_sublane[bf16]")),
            ("vqe", lambda d: VQEIsing(N29, PATHS_L["vqe"], device=d), "energy",
             ("mixed",), ("dual_multi_apply[bf16]", "high_multi_apply[bf16]")),
            ("qaoa", lambda d: QAOAMaxCut(N29, graph, layers_number=PATHS_L["qaoa"],
                                          scan=True, device=d), "loss", ("mixed",),
             ("dual_multi_apply[bf16]", "high_multi_apply[bf16]")),
            ("hpair", lambda d: HardwareEfficientAnsatz(N29, PATHS_L["hpair"],
                                                        entangler="cz", device=d),
             "magnetization", ("mixed", "f16"), ("block_backward_high[wide]",))):
        config.set_hpair_factorized(tag != "hpair")
        try:
            model = build(dev)
            p = model.init_params(torch.Generator().manual_seed(SEED + 4))
            run = lambda ps_, m=model, l=loss: getattr(m, l)(ps_[0])  # noqa: E731
            dry = model_dry_run(build, loss)
            _, v32, g32, _, _ = storage_phase(f"paths29_mixed {tag}", run, [p],
                                                "f32", dry)
            if tag in ("vqe", "qaoa"):
                paths_f32[tag] = dict(model=model, p=p, value=v32, grad=g32,
                                      build=build, loss=loss)
            for storage in storages:
                key = "bf16" if storage == "mixed" else "f16"
                paths[tag, storage] = storage_phase(
                    f"paths29_mixed {tag}", run, [p], storage, dry, ref=(v32, g32),
                    rms_tol=reduced_tol(tag, storage),
                    variants=variants + (f"block_backward_high[{key}]",)
                    if tag == "hpair" else variants)[0]
        finally:
            config.set_hpair_factorized(True)
        del model, p, g32
        torch.cuda.empty_cache()
    _, tape_run = gcirc.build()
    t_vg = [torch.tensor(g, device=dev) for g in t29["vg"]]
    paths["tape", "mixed"] = storage_phase(
        "paths29_mixed tape", lambda ps_: tsallis(tape_run(ps_, t29["cg"])), t_vg,
        "mixed", tape_dry(t29["ftape"], t29["vg"], t29["cg"]),
        ref=(t29["value_vg"], torch.cat([g.reshape(-1) for g in t29["grads"]])),
        rms_tol=reduced_tol("tape", "mixed"),
        variants=("block_backward_lane[bf16]", "block_backward_sublane[bf16]"))[0]
    del t_vg
    torch.cuda.empty_cache()

    # [paths29_bf16]: [paths29_mixed]'s VQE and QAOA and [tape29]'s tape, on
    # their models and params, under "bf16", f32 + bf16x3 and bf16 + bf16x3,
    # each against its own f32 run (the runs above); the [diagq] tape (the
    # diag adjoint's Q) under "bf16". Counts equal to the dry run; value and
    # gradient rms within own_bars of the JAX package's own error on the
    # same model at 14-17q (JAX_OWN_PATHS); every launch of the adjoints
    # with a run's Q or the lane adjoint in the setting's variants.
    log_time("[paths29_bf16]")

    def fwd16_phase(tag, run, params, storage, dot, dry, ref, bars, want_modes):
        """One value_and_grad of ``run(params)`` (a scalar loss of a list of
        tensors) in a setting, the counters set to 0 just before and read
        just after and held to the meta-device dry run ``dry`` in the same
        setting; against ``ref`` = (value, flat gradient) of the f32 run
        within ``bars`` = (value relative, gradient rms of max |g32|);
        ``want_modes``: counters that must equal their kernel's launches
        and be positive, or (a name alone) be positive."""
        config.set_state_storage(storage)
        config.set_kernel_dot_mode(dot)
        try:
            _, want, _ = dry_run_launches(dry)
            ps_ = [q.detach().clone().requires_grad_(True) for q in params]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            loss = run(ps_)
            loss.backward()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            got = K.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            value = loss.item()
            grad = torch.cat([q.grad.detach().reshape(-1) for q in ps_])
            del loss, ps_
        finally:
            config.set_state_storage("f32")
            config.set_kernel_dot_mode("f32")
        v32, g32 = ref[0], ref[1].reshape(-1)
        d = (grad - g32).abs() / g32.abs().max().item()
        rel_v = abs(value - v32) / abs(v32)
        rms, mx = d.pow(2).mean().sqrt().item(), d.max().item()
        log(f"[{tag}] {storage} storage, {dot} forward dots: value_and_grad "
            f"{step_s:.4f} s, peak {peak / 2**30:.3f} GiB; value {value!r} vs f32 "
            f"{v32!r} (relative {rel_v:.3e}, bar {bars[0]:.2e}); gradient |g - g32| "
            f"/ max |g32|: rms {rms:.3e} (bar {bars[1]:.2e}), max {mx:.3e}; launches "
            f"{json.dumps({k: c for k, c in got.items() if c})}")
        require(got == want, f"[{tag}] {storage}+{dot} launch counts {got}, want "
                             f"the dry run's {want}")
        require(bool(torch.isfinite(grad).all()), f"[{tag}] non-finite gradient")
        require(rel_v <= bars[0] and rms <= bars[1],
                f"[{tag}] {storage}+{dot} outside its bars against its f32 run")
        for k in want_modes:
            kernel = k.split("[")[0]
            require(got[k] > 0 and (kernel == k or "[fwd" not in k
                                    or got[k] == got[kernel]),
                    f"[{tag}] {storage}+{dot}: {k} launched {got[k]} times of "
                    f"{got[kernel]}")
        torch.cuda.empty_cache()
        return dict(counts=got, step_s=step_s, peak=peak, rel_value=rel_v, rms=rms,
                    max=mx)

    FWD16_SETTINGS = (("bf16", "f32", "fwd_bf16"), ("f32", "bf16x3", "fwd_bf16x3"),
                      ("bf16", "bf16x3", "fwd_bf16x3"))
    paths_bf16 = {}
    for tag in ("vqe", "qaoa"):
        r = paths_f32[tag]
        run = lambda ps_, m=r["model"], l=r["loss"]: getattr(m, l)(ps_[0])  # noqa: E731
        for storage, dot, mode in FWD16_SETTINGS:
            paths_bf16[tag, storage, dot] = fwd16_phase(
                f"paths29_bf16 {tag}", run, [r["p"]], storage, dot,
                model_dry_run(r["build"], r["loss"]), (r["value"], r["grad"]),
                own_bars(JAX_OWN_PATHS[tag, PATHS_L[tag], storage, dot]),
                ("block_backward_dual[diag_q]", f"block_backward_dual[{mode}]"))
    del paths_f32
    t_vg = [torch.tensor(g, device=dev) for g in t29["vg"]]
    for storage, dot, mode in FWD16_SETTINGS:
        paths_bf16["tape", storage, dot] = fwd16_phase(
            "paths29_bf16 tape", lambda ps_: tsallis(tape_run(ps_, t29["cg"])), t_vg,
            storage, dot, tape_dry(t29["ftape"], t29["vg"], t29["cg"]),
            (t29["value_vg"], torch.cat([g.reshape(-1) for g in t29["grads"]])),
            own_bars(JAX_OWN_PATHS["tape", TAPE_LAYERS, storage, dot]),
            (f"block_backward_lane[{mode}]", "block_backward_high[diag_q]",
             f"block_backward_high[{mode}]", "block_backward_dual[diag_q]"))
    del t_vg
    _, dq_run = dq.build()
    dq_vg = [torch.tensor(g, device=dev) for g in tdq["vg"]]
    paths_bf16["diagq", "bf16", "f32"] = fwd16_phase(
        "paths29_bf16 diagq", lambda ps_: tsallis(dq_run(ps_, tdq["cg"])), dq_vg,
        "bf16", "f32", tape_dry(tdq["ftape"], tdq["vg"], tdq["cg"]),
        (tdq["value_vg"], torch.cat([g.reshape(-1) for g in tdq["grads"]])),
        own_bars(JAX_OWN_PATHS["diagq", 1, "bf16", "f32"]),
        ("diag_backward[with_q]", "diag_backward[fwd_bf16]"))
    del dq_vg, dq_run
    torch.cuda.empty_cache()

    # [vqe_bf16_small]: VQEIsing(20, 2) and VQEIsing(27, 2) (the high adjoint
    # at X = 64 beside the dual adjoint with the runs' Q: group 2 at 20q,
    # group 3 at 27q) under "bf16" and f32 + bf16x3 against their f32 runs
    log_time("[vqe_bf16_small]")
    vqe_small = {}
    for n in VQE_SMALL_NS:
        build = lambda d, n=n: VQEIsing(n, VQE_SMALL_L, scan=True,  # noqa: E731
                                         device=d)
        model = build(dev)
        p = model.init_params(torch.Generator().manual_seed(SEED + n))
        ref = fwd16_run(f"vqe_bf16_small {n}q", model, p, build, loss="energy")
        for storage, dot, mode in FWD16_SETTINGS[:2]:
            tag = f"vqe_bf16_small {n}q {storage}+{dot}"
            r = fwd16_run(tag, model, p, build, storage, dot, loss="energy")
            e = vs_ref(tag, r, ref, own_bars(JAX_OWN_PATHS["vqe", VQE_SMALL_L,
                                                           storage, dot]))
            require(r["counts"]["block_backward_dual[diag_q]"] > 0 and all(
                r["counts"][f"{k}[{mode}]"] == r["counts"][k] > 0
                for k in ("block_backward_dual", "block_backward_high")),
                f"[{tag}] the adjoints ran off their {mode} variants")
            vqe_small[n, storage, dot] = dict(counts=r["counts"], step_s=r["step_s"], **e)
        del model, p, ref
        torch.cuda.empty_cache()

    # [vqe29_bf16]: the VQE headline ([vqe29]'s VQEIsing(29, 26) and params)
    # under "bf16": one value_and_grad step (every kernel it runs has
    # launched above: the port compiles nothing) and its peak memory,
    # against [vqe29]'s f32 step, memory and gradient
    log_time("[vqe29_bf16]")
    build = lambda d: VQEIsing(N29, VQE_LAYERS, device=d)  # noqa: E731
    model = build(dev)
    p = model.init_params(torch.Generator().manual_seed(SEED))
    r = fwd16_run("vqe29_bf16", model, p, build, "bf16", loss="energy")
    e = vs_ref("vqe29_bf16", r, dict(value=vqe29["value_vg"], grad=vqe29["grad"]),
               own_bars(JAX_OWN_PATHS["vqe", VQE_LAYERS, "bf16", "f32"]))
    require(r["counts"]["block_backward_dual[fwd_bf16]"]
            == r["counts"]["block_backward_dual"] > 0, "[vqe29_bf16] off its variants")
    log(f"[vqe29_bf16] {N29}q x {VQE_LAYERS}L under bf16: value_and_grad "
        f"{r['step_s']:.4f} s at {r['peak'] / 2**30:.3f} GiB against f32's "
        f"{vqe29['vg_s']:.4f} s at {vqe29['vg_peak'] / 2**30:.3f} GiB")
    vqe29_bf16 = dict(counts=r["counts"], step_s=r["step_s"], peak=r["peak"], **e)
    del model, p, r
    torch.cuda.empty_cache()

    # [per_term29_f16]: a 29q build() tape whose dense gate on qubits (16,
    # 7) takes the per-term fallback (per_term_tape, 2 layers) under "f16"
    # against f32 storage: the value bit-identical, the gradient rms within
    # the [paths29_mixed] "f16" rule, the applies counted on f16 input
    log_time("[per_term29_f16]")
    ptc = per_term_tape(AutoGradCircuit(N29), PER_TERM_L)
    pt_items = [it for it in ps.plane_program(fuse_tape(ptc.tape)) if it[0] == "dcross"]
    pt_fi = fuse_tape(ptc.tape).instructions[pt_items[0][1]]
    require(ps._cross_plan(np.eye(4, dtype=np.complex64), pt_fi.positions, N29,
                           dev)[0] == "per_term",
            "[per_term29_f16] the gate does not take the per-term fallback")
    _, pt_run = ptc.build()
    pt_rng = np.random.default_rng(SEED + 5)
    pt_vg_np = tape_gates(pt_rng, ptc.tape, True)
    pt_vg = [torch.tensor(g, device=dev) for g in pt_vg_np]
    pt_dry = tape_dry(fuse_tape(ptc.tape), pt_vg_np, [])
    pt = {}
    _, v32, g32, pt["f32_s"], _ = storage_phase(
        "per_term29_f16", lambda ps_: tsallis(pt_run(ps_, [])), pt_vg, "f32", pt_dry)
    pt["counts"], _, _, pt["step_s"], pt["peak"] = storage_phase(
        "per_term29_f16", lambda ps_: tsallis(pt_run(ps_, [])), pt_vg, "f16", pt_dry,
        ref=(v32, g32), rms_tol=reduced_tol("per_term", "f16"),
        variants=("dual_apply[in_f16]", "high_apply[in_f16]"))
    del ptc, pt_run, pt_vg, g32
    torch.cuda.empty_cache()

    # [hpair30_f16]: the CNOT ring at 30q x 2L under "f16", its lone 2-bit
    # top-group block at X = 512 both ways (the wide adjoint on f16
    # cotangent planes), by default and with the hpair expanded: params = 0
    # (n within 1e-5 n, |grad| <= 1e-5), the counters held to the dry run
    for factorized in (True, False):
        config.set_hpair_factorized(factorized)
        config.set_state_storage("f16")
        try:
            tag = f"hpair30_f16 {'factorized' if factorized else 'expanded'} hpair"
            build = lambda d: HardwareEfficientAnsatz(N30, L30, entangler="cnot",  # noqa: E731
                                                      device=d)
            _, want, _ = program_launches(build, "magnetization")
            two = build(dev)
            p2 = torch.zeros(L30, N30, 3, device=dev, requires_grad=True)
            K.reset_launch_counts()
            v2 = two.magnetization(p2)
            v2.backward()
            got = K.launch_counts()
        finally:
            config.set_state_storage("f32")
            config.set_hpair_factorized(True)
        g2_max = p2.grad.abs().max().item()
        log(f"[{tag}] {N30}q x {L30}L cnot params = 0: magnetization {v2.item()!r} "
            f"(want {N30}, tol {CLOSED_TOL * N30:.1e}); |grad| max {g2_max:.3e} "
            f"(tol {CLOSED_TOL:.0e}); block_backward_high[wide] "
            f"{got['block_backward_high[wide]']}, [f16] {got['block_backward_high[f16]']}")
        require(got == want, f"[{tag}] launch counts {got}, want the dry run's {want}")
        require(abs(v2.item() - N30) <= CLOSED_TOL * N30 and g2_max <= CLOSED_TOL,
                f"[{tag}] params = 0 failed")
        require(got["block_backward_high[wide]"] > 0 and got["block_backward_high[f16]"]
                >= got["block_backward_high[wide]"],
                f"[{tag}] the X = 512 adjoint did not run on f16 planes")
        paths["hpair30", factorized] = got
        del two, p2, v2
        torch.cuda.empty_cache()

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
    log_time("result lines")
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
        # the high multi-term apply is the dual multi-term kernel's entry
        # dqc_high_multi_apply, built in its library
        "high_multi_apply": ("dqc_tpu_torch/csrc/dual_multi_apply.cu",
                             "dqc_tpu/ops/pallas/high_apply.py:273",
                             "29q_T2_cnot"),
        # the lane and sublane adjoints are the dual kernel's lane and
        # sublane steps, built in its library
        "block_backward_sublane": ("dqc_tpu_torch/csrc/block_backward_dual.cu",
                                   "dqc_tpu/ops/pallas/block_backward.py:184",
                                   "29q"),
        "block_backward_lane": ("dqc_tpu_torch/csrc/block_backward_dual.cu",
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
            "dqc_tpu_torch/csrc/dual_multi_apply.cu",
            "dqc_tpu/ops/pallas/high_apply.py:273 (conj/acc/alias=False)",
            "29q_seed_T4_acc", "_seed_"),
        "block_backward_high[diag_q]": (
            "dqc_tpu_torch/csrc/block_backward_high.cu",
            "dqc_tpu/ops/pallas/block_backward.py:906 (diag_q)",
            "29q_X128_g2_diag_first_q", "_q"),
        "diag_backward[with_q]": (
            "dqc_tpu_torch/csrc/diag.cu", "dqc_tpu/ops/pallas/diag.py:154 (with_q)",
            "29q_q", "_q"),
        "high_apply[tc]": (
            "dqc_tpu_torch/csrc/tc_apply.cuh",
            "dqc_tpu/ops/pallas/high_apply.py:76 (every X on the tensor cores; "
            "X = 128 / 256 / 512 here)", "29q_X128_plain", "X128_"),
        "dual_multi_apply[tc]": (
            "dqc_tpu_torch/csrc/dual_multi_apply.cu",
            "dqc_tpu/ops/pallas/dual_apply.py:165 (every product, tensor cores)",
            "29q_T2_cnot", "29q_T"),
        "high_multi_apply[tc]": (
            "dqc_tpu_torch/csrc/dual_multi_apply.cu",
            "dqc_tpu/ops/pallas/high_apply.py:273 (every product, tensor cores)",
            "29q_T2_cnot", "29q_T"),
        "high_apply[wide_inplace]": (
            "dqc_tpu_torch/csrc/tc_apply.cuh",
            "dqc_tpu/ops/pallas/high_apply.py:76 (alias=True, X = 256 / 512)",
            "29q_X256_inplace", "_inplace"),
        "block_backward_high[wide]": (
            "dqc_tpu_torch/csrc/block_backward_high.cu",
            "dqc_tpu/ops/pallas/block_backward.py:906 (X = 256 / 512)",
            "29q_X256_wide", "_wide"),
        "block_backward_dual[tc]": (
            "dqc_tpu_torch/csrc/tc_adjoint.cuh",
            "dqc_tpu/ops/pallas/block_backward.py:437 (the one-pass step, tensor cores)",
            "29q_g0_first_diag_first", "29q_g0_first"),
        "block_backward_lane[tc]": (
            "dqc_tpu_torch/csrc/tc_adjoint.cuh",
            "dqc_tpu/ops/pallas/block_backward.py:88 (the one-pass step, tensor cores)",
            "29q", "q"),
        "block_backward_sublane[tc]": (
            "dqc_tpu_torch/csrc/tc_adjoint.cuh",
            "dqc_tpu/ops/pallas/block_backward.py:184 (the one-pass step, tensor cores)",
            "29q", "q"),
        "block_backward_high[tc]": (
            "dqc_tpu_torch/csrc/tc_adjoint.cuh",
            "dqc_tpu/ops/pallas/block_backward.py:906 (X = 128, the one-pass step, "
            "tensor cores)", "29q_X128_plain", "X128_"),
        "gram[tc]": (
            "dqc_tpu_torch/csrc/gram.cu",
            "dqc_tpu/ops/pallas/gram.py:58,97,134 (every X, tensor cores)",
            "29q_lane", "29q_"),
        "block_backward_merged_fact[tc]": (
            "dqc_tpu_torch/csrc/block_backward_merged_fact.cu",
            "dqc_tpu/ops/pallas/block_backward.py:670 (the one-pass step, tensor cores)",
            "Xt2", "Xt"),
        "dual_apply[tc]": (
            "dqc_tpu_torch/csrc/dual_apply.cu",
            "dqc_tpu/ops/pallas/dual_apply.py:232 (both products, tensor cores)",
            "29q_diag_first", "29q_"),
        "merged_fact_apply[tc]": (
            "dqc_tpu_torch/csrc/merged_fact_apply.cu",
            "dqc_tpu/ops/pallas/high_apply.py:190 (the low factor, tensor cores)",
            "Xt2", "Xt"),
    }
    mode_runs = {"block_backward_high[diag_q]": t29, "diag_backward[with_q]": tdq,
                 "high_apply[wide_inplace]": hp29, "block_backward_high[wide]": hp29,
                 "high_apply[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "dual_multi_apply[tc]": {"counts": countsc, "counts_fwd": fwdc},
                 "high_multi_apply[tc]": {"counts": countsc, "counts_fwd": fwdc},
                 "block_backward_dual[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "block_backward_lane[tc]": t29,
                 "block_backward_sublane[tc]": {"counts": countsc, "counts_fwd": fwdc},
                 "block_backward_high[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "gram[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "block_backward_merged_fact[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "dual_apply[tc]": {"counts": counts29, "counts_fwd": fwd29},
                 "merged_fact_apply[tc]": {"counts": counts29, "counts_fwd": fwd29}}
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
                "shape": rep["shape"], "dense_bound_ms": rep.get("dense_bound_ms"),
                "tc_bound_ms": rep.get("tc_bound_ms")}

    for name, (src, replaces, variant) in sources.items():
        mine = [r for r in rows if r["kernel"] == name and "storage" not in r and not (
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
        mine = [r for r in rows if r["kernel"] == kernel and tag in r["variant"]
                and "storage" not in r]
        run = mode_runs.get(name, vqe29)
        out.append(row_of(name, src, replaces, mine, variant,
                          run["counts"][name], run["counts_fwd"][name]))
    # the storage and dot-mode variants: "launches" from [f16_29] for
    # f16 and the bf16x3 transport, from [storage29]'s "mixed" run for bf16,
    # from [grad29] for the default bf16x3 pair grams ([cnot29] for the
    # sublane adjoint's, [tape29] for the lane adjoint's); their forwards
    # launch none of them
    bb = "dqc_tpu/ops/pallas/block_backward.py"
    f16c, bf16c = f16_29["counts"], storage29["mixed"]
    # name: (source, replaces, representative row, storages of its rows, runs)
    variants = {
        "dual_apply[f16]": ("dqc_tpu_torch/csrc/dual_apply.cu",
                            "dqc_tpu/ops/pallas/dual_apply.py:232 (seed, u16 out)",
                            "29q_seed_f16", ("float16",), f16c),
        "dual_apply[bf16]": ("dqc_tpu_torch/csrc/dual_apply.cu",
                             "dqc_tpu/ops/pallas/dual_apply.py:232 (seed, bf16 out)",
                             "29q_seed_bf16", ("bfloat16",), bf16c),
        "high_apply[f16]": ("dqc_tpu_torch/csrc/high_apply.cu",
                            "dqc_tpu/ops/pallas/high_apply.py:76 (seed, u16 out)",
                            "29q_X128_seed_f16", ("float16",), f16c),
        "high_apply[bf16]": ("dqc_tpu_torch/csrc/high_apply.cu",
                             "dqc_tpu/ops/pallas/high_apply.py:76 (seed, bf16 out)",
                             "29q_X128_seed_bf16", ("bfloat16",), bf16c),
        "diag_backward[f16]": ("dqc_tpu_torch/csrc/diag.cu",
                               "dqc_tpu/ops/pallas/diag.py:154 (u16 bwd)",
                               "29q_f16", ("float16",), f16c),
        "diag_backward[bf16]": ("dqc_tpu_torch/csrc/diag.cu",
                                "dqc_tpu/ops/pallas/diag.py:154 (bf16 bwd)",
                                "29q_bf16", ("bfloat16",), bf16c),
        "block_backward_sublane[gram_bf16x3]": (
            "dqc_tpu_torch/csrc/block_backward_dual.cu",
            f"{bb}:184 (gram_dot_mode bf16x3)", "29q_gram_bf16x3",
            ("float32",), countsc),
        "block_backward_lane[gram_bf16x3]": (
            "dqc_tpu_torch/csrc/block_backward_dual.cu",
            f"{bb}:88 (gram_dot_mode bf16x3)", "29q_gram_bf16x3",
            ("float32",), t29["counts"]),
    }
    for kernel, src, line, pre in (
            ("block_backward_dual", "dqc_tpu_torch/csrc/block_backward_dual.cu",
             f"{bb}:437", "29q_"),
            ("block_backward_high", "dqc_tpu_torch/csrc/block_backward_high.cu",
             f"{bb}:906", "29q_X128_"),
            ("block_backward_merged_fact",
             "dqc_tpu_torch/csrc/block_backward_merged_fact.cu", f"{bb}:670", "Xt2_")):
        rep_of = {"f16": f"{pre}f16", "bf16": f"{pre}bf16",
                  "gram_bf16x3": f"{pre}gram_bf16x3"}
        if kernel == "block_backward_dual":
            rep_of = {k: f"29q_{k}_g0_first_diag_first" for k in rep_of}
        x3_rep = rep_of["f16"]
        if kernel == "block_backward_merged_fact":
            # the path's transport is f32 since the JAX package's clamp was
            # ported (row 12f)
            rep_of.update(f16="Xt2_f16_f32_transport", bf16="Xt2_bf16_f32_transport")
        variants[f"{kernel}[f16]"] = (src, f"{line} (u16 bwd)", rep_of["f16"],
                                      ("float16",), f16c)
        variants[f"{kernel}[bf16]"] = (src, f"{line} (bf16 bwd)", rep_of["bf16"],
                                       ("bfloat16",), bf16c)
        variants[f"{kernel}[bf16x3]"] = (src, f"{line} (bwd_dot_mode bf16x3)",
                                         x3_rep, ("float16", "bfloat16"), f16c)
        variants[f"{kernel}[gram_bf16x3]"] = (src, f"{line} (gram_dot_mode bf16x3)",
                                              rep_of["gram_bf16x3"], ("float32",),
                                              counts29)
    # the variants of the other plane paths: f16 and the bf16x3 transport
    # from [cnot29_f16] (the multi-term applies, the sublane adjoint) and
    # [tape29_f16] (the lane adjoint), bf16 from [paths29_mixed]'s CNOT ring
    # and tape; the X = 256 adjoint on reduced planes from [paths29_mixed]'s
    # expanded hpair (every wide launch there is one)
    c16, tc16 = cnot16[0], tape16[0]
    cmix, tmix = paths["cnot", "mixed"], paths["tape", "mixed"]
    da = "dqc_tpu/ops/pallas/dual_apply.py:165"
    ha = "dqc_tpu/ops/pallas/high_apply.py:273"
    for name, src, line, counts16, countsb in (
            ("dual_multi_apply", "dqc_tpu_torch/csrc/dual_multi_apply.cu", da, c16, cmix),
            ("high_multi_apply", "dqc_tpu_torch/csrc/dual_multi_apply.cu", ha, c16, cmix)):
        variants[f"{name}[f16]"] = (src, f"{line} (u16 planes)", "29q_T2_cnot_f16",
                                    ("float16",), counts16)
        variants[f"{name}[bf16]"] = (src, f"{line} (bf16 planes)", "29q_T2_cnot_bf16",
                                     ("bfloat16",), countsb)
    for name, line, counts16, countsb in (
            ("block_backward_sublane", f"{bb}:184", c16, cmix),
            ("block_backward_lane", f"{bb}:88", tc16, tmix)):
        # the lane and sublane adjoints are built in the dual adjoint's library
        src = "dqc_tpu_torch/csrc/block_backward_dual.cu"
        variants[f"{name}[f16]"] = (src, f"{line} (u16 bwd)", "29q_f16", ("float16",),
                                    counts16)
        variants[f"{name}[bf16]"] = (src, f"{line} (bf16 bwd)", "29q_bf16",
                                     ("bfloat16",), countsb)
        variants[f"{name}[bf16x3]"] = (src, f"{line} (bwd_dot_mode bf16x3)", "29q_f16",
                                       ("float16", "bfloat16"), counts16)
    for store, storage, dtn in (("f16", "f16", "float16"), ("bf16", "mixed", "bfloat16")):
        name = f"block_backward_high[wide+{store}]"
        variants[name] = (
            "dqc_tpu_torch/csrc/block_backward_high.cu",
            f"{bb}:906 (X = 256 / 512, {'u16' if store == 'f16' else 'bf16'} bwd)",
            f"29q_X256_wide_{store}", (dtn,),
            {name: paths["hpair", storage]["block_backward_high[wide]"]})
    for name, (src, replaces, variant, storages, run_counts) in variants.items():
        kernel = name.split("[")[0]
        mine = [r for r in rows if r["kernel"] == kernel
                and r.get("storage") in storages and "fwd" not in r]
        out.append(row_of(name, src, replaces, mine, variant, run_counts[name], 0))
    # "bf16" forward storage and the forward bf16x3: "launches" from
    # [bf16_29] and from [x3_29]'s f32-storage run
    fwd_rows = {
        "dual_apply": ("dqc_tpu_torch/csrc/dual_apply.cu",
                       "dqc_tpu/ops/pallas/dual_apply.py:232", "29q_diag_first"),
        "high_apply": ("dqc_tpu_torch/csrc/high_apply.cu",
                       "dqc_tpu/ops/pallas/high_apply.py:76", "29q_X128"),
        "gram": ("dqc_tpu_torch/csrc/gram.cu",
                 "dqc_tpu/ops/pallas/gram.py:58,97,134", "29q_lane"),
        "merged_fact_apply": ("dqc_tpu_torch/csrc/merged_fact_apply.cu",
                              "dqc_tpu/ops/pallas/high_apply.py:190", "Xt2"),
        "diag_sweep": ("dqc_tpu_torch/csrc/diag.cu",
                       "dqc_tpu/ops/pallas/diag.py:75", "29q"),
        "diag_backward": ("dqc_tpu_torch/csrc/diag.cu",
                          "dqc_tpu/ops/pallas/diag.py:154", "29q"),
        "block_backward_dual": ("dqc_tpu_torch/csrc/block_backward_dual.cu",
                                f"{bb}:437", "29q_g0_first_diag_first"),
        "block_backward_high": ("dqc_tpu_torch/csrc/block_backward_high.cu",
                                f"{bb}:906", "29q_X128"),
        "block_backward_merged_fact": (
            "dqc_tpu_torch/csrc/block_backward_merged_fact.cu", f"{bb}:670", "Xt2"),
    }
    for kernel, (src, line, pre) in fwd_rows.items():
        for mode, tags, what, run_counts in (
                ("fwd_bf16", ("bf16",), "bf16 forward planes", bf16_29["counts"]),
                ("fwd_bf16x3", ("x3", "bf16x3"), "dot_mode bf16x3",
                 x3_29["f32"]["counts"])):
            name = f"{kernel}[{mode}]"
            if name not in run_counts:
                continue
            mine = [r for r in rows if r["kernel"] == kernel and r.get("fwd") in tags
                    and "phase" not in r]
            out.append(row_of(name, src, f"{line} ({what})", mine,
                              f"{pre}_{tags[0]}", run_counts[name], None))
    # this slice's variants (phase 3j): "launches" from [cz_bf16_small]'s 20q
    # runs (every high kernel there is at X = 64), [cnot29_bf16] and the
    # forward bf16x3 CNOT run on f32 planes ([cnot29_x3]), [hpair29_bf16]'s
    # expanded runs and [cnot30_bf16] (the merged top axis); each row's
    # numbers from its kernel's 3j rows of the setting
    small_bf16 = cz_small[20, "bf16", "f32"]["counts"]
    small_x3 = cz_small[20, "f32", "bf16x3"]["counts"]
    hp_bf16 = hpair29_bf16["bf16", "f32"]["counts"]
    hp_x3 = hpair29_bf16["f32", "bf16x3"]["counts"]
    c29b, c29x = cnot29_bf16["counts"], cnot29_x3["f32"]["counts"]

    def narrow(r):
        return r["variant"].split("_")[1] in ("X8", "X16", "X32", "X64")

    def wide_row(kind):
        return lambda r: f"_{kind}_" in r["variant"]

    def every(r):
        return True

    # (names of the bf16 and bf16x3 rows, kernel, source (or one per row),
    # representative variant, which of the kernel's 3j rows, launches of
    # each; the wide adjoint's bf16 launches [hpair29_bf16]'s and
    # [cnot30_bf16]'s)
    slice_rows = (
        (("high_apply[fwd_bf16,X=8..64]", "high_apply[fwd_bf16x3,X=8..64]"),
         "high_apply", "high_apply_small.cu", "29q_X64_diag_first", narrow,
         small_bf16["high_apply[fwd_bf16]"], small_x3["high_apply[fwd_bf16x3]"]),
        (("gram[fwd_bf16,X=8..64]", "gram[fwd_bf16x3,X=8..64]"), "gram", "gram.cu",
         "29q_X64", narrow, small_bf16["gram[fwd_bf16]"], small_x3["gram[fwd_bf16x3]"]),
        (("block_backward_high[fwd_bf16,X=8..64]",
          "block_backward_high[fwd_bf16x3,X=8..64]"), "block_backward_high",
         "block_backward_high_small.cu", "29q_X64", narrow,
         small_bf16["block_backward_high[fwd_bf16]"],
         small_x3["block_backward_high[fwd_bf16x3]"]),
        (("high_apply[wide_inplace+fwd_bf16]", "high_apply[wide_inplace+fwd_bf16x3]"),
         "high_apply", "tc_apply.cuh", "29q_X256_inplace", wide_row("inplace"),
         hp_bf16["high_apply[wide_inplace]"], hp_x3["high_apply[wide_inplace]"]),
        (("block_backward_high[wide+fwd_bf16]", "block_backward_high[wide+fwd_bf16x3]"),
         "block_backward_high", "block_backward_high.cu", "29q_X256_wide",
         wide_row("wide"), hp_bf16["block_backward_high[wide]"]
         + cnot30_bf16["counts"]["block_backward_high[wide]"],
         hp_x3["block_backward_high[wide]"]),
        (("dual_multi_apply[bf16 storage]", "dual_multi_apply[fwd_bf16x3]"),
         "dual_multi_apply", "dual_multi_apply.cu", "29q_T2_cnot", every,
         c29b["dual_multi_apply[bf16]"], c29x["dual_multi_apply[fwd_bf16x3]"]),
        (("high_multi_apply[bf16 storage]", "high_multi_apply[fwd_bf16x3]"),
         "high_multi_apply", "dual_multi_apply.cu",
         "29q_T2_cnot", every,
         c29b["high_multi_apply[bf16]"], c29x["high_multi_apply[fwd_bf16x3]"]),
        (("block_backward_sublane[fwd_bf16]", "block_backward_sublane[fwd_bf16x3]"),
         "block_backward_sublane", "block_backward_dual.cu", "29q", every,
         c29b["block_backward_sublane[fwd_bf16]"],
         c29x["block_backward_sublane[fwd_bf16x3]"]))
    replaces_of = {"high_apply": "dqc_tpu/ops/pallas/high_apply.py:76",
                   "gram": "dqc_tpu/ops/pallas/gram.py:134",
                   "block_backward_high": f"{bb}:906",
                   "dual_multi_apply": "dqc_tpu/ops/pallas/dual_apply.py:165",
                   "high_multi_apply": "dqc_tpu/ops/pallas/high_apply.py:273",
                   "block_backward_sublane": f"{bb}:184"}
    for names, kernel, srcs, pre, pick, n_bf16, n_x3 in slice_rows:
        srcs = (srcs, srcs) if isinstance(srcs, str) else srcs
        for name, src, tags, what, launches in (
                (names[0], srcs[0], ("bf16",), "bf16 forward planes", n_bf16),
                (names[1], srcs[1], ("x3", "bf16x3"), "dot_mode bf16x3", n_x3)):
            mine = [r for r in rows if r["kernel"] == kernel and r.get("fwd") in tags
                    and pick(r) and "phase" not in r]
            out.append(row_of(name, f"dqc_tpu_torch/csrc/{src}",
                              f"{replaces_of[kernel]} ({what})", mine,
                              f"{pre}_{tags[0]}", launches, None))
    # the high apply and the high adjoint at X = 8..64 on the tensor cores
    # (csrc/high_apply_small.cu, csrc/block_backward_high_small.cu, every
    # storage and mode): "launches" from [cz_f32_small]'s 20q run, whose every
    # high apply and high adjoint launch is at X = 64; their numbers from the
    # X = 8..64 rows on f32 planes (phases 3, 3e, 3m, 3p)
    out.append(row_of(
        "high_apply[tc,X=8..64]",
        "dqc_tpu_torch/csrc/high_apply_small.cu",
        "dqc_tpu/ops/pallas/high_apply.py:76 (X = 8..64, tensor cores)",
        [r for r in rows if r["kernel"] == "high_apply" and narrow(r)
         and "storage" not in r and "fwd" not in r], "29q_X64_f32",
        cz_f32_small[20]["counts"]["high_apply[tc]"], 0))
    out.append(row_of(
        "block_backward_high[tc,X=8..64]",
        "dqc_tpu_torch/csrc/block_backward_high_small.cu",
        f"{bb}:906 (X = 8..64, the one-pass step, tensor cores)",
        [r for r in rows if r["kernel"] == "block_backward_high" and narrow(r)
         and "storage" not in r], "29q_X64_f32",
        cz_f32_small[20]["counts"]["block_backward_high[tc]"], 0))
    # phase 3k's variants: "launches" from [paths29_bf16]'s
    # runs (the tape: the lane adjoint, the high adjoint's Q; VQE: the dual
    # adjoint's Q; the [diagq] tape: the diag adjoint's) and from
    # [per_term29_f16] (f16 input to the applies); each row's numbers from
    # its kernel's 3k rows of the setting
    def k3(kernel, tags, pick=lambda r: True):
        return [r for r in rows if r["kernel"] == kernel and r.get("phase") == "3k"
                and r.get("fwd") in tags and pick(r)]

    def q_rows(r):
        return "_q_" in r["variant"]

    pb = {k: v["counts"] for k, v in paths_bf16.items()}
    bfk, x3k = ("bf16", "f32"), ("f32", "bf16x3")
    for name, kernel, src, line, what, mine, rep, launches in (
            ("block_backward_lane[fwd_bf16]", "block_backward_lane",
             "block_backward_dual.cu", f"{bb}:88", "bf16 forward planes",
             k3("block_backward_lane", ("bf16",)), "29q_bf16",
             pb["tape", *bfk]["block_backward_lane[fwd_bf16]"]),
            ("block_backward_lane[fwd_bf16x3]", "block_backward_lane",
             "block_backward_dual.cu", f"{bb}:88", "dot_mode bf16x3",
             k3("block_backward_lane", ("x3", "bf16x3")), "29q_x3",
             pb["tape", *x3k]["block_backward_lane[fwd_bf16x3]"]),
            ("block_backward_dual[diag_q+fwd_bf16]", "block_backward_dual",
             "block_backward_dual.cu", f"{bb}:437", "diag_q, bf16 forward planes",
             k3("block_backward_dual", ("bf16",), q_rows),
             "29q_g0_first_diag_first_q_bf16",
             pb["vqe", *bfk]["block_backward_dual[diag_q]"]),
            ("block_backward_dual[diag_q+fwd_bf16x3]", "block_backward_dual",
             "block_backward_dual.cu", f"{bb}:437", "diag_q, dot_mode bf16x3",
             k3("block_backward_dual", ("x3",), q_rows),
             "29q_g0_first_diag_first_q_x3",
             pb["vqe", *x3k]["block_backward_dual[diag_q]"]),
            ("block_backward_high[diag_q+fwd_bf16]", "block_backward_high",
             "block_backward_high.cu", f"{bb}:906", "diag_q, bf16 forward planes",
             k3("block_backward_high", ("bf16",), q_rows), "29q_X128_diag_first_q_bf16",
             pb["tape", *bfk]["block_backward_high[diag_q]"]),
            ("block_backward_high[diag_q+fwd_bf16x3]", "block_backward_high",
             "block_backward_high.cu", f"{bb}:906", "diag_q, dot_mode bf16x3",
             k3("block_backward_high", ("x3",), q_rows), "29q_X128_diag_first_q_x3",
             pb["tape", *x3k]["block_backward_high[diag_q]"]),
            ("diag_backward[with_q+fwd_bf16]", "diag_backward", "diag.cu",
             "dqc_tpu/ops/pallas/diag.py:154", "with_q, bf16 forward planes",
             k3("diag_backward", ("bf16",)), "29q_q_bf16",
             pb["diagq", *bfk]["diag_backward[with_q]"]),
            ("dual_apply[in_f16]", "dual_apply", "dual_apply.cu",
             "dqc_tpu/ops/pallas/dual_apply.py:232", "u16 input planes",
             k3("dual_apply", ("f16in",)), "29q_fresh_f16in",
             pt["counts"]["dual_apply[in_f16]"]),
            ("high_apply[in_f16]", "high_apply", "high_apply.cu",
             "dqc_tpu/ops/pallas/high_apply.py:76", "u16 input planes",
             k3("high_apply", ("f16in",)), "29q_X128_fresh_f16in",
             pt["counts"]["high_apply[in_f16]"])):
        require(bool(mine), f"no phase 3k row for {name}")
        out.append(row_of(name, f"dqc_tpu_torch/csrc/{src}", f"{line} ({what})", mine,
                          rep, launches, None))
        require(launches > 0, f"{name} was launched no time on its path")
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
