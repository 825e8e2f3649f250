// Multi-term dual-group apply on the planes: y = sum_t Em_t . X . El_t^T for
// every 128 x 128 slab, in place.
//
// Replaces the TPU kernel dual_multi_apply_planes
// (dqc_tpu/ops/pallas/dual_apply.py:165, body _kernel_multi at :116): the
// whole operator-Schmidt decomposition of a dense gate across the lane group
// (qubits 0..6, El_t on the last axis) and the sublane group (qubits 7..13,
// Em_t on the middle axis), T terms, in one pass over planes (A, 128, 128),
// in place; and its density-seed modes (conj / acc / alias=False, :153-157):
// y = [acc +] conj(sum_t Em_t X El_t^T) with X read only, the seed of a
// density across the lane and sublane groups (T = 4 terms of its 4 x 4
// operator).
//
// Bound: operations. Per amplitude and term, 2 x 128 complex multiply-adds
// (8 real flops each) against 16 bytes read and written: 256 T flop per
// 16 bytes, far above the H100's FP32 ridge (~20 flop/B). f32 FMA on the
// CUDA cores, no TF32.
//
// Design: multi_apply.cuh at X = 128 on the view (A, 128, 1, 128): a block
// per slab holds the whole slab in shared memory (every output depends on
// all of it, for every term) and streams the output in 64-lane column
// blocks, summing the terms in registers. Under reduced cotangent storage
// the planes are stored as bf16 or f16 (multi_apply.cuh): the CNOT ring's
// G^T transport in place on B, the seeds from f32 forward planes into B.
// Under "bf16" storage the forward planes are bf16 too (the uncompute in
// place on them, the seeds from them into bf16 B), and the forward bf16x3
// runs both products in the 3-pass split (multi_apply.cuh X3).

#include "multi_apply.cuh"

// On planes (A, 128, 128): y <- [y +] conj?(sum_t Em_t x El_t^T), t < T,
// with y = x for in place and y the accumulator planes with has_acc; x
// stored as xkind, y as ykind (0 f32, 1 bf16, 2 f16; multi_apply.cuh's
// pairs); x3 runs the products bf16x3. elt = El_t^T and emt = Em_t^T,
// stacked (T, 128, 128) each, real/imag planes. Returns cudaGetLastError().
extern "C" int dqc_dual_multi_apply(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind, int x3,
                                    const float* elt_r, const float* elt_i,
                                    const float* emt_r, const float* emt_i,
                                    int T, int conj, int has_acc, long long A,
                                    void* stream) {
  auto fn = x3 ? dqc::launch_multi_apply<dqc::kGroup, true>
              : dqc::launch_multi_apply<dqc::kGroup, false>;
  return fn(xr, xi, yr, yi, xkind, ykind, elt_r, elt_i, emt_r, emt_i, T, A, 1,
            conj, has_acc, (cudaStream_t)stream);
}
