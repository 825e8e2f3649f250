// Multi-term dual-group apply on f32 planes: y = sum_t Em_t . X . El_t^T for
// every 128 x 128 slab, in place.
//
// Replaces the TPU kernel dual_multi_apply_planes
// (dqc_tpu/ops/pallas/dual_apply.py:165, body _kernel_multi at :116), in its
// in-place form (alias=True; conj / acc / alias=False, the cross-group
// density seed, are not ported): the whole operator-Schmidt decomposition of
// a dense gate across the lane group (qubits 0..6, El_t on the last axis)
// and the sublane group (qubits 7..13, Em_t on the middle axis), T terms,
// in one pass over planes (A, 128, 128).
//
// Bound: operations. Per amplitude and term, 2 x 128 complex multiply-adds
// (8 real flops each) against 16 bytes read and written: 256 T flop per
// 16 bytes, far above the H100's FP32 ridge (~20 flop/B). f32 FMA on the
// CUDA cores, no TF32.
//
// Design: multi_apply.cuh at X = 128 on the view (A, 128, 1, 128): a block
// per slab holds the whole slab in shared memory (every output depends on
// all of it, for every term) and streams the output in 64-lane column
// blocks, summing the terms in registers.

#include "multi_apply.cuh"

// In place on planes (A, 128, 128): x <- sum_t Em_t x El_t^T, t < T.
// elt = El_t^T and emt = Em_t^T, stacked (T, 128, 128) each, real/imag
// planes. Returns cudaGetLastError().
extern "C" int dqc_dual_multi_apply(float* xr, float* xi, const float* elt_r,
                                    const float* elt_i, const float* emt_r,
                                    const float* emt_i, int T, long long A,
                                    void* stream) {
  return dqc::launch_multi_apply<dqc::kGroup>(xr, xi, elt_r, elt_i, emt_r,
                                              emt_i, T, A, 1,
                                              (cudaStream_t)stream);
}
