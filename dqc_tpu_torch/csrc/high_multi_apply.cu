// Multi-term high + lane apply on f32 planes: y = sum_t (E_t on axis X)
// (El_t on the lane axis) x on the view (A1, X, M, 128), in place.
//
// Replaces the TPU kernel high_multi_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:273, body _kernel_multi at :231), in
// its in-place form (alias=True; conj / acc / alias=False are not ported):
// a dense gate with bits on the lane group and on a high group or a span of
// high bits (ops/planes.apply_cross_span: X = 8 for the ring's closing CNOT)
// as T terms of an X x X factor on the contracted axis and a 128 x 128
// factor on the lanes, in one pass. The lane factors of a span gate are
// elementary |q><p| expansions; this kernel multiplies them as dense
// 128-wide products.
//
// Bound: operations. Per amplitude and term, 128 + X complex multiply-adds
// (8 real flops each) against 16 bytes read and written. f32 FMA on the
// CUDA cores, no TF32.
//
// Design: multi_apply.cuh: a block takes 128 / X consecutive m of one i
// (128 rows of 128 lanes) into shared memory, forms each term's lane
// product into a shared buffer one 64-lane column block at a time, and adds
// the group product within each X-row group in registers.

#include "multi_apply.cuh"

// In place on the view (A1, X, M, 128), X in {8, 16, 32, 64, 128} and
// M % (128 / X) == 0: x <- sum_t E_t x El_t^T, t < T. elt = El_t^T
// (T, 128, 128) and et = E_t^T (T, X, X), real/imag planes. Returns
// cudaGetLastError().
extern "C" int dqc_high_multi_apply(float* xr, float* xi, const float* elt_r,
                                    const float* elt_i, const float* et_r,
                                    const float* et_i, int T, long long A1,
                                    int X, long long M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
#define DQC_MULTI_CASE(XX)                                                  \
  case XX:                                                                  \
    return dqc::launch_multi_apply<XX>(xr, xi, elt_r, elt_i, et_r, et_i, T, \
                                       A1, M, s);
    DQC_MULTI_CASE(8)
    DQC_MULTI_CASE(16)
    DQC_MULTI_CASE(32)
    DQC_MULTI_CASE(64)
    DQC_MULTI_CASE(128)
#undef DQC_MULTI_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
