// Multi-term high + lane apply on the planes: y = sum_t (E_t on axis X)
// (El_t on the lane axis) x on the view (A1, X, M, 128), in place.
//
// Replaces the TPU kernel high_multi_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:273, body _kernel_multi at :231): a
// dense gate with bits on the lane group and on a high group or a span of
// high bits (ops/planes.apply_cross_span: X = 8 for the ring's closing CNOT)
// as T terms of an X x X factor on the contracted axis and a 128 x 128
// factor on the lanes, in one pass, in place; and its density-seed modes
// (conj / acc / alias=False, :261): y = [acc +] conj(sum_t ...) with x read
// only, the seed of a density across the lane group and a high group on
// the X = 8 span view (T = 4 lane slices of its 4 x 4 operator). The lane factors of a span gate are
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
// the group product within each X-row group in registers. Under reduced
// cotangent storage the planes are stored as bf16 or f16 (multi_apply.cuh):
// the span gate's transport in place on B, the seeds into B. Under "bf16"
// storage the forward planes are bf16 too, and the forward bf16x3 runs both
// products in the 3-pass split (multi_apply.cuh X3; high_multi_apply_x3.cu).

#include "multi_apply.cuh"

// On the view (A1, X, M, 128), X in {8, 16, 32, 64, 128} and
// M % (128 / X) == 0: y <- [y +] conj?(sum_t E_t x El_t^T), t < T, with
// y = x for in place and y the accumulator with has_acc; x stored as xkind,
// y as ykind (0 f32, 1 bf16, 2 f16; multi_apply.cuh's pairs), the products
// f32 (the bf16x3 products: dqc_high_multi_apply_x3, high_multi_apply_x3.cu,
// a library of its own so that the two build in parallel). elt = El_t^T
// (T, 128, 128) and et = E_t^T (T, X, X), real/imag planes. Returns
// cudaGetLastError().
extern "C" int dqc_high_multi_apply(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind,
                                    const float* elt_r, const float* elt_i,
                                    const float* et_r, const float* et_i,
                                    int T, int conj, int has_acc,
                                    long long A1, int X, long long M,
                                    void* stream) {
  return dqc::launch_high_multi<false>(xr, xi, yr, yi, xkind, ykind, elt_r,
                                       elt_i, et_r, et_i, T, conj, has_acc, A1,
                                       X, M, (cudaStream_t)stream);
}
