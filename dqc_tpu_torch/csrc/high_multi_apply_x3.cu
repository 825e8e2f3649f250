// The forward bf16x3 variants of the multi-term high + lane apply: both
// products of y = sum_t (E_t on axis X) (El_t on the lane axis) x in the
// 3-pass split, on planes of every storage pair the f32 products take.
//
// Replaces, with high_multi_apply.cu, the TPU kernel high_multi_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:273) under set_kernel_dot_mode("bf16x3")
// (its make_dot(dot_mode)). The kernel is multi_apply.cuh's with X3: each
// operator tile staged as its hi and lo bf16 parts, x and the lane product
// split as they are read, two FMAs per real product on the CUDA cores (bound
// by operations: (128 + X) T complex multiply-adds per amplitude, three bf16
// products each), in a library of its own so that its build runs beside
// high_multi_apply.cu's.

#include "multi_apply.cuh"

// dqc_high_multi_apply's contract (high_multi_apply.cu) with the products
// bf16x3. Returns cudaGetLastError().
extern "C" int dqc_high_multi_apply_x3(const void* xr, const void* xi,
                                       void* yr, void* yi, int xkind,
                                       int ykind, const float* elt_r,
                                       const float* elt_i, const float* et_r,
                                       const float* et_i, int T, int conj,
                                       int has_acc, long long A1, int X,
                                       long long M, void* stream) {
  return dqc::launch_high_multi<true>(xr, xi, yr, yi, xkind, ykind, elt_r,
                                      elt_i, et_r, et_i, T, conj, has_acc, A1,
                                      X, M, (cudaStream_t)stream);
}
