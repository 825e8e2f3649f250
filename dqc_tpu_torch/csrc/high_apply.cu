// High-group apply on f32 planes: y = E . x along axis X of (A1, X, M, 128).
//
// Replaces the TPU kernel high_group_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:76, pallas_call at :133), forward form:
// a dense operator E (X x X, 8 <= X <= 128) on the contracted group axis of
// the high view, with an optional fused diagonal run multiplied before
// (diag_first) or after the product, and the seed modes of the gradient:
// conj(y), y added into accumulator planes, and output planes other than the
// input (alias=False). The run's tables are read in their
// canonical layout, tsl (128, 128) and tas/tal (A, 128), at
// a = (i X + x) post + p for view element (i, x, m = p 128 + s, l); the
// TPU kernel's re-laid-out table views (common.dh_table_views) were a
// Mosaic tiling need and have no counterpart here.
//
// Bound: operations. At X = 128 each amplitude takes 128 complex
// multiply-adds (8 real flops each) against 16 bytes moved, ~64 flop per
// byte, above the H100's FP32 ridge (~20 flop/B). f32 FMA on the CUDA
// cores, no TF32.
//
// X = 256 and 512 are the merged top axis of a tiny top group
// (ops/planes._merged_view): the in-place sweep of a dense block there (a
// lone top-group block, E (x) I, or the unfactorized hpair's merged
// operator) and the density seed of the top two groups, by
// wide_apply_kernel (csrc/wide_apply.cuh), without a diagonal run.
//
// Design: a "column" is one (i, m, l) position, its X amplitudes X apart
// by Q = M 128. A block of 256 threads takes 8192 / X consecutive columns
// (all of one i, since they divide Q), reads the whole X-deep tile into
// shared memory (64 KB) before it writes, so the output may be the input, and
// each thread keeps 8 rows x 4 columns of the product in registers while
// 16-deep tiles of E stream through shared memory.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on its input and its dot_mode), at every X: x may be stored as bf16
// (XKIND), in place or a seed from it into bf16 cotangent planes, and the
// product may run bf16x3 (X3): the E tile is staged as its hi and lo bf16
// parts and each x value split into hi and hi + lo as it is read
// (common.cuh cmac3). XKIND, YKIND and X3 are template parameters, so that
// the f32 sweep keeps its code. The variants at X = 8..64 build in a
// library of their own (high_apply_fwd16.cu; the kernel in high_apply.cuh).
// x may also be stored as f16 bits (into f16 y, in every mode and at
// every X): the TPU kernel decodes a uint16 cotangent through f32_of, and
// the per-term fallback of a dense cross-group gate under "f16" storage
// hands it the cotangent (plane_scan._apply_dense_cross).
// At X = 256 / 512 the in-place sweep on bf16 planes or in bf16x3 is
// wide_apply.cuh's in-place instantiation of the same kernel.

#include "high_apply.cuh"
#include "wide_apply.cuh"

// On the view (A1, X, Q = M 128): y <- [acc +] conj?([D] E x [D]), X in
// {8, 16, 32, 64, 128}, or X in {256, 512} without a run (Q a multiple of
// 32). y may be x (in place); with has_acc, y holds the accumulator and is
// added to. With has_diag, Q must be a multiple of
// 128 * 128 (M = post * 128). y is stored as ykind (0 f32, 1 bf16, 2 f16;
// the seed modes' cotangent planes), x as xkind (0 f32, 1 bf16, 2 f16: into
// y of its storage); x3 runs the product bf16x3. bf16 and f16 x and x3 take
// X = 128 here (X = 8..64 in dqc_high_apply_fwd16), and at X = 256 / 512 y
// is x (in place, x and y of one storage) or other planes than x (the
// seeds). Returns cudaGetLastError().
extern "C" int dqc_high_apply(const void* xr, const void* xi, void* yr,
                              void* yi, int xkind, int ykind, const float* er,
                              const float* ei,
                              const float* sl_r, const float* sl_i,
                              const float* as_r, const float* as_i,
                              const float* al_r, const float* al_i,
                              int has_diag, int diag_first, int conj,
                              int has_acc, int x3, long long A1, int X,
                              long long Q, void* stream) {
  if (has_diag && Q % (128 * 128) != 0) return (int)cudaErrorInvalidValue;
  if (ykind < 0 || ykind > 2 || xkind < 0 || xkind > 2)
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  if (xkind != F || x3) {
    if (X < 128) return (int)cudaErrorInvalidValue;  // dqc_high_apply_fwd16
    if (X == 128)
      return launch_fwd16<128>(xr, xi, yr, yi, xkind, ykind, x3, er, ei, d,
                               has_diag, diag_first, conj, has_acc, A1, Q, s);
    if (has_diag) return (int)cudaErrorInvalidValue;
    if (xr == yr) {
      // in place on the merged top axis
      if (ykind != xkind || conj || has_acc) return (int)cudaErrorInvalidValue;
      if (X == 256)
        return dqc::launch_wide_inplace_fwd16<256>(const_cast<void*>(xr),
                                                   const_cast<void*>(xi), xkind,
                                                   x3, er, ei, A1, Q, s);
      if (X == 512)
        return dqc::launch_wide_inplace_fwd16<512>(const_cast<void*>(xr),
                                                   const_cast<void*>(xi), xkind,
                                                   x3, er, ei, A1, Q, s);
      return (int)cudaErrorInvalidValue;
    }
    if (X == 256)
      return dqc::launch_wide_seed<256>(xr, xi, yr, yi, xkind, ykind, x3, er,
                                        ei, conj, has_acc, A1, Q, s);
    if (X == 512)
      return dqc::launch_wide_seed<512>(xr, xi, yr, yi, xkind, ykind, x3, er,
                                        ei, conj, has_acc, A1, Q, s);
    return (int)cudaErrorInvalidValue;
  }
#define DQC_HIGH_CASE(XX)                                                    \
  case XX:                                                                   \
    return launch<XX>(xr, xi, yr, yi, ykind, er, ei, d, has_diag, diag_first, \
                      conj, has_acc, A1, Q, s);
  switch (X) {
    DQC_HIGH_CASE(8)
    DQC_HIGH_CASE(16)
    DQC_HIGH_CASE(32)
    DQC_HIGH_CASE(64)
    DQC_HIGH_CASE(128)
    case 256:
      if (has_diag) return (int)cudaErrorInvalidValue;
      return dqc::launch_wide_apply<256>(static_cast<const float*>(xr),
                                         static_cast<const float*>(xi), yr, yi,
                                         ykind, er, ei, 0,
                                         conj, has_acc, A1, Q, s);
    case 512:
      if (has_diag) return (int)cudaErrorInvalidValue;
      return dqc::launch_wide_apply<512>(static_cast<const float*>(xr),
                                         static_cast<const float*>(xi), yr, yi,
                                         ykind, er, ei, 0,
                                         conj, has_acc, A1, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQC_HIGH_CASE
}
