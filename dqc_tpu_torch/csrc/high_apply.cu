// High-group apply: y = E . x along axis X of (A1, X, M, 128).
//
// Replaces the TPU kernel high_group_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:76, pallas_call at :133), forward form:
// a dense operator E (X x X, 8 <= X <= 512) on the contracted group axis of
// the high view, with an optional fused diagonal run multiplied before
// (diag_first) or after the product, and the seed modes of the gradient:
// conj(y), y added into accumulator planes, and output planes other than the
// input (alias=False). The run's tables are read in their
// canonical layout, tsl (128, 128) and tas/tal (A, 128), at
// a = (i X + x) post + p for view element (i, x, m = p 128 + s, l); the
// TPU kernel's re-laid-out table views (common.dh_table_views) were a
// Mosaic tiling need and have no counterpart here.
//
// Bound: operations at X >= 32 (X complex multiply-adds, 8 real flops
// each, against 16 bytes moved per amplitude: ~20 flop per byte at X = 32,
// the H100's FP32 ridge); below, bytes. X = 8..64 run f32 FMA on the CUDA
// cores, no TF32.
//
// X = 128 on every storage and in both dot modes, and X = 256 and 512 (the
// merged top axis of a tiny top group, ops/planes._merged_view: the
// in-place sweep of a dense block there — a lone top-group block, E (x) I,
// or the unfactorized hpair's merged operator — and the density seeds of
// the top two groups, without a diagonal run) run on the tensor cores:
// csrc/tc_apply.cuh, 3xTF32 in the "f32" dot mode, three bf16 products in
// bf16x3, the storage kinds taken at run time. This file's own kernel
// (high_apply.cuh) takes X = 8..64 on f32 planes.
//
// Design (X <= 64): a "column" is one (i, m, l) position, its X amplitudes
// X apart by Q = M 128. A block of 256 threads takes 8192 / X consecutive
// columns (all of one i, since they divide Q), reads the whole X-deep tile
// into shared memory (64 KB) before it writes, so the output may be the
// input, and each thread keeps 8 rows x 4 columns of the product in
// registers while 16-deep tiles of E stream through shared memory.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of /
// store_as on its input and its dot_mode), and f16 input (the per-term
// fallback of a dense cross-group gate under "f16" storage hands the
// kernel the cotangent, plane_scan._apply_dense_cross): at X = 8..64 the
// variants of high_apply.cuh's kernel build in a library of their own
// (high_apply_fwd16.cu); at X >= 128 the tensor-core kernel takes them.

#include "high_apply.cuh"
#include "tc_apply.cuh"

// On the view (A1, X, Q = M 128): y <- [acc +] conj?([D] E x [D]), X in
// {8, 16, 32, 64} (X >= 128: dqc_tc_apply). y may be x (in place); with
// has_acc, y holds the accumulator and is added to. With has_diag, Q must
// be a multiple of 128 * 128 (M = post * 128). x is f32 and the products
// f32 here (dqc_high_apply_fwd16 the rest); y is stored as ykind (0 f32, 1
// bf16, 2 f16; the seed modes' cotangent planes). Returns
// cudaGetLastError().
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
  if (ykind < 0 || ykind > 2 || xkind != F || x3)
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
#define DQC_HIGH_CASE(XX)                                                    \
  case XX:                                                                   \
    return launch<XX>(xr, xi, yr, yi, ykind, er, ei, d, has_diag, diag_first, \
                      conj, has_acc, A1, Q, s);
  switch (X) {
    DQC_HIGH_CASE(8)
    DQC_HIGH_CASE(16)
    DQC_HIGH_CASE(32)
    DQC_HIGH_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQC_HIGH_CASE
}

// The same on the tensor cores for X in {128, 256, 512} (tc_apply.cuh): a
// diagonal run at X = 128 only; Q a multiple of 64 (32 at X = 512). x is
// stored as xkind, y as ykind (0 f32, 1 bf16, 2 f16; y may be x, of one
// storage); x3 runs bf16x3, else 3xTF32; op is E pre-split for that mode
// (ops/kernels/_tc.tc_operator). Returns cudaGetLastError().
extern "C" int dqc_tc_apply(const void* xr, const void* xi, void* yr, void* yi,
                            int xkind, int ykind, const uint32_t* op,
                            const float* sl_r, const float* sl_i,
                            const float* as_r, const float* as_i,
                            const float* al_r, const float* al_i, int has_diag,
                            int diag_first, int conj, int has_acc, int x3,
                            long long A1, int X, long long Q, void* stream) {
  if (ykind < 0 || ykind > 2 || xkind < 0 || xkind > 2 ||
      (xr == yr && xkind != ykind))
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
#define DQC_TC_CASE(XX)                                                     \
  case XX:                                                                  \
    return dqc::launch_tc<XX>(xr, xi, yr, yi, xkind, ykind, x3, op, d,      \
                              has_diag, diag_first, conj, has_acc, A1, Q, s);
  switch (X) {
    DQC_TC_CASE(128)
    DQC_TC_CASE(256)
    DQC_TC_CASE(512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQC_TC_CASE
}
