// High-group apply at X = 128, 256 and 512: y = E . x along axis X of
// (A1, X, M, 128), on the tensor cores.
//
// Replaces, with high_apply_small.cu (X = 8..64), the TPU kernel
// high_group_apply_planes (dqc_tpu/ops/pallas/high_apply.py:76, pallas_call
// at :133), forward form: a dense operator E on the contracted group axis of
// the high view, with an optional fused diagonal run multiplied before
// (diag_first) or after the product, and the seed modes of the gradient:
// conj(y), y added into accumulator planes, and output planes other than the
// input (alias=False). The run's tables are read in their canonical layout,
// tsl (128, 128) and tas/tal (A, 128), at a = (i X + x) post + p for view
// element (i, x, m = p 128 + s, l); the TPU kernel's re-laid-out table views
// (common.dh_table_views) were a Mosaic tiling need and have no counterpart
// here.
//
// X = 128 on every storage and in both dot modes, and X = 256 and 512 (the
// merged top axis of a tiny top group, ops/planes._merged_view: the
// in-place sweep of a dense block there — a lone top-group block, E (x) I,
// or the unfactorized hpair's merged operator — and the density seeds of
// the top two groups, without a diagonal run): csrc/tc_apply.cuh, whose
// header gives the bound (operations on the tensor cores: X complex
// multiply-adds per amplitude, 3xTF32 in the "f32" dot mode, three bf16
// products in bf16x3, about a 3.33 ms floor at X = 128 on 2^29 f32
// amplitudes) and the design; the storage kinds are taken at run time.
// The X = 256 / 512 adjoint's two in-place updates run through the same
// entry.

#include "tc_apply.cuh"

// On the view (A1, X, Q = M 128): y <- [acc +] conj?([D] E x [D]) on the
// tensor cores for X in {128, 256, 512} (tc_apply.cuh): a diagonal run at
// X = 128 only; Q a multiple of 64 (32 at X = 512). x is stored as xkind,
// y as ykind (0 f32, 1 bf16, 2 f16; y may be x, of one storage); x3 runs
// bf16x3, else 3xTF32; op is E pre-split for that mode
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
  const dqc::DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
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
