// The "bf16" storage and forward bf16x3 variants of the high-group apply at
// X = 8..64: x stored as bf16 (in place, or a seed into bf16 cotangent
// planes) or as f16 bits (into f16 planes: the per-term fallback's sweeps
// on an "f16" cotangent) and / or the product in bf16x3 (into any
// storage), with or without a folded diagonal run.
//
// Replaces, with high_apply.cu, the TPU kernel high_group_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:76) on the narrow high groups: group 2
// at n = 17-20, group 3 at n = 24-27 and the CNOT ring's X = 8 span views,
// where the TPU kernel decodes its input through common.f32_of, stores
// through store_as and takes make_dot(dot_mode) at every X. The kernel is
// high_apply.cuh's (bound by operations at bf16x3's split products; by
// bytes on bf16 planes below X = 32 at f32), in a library of its own so
// that its build runs beside high_apply.cu's.

#include "high_apply.cuh"

// dqc_high_apply's contract (high_apply.cu), for X in {8, 16, 32, 64} with
// x stored as xkind (0 f32, 1 bf16, 2 f16: into y of its storage) or the
// product bf16x3 (x3); f32 x with f32 products is dqc_high_apply's. Returns
// cudaGetLastError().
extern "C" int dqc_high_apply_fwd16(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind,
                                    const float* er, const float* ei,
                                    const float* sl_r, const float* sl_i,
                                    const float* as_r, const float* as_i,
                                    const float* al_r, const float* al_i,
                                    int has_diag, int diag_first, int conj,
                                    int has_acc, int x3, long long A1, int X,
                                    long long Q, void* stream) {
  if (has_diag && Q % (128 * 128) != 0) return (int)cudaErrorInvalidValue;
  if (ykind < 0 || ykind > 2 || xkind < 0 || xkind > 2 ||
      (xkind == dqc::kStoreF32 && !x3))
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
#define DQC_FWD16_X(XX)                                                  \
  case XX:                                                               \
    return launch_fwd16<XX>(xr, xi, yr, yi, xkind, ykind, x3, er, ei, d, \
                            has_diag, diag_first, conj, has_acc, A1, Q, s);
    DQC_FWD16_X(8)
    DQC_FWD16_X(16)
    DQC_FWD16_X(32)
    DQC_FWD16_X(64)
#undef DQC_FWD16_X
    default: return (int)cudaErrorInvalidValue;
  }
}
