// The "bf16" storage and forward bf16x3 variants of the high-group adjoint
// at X = 8..64: F stored as bf16 and / or the uncompute in bf16x3, with
// every storage of B and every transport / pair-gram mode.
//
// Replaces, with block_backward_high.cu, the TPU kernel block_backward_high
// (dqc_tpu/ops/pallas/block_backward.py:906) on the narrow high groups:
// group 2 at n = 17-20, group 3 at n = 24-27 and the CNOT ring's X = 8 span
// views, where the TPU kernel decodes F through common.f32_of, stores it
// through store_as and takes make_dot(dot_mode) at every X. The kernel is
// block_backward_high.cuh's (adjoint.cuh's one-pass step; bound by
// operations, 3 X complex multiply-adds per amplitude against 16 bytes of F
// and B moved at bf16, 32 at f32), instantiated with F's kind at run time
// (FK = -1: one branch per tile to a loop of each kind), in a library of
// its own so that its build runs beside block_backward_high.cu's.

#include "block_backward_high.cuh"

// dqc_block_backward_high's contract (block_backward_high.cu), for X in
// {8, 16, 32, 64} with F stored as fkind (0 f32, 1 bf16) and the uncompute
// bf16x3 with dot_x3; f32 F with an f32 uncompute is
// dqc_block_backward_high's. Returns cudaGetLastError().
extern "C" int dqc_block_backward_high_fwd16(DQC_HIGH_PARAMS) {
  HighArgs a;
  const int code = DQC_HIGH_ARGS(a);
  if (code != 0) return code;
  if (fkind == dqc::kStoreF32 && !dot_x3) return (int)cudaErrorInvalidValue;
  switch (X) {
#define DQC_HIGH_FWD16(XX)                                              \
  case XX:                                                              \
    return dot_x3 ? launch_modes<XX, true, -1>(a, bwd_x3, gram_x3)      \
                  : launch_modes<XX, false, -1>(a, bwd_x3, gram_x3);
    DQC_HIGH_FWD16(8)
    DQC_HIGH_FWD16(16)
    DQC_HIGH_FWD16(32)
    DQC_HIGH_FWD16(64)
#undef DQC_HIGH_FWD16
    default: return (int)cudaErrorInvalidValue;
  }
}
