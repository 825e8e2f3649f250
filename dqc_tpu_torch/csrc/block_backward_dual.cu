// One-pass adjoint step of a lane + sublane block pair on f32 planes.
//
// Replaces the TPU kernel block_backward_dual
// (dqc_tpu/ops/pallas/block_backward.py:437, pallas_call at :499), without
// its diag_q outputs: the backward mirror of dual_group_apply_planes. For
// every 128 x 128 slab of the forward planes F and the cotangent planes B
// (A, 128, 128), with lane operator E0 (the last axis) and sublane operator
// E1 (the middle axis), in tape order:
//
//   sublane step: F <- E1inv F, T0_sub += B F^T (contract lanes), B <- E1^T B
//   lane step:    F <- F E0inv^T, T0_lane += B^T F (contract sublanes),
//                 B <- B E0
//
// With g0_first (the lane block came first in the forward) the sublane block
// is rolled back first, so its T0 sees the lane block still applied. A fused
// diagonal run is rolled back (F *= Dinv, B *= D) before both steps when it
// followed the pair in the forward (diag_first_fwd = 0), after them when it
// preceded it. The pair grams are holomorphic (no conjugation) and summed
// over every slab.
//
// Bound: operations. Six 128-wide complex products per slab, 768 complex
// multiply-adds per amplitude (8 real flops each), against 32 bytes read and
// written per amplitude: ~190 flop per byte, far above the H100's FP32
// ridge (~20 flop/B). f32 FMA on the CUDA cores, no TF32.
//
// Design: F and B of one slab are 256 KB, more than a block's 227 KB of
// shared memory. Each step is separable along the axis it does not
// contract, so a block walks its slab as two 64-wide tiles per step
// (adjoint.cuh): the sublane step in column tiles, the lane step in row
// tiles, staging the first step's results through the slab's own place in
// the planes, which only this block touches and which stays in L2. A grid
// of one block per SM loops over the slabs; each block sums its pair grams
// into its own partial slots, added in block order by a second kernel.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;

constexpr int N = dqc::kGroup;
constexpr int kSlab = N * N;
constexpr int kPartFloats = 4 * kSlab;  // T0_lane (re, im), T0_sub (re, im)

__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_dual_kernel(float* fr, float* fi, float* br, float* bi,
                           Operators lane, Operators sub, DiagTables dinv,
                           DiagTables dfwd, int has_diag, int diag_first_fwd,
                           int g0_first, float* part, int64_t A) {
  extern __shared__ float smem[];
  float* part_lane = part + (int64_t)blockIdx.x * kPartFloats;
  float* part_sub = part_lane + 2 * kSlab;
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    const int64_t off = a * kSlab;
    for (int step = 0; step < 2; ++step) {
      const bool sublane = (step == 0) == (g0_first != 0);
      int diag_mode = 0;
      if (has_diag && step == 0 && !diag_first_fwd) diag_mode = 1;
      if (has_diag && step == 1 && diag_first_fwd) diag_mode = 2;
      for (int h = 0; h < 2; ++h) {
        // sublane step: column tile l in [64 h, 64 h + 64), x = s;
        // lane step: row tile s in [64 h, 64 h + 64), x = l
        const int64_t t = sublane ? off + 64 * h : off + 64 * h * N;
        const int64_t rs = sublane ? N : 1, cs = sublane ? 1 : N;
        DiagView vi{dinv, sublane ? 0 : 1, a, 64 * h, N, 0};
        DiagView vf{dfwd, sublane ? 0 : 1, a, 64 * h, N, 0};
        dqc::adjoint_tile<N>(fr + t, fi + t, br + t, bi + t, rs, cs,
                             sublane ? sub : lane, diag_mode, vi, vf,
                             sublane ? part_sub : part_lane, smem);
      }
    }
  }
}

}  // namespace

// In place on planes (A, 128, 128): (F, B) <- the adjoint step of the lane
// operator E0 and sublane operator E1; out = (T0_lane re, im, T0_sub re, im),
// 4 x 128 x 128 floats. part is scratch of nblk * 4 * 128 * 128 floats, set
// to zero by the caller, and nblk the number of blocks (at most A). The
// twelve table pointers may be null when has_diag is 0. Returns
// cudaGetLastError().
extern "C" int dqc_block_backward_dual(
    float* fr, float* fi, float* br, float* bi, const float* e0inv_r,
    const float* e0inv_i, const float* e0_r, const float* e0_i,
    const float* e1inv_r, const float* e1inv_i, const float* e1_r,
    const float* e1_i, const float* isl_r, const float* isl_i,
    const float* ias_r, const float* ias_i, const float* ial_r,
    const float* ial_i, const float* sl_r, const float* sl_i,
    const float* as_r, const float* as_i, const float* al_r,
    const float* al_i, int has_diag, int diag_first_fwd, int g0_first,
    float* part, float* out, long long A, int nblk, void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A) return (int)cudaErrorInvalidValue;
  constexpr int kSmem = AdjCfg<N>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_backward_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Operators lane{e0inv_r, e0inv_i, e0_r, e0_i};
  const Operators sub{e1inv_r, e1inv_i, e1_r, e1_i};
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  block_backward_dual_kernel<<<nblk, dqc::kAdjThreads, kSmem, s>>>(
      fr, fi, br, bi, lane, sub, dinv, dfwd, has_diag, diag_first_fwd,
      g0_first, part, (int64_t)A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dqc::launch_reduce(part, out, nblk, kPartFloats, s);
}
