// One-pass adjoint step of an unpaired sublane-group block on f32 planes.
//
// Replaces the TPU kernel block_backward_sublane
// (dqc_tpu/ops/pallas/block_backward.py:184, body _kernel_sub at :133): for
// every 128 x 128 slab of the forward planes F and the cotangent planes B
// (A, 128, 128), with the sublane-group operator E (qubits 7..13, the
// middle axis),
//
//   F <- Einv F,   T0 += B F^T (contract the lanes),   B <- E^T B
//
// with the pair gram holomorphic (no conjugation; B is the incoming
// cotangent, F the uncomputed planes) and summed over every slab.
//
// Bound: operations. Three 128-wide complex products per slab, 384 complex
// multiply-adds per amplitude (8 real flops each), against 32 bytes read and
// written: ~96 flop per byte, above the H100's FP32 ridge (~20 flop/B). f32
// FMA on the CUDA cores, no TF32.
//
// Design: the sublane step of block_backward_dual.cu alone. F and B of one
// slab (256 KB) do not fit a block's shared memory, but the step is
// separable along the lanes, so a block walks its slab as two 64-lane column
// tiles of adjoint.cuh's step (512 threads, the uncompute and the transport
// on the two halves, in place). A grid of one block per SM loops over the
// slabs; each block sums its pair gram into its own partial slot (one writer
// per entry), and a second kernel adds the slots in block order, so the
// result does not depend on scheduling.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;

constexpr int N = dqc::kGroup;
constexpr int kSlab = N * N;
constexpr int kPartFloats = 2 * kSlab;  // T0 (re, im)

__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_sublane_kernel(float* fr, float* fi, float* br, float* bi,
                              Operators ops, float* part, int64_t A) {
  extern __shared__ float smem[];
  float* slot = part + (int64_t)blockIdx.x * kPartFloats;
  const DiagView none{DiagTables{}, 0, 0, 0, N, 0};
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    for (int h = 0; h < 2; ++h) {
      // column tile l in [64 h, 64 h + 64): x = s at stride N, c = l
      const int64_t t = a * kSlab + 64 * h;
      dqc::adjoint_tile<N>(fr + t, fi + t, br + t, bi + t, N, 1, ops, 0, none,
                           none, slot, smem);
    }
  }
}

}  // namespace

// In place on planes (A, 128, 128): (F, B) <- the adjoint step of the
// sublane operator E; out = (T0 re, T0 im), 2 x 128 x 128 floats. part is
// scratch of nblk * 2 * 128 * 128 floats, set to zero by the caller, and
// nblk the number of blocks (at most A). Returns cudaGetLastError().
extern "C" int dqc_block_backward_sublane(float* fr, float* fi, float* br,
                                          float* bi, const float* einv_r,
                                          const float* einv_i,
                                          const float* e_r, const float* e_i,
                                          float* part, float* out,
                                          long long A, int nblk,
                                          void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A) return (int)cudaErrorInvalidValue;
  constexpr int kSmem = AdjCfg<N>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_backward_sublane_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Operators ops{einv_r, einv_i, e_r, e_i};
  block_backward_sublane_kernel<<<nblk, dqc::kAdjThreads, kSmem, s>>>(
      fr, fi, br, bi, ops, part, (int64_t)A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dqc::launch_reduce(part, out, nblk, kPartFloats, s);
}
