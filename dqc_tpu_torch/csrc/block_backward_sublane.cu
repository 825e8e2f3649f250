// One-pass adjoint step of an unpaired sublane-group block on the planes.
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
// Design: the sublane step of the dual adjoint alone, on adjoint.cuh's
// CUDA-core step (the dual adjoint's runs on the tensor cores,
// tc_adjoint.cuh). F and B of one
// slab (256 KB) do not fit a block's shared memory, but the step is
// separable along the lanes, so a block walks its slab as two 64-lane column
// tiles of adjoint.cuh's step (512 threads, the uncompute and the transport
// on the two halves, in place). A grid of one block per SM loops over the
// slabs; each block sums its pair gram into its own partial slot (one writer
// per entry), and a second kernel adds the slots in block order, so the
// result does not depend on scheduling.
//
// Reduced cotangent storage and bf16x3 (the TPU kernel's f32_of / store_as
// and bwd_dot_mode / gram_dot_mode): B may be stored as bf16 or f16 (one
// decode on load, one encode on store, F stays f32), and the transport and
// the pair gram may run bf16x3, as adjoint.cuh does them for the dual and
// high adjoints.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on F and its dot_mode): F may be stored as bf16 (one load and one store
// per element; the pair gram reads the unrounded uncompute, as the TPU
// kernel's does) and the uncompute may run bf16x3 (adjoint.cuh UX3). These
// variants take F's kind at run time (adjoint.cuh: a loop per kind); the
// f32 instances keep their code.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;

constexpr int N = dqc::kGroup;
constexpr int kSlab = N * N;
constexpr int kPartFloats = 2 * kSlab;  // T0 (re, im)

// FWD16: the variants of bf16 F (fkind) and the bf16x3 uncompute (UX3);
// the f32 instances (FWD16 false) read F as f32.
template <bool TX3, bool GX3, bool UX3, bool FWD16>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_sublane_kernel(char* fr, char* fi, char* br, char* bi,
                              int bkind, int fkind, Operators ops, float* part,
                              int64_t A) {
  extern __shared__ float smem[];
  float* slot = part + (int64_t)blockIdx.x * kPartFloats;
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  if constexpr (!FWD16) fkind = dqc::kStoreF32;
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  const DiagView none{DiagTables{}, 0, 0, 0, N, 0};
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    for (int h = 0; h < 2; ++h) {
      // column tile l in [64 h, 64 h + 64): x = s at stride N, c = l
      const int64_t t = a * kSlab + 64 * h;
      if constexpr (FWD16)
        dqc::adjoint_tile<N, TX3, GX3, dqc::QView, UX3>(
            fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize,
            bkind, 0, N, 1, ops, 0, none, none, slot, smem, nullptr, fkind);
      else
        dqc::adjoint_tile<N, TX3, GX3>(fr + t * 4, fi + t * 4, br + t * bsize,
                                       bi + t * bsize, bkind, 0, N, 1, ops,
                                       0, none, none, slot, smem);
    }
  }
}

template <bool TX3, bool GX3, bool UX3, bool FWD16>
int launch(char* fr, char* fi, char* br, char* bi, int bkind, int fkind,
           const Operators& ops, float* part, long long A, int nblk,
           cudaStream_t s) {
  constexpr int kSmem = AdjCfg<N>::kSmemBytes;
  auto kernel = block_backward_sublane_kernel<TX3, GX3, UX3, FWD16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, dqc::kAdjThreads, kSmem, s>>>(fr, fi, br, bi, bkind, fkind,
                                               ops, part, (int64_t)A);
  return (int)cudaGetLastError();
}

}  // namespace

// In place on planes (A, 128, 128): (F, B) <- the adjoint step of the
// sublane operator E; out = (T0 re, T0 im), 2 x 128 x 128 floats. part is
// scratch of nblk * 2 * 128 * 128 floats, set to zero by the caller, and
// nblk the number of blocks (at most A). B is stored as bkind (0 f32, 1
// bf16, 2 f16), F as fkind (0 f32, 1 bf16); bwd_x3 / gram_x3 / dot_x3 run
// the transport / the pair gram / the uncompute bf16x3 (adjoint.cuh).
// Returns cudaGetLastError().
extern "C" int dqc_block_backward_sublane(void* fr, void* fi, void* br,
                                       void* bi, int bkind, int fkind,
                                       const float* einv_r,
                                       const float* einv_i, const float* e_r,
                                       const float* e_i, float* part,
                                       float* out, long long A, int nblk,
                                       int bwd_x3, int gram_x3, int dot_x3,
                                       void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A || bkind < 0 || bkind > 2 ||
      fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Operators ops{einv_r, einv_i, e_r, e_i};
  char* f_r = static_cast<char*>(fr);
  char* f_i = static_cast<char*>(fi);
  char* b_r = static_cast<char*>(br);
  char* b_i = static_cast<char*>(bi);
  const int mode = 2 * (bwd_x3 != 0) + (gram_x3 != 0);
#define DQC_SUB(T, G, U, W)                                                 \
  code = launch<T, G, U, W>(f_r, f_i, b_r, b_i, bkind, fkind, ops, part, A, \
                            nblk, s);                                       \
  break
#define DQC_SUB_MODES(U, W)                       \
  switch (mode) {                                 \
    case 0: DQC_SUB(false, false, U, W);          \
    case 1: DQC_SUB(false, true, U, W);           \
    case 2: DQC_SUB(true, false, U, W);           \
    default: DQC_SUB(true, true, U, W);           \
  }
  int code;
  if (dot_x3) {
    DQC_SUB_MODES(true, true)
  } else if (fkind != dqc::kStoreF32) {
    DQC_SUB_MODES(false, true)
  } else {
    DQC_SUB_MODES(false, false)
  }
#undef DQC_SUB_MODES
#undef DQC_SUB
  if (code != 0) return code;
  return dqc::launch_reduce(part, out, nblk, kPartFloats, s);
}
