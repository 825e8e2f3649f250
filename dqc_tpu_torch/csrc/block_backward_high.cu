// One-pass adjoint step of a high-group block on f32 planes.
//
// Replaces the TPU kernel block_backward_high
// (dqc_tpu/ops/pallas/block_backward.py:906, pallas_call at :995), for
// X <= 128 and without its diag_q outputs. On the view (A1, X, Q = M 128)
// of the forward planes F and the cotangent planes B, with the group's
// operator E (X x X) on axis X, for every column:
//
//   F <- Einv F,   T0 += B F^T (contract the columns),   B <- E^T B
//
// with an optional fused diagonal run rolled back (F *= Dinv, B *= D) before
// the dense stage when the run followed it in the forward
// (diag_first_fwd = 0), after it otherwise. The run's tables are read in
// their canonical layout, tsl (128, 128) and tas/tal (A, 128), at
// a = (i X + x) post + p for view element (i, x, q = (p 128 + s) 128 + l),
// as csrc/high_apply.cu reads them.
//
// Bound: operations. Three X-wide complex products per column, 3 X complex
// multiply-adds per amplitude (8 real flops each) against 32 bytes read and
// written: ~96 flop per byte at X = 128, above the H100's FP32 ridge
// (~20 flop/B). f32 FMA on the CUDA cores, no TF32.
//
// Design: adjoint.cuh on tiles of 8192 / X columns (all of one i, since
// they divide Q), in place: 512 threads, the uncompute and the transport at
// once on the two halves of the block. A grid of one block per SM loops over
// the tiles, and the pair grams' per-block, per-group partial slots are
// added in a fixed order by a second kernel.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;

template <int X>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_high_kernel(float* fr, float* fi, float* br, float* bi,
                           Operators ops, DiagTables dinv, DiagTables dfwd,
                           int has_diag, int diag_first_fwd, float* part,
                           int64_t Q, int64_t post, int64_t ntiles) {
  using Cfg = AdjCfg<X>;
  extern __shared__ float smem[];
  float* slots = part + (int64_t)blockIdx.x * Cfg::G * Cfg::kSlotFloats;
  const int diag_mode = has_diag ? (diag_first_fwd ? 2 : 1) : 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * Cfg::C;
    const int64_t i = g0 / Q;
    const int64_t q0 = g0 - i * Q;
    const int64_t t = i * X * Q + q0;
    DiagView vi{dinv, 2, i, q0, X, post};
    DiagView vf{dfwd, 2, i, q0, X, post};
    dqc::adjoint_tile<X>(fr + t, fi + t, br + t, bi + t, Q, 1, ops, diag_mode,
                         vi, vf, slots, smem);
  }
}

template <int X>
int launch(float* fr, float* fi, float* br, float* bi, const Operators& ops,
           const DiagTables& dinv, const DiagTables& dfwd, int has_diag,
           int diag_first_fwd, float* part, float* out, long long A1,
           long long Q, int nblk, cudaStream_t stream) {
  using Cfg = AdjCfg<X>;
  if (Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = A1 * (Q / Cfg::C);
  if (ntiles <= 0 || nblk <= 0 || nblk > ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_backward_high_kernel<X>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  block_backward_high_kernel<X><<<nblk, dqc::kAdjThreads, Cfg::kSmemBytes,
                                  stream>>>(
      fr, fi, br, bi, ops, dinv, dfwd, has_diag, diag_first_fwd, part,
      (int64_t)Q, (int64_t)(Q >> 14), (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return dqc::launch_reduce(part, out, (int64_t)nblk * Cfg::G,
                            Cfg::kSlotFloats, stream);
}

}  // namespace

// The number of partial slots per block of the pair gram at this X (the
// caller sizes the scratch: nblk * slots * 2 * X * X floats), 0 for an X the
// kernel does not take.
extern "C" int dqc_block_backward_high_slots(int X) {
  switch (X) {
    case 8: return AdjCfg<8>::G;
    case 16: return AdjCfg<16>::G;
    case 32: return AdjCfg<32>::G;
    case 64: return AdjCfg<64>::G;
    case 128: return AdjCfg<128>::G;
    default: return 0;
  }
}

// In place on the view (A1, X, Q = M 128), X in {8, 16, 32, 64, 128}:
// (F, B) <- the adjoint step of E; out = (T0 re, T0 im), 2 x X x X floats.
// part is scratch of nblk * slots(X) * 2 X X floats, set to zero by the
// caller; nblk is the number of blocks (at most the number of tiles,
// A1 Q X / 8192). With has_diag, Q must be a multiple of 128 * 128. The
// twelve table pointers may be null when has_diag is 0. Returns
// cudaGetLastError().
extern "C" int dqc_block_backward_high(
    float* fr, float* fi, float* br, float* bi, const float* einv_r,
    const float* einv_i, const float* e_r, const float* e_i,
    const float* isl_r, const float* isl_i, const float* ias_r,
    const float* ias_i, const float* ial_r, const float* ial_i,
    const float* sl_r, const float* sl_i, const float* as_r,
    const float* as_i, const float* al_r, const float* al_i, int has_diag,
    int diag_first_fwd, float* part, float* out, long long A1, int X,
    long long Q, int nblk, void* stream) {
  if (has_diag && Q % (128 * 128) != 0) return (int)cudaErrorInvalidValue;
  const Operators ops{einv_r, einv_i, e_r, e_i};
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 8: return launch<8>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                             diag_first_fwd, part, out, A1, Q, nblk, s);
    case 16: return launch<16>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, part, out, A1, Q, nblk, s);
    case 32: return launch<32>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, part, out, A1, Q, nblk, s);
    case 64: return launch<64>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, part, out, A1, Q, nblk, s);
    case 128: return launch<128>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                                 diag_first_fwd, part, out, A1, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
