// One-pass adjoint step of a lane + sublane block pair on f32 planes.
//
// Replaces the TPU kernel block_backward_dual
// (dqc_tpu/ops/pallas/block_backward.py:437, pallas_call at :499, body
// _kernel_dual at :240), with its diag_q outputs: the backward mirror of
// dual_group_apply_planes. For
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
// over every slab. With diag_q, the run's Q reductions of the holomorphic
// product Q[a, s, l] = B F, taken where the planes meet the run (before its
// update): Qsl (128 x 128, summed over every slab), Qas (A x 128, summed over
// l) and Qal (A x 128, summed over s) — the gradient sources of a run with
// variable gates (plane_scan._diag_cts_from_Q).
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
// into its own partial slots, added in block order by a second kernel. The
// Q reductions are formed in the step that meets the run, from the tiles of
// F and B already in shared memory (adjoint.cuh q_tile): Qsl into one more
// partial slot per block (2 x 64 KB, in the tile's order so that a warp's
// reductions land on adjacent entries: transposed when the run meets a lane
// step), added by the same second pass; the
// rows of Qas and Qal by warp shuffles and a fixed-order sum of per-warp
// column partials, written by the block that owns the slab. Q adds 2 complex
// multiply-adds and 4 reductions per amplitude of the step that meets the
// run, and 2 x 2 A x 128 + 2 x 128 x 128 floats of outputs.
//
// Reduced storage and bf16x3 (the TPU kernel's bwd_dot_mode and
// gram_dot_mode at block_backward.py:283-308): B is stored as f32, bf16 or
// f16 (bkind; F stays f32), the two transports run bf16x3 with bwd_x3 and
// the two pair grams with gram_x3, the uncomputes in f32. B is rounded to
// its storage where the TPU kernel stores and reloads it: between the two
// steps (here the staging through the planes) and next to the run.
// The transports' bf16x3 costs two FMAs per real product and the operand
// splits, the pair grams' runs on the tensor cores (adjoint.cuh); the bytes
// move with the storage: 24 per amplitude with a 16-bit B against 32.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on F and its dot_mode): F may be stored as bf16 (fkind, runtime, as B;
// rounded where the TPU kernel stores and reloads it, as B) and the two
// uncomputes run bf16x3 with dot_x3 (adjoint.cuh UX3): 16 bytes per
// amplitude with both pairs 16-bit.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;

constexpr int N = dqc::kGroup;
constexpr int kSlab = N * N;
// per block: T0_lane (re, im), T0_sub (re, im) and, with diag_q, Qsl (re, im)
constexpr int kPartFloats = 4 * kSlab;
constexpr int kPartFloatsQ = 6 * kSlab;

struct QRows {  // the (A, 128) outputs Qas and Qal
  float* as_r;
  float* as_i;
  float* al_r;
  float* al_i;
};

template <bool TX3, bool GX3, bool UX3>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_dual_kernel(char* fr, char* fi, char* br, char* bi,
                           int bkind, int fkind, Operators lane, Operators sub,
                           DiagTables dinv, DiagTables dfwd, int has_diag,
                           int diag_first_fwd, int g0_first, int diag_q,
                           QRows qrows, float* part, int64_t A) {
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  extern __shared__ float smem[];
  const int part_floats = diag_q ? kPartFloatsQ : kPartFloats;
  float* part_lane = part + (int64_t)blockIdx.x * part_floats;
  float* part_sub = part_lane + 2 * kSlab;
  dqc::QView qv{part_sub + 2 * kSlab, qrows.as_r, qrows.as_i, qrows.al_r,
                qrows.al_i, 0, 0, 0};
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
        qv.a = a;
        qv.sublane = sublane;
        qv.c0 = 64 * h;
        dqc::adjoint_tile<N, TX3, GX3, dqc::QView, UX3>(
            fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize,
            bkind, 1, rs, cs, sublane ? sub : lane, diag_mode, vi, vf,
            sublane ? part_sub : part_lane, smem,
            diag_q && diag_mode ? &qv : nullptr, fkind);
      }
    }
  }
}

template <bool TX3, bool GX3, bool UX3>
int launch(void* fr, void* fi, void* br, void* bi, int bkind, int fkind,
           const Operators& lane, const Operators& sub, const DiagTables& dinv,
           const DiagTables& dfwd, int has_diag, int diag_first_fwd,
           int g0_first, int diag_q, const QRows& qrows, float* part,
           int64_t A, int nblk, cudaStream_t s) {
  constexpr int kSmem = AdjCfg<N>::kSmemBytes;
  auto kernel = block_backward_dual_kernel<TX3, GX3, UX3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, dqc::kAdjThreads, kSmem, s>>>(
      static_cast<char*>(fr), static_cast<char*>(fi), static_cast<char*>(br),
      static_cast<char*>(bi), bkind, fkind, lane, sub, dinv, dfwd, has_diag,
      diag_first_fwd, g0_first, diag_q, qrows, part, A);
  return (int)cudaGetLastError();
}

}  // namespace

// In place on planes (A, 128, 128): (F, B) <- the adjoint step of the lane
// operator E0 and sublane operator E1; out = (T0_lane re, im, T0_sub re, im),
// 4 x 128 x 128 floats, then with diag_q (Qsl re, im), 2 x 128 x 128 more,
// transposed ([l][s]) when the run meets the lane step: the step after the
// pair with diag_first_fwd, the step before it otherwise; the lane step is
// the second with g0_first. B is stored as bkind (0 f32, 1 bf16, 2 f16 in
// common.cuh's codec), F as fkind (0 f32, 1 bf16); bwd_x3 / gram_x3 /
// dot_x3 run the transports / the pair grams / the uncomputes bf16x3.
// part is scratch of nblk * (4 or 6) * 128 * 128 floats, set to zero by the
// caller, and nblk the number of blocks (at most A). The twelve table
// pointers may be null when has_diag is 0. With diag_q (needs has_diag),
// qas_r/i and qal_r/i are (A, 128) outputs set to zero by the caller (null
// without). Returns cudaGetLastError().
extern "C" int dqc_block_backward_dual(
    void* fr, void* fi, void* br, void* bi, const float* e0inv_r,
    const float* e0inv_i, const float* e0_r, const float* e0_i,
    const float* e1inv_r, const float* e1inv_i, const float* e1_r,
    const float* e1_i, const float* isl_r, const float* isl_i,
    const float* ias_r, const float* ias_i, const float* ial_r,
    const float* ial_i, const float* sl_r, const float* sl_i,
    const float* as_r, const float* as_i, const float* al_r,
    const float* al_i, int has_diag, int diag_first_fwd, int g0_first,
    int diag_q, float* qas_r, float* qas_i, float* qal_r, float* qal_i,
    float* part, float* out, long long A, int nblk, int bkind, int bwd_x3,
    int gram_x3, int fkind, int dot_x3, void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A || (diag_q && !has_diag) || bkind < 0 ||
      bkind > 2 || fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Operators lane{e0inv_r, e0inv_i, e0_r, e0_i};
  const Operators sub{e1inv_r, e1inv_i, e1_r, e1_i};
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const QRows qrows{qas_r, qas_i, qal_r, qal_i};
  int code;
#define DQC_DUAL_LAUNCH(T, G, U)                                              \
  code = launch<T, G, U>(fr, fi, br, bi, bkind, fkind, lane, sub, dinv, dfwd, \
                         has_diag, diag_first_fwd, g0_first, diag_q, qrows,  \
                         part, (int64_t)A, nblk, s)
#define DQC_DUAL_MODES(U)                                 \
  if (bwd_x3 && gram_x3) DQC_DUAL_LAUNCH(true, true, U);  \
  else if (bwd_x3) DQC_DUAL_LAUNCH(true, false, U);       \
  else if (gram_x3) DQC_DUAL_LAUNCH(false, true, U);      \
  else DQC_DUAL_LAUNCH(false, false, U);
  if (dot_x3) {
    DQC_DUAL_MODES(true)
  } else {
    DQC_DUAL_MODES(false)
  }
#undef DQC_DUAL_MODES
#undef DQC_DUAL_LAUNCH
  if (code != 0) return code;
  return dqc::launch_reduce(part, out, nblk,
                            diag_q ? kPartFloatsQ : kPartFloats, s);
}
