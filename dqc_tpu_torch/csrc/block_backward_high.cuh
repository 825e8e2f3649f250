// The one-pass adjoint step of a high-group block at X = 8..64 on the CUDA
// cores (adjoint.cuh), shared by block_backward_high.cu (f32 F with an f32
// uncompute) and block_backward_high_fwd16.cu (bf16 F and the bf16x3
// uncompute, a library of its own so that the two build in parallel), and
// the tile walk the tensor-core step at X = 128 (block_backward_high.cu)
// shares with it. block_backward_high.cu's header comment describes the
// kernels.
#pragma once

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;
using dqc::QHigh;

constexpr int kSl = dqc::kGroup * dqc::kGroup;

struct QOut {  // the diag_q outputs: Qas, Qal rows (A, 128), Qsl partial slots
  float* as_r;
  float* as_i;
  float* al_r;
  float* al_i;
  float* sl_part;  // nblk x 2 x 128 x 128
};

// tile(i, q0) for each tile of C columns of the view (A1, X, Q) that this
// block takes (ntiles in all, the first at element i X Q + q0 of the
// planes), in order: with diag_q whole (i, p) groups of 128 x 128 columns,
// so that each Qas and Qal entry has one block as its writer.
template <int C, class Tile>
__device__ __forceinline__ void for_each_tile(int64_t Q, int64_t ntiles,
                                              int diag_q, Tile&& tile) {
  const int64_t per_group = diag_q ? kSl / C : 1;
  for (int64_t grp = blockIdx.x; grp < ntiles / per_group; grp += gridDim.x) {
    for (int64_t k = 0; k < per_group; ++k) {
      const int64_t g0 = (grp * per_group + k) * C;
      const int64_t i = g0 / Q;
      tile(i, g0 - i * Q);
    }
  }
}

// F is stored as FK, a compile-time kind, so that the f32 instances keep
// their plain loads and stores; FK = -1 takes it at run time (fkind).
template <int X, bool TX3, bool GX3, bool UX3, int FK>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_high_kernel(char* fr, char* fi, char* br, char* bi, int bkind,
                           int fkind, Operators ops, DiagTables dinv,
                           DiagTables dfwd, int has_diag, int diag_first_fwd,
                           int diag_q, QOut qo, float* part, int64_t Q,
                           int64_t post, int64_t ntiles) {
  using Cfg = AdjCfg<X>;
  extern __shared__ float smem[];
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  if constexpr (FK >= 0) fkind = FK;
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  float* slots = part + (int64_t)blockIdx.x * Cfg::G * Cfg::kSlotFloats;
  const int diag_mode = has_diag ? (diag_first_fwd ? 2 : 1) : 0;
  QHigh qh{qo.sl_part + (int64_t)blockIdx.x * 2 * kSl, qo.as_r, qo.as_i,
           qo.al_r, qo.al_i, 0, 0, post};
  for_each_tile<Cfg::C>(Q, ntiles, diag_q, [&](int64_t i, int64_t q0) {
    const int64_t t = i * X * Q + q0;
    DiagView vi{dinv, 2, i, q0, X, post};
    DiagView vf{dfwd, 2, i, q0, X, post};
    qh.i = i;
    qh.q0 = q0;
    dqc::adjoint_tile<X, TX3, GX3, UX3, FK>(
        fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize, bkind,
        Q, 1, ops, diag_mode, vi, vf, slots, smem, diag_q ? &qh : nullptr,
        fkind);
  });
}

// The number of tiles of C columns of the view (A1, X, Q), or 0 when Q is
// not a multiple of C or nblk is not in 1 .. the blocks' units of work
// (tiles, or with diag_q (i, p) groups).
inline long long high_tiles(int C, long long A1, long long Q, int diag_q,
                            int nblk) {
  if (Q % C != 0) return 0;
  const long long ntiles = A1 * (Q / C);
  const long long units = diag_q ? ntiles / (kSl / C) : ntiles;
  return units <= 0 || nblk <= 0 || nblk > units ? 0 : ntiles;
}

// After a launch: cudaGetLastError(), then the fixed-order sums of the pair
// gram's nslots slots of slot_floats each and, with diag_q, of Qsl's.
inline int high_reduce(float* part, float* out, long long nslots,
                       int slot_floats, int diag_q, const QOut& qo, float* qsl,
                       int nblk, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int code = dqc::launch_reduce(part, out, nslots, slot_floats, stream);
  if (code != 0 || !diag_q) return code;
  return dqc::launch_reduce(qo.sl_part, qsl, nblk, 2 * kSl, stream);
}

// One launch of block_backward_high_kernel<X, TX3, GX3, UX3, FK> and its
// fixed-order slot sums.
template <int X, bool TX3, bool GX3, bool UX3, int FK>
int launch(void* fr, void* fi, void* br, void* bi, int bkind, int fkind,
           const Operators& ops, const DiagTables& dinv, const DiagTables& dfwd,
           int has_diag, int diag_first_fwd, int diag_q, const QOut& qo,
           float* qsl, float* part, float* out, long long A1, long long Q,
           int nblk, cudaStream_t stream) {
  using Cfg = AdjCfg<X>;
  const long long ntiles = high_tiles(Cfg::C, A1, Q, diag_q, nblk);
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  auto kernel = block_backward_high_kernel<X, TX3, GX3, UX3, FK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, dqc::kAdjThreads, Cfg::kSmemBytes, stream>>>(
      static_cast<char*>(fr), static_cast<char*>(fi), static_cast<char*>(br),
      static_cast<char*>(bi), bkind, fkind, ops, dinv, dfwd, has_diag,
      diag_first_fwd,
      diag_q, qo, part, (int64_t)Q, (int64_t)(Q >> 14), (int64_t)ntiles);
  return high_reduce(part, out, (long long)nblk * Cfg::G, Cfg::kSlotFloats,
                     diag_q, qo, qsl, nblk, stream);
}

// Everything dqc_block_backward_high takes (the extern "C" entry points of
// block_backward_high.cu and block_backward_high_fwd16.cu).
struct HighArgs {
  void* fr;
  void* fi;
  void* br;
  void* bi;
  int bkind, fkind;
  Operators ops;
  DiagTables dinv, dfwd;
  int has_diag, diag_first_fwd, diag_q;
  QOut qo;
  float* qsl;
  float* part;
  float* out;
  long long A1, Q;
  int nblk;
  cudaStream_t stream;
};

// The transport / pair-gram modes at one X, uncompute mode UX3 and F kind FK.
template <int X, bool UX3, int FK>
int launch_modes(const HighArgs& a, int bwd_x3, int gram_x3) {
#define DQC_HIGH_MODE(T, G)                                                  \
  return launch<X, T, G, UX3, FK>(a.fr, a.fi, a.br, a.bi, a.bkind, a.fkind,  \
                                  a.ops, a.dinv, a.dfwd, a.has_diag,         \
                                  a.diag_first_fwd, a.diag_q, a.qo, a.qsl,   \
                                  a.part, a.out, a.A1, a.Q, a.nblk, a.stream)
  switch (2 * (bwd_x3 != 0) + (gram_x3 != 0)) {
    case 0: DQC_HIGH_MODE(false, false);
    case 1: DQC_HIGH_MODE(false, true);
    case 2: DQC_HIGH_MODE(true, false);
    default: DQC_HIGH_MODE(true, true);
  }
#undef DQC_HIGH_MODE
}

// The checks of the arguments that every entry takes: a run needs Q a
// multiple of 128 128, Q needs a run, the kinds are in range.
inline bool high_kinds_ok(int has_diag, int diag_q, long long Q, int bkind,
                          int fkind) {
  return !(has_diag && Q % (128 * 128) != 0) && !(diag_q && !has_diag) &&
         bkind >= 0 && bkind <= 2 && fkind >= 0 && fkind <= 1;
}

// The arguments of dqc_block_backward_high, checked; returns a CUDA error
// code (cudaSuccess when they are in range).
inline int high_args(HighArgs& a, void* fr, void* fi, void* br, void* bi,
                     const float* einv_r, const float* einv_i,
                     const float* e_r, const float* e_i, const float* isl_r,
                     const float* isl_i, const float* ias_r,
                     const float* ias_i, const float* ial_r,
                     const float* ial_i, const float* sl_r, const float* sl_i,
                     const float* as_r, const float* as_i, const float* al_r,
                     const float* al_i, int has_diag, int diag_first_fwd,
                     int diag_q, float* qas_r, float* qas_i, float* qal_r,
                     float* qal_i, float* qpart, float* qsl, float* part,
                     float* out, long long A1, long long Q, int nblk,
                     int bkind, int fkind, void* stream) {
  if (!high_kinds_ok(has_diag, diag_q, Q, bkind, fkind))
    return (int)cudaErrorInvalidValue;
  a = HighArgs{fr, fi, br, bi, bkind, fkind,
               Operators{einv_r, einv_i, e_r, e_i},
               DiagTables{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i},
               DiagTables{sl_r, sl_i, as_r, as_i, al_r, al_i},
               has_diag, diag_first_fwd, diag_q,
               QOut{qas_r, qas_i, qal_r, qal_i, qpart},
               qsl, part, out, A1, Q, nblk, (cudaStream_t)stream};
  return (int)cudaSuccess;
}

}  // namespace

// The parameter list of dqc_block_backward_high and its fwd16 counterpart,
// and the call that checks and packs it.
#define DQC_HIGH_PARAMS                                                       \
    void *fr, void *fi, void *br, void *bi, const float *einv_r,              \
        const float *einv_i, const float *e_r, const float *e_i,              \
        const float *isl_r, const float *isl_i, const float *ias_r,           \
        const float *ias_i, const float *ial_r, const float *ial_i,           \
        const float *sl_r, const float *sl_i, const float *as_r,              \
        const float *as_i, const float *al_r, const float *al_i,              \
        int has_diag, int diag_first_fwd, int diag_q, float *qas_r,           \
        float *qas_i, float *qal_r, float *qal_i, float *qpart, float *qsl,   \
        float *part, float *out, long long A1, int X, long long Q, int nblk,  \
        int bkind, int bwd_x3, int gram_x3, int fkind, int dot_x3,            \
        void *stream
#define DQC_HIGH_ARGS(a)                                                      \
  high_args(a, fr, fi, br, bi, einv_r, einv_i, e_r, e_i, isl_r, isl_i, ias_r, \
            ias_i, ial_r, ial_i, sl_r, sl_i, as_r, as_i, al_r, al_i,          \
            has_diag, diag_first_fwd, diag_q, qas_r, qas_i, qal_r, qal_i,     \
            qpart, qsl, part, out, A1, Q, nblk, bkind, fkind, stream)

