// The pieces the high adjoint's two one-pass steps share: the tensor-core
// step at X = 128 (block_backward_high.cu, on tc_adjoint.cuh) and the one at
// X = 8..64 (block_backward_high_small.cu): the Q outputs, the tile walk
// (whole (i, p) groups with diag_q), the count of tiles, the checks of the
// arguments and the fixed-order slot sums after a launch.
// block_backward_high.cu's header comment describes the kernels.
#pragma once

#include "adjoint.cuh"

namespace {

using dqc::DiagTables;
using dqc::DiagView;
using dqc::QHigh;

constexpr int kSl = dqc::kGroup * dqc::kGroup;

struct QOut {  // the diag_q outputs: Qas, Qal rows (A, 128), Qsl partial slots
  float* as_r;
  float* as_i;
  float* al_r;
  float* al_i;
  float* sl_part;  // nblk x 2 x 128 x 128
};

// The block's n-th tile of C columns of the view (A1, X, Q) (ntiles in all):
// false past its last, else its (i, q0), the first element i X Q + q0 of
// the planes. With diag_q the blocks take whole (i, p) groups of 128 x 128
// columns, so that each Qas and Qal entry has one block as its writer.
template <int C>
__device__ __forceinline__ bool tile_at(int64_t n, int64_t Q, int64_t ntiles,
                                        int diag_q, int64_t& i, int64_t& q0) {
  const int64_t per_group = diag_q ? kSl / C : 1;
  const int64_t grp = blockIdx.x + (n / per_group) * gridDim.x;
  if (grp >= ntiles / per_group) return false;
  const int64_t g0 = (grp * per_group + n % per_group) * C;
  i = g0 / Q;
  q0 = g0 - i * Q;
  return true;
}

// tile(i, q0) for each of this block's tiles (tile_at), in order.
template <int C, class Tile>
__device__ __forceinline__ void for_each_tile(int64_t Q, int64_t ntiles,
                                              int diag_q, Tile&& tile) {
  int64_t i, q0;
  for (int64_t n = 0; tile_at<C>(n, Q, ntiles, diag_q, i, q0); ++n) tile(i, q0);
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

// The checks of the arguments that every entry takes: a run needs Q a
// multiple of 128 128, Q needs a run, the kinds are in range.
inline bool high_kinds_ok(int has_diag, int diag_q, long long Q, int bkind,
                          int fkind) {
  return !(has_diag && Q % (128 * 128) != 0) && !(diag_q && !has_diag) &&
         bkind >= 0 && bkind <= 2 && fkind >= 0 && fkind <= 1;
}

}  // namespace
