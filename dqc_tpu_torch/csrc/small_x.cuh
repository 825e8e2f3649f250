// The pieces the two streamed kernels at X = 8..64 share: the high adjoint's
// one-pass step (block_backward_high_small.cu) and the high apply
// (high_apply_small.cu). Both walk the view (A1, X, Q = M 128) in tiles of
// 2048 amplitudes (X rows at stride Q by C = 2048 / X contiguous columns,
// all of one i) with 256-thread blocks, hold each tile decoded to f32 in a
// swizzled working tile in shared memory, and multiply it by an operator
// pre-split in mma fragment order (ops/kernels/_tc.tc_operator) held in
// shared memory for the whole launch, on mma.sync (mma.cuh's split
// products). X = 8 runs as 16 rows: the tile's two halves of 128 columns
// stacked under diag(E, E) (the wrapper's operator is laid out so).
#pragma once

#include "adjoint.cuh"

namespace {

using dqc::CFrag;
using dqc::kBf16x3;
using dqc::kStoreF32;
using dqc::kTf32x3;

constexpr int kSmThreads = 256;
constexpr int kSmWarps = kSmThreads / 32;
constexpr int kSmTile = 2048;   // amplitudes of a tile
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// A tile as the products see it: XR rows (X, or 16 at X = 8) by CR columns;
// each warp owns one m-tile by 16 columns of a product.
template <int X>
struct SmTile {
  static constexpr int XR = X < 16 ? 16 : X;   // rows as the products see a tile
  static constexpr int C = kSmTile / X;        // columns of the view
  static constexpr int CR = kSmTile / XR;      // columns as the products see them
  static constexpr int MT = XR / 16;           // m-tiles
  static constexpr int CB = CR / 16;           // 16-column blocks of a product
  static_assert(MT * CB == kSmWarps, "one m-tile x 16 columns of each product a warp");
  static_assert(CR >= 32 && C % 4 == 0, "the swizzle and the groups of four");
};

// The working tile, XR rows x CR columns, swizzled (adjoint.cuh).
template <int X>
using SmRows = dqc::SwizzledRows<SmTile<X>::CR>;

// Element (x, c) of the view's tile (X rows x C columns) in the working
// tile: at X = 8 the columns from CR on are rows 8 .. 15.
template <int X>
struct SmView {
  static __device__ __forceinline__ int at(int x, int c) {
    constexpr int CR = SmTile<X>::CR;
    if constexpr (X == 8)
      return SmRows<X>::at(x + 8 * (c / CR), c % CR);
    else
      return SmRows<X>::at(x, c);
  }
};

// One pass of N complex products against one A fragment's parts (ar, ai):
// tr[n] (+)= ar Yr[n] - ai Yi[n], ti[n] (+)= ar Yi[n] + ai Yr[n], Y the hi
// (BLO false) or lo parts of b[n], from zero with ZERO; the two products of
// a chain go 2 N mma.sync apart, so that neighbouring ones do not wait on
// each other.
template <int MODE, int N, bool ZERO, bool BLO>
__device__ __forceinline__ void pass_n(float (&tr)[N][4], float (&ti)[N][4],
                                       const uint32_t (&ar)[4],
                                       const uint32_t (&ai)[4],
                                       const CFrag<2> (&b)[N]) {
  constexpr uint32_t neg = dqc::kNegMask<MODE>;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t yr0 = BLO ? b[n].rl[0] : b[n].rh[0], yr1 = BLO ? b[n].rl[1] : b[n].rh[1];
    const uint32_t yi0 = BLO ? b[n].il[0] : b[n].ih[0], yi1 = BLO ? b[n].il[1] : b[n].ih[1];
    if constexpr (ZERO) {
      dqc::mma_op0<MODE>(tr[n], ar, yr0, yr1);
      dqc::mma_op0<MODE>(ti[n], ar, yi0, yi1);
    } else {
      dqc::mma_op<MODE>(tr[n], ar, yr0, yr1);
      dqc::mma_op<MODE>(ti[n], ar, yi0, yi1);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t yr0 = BLO ? b[n].rl[0] : b[n].rh[0], yr1 = BLO ? b[n].rl[1] : b[n].rh[1];
    const uint32_t yi0 = BLO ? b[n].il[0] : b[n].ih[0], yi1 = BLO ? b[n].il[1] : b[n].ih[1];
    dqc::mma_op<MODE>(tr[n], ai, yi0 ^ neg, yi1 ^ neg);
    dqc::mma_op<MODE>(ti[n], ai, yr0, yr1);
  }
}

// dr[n] += A B[n] for n < N: mma.cuh's cmma3 (three passes per real
// product, a_exact / b_exact skip the passes that read zero lo parts; each
// k-step's passes summed from zero in the tensor cores, the small ones
// first, and added on the CUDA cores) for one A fragment against N B
// fragments, issued pass by pass across the N products: 2 N chains of
// mma.sync, neighbouring ones independent.
template <int MODE, int N>
__device__ __forceinline__ void cmma3n(float (&dr)[N][4], float (&di)[N][4],
                                       const CFrag<4>& a, const CFrag<2> (&b)[N],
                                       bool a_exact, bool b_exact) {
  float tr[N][4], ti[N][4];
  if (!a_exact) {
    pass_n<MODE, N, true, false>(tr, ti, a.rl, a.il, b);
    if (!b_exact) pass_n<MODE, N, false, true>(tr, ti, a.rh, a.ih, b);
  } else if (!b_exact) {
    pass_n<MODE, N, true, true>(tr, ti, a.rh, a.ih, b);
  }
  if (a_exact && b_exact)
    pass_n<MODE, N, true, false>(tr, ti, a.rh, a.ih, b);
  else
    pass_n<MODE, N, false, false>(tr, ti, a.rh, a.ih, b);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dr[n][e] += tr[n][e];
      di[n][e] += ti[n][e];
    }
}

// cmma3n for an operator in three parts (a: hi and lo, a2's hi slots: the
// second lo) against exact B fragments (mma.cuh cmma3x), the smallest pass
// first.
template <int MODE, int N>
__device__ __forceinline__ void cmma3xn(float (&dr)[N][4], float (&di)[N][4],
                                        const CFrag<4>& a, const CFrag<4>& a2,
                                        const CFrag<2> (&b)[N]) {
  float tr[N][4], ti[N][4];
  pass_n<MODE, N, true, false>(tr, ti, a2.rh, a2.ih, b);
  pass_n<MODE, N, false, false>(tr, ti, a.rl, a.il, b);
  pass_n<MODE, N, false, false>(tr, ti, a.rh, a.ih, b);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dr[n][e] += tr[n][e];
      di[n][e] += ti[n][e];
    }
}

// acc = Op T for this warp's m-tile mt and columns n0 .. n0 + 15 of the
// working tile T (tr, ti): Op pre-split in shared memory at op (fragment
// order: k-step, m-tile, part, lane, register; three: six parts, 3xTF32
// only); t_exact: T's lo parts are zero.
template <int X, int MODE>
__device__ __forceinline__ void sm_product(const uint32_t* op, bool three,
                                           const float* tr, const float* ti,
                                           bool t_exact, int mt, int n0,
                                           float (&accr)[2][4],
                                           float (&acci)[2][4]) {
  using Cfg = SmTile<X>;
  constexpr int KS = MODE == kTf32x3 ? 8 : 16;
  const int lane = threadIdx.x & 31;
  if constexpr (MODE != kTf32x3) three = false;
  const int P = three ? 6 : 4;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accr[n][e] = acci[n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < Cfg::XR / KS; ++s) {
    CFrag<4> a, a2;  // the operator's parts (three: lo2 in a2's hi slots)
    dqc::load_op_frag(reinterpret_cast<const uint4*>(op) + (s * Cfg::MT + mt) * P * 32 + lane,
                      three, a, a2);
    CFrag<2> b[2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
      dqc::load_b_cols<MODE, SmRows<X>>(tr, ti, s * KS, n0 + 8 * n, b[n]);
    if (three)
      cmma3xn<MODE, 2>(accr, acci, a, a2, b);
    else
      cmma3n<MODE, 2>(accr, acci, a, b, false, t_exact);
  }
}

// sm_product's results over the working tile (rows 16 mt .., columns n0 ..).
template <int X>
__device__ __forceinline__ void sm_put(float* tr, float* ti, int mt, int n0,
                                       const float (&accr)[2][4],
                                       const float (&acci)[2][4]) {
  using L = SmRows<X>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = L::at(16 * mt + g + 8 * h, n0 + 8 * n + 2 * t);
      *reinterpret_cast<float2*>(tr + o) = make_float2(accr[n][2 * h], accr[n][2 * h + 1]);
      *reinterpret_cast<float2*>(ti + o) = make_float2(acci[n][2 * h], acci[n][2 * h + 1]);
    }
}

// The bytes of an element of planes stored as kind.
__host__ __device__ __forceinline__ int elem_bytes(int kind) {
  return kind == kStoreF32 ? 4 : 2;
}

// Group j of four neighbouring elements (x, c .. c + 3) of the view's tile
// that this thread loads, converts and stores (x fastest across threads
// along c: a warp's groups are contiguous in the planes).
template <int X>
__device__ __forceinline__ void sm_group(int j, int& x, int& c) {
  constexpr int G4 = SmTile<X>::C / 4;
  const int e = threadIdx.x + kSmThreads * j;
  x = e / G4;
  c = 4 * (e % G4);
}

// 32-bit words of an operator pre-split for a product of XR rows in mode x3
// (bf16x3) or 3xTF32 (three: in three parts).
inline int op_words(int XR, int x3, bool three) {
  return x3 ? XR * XR * 2 : XR * XR * (three ? 6 : 4);
}

}  // namespace
