// Multi-term applies on the planes, every product on the tensor cores:
// y = sum_t Em_t . X . El_t^T for every 128 x 128 slab (the dual form), and
// y = sum_t (E_t on axis X) (El_t on the lane axis) x on the view (A1, X,
// M, 128) (the high form), both one kernel.
//
// Replaces the TPU kernels dual_multi_apply_planes
// (dqc_tpu/ops/pallas/dual_apply.py:165, body _kernel_multi at :116,
// pallas_call at :213) and high_multi_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:273, body _kernel_multi at :231): the
// whole operator-Schmidt decomposition of a dense gate across the lane
// group (qubits 0..6, El_t on the last axis) and the sublane group (qubits
// 7..13, Em_t on the middle axis) or a high group or a span of high bits
// (E_t, X x X on axis X; ops/planes.apply_cross_span: X = 8 for the CNOT
// ring's closing gate), T terms (a run-time count: 16 for a traced k >= 4
// gate), in one pass over the planes, in place; and their density-seed
// modes (conj / acc / alias=False): y = [acc +] conj(sum_t ...) with x read
// only, the seed of a density across the lane group and another group (T
// = 4 terms of its 4 x 4 operator). x is stored as f32, bf16 or f16 and y
// as f32, bf16 or f16 (the TPU kernels' f32_of / store_as; common.cuh's
// codec); the products run in 3xTF32 (the "f32" dot mode) or bf16x3.
//
// The two forms are one: a tile of 128 rows x 128 lanes, row r = mm X + x
// (128 / X consecutive m of one i, X rows each) at base + (r mod X) Q +
// (r div X) 128 in the planes, Q = M 128. The dual slab is X = 128, Q =
// 128 (planes (A, 128, 128) as the view (A, 128, 1, 128)), with Em_t as
// E_t; below X = 128 the group product is block-diagonal: 128 / X copies
// of E_t, each on its own X rows.
//
// Bound: operations on the tensor cores. Per amplitude and term 128
// complex multiply-adds for the lane product and X for the group product
// against 16 bytes moved (24 with an accumulator): in 3xTF32 three tf32
// passes per real product at 495 TFLOP/s, in bf16x3 three bf16 passes at
// 989, a pass fewer for the lane product where x's lo parts are zero (bf16
// x in bf16x3; in 3xTF32 El meets 16-bit x in three parts and keeps its
// three passes). At 2^29 f32 amplitudes: 13.33 ms at X = 128, T = 2 and
// 26.66 at T = 4; 7.08 ms at X = 8, T = 2; against 2.56 ms of HBM traffic.
//
// Design: one block of 512 threads (16 warps) per tile, its shared memory
// the tile (128 KB), one 64 KB tile and a two-stage operator ring (32 KB).
// 1. The block reads the whole tile before it writes anything (so y may be
//    x: a block's rows belong to no other block), decoding x into f32 rows
//    s of 128 lanes l, unpadded and XOR-swizzled (adjoint.cuh SwizzledRows),
//    16 bytes a thread a load (each row 512 contiguous bytes of f32).
// 2. The output goes in two blocks of 64 lane columns cb, each summed over
//    the terms in the warps' registers (each warp 32 rows s x 16 lanes l):
//    - the lane product T = El_t[cb rows] X^T (64 x 128: T[l][s] = sum over
//      l' of El_t[l][l'] X[s][l']) into the tile, in two halves of 32 rows
//      (each warp 16 x 16 of a half in registers, beside the output's);
//    - the group product E_t T^T (128 x 64), added into the output's
//      accumulators. It is block-diagonal below X = 128: a 16-row m-tile
//      lies within one X-row group (X >= 16) and runs only that group's X / 8
//      tf32 (X / 16 bf16) k-steps; X = 8 runs as diag(E_t, E_t) on 16-row
//      m-tiles (the pre-split operator's X = 8 layout, csrc/small_x.cuh's),
//      so the group product costs max(X, 16) multiply-adds an amplitude, not
//      128.
//    Every k-step is summed from zero on the tensor cores and added on the
//    CUDA cores (mma.cuh cmma3; the operator is the A fragment, the tile's
//    or T's rows the B fragments, conflict-free in the swizzle).
// 3. After the last term the accumulators go to the tile (128 x 64), and the
//    stores read it in the loads' order: the conjugate, the accumulator
//    planes, y's storage rounding.
// The operators come pre-split in mma fragment order (the wrapper's
// _tc.tc_operator of the stacked El_t and E_t, once per call; El_t in three
// parts where 3xTF32 meets 16-bit x), streamed as one sequence of chunks of
// at most 16 KB (the two m-tiles of a half of El_t's cb rows for four
// k-steps, two in three parts; E_t's k-steps, as many as 16 KB holds, sized
// to X), the next chunk in flight while the warps multiply the current
// one, across the products' boundaries. One thread issues each chunk as
// bulk copies (the Tensor Memory Accelerator) that complete the stage's
// mbarrier; issued by every thread as 16-byte cp.async copies, the chunks'
// address arithmetic and copies sat on every warp's path between two
// products and cost more than a stage of depth would have saved. T stays
// f32 in shared memory between the products, as the TPU kernels keep it in
// VMEM. Kinds, modes, conj and acc are run-time arguments; the kernel is
// templated on the split (MODE, El_t's parts P) and on the group product's
// width XG = max(X, 16) only.

#include "adjoint.cuh"

namespace {

using dqc::CFrag;
using dqc::kBf16x3;
using dqc::kStoreF32;
using dqc::kTf32x3;

constexpr int N = dqc::kGroup;
constexpr int kMaThreads = 512;
constexpr int kStageWords = 4096;  // 16 KB: one chunk of the operator stream
constexpr int kSlabFloats = N * N;
constexpr int kTileFloats = 64 * N;
constexpr int kMaSmemBytes =
    (2 * kSlabFloats + 2 * kTileFloats + 2 * kStageWords) * (int)sizeof(float) +
    2 * (int)sizeof(uint64_t);
static_assert(kMaSmemBytes <= 232448, "shared memory of one block");

using SlabRows = dqc::SwizzledRows<N>;   // the slab X[s][l]; the tile T[l][s]
using OutRows = dqc::SwizzledRows<64>;   // the tile as the output block y[s][l]

struct MaArgs {
  const char* x[2];          // x re, im
  char* y[2];                // y re, im (x in place; the accumulator)
  const uint32_t* op_l;      // El_t pre-split, (T, k-steps, 8, P, 32, 4)
  const uint32_t* op_m;      // E_t pre-split, (T, k-steps, XG / 16, 4, 32, 4)
  int T, xkind, ykind, conj, has_acc;
  int lx;                    // log2 X: tile row r is x = r mod X of m = r div X
  int64_t Q;                 // M 128: the planes' stride between x and x + 1
  int64_t tpi;               // tiles an i: M / (128 / X)
};

// Where tile row r starts in the planes, from the tile's base.
__device__ __forceinline__ int64_t row_off(const MaArgs& a, int r) {
  return (int64_t)(r & ((1 << a.lx) - 1)) * a.Q + (int64_t)(r >> a.lx) * N;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The ring's two stages, each with an mbarrier that its bulk copies
// complete (one arrival: the issuing thread's, with the chunk's bytes).
struct MaRing {
  uint32_t* stage;   // 2 x kStageWords
  uint64_t* full;    // 2 mbarriers
};

// The operator stream of a tile, for MODE, El_t's parts P and the group
// product's width XG: per output column block cb and term t, the lane
// product's NL chunks (for each half of cb's 64 rows of El_t, KPL k-steps
// of its two m-tiles a chunk), then the group product's NM (KPM k-steps of
// E_t's MT m-tiles each, at most 16 KB).
template <int MODE, int P, int XG>
struct MaStream {
  static constexpr int KS = MODE == kTf32x3 ? 8 : 16;     // k of one mma
  static constexpr int NKS = N / KS;                       // k-steps a product
  static constexpr int kFragWords = 32 * 4;                // a part of a fragment
  static constexpr int kLaneStepWords = 2 * P * kFragWords;  // a half's k-step
  static constexpr int KPL = kStageWords / kLaneStepWords;   // its k-steps a chunk
  static constexpr int NLH = NKS / KPL;                    // chunks a half
  static constexpr int NL = 2 * NLH;
  static constexpr int MT = XG / 16;                       // E_t's m-tiles
  static constexpr int NKG = XG / KS;                      // its k-steps
  static constexpr int kGroupStepWords = MT * 4 * kFragWords;
  static constexpr int KPM = NKG < kStageWords / kGroupStepWords
                                 ? NKG : kStageWords / kGroupStepWords;
  static constexpr int NM = NKG / KPM;
  static constexpr int kGroupChunkWords = KPM * kGroupStepWords;
  static constexpr int PER = NL + NM;                      // chunks a term
  static_assert(NKS % KPL == 0 && NKG % KPM == 0 && XG % 16 == 0 && XG <= N,
                "whole chunks; 16-row m-tiles within a group");
};

// Thread 0: chunk g of the slab's operator stream (if the stream has one)
// into stage g % 2 by bulk copies, which complete that stage's mbarrier.
template <int MODE, int P, int XG>
__device__ __forceinline__ void ma_issue(const MaRing& r, const MaArgs& a, int g) {
  using S = MaStream<MODE, P, XG>;
  if (g >= 2 * a.T * S::PER) return;
  uint32_t* stage = r.stage + (g & 1) * kStageWords;
  uint64_t* bar = r.full + (g & 1);
  const int ct = g / S::PER, c = g % S::PER;
  const int cb = ct / a.T, t = ct % a.T;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)),
                  "r"((uint32_t)(c < S::NL ? S::KPL * S::kLaneStepWords
                                           : S::kGroupChunkWords) * 4u)
               : "memory");
  if (c < S::NL) {  // KPL k-steps of El_t's m-tiles 4 cb + 2 h, + 1
    const int h = c / S::NLH, k0 = (c % S::NLH) * S::KPL;
    for (int j = 0; j < S::KPL; ++j) {
      const uint32_t* src =
          a.op_l + ((int64_t)(t * S::NKS + k0 + j) * 8 + 4 * cb + 2 * h) * P * S::kFragWords;
      dqc::bulk_g2s(stage + j * S::kLaneStepWords, src, S::kLaneStepWords * 4u, bar);
    }
  } else {  // KPM k-steps of E_t, every m-tile
    dqc::bulk_g2s(stage,
                  a.op_m + ((int64_t)t * S::NKG + (c - S::NL) * S::KPM) * S::kGroupStepWords,
                  S::kGroupChunkWords * 4u, bar);
  }
}

// The next chunk of the stream: waits for chunk g, then, once every warp is
// done with chunk g - 1, has thread 0 issue chunk g + 1 into its stage.
// Returns chunk g's stage; g moves on.
template <int MODE, int P, int XG>
__device__ __forceinline__ const uint4* ma_next(const MaRing& r, const MaArgs& a, int& g) {
  dqc::mbar_wait(r.full + (g & 1), (g >> 1) & 1);
  __syncthreads();
  if (threadIdx.x == 0) ma_issue<MODE, P, XG>(r, a, g + 1);
  const uint4* stage = reinterpret_cast<const uint4*>(r.stage + (g & 1) * kStageWords);
  ++g;
  return stage;
}

// acc[n][m] += A_m B_n for this warp's M m-tiles (their fragments at fm,
// P * 32 uint4 apart in the stage) and two B fragments: one A fragment in
// registers at a time. b_exact: B's lo parts are zero (P = 6 needs it).
template <int MODE, int P, int M>
__device__ __forceinline__ void ma_kstep(const uint4* fm, const CFrag<2> (&b)[2],
                                         bool b_exact, float (&accr)[2][M][1][4],
                                         float (&acci)[2][M][1][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    CFrag<4> a[1], a2[1];
    dqc::load_op_frag(fm + m * P * 32, P == 6, a[0], a2[0]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if constexpr (P == 6)
        dqc::cmma3x<MODE, 1>(accr[n][m], acci[n][m], a, a2, b[n]);
      else
        dqc::cmma3<MODE, 1>(accr[n][m], acci[n][m], a, b[n], false, b_exact);
    }
  }
}

template <int M>
__device__ __forceinline__ void ma_zero(float (&accr)[2][M][1][4], float (&acci)[2][M][1][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[n][m][0][e] = acci[n][m][0][e] = 0.f;
}

// The lane product of column block cb and the current term into the tile:
// T[l][s] = sum over l' of El_t[64 cb + l][l'] X[s][l'], in two halves of
// 32 rows l (so that its accumulators stay beside the output's in
// registers), warp (wr, wc) = (warp / 8, warp % 8) rows 32 h + 16 wr ..,
// columns s 16 wc ... The tile's old readers (the last sublane product) are
// past this product's first barrier.
template <int MODE, int P, int XG>
__device__ __forceinline__ void ma_lane(const MaRing& r, const MaArgs& a, int& g,
                                        const float* sXr, const float* sXi, float* sTr,
                                        float* sTi, bool x_exact) {
  using S = MaStream<MODE, P, XG>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 3, wc = warp & 7, gq = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float accr[2][1][1][4], acci[2][1][1][4];
    ma_zero(accr, acci);
#pragma unroll 1
    for (int ci = 0; ci < S::NLH; ++ci) {
      const uint4* stage = ma_next<MODE, P, XG>(r, a, g);
#pragma unroll
      for (int j = 0; j < S::KPL; ++j) {
        CFrag<2> b[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          dqc::load_b_rows<MODE, SlabRows>(sXr, sXi, 16 * wc + 8 * n,
                                           (ci * S::KPL + j) * S::KS, b[n]);
        ma_kstep<MODE, P, 1>(stage + (2 * j + wr) * P * 32 + lane, b, x_exact, accr, acci);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = SlabRows::at(32 * h + 16 * wr + gq + 8 * hh, 16 * wc + 8 * n + 2 * tq);
        *reinterpret_cast<float2*>(sTr + o) =
            make_float2(accr[n][0][0][2 * hh], accr[n][0][0][2 * hh + 1]);
        *reinterpret_cast<float2*>(sTi + o) =
            make_float2(acci[n][0][0][2 * hh], acci[n][0][0][2 * hh + 1]);
      }
  }
}

// The group product of the current term added into the warp's output
// accumulators: y[s][l] += sum over s' of E_t[s][s'] T[l][s'] within s's
// X-row group (at X = 128 every row s'), warp (wr, wc) = (warp / 4, warp %
// 4) rows s 32 wr .. (m-tiles 2 wr, 2 wr + 1), columns l 16 wc ... At XG >=
// 32 both m-tiles lie in one group and share its B fragments; at XG = 16
// each m-tile is a group of its own (diag(E_t, E_t) at X = 8), one A
// fragment against the two m-tiles' B fragments.
template <int MODE, int P, int XG>
__device__ __forceinline__ void ma_group(const MaRing& r, const MaArgs& a, int& g,
                                         const float* sTr, const float* sTi,
                                         float (&yr)[2][2][1][4], float (&yi)[2][2][1][4]) {
  using S = MaStream<MODE, P, XG>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll 1
  for (int ci = 0; ci < S::NM; ++ci) {
    const uint4* stage = ma_next<MODE, P, XG>(r, a, g);
#pragma unroll
    for (int j = 0; j < S::KPM; ++j) {
      const int ks = (ci * S::KPM + j) * S::KS;  // within the group
      if constexpr (XG >= 32) {
        const int g0 = (32 * wr / XG) * XG, mg = (2 * wr) % S::MT;
        CFrag<2> b[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          dqc::load_b_rows<MODE, SlabRows>(sTr, sTi, 16 * wc + 8 * n, g0 + ks, b[n]);
        ma_kstep<MODE, 4, 2>(stage + (j * S::MT + mg) * 4 * 32 + lane, b, false, yr, yi);
      } else {
        CFrag<4> af[1], a2[1];
        dqc::load_op_frag(stage + j * 4 * 32 + lane, false, af[0], a2[0]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          CFrag<2> b[2];
#pragma unroll
          for (int n = 0; n < 2; ++n)
            dqc::load_b_rows<MODE, SlabRows>(sTr, sTi, 16 * wc + 8 * n,
                                             16 * (2 * wr + m) + ks, b[n]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            dqc::cmma3<MODE, 1>(yr[n][m], yi[n][m], af, b[n], false, false);
        }
      }
    }
  }
}

// x's tile (its first row at base) -> the shared rows, decoded (every load
// of half the tile in flight before its shared-memory stores).
__device__ __forceinline__ void ma_load(const MaArgs& a, int64_t base, float* sXr, float* sXi) {
  const int es = a.xkind == kStoreF32 ? 4 : 2;
  const char* gr = a.x[0] + base * es;
  const char* gi = a.x[1] + base * es;
  constexpr int J = kSlabFloats / 4 / kMaThreads / 2;  // groups of four a thread a half
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float vr[J][4], vi[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + kMaThreads * (J * h + j);
      const int64_t e4 = (row_off(a, e >> 5) >> 2) + (e & 31);
      dqc::load4(gr, e4, a.xkind, vr[j]);
      dqc::load4(gi, e4, a.xkind, vi[j]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + kMaThreads * (J * h + j);
      const int o = SlabRows::at(e >> 5, 4 * (e & 31));
      *reinterpret_cast<float4*>(sXr + o) = make_float4(vr[j][0], vr[j][1], vr[j][2], vr[j][3]);
      *reinterpret_cast<float4*>(sXi + o) = make_float4(vi[j][0], vi[j][1], vi[j][2], vi[j][3]);
    }
  }
}

// The output block cb (128 rows s x 64 lanes, in the tile as OutRows) -> y
// (the tile's first row at base): the conjugate, the accumulator planes
// (their loads in flight first), y's storage rounding.
__device__ __forceinline__ void ma_store(const MaArgs& a, int64_t base, int cb,
                                         const float* sYr, const float* sYi) {
  const int es = a.ykind == kStoreF32 ? 4 : 2;
  char* gr = a.y[0] + base * es;
  char* gi = a.y[1] + base * es;
  constexpr int J = kTileFloats / 4 / kMaThreads;  // 4 groups a thread
  float pr[J][4], pi[J][4];
  if (a.has_acc) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + kMaThreads * j, s = e >> 4, l = 4 * (e & 15);
      const int64_t e4 = (row_off(a, s) + 64 * cb + l) >> 2;
      dqc::load4(gr, e4, a.ykind, pr[j]);
      dqc::load4(gi, e4, a.ykind, pi[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = threadIdx.x + kMaThreads * j, s = e >> 4, l = 4 * (e & 15);
    const int o = OutRows::at(s, l);
    const float4 r4 = *reinterpret_cast<const float4*>(sYr + o);
    const float4 i4 = *reinterpret_cast<const float4*>(sYi + o);
    float vr[4] = {r4.x, r4.y, r4.z, r4.w}, vi[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (a.conj) vi[q] = -vi[q];
      if (a.has_acc) {
        vr[q] += pr[j][q];
        vi[q] += pi[j][q];
      }
    }
    const int64_t e4 = (row_off(a, s) + 64 * cb + l) >> 2;
    dqc::store4(gr, e4, a.ykind, vr);
    dqc::store4(gi, e4, a.ykind, vi);
  }
}

// One tile a block: MODE the products' split, P El_t's parts, XG the
// group product's width.
template <int MODE, int P, int XG>
__global__ void __launch_bounds__(kMaThreads, 1)
dual_multi_apply_tc_kernel(const MaArgs a) {
  extern __shared__ float4 ma_smem4[];
  float* sXr = reinterpret_cast<float*>(ma_smem4);
  float* sXi = sXr + kSlabFloats;
  float* sTr = sXi + kSlabFloats;
  float* sTi = sTr + kTileFloats;
  uint32_t* ring_words = reinterpret_cast<uint32_t*>(sTi + kTileFloats);
  const MaRing ring{ring_words, reinterpret_cast<uint64_t*>(ring_words + 2 * kStageWords)};
  const int64_t i = blockIdx.x / a.tpi;
  const int64_t base = (i << a.lx) * a.Q + (blockIdx.x - i * a.tpi) * (N >> a.lx) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // x's lo parts are zero: bf16 x in bf16x3 (16-bit x in 3xTF32: P = 6)
  const bool x_exact = MODE == kBf16x3 && a.xkind == dqc::kStoreBF16;

  if (threadIdx.x == 0) {
    dqc::mbar_init(ring.full, 1);
    dqc::mbar_init(ring.full + 1, 1);
    dqc::mbar_fence_init();
    ma_issue<MODE, P, XG>(ring, a, 0);  // the first chunk flies during the load
  }
  int g = 0;
  ma_load(a, base, sXr, sXi);
#pragma unroll 1
  for (int cb = 0; cb < 2; ++cb) {
    float yr[2][2][1][4], yi[2][2][1][4];
    ma_zero(yr, yi);
#pragma unroll 1
    for (int t = 0; t < a.T; ++t) {
      ma_lane<MODE, P, XG>(ring, a, g, sXr, sXi, sTr, sTi, x_exact);
      ma_group<MODE, P, XG>(ring, a, g, sTr, sTi, yr, yi);
    }
    __syncthreads();  // every warp is done reading the tile
    const int wr = warp >> 2, wc = warp & 3, gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = OutRows::at(32 * wr + 16 * m + gq + 8 * h, 16 * wc + 8 * n + 2 * tq);
          *reinterpret_cast<float2*>(sTr + o) = make_float2(yr[n][m][0][2 * h], yr[n][m][0][2 * h + 1]);
          *reinterpret_cast<float2*>(sTi + o) = make_float2(yi[n][m][0][2 * h], yi[n][m][0][2 * h + 1]);
        }
    __syncthreads();  // the output block is complete
    ma_store(a, base, cb, sTr, sTi);
  }
}

template <int MODE, int P, int XG>
int launch_ma(const MaArgs& a, long long blocks, cudaStream_t stream) {
  auto kernel = dual_multi_apply_tc_kernel<MODE, P, XG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kMaThreads, kMaSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int XG>
int launch_modes(const MaArgs& a, int x3, long long blocks, cudaStream_t s) {
  if (x3) return launch_ma<kBf16x3, 4, XG>(a, blocks, s);
  return a.xkind != kStoreF32 ? launch_ma<kTf32x3, 6, XG>(a, blocks, s)
                              : launch_ma<kTf32x3, 4, XG>(a, blocks, s);
}

// The two entries' common checks and launch: the view (A1, X, M, 128), X in
// {8, 16, 32, 64, 128}, M a multiple of 128 / X.
int launch_multi(const void* xr, const void* xi, void* yr, void* yi, int xkind,
                 int ykind, int x3, const uint32_t* op_l, const uint32_t* op_g,
                 int three_l, int T, int conj, int has_acc, long long A1, int X,
                 long long M, cudaStream_t stream) {
  const bool three = !x3 && xkind != kStoreF32;
  int lx = 0;
  while (lx < 7 && (1 << lx) < X) ++lx;
  if (A1 <= 0 || M <= 0 || X < 8 || X != (1 << lx) || M % (N / X) != 0 ||
      A1 * (M / (N / X)) > 0x7fffffffLL || T < 1 || xkind < 0 || xkind > 2 ||
      ykind < 0 || ykind > 2 || (xr == yr && xkind != ykind) || (three_l != 0) != three)
    return (int)cudaErrorInvalidValue;
  MaArgs a{};
  a.x[0] = static_cast<const char*>(xr);
  a.x[1] = static_cast<const char*>(xi);
  a.y[0] = static_cast<char*>(yr);
  a.y[1] = static_cast<char*>(yi);
  a.op_l = op_l;
  a.op_m = op_g;
  a.T = T;
  a.xkind = xkind;
  a.ykind = ykind;
  a.conj = conj;
  a.has_acc = has_acc;
  a.lx = lx;
  a.Q = M * N;
  a.tpi = M / (N / X);
  const long long blocks = A1 * a.tpi;
  switch (X) {
    case 8:
    case 16: return launch_modes<16>(a, x3, blocks, stream);
    case 32: return launch_modes<32>(a, x3, blocks, stream);
    case 64: return launch_modes<64>(a, x3, blocks, stream);
    default: return launch_modes<128>(a, x3, blocks, stream);
  }
}

}  // namespace

// On planes (A, 128, 128): y <- [acc +] conj?(sum_t Em_t x El_t^T), t < T
// (T >= 1), with y = x for in place (of one storage) and y the
// accumulator planes with has_acc; x stored as xkind, y as ykind (0 f32, 1
// bf16, 2 f16). x3: the products in bf16x3, else 3xTF32. op_l and op_m are
// the stacked El_t and Em_t pre-split for that mode (ops/kernels/_tc.
// tc_operator, (T, k-steps, 8, parts, 32, 4)), op_l in three parts (three_l)
// exactly where 3xTF32 meets 16-bit x. The planes are 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int dqc_dual_multi_apply(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind, int x3,
                                    const uint32_t* op_l, const uint32_t* op_m,
                                    int three_l, int T, int conj, int has_acc,
                                    long long A, void* stream) {
  return launch_multi(xr, xi, yr, yi, xkind, ykind, x3, op_l, op_m, three_l, T,
                      conj, has_acc, A, N, 1, (cudaStream_t)stream);
}

// On the view (A1, X, M, 128), X in {8, 16, 32, 64, 128} and M a multiple
// of 128 / X: y <- [acc +] conj?(sum_t E_t x El_t^T), t < T (E_t on axis
// X), with dqc_dual_multi_apply's storages, modes and seed forms. op_e is
// the stacked E_t pre-split for the mode (ops/kernels/_tc.tc_operator,
// (T, k-steps, max(X, 16) / 16, 4, 32, 4); X = 8 as diag(E_t, E_t)), op_l
// the stacked El_t as there. Returns cudaGetLastError().
extern "C" int dqc_high_multi_apply(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind, int x3,
                                    const uint32_t* op_l, const uint32_t* op_e,
                                    int three_l, int T, int conj, int has_acc,
                                    long long A1, int X, long long M,
                                    void* stream) {
  return launch_multi(xr, xi, yr, yi, xkind, ykind, x3, op_l, op_e, three_l, T,
                      conj, has_acc, A1, X, M, (cudaStream_t)stream);
}
