// The one-pass adjoint step of a 128 x 64 tile on the tensor cores:
// adjoint.cuh's step with every product on mma.sync. The dual, lane and
// sublane adjoints (block_backward_dual.cu, which builds all three) run it on
// slab tiles, the high adjoint at X = 128 (block_backward_high.cu) on tiles
// of its view, the merged-top adjoint (block_backward_merged_fact.cu) on
// tiles of Xt slices of its merged view, with two passes of its own. The
// forward applies run its tile product alone (tc_op_tile): the dual apply
// (dual_apply.cu) on a whole slab held in the F and B tiles' places, the
// merged-top apply (merged_fact_apply.cu) on tiles of Xt slices.
//
// For a tile of the forward planes F and the cotangent planes B (128 rows x
// along the contracted axis, 64 columns c; element (x, c) at base[x rs +
// c cs] in the planes) and the group operator E, one step computes
//
//   fin  = Einv F              (uncompute, in the dot mode)
//   T0  += B fin^T             (the holomorphic pair gram, in the gram mode)
//   bout = E^T B               (the transport, in the bwd mode)
//
// and writes fin over F and bout over B, with a diagonal run rolled back on
// load or on store and the run's Q reductions where it is met, as
// adjoint.cuh's adjoint_tile does; with ``stage`` (the dual adjoint) F and B
// are rounded to their storage where its TPU kernel stores and reloads them.
//
// Bound: operations on the tensor cores. Per amplitude and step 128 complex
// multiply-adds each for the uncompute, the transport and the pair gram: as
// 3xTF32 ("f32": three tf32 passes per real product at 495 TFLOP/s) or
// bf16x3 (three bf16 passes at 989), a pass fewer where a planes operand's lo
// parts are zero (16-bit planes in 3xTF32, bf16 planes in bf16x3), against
// 32 bytes read and written (24 / 16 with 16-bit planes).
//
// Design: 512 threads (16 warps), one block per SM.
// 1. The block reads the tile of F and of B into shared memory before it
//    writes anything (in place), 16 bytes a thread per load (4 values of
//    the storage's kind, decoded), all of a thread's loads in flight at once. The tiles are
//    unpadded (4 x 32 KB) with their columns XOR-swizzled by row (TcRows),
//    so that every mma fragment read below (the products' columns of 8
//    values at 4 rows, the pair grams' rows) meets 32 banks; only bf16x3's
//    two-row product fragments meet two banks twice.
// 2. The uncompute and the transport run as tc_apply.cuh runs its pass, one
//    after the other on all 16 warps: each warp owns 32 rows x 16 columns
//    (2 x 2 m16n8 tiles, re and im accumulators in registers), each k-step
//    splits its fragment of the tile in registers and runs mma.cuh's cmma3
//    (each k-step summed from zero and added on the CUDA cores, rounded to
//    nearest: the tensor cores' sums round toward zero). The operators come
//    pre-split in fragment order (the wrapper's _tc.tc_operator of Einv and
//    of E^T), two k-steps a chunk through a three-stage cp.async ring (96
//    KB beside the tiles), the first two chunks of each product issued
//    while the block still loads the tiles or forms the pair gram.
// 3. fin replaces F in shared memory; the pair gram (each warp a 32 x 32
//    block of T0, 3xTF32 through cmma3 or bf16x3 through adjoint.cuh's
//    pair_gram_x3_mma128) then reads B and fin, before the transport's
//    result replaces B. Each T0 entry has one writer thread in the block,
//    added to the block's slot (launch_reduce sums the slots in a fixed
//    order). The Q reductions of a run met on store read fin and bout; the
//    stores write both back in the loads' order.
// The operators are read from L2 once per tile and product: 256 KB (two
// tf32 parts; 384 KB in three, where 3xTF32 meets 16-bit planes) or 128 KB
// (bf16) against the tile's 128 KB of planes.
#pragma once

#include <type_traits>

#include "adjoint.cuh"
#include "tc_apply.cuh"

namespace dqc {

// The 128 x 64 tile: 64 columns a row, swizzled (adjoint.cuh SwizzledRows).
struct TcRows : SwizzledRows<64> {
  static constexpr int C = 64;
};

constexpr int kTcTileFloats = kGroup * TcRows::C;
constexpr int kTcRingWords = TcCfg<kGroup, kTf32x3>::kStages *
                             TcCfg<kGroup, kTf32x3>::kChunkWords;
static_assert(TcCfg<kGroup, kBf16x3>::kChunkWords ==
                  TcCfg<kGroup, kTf32x3>::kChunkWords,
              "one ring for both modes");
// F and B (re, im) and the operator ring
constexpr int kTcAdjSmemBytes =
    (4 * kTcTileFloats + kTcRingWords) * (int)sizeof(float);
static_assert(kTcAdjSmemBytes <= 232448, "shared memory of one block");
static_assert(2 * 16 * TcRows::C <= kTcRingWords &&
                  QHighCfg<kGroup>::kScratchFloats <= kTcRingWords,
              "the ring holds Q's scratch");
static_assert(AdjCfg<kGroup>::C == TcRows::C, "the high view's tiles at X = 128");

// The step's dynamic shared memory: the tiles of F (re, im), then of B,
// then the operator ring. The functions below address it through this
// symbol, so that even those not inlined read it as shared memory.
extern __shared__ float4 tc_adj_smem[];
enum : int { kTileF = 0, kTileB = 1 };
__device__ __forceinline__ float* tc_tile(int which) {
  return reinterpret_cast<float*>(tc_adj_smem) + 2 * which * kTcTileFloats;
}
__device__ __forceinline__ uint32_t* tc_ring() {
  return reinterpret_cast<uint32_t*>(tc_adj_smem) + 4 * kTcTileFloats;
}

// The pre-split operators of one step (_tc.tc_operator): Einv for the
// uncompute, E^T for the transport.
struct TcOps {
  const uint32_t* inv;
  const uint32_t* et;
};

// A pre-split operator as the step streams it: P parts to an A fragment
// (4: re and im, hi and lo; 6 in tf32 for a planes operand whose lo parts
// are zero: a second lo part of re and im after them, _tc.tc_operator's
// ``parts=6``), the k-steps of MODE, KPC of them a chunk of the ring (one
// with six parts, so that three chunks still fit the ring).
template <int MODE, int P>
struct TcOp {
  using Cfg = TcCfg<kGroup, MODE>;
  static constexpr int KPC = P == 6 ? 1 : Cfg::KPC;
  static constexpr int kStepWords = kGroup / 16 * P * 32 * 4;
  static constexpr int kChunkWords = KPC * kStepWords;
  static constexpr int nchunks = Cfg::NKS / KPC;
  static_assert(P == 4 || (P == 6 && MODE == kTf32x3), "parts");
  static_assert(Cfg::kStages * kChunkWords <= kTcRingWords, "the ring holds three chunks");
  static_assert(nchunks >= 2, "two chunks in flight");
};

// Chunk ci of the operator into a stage of the ring: one cp.async group.
template <int MODE, int P>
__device__ __forceinline__ void tc_issue(uint32_t* stage, const uint32_t* op,
                                         int ci) {
  using O = TcOp<MODE, P>;
  const uint32_t* src = op + (int64_t)ci * O::kChunkWords;
  for (int e = threadIdx.x; e < O::kChunkWords / 4; e += kAdjThreads)
    cp_async16(stage + 4 * e, src + 4 * e);
  cp_async_commit();
}

// The first two chunks of a product's operator into the ring's stages 0
// and 1 (two cp.async groups).
template <int MODE, int P = 4>
__device__ __forceinline__ void tc_prefetch(uint32_t* ring, const uint32_t* op) {
  tc_issue<MODE, P>(ring, op, 0);
  tc_issue<MODE, P>(ring + TcOp<MODE, P>::kChunkWords, op, 1);
}

// Group e (of 2048) of four neighbouring elements of the tile: along x when
// the rows are adjacent in the planes (rs == 1: a warp reads four 128-byte
// runs of 32 x, at four columns), else along c (two rows of 64 c).
__device__ __forceinline__ void tc_group(int e, bool xfast, int& x, int& c) {
  if (xfast) {
    x = 4 * ((e & 7) | (((e >> 5) & 3) << 3));
    c = ((e >> 3) & 3) | ((e >> 7) << 2);
  } else {
    x = e >> 4;
    c = 4 * (e & 15);
  }
}

// A group of four loaded values into a tile (shared memory at tr, ti),
// optionally times the run's entries and then rounded to qkind (kStoreF32:
// not at all).
template <bool HIGH>
__device__ __forceinline__ void tc_put_group(float* tr, float* ti,
                                             float (&vr)[4], float (&vi)[4],
                                             int x, int c, bool xfast,
                                             int use_diag, const DiagView& dv,
                                             int qkind) {
  if (use_diag) {
    float dr[4], di[4];
    diag_group<HIGH>(dv, x, c, dr, di);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cmul(vr[q], vi[q], dr[q], di[q], vr[q], vi[q]);
      vr[q] = quantize(vr[q], qkind);
      vi[q] = quantize(vi[q], qkind);
    }
  }
  if (xfast) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tr[TcRows::at(x + q, c)] = vr[q];
      ti[TcRows::at(x + q, c)] = vi[q];
    }
  } else {
    const int o = TcRows::at(x, c);
    *reinterpret_cast<float4*>(tr + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(ti + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

// Where element (x, c) of a tile sits in the planes, from the tile's base:
// x rs + c cs, the columns in slices of 2^cshift, each slice a further ss
// on (the merged top's slices, block_backward_merged_fact.cu; elsewhere one
// slice: cshift 6, ss 0). A group of four columns stays in one slice.
__device__ __forceinline__ int64_t tc_at(int x, int c, int64_t rs, int64_t cs,
                                         int64_t ss, int cshift) {
  return x * rs + c * cs + (int64_t)(c >> cshift) * ss;
}

// Planes -> the tiles of F (stored as fkind; FK >= 0 fixes it at compile
// time) and of B (bkind), every load of both in flight before the first
// shared-memory store; with use_diag times the run's entries (Dinv for F,
// D for B) and then rounded to fqkind / bqkind, as adjoint.cuh's load_tile;
// HIGH: the views are the high view's (diag_group); element (x, c) at
// tc_at.
// (Issuing the next tile's loads during this tile's stores, their values
// held in registers, spilled and was slower on the H100.)
template <int FK, bool HIGH>
__device__ __noinline__ void tc_load_tiles(const void* fr, const void* fi,
                                           int fkind, const void* br,
                                           const void* bi, int bkind,
                                           int64_t rs, int64_t cs, int64_t ss,
                                           int cshift, int use_diag,
                                           const DiagView& dv_inv,
                                           const DiagView& dv_fwd, int fqkind,
                                           int bqkind) {
  if constexpr (FK >= 0) fkind = FK;
  if constexpr (FK == kStoreF32) fqkind = kStoreF32;
  const bool xfast = rs == 1;
  constexpr int kPer = kTcTileFloats / 4 / kAdjThreads;  // 4 groups a thread
  float fr4[kPer][4], fi4[kPer][4], br4[kPer][4], bi4[kPer][4];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x, c;
    tc_group(threadIdx.x + j * kAdjThreads, xfast, x, c);
    const int64_t e4 = tc_at(x, c, rs, cs, ss, cshift) >> 2;
    load4(fr, e4, fkind, fr4[j]);
    load4(fi, e4, fkind, fi4[j]);
    load4(br, e4, bkind, br4[j]);
    load4(bi, e4, bkind, bi4[j]);
  }
  float* sF = tc_tile(kTileF);
  float* sB = tc_tile(kTileB);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x, c;
    tc_group(threadIdx.x + j * kAdjThreads, xfast, x, c);
    tc_put_group<HIGH>(sF, sF + kTcTileFloats, fr4[j], fi4[j], x, c, xfast,
                       use_diag, dv_inv, fqkind);
    tc_put_group<HIGH>(sB, sB + kTcTileFloats, br4[j], bi4[j], x, c, xfast,
                       use_diag, dv_fwd, bqkind);
  }
}

// Tile -> planes; with use_diag the values are rounded to qkind, then
// times the run's entries (adjoint.cuh's store_tile); HIGH as
// tc_load_tiles'.
template <int K, bool HIGH>
__device__ __noinline__ void tc_store_tile(void* gr_, void* gi_, int kind,
                                           int64_t rs, int64_t cs, int64_t ss,
                                           int cshift, int which,
                                           int use_diag, const DiagView& dv,
                                           int qkind = kStoreF32) {
  const float* tr_ = tc_tile(which);
  const float* ti_ = tr_ + kTcTileFloats;
  if constexpr (K >= 0) kind = K;
  if constexpr (K == kStoreF32) qkind = kStoreF32;
  const bool xfast = rs == 1;
  constexpr int kPer = kTcTileFloats / 4 / kAdjThreads;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x, c;
    tc_group(threadIdx.x + j * kAdjThreads, xfast, x, c);
    float vr[4], vi[4];
    if (xfast) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = tr_[TcRows::at(x + q, c)];
        vi[q] = ti_[TcRows::at(x + q, c)];
      }
    } else {
      const int o = TcRows::at(x, c);
      const float4 r4 = *reinterpret_cast<const float4*>(tr_ + o);
      const float4 i4 = *reinterpret_cast<const float4*>(ti_ + o);
      vr[0] = r4.x; vr[1] = r4.y; vr[2] = r4.z; vr[3] = r4.w;
      vi[0] = i4.x; vi[1] = i4.y; vi[2] = i4.z; vi[3] = i4.w;
    }
    if (use_diag) {
      float dr[4], di[4];
      diag_group<HIGH>(dv, x, c, dr, di);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = quantize(vr[q], qkind);
        vi[q] = quantize(vi[q], qkind);
        cmul(vr[q], vi[q], dr[q], di[q], vr[q], vi[q]);
      }
    }
    const int64_t e4 = tc_at(x, c, rs, cs, ss, cshift) >> 2;
    store4(gr_, e4, kind, vr);
    store4(gi_, e4, kind, vi);
  }
}

// A whole 128 x 128 slab in the places of the F and B tiles, as the forward
// dual apply (csrc/dual_apply.cu) holds it: the tile at tc_tile(h) holds
// rows s = 64 h .. 64 h + 63 of the slab as [l][s - 64 h] (TcRows: the lane
// step's tile). Element (s, l) of the slab at at(l, s) from tc_tile(0).
struct TcSlabCols {
  static __device__ __forceinline__ int at(int l, int s) {
    return (s >> 6) * 2 * kTcTileFloats + TcRows::at(l, s & 63);
  }
};

// The tile T (kTileF or kTileB) <- Op T, rounded to qkind (kStoreF32: as
// it is): warp (wr, wc) = (warp / 4, warp % 4) keeps rows 32 wr .. + 31,
// columns 16 wc .. + 15 of the product in registers, acc[n][m][fragment
// entry], and writes them over T once every warp is done reading it. Op is
// pre-split for MODE, streamed chunk by chunk through the ring; the caller
// has issued its chunks 0 and 1 (tc_prefetch) into stages 0 and 1, and
// every thread calls. t_exact: T's lo parts are zero; P = 6 (the operator
// in three parts) needs them zero. SLAB: T is column tile ``which`` (l =
// 64 which ..) of a slab held as TcSlabCols holds it, its rows s across
// both tiles: the product's B fragments are that layout's rows (load_b_rows)
// and its results go back to the same places. Not inlined: the
// caller's state stays out of the product's registers. (Storing the
// results to the planes from here instead, in the fragments' order, was
// slower on the H100.)
template <int MODE, int P = 4, bool SLAB = false>
__device__ __noinline__ void tc_op_tile(const uint32_t* op, int which,
                                        bool t_exact, int qkind) {
  using Cfg = TcCfg<kGroup, MODE>;
  using O = TcOp<MODE, P>;
  float* tr = SLAB ? tc_tile(0) + which * 64 * TcRows::C : tc_tile(which);
  float* ti = tr + kTcTileFloats;
  uint32_t* ring = tc_ring();
  constexpr int KPC = O::KPC, nchunks = O::nchunks;
  static_assert(Cfg::WC == 4 && Cfg::RP == kGroup, "one pass of 4 x 4 warps");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / Cfg::WC, wc = warp % Cfg::WC;
  float accr[2][2][4], acci[2][2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[n][m][e] = acci[n][m][e] = 0.f;
#pragma unroll 1
  for (int ci = 0; ci < nchunks; ++ci) {
    cp_async_wait<1>();  // chunk ci landed (ci + 1 may still fly)
    __syncthreads();     // ... for every warp; chunk ci - 1 consumed; the tile ready
    if (ci + 2 < nchunks)
      tc_issue<MODE, P>(ring + ((ci + 2) % Cfg::kStages) * O::kChunkWords, op, ci + 2);
    else
      cp_async_commit();  // an empty group keeps the count
#pragma unroll
    for (int j = 0; j < KPC; ++j) {
      const uint4* stage = reinterpret_cast<const uint4*>(
          ring + (ci % Cfg::kStages) * O::kChunkWords + j * O::kStepWords);
      CFrag<4> a[2], a2[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // the parts of m-tile 2 wr + m, a uint4 each
        const uint4* f = stage + (2 * wr + m) * P * 32 + lane;
        const uint4 rh = f[0], rl = f[32], ih = f[64], il = f[96];
        a[m].rh[0] = rh.x; a[m].rh[1] = rh.y; a[m].rh[2] = rh.z; a[m].rh[3] = rh.w;
        a[m].rl[0] = rl.x; a[m].rl[1] = rl.y; a[m].rl[2] = rl.z; a[m].rl[3] = rl.w;
        a[m].ih[0] = ih.x; a[m].ih[1] = ih.y; a[m].ih[2] = ih.z; a[m].ih[3] = ih.w;
        a[m].il[0] = il.x; a[m].il[1] = il.y; a[m].il[2] = il.z; a[m].il[3] = il.w;
        if constexpr (P == 6) {
          const uint4 r2 = f[128], i2 = f[160];
          a2[m].rh[0] = r2.x; a2[m].rh[1] = r2.y; a2[m].rh[2] = r2.z; a2[m].rh[3] = r2.w;
          a2[m].ih[0] = i2.x; a2[m].ih[1] = i2.y; a2[m].ih[2] = i2.z; a2[m].ih[3] = i2.w;
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        CFrag<2> b;
        if constexpr (SLAB)
          load_b_rows<MODE, TcSlabCols>(tr, ti, wc * 16 + 8 * n, (ci * KPC + j) * Cfg::KS, b);
        else
          load_b_cols<MODE, TcRows>(tr, ti, (ci * KPC + j) * Cfg::KS, wc * 16 + 8 * n, b);
        if constexpr (P == 6)
          cmma3x<MODE, 2>(accr[n], acci[n], a, a2, b);
        else
          cmma3<MODE, 2>(accr[n], acci[n], a, b, false, t_exact);
      }
    }
  }
  __syncthreads();  // every warp is done reading T and the ring
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wr + 16 * m + g + 8 * h, col = 16 * wc + 8 * n + 2 * t;
        if constexpr (SLAB) {  // row s, columns l and l + 1: two rows of a tile
          const int o0 = TcSlabCols::at(col, row), o1 = TcSlabCols::at(col + 1, row);
          tr[o0] = quantize(accr[n][m][2 * h], qkind);
          tr[o1] = quantize(accr[n][m][2 * h + 1], qkind);
          ti[o0] = quantize(acci[n][m][2 * h], qkind);
          ti[o1] = quantize(acci[n][m][2 * h + 1], qkind);
          continue;
        }
        const int o = TcRows::at(row, col);
        *reinterpret_cast<float2*>(tr + o) =
            make_float2(quantize(accr[n][m][2 * h], qkind),
                        quantize(accr[n][m][2 * h + 1], qkind));
        *reinterpret_cast<float2*>(ti + o) =
            make_float2(quantize(acci[n][m][2 * h], qkind),
                        quantize(acci[n][m][2 * h + 1], qkind));
      }
}

// The 3xTF32 pair gram of the tiles: part[x][y] (re), part[X X + x X + y]
// (im) += sum over the tiles' 64 columns of B[x][c] fin[y][c]. Warp w owns
// the 32 x 32 block at rows 32 (w / 4), columns 32 (w % 4), in two halves of
// 16 columns, each as tc_op_tile runs a product: 2 x 2 m16n8 tiles in
// registers, 8 columns a k-step through cmma3 (B's fragments the A operand,
// fin's rows the B operand). b_exact: B's lo parts are zero (16-bit
// storage). Each entry has one writer thread, added to the block's slot
// without waiting for the old value (two neighbouring entries a reduction,
// red2). Not inlined, as tc_op_tile.
__device__ __noinline__ void pair_gram_tf32_mma128(float* part, bool b_exact) {
  constexpr int X = kGroup;
  const float* bR = tc_tile(kTileB);
  const float* bI = bR + kTcTileFloats;
  const float* fR = tc_tile(kTileF);
  const float* fI = fR + kTcTileFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int xb = 32 * (warp >> 2);
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int yb = 32 * (warp & 3) + 16 * half;
    float accr[2][2][4], acci[2][2][4];  // [n][m][fragment entry]
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accr[n][m][e] = acci[n][m][e] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < TcRows::C; kb += 8) {
      // A = B[x][c]: rows xb + 16 m + g (+ 8), columns kb + t (+ 4)
      CFrag<4> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) load_a<kTf32x3, TcRows>(bR, bI, xb + 16 * m, kb, a[m]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // B = fin^T: column y = yb + 8 n + g, rows c = kb + t (+ 4)
        CFrag<2> b;
        load_b_rows<kTf32x3, TcRows>(fR, fI, yb + 8 * n, kb, b);
        cmma3<kTf32x3, 2>(accr[n], acci[n], a, b, b_exact, false);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = xb + 16 * m + g + 8 * h, y = yb + 8 * n + 2 * t;
          red2(part + x * X + y, accr[n][m][2 * h], accr[n][m][2 * h + 1]);
          red2(part + X * X + x * X + y, acci[n][m][2 * h], acci[n][m][2 * h + 1]);
        }
  }
}

// tc_prefetch / tc_op_tile of an operator in three parts (three, 3xTF32
// only) or two.
template <int MODE>
__device__ __forceinline__ void tc_prefetch_op(uint32_t* ring, const uint32_t* op,
                                               bool three) {
  if constexpr (MODE == kTf32x3)
    if (three) return tc_prefetch<MODE, 6>(ring, op);
  tc_prefetch<MODE, 4>(ring, op);
}
template <int MODE>
__device__ __forceinline__ void tc_op_tile_op(const uint32_t* op, int which,
                                              bool t_exact, bool three, int qkind) {
  if constexpr (MODE == kTf32x3)
    if (three) return tc_op_tile<MODE, 6>(op, which, t_exact, qkind);
  tc_op_tile<MODE, 4>(op, which, t_exact, qkind);
}

// adjoint.cuh's bf16x3 pair gram on the swizzled tiles, not inlined.
__device__ __noinline__ void pair_gram_x3_tc(float* part) {
  const float* bR = tc_tile(kTileB);
  const float* fR = tc_tile(kTileF);
  pair_gram_x3_mma128<TcRows>(bR, bR + kTcTileFloats, fR,
                                    fR + kTcTileFloats, part);
}

// A step's own column slices and extra passes: none for the dual, lane,
// sublane and high adjoints. The merged-top adjoint
// (block_backward_merged_fact.cu) hands its own: the slices' stride and
// width (tc_at), a pass after the load (the raw tiles' slice gram) and one
// before the stores (the top factor), both on the tiles in shared memory.
struct TcNoTop {
  static constexpr int64_t ss = 0;
  static constexpr int cshift = 6;
  __device__ __forceinline__ void after_load() const {}
  __device__ __forceinline__ void before_store() const {}
};

// One adjoint step on the tile at (fr, fi, br, bi) with strides (rs, cs),
// as adjoint.cuh's adjoint_tile (diag_mode 0 none, 1 roll the run back on
// load, 2 on store; q null for no Q: a QView on a slab tile, a QHigh on a
// high-view tile; B stored as bkind, F as fkind; stage rounds F and B to
// their storage where the dual adjoint's TPU kernel stores and reloads
// them, and is off for the high adjoint, whose TPU kernel does not stage:
// its Q reads the f32 values), every product on the tensor cores: the
// uncompute in UM, the transport in TM (kTf32x3 or kBf16x3), the pair gram
// bf16x3 with GX3, else 3xTF32; top: the step's slices and extra passes
// (TcNoTop). The block's dynamic shared memory (tc_adj_smem) holds
// kTcAdjSmemBytes.
template <int UM, int TM, bool GX3, class QT, class Top = TcNoTop>
__device__ void tc_adjoint_tile(void* fr, void* fi, void* br, void* bi,
                                int bkind, int fkind, int stage, int64_t rs,
                                int64_t cs, const TcOps& ops, int diag_mode,
                                const DiagView& dv_inv, const DiagView& dv_fwd,
                                float* part, const QT* q, const Top& top = Top()) {
  constexpr bool kSlab = std::is_same<QT, QView>::value;
  static_assert(kSlab || std::is_same<QT, QHigh>::value, "a QView or a QHigh");
  float* sFr = tc_tile(kTileF);
  float* sFi = sFr + kTcTileFloats;
  float* sBr = tc_tile(kTileB);
  float* sBi = sBr + kTcTileFloats;
  uint32_t* ring = tc_ring();
  float* scratch = reinterpret_cast<float*>(ring);  // Q's, when the ring is idle
  const int qkind = stage ? bkind : kStoreF32;
  const int fqkind = stage ? fkind : kStoreF32;
  const bool q_on_load = q != nullptr && diag_mode == 1;
  const int load_diag = diag_mode == 1 && !q_on_load;
  // a planes operand's lo parts are zero: bf16 in both modes, f16 in tf32
  // (loaded values, or rounded to their storage after the run's entries: a
  // slab step with a run stages; on the high view, a run rolled back on
  // load leaves f32 values in the tiles)
  const bool stored = kSlab || diag_mode != 1;
  const bool f_exact = stored && fkind != kStoreF32;
  const bool b_exact_tf32 = stored && bkind != kStoreF32;
  const bool b_exact_t = TM == kTf32x3 ? b_exact_tf32
                                       : stored && bkind == kStoreBF16;
  // In 3xTF32 an operator meets exact planes (16-bit F or B) in three parts
  // (the wrapper's step_operators pre-splits it so): its two-part split
  // would leave ~2^-22 of each product, four times an f32 product's error.
  const bool u3 = UM == kTf32x3 && f_exact;
  const bool t3 = TM == kTf32x3 && b_exact_tf32;

  __syncthreads();  // the previous tile's stores, pair gram and Q are done
  if (!q_on_load) tc_prefetch_op<UM>(ring, ops.inv, u3);
  if (fkind == kStoreF32)
    tc_load_tiles<kStoreF32, !kSlab>(fr, fi, fkind, br, bi, bkind, rs, cs,
                                     top.ss, top.cshift, load_diag, dv_inv,
                                     dv_fwd, fqkind, qkind);
  else
    tc_load_tiles<kStoreBF16, !kSlab>(fr, fi, fkind, br, bi, bkind, rs, cs,
                                      top.ss, top.cshift, load_diag, dv_inv,
                                      dv_fwd, fqkind, qkind);
  top.after_load();
  if (q_on_load) {
    __syncthreads();  // the tile is loaded
    if constexpr (kSlab)
      q_tile<kGroup, false, TcRows>(sFr, sFi, sBr, sBi, *q, scratch);
    else
      q_tile<kGroup, TcRows>(sFr, sFi, sBr, sBi, *q, scratch);
    __syncthreads();  // every read of the raw tiles and of the scratch is done
    diag_tile_smem<kGroup, TcRows>(sFr, sFi, dv_inv, fqkind);
    diag_tile_smem<kGroup, TcRows>(sBr, sBi, dv_fwd, qkind);
    tc_prefetch_op<UM>(ring, ops.inv, u3);
  }

  tc_op_tile_op<UM>(ops.inv, kTileF, f_exact, u3, kStoreF32);  // fin = Einv F
  tc_prefetch_op<TM>(ring, ops.et, t3);
  __syncthreads();  // fin is complete
  // the pair gram of the incoming cotangent and fin
  if constexpr (GX3)
    pair_gram_x3_tc(part);
  else
    pair_gram_tf32_mma128(part, b_exact_tf32);
  // bout = E^T B (its first barrier also waits for the pair gram's reads of B)
  tc_op_tile_op<TM>(ops.et, kTileB, b_exact_t, t3,
                    diag_mode == 2 ? qkind : kStoreF32);
  __syncthreads();  // bout is complete
  if (q != nullptr && diag_mode == 2) {
    if constexpr (!kSlab)
      q_tile<kGroup, TcRows>(sFr, sFi, sBr, sBi, *q, scratch);
    else if (fqkind != kStoreF32)
      q_tile<kGroup, true, TcRows>(sFr, sFi, sBr, sBi, *q, scratch, fqkind);
    else
      q_tile<kGroup, false, TcRows>(sFr, sFi, sBr, sBi, *q, scratch);
  }
  top.before_store();
  if (fkind == kStoreF32)
    tc_store_tile<kStoreF32, !kSlab>(fr, fi, fkind, rs, cs, top.ss, top.cshift,
                                     kTileF, diag_mode == 2, dv_inv);
  else
    tc_store_tile<kStoreBF16, !kSlab>(fr, fi, fkind, rs, cs, top.ss, top.cshift,
                                      kTileF, diag_mode == 2, dv_inv, fqkind);
  tc_store_tile<-1, !kSlab>(br, bi, bkind, rs, cs, top.ss, top.cshift, kTileB,
                            diag_mode == 2, dv_fwd);
}

}  // namespace dqc
