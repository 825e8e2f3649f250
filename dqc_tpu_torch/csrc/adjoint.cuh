// The pieces the one-pass adjoint steps on the tensor cores share
// (tc_adjoint.cuh: the dual, lane and sublane adjoints, the high adjoint at
// X = 128 and the merged-top adjoint; block_backward_high_small.cu: the high
// adjoint at X = 8..64): the diagonal views (diag_group, diag_tile_smem),
// the Q reductions (q_tile) and the bf16x3 pair gram of a 128-row tile.
//
// A "column" is X amplitudes along the contracted group axis; the tile
// holds C = 8192 / X columns, and element (x, c) sits at base[x rs + c cs]
// in the planes. For a column-tile of the forward planes F, the cotangent
// planes B and the group operator E, one step computes
//
//   fin  = Einv F              (uncompute)
//   T0  += B fin^T             T0[x, y] = sum_c B[x, c] fin[y, c], with no
//                              conjugation (the holomorphic pair gram)
//   bout = E^T B               (cotangent transport)
//
// and writes fin over F and bout over B. An optional diagonal run is rolled
// back with it: fwd *= Dinv and bwd *= D on load (the run followed the dense
// block in the forward) or on store (it preceded it). The pair gram sees the
// planes between the two. Each pair-gram entry has one writer thread in a
// block, added to the block's own partial slot in device memory with
// reductions that do not wait for the old value (program order, like "+="),
// and a second kernel adds the slots in a fixed order: the result does not
// depend on scheduling.
//
// The shared-memory tile functions below take the tile's layout as a
// parameter L: L::at(x, c) is where element (x, c) sits (swizzled rows:
// SwizzledRows, block_backward_high_small.cu's).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace dqc {

constexpr int kAdjThreads = 512;

template <int X>
struct AdjCfg {
  static constexpr int C = 8192 / X;      // tile columns
};

// Rows of C floats unpadded (C a multiple of 32), column c of row x at c ^
// (8 (x & 3) + (x & 4)): a tf32 product fragment (rows k0 + t (+ 4),
// columns n0 + g) and a pair-gram fragment (rows r0 + g, columns k0 + t
// (+ 4), or float2 pairs at 2 t) each meet 32 different banks; four
// neighbouring columns stay together (16-byte loads and stores).
template <int C>
struct SwizzledRows {
  static __device__ __forceinline__ int at(int x, int c) {
    return x * C + (c ^ (((x & 3) << 3) | (x & 4)));
  }
};

// Where a tile's entries of the diagonal run D[a, s, l] come from.
struct DiagView {
  DiagTables t;
  int kind;      // 0: slab, x = s, l = c0 + c; 1: slab, x = l, s = c0 + c;
                 // 2: high view (i, x, q = c0 + c), q = (p 128 + s) 128 + l
  int64_t a;     // slab index (kinds 0, 1) or i (kind 2)
  int64_t c0;    // the tile's first column
  int X;         // kind 2: the contracted axis
  int64_t post;  // kind 2: a = (i X + x) post + p
};

__device__ __forceinline__ void diag_view_at(const DiagView& v, int x, int c,
                                             float& dr, float& di) {
  if (v.kind == 0) {
    diag_at(v.t, v.a, x, (int)(v.c0 + c), dr, di);
  } else if (v.kind == 1) {
    diag_at(v.t, v.a, (int)(v.c0 + c), x, dr, di);
  } else {
    const int64_t q = v.c0 + c;
    const int l = (int)(q & 127);
    const int s = (int)((q >> 7) & 127);
    diag_at(v.t, (v.a * v.X + x) * v.post + (q >> 14), s, l, dr, di);
  }
}

// The run's entries D[a, s, l] of the group of four neighbouring elements
// at (x, c) of a tile, which runs along l in every DiagView kind: sublane
// tiles (kind 0) have x = s, c = l - c0, lane tiles (kind 1) x = l, c = s -
// c0, and the high view's (kind 2) column q = c0 + c = (p 128 + s) 128 + l
// of row x at a = (i X + x) post + p (four columns from a multiple of four
// share a, s and p). tas[a, s] once, tal[a, l ..] and tsl[s, l ..] as
// float4 (the tables 16-byte aligned), each entry (tas tal) tsl as diag_at
// forms it. HIGH: the view is of kind 2 (known at compile time, so that the
// slab steps keep their code).
template <bool HIGH>
__device__ __forceinline__ void diag_group(const DiagView& v, int x, int c,
                                           float (&dr)[4], float (&di)[4]) {
  int s, l;
  int64_t a = v.a;
  if constexpr (HIGH) {
    const int64_t q = v.c0 + c;
    l = (int)(q & 127);
    s = (int)((q >> 7) & 127);
    a = (v.a * v.X + x) * v.post + (q >> 14);
  } else {
    s = v.kind == 0 ? x : (int)(v.c0 + c);
    l = v.kind == 0 ? (int)(v.c0 + c) : x;
  }
  const int64_t as = a * kGroup + s, al = a * kGroup + l;
  const int sl = s * kGroup + l;
  const float asr = __ldg(v.t.as_r + as), asi = __ldg(v.t.as_i + as);
  const float4 alr = __ldg(reinterpret_cast<const float4*>(v.t.al_r + al));
  const float4 ali = __ldg(reinterpret_cast<const float4*>(v.t.al_i + al));
  const float4 slr = __ldg(reinterpret_cast<const float4*>(v.t.sl_r + sl));
  const float4 sli = __ldg(reinterpret_cast<const float4*>(v.t.sl_i + sl));
  const float lr[4] = {alr.x, alr.y, alr.z, alr.w}, li[4] = {ali.x, ali.y, ali.z, ali.w};
  const float tr[4] = {slr.x, slr.y, slr.z, slr.w}, ti[4] = {sli.x, sli.y, sli.z, sli.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float mr, mi;
    cmul(asr, asi, lr[q], li[q], mr, mi);
    cmul(mr, mi, tr[q], ti[q], dr[q], di[q]);
  }
}

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// p[0] += a, p[1] += b (p 8-byte aligned) by one vector reduction that does
// not wait for the old values (sm_90's float2 atomicAdd): each entry is
// added as by a scalar one, in fewer memory operations.
__device__ __forceinline__ void red2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// d += a b in bf16x3 on the tensor cores: ah bh + ah bl + al bh.
__device__ __forceinline__ void mma_bf16x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_bf16(d, ah, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, al, bh0, bh1);
}

// The bf16x3 pair gram of a 128-row tile on the tensor cores: part[x][y]
// (re), part[X X + x X + y] (im) += sum over the tile's 64 columns of
// B[x][c] F[y][c]. Warp w owns the 32 x 32 output block at rows 32 (w / 4),
// columns 32 (w % 4): 2 x 4 m16n8 tiles, their re and im accumulators in
// registers, 16 columns per k-step. Each operand fragment is read from
// shared memory as float2 pairs and split into bf16 hi and lo registers
// there; a complex product is Br Fr - Bi Fi and Br Fi + Bi Fr, each real
// product three bf16 mma (hi hi, hi lo, lo hi), -Bi by flipping the sign
// bits of its parts (exact). Each accumulator entry has one writer thread,
// its two neighbouring entries added to the block's slot by one vector
// reduction (red2). L: the tiles' layout (a pair of neighbouring columns
// stays adjacent).
template <class L>
__device__ void pair_gram_x3_mma128(const float* bR, const float* bI,
                                    const float* fR, const float* fI,
                                    float* part) {
  using Cfg = AdjCfg<kGroup>;
  constexpr int X = kGroup;
  static_assert(Cfg::C == 64, "X = 128 tiles");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int xb = 32 * (warp >> 2), yb = 32 * (warp & 3);
  float accr[2][4][4], acci[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[m][n][e] = acci[m][n][e] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < Cfg::C; kb += 16) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      // A = B[x][c]: rows x = xb + 16 m + g (+ 8), columns kb + 2 t (+ 8)
      uint32_t arh[4], arl[4], aih[4], ail[4], anh[4], anl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = xb + 16 * m + g + 8 * (r & 1);
        const int col = kb + 2 * t + 8 * (r >> 1);
        const int o = L::at(row, col);
        split_bf16x2(*reinterpret_cast<const float2*>(bR + o), arh[r], arl[r]);
        split_bf16x2(*reinterpret_cast<const float2*>(bI + o), aih[r], ail[r]);
        anh[r] = aih[r] ^ 0x80008000u;
        anl[r] = ail[r] ^ 0x80008000u;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // B = F^T: column y = yb + 8 n + g, rows c = kb + 2 t (+ 8)
        const int o0 = L::at(yb + 8 * n + g, kb + 2 * t);
        const int o1 = L::at(yb + 8 * n + g, kb + 2 * t + 8);
        uint32_t brh0, brl0, brh1, brl1, bih0, bil0, bih1, bil1;
        split_bf16x2(*reinterpret_cast<const float2*>(fR + o0), brh0, brl0);
        split_bf16x2(*reinterpret_cast<const float2*>(fR + o1), brh1, brl1);
        split_bf16x2(*reinterpret_cast<const float2*>(fI + o0), bih0, bil0);
        split_bf16x2(*reinterpret_cast<const float2*>(fI + o1), bih1, bil1);
        mma_bf16x3(accr[m][n], arh, arl, brh0, brh1, brl0, brl1);
        mma_bf16x3(accr[m][n], anh, anl, bih0, bih1, bil0, bil1);
        mma_bf16x3(acci[m][n], arh, arl, bih0, bih1, bil0, bil1);
        mma_bf16x3(acci[m][n], aih, ail, brh0, brh1, brl0, brl1);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = xb + 16 * m + g + 8 * (e >> 1);
        const int y = yb + 8 * n + 2 * t + (e & 1);
        if (e & 1) continue;
        red2(part + x * X + y, accr[m][n][e], accr[m][n][e + 1]);
        red2(part + X * X + x * X + y, acci[m][n][e], acci[m][n][e + 1]);
      }
}

// Where the Q reductions of a diagonal run go (the diag_q outputs of the
// dual adjoint, X = 128 slab tiles only): Q[a, s, l] = B F, the holomorphic
// pair product of the planes as they meet the run (before its update).
struct QView {
  float* sl;      // this block's partial slot in the tile's order: re
                  // [x 128 + c0 + c] (Qsl for a sublane step, its transpose
                  // for a lane step), im + 128 128
  float* as_r;    // rows (A, 128): sum over l of Q[a, s, l]
  float* as_i;
  float* al_r;    // rows (A, 128): sum over s of Q[a, s, l]
  float* al_i;
  int64_t a;      // the slab
  int sublane;    // the tile's rows x are s (columns l = c0 + c); else x = l
  int c0;         // the tile's first column
};

// The tile's share of the Q reductions from the shared-memory tiles of F and
// B (X = 128 rows, C = 64 columns). Warp w takes rows 8 w .. 8 w + 7, lane t
// the columns t and t + 32. Each Qsl entry has one writer thread in the
// block, tile after tile (red.global, as the pair gram), and a warp's 32
// lanes add to 32 adjacent entries (the slot keeps the tile's order, so a
// lane step's Q lands transposed); a row's sum over the
// tile is a fixed butterfly of warp shuffles, added by the warp's lane 0; a
// column's is 16 per-warp partials in scratch (2 x 16 x 64 floats, the
// operator-tile buffers, unused here), added in warp order by one thread.
// Rows and columns of a slab are summed into the (A, 128) outputs by their
// one owner thread, in tile order: the sums do not depend on scheduling.
// RF rounds F to the storage kind fq as it is read (the dual adjoint's TPU
// kernel stores F and rereads it before a run met after the dense steps;
// the tile keeps the unrounded values the pair gram reads). L: the tiles'
// layout.
template <int X, bool RF, class L>
__device__ void q_tile(const float* fR, const float* fI, const float* bR,
                       const float* bI, const QView& q, float* scratch,
                       int fq = kStoreF32) {
  static_assert(X == kGroup, "slab tiles: X = 128");
  using Cfg = AdjCfg<kGroup>;
  static_assert(Cfg::C == 64, "X = 128 tiles");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows of the tile sum into Qas (x = s) or Qal (x = l); columns into the
  // other
  float* row_r = q.sublane ? q.as_r : q.al_r;
  float* row_i = q.sublane ? q.as_i : q.al_i;
  float* col_r = q.sublane ? q.al_r : q.as_r;
  float* col_i = q.sublane ? q.al_i : q.as_i;
  float colr[2] = {0.f, 0.f}, coli[2] = {0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int x = warp * 8 + i;
    float rr = 0.f, ri = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, o = L::at(x, c);
      float qr, qi, fr = fR[o], fi = fI[o];
      if constexpr (RF) {
        fr = quantize(fr, fq);
        fi = quantize(fi, fq);
      }
      cmul(bR[o], bI[o], fr, fi, qr, qi);
      const int sl = x * kGroup + q.c0 + c;
      atomicAdd(q.sl + sl, qr);
      atomicAdd(q.sl + kGroup * kGroup + sl, qi);
      rr += qr;
      ri += qi;
      colr[j] += qr;
      coli[j] += qi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      rr += __shfl_xor_sync(0xffffffffu, rr, off);
      ri += __shfl_xor_sync(0xffffffffu, ri, off);
    }
    if (lane == 0) {
      row_r[q.a * kGroup + x] += rr;
      row_i[q.a * kGroup + x] += ri;
    }
  }
  float* sr = scratch;
  float* si = scratch + 16 * Cfg::C;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    sr[warp * Cfg::C + lane + 32 * j] = colr[j];
    si[warp * Cfg::C + lane + 32 * j] = coli[j];
  }
  __syncthreads();  // the column partials are complete
  if (threadIdx.x < Cfg::C) {
    const int c = threadIdx.x;
    float tr = 0.f, ti = 0.f;
    for (int w = 0; w < 16; ++w) {
      tr += sr[w * Cfg::C + c];
      ti += si[w * Cfg::C + c];
    }
    col_r[q.a * kGroup + q.c0 + c] += tr;
    col_i[q.a * kGroup + q.c0 + c] += ti;
  }
}

// Where the Q reductions of a diagonal run folded into a high sweep go (the
// diag_q outputs of block_backward_high): the tile is X rows x C columns of
// the view (A1, X, Q = post 128 128) at (i, q0 .. q0 + C - 1),
// column q = (p 128 + s) 128 + l of row x holding the run's entry
// D[a = (i X + x) post + p, s, l].
struct QHigh {
  float* sl;      // this block's Qsl partial slot: re [s 128 + l], im + 128 128
  float* as_r;    // rows (A, 128): sum over l of Q[a, s, l]
  float* as_i;
  float* al_r;    // rows (A, 128): sum over s of Q[a, s, l]
  float* al_i;
  int64_t i;      // the tile's leading index
  int64_t q0;     // the tile's first column
  int64_t post;
};

// The shape of q_tile's work on a tile of X rows x C columns of the high
// view (C = 8192 / X by default), run by NT threads: segments of SL columns
// (one (x, s) row of l each), R row chunks of the column sums, whose
// partials need kScratchFloats of the caller's shared memory.
template <int X, int C_ = AdjCfg<X>::C, int NT = kAdjThreads>
struct QHighCfg {
  static constexpr int C = C_;
  static constexpr int SL = C < kGroup ? C : kGroup;
  static constexpr int NSEG = C / SL;
  static constexpr int R = C < NT ? NT / C : 1;
  static constexpr int kScratchFloats = R > 1 ? 2 * R * C : 0;
};

// The tile's share of the Q reductions, Q = B F, from the shared-memory
// tiles of F and B. The caller walks a block's tiles one (i, p) group at a
// time (all 128 x 128 columns of one i and p, so every Qas and Qal entry
// has one block as its writer), and within a block every entry keeps one
// writer thread, tile after tile:
// * Qal[a, l]: thread f = x SL + lc (SL = min(C, 128) columns of one
//   (x, s) segment) sums the tile's C / SL segments of row x at column lc in
//   order, then adds to the entry;
// * Qas[a, s]: warp w takes the segments (x, k) = w, w + NT / 32, ...; a
//   segment's sum is a fixed butterfly of warp shuffles, added by lane 0;
// * Qsl[s, l]: column c's sum over the rows, in R = max(1, NT / C) row
//   chunks whose partials go to scratch (QHighCfg::kScratchFloats, idle
//   shared memory of the caller's) and are added in chunk order by one
//   thread, which adds the result to the block's slot (red.global, as the
//   pair gram).
// Every read of F and B comes before the one barrier (R > 1), so the caller
// may then update the tiles. L: the tiles' layout; C_ the tile's columns,
// NT the block's threads.
template <int X, class L, int C_ = AdjCfg<X>::C, int NT = kAdjThreads>
__device__ void q_tile(const float* fR, const float* fI, const float* bR,
                       const float* bI, const QHigh& q, float* scratch) {
  using Cfg = QHighCfg<X, C_, NT>;
  constexpr int C = Cfg::C, SL = Cfg::SL, NSEG = Cfg::NSEG, R = Cfg::R;
  constexpr int RC = X / R;
  const int64_t p = q.q0 >> 14;
  const int s0 = (int)((q.q0 >> 7) & 127);
  const int l0 = (int)(q.q0 & 127);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = threadIdx.x; f < X * SL; f += NT) {
    const int x = f / SL, lc = f % SL;
    float sr = 0.f, si = 0.f;
#pragma unroll 1
    for (int k = 0; k < NSEG; ++k) {
      const int e = L::at(x, k * SL + lc);
      float qr, qi;
      cmul(bR[e], bI[e], fR[e], fI[e], qr, qi);
      sr += qr;
      si += qi;
    }
    const int64_t a = (q.i * X + x) * q.post + p;
    q.al_r[a * kGroup + l0 + lc] += sr;
    q.al_i[a * kGroup + l0 + lc] += si;
  }
#pragma unroll 1
  for (int seg = warp; seg < X * NSEG; seg += NT / 32) {
    const int x = seg / NSEG, k = seg % NSEG;
    float sr = 0.f, si = 0.f;
    for (int lc = lane; lc < SL; lc += 32) {
      const int e = L::at(x, k * SL + lc);
      float qr, qi;
      cmul(bR[e], bI[e], fR[e], fI[e], qr, qi);
      sr += qr;
      si += qi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(0xffffffffu, sr, off);
      si += __shfl_xor_sync(0xffffffffu, si, off);
    }
    if (lane == 0) {
      const int64_t a = (q.i * X + x) * q.post + p;
      q.as_r[a * kGroup + s0 + k] += sr;
      q.as_i[a * kGroup + s0 + k] += si;
    }
  }
  float* pr = scratch;
  float* pi = scratch + R * C;
  for (int t = threadIdx.x; t < R * C; t += NT) {
    const int c = t % C, r = t / C;
    float sr = 0.f, si = 0.f;
#pragma unroll 1
    for (int x = r * RC; x < (r + 1) * RC; ++x) {
      const int e = L::at(x, c);
      float qr, qi;
      cmul(bR[e], bI[e], fR[e], fI[e], qr, qi);
      sr += qr;
      si += qi;
    }
    if (R == 1) {
      const int sl = (int)((q.q0 + c) & (kGroup * kGroup - 1));
      atomicAdd(q.sl + sl, sr);
      atomicAdd(q.sl + kGroup * kGroup + sl, si);
    } else {
      pr[r * C + c] = sr;
      pi[r * C + c] = si;
    }
  }
  if constexpr (R > 1) {
    __syncthreads();  // the row-chunk partials are complete
    for (int c = threadIdx.x; c < C; c += NT) {
      float sr = 0.f, si = 0.f;
      for (int r = 0; r < R; ++r) {
        sr += pr[r * C + c];
        si += pi[r * C + c];
      }
      const int sl = (int)((q.q0 + c) & (kGroup * kGroup - 1));
      atomicAdd(q.sl + sl, sr);
      atomicAdd(q.sl + kGroup * kGroup + sl, si);
    }
  }
}

// The shared-memory tile [x][c] (layout L) times the run's entries, in
// place, rounded to the storage kind qkind.
template <int X, class L>
__device__ void diag_tile_smem(float* tr_, float* ti_, const DiagView& dv,
                               int qkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = e / Cfg::C, c = e % Cfg::C, o = L::at(x, c);
    float dr, di, vr, vi;
    diag_view_at(dv, x, c, dr, di);
    cmul(tr_[o], ti_[o], dr, di, vr, vi);
    tr_[o] = quantize(vr, qkind);
    ti_[o] = quantize(vi, qkind);
  }
}

}  // namespace dqc
