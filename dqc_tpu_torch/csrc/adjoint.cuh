// The one-pass adjoint step on a tile of columns, shared by the backward
// kernels (block_backward_dual.cu, block_backward_high.cu).
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
// planes between the two.
//
// Design: 512 threads in two halves of 256. The block reads the tile of F
// and of B into shared memory (3 x 68 KB with the third buffer below, at
// X = 128) before it writes anything, so the step is in place. Then the two
// halves run the two operator products at once — the first half the
// uncompute on F, the second the transport on B — each thread keeping 8 rows
// x 4 columns of its product in registers while 8-deep tiles of its half's
// operator stream through shared memory. Shared-memory rows are padded to a
// multiple of four floats, so that the products and the pair gram read
// float4. The uncompute's result replaces F in shared memory, the
// transport's goes to a third buffer (B is still needed), and all 512
// threads then store both in the load's coalesced order and form the pair
// gram. The pair gram splits the tile's columns over G groups of threads
// (G = 1 at X = 128); each group adds its share into its own partial slot in
// device memory, which only this block touches, with reductions that do not
// wait for the old value (each entry has one writer, so they add in program
// order), and a second kernel adds the slots in a fixed order: the result
// does not depend on scheduling.
//
// Reduced cotangent storage and bf16x3 (config.set_state_storage,
// set_bwd_kernel_dot_mode / set_gram_kernel_dot_mode): B may be stored as
// bf16 or f16 (common.cuh's codec at its loads and stores; F stays f32), the
// transport may run bf16x3 (TX3) and the pair gram bf16x3 (GX3), the
// uncompute always f32. The bf16x3 pair gram of a 128-row tile runs on the
// tensor cores (pair_gram_x3_mma128: mma.sync m16n8k16 bf16, three products
// per real product, the parts split from shared memory into registers);
// faster than the f32 gram's FMAs. Elsewhere bf16x3 is two FMAs per real
// product on parts split in registers (common.cuh cmac3): the transport half
// stages its operator tile as hi and lo parts at half the depth, in the same
// shared memory, and splits the tile's values as it reads them; a narrower
// pair gram splits both operands as it reads them, one column of its float4
// at a time so that the parts stay in registers.
//
// "bf16" storage and the forward bf16x3 (config.set_state_storage("bf16"),
// set_kernel_dot_mode): F may be stored as bf16 too (fkind, a run-time
// argument as B's kind, the same codec; its loads and stores branch once
// to a loop of each kind, since a per-element branch there cost the f32
// adjoints 3-18% on the H100), rounded where the TPU kernel stores and
// reloads it (stage, as B), and the uncompute may run bf16x3 (UX3): the
// first half then stages its operator tile as hi and lo parts as the
// transport half does with TX3.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dqc {

constexpr int kAdjThreads = 512;
constexpr int kHalf = kAdjThreads / 2;  // threads per operator product

template <int X>
struct AdjCfg {
  static constexpr int C = 8192 / X;      // tile columns
  static constexpr int LD = C + 4;        // padded row, float4-aligned
  static constexpr int KC = 8;            // operator tile depth
  // operator x tile products, one per half: 8 rows x 4 columns per thread
  static constexpr int RG = X / 8;        // row groups
  static constexpr int CT = kHalf / RG;   // column threads (C / 4)
  static constexpr int C4 = C / 4;        // float4 columns
  // pair gram: X x X outputs, the tile's C columns split over G groups
  static constexpr int CT2 = X / 4;
  static constexpr int TPG = RG * CT2;          // threads per group
  static constexpr int G = kAdjThreads / TPG;   // column groups
  static constexpr int kSlotFloats = 2 * X * X;  // one partial (re, im)
  // F, B and the transport's result (re, im), and one operator tile per half
  static constexpr int kSmemFloats = 6 * X * LD + 4 * KC * X;
  static constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
  static_assert(CT * 4 == C, "four columns per thread");
  static_assert(TPG * G == kAdjThreads, "gram groups fill the block");
  static_assert(C4 % G == 0, "gram groups share the float4 columns evenly");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
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

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// acc[i][j] = sum_k Op[y][k] T[k][c] for y = rg 8 + i, c = 4 ct + j, with
// Op = E (trans = 0) or E^T (trans = 1), E an X x X operator in device
// memory and T the shared-memory tile [x][c]; run by each half of the block
// on its own operands and operator-tile buffer. Both operands are read as
// float4 (four rows of the operator tile, four columns of the tile). With
// TX3 the second half (trans = 1, the transport) runs bf16x3: its operator
// tile holds the hi and lo parts of KC / 2 rows of E, and both halves step
// KC / 2 deep so that they meet the same barriers. UX3 runs the first half
// (trans = 0, the uncompute) bf16x3 the same way.
template <int X, bool TX3 = false, bool UX3 = false>
__device__ void op_times_tile(const float* __restrict__ er,
                              const float* __restrict__ ei, int trans,
                              const float* tr_, const float* ti_, float* sTr,
                              float* sTi, float (&accr)[8][4],
                              float (&acci)[8][4]) {
  using Cfg = AdjCfg<X>;
  constexpr int KC = TX3 || UX3 ? Cfg::KC / 2 : Cfg::KC, CT = Cfg::CT;
  constexpr int LD = Cfg::LD;
  const bool x3 = trans ? TX3 : UX3;
  // the x3 half's operator tile: hi (r, i) in sTr, lo (r, i) after it
  float* sLr = sTr + 2 * KC * X;
  float* sLi = sLr + KC * X;
  if (x3) sTi = sTr + KC * X;
  const int t = threadIdx.x % kHalf;
  const int rg = t / CT, ct = t % CT;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0.f;
  for (int k0 = 0; k0 < X; k0 += KC) {
    __syncthreads();  // the tile is ready / the previous operator tile is consumed
    for (int e = t; e < KC * X; e += kHalf) {
      int row, kk;
      int64_t src;
      if (trans) {  // Op[row][k] = E[k][row]: read rows of E
        kk = e / X;
        row = e % X;
        src = (int64_t)(k0 + kk) * X + row;
      } else {
        row = e / KC;
        kk = e % KC;
        src = (int64_t)row * X + k0 + kk;
      }
      const float vr = __ldg(er + src), vi = __ldg(ei + src);
      if (x3) {
        split_hl(vr, sTr[kk * X + row], sLr[kk * X + row]);
        split_hl(vi, sTi[kk * X + row], sLi[kk * X + row]);
      } else {
        sTr[kk * X + row] = vr;
        sTi[kk * X + row] = vi;
      }
    }
    __syncthreads();
    if (x3) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 br4 =
            *reinterpret_cast<const float4*>(tr_ + (k0 + kk) * LD + 4 * ct);
        const float4 bi4 =
            *reinterpret_cast<const float4*>(ti_ + (k0 + kk) * LD + 4 * ct);
        const float br[4] = {br4.x, br4.y, br4.z, br4.w};
        const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
        float brh[4], brs[4], bih[4], bis[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_hs(br[j], brh[j], brs[j]);
          split_hs(bi[j], bih[j], bis[j]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = kk * X + rg * 8 + 4 * h;
          const float4 arh4 = *reinterpret_cast<const float4*>(sTr + o);
          const float4 aih4 = *reinterpret_cast<const float4*>(sTi + o);
          const float4 arl4 = *reinterpret_cast<const float4*>(sLr + o);
          const float4 ail4 = *reinterpret_cast<const float4*>(sLi + o);
          const float arh[4] = {arh4.x, arh4.y, arh4.z, arh4.w};
          const float aih[4] = {aih4.x, aih4.y, aih4.z, aih4.w};
          const float arl[4] = {arl4.x, arl4.y, arl4.z, arl4.w};
          const float ail[4] = {ail4.x, ail4.y, ail4.z, ail4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cmac3(accr[4 * h + i][j], acci[4 * h + i][j], arh[i], arl[i],
                    aih[i], ail[i], brh[j], brs[j], bih[j], bis[j]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 br4 =
            *reinterpret_cast<const float4*>(tr_ + (k0 + kk) * LD + 4 * ct);
        const float4 bi4 =
            *reinterpret_cast<const float4*>(ti_ + (k0 + kk) * LD + 4 * ct);
        const float br[4] = {br4.x, br4.y, br4.z, br4.w};
        const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows rg 8 + 4 h .. + 3, one float4 each
          const float4 ar4 =
              *reinterpret_cast<const float4*>(sTr + kk * X + rg * 8 + 4 * h);
          const float4 ai4 =
              *reinterpret_cast<const float4*>(sTi + kk * X + rg * 8 + 4 * h);
          const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
          const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cmac(accr[4 * h + i][j], acci[4 * h + i][j], ar[i], ai[i], br[j],
                   bi[j]);
        }
      }
    }
  }
}

// The products back into the shared-memory tile [y][c], rounded to the
// storage kind qkind (kStoreF32: as they are).
template <int X>
__device__ __forceinline__ void acc_to_tile(const float (&accr)[8][4],
                                            const float (&acci)[8][4],
                                            float* tr_, float* ti_,
                                            int qkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  const int t = threadIdx.x % kHalf;
  const int rg = t / Cfg::CT, ct = t % Cfg::CT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = (rg * 8 + i) * Cfg::LD + 4 * ct;
    *reinterpret_cast<float4*>(tr_ + o) = make_float4(
        quantize(accr[i][0], qkind), quantize(accr[i][1], qkind),
        quantize(accr[i][2], qkind), quantize(accr[i][3], qkind));
    *reinterpret_cast<float4*>(ti_ + o) = make_float4(
        quantize(acci[i][0], qkind), quantize(acci[i][1], qkind),
        quantize(acci[i][2], qkind), quantize(acci[i][3], qkind));
  }
}

// Planes <-> shared-memory tile, in the order that keeps device-memory
// accesses coalesced (x fastest when the rows are adjacent, rs == 1),
// optionally times the run's entries; the planes stored as kind (common.cuh
// codec). qkind rounds the loaded values times the run to that storage
// (kStoreF32: not at all), as a store and a reload would. K >= 0 fixes the
// planes' kind at compile time (the forward planes': each kind its own
// loop, so that the f32 one keeps its plain loads), else ``kind`` gives it.
template <int X, int K = -1>
__device__ void load_tile(const void* gr_, const void* gi_, int kind,
                          int64_t rs, int64_t cs, float* tr_, float* ti_,
                          int use_diag, const DiagView& dv,
                          int qkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  if constexpr (K >= 0) kind = K;
  if constexpr (K == kStoreF32) qkind = kStoreF32;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = rs == 1 ? e % X : e / Cfg::C;
    const int c = rs == 1 ? e / X : e % Cfg::C;
    float vr = load_plane(gr_, x * rs + c * cs, kind);
    float vi = load_plane(gi_, x * rs + c * cs, kind);
    if (use_diag) {
      float dr, di;
      diag_view_at(dv, x, c, dr, di);
      cmul(vr, vi, dr, di, vr, vi);
      vr = quantize(vr, qkind);
      vi = quantize(vi, qkind);
    }
    tr_[x * Cfg::LD + c] = vr;
    ti_[x * Cfg::LD + c] = vi;
  }
}

// qkind rounds the values to that storage before the run's entries
// multiply them (kStoreF32: not at all), as a store and a reload would.
template <int X, int K = -1>
__device__ void store_tile(void* gr_, void* gi_, int kind, int64_t rs,
                           int64_t cs, const float* tr_, const float* ti_,
                           int use_diag, const DiagView& dv,
                           int qkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  if constexpr (K >= 0) kind = K;
  if constexpr (K == kStoreF32) qkind = kStoreF32;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = rs == 1 ? e % X : e / Cfg::C;
    const int c = rs == 1 ? e / X : e % Cfg::C;
    float vr = tr_[x * Cfg::LD + c], vi = ti_[x * Cfg::LD + c];
    if (use_diag) {
      vr = quantize(vr, qkind);
      vi = quantize(vi, qkind);
      float dr, di;
      diag_view_at(dv, x, c, dr, di);
      cmul(vr, vi, dr, di, vr, vi);
    }
    store_plane(gr_, x * rs + c * cs, vr, kind);
    store_plane(gi_, x * rs + c * cs, vi, kind);
  }
}

// Two floats (the lower index first) as the hi and lo bf16 parts of a
// bf16x2 register each, for mma.sync.
__device__ __forceinline__ void split_bf16x2(float2 v, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - __low2float(h),
                                                 v.y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation on the tensor
// cores (a: 4 registers of the row-major 16 x 16 A fragment, b: 2 of the
// column-major 16 x 8 B fragment).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// added to the block's slot without waiting for the old value, as below.
__device__ void pair_gram_x3_mma128(const float* bR, const float* bI,
                                    const float* fR, const float* fI,
                                    float* part) {
  using Cfg = AdjCfg<kGroup>;
  constexpr int LD = Cfg::LD, X = kGroup;
  static_assert(Cfg::C == 64 && Cfg::G == 1, "X = 128 tiles, one slot");
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
        split_bf16x2(*reinterpret_cast<const float2*>(bR + row * LD + col),
                     arh[r], arl[r]);
        split_bf16x2(*reinterpret_cast<const float2*>(bI + row * LD + col),
                     aih[r], ail[r]);
        anh[r] = aih[r] ^ 0x80008000u;
        anl[r] = ail[r] ^ 0x80008000u;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // B = F^T: column y = yb + 8 n + g, rows c = kb + 2 t (+ 8)
        const float* fr = fR + (yb + 8 * n + g) * LD + kb + 2 * t;
        const float* fi = fI + (yb + 8 * n + g) * LD + kb + 2 * t;
        uint32_t brh0, brl0, brh1, brl1, bih0, bil0, bih1, bil1;
        split_bf16x2(*reinterpret_cast<const float2*>(fr), brh0, brl0);
        split_bf16x2(*reinterpret_cast<const float2*>(fr + 8), brh1, brl1);
        split_bf16x2(*reinterpret_cast<const float2*>(fi), bih0, bil0);
        split_bf16x2(*reinterpret_cast<const float2*>(fi + 8), bih1, bil1);
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
        atomicAdd(part + x * X + y, accr[m][n][e]);
        atomicAdd(part + X * X + x * X + y, acci[m][n][e]);
      }
}

// part[g][x][y] (re), part[g][X X + x X + y] (im) += sum over this group's
// columns, the float4 columns 4 (g + G kk) .. + 3, of B[x][c] F[y][c];
// x = rx + i, y = cy + CT2 j. With GX3 the products run bf16x3: on the
// tensor cores at X = 128 (pair_gram_x3_mma128), else on the CUDA cores,
// the columns of a float4 one at a time with scalar reads, B as (hi, lo)
// parts and F as (hi, hi + lo).
template <int X, bool GX3 = false>
__device__ void pair_gram(const float* bR, const float* bI, const float* fR,
                          const float* fI, float* part) {
  if constexpr (GX3 && X == kGroup) {
    pair_gram_x3_mma128(bR, bI, fR, fI, part);
    return;
  }
  using Cfg = AdjCfg<X>;
  constexpr int G = Cfg::G, CT2 = Cfg::CT2, LD = Cfg::LD;
  const int g = threadIdx.x / Cfg::TPG, t = threadIdx.x % Cfg::TPG;
  const int rx = (t / CT2) * 8, cy = t % CT2;
  float* slot = part + (int64_t)g * Cfg::kSlotFloats;
  float accr[8][4], acci[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0.f;
  for (int c4 = g; c4 < Cfg::C4; c4 += G) {
    const int c = 4 * c4;
    if constexpr (GX3) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float fh_r[4], fs_r[4], fh_i[4], fs_i[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_hs(fR[(cy + CT2 * j) * LD + c + u], fh_r[j], fs_r[j]);
          split_hs(fI[(cy + CT2 * j) * LD + c + u], fh_i[j], fs_i[j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float bh_r, bl_r, bh_i, bl_i;
          split_hl(bR[(rx + i) * LD + c + u], bh_r, bl_r);
          split_hl(bI[(rx + i) * LD + c + u], bh_i, bl_i);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cmac3(accr[i][j], acci[i][j], bh_r, bl_r, bh_i, bl_i, fh_r[j],
                  fs_r[j], fh_i[j], fs_i[j]);
        }
      }
    } else {
      float4 f_r[4], f_i[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f_r[j] = *reinterpret_cast<const float4*>(fR + (cy + CT2 * j) * LD + c);
        f_i[j] = *reinterpret_cast<const float4*>(fI + (cy + CT2 * j) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 b_r = *reinterpret_cast<const float4*>(bR + (rx + i) * LD + c);
        const float4 b_i = *reinterpret_cast<const float4*>(bI + (rx + i) * LD + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cmac(accr[i][j], acci[i][j], b_r.x, b_i.x, f_r[j].x, f_i[j].x);
          cmac(accr[i][j], acci[i][j], b_r.y, b_i.y, f_r[j].y, f_i[j].y);
          cmac(accr[i][j], acci[i][j], b_r.z, b_i.z, f_r[j].z, f_i[j].z);
          cmac(accr[i][j], acci[i][j], b_r.w, b_i.w, f_r[j].w, f_i[j].w);
        }
      }
    }
  }
  // each entry of the slot has this one thread as its only writer, tile
  // after tile: a reduction without return (red.global) adds in program
  // order, like "+=", but does not wait for the entry's old value
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = (rx + i) * X + cy + CT2 * j;
      atomicAdd(slot + e, accr[i][j]);
      atomicAdd(slot + X * X + e, acci[i][j]);
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
// the tile keeps the unrounded values the pair gram reads).
template <int X, bool RF = false>
__device__ void q_tile(const float* fR, const float* fI, const float* bR,
                       const float* bI, const QView& q, float* scratch,
                       int fq = kStoreF32) {
  static_assert(X == kGroup, "slab tiles: X = 128");
  using Cfg = AdjCfg<kGroup>;
  constexpr int LD = Cfg::LD;
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
      const int c = lane + 32 * j;
      float qr, qi, fr = fR[x * LD + c], fi = fI[x * LD + c];
      if constexpr (RF) {
        fr = quantize(fr, fq);
        fi = quantize(fi, fq);
      }
      cmul(bR[x * LD + c], bI[x * LD + c], fr, fi, qr, qi);
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
// diag_q outputs of block_backward_high): the tile is X rows x C = 8192 / X
// columns of the view (A1, X, Q = post 128 128) at (i, q0 .. q0 + C - 1),
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

// The tile's share of the Q reductions, Q = B F, from the shared-memory
// tiles of F and B. The caller walks a block's tiles one (i, p) group at a
// time (all 128 x 128 columns of one i and p, so every Qas and Qal entry
// has one block as its writer), and within a block every entry keeps one
// writer thread, tile after tile:
// * Qal[a, l]: thread f = x SL + lc (SL = min(C, 128) columns of one
//   (x, s) segment) sums the tile's C / SL segments of row x at column lc in
//   order, then adds to the entry;
// * Qas[a, s]: warp w takes the segments (x, k) = w, w + 16, ...; a
//   segment's sum is a fixed butterfly of warp shuffles, added by lane 0;
// * Qsl[s, l]: column c's sum over the rows, in R = max(1, 512 / C) row
//   chunks whose partials go to scratch (2 R C <= 32 X floats, the
//   operator-tile buffers) and are added in chunk order by one thread, which
//   adds the result to the block's slot (red.global, as the pair gram).
// Every read of F and B comes before the one barrier, so the caller may
// update the tiles once this returns.
template <int X>
__device__ void q_tile(const float* fR, const float* fI, const float* bR,
                       const float* bI, const QHigh& q, float* scratch) {
  using Cfg = AdjCfg<X>;
  constexpr int C = Cfg::C, LD = Cfg::LD;
  constexpr int SL = C < kGroup ? C : kGroup;
  constexpr int NSEG = C / SL;
  constexpr int R = C < kAdjThreads ? kAdjThreads / C : 1;
  constexpr int RC = X / R;
  static_assert(R == 1 || 2 * R * C <= 4 * Cfg::KC * X, "scratch holds the partials");
  const int64_t p = q.q0 >> 14;
  const int s0 = (int)((q.q0 >> 7) & 127);
  const int l0 = (int)(q.q0 & 127);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = threadIdx.x; f < X * SL; f += kAdjThreads) {
    const int x = f / SL, lc = f % SL;
    float sr = 0.f, si = 0.f;
#pragma unroll 1
    for (int k = 0; k < NSEG; ++k) {
      const int e = x * LD + k * SL + lc;
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
  for (int seg = warp; seg < X * NSEG; seg += kAdjThreads / 32) {
    const int x = seg / NSEG, k = seg % NSEG;
    float sr = 0.f, si = 0.f;
    for (int lc = lane; lc < SL; lc += 32) {
      const int e = x * LD + k * SL + lc;
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
  for (int t = threadIdx.x; t < R * C; t += kAdjThreads) {
    const int c = t % C, r = t / C;
    float sr = 0.f, si = 0.f;
#pragma unroll 1
    for (int x = r * RC; x < (r + 1) * RC; ++x) {
      float qr, qi;
      cmul(bR[x * LD + c], bI[x * LD + c], fR[x * LD + c], fI[x * LD + c], qr,
           qi);
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
    for (int c = threadIdx.x; c < C; c += kAdjThreads) {
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

// The shared-memory tile [x][c] times the run's entries, in place, rounded
// to the storage kind qkind.
template <int X>
__device__ void diag_tile_smem(float* tr_, float* ti_, const DiagView& dv,
                               int qkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = e / Cfg::C, c = e % Cfg::C;
    float dr, di, vr, vi;
    diag_view_at(dv, x, c, dr, di);
    cmul(tr_[x * Cfg::LD + c], ti_[x * Cfg::LD + c], dr, di, vr, vi);
    tr_[x * Cfg::LD + c] = quantize(vr, qkind);
    ti_[x * Cfg::LD + c] = quantize(vi, qkind);
  }
}

struct Operators {  // real/imag planes of Einv and E (X x X each)
  const float* inv_r;
  const float* inv_i;
  const float* e_r;
  const float* e_i;
};

// One adjoint step on the tile at (fr, fi, br, bi) with strides (rs, cs).
// diag_mode: 0 none, 1 roll the run back on load, 2 on store. q (null for
// none): where the run's Q reductions go (QView for a slab tile, QHigh for a
// high-view tile), from the planes as they meet the run — loaded as they
// are, then the run's entries multiplied in shared memory (mode 1), or
// before the store (mode 2). B is stored as bkind, F as fkind; TX3 / GX3 /
// UX3 run the transport / the pair gram / the uncompute bf16x3. stage (the
// dual adjoint, whose TPU kernel stages the run's step through its output
// planes) rounds F and B to their storage where that kernel stores and
// reloads them: after the run's entries on load, before them on store (B's
// transport result in shared memory; F as it is stored and as the Q
// reductions read it, since the pair gram reads it unrounded). Without
// stage (the high adjoint) Q takes the f32 values, as its TPU kernel's
// does. FK >= 0 fixes F's kind at compile time.
template <int X, bool TX3 = false, bool GX3 = false, class QT = QView,
          bool UX3 = false, int FK = -1>
__device__ void adjoint_tile(void* fr, void* fi, void* br, void* bi,
                             int bkind, int stage, int64_t rs, int64_t cs,
                             const Operators& ops, int diag_mode,
                             const DiagView& dv_inv, const DiagView& dv_fwd,
                             float* part, float* smem, const QT* q = nullptr,
                             int fkind = kStoreF32) {
  using Cfg = AdjCfg<X>;
  float* sFr = smem;
  float* sFi = sFr + X * Cfg::LD;
  float* sBr = sFi + X * Cfg::LD;
  float* sBi = sBr + X * Cfg::LD;
  float* sOr = sBi + X * Cfg::LD;  // the transport's result
  float* sOi = sOr + X * Cfg::LD;
  const int half = threadIdx.x / kHalf;
  float* sTr = sOi + X * Cfg::LD + half * 2 * Cfg::KC * X;  // this half's
  float* sTi = sTr + Cfg::KC * X;                           // operator tile
  float accr[8][4], acci[8][4];
  if constexpr (FK >= 0) fkind = FK;
  const int qkind = stage ? bkind : kStoreF32;
  const int fqkind = stage ? fkind : kStoreF32;

  float* scratch = sOi + X * Cfg::LD;  // both halves' operator tiles
  __syncthreads();  // the previous tile's stores and gram have read the buffers
  const bool q_on_load = q != nullptr && diag_mode == 1;
  if (fkind == kStoreF32)
    load_tile<X, kStoreF32>(fr, fi, fkind, rs, cs, sFr, sFi,
                            diag_mode == 1 && !q_on_load, dv_inv);
  else
    load_tile<X, kStoreBF16>(fr, fi, fkind, rs, cs, sFr, sFi,
                             diag_mode == 1 && !q_on_load, dv_inv, fqkind);
  load_tile<X>(br, bi, bkind, rs, cs, sBr, sBi, diag_mode == 1 && !q_on_load,
               dv_fwd, qkind);
  if (q_on_load) {
    __syncthreads();  // the tile is loaded
    q_tile<X>(sFr, sFi, sBr, sBi, *q, scratch);
    __syncthreads();  // every read of the raw tiles is done
    diag_tile_smem<X>(sFr, sFi, dv_inv, fqkind);
    diag_tile_smem<X>(sBr, sBi, dv_fwd, qkind);
  }

  // first half: the uncompute fin = Einv F; second half: the transport
  // bout = E^T B (one call site, so that every thread meets the same
  // barriers)
  op_times_tile<X, TX3, UX3>(half ? ops.e_r : ops.inv_r,
                             half ? ops.e_i : ops.inv_i, half,
                             half ? sBr : sFr, half ? sBi : sFi, sTr, sTi,
                             accr, acci);
  __syncthreads();  // every thread is done reading F
  acc_to_tile<X>(accr, acci, half ? sOr : sFr, half ? sOi : sFi,
                 half && diag_mode == 2 ? qkind : kStoreF32);
  __syncthreads();  // fin and bout are complete
  if (q != nullptr && diag_mode == 2) {
    if constexpr (FK != kStoreF32 && std::is_same<QT, QView>::value) {
      if (fqkind != kStoreF32)
        q_tile<X, true>(sFr, sFi, sOr, sOi, *q, scratch, fqkind);
      else
        q_tile<X>(sFr, sFi, sOr, sOi, *q, scratch);
    } else {
      q_tile<X>(sFr, sFi, sOr, sOi, *q, scratch);
    }
  }
  if (fkind == kStoreF32)
    store_tile<X, kStoreF32>(fr, fi, fkind, rs, cs, sFr, sFi, diag_mode == 2,
                             dv_inv);
  else
    store_tile<X, kStoreBF16>(fr, fi, fkind, rs, cs, sFr, sFi, diag_mode == 2,
                              dv_inv, fqkind);
  store_tile<X>(br, bi, bkind, rs, cs, sOr, sOi, diag_mode == 2, dv_fwd);

  // the pair gram of the incoming cotangent and fin
  pair_gram<X, GX3>(sBr, sBi, sFr, sFi, part);
}

}  // namespace dqc
