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
#pragma once

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
// float4 (four rows of the operator tile, four columns of the tile).
template <int X>
__device__ void op_times_tile(const float* __restrict__ er,
                              const float* __restrict__ ei, int trans,
                              const float* tr_, const float* ti_, float* sTr,
                              float* sTi, float (&accr)[8][4],
                              float (&acci)[8][4]) {
  using Cfg = AdjCfg<X>;
  constexpr int KC = Cfg::KC, CT = Cfg::CT, LD = Cfg::LD;
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
      sTr[kk * X + row] = __ldg(er + src);
      sTi[kk * X + row] = __ldg(ei + src);
    }
    __syncthreads();
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

// The products back into the shared-memory tile [y][c].
template <int X>
__device__ __forceinline__ void acc_to_tile(const float (&accr)[8][4],
                                            const float (&acci)[8][4],
                                            float* tr_, float* ti_) {
  using Cfg = AdjCfg<X>;
  const int t = threadIdx.x % kHalf;
  const int rg = t / Cfg::CT, ct = t % Cfg::CT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = (rg * 8 + i) * Cfg::LD + 4 * ct;
    *reinterpret_cast<float4*>(tr_ + o) =
        make_float4(accr[i][0], accr[i][1], accr[i][2], accr[i][3]);
    *reinterpret_cast<float4*>(ti_ + o) =
        make_float4(acci[i][0], acci[i][1], acci[i][2], acci[i][3]);
  }
}

// Planes <-> shared-memory tile, in the order that keeps device-memory
// accesses coalesced (x fastest when the rows are adjacent, rs == 1),
// optionally times the run's entries.
template <int X>
__device__ void load_tile(const float* gr_, const float* gi_, int64_t rs,
                          int64_t cs, float* tr_, float* ti_, int use_diag,
                          const DiagView& dv) {
  using Cfg = AdjCfg<X>;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = rs == 1 ? e % X : e / Cfg::C;
    const int c = rs == 1 ? e / X : e % Cfg::C;
    float vr = gr_[x * rs + c * cs], vi = gi_[x * rs + c * cs];
    if (use_diag) {
      float dr, di;
      diag_view_at(dv, x, c, dr, di);
      cmul(vr, vi, dr, di, vr, vi);
    }
    tr_[x * Cfg::LD + c] = vr;
    ti_[x * Cfg::LD + c] = vi;
  }
}

template <int X>
__device__ void store_tile(float* gr_, float* gi_, int64_t rs, int64_t cs,
                           const float* tr_, const float* ti_, int use_diag,
                           const DiagView& dv) {
  using Cfg = AdjCfg<X>;
  for (int e = threadIdx.x; e < X * Cfg::C; e += kAdjThreads) {
    const int x = rs == 1 ? e % X : e / Cfg::C;
    const int c = rs == 1 ? e / X : e % Cfg::C;
    float vr = tr_[x * Cfg::LD + c], vi = ti_[x * Cfg::LD + c];
    if (use_diag) {
      float dr, di;
      diag_view_at(dv, x, c, dr, di);
      cmul(vr, vi, dr, di, vr, vi);
    }
    gr_[x * rs + c * cs] = vr;
    gi_[x * rs + c * cs] = vi;
  }
}

// part[g][x][y] (re), part[g][X X + x X + y] (im) += sum over this group's
// columns, the float4 columns 4 (g + G kk) .. + 3, of B[x][c] F[y][c];
// x = rx + i, y = cy + CT2 j.
template <int X>
__device__ void pair_gram(const float* bR, const float* bI, const float* fR,
                          const float* fI, float* part) {
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

struct Operators {  // real/imag planes of Einv and E (X x X each)
  const float* inv_r;
  const float* inv_i;
  const float* e_r;
  const float* e_i;
};

// One adjoint step on the tile at (fr, fi, br, bi) with strides (rs, cs).
// diag_mode: 0 none, 1 roll the run back on load, 2 on store.
template <int X>
__device__ void adjoint_tile(float* fr, float* fi, float* br, float* bi,
                             int64_t rs, int64_t cs, const Operators& ops,
                             int diag_mode, const DiagView& dv_inv,
                             const DiagView& dv_fwd, float* part,
                             float* smem) {
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

  __syncthreads();  // the previous tile's stores and gram have read the buffers
  load_tile<X>(fr, fi, rs, cs, sFr, sFi, diag_mode == 1, dv_inv);
  load_tile<X>(br, bi, rs, cs, sBr, sBi, diag_mode == 1, dv_fwd);

  // first half: the uncompute fin = Einv F; second half: the transport
  // bout = E^T B (one call site, so that every thread meets the same
  // barriers)
  op_times_tile<X>(half ? ops.e_r : ops.inv_r, half ? ops.e_i : ops.inv_i,
                   half, half ? sBr : sFr, half ? sBi : sFi, sTr, sTi, accr,
                   acci);
  __syncthreads();  // every thread is done reading F
  acc_to_tile<X>(accr, acci, half ? sOr : sFr, half ? sOi : sFi);
  __syncthreads();  // fin and bout are complete
  store_tile<X>(fr, fi, rs, cs, sFr, sFi, diag_mode == 2, dv_inv);
  store_tile<X>(br, bi, rs, cs, sOr, sOi, diag_mode == 2, dv_fwd);

  // the pair gram of the incoming cotangent and fin
  pair_gram<X>(sBr, sBi, sFr, sFi, part);
}

// out[e] = sum over slots s of part[s n2 + e], e < n2, in slot order: each
// of the 32 y-threads of a column of the block sums the slots s = ty mod 32
// in order, then thread ty = 0 adds the 32 sums in order.
__global__ void adjoint_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int64_t nslots,
                                      int n2) {
  __shared__ float acc[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (e < n2)
    for (int64_t s = threadIdx.y; s < nslots; s += 32)
      sum += part[s * n2 + e];
  acc[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && e < n2) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += acc[y][threadIdx.x];
    out[e] = total;
  }
}

inline int launch_reduce(const float* part, float* out, int64_t nslots, int n2,
                         cudaStream_t stream) {
  adjoint_reduce_kernel<<<(n2 + 31) / 32, dim3(32, 32), 0, stream>>>(
      part, out, nslots, n2);
  return (int)cudaGetLastError();
}

}  // namespace dqc
