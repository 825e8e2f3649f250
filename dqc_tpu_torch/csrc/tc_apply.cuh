// The dense apply on a high axis on the tensor cores: y <- [acc +] conj?(E x)
// along X = 128, 256 or 512 of the view (A1, X, Q = M 128), in every mode
// of the high apply: in place (y = x), into fresh planes, or added into
// accumulator planes, optionally conjugated, and at X = 128 with a folded
// diagonal run before (diag_first) or after the product.
//
// Built once, in csrc/high_apply.cu's library (entry dqc_tc_apply):
// high_group_apply_planes (dqc_tpu/ops/pallas/high_apply.py:76) at X = 128
// — group 2 and the dhigh sweeps — and on the merged top axis, X = 256 /
// 512: the in-place sweep and the density seeds; and the uncompute and the
// transport of the X = 256 / 512 adjoint, which its wrapper launches
// through the same entry after csrc/block_backward_high.cu's cross-Gram
// (the transport's E^T is a copy of the operator the wrapper makes).
//
// Bound: operations. X complex multiply-adds per amplitude against 16 bytes
// moved (24 with an accumulator); as 3xTF32 (the "f32" dot mode) three
// tf32 products per real product at 495 TFLOP/s, as bf16x3 three bf16 at
// 989, two where x's lo parts are zero (below): at X = 128 on f32 planes
// about a 3.33 ms floor at 29 qubits against 2.56 ms of HBM traffic.
//
// Design: a block of 512 threads (16 warps) takes C consecutive columns
// (all of one i, since C divides Q): C = 64 at X = 128 / 256, 32 at X = 512.
// 1. It reads their whole X-deep tile into shared memory before it writes
//    anything (so the output may be the input), decoding x from its
//    storage (f32, bf16 or f16: a kind known at run time, read here and
//    at the store only) and multiplying the run in when it comes first.
//    The tile is unpadded; its columns are XOR-swizzled by row so that the
//    B fragments' loads meet no bank twice.
// 2. E comes pre-split (the wrapper's _tc.tc_operator, once per call: 0.1%
//    of the work): hi and lo parts of its re and im, tf32 or bf16, laid
//    out in mma fragment order, so that a warp loads each part of an A
//    fragment as one 16-byte shared-memory read per lane and splits
//    nothing. The X output rows go in passes of RP = 128 (X = 128 / 256)
//    or 256 (X = 512) rows; two k-steps of a pass (one at X = 512: its RP
//    rows of E, 8 or 16 deep each) are one chunk of a three-stage cp.async
//    ring, two chunks in flight while the warps multiply the third, one
//    barrier a chunk. E is
//    read once per block, so at X = 256 the 64 columns halve its L2 reads
//    against 32.
// 3. Warps tile a pass 32 rows x 16 columns each (2 x 2 m16n8 tiles, their
//    re and im accumulators in registers, under 128 registers a thread):
//    a k-step splits its x fragments in registers (mma.cuh) and runs
//    3xTF32 (m16n8k8) or bf16x3 (m16n8k16), 12 mma per complex m16n8
//    tile, 8 where x's lo parts are zero (16-bit x: exact in tf32, and
//    bf16 x in bf16).
// 4. The pass's epilogue multiplies the run in when it follows, conjugates,
//    adds the accumulator planes, rounds to y's storage and stores two
//    neighbouring columns per register pair.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace dqc {

constexpr int kTcThreads = 512;

template <int X, int MODE>
struct TcCfg {
  static constexpr int C = X == 512 ? 32 : 64;   // columns per block
  static constexpr int WC = C / 16;              // warps along the columns
  static constexpr int WR = kTcThreads / 32 / WC;  // warps along the rows
  static constexpr int RP = WR * 32;             // rows per pass
  static constexpr int KS = MODE == kTf32x3 ? 8 : 16;  // k of one mma
  static constexpr int NKS = X / KS;             // k-steps a pass
  static constexpr int KPC = X == 512 ? 1 : 2;   // k-steps a chunk
  static constexpr int kStages = 3;
  static constexpr int kFragWords = 4 * 32 * 4;  // the 4 parts of an A fragment
  static constexpr int kStepWords = RP / 16 * kFragWords;  // one k-step
  static constexpr int kChunkWords = KPC * kStepWords;
  static constexpr int kTileFloats = X * C;      // the x tile, re or im
  static constexpr int kSmemBytes =
      (2 * kTileFloats + kStages * kChunkWords) * (int)sizeof(float);
  static_assert(X % RP == 0, "whole passes");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// The x tile's column of (k, c): c XOR'ed by row, so that a B fragment's
// eight columns at its four (tf32) or eight (bf16, two rows a register)
// rows fall in 32 different banks.
template <int MODE>
__device__ __forceinline__ int tc_swz(int k, int c) {
  return MODE == kTf32x3 ? c ^ ((k & 3) << 3) : c ^ (((k >> 1) & 3) << 3);
}

// Two neighbouring elements (i even) of a plane stored as kind, and their
// store.
__device__ __forceinline__ void load2(const void* p, int64_t i, int kind,
                                      float& v0, float& v1) {
  if (kind == kStoreF32) {
    const float2 f = *reinterpret_cast<const float2*>(
        static_cast<const float*>(p) + i);
    v0 = f.x;
    v1 = f.y;
    return;
  }
  const uint32_t u = *reinterpret_cast<const uint32_t*>(
      static_cast<const uint16_t*>(p) + i);
  v0 = kind == kStoreBF16 ? __uint_as_float(u << 16) : f16_bits_to_f32(u & 0xFFFFu);
  v1 = kind == kStoreBF16 ? __uint_as_float(u & 0xFFFF0000u) : f16_bits_to_f32(u >> 16);
}

__device__ __forceinline__ void store2(void* p, int64_t i, int kind, float v0,
                                       float v1) {
  if (kind == kStoreF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(v0, v1);
    return;
  }
  uint32_t h0, h1;
  if (kind == kStoreBF16) {
    h0 = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
    h1 = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
  } else {
    h0 = f32_to_f16_bits(v0);
    h1 = f32_to_f16_bits(v1);
  }
  *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(p) + i) = h0 | (h1 << 16);
}

// Chunk ci of the pre-split operator (pass p, k-steps s0 .. s0 + KPC: for
// each, the m-tiles of rows p RP .. p RP + RP, contiguous in its layout
// [s][m-tile][part][lane][4]) into a stage; one cp.async group.
template <int X, int MODE>
__device__ __forceinline__ void tc_issue_chunk(uint32_t* stage,
                                               const uint32_t* op, int ci) {
  using Cfg = TcCfg<X, MODE>;
  constexpr int per_pass = Cfg::NKS / Cfg::KPC;
  const int p = ci / per_pass, s0 = (ci % per_pass) * Cfg::KPC;
#pragma unroll
  for (int j = 0; j < Cfg::KPC; ++j) {
    const uint32_t* src = op + ((int64_t)(s0 + j) * (X / 16) + p * (Cfg::RP / 16)) *
                                   Cfg::kFragWords;
    uint32_t* dst = stage + j * Cfg::kStepWords;
    for (int e = threadIdx.x; e < Cfg::kStepWords / 4; e += kTcThreads)
      cp_async16(dst + 4 * e, src + 4 * e);
  }
  cp_async_commit();
}

// The A fragment of m-tile mt of a staged chunk: its four parts, one
// 16-byte read each.
__device__ __forceinline__ void tc_load_a(const uint32_t* stage, int mt,
                                          CFrag<4>& a) {
  const int lane = threadIdx.x & 31;
  const uint4* f = reinterpret_cast<const uint4*>(stage) + mt * 4 * 32 + lane;
  const uint4 rh = f[0], rl = f[32], ih = f[64], il = f[96];
  a.rh[0] = rh.x; a.rh[1] = rh.y; a.rh[2] = rh.z; a.rh[3] = rh.w;
  a.rl[0] = rl.x; a.rl[1] = rl.y; a.rl[2] = rl.z; a.rl[3] = rl.w;
  a.ih[0] = ih.x; a.ih[1] = ih.y; a.ih[2] = ih.z; a.ih[3] = ih.w;
  a.il[0] = il.x; a.il[1] = il.y; a.il[2] = il.z; a.il[3] = il.w;
}

// The B fragment of a k-step from the x tile (rows k0 .., columns n0 .. n0
// + 7 of the tile [k][c], swizzled), split.
template <int C, int MODE>
__device__ __forceinline__ void tc_load_x(const float* vr, const float* vi,
                                          int k0, int n0, CFrag<2>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (MODE == kTf32x3) {
      const int k = k0 + t + 4 * j;
      const int o = k * C + tc_swz<MODE>(k, n0 + g);
      split_tf32(vr[o], b.rh[j], b.rl[j]);
      split_tf32(vi[o], b.ih[j], b.il[j]);
    } else {
      const int k = k0 + 2 * t + 8 * j;  // rows k, k + 1: one swizzle
      const int o = k * C + tc_swz<MODE>(k, n0 + g);
      split_bf16x2(make_float2(vr[o], vr[o + C]), b.rh[j], b.rl[j]);
      split_bf16x2(make_float2(vi[o], vi[o + C]), b.ih[j], b.il[j]);
    }
  }
}

// y <- [acc +] conj?([D] E x [D]) on the view (A1, X, Q); x stored as
// xkind, y as ykind (common.cuh codec); y may be x (of one storage); op is
// E pre-split for MODE (_tc.tc_operator).
template <int X, int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_apply_kernel(const void* xr, const void* xi, void* yr, void* yi, int xkind,
                int ykind, const uint32_t* __restrict__ op, DiagTables d,
                int has_diag, int diag_first, int conj, int has_acc, int64_t Q,
                int64_t post) {
  using Cfg = TcCfg<X, MODE>;
  constexpr int C = Cfg::C, RP = Cfg::RP, KS = Cfg::KS, KPC = Cfg::KPC;
  constexpr int per_pass = Cfg::NKS / KPC, nchunks = (X / RP) * per_pass;
  extern __shared__ float4 tc_smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(tc_smem4);
  float* vr = smem;  // the x tile [k][c], swizzled
  float* vi = vr + Cfg::kTileFloats;
  uint32_t* ring = reinterpret_cast<uint32_t*>(vi + Cfg::kTileFloats);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / Cfg::WC, wc = warp % Cfg::WC;
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t q0 = g0 - i * Q;
  const int xsize = xkind == kStoreF32 ? 4 : 2, ysize = ykind == kStoreF32 ? 4 : 2;
  // element (x, c) at bx[x Q + c]
  const char* bxr = static_cast<const char*>(xr) + (i * X * Q + q0) * xsize;
  const char* bxi = static_cast<const char*>(xi) + (i * X * Q + q0) * xsize;
  char* byr = static_cast<char*>(yr) + (i * X * Q + q0) * ysize;
  char* byi = static_cast<char*>(yi) + (i * X * Q + q0) * ysize;
  const bool run_first = has_diag && diag_first, run_after = has_diag && !diag_first;

  // the first two chunks in flight while the tile lands
  tc_issue_chunk<X, MODE>(ring, op, 0);
  tc_issue_chunk<X, MODE>(ring + Cfg::kChunkWords, op, 1);

  // 1. the whole X-deep tile of this block's columns, times the run if
  //    first: batches of four 4-element groups a thread, their loads all
  //    in flight before the stores
  constexpr int kPer = X * C / 4 / kTcThreads, kBatch = 4;
  static_assert(kPer % kBatch == 0, "whole batches");
#pragma unroll 1
  for (int b0 = 0; b0 < kPer; b0 += kBatch) {
    float ar[kBatch][4], ai[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = tid + (b0 + j) * kTcThreads;
      const int x = e / (C / 4), c = 4 * (e % (C / 4));
      load4(bxr + (int64_t)x * Q * xsize, c / 4, xkind, ar[j]);
      load4(bxi + (int64_t)x * Q * xsize, c / 4, xkind, ai[j]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = tid + (b0 + j) * kTcThreads;
      const int x = e / (C / 4), c = 4 * (e % (C / 4));
      if (run_first) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float dr, di;
          view_diag(d, i, X, x, q0 + c + q, post, dr, di);
          cmul(ar[j][q], ai[j][q], dr, di, ar[j][q], ai[j][q]);
        }
      }
      const int o = x * C + tc_swz<MODE>(x, c);
      *reinterpret_cast<float4*>(vr + o) =
          make_float4(ar[j][0], ar[j][1], ar[j][2], ar[j][3]);
      *reinterpret_cast<float4*>(vi + o) =
          make_float4(ai[j][0], ai[j][1], ai[j][2], ai[j][3]);
    }
  }
  // x's lo parts are zero: 16-bit planes in 3xTF32, bf16 planes in bf16x3
  const bool x_exact = !run_first && (MODE == kTf32x3 ? xkind != kStoreF32
                                                      : xkind == kStoreBF16);

  int ci = 0;
  for (int r0 = 0; r0 < X; r0 += RP) {
    float accr[2][2][4], acci[2][2][4];  // [n][m][fragment entry]
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accr[n][m][e] = acci[n][m][e] = 0.f;
    // 2. rows r0 .. r0 + RP of E x, chunk by chunk
#pragma unroll 1
    for (int sc = 0; sc < per_pass; ++sc, ++ci) {
      cp_async_wait<1>();  // chunk ci landed (ci + 1 may still fly)
      __syncthreads();     // ... for every warp, and chunk ci - 1 consumed
      if (ci + 2 < nchunks)
        tc_issue_chunk<X, MODE>(ring + ((ci + 2) % Cfg::kStages) * Cfg::kChunkWords,
                                op, ci + 2);
      else
        cp_async_commit();  // an empty group keeps the count
#pragma unroll
      for (int j = 0; j < KPC; ++j) {
        const uint32_t* stage =
            ring + (ci % Cfg::kStages) * Cfg::kChunkWords + j * Cfg::kStepWords;
        CFrag<4> a[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) tc_load_a(stage, 2 * wr + m, a[m]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          CFrag<2> b;
          tc_load_x<C, MODE>(vr, vi, (sc * KPC + j) * KS, wc * 16 + 8 * n, b);
          cmma3<MODE, 2>(accr[n], acci[n], a, b, false, x_exact);
        }
      }
    }
    // 3. the run when it follows, the seed modes, the store (per row pair
    //    h of the fragments: the accumulator's values loaded first, all in
    //    flight at once)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wr2[2][2][2], wi2[2][2][2];  // [n][m][column j]
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wr2[n][m][j] = accr[n][m][2 * h + j];
            wi2[n][m][j] = acci[n][m][2 * h + j];
          }
      if (has_acc) {
        float pr[2][2][2], pi[2][2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int x = r0 + wr * 32 + 16 * m + g + 8 * h;
            const int64_t o = (int64_t)x * Q + wc * 16 + 8 * n + 2 * t;
            load2(byr, o, ykind, pr[n][m][0], pr[n][m][1]);
            load2(byi, o, ykind, pi[n][m][0], pi[n][m][1]);
          }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float vr2 = wr2[n][m][j], vi2 = wi2[n][m][j];
              if (run_after) {
                float dr, di;
                view_diag(d, i, X, r0 + wr * 32 + 16 * m + g + 8 * h,
                          q0 + wc * 16 + 8 * n + 2 * t + j, post, dr, di);
                cmul(vr2, vi2, dr, di, vr2, vi2);
              }
              wr2[n][m][j] = vr2 + pr[n][m][j];
              wi2[n][m][j] = (conj ? -vi2 : vi2) + pi[n][m][j];
            }
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float vr2 = wr2[n][m][j], vi2 = wi2[n][m][j];
              if (run_after) {
                float dr, di;
                view_diag(d, i, X, r0 + wr * 32 + 16 * m + g + 8 * h,
                          q0 + wc * 16 + 8 * n + 2 * t + j, post, dr, di);
                cmul(vr2, vi2, dr, di, vr2, vi2);
              }
              wr2[n][m][j] = vr2;
              wi2[n][m][j] = conj ? -vi2 : vi2;
            }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int x = r0 + wr * 32 + 16 * m + g + 8 * h;
          const int64_t o = (int64_t)x * Q + wc * 16 + 8 * n + 2 * t;
          store2(byr, o, ykind, wr2[n][m][0], wr2[n][m][1]);
          store2(byi, o, ykind, wi2[n][m][0], wi2[n][m][1]);
        }
    }
  }
}

// Launches tc_apply_kernel<X, MODE> over A1 Q / C blocks; returns a CUDA
// error code (cudaErrorInvalidValue for a Q that does not tile, or a run
// away from X = 128).
template <int X, int MODE>
inline int launch_tc_apply(const void* xr, const void* xi, void* yr, void* yi,
                           int xkind, int ykind, const uint32_t* op,
                           const DiagTables& d, int has_diag,
                           int diag_first, int conj, int has_acc, long long A1,
                           long long Q, cudaStream_t stream) {
  using Cfg = TcCfg<X, MODE>;
  if (Q % Cfg::C != 0 || (has_diag && (X != 128 || Q % (128 * 128) != 0)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / Cfg::C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = tc_apply_kernel<X, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kTcThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, yr, yi, xkind, ykind, op, d, has_diag, diag_first, conj,
      has_acc, (int64_t)Q, (int64_t)(Q >> 14));
  return (int)cudaGetLastError();
}

// The product mode at run time (x3: bf16x3, else 3xTF32); op pre-split
// for that mode.
template <int X>
inline int launch_tc(const void* xr, const void* xi, void* yr, void* yi,
                     int xkind, int ykind, int x3, const uint32_t* op,
                     const DiagTables& d, int has_diag, int diag_first,
                     int conj, int has_acc, long long A1, long long Q,
                     cudaStream_t stream) {
  auto fn = x3 ? launch_tc_apply<X, kBf16x3> : launch_tc_apply<X, kTf32x3>;
  return fn(xr, xi, yr, yi, xkind, ykind, op, d, has_diag, diag_first, conj,
            has_acc, A1, Q, stream);
}

}  // namespace dqc
