// The dense apply on the merged top axis of a tiny top group: y = E . x (or
// E^T . x) along X = 256 or 512 of the view (A1, X, Q = M 128), in every mode
// of the high apply: in place (y = x), into fresh planes, or added into
// accumulator planes, optionally conjugated.
//
// Shared by csrc/high_apply.cu (the merged-top sweep of
// high_group_apply_planes, dqc_tpu/ops/pallas/high_apply.py:76, both the
// in-place sweep and the density seed) and csrc/block_backward_high.cu (the
// uncompute and the transport of its X = 256 / 512 adjoint).
//
// Bound: operations. X complex multiply-adds per amplitude (8 real flops
// each) against 16 bytes moved (24 with an accumulator): 128 flop per byte
// at X = 256, far above the H100's FP32 ridge (~20 flop/B). f32 FMA on the
// CUDA cores, no TF32.
//
// Design: a block of 256 threads takes C = 32 consecutive columns (all of
// one i, since C divides Q) and reads their whole X-deep tile (X x 32 x 2
// floats: 64 KB at X = 256, 128 KB at X = 512) into shared memory before it
// writes anything, so the output may be the input. The X output rows go in
// passes of 256: each thread keeps 8 rows x 4 columns of the product in
// registers while 16-deep tiles of E (256 rows of it, or of E^T) stream
// through shared memory from L2, and stores them when the pass ends.
//
// Reduced cotangent storage and bf16x3 (the transport of the X = 256 / 512
// adjoint, csrc/block_backward_high.cu; the TPU kernel's f32_of / store_as
// and bwd_dot_mode): x may be stored as bf16 or f16 bits and y too
// (common.cuh's codec; XKIND and YKIND are template parameters, so that the
// f32 sweep keeps its plain loads and stores), and the product may run
// bf16x3 (TX3) on the CUDA cores: the E tile is staged as its hi and lo
// bf16 parts (twice the tile buffer), each x value split into hi and
// hi + lo as it is read, two FMAs per real product (common.cuh cmac3).

#pragma once

#include "common.cuh"

namespace dqc {

constexpr int kWideThreads = 256;

template <int X, bool TX3 = false>
struct WideCfg {
  static constexpr int C = 32;                       // columns per block
  static constexpr int kRows = 8;                    // rows per thread
  static constexpr int kCols = 4;                    // columns per thread
  static constexpr int TC = C / kCols;               // column threads
  static constexpr int RG = kWideThreads / TC;       // row groups
  static constexpr int RP = RG * kRows;              // rows per pass
  static constexpr int KC = 16;                      // E tile depth
  static constexpr int LDE = KC + 1;                 // padded E tile row
  static constexpr int kOpBufs = TX3 ? 4 : 2;        // E tile: re, im (hi, lo)
  static constexpr int kSmemBytes =
      (2 * X * C + kOpBufs * RP * LDE) * (int)sizeof(float);
  static_assert(X % RP == 0, "whole passes");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void wide_cmac(float& accr, float& acci, float ar,
                                          float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// y <- [acc +] conj?(op(E) x), op(E) = E or E^T (trans); y may be x (of one
// storage); x stored as XKIND, y as YKIND (common.cuh codec); TX3: the
// product in bf16x3.
template <int X, int XKIND, int YKIND, bool TX3>
__global__ void __launch_bounds__(kWideThreads)
wide_apply_kernel(const void* xr, const void* xi, void* yr, void* yi,
                  const float* __restrict__ er,
                  const float* __restrict__ ei, int trans, int conj,
                  int has_acc, int64_t Q) {
  using Cfg = WideCfg<X, TX3>;
  constexpr int C = Cfg::C, KC = Cfg::KC, LDE = Cfg::LDE, TC = Cfg::TC;
  constexpr int RP = Cfg::RP;
  extern __shared__ float smem[];
  float* vr = smem;            // input tile [x][c]
  float* vi = vr + X * C;
  float* tr = vi + X * C;      // operator tile [row][kk] (TX3: its hi part)
  float* ti = tr + RP * LDE;
  float* tlr = ti + RP * LDE;  // TX3: the operator tile's lo part
  float* tli = tlr + RP * LDE;

  const int tid = threadIdx.x;
  const int rg = tid / TC;     // rows rg * 8 + r of the pass
  const int tc = tid % TC;     // columns tc + TC * j
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t q0 = g0 - i * Q;
  constexpr int xsize = XKIND == kStoreF32 ? 4 : 2;  // bytes per x element
  constexpr int ysize = YKIND == kStoreF32 ? 4 : 2;  // bytes per y element
  // element (x, c) at bx[x Q + c]
  const char* bxr = static_cast<const char*>(xr) + (i * X * Q + q0) * xsize;
  const char* bxi = static_cast<const char*>(xi) + (i * X * Q + q0) * xsize;
  char* byr = static_cast<char*>(yr) + (i * X * Q + q0) * ysize;
  char* byi = static_cast<char*>(yi) + (i * X * Q + q0) * ysize;

  // 1. the whole X-deep tile of this block's columns
  for (int e = tid; e < X * C; e += kWideThreads) {
    const int x = e / C, c = e % C;
    vr[e] = load_plane(bxr, (int64_t)x * Q + c, XKIND);
    vi[e] = load_plane(bxi, (int64_t)x * Q + c, XKIND);
  }

  for (int r0 = 0; r0 < X; r0 += RP) {
    float accr[Cfg::kRows][Cfg::kCols];
    float acci[Cfg::kRows][Cfg::kCols];
#pragma unroll
    for (int r = 0; r < Cfg::kRows; ++r)
#pragma unroll
      for (int j = 0; j < Cfg::kCols; ++j) accr[r][j] = acci[r][j] = 0.f;
    // 2. rows r0 .. r0 + RP of op(E) x
    for (int k0 = 0; k0 < X; k0 += KC) {
      __syncthreads();  // the tile is loaded / the previous E tile consumed
      // (two loops of a fixed trip count, so that each unrolls and its
      // loads are all in flight at once: at X = 512 one block fills an SM)
      if (trans) {
        // op(E)[row, k] = E[k, row]: neighbouring threads, neighbouring rows
        for (int e = tid; e < RP * KC; e += kWideThreads) {
          const int kk = e / RP, row = e % RP;
          const int64_t o = (int64_t)(k0 + kk) * X + r0 + row;
          stage_op<TX3>(__ldg(er + o), __ldg(ei + o), row * LDE + kk, tr, ti,
                        tlr, tli);
        }
      } else {
        for (int e = tid; e < RP * KC; e += kWideThreads) {
          const int row = e / KC, kk = e % KC;
          const int64_t o = (int64_t)(r0 + row) * X + k0 + kk;
          stage_op<TX3>(__ldg(er + o), __ldg(ei + o), row * LDE + kk, tr, ti,
                        tlr, tli);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float br[Cfg::kCols], bi[Cfg::kCols];
#pragma unroll
        for (int j = 0; j < Cfg::kCols; ++j) {
          br[j] = vr[(k0 + kk) * C + tc + TC * j];
          bi[j] = vi[(k0 + kk) * C + tc + TC * j];
        }
        if constexpr (TX3) {
          float brh[Cfg::kCols], brs[Cfg::kCols], bih[Cfg::kCols],
              bis[Cfg::kCols];
#pragma unroll
          for (int j = 0; j < Cfg::kCols; ++j) {
            split_hs(br[j], brh[j], brs[j]);
            split_hs(bi[j], bih[j], bis[j]);
          }
#pragma unroll
          for (int r = 0; r < Cfg::kRows; ++r) {
            const int o = (rg * Cfg::kRows + r) * LDE + kk;
            const float arh = tr[o], aih = ti[o], arl = tlr[o], ail = tli[o];
#pragma unroll
            for (int j = 0; j < Cfg::kCols; ++j)
              cmac3(accr[r][j], acci[r][j], arh, arl, aih, ail, brh[j],
                    brs[j], bih[j], bis[j]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < Cfg::kRows; ++r) {
            const float ar = tr[(rg * Cfg::kRows + r) * LDE + kk];
            const float ai = ti[(rg * Cfg::kRows + r) * LDE + kk];
#pragma unroll
            for (int j = 0; j < Cfg::kCols; ++j)
              wide_cmac(accr[r][j], acci[r][j], ar, ai, br[j], bi[j]);
          }
        }
      }
    }
    // 3. the seed modes and the store (the input is all in shared memory)
#pragma unroll
    for (int r = 0; r < Cfg::kRows; ++r)
#pragma unroll
      for (int j = 0; j < Cfg::kCols; ++j) {
        const int64_t o = (int64_t)(r0 + rg * Cfg::kRows + r) * Q + tc + TC * j;
        float wr = accr[r][j], wi = acci[r][j];
        if (conj) wi = -wi;
        if (has_acc) {
          wr += load_plane(byr, o, YKIND);
          wi += load_plane(byi, o, YKIND);
        }
        store_plane(byr, o, wr, YKIND);
        store_plane(byi, o, wi, YKIND);
      }
  }
}

template <int X, int XKIND, int YKIND, bool TX3>
inline int launch_wide_kind(const void* xr, const void* xi, void* yr, void* yi,
                            const float* er, const float* ei, int trans,
                            int conj, int has_acc, long long A1, long long Q,
                            cudaStream_t stream) {
  using Cfg = WideCfg<X, TX3>;
  if (Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / Cfg::C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = wide_apply_kernel<X, XKIND, YKIND, TX3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kWideThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, yr, yi, er, ei, trans, conj, has_acc, (int64_t)Q);
  return (int)cudaGetLastError();
}

// Launches wide_apply_kernel<X> over A1 Q / 32 blocks with x stored as f32
// and y as ykind (the high apply's sweep and seeds); returns a CUDA error
// code (cudaErrorInvalidValue for a Q that does not tile).
template <int X>
inline int launch_wide_apply(const float* xr, const float* xi, void* yr,
                             void* yi, int ykind, const float* er,
                             const float* ei, int trans, int conj, int has_acc,
                             long long A1, long long Q, cudaStream_t stream) {
  constexpr int F = kStoreF32;
  auto fn = ykind == kStoreF32    ? launch_wide_kind<X, F, kStoreF32, false>
            : ykind == kStoreBF16 ? launch_wide_kind<X, F, kStoreBF16, false>
                                  : launch_wide_kind<X, F, kStoreF16, false>;
  return fn(xr, xi, yr, yi, er, ei, trans, conj, has_acc, A1, Q, stream);
}

// The seeds of the high apply (y other planes than x, no transpose) with
// bf16 x (into bf16 y), f16 x (into f16 y: the per-term fallback under
// "f16") or bf16x3 products ("bf16" storage and the forward bf16x3): x
// stored as xkind (0 f32, 1 bf16, 2 f16), y as ykind, x3 the product's
// mode.
template <int X>
inline int launch_wide_seed(const void* xr, const void* xi, void* yr,
                            void* yi, int xkind, int ykind, int x3,
                            const float* er, const float* ei, int conj,
                            int has_acc, long long A1, long long Q,
                            cudaStream_t stream) {
  constexpr int F = kStoreF32, B = kStoreBF16, H = kStoreF16;
#define DQC_WIDE_SEED(XK, YK, T)                                           \
  if (xkind == XK && ykind == YK && (x3 != 0) == T)                        \
    return launch_wide_kind<X, XK, YK, T>(xr, xi, yr, yi, er, ei, 0, conj, \
                                          has_acc, A1, Q, stream);
  DQC_WIDE_SEED(F, F, true)
  DQC_WIDE_SEED(F, B, true)
  DQC_WIDE_SEED(F, H, true)
  DQC_WIDE_SEED(B, B, false)
  DQC_WIDE_SEED(B, B, true)
  DQC_WIDE_SEED(H, H, false)
  DQC_WIDE_SEED(H, H, true)
#undef DQC_WIDE_SEED
  return (int)cudaErrorInvalidValue;
}

// The in-place apply (no transpose) with bf16 or f16 planes or bf16x3
// products ("bf16" storage and the forward bf16x3; f16 input): planes
// stored as kind (0 f32, 1 bf16, 2 f16), the product bf16x3 with x3 (f32
// planes take x3 only). The high apply's in-place sweep on the merged top
// axis and the X = 256 / 512 adjoint's uncompute.
template <int X>
inline int launch_wide_inplace_fwd16(void* xr, void* xi, int kind, int x3,
                                     const float* er, const float* ei,
                                     long long A1, long long Q,
                                     cudaStream_t stream) {
#define DQC_WIDE_FWD16(K, T)                                              \
  if (kind == K && (x3 != 0) == T)                                        \
    return launch_wide_kind<X, K, K, T>(xr, xi, xr, xi, er, ei, 0, 0, 0, \
                                        A1, Q, stream);
  DQC_WIDE_FWD16(kStoreF32, true)
  DQC_WIDE_FWD16(kStoreBF16, false)
  DQC_WIDE_FWD16(kStoreBF16, true)
  DQC_WIDE_FWD16(kStoreF16, false)
  DQC_WIDE_FWD16(kStoreF16, true)
#undef DQC_WIDE_FWD16
  return (int)cudaErrorInvalidValue;
}

// The in-place apply on planes stored as kind (0 f32, 1 bf16, 2 f16), the
// product bf16x3 with x3: the X = 256 / 512 adjoint's transport on B.
template <int X>
inline int launch_wide_inplace(void* xr, void* xi, int kind, int x3,
                               const float* er, const float* ei, int trans,
                               long long A1, long long Q,
                               cudaStream_t stream) {
#define DQC_WIDE_KIND(K, T)                                              \
  if (kind == K && (x3 != 0) == T)                                       \
    return launch_wide_kind<X, K, K, T>(xr, xi, xr, xi, er, ei, trans, 0, \
                                        0, A1, Q, stream);
  DQC_WIDE_KIND(kStoreF32, false)
  DQC_WIDE_KIND(kStoreF32, true)
  DQC_WIDE_KIND(kStoreBF16, false)
  DQC_WIDE_KIND(kStoreBF16, true)
  DQC_WIDE_KIND(kStoreF16, false)
  DQC_WIDE_KIND(kStoreF16, true)
#undef DQC_WIDE_KIND
  return (int)cudaErrorInvalidValue;
}

}  // namespace dqc
