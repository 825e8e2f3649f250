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

#pragma once

#include "common.cuh"

namespace dqc {

constexpr int kWideThreads = 256;

template <int X>
struct WideCfg {
  static constexpr int C = 32;                       // columns per block
  static constexpr int kRows = 8;                    // rows per thread
  static constexpr int kCols = 4;                    // columns per thread
  static constexpr int TC = C / kCols;               // column threads
  static constexpr int RG = kWideThreads / TC;       // row groups
  static constexpr int RP = RG * kRows;              // rows per pass
  static constexpr int KC = 16;                      // E tile depth
  static constexpr int LDE = KC + 1;                 // padded E tile row
  static constexpr int kSmemBytes = (2 * X * C + 2 * RP * LDE) * (int)sizeof(float);
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

// y <- [acc +] conj?(op(E) x), op(E) = E or E^T (trans); y may be x.
template <int X>
__global__ void __launch_bounds__(kWideThreads)
wide_apply_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  const float* __restrict__ er, const float* __restrict__ ei,
                  int trans, int conj, int has_acc, int64_t Q) {
  using Cfg = WideCfg<X>;
  constexpr int C = Cfg::C, KC = Cfg::KC, LDE = Cfg::LDE, TC = Cfg::TC;
  constexpr int RP = Cfg::RP;
  extern __shared__ float smem[];
  float* vr = smem;            // input tile [x][c]
  float* vi = vr + X * C;
  float* tr = vi + X * C;      // operator tile [row][kk]
  float* ti = tr + RP * LDE;

  const int tid = threadIdx.x;
  const int rg = tid / TC;     // rows rg * 8 + r of the pass
  const int tc = tid % TC;     // columns tc + TC * j
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t q0 = g0 - i * Q;
  const float* bxr = xr + i * X * Q + q0;   // element (x, c) at bxr[x Q + c]
  const float* bxi = xi + i * X * Q + q0;
  float* byr = yr + i * X * Q + q0;
  float* byi = yi + i * X * Q + q0;

  // 1. the whole X-deep tile of this block's columns
  for (int e = tid; e < X * C; e += kWideThreads) {
    const int x = e / C, c = e % C;
    vr[e] = bxr[(int64_t)x * Q + c];
    vi[e] = bxi[(int64_t)x * Q + c];
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
      if (trans) {
        // op(E)[row, k] = E[k, row]: neighbouring threads, neighbouring rows
        for (int e = tid; e < RP * KC; e += kWideThreads) {
          const int kk = e / RP, row = e % RP;
          const int64_t o = (int64_t)(k0 + kk) * X + r0 + row;
          tr[row * LDE + kk] = __ldg(er + o);
          ti[row * LDE + kk] = __ldg(ei + o);
        }
      } else {
        for (int e = tid; e < RP * KC; e += kWideThreads) {
          const int row = e / KC, kk = e % KC;
          const int64_t o = (int64_t)(r0 + row) * X + k0 + kk;
          tr[row * LDE + kk] = __ldg(er + o);
          ti[row * LDE + kk] = __ldg(ei + o);
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
    // 3. the seed modes and the store (the input is all in shared memory)
#pragma unroll
    for (int r = 0; r < Cfg::kRows; ++r)
#pragma unroll
      for (int j = 0; j < Cfg::kCols; ++j) {
        const int64_t o = (int64_t)(r0 + rg * Cfg::kRows + r) * Q + tc + TC * j;
        float wr = accr[r][j], wi = acci[r][j];
        if (conj) wi = -wi;
        if (has_acc) {
          wr += byr[o];
          wi += byi[o];
        }
        byr[o] = wr;
        byi[o] = wi;
      }
  }
}

// Launches wide_apply_kernel<X> over A1 Q / 32 blocks; returns a CUDA error
// code (cudaErrorInvalidValue for a Q that does not tile).
template <int X>
inline int launch_wide_apply(const float* xr, const float* xi, float* yr,
                             float* yi, const float* er, const float* ei,
                             int trans, int conj, int has_acc, long long A1,
                             long long Q, cudaStream_t stream) {
  using Cfg = WideCfg<X>;
  if (Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / Cfg::C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wide_apply_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  wide_apply_kernel<X><<<(unsigned)blocks, kWideThreads, Cfg::kSmemBytes,
                         stream>>>(xr, xi, yr, yi, er, ei, trans, conj, has_acc,
                                   (int64_t)Q);
  return (int)cudaGetLastError();
}

}  // namespace dqc
