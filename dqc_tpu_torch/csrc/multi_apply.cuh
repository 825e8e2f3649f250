// The sum-of-terms apply on f32 planes, shared by dual_multi_apply.cu and
// high_multi_apply.cu:
//
//   y = sum_t (E_t on the group axis) (El_t on the lane axis) x,   in place,
//
// on the view (A1, X, M, 128) of the planes, E_t an X x X operator on axis
// X and El_t a 128 x 128 operator on the last (lane) axis, t < T. For a
// fixed (i, m) the X x 128 matrix Z[x, l] = x[i, x, m, l] becomes
// sum_t E_t Z El_t^T. The dual form (planes (A, 128, 128), Em_t on the
// sublane axis) is the view (A, 128, 1, 128) with X = 128.
//
// Bound: operations. Per amplitude and term, 128 complex multiply-adds for
// the lane factor and X for the group factor (8 real flops each), against
// 16 bytes read and written.
//
// Design: every output amplitude depends on a whole X x 128 matrix Z, for
// every term, and the result overwrites its input. A block of 512 threads
// takes 128 rows (128 / X consecutive m, X rows each) of 128 lanes, reads
// them all into shared memory (128 KB) before it writes anything, and then
// walks the output in two column blocks of 64 lanes. For each column block
// and each term it forms T = Z El_t^T[:, cols] (the lane product, K = 128)
// into a shared 128 x 64 buffer (64 KB), then adds E_t T within each X-row
// group into registers (the group product, K = X); after the last term the
// block stores the column block. A second full 128 x 128 temporary per
// term would not fit beside the rows (227 KB). Each thread owns 8 rows x 2
// columns of both products; 16-deep tiles of the operators stream through
// a shared buffer, read transposed (the wrapper passes El_t^T and E_t^T) so
// that the tile loads are coalesced. The rows' entries along the contracted
// axis are read as float4 broadcasts, the tile's and T's entries one column
// per lane, without bank conflicts.
#pragma once

#include "common.cuh"

namespace dqc {

constexpr int kMultiThreads = 512;       // 16 warps, 8 rows each
constexpr int kMultiRows = 128;          // rows of a tile
constexpr int kMultiCB = 64;             // lanes of a column block
constexpr int kMultiKC = 16;             // lane-product operator tile depth
constexpr int kMultiOpFloats = 16 * 128;  // one operator tile (re or im)
constexpr int kMultiSmemFloats =
    2 * kMultiRows * kGroup + 2 * kMultiRows * kMultiCB + 2 * kMultiOpFloats;
constexpr int kMultiSmemBytes = kMultiSmemFloats * (int)sizeof(float);
static_assert(kMultiSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ void mcmac(float& accr, float& acci, float ar,
                                      float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// xr, xi: the view (A1, X, M, 128), updated in place. elt: El_t^T stacked
// (T, 128, 128), elt[t][k][l] = El_t[l][k]; et: E_t^T stacked (T, X, X),
// et[t][k][x] = E_t[x][k]. A tile is 128 / X consecutive m of one i.
template <int X>
__global__ void __launch_bounds__(kMultiThreads, 1)
multi_apply_kernel(float* xr, float* xi, const float* __restrict__ elt_r,
                   const float* __restrict__ elt_i,
                   const float* __restrict__ et_r,
                   const float* __restrict__ et_i, int T, int64_t M) {
  static_assert(X % 8 == 0 && X <= kMultiRows, "8 | X <= 128");
  constexpr int GP = kMultiRows / X;         // m per tile
  constexpr int KB = X < 16 ? X : 16;        // group-product tile depth
  extern __shared__ float smem[];
  float* sXr = smem;                          // rows [r][k], r = mm X + x
  float* sXi = sXr + kMultiRows * kGroup;
  float* sTr = sXi + kMultiRows * kGroup;     // lane product [r][c]
  float* sTi = sTr + kMultiRows * kMultiCB;
  float* sOr = sTi + kMultiRows * kMultiCB;   // operator tile
  float* sOi = sOr + kMultiOpFloats;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t Q = M * kGroup;
  const int64_t tiles_per_i = M / GP;
  const int64_t i = blockIdx.x / tiles_per_i;
  const int64_t m0 = (blockIdx.x - i * tiles_per_i) * GP;
  const int64_t base = i * X * Q + m0 * kGroup;
  // row r of the tile sits at base + row_off(r) in the planes
  auto row_off = [&](int r) -> int64_t {
    return (int64_t)(r % X) * Q + (int64_t)(r / X) * kGroup;
  };

  // 1. every row of the tile into shared memory, before any store
  for (int e4 = tid; e4 < kMultiRows * kGroup / 4; e4 += kMultiThreads) {
    const int r = e4 / (kGroup / 4), c4 = e4 % (kGroup / 4);
    const int64_t o = base + row_off(r) + 4 * c4;
    reinterpret_cast<float4*>(sXr)[e4] = *reinterpret_cast<const float4*>(xr + o);
    reinterpret_cast<float4*>(sXi)[e4] = *reinterpret_cast<const float4*>(xi + o);
  }

  const int r0 = warp * 8;            // this thread's rows r0 .. r0 + 7
  const int g0 = (r0 / X) * X;        // first row of their X-row group
  const int x0 = r0 - g0;             // their x
  for (int cb = 0; cb < kGroup / kMultiCB; ++cb) {
    float yr[8][2], yi[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j) yr[a][j] = yi[a][j] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* lr = elt_r + (int64_t)t * kGroup * kGroup;
      const float* li = elt_i + (int64_t)t * kGroup * kGroup;
      // 2. the lane product T[r, c] = sum_k Z[r, k] El_t[cb 64 + c, k]
      float ar_[8][2], ai_[8][2];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) ar_[a][j] = ai_[a][j] = 0.f;
      for (int k0 = 0; k0 < kGroup; k0 += kMultiKC) {
        __syncthreads();  // rows loaded / the previous tile consumed
        for (int e = tid; e < kMultiKC * kMultiCB; e += kMultiThreads) {
          const int kk = e / kMultiCB, c = e % kMultiCB;
          const int64_t src = (int64_t)(k0 + kk) * kGroup + cb * kMultiCB + c;
          sOr[e] = __ldg(lr + src);
          sOi[e] = __ldg(li + src);
        }
        __syncthreads();
#pragma unroll
        for (int q4 = 0; q4 < kMultiKC; q4 += 4) {
          float br[4][2], bi[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              br[q][j] = sOr[(q4 + q) * kMultiCB + lane + 32 * j];
              bi[q][j] = sOi[(q4 + q) * kMultiCB + lane + 32 * j];
            }
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const float4 zr = *reinterpret_cast<const float4*>(
                sXr + (r0 + a) * kGroup + k0 + q4);
            const float4 zi = *reinterpret_cast<const float4*>(
                sXi + (r0 + a) * kGroup + k0 + q4);
            const float vr[4] = {zr.x, zr.y, zr.z, zr.w};
            const float vi[4] = {zi.x, zi.y, zi.z, zi.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mcmac(ar_[a][j], ai_[a][j], vr[q], vi[q], br[q][j], bi[q][j]);
          }
        }
      }
      __syncthreads();  // the previous term's group product has read T
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sTr[(r0 + a) * kMultiCB + lane + 32 * j] = ar_[a][j];
          sTi[(r0 + a) * kMultiCB + lane + 32 * j] = ai_[a][j];
        }

      // 3. the group product y[r, c] += sum_k E_t[x, k] T[g k, c], within
      //    the X-row group of r = g + x
      const float* gr_ = et_r + (int64_t)t * X * X;
      const float* gi_ = et_i + (int64_t)t * X * X;
      for (int k0 = 0; k0 < X; k0 += KB) {
        __syncthreads();  // T complete / the previous tile consumed
        for (int e = tid; e < KB * X; e += kMultiThreads) {
          sOr[e] = __ldg(gr_ + (int64_t)k0 * X + e);  // [kk][x]
          sOi[e] = __ldg(gi_ + (int64_t)k0 * X + e);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          float br[2], bi[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            br[j] = sTr[(g0 + k0 + kk) * kMultiCB + lane + 32 * j];
            bi[j] = sTi[(g0 + k0 + kk) * kMultiCB + lane + 32 * j];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 er4 =
                *reinterpret_cast<const float4*>(sOr + kk * X + x0 + 4 * h);
            const float4 ei4 =
                *reinterpret_cast<const float4*>(sOi + kk * X + x0 + 4 * h);
            const float er[4] = {er4.x, er4.y, er4.z, er4.w};
            const float ei[4] = {ei4.x, ei4.y, ei4.z, ei4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mcmac(yr[4 * h + a][j], yi[4 * h + a][j], er[a], ei[a], br[j],
                      bi[j]);
          }
        }
      }
    }
    // 4. the column block's sum over the terms, in place (one row per warp
    //    and store: 32 consecutive lanes)
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int64_t o = base + row_off(r0 + a) + cb * kMultiCB + lane;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        xr[o + 32 * j] = yr[a][j];
        xi[o + 32 * j] = yi[a][j];
      }
    }
  }
}

// In place on the view (A1, X, M, 128): x <- sum_t E_t x El_t^T. Needs
// M % (128 / X) == 0. Returns cudaGetLastError().
template <int X>
int launch_multi_apply(float* xr, float* xi, const float* elt_r,
                       const float* elt_i, const float* et_r,
                       const float* et_i, int T, long long A1, long long M,
                       cudaStream_t stream) {
  constexpr int GP = kMultiRows / X;
  if (T <= 0 || A1 <= 0 || M <= 0 || M % GP != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (M / GP);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      multi_apply_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMultiSmemBytes);
  if (err != cudaSuccess) return (int)err;
  multi_apply_kernel<X><<<(unsigned)blocks, kMultiThreads, kMultiSmemBytes,
                          stream>>>(xr, xi, elt_r, elt_i, et_r, et_i, T,
                                    (int64_t)M);
  return (int)cudaGetLastError();
}

}  // namespace dqc
