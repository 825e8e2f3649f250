// The sum-of-terms apply on the planes of high_multi_apply.cu (and of
// high_multi_apply_x3.cu, its bf16x3 products), on the CUDA cores:
//
//   y = sum_t (E_t on the group axis) (El_t on the lane axis) x,   in place,
//
// or in the density-seed modes of the gradient: conj writes conj(y), acc
// adds it into accumulator planes (y <- acc + conj(...), in place on acc),
// and the output may be fresh planes with x left as it was (alias=False).
// The seed of a density across two groups is such a sum: its 4 x 4
// operator's decomposition over the two groups (plane_scan._seed_apply).
//
// on the view (A1, X, M, 128) of the planes, E_t an X x X operator on axis
// X and El_t a 128 x 128 operator on the last (lane) axis, t < T. For a
// fixed (i, m) the X x 128 matrix Z[x, l] = x[i, x, m, l] becomes
// sum_t E_t Z El_t^T. (The dual form, planes (A, 128, 128) with Em_t on
// the sublane axis, runs on the tensor cores: dual_multi_apply.cu.)
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
//
// Reduced cotangent storage (config.set_state_storage "mixed" / "f16"; the
// TPU kernels' f32_of / store_as at dual_apply.py:128-129, 155-159): x and
// y may be stored as bf16 or f16 bits (common.cuh's codec), each a template
// parameter (XKIND, YKIND), so that the f32 instantiation keeps its plain
// float4 loads and stores. x is decoded as the tile is read, an accumulator
// decoded where it is added, and y encoded as it is stored; every product
// runs in f32 (the TPU kernels' kernel_dot_mode). In place on a reduced
// cotangent (the transport of a cross-group gate), x and y are the same
// planes of one storage; a seed reads f32 forward planes into reduced y.
//
// "bf16" storage and the forward bf16x3 (the TPU kernels' f32_of on x and
// their dot_mode): x may be stored as bf16 in a seed too (the forward
// planes under "bf16", into bf16 cotangent planes: the XKIND = YKIND = bf16
// instantiation of the in-place form), and both products may run bf16x3
// (X3, a template parameter): each operator tile is staged as its hi and
// lo bf16 parts (the lo parts in the unused half of the operator buffer:
// the group product's tile is then 1024 / X rows deep at most, 8 at
// X = 128), and each value of x and of the lane product T split into hi
// and hi + lo as it is read, two FMAs per real product (common.cuh cmac3).
// T stays f32 between the two products, as in the TPU kernels.
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

// xr, xi: the view (A1, X, M, 128) stored as XKIND, read; yr, yi: the
// output in the same view stored as YKIND (x itself when in place, the
// accumulator with has_acc). elt: El_t^T
// stacked (T, 128, 128), elt[t][k][l] = El_t[l][k]; et: E_t^T stacked
// (T, X, X), et[t][k][x] = E_t[x][k]. A tile is 128 / X consecutive m of
// one i, read whole before any store.
template <int X, int XKIND, int YKIND, bool X3 = false>
__global__ void __launch_bounds__(kMultiThreads, 1)
multi_apply_kernel(const void* xr, const void* xi, void* yr, void* yi,
                   const float* __restrict__ elt_r,
                   const float* __restrict__ elt_i,
                   const float* __restrict__ et_r,
                   const float* __restrict__ et_i, int T, int64_t M, int conj,
                   int has_acc) {
  static_assert(X % 8 == 0 && X <= kMultiRows, "8 | X <= 128");
  constexpr int GP = kMultiRows / X;         // m per tile
  // group-product tile depth; with X3 its lo parts take the buffer's second
  // half
  constexpr int KB0 = X < 16 ? X : 16;
  constexpr int KB = X3 && KB0 * X > kMultiOpFloats / 2
                         ? kMultiOpFloats / 2 / X : KB0;
  constexpr int kLo = kMultiOpFloats / 2;    // X3: offset of the lo parts
  static_assert(kMultiKC * kMultiCB <= kLo, "lane tile and its lo parts");
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
    const int64_t o4 = (base + row_off(r)) / 4 + c4;  // float4 index
    float vr[4], vi[4];
    load4(xr, o4, XKIND, vr);
    load4(xi, o4, XKIND, vi);
    reinterpret_cast<float4*>(sXr)[e4] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    reinterpret_cast<float4*>(sXi)[e4] = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }

  const int r0 = warp * 8;            // this thread's rows r0 .. r0 + 7
  const int g0 = (r0 / X) * X;        // first row of their X-row group
  const int x0 = r0 - g0;             // their x
  for (int cb = 0; cb < kGroup / kMultiCB; ++cb) {
    float acc_r[8][2], acc_i[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc_r[a][j] = acc_i[a][j] = 0.f;
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
          stage_op<X3>(__ldg(lr + src), __ldg(li + src), e, sOr, sOi,
                       sOr + kLo, sOi + kLo);
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
          if constexpr (X3) {
            float bl_r[4][2], bl_i[4][2];  // the operator tile's lo parts
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                bl_r[q][j] = sOr[kLo + (q4 + q) * kMultiCB + lane + 32 * j];
                bl_i[q][j] = sOi[kLo + (q4 + q) * kMultiCB + lane + 32 * j];
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
              for (int q = 0; q < 4; ++q) {
                float vrh, vrs, vih, vis;
                split_hs(vr[q], vrh, vrs);
                split_hs(vi[q], vih, vis);
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  cmac3(ar_[a][j], ai_[a][j], br[q][j], bl_r[q][j], bi[q][j],
                        bl_i[q][j], vrh, vrs, vih, vis);
              }
            }
          } else {
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
        for (int e = tid; e < KB * X; e += kMultiThreads)  // [kk][x]
          stage_op<X3>(__ldg(gr_ + (int64_t)k0 * X + e),
                       __ldg(gi_ + (int64_t)k0 * X + e), e, sOr, sOi,
                       sOr + kLo, sOi + kLo);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          float br[2], bi[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            br[j] = sTr[(g0 + k0 + kk) * kMultiCB + lane + 32 * j];
            bi[j] = sTi[(g0 + k0 + kk) * kMultiCB + lane + 32 * j];
          }
          if constexpr (X3) {
            float brh[2], brs[2], bih[2], bis[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              split_hs(br[j], brh[j], brs[j]);
              split_hs(bi[j], bih[j], bis[j]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = kk * X + x0 + 4 * h;
              const float4 er4 = *reinterpret_cast<const float4*>(sOr + o);
              const float4 ei4 = *reinterpret_cast<const float4*>(sOi + o);
              const float4 el4 = *reinterpret_cast<const float4*>(sOr + kLo + o);
              const float4 eli4 = *reinterpret_cast<const float4*>(sOi + kLo + o);
              const float er[4] = {er4.x, er4.y, er4.z, er4.w};
              const float ei[4] = {ei4.x, ei4.y, ei4.z, ei4.w};
              const float elr[4] = {el4.x, el4.y, el4.z, el4.w};
              const float eli[4] = {eli4.x, eli4.y, eli4.z, eli4.w};
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  cmac3(acc_r[4 * h + a][j], acc_i[4 * h + a][j], er[a],
                        elr[a], ei[a], eli[a], brh[j], brs[j], bih[j], bis[j]);
            }
          } else {
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
                  mcmac(acc_r[4 * h + a][j], acc_i[4 * h + a][j], er[a], ei[a],
                        br[j], bi[j]);
            }
          }
        }
      }
    }
    // 4. the column block's sum over the terms, in the seed's form (one row
    //    per warp and store: 32 consecutive lanes)
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int64_t o = base + row_off(r0 + a) + cb * kMultiCB + lane;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float vr = acc_r[a][j], vi = acc_i[a][j];
        if (conj) vi = -vi;
        if (has_acc) {
          vr += load_plane(yr, o + 32 * j, YKIND);
          vi += load_plane(yi, o + 32 * j, YKIND);
        }
        store_plane(yr, o + 32 * j, vr, YKIND);
        store_plane(yi, o + 32 * j, vi, YKIND);
      }
    }
  }
}

template <int X, int XKIND, int YKIND, bool X3>
int launch_multi_kind(const void* xr, const void* xi, void* yr, void* yi,
                      const float* elt_r, const float* elt_i,
                      const float* et_r, const float* et_i, int T,
                      long long blocks, long long M, int conj, int has_acc,
                      cudaStream_t stream) {
  auto kernel = multi_apply_kernel<X, XKIND, YKIND, X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMultiSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kMultiThreads, kMultiSmemBytes, stream>>>(
      xr, xi, yr, yi, elt_r, elt_i, et_r, et_i, T, (int64_t)M, conj, has_acc);
  return (int)cudaGetLastError();
}

// On the view (A1, X, M, 128): y <- [y +] conj?(sum_t E_t x El_t^T), with
// y = x for in place and y the accumulator with has_acc; x stored as xkind
// and y as ykind (0 f32, 1 bf16, 2 f16): both f32, both one reduced storage
// (in place on a cotangent or on bf16 forward planes, or a seed from bf16
// forward planes into bf16 cotangent planes), or x f32 and y reduced (a
// seed); X3 runs both products bf16x3. Needs M % (128 / X) == 0. Returns
// cudaGetLastError().
template <int X, bool X3>
int launch_multi_apply(const void* xr, const void* xi, void* yr, void* yi,
                       int xkind, int ykind, const float* elt_r,
                       const float* elt_i, const float* et_r,
                       const float* et_i, int T, long long A1, long long M,
                       int conj, int has_acc, cudaStream_t stream) {
  constexpr int GP = kMultiRows / X;
  if (T <= 0 || A1 <= 0 || M <= 0 || M % GP != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (M / GP);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define DQC_MULTI_KIND(XK, YK)                                                \
  if (xkind == XK && ykind == YK)                                             \
    return launch_multi_kind<X, XK, YK, X3>(xr, xi, yr, yi, elt_r, elt_i,     \
                                            et_r, et_i, T, blocks, M, conj,   \
                                            has_acc, stream);
  DQC_MULTI_KIND(kStoreF32, kStoreF32)
  DQC_MULTI_KIND(kStoreBF16, kStoreBF16)
  DQC_MULTI_KIND(kStoreF16, kStoreF16)
  DQC_MULTI_KIND(kStoreF32, kStoreBF16)
  DQC_MULTI_KIND(kStoreF32, kStoreF16)
#undef DQC_MULTI_KIND
  return (int)cudaErrorInvalidValue;
}

// launch_multi_apply at the view's X (high_multi_apply.cu, and its bf16x3
// products in high_multi_apply_x3.cu).
template <bool X3>
int launch_high_multi(const void* xr, const void* xi, void* yr, void* yi,
                      int xkind, int ykind, const float* elt_r,
                      const float* elt_i, const float* et_r, const float* et_i,
                      int T, int conj, int has_acc, long long A1, int X,
                      long long M, cudaStream_t s) {
  switch (X) {
#define DQC_MULTI_CASE(XX)                                                   \
  case XX:                                                                   \
    return launch_multi_apply<XX, X3>(xr, xi, yr, yi, xkind, ykind, elt_r,   \
                                      elt_i, et_r, et_i, T, A1, M, conj,     \
                                      has_acc, s);
    DQC_MULTI_CASE(8)
    DQC_MULTI_CASE(16)
    DQC_MULTI_CASE(32)
    DQC_MULTI_CASE(64)
    DQC_MULTI_CASE(128)
#undef DQC_MULTI_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dqc
