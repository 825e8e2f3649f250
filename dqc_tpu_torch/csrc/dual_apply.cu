// Dual-group apply on f32 planes: y = Em . X . El^T for every 128x128 slab.
//
// Replaces the TPU kernel dual_group_apply_planes
// (dqc_tpu/ops/pallas/dual_apply.py:232, pallas_call at :295), forward form:
// lane-group operator El (qubits 0..6, the last axis) and sublane-group
// operator Em (qubits 7..13, the middle axis) on planes of shape
// (A, 128, 128), with an optional fused diagonal run
// D[a,s,l] = tas[a,s] tal[a,l] tsl[s,l] multiplied before (diag_first) or
// after the two products. The seed modes of the gradient write conj(y)
// (conj) and add y into accumulator planes (acc), and the output planes may
// be other planes than the input (the TPU kernel's alias=False): the density
// seed reads the forward planes and leaves them intact.
//
// Bound: operations. Each amplitude takes 2 x 128 complex multiply-adds
// (8 real flops each) against 16 bytes moved, about 128 flop per byte,
// far above the H100's FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B).
// The "f32" dot mode is f32 FMA on the CUDA cores (no TF32).
//
// Design: one block per slab. The block reads the whole complex slab into
// shared memory (128 KB) before it writes anything, so the output planes may
// be the input planes (in place, as the TPU kernel aliases output to input). Stage 1 computes
// T = X El^T into registers (each of the 512 threads owns 8 rows x 4
// columns), the slab buffer then takes T, and stage 2 computes Em T. The
// operators do not fit beside the slab (another 128 KB each), so 16-deep
// tiles of them stream through shared memory (16 KB).

#include "common.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;
using dqc::diag_at;

constexpr int N = dqc::kGroup;
constexpr int kThreads = 512;  // 16 warps
constexpr int kRows = 8;       // rows per thread: warp * 8 + i
constexpr int kCols = 4;       // columns per thread: lane + 32 * j
constexpr int KC = 16;         // operator tile depth
constexpr int kSmemBytes = (2 * N * N + 2 * KC * N) * sizeof(float);

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

__global__ void __launch_bounds__(kThreads, 1)
dual_apply_kernel(const float* xr, const float* xi, float* yr, float* yi,
                  const float* __restrict__ elr, const float* __restrict__ eli,
                  const float* __restrict__ emr, const float* __restrict__ emi,
                  DiagTables d, int has_diag, int diag_first, int conj,
                  int has_acc) {
  extern __shared__ float smem[];
  float* sr = smem;             // slab, then T (row-major [s][l])
  float* si = sr + N * N;
  float* tr = si + N * N;       // operator tile, [kk][row]
  float* ti = tr + KC * N;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t a = blockIdx.x;
  const float* gxr = xr + a * (N * N);
  const float* gxi = xi + a * (N * N);
  float* gyr = yr + a * (N * N);
  float* gyi = yi + a * (N * N);

  // 1. the whole slab into shared memory, times the run when it comes first
  for (int e4 = tid; e4 < N * N / 4; e4 += kThreads) {
    float4 vr = reinterpret_cast<const float4*>(gxr)[e4];
    float4 vi = reinterpret_cast<const float4*>(gxi)[e4];
    if (has_diag && diag_first) {
      const int s = (e4 * 4) / N, l0 = (e4 * 4) % N;
      float pr[4] = {vr.x, vr.y, vr.z, vr.w};
      float pi[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float dr, di;
        diag_at(d, a, s, l0 + u, dr, di);
        cmul(pr[u], pi[u], dr, di, pr[u], pi[u]);
      }
      vr = make_float4(pr[0], pr[1], pr[2], pr[3]);
      vi = make_float4(pi[0], pi[1], pi[2], pi[3]);
    }
    reinterpret_cast<float4*>(sr)[e4] = vr;
    reinterpret_cast<float4*>(si)[e4] = vi;
  }

  float accr[kRows][kCols], acci[kRows][kCols];

  // 2. stage 1: T[s, l] = sum_k X[s, k] El[l, k]  (the lane group, El^T)
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) accr[i][j] = acci[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();  // the slab is loaded / the previous tile is consumed
    for (int e = tid; e < KC * N; e += kThreads) {
      const int l = e / KC, kk = e % KC;
      tr[kk * N + l] = __ldg(elr + l * N + k0 + kk);
      ti[kk * N + l] = __ldg(eli + l * N + k0 + kk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float br[kCols], bi[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        br[j] = tr[kk * N + lane + 32 * j];
        bi[j] = ti[kk * N + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ar = sr[(warp * kRows + i) * N + k0 + kk];
        const float ai = si[(warp * kRows + i) * N + k0 + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          cmac(accr[i][j], acci[i][j], ar, ai, br[j], bi[j]);
      }
    }
  }
  __syncthreads();  // every warp is done reading the slab
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      sr[(warp * kRows + i) * N + lane + 32 * j] = accr[i][j];
      si[(warp * kRows + i) * N + lane + 32 * j] = acci[i][j];
      accr[i][j] = acci[i][j] = 0.f;
    }

  // 3. stage 2: Z[s, l] = sum_k Em[s, k] T[k, l]  (the sublane group)
  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();  // T is complete / the previous tile is consumed
    for (int e = tid; e < KC * N; e += kThreads) {
      const int s = e / KC, kk = e % KC;
      tr[kk * N + s] = __ldg(emr + s * N + k0 + kk);
      ti[kk * N + s] = __ldg(emi + s * N + k0 + kk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float br[kCols], bi[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        br[j] = sr[(k0 + kk) * N + lane + 32 * j];
        bi[j] = si[(k0 + kk) * N + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ar = tr[kk * N + warp * kRows + i];
        const float ai = ti[kk * N + warp * kRows + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          cmac(accr[i][j], acci[i][j], ar, ai, br[j], bi[j]);
      }
    }
  }

  // 4. the run when it follows, the seed modes, the store (coalesced rows)
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int s = warp * kRows + i, l = lane + 32 * j;
      float vr = accr[i][j], vi = acci[i][j];
      if (has_diag && !diag_first) {
        float dr, di;
        diag_at(d, a, s, l, dr, di);
        cmul(vr, vi, dr, di, vr, vi);
      }
      if (conj) vi = -vi;
      if (has_acc) {
        vr += gyr[s * N + l];
        vi += gyi[s * N + l];
      }
      gyr[s * N + l] = vr;
      gyi[s * N + l] = vi;
    }
}

}  // namespace

// On planes (A, 128, 128): y <- [acc +] conj?([D] Em x El^T [D]). y may be
// x (in place); with has_acc, y holds the accumulator and is added to. The
// six table pointers may be null when has_diag is 0. Returns
// cudaGetLastError().
extern "C" int dqc_dual_apply(const float* xr, const float* xi, float* yr,
                              float* yi, const float* elr, const float* eli,
                              const float* emr, const float* emi,
                              const float* sl_r, const float* sl_i,
                              const float* as_r, const float* as_i,
                              const float* al_r, const float* al_i,
                              int has_diag, int diag_first, int conj,
                              int has_acc, long long A, void* stream) {
  if (A <= 0 || A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dual_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  dual_apply_kernel<<<(unsigned)A, kThreads, kSmemBytes,
                      (cudaStream_t)stream>>>(xr, xi, yr, yi, elr, eli, emr,
                                              emi, d, has_diag, diag_first,
                                              conj, has_acc);
  return (int)cudaGetLastError();
}
