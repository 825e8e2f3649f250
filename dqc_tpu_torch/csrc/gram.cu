// Group Gram of f32 planes: S = sum xr xr^T + xi xi^T and C = sum xr xi^T
// over every axis but one, for the view (P, X, Q) of the planes.
//
// Replaces the three TPU Gram kernels of dqc_tpu/ops/pallas/gram.py:
// gram_lane (:58, pallas_call at :70; view P = A 128, X = 128, Q = 1),
// gram_sublane (:97, at :109; view P = A, X = 128, Q = 128) and gram_high
// (:134, at :149; view P = A1, X, Q = M 128). The complex group Gram is
// G = S + i (C^T - C) (conj on the second factor), formed by the caller.
//
// Bound: operations. S is symmetric, so the function needs 2 X + 1 real
// multiply-adds per amplitude (X (X + 1) / 2 entries of S at two each, X^2
// of C, per column of X amplitudes) against 8 bytes read, ~64 flop per
// byte at X = 128, above the H100's FP32 ridge (~20 flop/B). This kernel
// forms both S[x, y] and S[y, x], 3 X per amplitude: 1.5x what the bound
// counts. f32 FMA on the CUDA cores, no TF32.
//
// Design: the TPU kernel carries (S, C) across its sequential grid; Hopper
// blocks run in parallel, so each block sums its share of the columns into
// registers (each of 512 threads owns a patch of (x, y) pairs, or one pair
// and a slice of the columns for X <= 16), writes one partial (S, C), and a
// second kernel adds the partials in a fixed order: the result does not
// depend on scheduling. Columns stream through shared memory in tiles of
// 4096 / X columns, stored [column][x] with a padded row.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <int X>
struct GramCfg {
  static constexpr int RX = X >= 128 ? 8 : X >= 64 ? 4 : X >= 32 ? 2 : 1;
  static constexpr int RY = X >= 128 ? 4 : X >= 64 ? 2 : 1;
  static constexpr int TR = X / RX;                 // row threads
  static constexpr int TC = X / RY;                 // column threads
  static constexpr int G = kThreads / (TR * TC);    // column groups
  static constexpr int CB = 4096 / X;               // columns per tile
  static constexpr int LD = X + 1;                  // padded tile row
  static constexpr int kSmemBytes = 2 * CB * LD * sizeof(float);
};

template <int X>
__global__ void __launch_bounds__(kThreads, 1)
gram_partial_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ part, int64_t Q, int64_t ntiles) {
  using Cfg = GramCfg<X>;
  constexpr int RX = Cfg::RX, RY = Cfg::RY, TC = Cfg::TC, G = Cfg::G;
  constexpr int CB = Cfg::CB, LD = Cfg::LD;
  constexpr int kPairThreads = Cfg::TR * TC;
  extern __shared__ float smem[];
  float* tr = smem;            // tile [c][x]
  float* ti = tr + CB * LD;

  const int tid = threadIdx.x;
  const int grp = tid / kPairThreads;
  const int t = tid % kPairThreads;
  const int rx = (t / TC) * RX;   // rows rx + i
  const int cy = t % TC;          // columns cy + TC * j

  float S[RX][RY], Cc[RX][RY];
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) S[i][j] = Cc[i][j] = 0.f;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * CB;
    __syncthreads();  // the previous tile is consumed
    if (Q == 1) {
      // lane view: a tile is CB * X contiguous floats, x fastest
      const float* pr = xr + g0 * X;
      const float* pi = xi + g0 * X;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int c = e / X, x = e % X;
        tr[c * LD + x] = pr[e];
        ti[c * LD + x] = pi[e];
      }
    } else {
      // CB divides Q: a tile's columns share p and are contiguous per x
      const int64_t p = g0 / Q, q0 = g0 - p * Q;
      const float* pr = xr + p * X * Q + q0;
      const float* pi = xi + p * X * Q + q0;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int x = e / CB, c = e % CB;
        tr[c * LD + x] = pr[x * Q + c];
        ti[c * LD + x] = pi[x * Q + c];
      }
    }
    __syncthreads();
    for (int c = grp; c < CB; c += G) {
      float ar[RX], ai[RX], br[RY], bi[RY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        ar[i] = tr[c * LD + rx + i];
        ai[i] = ti[c * LD + rx + i];
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        br[j] = tr[c * LD + cy + TC * j];
        bi[j] = ti[c * LD + cy + TC * j];
      }
#pragma unroll
      for (int i = 0; i < RX; ++i)
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          S[i][j] = fmaf(ar[i], br[j], S[i][j]);
          S[i][j] = fmaf(ai[i], bi[j], S[i][j]);
          Cc[i][j] = fmaf(ar[i], bi[j], Cc[i][j]);
        }
    }
  }

  // this block's partial (S, C) at part[block][0 / 1][x][y]
  float* out = part + (int64_t)blockIdx.x * 2 * X * X;
  if (G == 1) {
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        out[(rx + i) * X + cy + TC * j] = S[i][j];
        out[X * X + (rx + i) * X + cy + TC * j] = Cc[i][j];
      }
  } else {
    // X <= 16: one pair per thread; add the column groups in a fixed order
    __syncthreads();  // the tile buffer is free
    smem[tid] = S[0][0];
    smem[kThreads + tid] = Cc[0][0];
    __syncthreads();
    if (grp == 0) {
      float s = 0.f, cc = 0.f;
      for (int g = 0; g < G; ++g) {
        s += smem[g * kPairThreads + t];
        cc += smem[kThreads + g * kPairThreads + t];
      }
      out[rx * X + cy] = s;
      out[X * X + rx * X + cy] = cc;
    }
  }
}

// out[e] = sum over blocks of part[b][e], e < 2 X X, in block order.
__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nblk, int n2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n2) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[(int64_t)b * n2 + e];
  out[e] = acc;
}

template <int X>
int launch(const float* xr, const float* xi, float* part, float* out,
           long long P, long long Q, int nblk, cudaStream_t stream) {
  using Cfg = GramCfg<X>;
  const long long cols = P * Q;
  if (cols % Cfg::CB != 0 || (Q != 1 && Q % Cfg::CB != 0) || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gram_partial_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  gram_partial_kernel<X><<<nblk, kThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, part, (int64_t)Q, (int64_t)(cols / Cfg::CB));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n2 = 2 * X * X;
  gram_reduce_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(part, out, nblk, n2);
  return (int)cudaGetLastError();
}

}  // namespace

// (S, C) of the view (P, X, Q), X in {8, 16, ..., 128}, into out[0] = S,
// out[1] = C (each X x X). part is scratch of nblk * 2 * X * X floats and
// nblk the number of partial-sum blocks (at most the number of tiles,
// P Q X / 4096). Returns cudaGetLastError().
extern "C" int dqc_gram(const float* xr, const float* xi, float* part,
                        float* out, long long P, int X, long long Q, int nblk,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 8: return launch<8>(xr, xi, part, out, P, Q, nblk, s);
    case 16: return launch<16>(xr, xi, part, out, P, Q, nblk, s);
    case 32: return launch<32>(xr, xi, part, out, P, Q, nblk, s);
    case 64: return launch<64>(xr, xi, part, out, P, Q, nblk, s);
    case 128: return launch<128>(xr, xi, part, out, P, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
