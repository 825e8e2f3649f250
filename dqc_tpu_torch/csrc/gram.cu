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
// 4096 / X columns, stored [column][x] with a padded row. A thread's sums
// run in two levels, so that no f32 sum grows over more than a few hundred
// terms of its own size: registers over a chunk of four tiles, then a
// running sum in shared memory (each thread its own entries), which keeps
// the 29- and 30-qubit Grams, with tens of thousands of columns per thread,
// as close to the exact sums as the 28-qubit ones.
//
// "bf16" storage and the forward bf16x3 (the TPU kernels' f32_of and
// dot_mode), at every X: the planes may be stored as bf16
// (XKIND, decoded as the tile is read) and the products may run bf16x3 (X3:
// each value split as it is read from the tile, rows into hi and lo, columns
// into hi and hi + lo, two FMAs per real product). On bf16 planes the split
// of every value has a zero lo part, so bf16x3 and f32 give the same sums
// and such a call runs the f32 products. XKIND and X3 are template
// parameters, so that the f32 Gram keeps its code.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunkTiles = 4;   // tiles summed in registers before a flush

template <int X>
struct GramCfg {
  static constexpr int RX = X >= 128 ? 8 : X >= 64 ? 4 : X >= 32 ? 2 : 1;
  static constexpr int RY = X >= 128 ? 4 : X >= 64 ? 2 : 1;
  static constexpr int TR = X / RX;                 // row threads
  static constexpr int TC = X / RY;                 // column threads
  static constexpr int G = kThreads / (TR * TC);    // column groups
  static constexpr int CB = 4096 / X;               // columns per tile
  static constexpr int LD = X + 1;                  // padded tile row
  static constexpr int kTileBytes = 2 * CB * LD * sizeof(float);
  static constexpr int kRunBytes = 2 * RX * RY * kThreads * sizeof(float);
  static constexpr int kSmemBytes = kTileBytes + kRunBytes;
};

// run[(2 (i RY + j) + {0: S, 1: C}) kThreads + thread]: this thread's running
// (S, C) in shared memory. add_chunk adds the register chunk in and clears it.
template <int RX, int RY>
__device__ __forceinline__ void add_chunk(float (&S)[RX][RY], float (&Cc)[RX][RY],
                                          float* run) {
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      float* a = run + 2 * (i * RY + j) * kThreads + threadIdx.x;
      a[0] += S[i][j];
      a[kThreads] += Cc[i][j];
      S[i][j] = Cc[i][j] = 0.f;
    }
}

template <int RX, int RY>
__device__ __forceinline__ void clear_run(float* run) {
#pragma unroll
  for (int k = 0; k < 2 * RX * RY; ++k) run[k * kThreads + threadIdx.x] = 0.f;
}

// The registers <- the running sums (after the last add_chunk).
template <int RX, int RY>
__device__ __forceinline__ void read_run(const float* run, float (&S)[RX][RY],
                                         float (&Cc)[RX][RY]) {
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const float* a = run + 2 * (i * RY + j) * kThreads + threadIdx.x;
      S[i][j] = a[0];
      Cc[i][j] = a[kThreads];
    }
}

// S += ar br + ai bi, C += ar bi over a thread's (rows, columns) patch of
// one tile column; X3 in bf16x3.
template <int RX, int RY, bool X3>
__device__ __forceinline__ void gram_products(const float (&ar)[RX],
                                              const float (&ai)[RX],
                                              const float (&br)[RY],
                                              const float (&bi)[RY],
                                              float (&S)[RX][RY],
                                              float (&Cc)[RX][RY]) {
  if constexpr (X3) {
    float brh[RY], brs[RY], bih[RY], bis[RY];
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      dqc::split_hs(br[j], brh[j], brs[j]);
      dqc::split_hs(bi[j], bih[j], bis[j]);
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      float arh, arl, aih, ail;
      dqc::split_hl(ar[i], arh, arl);
      dqc::split_hl(ai[i], aih, ail);
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        S[i][j] = fmaf(arh, brs[j], S[i][j]);
        S[i][j] = fmaf(arl, brh[j], S[i][j]);
        S[i][j] = fmaf(aih, bis[j], S[i][j]);
        S[i][j] = fmaf(ail, bih[j], S[i][j]);
        Cc[i][j] = fmaf(arh, bis[j], Cc[i][j]);
        Cc[i][j] = fmaf(arl, bih[j], Cc[i][j]);
      }
    }
  } else {
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

template <int X, int XKIND, bool X3>
__global__ void __launch_bounds__(kThreads, 1)
gram_partial_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
                    float* __restrict__ part, int64_t Q, int64_t ntiles) {
  using Cfg = GramCfg<X>;
  constexpr int RX = Cfg::RX, RY = Cfg::RY, TC = Cfg::TC, G = Cfg::G;
  constexpr int CB = Cfg::CB, LD = Cfg::LD;
  constexpr int kPairThreads = Cfg::TR * TC;
  extern __shared__ float smem[];
  float* tr = smem;            // tile [c][x]
  float* ti = tr + CB * LD;
  float* run = ti + CB * LD;   // running sums

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
  clear_run<RX, RY>(run);

  int chunk = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * CB;
    __syncthreads();  // the previous tile is consumed
    if (Q == 1) {
      // lane view: a tile is CB * X contiguous floats, x fastest
      const int64_t b0 = g0 * X;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int c = e / X, x = e % X;
        tr[c * LD + x] = dqc::load_plane(xr, b0 + e, XKIND);
        ti[c * LD + x] = dqc::load_plane(xi, b0 + e, XKIND);
      }
    } else {
      // CB divides Q: a tile's columns share p and are contiguous per x
      const int64_t p = g0 / Q, q0 = g0 - p * Q;
      const int64_t b0 = p * X * Q + q0;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int x = e / CB, c = e % CB;
        tr[c * LD + x] = dqc::load_plane(xr, b0 + x * Q + c, XKIND);
        ti[c * LD + x] = dqc::load_plane(xi, b0 + x * Q + c, XKIND);
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
      gram_products<RX, RY, X3>(ar, ai, br, bi, S, Cc);
    }
    if (++chunk == kChunkTiles) {
      add_chunk<RX, RY>(S, Cc, run);
      chunk = 0;
    }
  }
  add_chunk<RX, RY>(S, Cc, run);
  read_run<RX, RY>(run, S, Cc);

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

// X = 256 or 512 (the merged top axis of a tiny top group): block (patch,
// column group) forms the 128 x 128 patch (bx, by) of (S, C), rows bx 128 +
// i against rows by 128 + j, over the column tiles of its group, with the
// X = 128 thread layout; the (X / 128)^2 patches of one column group are
// neighbours in the grid, so their tiles come from L2. Each block writes its
// patch of its group's partial part[group], every entry of which one block
// writes.
template <int NRB, int XKIND, bool X3>
__global__ void __launch_bounds__(kThreads, 1)
gram_wide_partial_kernel(const void* __restrict__ xr,
                         const void* __restrict__ xi, float* __restrict__ part,
                         int64_t Q, int64_t ntiles) {
  using Cfg = GramCfg<128>;
  constexpr int X = NRB * 128;
  constexpr int RX = Cfg::RX, RY = Cfg::RY, TC = Cfg::TC;
  constexpr int CB = Cfg::CB, LD = Cfg::LD;
  static_assert(Cfg::G == 1, "one thread per patch of (x, y) pairs");
  extern __shared__ float smem[];
  float* ar_ = smem;          // rows of patch block bx, tile [c][x]
  float* ai_ = ar_ + CB * LD;
  float* br_ = ai_ + CB * LD;  // rows of patch block by
  float* bi_ = br_ + CB * LD;
  float* run = bi_ + CB * LD;  // running sums

  const int bx = (int)(blockIdx.x / NRB), by = (int)(blockIdx.x % NRB);
  const int tid = threadIdx.x;
  const int rx = (tid / TC) * RX;  // rows rx + i
  const int cy = tid % TC;         // columns cy + TC * j

  float S[RX][RY], Cc[RX][RY];
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) S[i][j] = Cc[i][j] = 0.f;
  clear_run<RX, RY>(run);

  int chunk = 0;
  for (int64_t tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t g0 = tile * CB;
    const int64_t p = g0 / Q, q0 = g0 - p * Q;
    const int64_t b0 = p * X * Q + q0;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < CB * 128; e += kThreads) {
      const int x = e / CB, c = e % CB;
      const int64_t oa = b0 + (int64_t)(bx * 128 + x) * Q + c;
      const int64_t ob = b0 + (int64_t)(by * 128 + x) * Q + c;
      ar_[c * LD + x] = dqc::load_plane(xr, oa, XKIND);
      ai_[c * LD + x] = dqc::load_plane(xi, oa, XKIND);
      br_[c * LD + x] = dqc::load_plane(xr, ob, XKIND);
      bi_[c * LD + x] = dqc::load_plane(xi, ob, XKIND);
    }
    __syncthreads();
    for (int c = 0; c < CB; ++c) {
      float ar[RX], ai[RX], br[RY], bi[RY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        ar[i] = ar_[c * LD + rx + i];
        ai[i] = ai_[c * LD + rx + i];
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        br[j] = br_[c * LD + cy + TC * j];
        bi[j] = bi_[c * LD + cy + TC * j];
      }
      gram_products<RX, RY, X3>(ar, ai, br, bi, S, Cc);
    }
    if (++chunk == kChunkTiles) {
      add_chunk<RX, RY>(S, Cc, run);
      chunk = 0;
    }
  }
  add_chunk<RX, RY>(S, Cc, run);
  read_run<RX, RY>(run, S, Cc);

  float* out = part + (int64_t)blockIdx.y * 2 * X * X;
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const int64_t e = (int64_t)(bx * 128 + rx + i) * X + by * 128 + cy + TC * j;
      out[e] = S[i][j];
      out[(int64_t)X * X + e] = Cc[i][j];
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

template <int X, int XKIND = dqc::kStoreF32, bool X3 = false>
int launch(const void* xr, const void* xi, float* part, float* out,
           long long P, long long Q, int nblk, cudaStream_t stream) {
  using Cfg = GramCfg<X>;
  const long long cols = P * Q;
  if (cols % Cfg::CB != 0 || (Q != 1 && Q % Cfg::CB != 0) || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_partial_kernel<X, XKIND, X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, part, (int64_t)Q, (int64_t)(cols / Cfg::CB));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n2 = 2 * X * X;
  gram_reduce_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(part, out, nblk, n2);
  return (int)cudaGetLastError();
}

template <int NRB, int XKIND = dqc::kStoreF32, bool X3 = false>
int launch_wide(const void* xr, const void* xi, float* part, float* out,
                long long P, long long Q, int nblk, cudaStream_t stream) {
  constexpr int X = NRB * 128;
  constexpr int CB = GramCfg<128>::CB;
  constexpr int kSmemBytes = 2 * GramCfg<128>::kTileBytes + GramCfg<128>::kRunBytes;
  if (Q == 1 || Q % CB != 0 || nblk <= 0 || nblk > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_wide_partial_kernel<NRB, XKIND, X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(NRB * NRB, nblk), kThreads, kSmemBytes, stream>>>(
      xr, xi, part, (int64_t)Q, (int64_t)(P * Q / CB));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n2 = 2 * X * X;
  gram_reduce_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(part, out, nblk, n2);
  return (int)cudaGetLastError();
}

}  // namespace

// (S, C) of the view (P, X, Q), X in {8, 16, ..., 128, 256, 512}, into
// out[0] = S, out[1] = C (each X x X). part is scratch of nblk * 2 * X * X
// floats and nblk the number of partial-sum blocks (at most the number of
// tiles, P Q X / 4096, for X <= 128) or of column groups (at most P Q / 32,
// for X > 128, where Q must be a multiple of 32). The planes are stored as
// kind (0 f32, 1 bf16) and x3 runs the products bf16x3, at every X.
// Returns cudaGetLastError().
extern "C" int dqc_gram(const void* xr, const void* xi, float* part,
                        float* out, long long P, int X, long long Q, int nblk,
                        int kind, int x3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int B = dqc::kStoreBF16;
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  if (kind == B || x3) {
    // bf16 values split with a zero lo part: bf16x3 is the f32 product there
    const bool split = kind != B;
    switch (X) {
#define DQC_GRAM_FWD16(XX)                                                    \
  case XX:                                                                    \
    return split ? launch<XX, dqc::kStoreF32, true>(xr, xi, part, out, P, Q,  \
                                                    nblk, s)                  \
                 : launch<XX, B, false>(xr, xi, part, out, P, Q, nblk, s);
      DQC_GRAM_FWD16(8)
      DQC_GRAM_FWD16(16)
      DQC_GRAM_FWD16(32)
      DQC_GRAM_FWD16(64)
#undef DQC_GRAM_FWD16
      case 128:
        return split ? launch<128, dqc::kStoreF32, true>(xr, xi, part, out, P,
                                                          Q, nblk, s)
                     : launch<128, B, false>(xr, xi, part, out, P, Q, nblk, s);
      case 256:
        return split ? launch_wide<2, dqc::kStoreF32, true>(xr, xi, part, out,
                                                             P, Q, nblk, s)
                     : launch_wide<2, B, false>(xr, xi, part, out, P, Q, nblk,
                                                s);
      case 512:
        return split ? launch_wide<4, dqc::kStoreF32, true>(xr, xi, part, out,
                                                             P, Q, nblk, s)
                     : launch_wide<4, B, false>(xr, xi, part, out, P, Q, nblk,
                                                s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (X) {
    case 8: return launch<8>(xr, xi, part, out, P, Q, nblk, s);
    case 16: return launch<16>(xr, xi, part, out, P, Q, nblk, s);
    case 32: return launch<32>(xr, xi, part, out, P, Q, nblk, s);
    case 64: return launch<64>(xr, xi, part, out, P, Q, nblk, s);
    case 128: return launch<128>(xr, xi, part, out, P, Q, nblk, s);
    case 256: return launch_wide<2>(xr, xi, part, out, P, Q, nblk, s);
    case 512: return launch_wide<4>(xr, xi, part, out, P, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
