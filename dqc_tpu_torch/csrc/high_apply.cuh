// The high-group apply kernel on the CUDA cores (X = 8..64) and its
// launches, shared by high_apply.cu (f32 planes, f32 products) and
// high_apply_fwd16.cu (the bf16 / f16 / bf16x3 variants, a library of its
// own so that the two build in parallel); X >= 128 runs on the tensor
// cores (tc_apply.cuh). high_apply.cu's header comment describes the
// kernel.
#pragma once

#include "common.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;
using dqc::view_diag;

constexpr int kThreads = 256;

template <int X, bool X3 = false>
struct HighCfg {
  static constexpr int kRows = 8;                          // rows per thread
  static constexpr int kColsPerThread = 4;
  static constexpr int kColThreads = kThreads / (X / kRows);  // 2048 / X
  static constexpr int C = kColThreads * kColsPerThread;   // columns per block
  static constexpr int KC = X < 16 ? X : 16;               // E tile depth
  static constexpr int LDE = KC + 1;                       // padded E tile row
  static constexpr int kSmemBytes =
      (2 * X * C + (X3 ? 4 : 2) * X * LDE) * (int)sizeof(float);
};

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

template <int X, int XKIND, int YKIND, bool X3>
__global__ void __launch_bounds__(kThreads)
high_apply_kernel(const void* xr, const void* xi, char* yr, char* yi,
                  const float* __restrict__ er,
                  const float* __restrict__ ei,
                  DiagTables d, int has_diag, int diag_first, int conj,
                  int has_acc, int64_t Q, int64_t post) {
  using Cfg = HighCfg<X, X3>;
  constexpr int C = Cfg::C;
  constexpr int KC = Cfg::KC;
  constexpr int LDE = Cfg::LDE;
  constexpr int TC = Cfg::kColThreads;
  extern __shared__ float smem[];
  float* vr = smem;             // input tile [x][c]
  float* vi = vr + X * C;
  float* tr = vi + X * C;       // E tile [row][kk] (X3: its hi part)
  float* ti = tr + X * LDE;
  float* tlr = ti + X * LDE;    // X3: the E tile's lo part
  float* tli = tlr + X * LDE;

  const int tid = threadIdx.x;
  const int rg = tid / TC;      // row group: rows rg * 8 + r
  const int tc = tid % TC;      // columns tc + TC * j
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t q0 = g0 - i * Q;
  constexpr int xsize = XKIND == dqc::kStoreF32 ? 4 : 2;  // bytes per x element
  // element (x, c) at bx[x Q + c]
  const char* bxr = static_cast<const char*>(xr) + (i * X * Q + q0) * xsize;
  const char* bxi = static_cast<const char*>(xi) + (i * X * Q + q0) * xsize;
  constexpr int ykind = YKIND;  // y's storage, a template parameter
  constexpr int ysize = ykind == dqc::kStoreF32 ? 4 : 2;  // bytes per y element
  char* byr = yr + (i * X * Q + q0) * ysize;
  char* byi = yi + (i * X * Q + q0) * ysize;

  // 1. the whole X-deep tile of this block's columns, times the run if first
  for (int e = tid; e < X * C; e += kThreads) {
    const int x = e / C, c = e % C;
    float ar = dqc::load_plane(bxr, x * Q + c, XKIND);
    float ai = dqc::load_plane(bxi, x * Q + c, XKIND);
    if (has_diag && diag_first) {
      float dr, di;
      view_diag(d, i, X, x, q0 + c, post, dr, di);
      cmul(ar, ai, dr, di, ar, ai);
    }
    vr[x * C + c] = ar;
    vi[x * C + c] = ai;
  }

  // 2. y[x, c] = sum_k E[x, k] v[k, c]
  float accr[Cfg::kRows][Cfg::kColsPerThread];
  float acci[Cfg::kRows][Cfg::kColsPerThread];
#pragma unroll
  for (int r = 0; r < Cfg::kRows; ++r)
#pragma unroll
    for (int j = 0; j < Cfg::kColsPerThread; ++j) accr[r][j] = acci[r][j] = 0.f;
  for (int k0 = 0; k0 < X; k0 += KC) {
    __syncthreads();  // the tile is loaded / the previous E tile is consumed
    for (int e = tid; e < X * KC; e += kThreads) {
      const int row = e / KC, kk = e % KC;
      dqc::stage_op<X3>(__ldg(er + row * X + k0 + kk),
                        __ldg(ei + row * X + k0 + kk), row * LDE + kk, tr, ti,
                        tlr, tli);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float br[Cfg::kColsPerThread], bi[Cfg::kColsPerThread];
#pragma unroll
      for (int j = 0; j < Cfg::kColsPerThread; ++j) {
        br[j] = vr[(k0 + kk) * C + tc + TC * j];
        bi[j] = vi[(k0 + kk) * C + tc + TC * j];
      }
      if constexpr (X3) {
        float brh[Cfg::kColsPerThread], brs[Cfg::kColsPerThread];
        float bih[Cfg::kColsPerThread], bis[Cfg::kColsPerThread];
#pragma unroll
        for (int j = 0; j < Cfg::kColsPerThread; ++j) {
          dqc::split_hs(br[j], brh[j], brs[j]);
          dqc::split_hs(bi[j], bih[j], bis[j]);
        }
#pragma unroll
        for (int r = 0; r < Cfg::kRows; ++r) {
          const int o = (rg * Cfg::kRows + r) * LDE + kk;
          const float arh = tr[o], aih = ti[o], arl = tlr[o], ail = tli[o];
#pragma unroll
          for (int j = 0; j < Cfg::kColsPerThread; ++j)
            dqc::cmac3(accr[r][j], acci[r][j], arh, arl, aih, ail, brh[j],
                       brs[j], bih[j], bis[j]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < Cfg::kRows; ++r) {
          const float ar = tr[(rg * Cfg::kRows + r) * LDE + kk];
          const float ai = ti[(rg * Cfg::kRows + r) * LDE + kk];
#pragma unroll
          for (int j = 0; j < Cfg::kColsPerThread; ++j)
            cmac(accr[r][j], acci[r][j], ar, ai, br[j], bi[j]);
        }
      }
    }
  }

  // 3. the run when it follows, the seed modes, the store
#pragma unroll
  for (int r = 0; r < Cfg::kRows; ++r)
#pragma unroll
    for (int j = 0; j < Cfg::kColsPerThread; ++j) {
      const int x = rg * Cfg::kRows + r, c = tc + TC * j;
      float vr = accr[r][j], vi = acci[r][j];
      if (has_diag && !diag_first) {
        float dr, di;
        view_diag(d, i, X, x, q0 + c, post, dr, di);
        cmul(vr, vi, dr, di, vr, vi);
      }
      if (conj) vi = -vi;
      if (has_acc) {
        vr += dqc::load_plane(byr, x * Q + c, ykind);
        vi += dqc::load_plane(byi, x * Q + c, ykind);
      }
      dqc::store_plane(byr, x * Q + c, vr, ykind);
      dqc::store_plane(byi, x * Q + c, vi, ykind);
    }
}

template <int X, int XKIND, int YKIND, bool X3>
int launch_kind(const void* xr, const void* xi, void* yr, void* yi,
                const float* er, const float* ei, const DiagTables& d,
                int has_diag, int diag_first, int conj, int has_acc,
                long long A1, long long Q, cudaStream_t stream) {
  using Cfg = HighCfg<X, X3>;
  if (Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / Cfg::C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = high_apply_kernel<X, XKIND, YKIND, X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, static_cast<char*>(yr), static_cast<char*>(yi), er, ei, d,
      has_diag, diag_first, conj, has_acc, (int64_t)Q, (int64_t)(Q >> 14));
  return (int)cudaGetLastError();
}

constexpr int F = dqc::kStoreF32, B = dqc::kStoreBF16, H = dqc::kStoreF16;

// f32 x into y of any storage, f32 products (every X)
template <int X>
int launch(const void* xr, const void* xi, void* yr, void* yi, int ykind,
           const float* er, const float* ei, const DiagTables& d, int has_diag,
           int diag_first, int conj, int has_acc, long long A1, long long Q,
           cudaStream_t stream) {
  auto fn = ykind == F   ? launch_kind<X, F, F, false>
            : ykind == B ? launch_kind<X, F, B, false>
                         : launch_kind<X, F, H, false>;
  return fn(xr, xi, yr, yi, er, ei, d, has_diag, diag_first, conj, has_acc, A1,
            Q, stream);
}

// bf16 x (into bf16 y), f16 x (into f16 y: the per-term fallback's sweeps
// on an "f16" cotangent) or bf16x3 products at X <= 64: the variants of
// the forward storage and dot mode, and of f16 input
template <int X>
int launch_fwd16(const void* xr, const void* xi, void* yr, void* yi, int xkind,
                 int ykind, int x3, const float* er, const float* ei,
                 const DiagTables& d, int has_diag, int diag_first, int conj,
                 int has_acc, long long A1, long long Q, cudaStream_t stream) {
#define DQC_FWD16_CASE(XK, YK, T)                                          \
  if (xkind == XK && ykind == YK && (x3 != 0) == T)                        \
    return launch_kind<X, XK, YK, T>(xr, xi, yr, yi, er, ei, d, has_diag,   \
                                     diag_first, conj, has_acc, A1, Q,     \
                                     stream);
  DQC_FWD16_CASE(F, F, true)
  DQC_FWD16_CASE(F, B, true)
  DQC_FWD16_CASE(F, H, true)
  DQC_FWD16_CASE(B, B, false)
  DQC_FWD16_CASE(B, B, true)
  DQC_FWD16_CASE(H, H, false)
  DQC_FWD16_CASE(H, H, true)
#undef DQC_FWD16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
