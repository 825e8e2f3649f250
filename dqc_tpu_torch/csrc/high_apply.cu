// High-group apply on f32 planes: y = E . x along axis X of (A1, X, M, 128).
//
// Replaces the TPU kernel high_group_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:76, pallas_call at :133), forward form:
// a dense operator E (X x X, 8 <= X <= 128) on the contracted group axis of
// the high view, with an optional fused diagonal run multiplied before
// (diag_first) or after the product, and the seed modes of the gradient:
// conj(y), y added into accumulator planes, and output planes other than the
// input (alias=False). The run's tables are read in their
// canonical layout, tsl (128, 128) and tas/tal (A, 128), at
// a = (i X + x) post + p for view element (i, x, m = p 128 + s, l); the
// TPU kernel's re-laid-out table views (common.dh_table_views) were a
// Mosaic tiling need and have no counterpart here.
//
// Bound: operations. At X = 128 each amplitude takes 128 complex
// multiply-adds (8 real flops each) against 16 bytes moved, ~64 flop per
// byte, above the H100's FP32 ridge (~20 flop/B). f32 FMA on the CUDA
// cores, no TF32.
//
// X = 256 and 512 are the merged top axis of a tiny top group
// (ops/planes._merged_view): the in-place sweep of a dense block there (a
// lone top-group block, E (x) I, or the unfactorized hpair's merged
// operator) and the density seed of the top two groups, by
// wide_apply_kernel (csrc/wide_apply.cuh), without a diagonal run.
//
// Design: a "column" is one (i, m, l) position, its X amplitudes X apart
// by Q = M 128. A block of 256 threads takes 8192 / X consecutive columns
// (all of one i, since they divide Q), reads the whole X-deep tile into
// shared memory (64 KB) before it writes, so the output may be the input, and
// each thread keeps 8 rows x 4 columns of the product in registers while
// 16-deep tiles of E stream through shared memory.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on its input and its dot_mode), at X = 128 and, for the seeds, X = 256 /
// 512: x may be stored as bf16 (XKIND), in place or a seed from it into
// bf16 cotangent planes, and the product may run bf16x3 (X3): the E tile is
// staged as its hi and lo bf16 parts and each x value split into hi and
// hi + lo as it is read (common.cuh cmac3). XKIND, YKIND and X3 are
// template parameters, so that the f32 sweep keeps its code.

#include "wide_apply.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;
using dqc::diag_at;

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

// (i, x, q) -> the run's D; q = (p 128 + s) 128 + l.
__device__ __forceinline__ void view_diag(const DiagTables& d, int64_t i,
                                          int X, int x, int64_t q,
                                          int64_t post, float& dr, float& di) {
  const int l = (int)(q & 127);
  const int s = (int)((q >> 7) & 127);
  const int64_t p = q >> 14;
  diag_at(d, (i * X + x) * post + p, s, l, dr, di);
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

// X = 128 with bf16 x (into bf16 y) or bf16x3 products: the variants of the
// forward storage and dot mode
int launch_fwd16(const void* xr, const void* xi, void* yr, void* yi, int xkind,
                 int ykind, int x3, const float* er, const float* ei,
                 const DiagTables& d, int has_diag, int diag_first, int conj,
                 int has_acc, long long A1, long long Q, cudaStream_t stream) {
#define DQC_FWD16_CASE(XK, YK, T)                                          \
  if (xkind == XK && ykind == YK && (x3 != 0) == T)                        \
    return launch_kind<128, XK, YK, T>(xr, xi, yr, yi, er, ei, d, has_diag, \
                                       diag_first, conj, has_acc, A1, Q,   \
                                       stream);
  DQC_FWD16_CASE(F, F, true)
  DQC_FWD16_CASE(F, B, true)
  DQC_FWD16_CASE(F, H, true)
  DQC_FWD16_CASE(B, B, false)
  DQC_FWD16_CASE(B, B, true)
#undef DQC_FWD16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// On the view (A1, X, Q = M 128): y <- [acc +] conj?([D] E x [D]), X in
// {8, 16, 32, 64, 128}, or X in {256, 512} without a run (Q a multiple of
// 32). y may be x (in place); with has_acc, y holds the accumulator and is
// added to. With has_diag, Q must be a multiple of
// 128 * 128 (M = post * 128). y is stored as ykind (0 f32, 1 bf16, 2 f16;
// the seed modes' cotangent planes), x as xkind (0 f32, 1 bf16: into bf16
// y); x3 runs the product bf16x3. bf16 x and x3 take X = 128, and X = 256 /
// 512 with y other planes than x (the seeds). Returns cudaGetLastError().
extern "C" int dqc_high_apply(const void* xr, const void* xi, void* yr,
                              void* yi, int xkind, int ykind, const float* er,
                              const float* ei,
                              const float* sl_r, const float* sl_i,
                              const float* as_r, const float* as_i,
                              const float* al_r, const float* al_i,
                              int has_diag, int diag_first, int conj,
                              int has_acc, int x3, long long A1, int X,
                              long long Q, void* stream) {
  if (has_diag && Q % (128 * 128) != 0) return (int)cudaErrorInvalidValue;
  if (ykind < 0 || ykind > 2 || xkind < 0 || xkind > 1)
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  if (xkind != F || x3) {
    if (X == 128)
      return launch_fwd16(xr, xi, yr, yi, xkind, ykind, x3, er, ei, d, has_diag,
                          diag_first, conj, has_acc, A1, Q, s);
    if (has_diag || xr == yr) return (int)cudaErrorInvalidValue;
    if (X == 256)
      return dqc::launch_wide_seed<256>(xr, xi, yr, yi, xkind, ykind, x3, er,
                                        ei, conj, has_acc, A1, Q, s);
    if (X == 512)
      return dqc::launch_wide_seed<512>(xr, xi, yr, yi, xkind, ykind, x3, er,
                                        ei, conj, has_acc, A1, Q, s);
    return (int)cudaErrorInvalidValue;
  }
#define DQC_HIGH_CASE(XX)                                                    \
  case XX:                                                                   \
    return launch<XX>(xr, xi, yr, yi, ykind, er, ei, d, has_diag, diag_first, \
                      conj, has_acc, A1, Q, s);
  switch (X) {
    DQC_HIGH_CASE(8)
    DQC_HIGH_CASE(16)
    DQC_HIGH_CASE(32)
    DQC_HIGH_CASE(64)
    DQC_HIGH_CASE(128)
    case 256:
      if (has_diag) return (int)cudaErrorInvalidValue;
      return dqc::launch_wide_apply<256>(static_cast<const float*>(xr),
                                         static_cast<const float*>(xi), yr, yi,
                                         ykind, er, ei, 0,
                                         conj, has_acc, A1, Q, s);
    case 512:
      if (has_diag) return (int)cudaErrorInvalidValue;
      return dqc::launch_wide_apply<512>(static_cast<const float*>(xr),
                                         static_cast<const float*>(xi), yr, yi,
                                         ykind, er, ei, 0,
                                         conj, has_acc, A1, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQC_HIGH_CASE
}
