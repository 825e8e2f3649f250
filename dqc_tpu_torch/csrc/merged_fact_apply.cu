// Kronecker-factorized apply on the merged top axis: y = (Et (x) El) x.
//
// Replaces the TPU kernel merged_fact_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:190, body _kernel_fact :148, pallas_call
// at :215). When the top group is tiny (Xt = 2 or 4 wide), a dense block on
// it and one on the group below (Xl = 128) run as one sweep on the merged
// view (A1, Xt Xl, Q = M 128), merged row x = t Xl + d: the low factor El
// acts within each top slice t, the top factor Et mixes the Xt slices
// elementwise. The Kronecker product is never expanded.
//
// Bound: operations. Xl + Xt complex multiply-adds per amplitude (8 real
// flops each) against 16 bytes moved, ~65 flop per byte, above the H100's
// FP32 ridge (~20 flop/B). f32 FMA on the CUDA cores, no TF32.
//
// Design: the two factors commute, y_a = El (sum_b Et[a, b] x_b), so the
// top factor is applied on the load. A block of 256 threads takes 64 / Xt
// consecutive columns (all of one i) of all Xt Xl rows, forms the Xt
// combinations of the slices as it reads them into a shared-memory tile of
// 128 rows x 64 "product columns" (slice a, column c at a 64 / Xt + c), and
// then runs the X = 128 tile product of csrc/high_apply.cu: each thread
// keeps 8 rows x 4 product columns in registers while 16-deep tiles of El
// stream through shared memory. The block reads all its rows before it
// writes, so the sweep is in place.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// and its dot_mode): the planes may be stored as bf16 (KIND: decoded on
// load, rounded to nearest even on store) and the low factor's product may
// run bf16x3 (X3: the El tile staged as hi and lo parts, the top-combined
// values split as they are read; the top factor stays f32, as the TPU
// kernel's VPU combinations). KIND and X3 are template parameters, so that
// the f32 sweep keeps its code.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int XL = 128;                        // the low group
constexpr int kRows = 8;                        // rows per thread
constexpr int kColsPerThread = 4;
constexpr int kColThreads = kThreads / (XL / kRows);   // 16
constexpr int PC = kColThreads * kColsPerThread;       // 64 product columns
constexpr int KC = 16;                          // El tile depth
constexpr int LDE = KC + 1;
template <bool X3>
constexpr int smem_bytes() {
  return (2 * XL * PC + (X3 ? 4 : 2) * XL * LDE) * (int)sizeof(float);
}

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

template <int XT, int KIND, bool X3>
__global__ void __launch_bounds__(kThreads)
merged_fact_apply_kernel(void* xr, void* xi, const float* __restrict__ er,
                         const float* __restrict__ ei,
                         const float* __restrict__ tr_,
                         const float* __restrict__ ti_, int64_t Q) {
  constexpr int C = PC / XT;   // columns of each slice
  extern __shared__ float smem[];
  float* vr = smem;            // top-combined tile [d][a C + c]
  float* vi = vr + XL * PC;
  float* tr = vi + XL * PC;    // El tile [row][kk] (X3: its hi part)
  float* ti = tr + XL * LDE;
  float* tlr = ti + XL * LDE;  // X3: the El tile's lo part
  float* tli = tlr + XL * LDE;

  float etr[XT][XT], eti[XT][XT];
#pragma unroll
  for (int a = 0; a < XT; ++a)
#pragma unroll
    for (int b = 0; b < XT; ++b) {
      etr[a][b] = __ldg(tr_ + a * XT + b);
      eti[a][b] = __ldg(ti_ + a * XT + b);
    }

  const int tid = threadIdx.x;
  const int rg = tid / kColThreads;  // rows rg * 8 + r
  const int tc = tid % kColThreads;  // product columns tc + 16 j
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t q0 = g0 - i * Q;
  // slice t, row d, column c at base[(t XL + d) Q + c]
  constexpr int xsize = KIND == dqc::kStoreF32 ? 4 : 2;  // bytes per element
  char* bxr = static_cast<char*>(xr) + (i * XT * XL * Q + q0) * xsize;
  char* bxi = static_cast<char*>(xi) + (i * XT * XL * Q + q0) * xsize;

  // 1. the tile of this block's columns, times (Et (x) I) as it is read
  for (int e = tid; e < XL * C; e += kThreads) {
    const int d = e / C, c = e % C;
    float xr_[XT], xi_[XT];
#pragma unroll
    for (int b = 0; b < XT; ++b) {
      const int64_t o = (int64_t)(b * XL + d) * Q + c;
      xr_[b] = dqc::load_plane(bxr, o, KIND);
      xi_[b] = dqc::load_plane(bxi, o, KIND);
    }
#pragma unroll
    for (int a = 0; a < XT; ++a) {
      float zr = 0.f, zi = 0.f;
#pragma unroll
      for (int b = 0; b < XT; ++b) cmac(zr, zi, etr[a][b], eti[a][b], xr_[b], xi_[b]);
      vr[d * PC + a * C + c] = zr;
      vi[d * PC + a * C + c] = zi;
    }
  }

  // 2. y[d, p] = sum_k El[d, k] v[k, p]
  float accr[kRows][kColsPerThread];
  float acci[kRows][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) accr[r][j] = acci[r][j] = 0.f;
  for (int k0 = 0; k0 < XL; k0 += KC) {
    __syncthreads();  // the tile is loaded / the previous El tile is consumed
    for (int e = tid; e < XL * KC; e += kThreads) {
      const int row = e / KC, kk = e % KC;
      const int at = row * LDE + kk;
      const float wr = __ldg(er + row * XL + k0 + kk);
      const float wi = __ldg(ei + row * XL + k0 + kk);
      if constexpr (X3) {
        dqc::split_hl(wr, tr[at], tlr[at]);
        dqc::split_hl(wi, ti[at], tli[at]);
      } else {
        tr[at] = wr;
        ti[at] = wi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float br[kColsPerThread], bi[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        br[j] = vr[(k0 + kk) * PC + tc + kColThreads * j];
        bi[j] = vi[(k0 + kk) * PC + tc + kColThreads * j];
      }
      if constexpr (X3) {
        float brh[kColsPerThread], brs[kColsPerThread];
        float bih[kColsPerThread], bis[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          dqc::split_hs(br[j], brh[j], brs[j]);
          dqc::split_hs(bi[j], bih[j], bis[j]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int o = (rg * kRows + r) * LDE + kk;
          const float arh = tr[o], aih = ti[o], arl = tlr[o], ail = tli[o];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            dqc::cmac3(accr[r][j], acci[r][j], arh, arl, aih, ail, brh[j],
                       brs[j], bih[j], bis[j]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float ar = tr[(rg * kRows + r) * LDE + kk];
          const float ai = ti[(rg * kRows + r) * LDE + kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            cmac(accr[r][j], acci[r][j], ar, ai, br[j], bi[j]);
        }
      }
    }
  }

  // 3. the store: product column p = a C + c is slice a, column c
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int d = rg * kRows + r, p = tc + kColThreads * j;
      const int64_t o = (int64_t)((p / C) * XL + d) * Q + p % C;
      dqc::store_plane(bxr, o, accr[r][j], KIND);
      dqc::store_plane(bxi, o, acci[r][j], KIND);
    }
}

template <int XT, int KIND, bool X3>
int launch(void* xr, void* xi, const float* er, const float* ei,
           const float* tr, const float* ti, long long A1, long long Q,
           cudaStream_t stream) {
  constexpr int C = PC / XT;
  if (Q % C != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = merged_fact_apply_kernel<XT, KIND, X3>;
  constexpr int kSmem = smem_bytes<X3>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(xr, xi, er, ei, tr, ti,
                                                       (int64_t)Q);
  return (int)cudaGetLastError();
}

template <int XT>
int launch_modes(void* xr, void* xi, const float* er, const float* ei,
                 const float* tr, const float* ti, long long A1, long long Q,
                 int kind, int x3, cudaStream_t stream) {
  constexpr int F = dqc::kStoreF32, B = dqc::kStoreBF16;
  auto fn = kind == F ? (x3 ? launch<XT, F, true> : launch<XT, F, false>)
                      : (x3 ? launch<XT, B, true> : launch<XT, B, false>);
  return fn(xr, xi, er, ei, tr, ti, A1, Q, stream);
}

}  // namespace

// In place on the merged view (A1, Xt 128, Q = M 128), Xt in {2, 4}:
// x <- (Et (x) El) x, El (128 x 128) and Et (Xt x Xt) as f32 real/imag
// planes; x stored as kind (0 f32, 1 bf16); x3 runs El's product bf16x3.
// Returns cudaGetLastError().
extern "C" int dqc_merged_fact_apply(void* xr, void* xi, const float* el_r,
                                     const float* el_i, const float* et_r,
                                     const float* et_i, long long A1, int XT,
                                     long long Q, int kind, int x3,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  switch (XT) {
    case 2:
      return launch_modes<2>(xr, xi, el_r, el_i, et_r, et_i, A1, Q, kind, x3, s);
    case 4:
      return launch_modes<4>(xr, xi, el_r, el_i, et_r, et_i, A1, Q, kind, x3, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
