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
// seed reads the forward planes and leaves them intact. The seed's output
// (and accumulator) planes may be stored reduced (ykind: the cotangent
// storage of config.set_state_storage, common.cuh's codec; the TPU kernel's
// store_as at dual_apply.py:109-113): the accumulator is decoded, added to
// in f32 and encoded.
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
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on its input and its dot_mode): x may be stored as bf16 (XKIND), in place
// (y = x, the forward sweep on bf16 forward planes) or a seed from it into
// bf16 cotangent planes, and the two products may run bf16x3 (X3): each
// operator tile is staged as its hi and lo bf16 parts (twice the tile
// buffer) and each slab value split into hi and lo as it is read, two FMAs
// per real product (common.cuh cmac3). XKIND, YKIND and X3 are template
// parameters, so that the f32 sweep keeps its code.
//
// f16 input (the TPU kernel's f32_of on a uint16 cotangent): x may be
// stored as f16 bits in the JAX package's codec, into f16 y: the per-term
// fallback of a dense cross-group gate under "f16" storage
// (plane_scan._apply_dense_cross) runs a term's two sweeps on the
// cotangent, a fresh temporary then a seed into the f16 accumulator, in
// either dot mode.

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
// the slab and the operator tile (X3: its hi and lo parts)
template <bool X3>
constexpr int smem_bytes() {
  return (2 * N * N + (X3 ? 4 : 2) * KC * N) * (int)sizeof(float);
}

__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// One operator entry into the shared tile at `at`: as it is, or (X3) as
// its hi part there and its lo part at the same place of the lo buffers.
template <bool X3>
__device__ __forceinline__ void stage_op(float wr, float wi, int at, float* tr,
                                         float* ti) {
  if constexpr (X3) {
    dqc::split_hl(wr, tr[at], tr[2 * KC * N + at]);
    dqc::split_hl(wi, ti[at], ti[2 * KC * N + at]);
  } else {
    tr[at] = wr;
    ti[at] = wi;
  }
}

// XKIND / YKIND: the storage of x / y; X3: the products in bf16x3 (template
// parameters, so that the f32 sweep keeps its plain loads and stores)
template <int XKIND, int YKIND, bool X3>
__global__ void __launch_bounds__(kThreads, 1)
dual_apply_kernel(const void* xr, const void* xi, char* yr, char* yi,
                  const float* __restrict__ elr,
                  const float* __restrict__ eli,
                  const float* __restrict__ emr, const float* __restrict__ emi,
                  DiagTables d, int has_diag, int diag_first, int conj,
                  int has_acc) {
  extern __shared__ float smem[];
  float* sr = smem;             // slab, then T (row-major [s][l])
  float* si = sr + N * N;
  float* tr = si + N * N;       // operator tile, [kk][row]
  float* ti = tr + KC * N;      // (X3: the lo parts 2 KC N further on)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t a = blockIdx.x;
  constexpr int xsize = XKIND == dqc::kStoreF32 ? 4 : 2;  // bytes per x element
  const char* gxr = static_cast<const char*>(xr) + a * (N * N) * xsize;
  const char* gxi = static_cast<const char*>(xi) + a * (N * N) * xsize;
  constexpr int ykind = YKIND;
  constexpr int ysize = ykind == dqc::kStoreF32 ? 4 : 2;  // bytes per y element
  char* gyr = yr + a * (N * N) * ysize;
  char* gyi = yi + a * (N * N) * ysize;

  // 1. the whole slab into shared memory, times the run when it comes first
  for (int e4 = tid; e4 < N * N / 4; e4 += kThreads) {
    float4 vr, vi;
    if constexpr (XKIND == dqc::kStoreF32) {
      vr = reinterpret_cast<const float4*>(gxr)[e4];
      vi = reinterpret_cast<const float4*>(gxi)[e4];
    } else {
      float pr[4], pi[4];
      dqc::load4(gxr, e4, XKIND, pr);
      dqc::load4(gxi, e4, XKIND, pi);
      vr = make_float4(pr[0], pr[1], pr[2], pr[3]);
      vi = make_float4(pi[0], pi[1], pi[2], pi[3]);
    }
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
      stage_op<X3>(__ldg(elr + l * N + k0 + kk), __ldg(eli + l * N + k0 + kk),
                   kk * N + l, tr, ti);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float br[kCols], bi[kCols];
      if constexpr (X3) {
        // El as (hi, hi + lo) parts, the slab values as (hi, lo)
        float brs[kCols], bis[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int o = kk * N + lane + 32 * j;
          br[j] = tr[o];
          bi[j] = ti[o];
          brs[j] = br[j] + tr[2 * KC * N + o];
          bis[j] = bi[j] + ti[2 * KC * N + o];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float arh, arl, aih, ail;
          dqc::split_hl(sr[(warp * kRows + i) * N + k0 + kk], arh, arl);
          dqc::split_hl(si[(warp * kRows + i) * N + k0 + kk], aih, ail);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            dqc::cmac3(accr[i][j], acci[i][j], arh, arl, aih, ail, br[j],
                       brs[j], bi[j], bis[j]);
        }
      } else {
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
      stage_op<X3>(__ldg(emr + s * N + k0 + kk), __ldg(emi + s * N + k0 + kk),
                   kk * N + s, tr, ti);
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
      if constexpr (X3) {
        // Em as (hi, lo) parts, T's values as (hi, hi + lo)
        float brh[kCols], brs[kCols], bih[kCols], bis[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dqc::split_hs(br[j], brh[j], brs[j]);
          dqc::split_hs(bi[j], bih[j], bis[j]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int o = kk * N + warp * kRows + i;
          const float arh = tr[o], aih = ti[o];
          const float arl = tr[2 * KC * N + o], ail = ti[2 * KC * N + o];
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            dqc::cmac3(accr[i][j], acci[i][j], arh, arl, aih, ail, brh[j],
                       brs[j], bih[j], bis[j]);
        }
      } else {
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
        vr += dqc::load_plane(gyr, s * N + l, ykind);
        vi += dqc::load_plane(gyi, s * N + l, ykind);
      }
      dqc::store_plane(gyr, s * N + l, vr, ykind);
      dqc::store_plane(gyi, s * N + l, vi, ykind);
    }
}

}  // namespace

template <int XKIND, int YKIND, bool X3>
int launch(const void* xr, const void* xi, void* yr, void* yi, const float* elr,
           const float* eli, const float* emr, const float* emi,
           const DiagTables& d, int has_diag, int diag_first, int conj,
           int has_acc, long long A, cudaStream_t stream) {
  auto kernel = dual_apply_kernel<XKIND, YKIND, X3>;
  constexpr int kSmem = smem_bytes<X3>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)A, kThreads, kSmem, stream>>>(
      xr, xi, static_cast<char*>(yr), static_cast<char*>(yi), elr, eli, emr,
      emi, d, has_diag, diag_first, conj, has_acc);
  return (int)cudaGetLastError();
}

// On planes (A, 128, 128): y <- [acc +] conj?([D] Em x El^T [D]). y may be
// x (in place, ykind = xkind); with has_acc, y holds the accumulator and is
// added to. x is stored as xkind (0 f32, 1 bf16, 2 f16), y as ykind (0 f32,
// 1 bf16, 2 f16): x f32 into any y, bf16 into bf16 or f16 into f16. x3: the
// products in bf16x3.
// The six table pointers may be null when has_diag is 0. Returns
// cudaGetLastError().
extern "C" int dqc_dual_apply(const void* xr, const void* xi, void* yr,
                              void* yi, int xkind, int ykind, const float* elr,
                              const float* eli,
                              const float* emr, const float* emi,
                              const float* sl_r, const float* sl_i,
                              const float* as_r, const float* as_i,
                              const float* al_r, const float* al_i,
                              int has_diag, int diag_first, int conj,
                              int has_acc, int x3, long long A, void* stream) {
  if (A <= 0 || A > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  constexpr int F = dqc::kStoreF32, B = dqc::kStoreBF16, H = dqc::kStoreF16;
#define DQC_DUAL_CASE(XK, YK, T)                                             \
  if (xkind == XK && ykind == YK && (x3 != 0) == T)                          \
    return launch<XK, YK, T>(xr, xi, yr, yi, elr, eli, emr, emi, d, has_diag, \
                             diag_first, conj, has_acc, A,                   \
                             (cudaStream_t)stream);
  DQC_DUAL_CASE(F, F, false)
  DQC_DUAL_CASE(F, B, false)
  DQC_DUAL_CASE(F, H, false)
  DQC_DUAL_CASE(F, F, true)
  DQC_DUAL_CASE(F, B, true)
  DQC_DUAL_CASE(F, H, true)
  DQC_DUAL_CASE(B, B, false)
  DQC_DUAL_CASE(B, B, true)
  DQC_DUAL_CASE(H, H, false)
  DQC_DUAL_CASE(H, H, true)
#undef DQC_DUAL_CASE
  return (int)cudaErrorInvalidValue;
}
