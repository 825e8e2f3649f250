// Fused diagonal-run sweep and its one-pass adjoint on f32 planes.
//
// Replaces the TPU kernels diag_sweep_planes (dqc_tpu/ops/pallas/diag.py:75,
// pallas_call at :90) and diag_backward_planes (:154, at :184, body
// _kernel_bwd at :105) with its Q reductions. A run of commuting diagonal gates is one
// elementwise multiply by its total diagonal, factored over the plane axes
// (a = merged high groups, s = sublane, l = lane) as
// D[a, s, l] = (tas[a, s] tal[a, l]) tsl[s, l], the association order of the
// TPU kernels (common.cuh diag_at):
//
//   sweep:     x   *= D
//   backward:  fwd *= Dinv,  bwd *= D
//
// in place on planes (A, 128, 128). With Q (a run with variable gates) the
// backward also forms the reductions of the holomorphic product
// Q[a, s, l] = bwd fwd, taken before the update: Qsl (128 x 128, summed over
// a), Qas (A x 128, summed over l) and Qal (A x 128, summed over s) — the
// gradient sources of the run's variable gates.
//
// Bound: bytes. One read and one write of each plane, 16 bytes per amplitude
// for the sweep and 32 for the backward, against 3 (6) complex multiplies:
// under 2 flop per byte, far below the H100's FP32 ridge (~20 flop/B).
//
// Design: each thread takes four consecutive lanes of one (a, s) row as
// float4 loads and stores of the planes and of the tal / tsl table rows
// (tables stay in L2: at most 2 x (A + 128) x 128 complex entries), and tas
// as one broadcast complex scalar; a grid-stride loop over the float4s with
// int64 offsets (a 30-qubit plane has 2^30 elements).
//
// The Q mode works by slabs: a block of 256 threads walks its slabs a in
// grid-stride order, thread (w, t) (warp w, lane t) taking lanes 4 t .. 4 t
// + 3 of rows s = w, w + 8, ..., w + 120. A row's Qas entry is a fixed
// butterfly of warp shuffles, written by lane 0; a column's Qal entry sums
// 8 per-warp partials from shared memory in warp order; Qsl goes to the
// block's own partial slot, each entry added by the one thread that owns
// it, slab after slab (the slot stays in L2), and a second kernel adds the
// slots in block order. No sum depends on scheduling. Q adds 1 complex
// multiply and 3 reductions per amplitude, and 2 x 2 A x 128 + 2 x 128 x 128
// floats of outputs.
//
// Reduced storage (the TPU kernel's f32_of / store_as at diag.py:117-150):
// the backward's B is stored as f32, bf16 or f16 (bkind, common.cuh codec;
// F stays f32), read and written four elements at a time (8 bytes for a
// 16-bit B), decoded to f32 before the multiply and the Q reductions. The
// backward then moves 24 bytes per amplitude against 32.
//
// "bf16" storage: the forward planes may be stored as bf16 too (the sweep's
// x and the backward's F, with or without the Q reductions; the kind a
// template parameter so that the f32 sweeps keep their float4 code),
// decoded on load (Q takes the decoded F, as the TPU kernel's f32_of at
// diag.py:117-120) and rounded on store, 8 bytes per amplitude for the
// sweep against 16.

#include "common.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;
using dqc::load4;
using dqc::store4;

constexpr int kThreads = 256;

__device__ __forceinline__ void diag4(const DiagTables& d, int64_t a, int s,
                                      int l0, float (&dr)[4], float (&di)[4]) {
  const int64_t as = a * dqc::kGroup + s;
  const float tas_r = __ldg(d.as_r + as), tas_i = __ldg(d.as_i + as);
  const float4 alr = __ldg(reinterpret_cast<const float4*>(d.al_r + a * dqc::kGroup + l0));
  const float4 ali = __ldg(reinterpret_cast<const float4*>(d.al_i + a * dqc::kGroup + l0));
  const float4 slr = __ldg(reinterpret_cast<const float4*>(d.sl_r + s * dqc::kGroup + l0));
  const float4 sli = __ldg(reinterpret_cast<const float4*>(d.sl_i + s * dqc::kGroup + l0));
  const float al_r[4] = {alr.x, alr.y, alr.z, alr.w};
  const float al_i[4] = {ali.x, ali.y, ali.z, ali.w};
  const float sl_r[4] = {slr.x, slr.y, slr.z, slr.w};
  const float sl_i[4] = {sli.x, sli.y, sli.z, sli.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float mr, mi;
    cmul(tas_r, tas_i, al_r[k], al_i[k], mr, mi);
    cmul(mr, mi, sl_r[k], sl_i[k], dr[k], di[k]);
  }
}

// x[e] *= D at float4 index e of the planes (4 lanes of one (a, s) row).
__device__ __forceinline__ void times_diag(float* xr, float* xi,
                                           const DiagTables& d, int64_t e) {
  const int64_t a = e >> 12;              // 128 * 32 float4s per slab
  const int s = (int)((e >> 5) & 127);
  const int l0 = (int)(e & 31) * 4;
  float dr[4], di[4];
  diag4(d, a, s, l0, dr, di);
  float4* pr = reinterpret_cast<float4*>(xr) + e;
  float4* pi = reinterpret_cast<float4*>(xi) + e;
  const float4 vr = *pr, vi = *pi;
  const float ar[4] = {vr.x, vr.y, vr.z, vr.w};
  const float ai[4] = {vi.x, vi.y, vi.z, vi.w};
  float yr[4], yi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) cmul(ar[k], ai[k], dr[k], di[k], yr[k], yi[k]);
  *pr = make_float4(yr[0], yr[1], yr[2], yr[3]);
  *pi = make_float4(yi[0], yi[1], yi[2], yi[3]);
}

// x[e] *= D at float4 index e of planes stored as kind.
__device__ __forceinline__ void times_diag_kind(void* xr, void* xi, int kind,
                                                const DiagTables& d,
                                                int64_t e) {
  const int64_t a = e >> 12;
  const int s = (int)((e >> 5) & 127);
  const int l0 = (int)(e & 31) * 4;
  float dr[4], di[4], ar[4], ai[4], yr[4], yi[4];
  diag4(d, a, s, l0, dr, di);
  load4(xr, e, kind, ar);
  load4(xi, e, kind, ai);
#pragma unroll
  for (int k = 0; k < 4; ++k) cmul(ar[k], ai[k], dr[k], di[k], yr[k], yi[k]);
  store4(xr, e, kind, yr);
  store4(xi, e, kind, yi);
}

// x[e] *= D at float4 index e of planes stored as KIND (known at compile
// time: the f32 planes keep times_diag's float4 code).
template <int KIND>
__device__ __forceinline__ void times_diag_of(void* xr, void* xi,
                                              const DiagTables& d, int64_t e) {
  if constexpr (KIND == dqc::kStoreF32)
    times_diag(static_cast<float*>(xr), static_cast<float*>(xi), d, e);
  else
    times_diag_kind(xr, xi, KIND, d, e);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
diag_sweep_kernel(void* xr, void* xi, DiagTables d, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads)
    times_diag_of<KIND>(xr, xi, d, e);
}

template <int FKIND>
__global__ void __launch_bounds__(kThreads)
diag_backward_kernel(void* fr, void* fi, void* br, void* bi, int bkind,
                     DiagTables dinv, DiagTables dfwd, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads) {
    times_diag_of<FKIND>(fr, fi, dinv, e);
    times_diag_kind(br, bi, bkind, dfwd, e);
  }
}

constexpr int kRows = 128 / (kThreads / 32);  // rows of a slab per warp

template <int FKIND>
__global__ void __launch_bounds__(kThreads)
diag_backward_q_kernel(void* fr, void* fi, void* br, void* bi, int bkind,
                       DiagTables dinv, DiagTables dfwd, float* qas_r,
                       float* qas_i, float* qal_r, float* qal_i, float* part,
                       int64_t A) {
  __shared__ float colr[kThreads / 32][dqc::kGroup];
  __shared__ float coli[kThreads / 32][dqc::kGroup];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = 4 * lane;
  float* slot = part + (int64_t)blockIdx.x * 2 * dqc::kGroup * dqc::kGroup;
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    float cr[4] = {0.f, 0.f, 0.f, 0.f}, ci[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int k = 0; k < kRows; ++k) {
      const int s = warp + (kThreads / 32) * k;
      const int64_t e = (a * dqc::kGroup + s) * 32 + lane;  // float4 index
      float far[4], fai[4], bar[4], bai[4];
      load4(fr, e, FKIND, far);
      load4(fi, e, FKIND, fai);
      load4(br, e, bkind, bar);
      load4(bi, e, bkind, bai);
      float qr[4], qi[4], rr = 0.f, ri = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cmul(bar[j], bai[j], far[j], fai[j], qr[j], qi[j]);
        rr += qr[j];
        ri += qi[j];
        cr[j] += qr[j];
        ci[j] += qi[j];
      }
      float4* sr = reinterpret_cast<float4*>(slot + s * dqc::kGroup + l0);
      float4* si = reinterpret_cast<float4*>(slot + dqc::kGroup * dqc::kGroup +
                                             s * dqc::kGroup + l0);
      float4 vr = *sr, vi = *si;
      vr.x += qr[0]; vr.y += qr[1]; vr.z += qr[2]; vr.w += qr[3];
      vi.x += qi[0]; vi.y += qi[1]; vi.z += qi[2]; vi.w += qi[3];
      *sr = vr;
      *si = vi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rr += __shfl_xor_sync(0xffffffffu, rr, off);
        ri += __shfl_xor_sync(0xffffffffu, ri, off);
      }
      if (lane == 0) {
        qas_r[a * dqc::kGroup + s] = rr;
        qas_i[a * dqc::kGroup + s] = ri;
      }
      times_diag_of<FKIND>(fr, fi, dinv, e);
      times_diag_kind(br, bi, bkind, dfwd, e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      colr[warp][l0 + j] = cr[j];
      coli[warp][l0 + j] = ci[j];
    }
    __syncthreads();  // the column partials are complete
    if (threadIdx.x < dqc::kGroup) {
      const int l = threadIdx.x;
      float tr = 0.f, ti = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        tr += colr[w][l];
        ti += coli[w][l];
      }
      qal_r[a * dqc::kGroup + l] = tr;
      qal_i[a * dqc::kGroup + l] = ti;
    }
    __syncthreads();  // the partials are read before the next slab's
  }
}

int grid_for(int64_t n4) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;  // enough blocks in flight per SM
  return (int)(want < cap ? want : cap);
}

}  // namespace

// x <- x * D in place on planes (A, 128, 128) stored as kind (0 f32, 1
// bf16); the tables as in common.cuh, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dqc_diag_sweep(void* xr, void* xi, const float* sl_r,
                              const float* sl_i, const float* as_r,
                              const float* as_i, const float* al_r,
                              const float* al_i, long long A, int kind,
                              void* stream) {
  if (A <= 0 || kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  auto kernel = kind == dqc::kStoreF32 ? diag_sweep_kernel<dqc::kStoreF32>
                                       : diag_sweep_kernel<dqc::kStoreBF16>;
  kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(xr, xi, d, n4);
  return (int)cudaGetLastError();
}

// fwd <- fwd * Dinv, bwd <- bwd * D in place on planes (A, 128, 128): the six
// tables of the run's inverse, then the run's; bwd stored as bkind (0 f32,
// 1 bf16, 2 f16), fwd as fkind (0 f32, 1 bf16). Returns cudaGetLastError().
extern "C" int dqc_diag_backward(void* fr, void* fi, void* br, void* bi,
                                 const float* isl_r, const float* isl_i,
                                 const float* ias_r, const float* ias_i,
                                 const float* ial_r, const float* ial_i,
                                 const float* sl_r, const float* sl_i,
                                 const float* as_r, const float* as_i,
                                 const float* al_r, const float* al_i,
                                 long long A, int bkind, int fkind,
                                 void* stream) {
  if (A <= 0 || bkind < 0 || bkind > 2 || fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  auto kernel = fkind == dqc::kStoreF32 ? diag_backward_kernel<dqc::kStoreF32>
                                        : diag_backward_kernel<dqc::kStoreBF16>;
  kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      fr, fi, br, bi, bkind, dinv, dfwd, n4);
  return (int)cudaGetLastError();
}

// The backward with the Q reductions, taken before the update: qas_r/i and
// qal_r/i are (A, 128) outputs; part is scratch of nblk * 2 * 128 * 128
// floats set to zero by the caller (nblk blocks, at most A), qsl the
// (Qsl re, im) output, 2 x 128 x 128 floats; bwd stored as bkind, fwd as
// fkind (0 f32, 1 bf16). Returns cudaGetLastError().
extern "C" int dqc_diag_backward_q(void* fr, void* fi, void* br, void* bi,
                                   const float* isl_r, const float* isl_i,
                                   const float* ias_r, const float* ias_i,
                                   const float* ial_r, const float* ial_i,
                                   const float* sl_r, const float* sl_i,
                                   const float* as_r, const float* as_i,
                                   const float* al_r, const float* al_i,
                                   float* qas_r, float* qas_i, float* qal_r,
                                   float* qal_i, float* part, float* qsl,
                                   long long A, int nblk, int bkind,
                                   int fkind, void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A || bkind < 0 || bkind > 2 ||
      fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = fkind == dqc::kStoreF32 ? diag_backward_q_kernel<dqc::kStoreF32>
                                        : diag_backward_q_kernel<dqc::kStoreBF16>;
  kernel<<<nblk, kThreads, 0, s>>>(
      fr, fi, br, bi, bkind, dinv, dfwd, qas_r, qas_i, qal_r, qal_i, part,
      (int64_t)A);
  const int code = (int)cudaGetLastError();
  if (code != 0) return code;
  return dqc::launch_reduce(part, qsl, nblk, 2 * dqc::kGroup * dqc::kGroup, s);
}
