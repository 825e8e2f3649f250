// Fused diagonal-run sweep and its one-pass adjoint on f32 planes.
//
// Replaces the TPU kernels diag_sweep_planes (dqc_tpu/ops/pallas/diag.py:75,
// pallas_call at :90) and diag_backward_planes (:154, at :184) without its Q
// reductions (with_q = False). A run of commuting diagonal gates is one
// elementwise multiply by its total diagonal, factored over the plane axes
// (a = merged high groups, s = sublane, l = lane) as
// D[a, s, l] = (tas[a, s] tal[a, l]) tsl[s, l], the association order of the
// TPU kernels (common.cuh diag_at):
//
//   sweep:     x   *= D
//   backward:  fwd *= Dinv,  bwd *= D
//
// in place on planes (A, 128, 128).
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

#include "common.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;

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

__global__ void __launch_bounds__(kThreads)
diag_sweep_kernel(float* xr, float* xi, DiagTables d, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads)
    times_diag(xr, xi, d, e);
}

__global__ void __launch_bounds__(kThreads)
diag_backward_kernel(float* fr, float* fi, float* br, float* bi,
                     DiagTables dinv, DiagTables dfwd, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads) {
    times_diag(fr, fi, dinv, e);
    times_diag(br, bi, dfwd, e);
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

// x <- x * D in place on planes (A, 128, 128); the tables as in common.cuh,
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int dqc_diag_sweep(float* xr, float* xi, const float* sl_r,
                              const float* sl_i, const float* as_r,
                              const float* as_i, const float* al_r,
                              const float* al_i, long long A, void* stream) {
  if (A <= 0) return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  diag_sweep_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      xr, xi, d, n4);
  return (int)cudaGetLastError();
}

// fwd <- fwd * Dinv, bwd <- bwd * D in place on planes (A, 128, 128): the six
// tables of the run's inverse, then the run's. Returns cudaGetLastError().
extern "C" int dqc_diag_backward(float* fr, float* fi, float* br, float* bi,
                                 const float* isl_r, const float* isl_i,
                                 const float* ias_r, const float* ias_i,
                                 const float* ial_r, const float* ial_i,
                                 const float* sl_r, const float* sl_i,
                                 const float* as_r, const float* as_i,
                                 const float* al_r, const float* al_i,
                                 long long A, void* stream) {
  if (A <= 0) return (int)cudaErrorInvalidValue;
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  diag_backward_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      fr, fi, br, bi, dinv, dfwd, n4);
  return (int)cudaGetLastError();
}
