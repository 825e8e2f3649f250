// Shared device helpers of the dqc_tpu_torch kernels (complex arithmetic on
// real/imag float pairs, and the factored diagonal run of ops/planes.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dqc {

constexpr int kGroup = 128;  // a full 7-bit qubit group (lane / sublane axis)

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// A diagonal run in factored form D[a, s, l] = tas[a, s] * tal[a, l] * tsl[s, l]
// (plane_scan._DiagFactors): tsl is (128, 128), tas and tal are (A, 128),
// all row-major f32 real/imag planes. `a` indexes the merged high groups.
struct DiagTables {
  const float* sl_r;
  const float* sl_i;
  const float* as_r;
  const float* as_i;
  const float* al_r;
  const float* al_i;
};

// D[a, s, l] in the same association order as the TPU kernels:
// (tas * tal) * tsl.
__device__ __forceinline__ void diag_at(const DiagTables& d, int64_t a, int s,
                                        int l, float& dr, float& di) {
  const int64_t as = a * kGroup + s, al = a * kGroup + l;
  const int sl = s * kGroup + l;
  float mr, mi;
  cmul(__ldg(d.as_r + as), __ldg(d.as_i + as), __ldg(d.al_r + al),
       __ldg(d.al_i + al), mr, mi);
  cmul(mr, mi, __ldg(d.sl_r + sl), __ldg(d.sl_i + sl), dr, di);
}

// out[e] = sum over slots s of part[s n2 + e], e < n2, in slot order: each
// of the 32 y-threads of a column of the block sums the slots s = ty mod 32
// in order, then thread ty = 0 adds the 32 sums in order.
__global__ void adjoint_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int64_t nslots,
                                      int n2) {
  __shared__ float acc[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (e < n2)
    for (int64_t s = threadIdx.y; s < nslots; s += 32)
      sum += part[s * n2 + e];
  acc[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && e < n2) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += acc[y][threadIdx.x];
    out[e] = total;
  }
}

inline int launch_reduce(const float* part, float* out, int64_t nslots, int n2,
                         cudaStream_t stream) {
  adjoint_reduce_kernel<<<(n2 + 31) / 32, dim3(32, 32), 0, stream>>>(
      part, out, nslots, n2);
  return (int)cudaGetLastError();
}

}  // namespace dqc

// The message of a code returned by a dqc_* entry point (each library is
// built from one source file, so each carries its own copy).
extern "C" const char* dqc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
