// Shared device helpers of the dqc_tpu_torch kernels (complex arithmetic on
// real/imag float pairs, the factored diagonal run of ops/planes.py, the
// cotangent planes' storage codec, the bf16x3 operand split and cp.async
// copies).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
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

// The run's D at element (i, x, q) of the high view (A1, X, Q = M 128):
// q = (p 128 + s) 128 + l, the tables' row a = (i X + x) post + p.
__device__ __forceinline__ void view_diag(const DiagTables& d, int64_t i,
                                          int X, int x, int64_t q,
                                          int64_t post, float& dr, float& di) {
  const int l = (int)(q & 127);
  const int s = (int)((q >> 7) & 127);
  const int64_t p = q >> 14;
  diag_at(d, (i * X + x) * post + p, s, l, dr, di);
}

// --- Storage of the cotangent planes -------------------------------------
//
// The counterpart of dqc_tpu/ops/pallas/common.py f32_of / store_as (and of
// ops/kernels/_storage.py, the plain versions' copy). A plane is stored as
// float32 (kStoreF32), bfloat16 (kStoreBF16, round to nearest even) or
// float16 bits (kStoreF16) in the JAX package's codec, which is not IEEE
// half conversion: the encode clamps to +-65504 and stores every |x| < 2^-14
// as a signed zero (the TPU flushes the f32 denormal its exponent rebias
// makes), rounding to nearest even elsewhere; the decode reads subnormal
// patterns as signed zeros and exponent 31 as 2^16 (1 + m / 1024). Compute
// is f32 throughout: loads decode, stores encode.
enum : int { kStoreF32 = 0, kStoreBF16 = 1, kStoreF16 = 2 };

__device__ __forceinline__ float f16_bits_to_f32(uint32_t u) {
  uint32_t bits = ((u & 0x7FFFu) << 13) | ((u & 0x8000u) << 16);
  if ((u & 0x7C00u) == 0) bits &= 0x80000000u;  // subnormal: signed zero
  return __uint_as_float(bits) * 0x1p112f;
}

__device__ __forceinline__ uint16_t f32_to_f16_bits(float v) {
  if (v != v) return (uint16_t)0x7E00u;  // NaN stays NaN
  const float c = fminf(fmaxf(v, -65504.f), 65504.f);
  const uint32_t sign = (__float_as_uint(c) >> 16) & 0x8000u;
  if (fabsf(c) < 0x1p-14f) return (uint16_t)sign;  // the flushed band
  uint32_t mag = __float_as_uint(c * 0x1p-112f) & 0x7FFFFFFFu;
  mag = mag + 0x0FFFu + ((mag >> 13) & 1u);  // RTNE on the 13 dropped bits
  return (uint16_t)(sign | (mag >> 13));
}

__device__ __forceinline__ float load_plane(const void* p, int64_t i,
                                            int kind) {
  if (kind == kStoreF32) return static_cast<const float*>(p)[i];
  const uint32_t h = static_cast<const uint16_t*>(p)[i];
  if (kind == kStoreBF16) return __uint_as_float(h << 16);
  return f16_bits_to_f32(h);
}

__device__ __forceinline__ void store_plane(void* p, int64_t i, float v,
                                            int kind) {
  if (kind == kStoreF32) {
    static_cast<float*>(p)[i] = v;
  } else if (kind == kStoreBF16) {
    static_cast<uint16_t*>(p)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    static_cast<uint16_t*>(p)[i] = f32_to_f16_bits(v);
  }
}

// The four elements at float4 index e of a plane stored as kind (a kind known
// at compile time folds the branches away), and their store.
__device__ __forceinline__ void load4(const void* p, int64_t e, int kind,
                                      float (&v)[4]) {
  if (kind == kStoreF32) {
    const float4 f = reinterpret_cast<const float4*>(p)[e];
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    return;
  }
  const uint2 u = reinterpret_cast<const uint2*>(p)[e];
  const uint32_t h[4] = {u.x & 0xFFFFu, u.x >> 16, u.y & 0xFFFFu, u.y >> 16};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = kind == kStoreBF16 ? __uint_as_float(h[k] << 16)
                              : f16_bits_to_f32(h[k]);
}

__device__ __forceinline__ void store4(void* p, int64_t e, int kind,
                                       const float (&v)[4]) {
  if (kind == kStoreF32) {
    reinterpret_cast<float4*>(p)[e] = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  uint32_t h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = kind == kStoreBF16
               ? (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[k]))
               : (uint32_t)f32_to_f16_bits(v[k]);
  reinterpret_cast<uint2*>(p)[e] = make_uint2(h[0] | (h[1] << 16),
                                              h[2] | (h[3] << 16));
}

// The value a store then a load give: v rounded to the storage.
__device__ __forceinline__ float quantize(float v, int kind) {
  if (kind == kStoreF32) return v;
  if (kind == kStoreBF16)
    return __bfloat162float(__float2bfloat16_rn(v));
  return f16_bits_to_f32(f32_to_f16_bits(v));
}

// --- bf16x3 ---------------------------------------------------------------
//
// The counterpart of dqc_tpu/ops/pallas/dots.py _dot_bf16x3: hi = bf16(a),
// lo = bf16(a - hi), and a b ~ ah bh + ah bl + al bh accumulated in f32.
// The kernels take it as ah (bh + bl) + al bh, two FMAs: every product of
// those parts is exact in f32 (bh + bl has at most 16 significant bits), so
// the sum is the three-pass one with only the accumulation rounding.
__device__ __forceinline__ float bf16_hi(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// a -> (hi, lo), the left operand's parts.
__device__ __forceinline__ void split_hl(float a, float& hi, float& lo) {
  hi = bf16_hi(a);
  lo = bf16_hi(a - hi);
}

// b -> (hi, hi + lo), the right operand's parts.
__device__ __forceinline__ void split_hs(float b, float& hi, float& s) {
  hi = bf16_hi(b);
  s = hi + bf16_hi(b - hi);
}

// One operator entry into a shared operator tile: as it is, or (TX3) as its hi
// and lo bf16 parts.
template <bool TX3>
__device__ __forceinline__ void stage_op(float wr, float wi, int at, float* tr,
                                         float* ti, float* tlr, float* tli) {
  if constexpr (TX3) {
    split_hl(wr, tr[at], tlr[at]);
    split_hl(wi, ti[at], tli[at]);
  } else {
    tr[at] = wr;
    ti[at] = wi;
  }
}

// acc += (ar + i ai)(br + i bi) in bf16x3, the left operand as (hi, lo)
// parts, the right as (hi, hi + lo).
__device__ __forceinline__ void cmac3(float& accr, float& acci, float arh,
                                      float arl, float aih, float ail,
                                      float brh, float brs, float bih,
                                      float bis) {
  accr = fmaf(arh, brs, accr);
  accr = fmaf(arl, brh, accr);
  accr = fmaf(-aih, bis, accr);
  accr = fmaf(-ail, bih, accr);
  acci = fmaf(arh, bis, acci);
  acci = fmaf(arl, bih, acci);
  acci = fmaf(aih, brs, acci);
  acci = fmaf(ail, brh, acci);
}

// --- cp.async: 16-byte copies from global to shared memory -------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- Bulk copies (the Tensor Memory Accelerator) and mbarriers ---------

// An mbarrier in shared memory expecting `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)), "r"(count)
               : "memory");
}
// Makes initialised mbarriers visible to the bulk copies.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"((unsigned)__cvta_generic_to_shared(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory in one bulk copy, which completes that many bytes of the
// transaction count of `bar` (set by the issuing thread's arrive.expect_tx).
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
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
