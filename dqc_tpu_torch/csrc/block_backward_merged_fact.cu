// Kronecker-factorized one-pass adjoint on the merged top axis.
//
// Replaces the TPU kernel block_backward_merged_fact
// (dqc_tpu/ops/pallas/block_backward.py:670, body _kernel_mtop_fact :534,
// pallas_call at :740): the adjoint of merged_fact_apply (a sweep of
// Et (x) El, Xt = 2 or 4, Xl = 128, on the merged view (A1, Xt Xl, Q = M 128),
// merged row x = t Xl + d). On the forward planes F and the cotangent planes
// B, in place:
//
//   F <- (Eti (x) Eli) F                 (uncompute)
//   B <- (Et^T (x) El^T) B               (cotangent transport)
//   T0_low[x, y] = sum_{e, c} B[(e, x), c] ((I (x) Eli) F)[(e, y), c]
//   T0_top[x, y] = sum_{d, c} B[(x, d), c] ((Eti (x) I) F)[(y, d), c]
//
// with the incoming F and B, holomorphic (no conjugation), summed over every
// column.
//
// Bound: operations. The uncompute and the transport take Xl + Xt complex
// multiply-adds per amplitude each and the two pair grams Xl + Xt: about
// 3 (Xl + Xt) (8 real flops each) against 32 bytes read and written, ~100
// flop per byte, above the H100's FP32 ridge (~20 flop/B). f32 FMA on the
// CUDA cores, no TF32.
//
// Design: csrc/adjoint.cuh's X = 128 step on tiles of 128 rows x 64 "product
// columns" (slice a, column c at a 64 / Xt + c; 64 / Xt consecutive columns
// of one i): the low factor is the X = 128 step with Eli and El, its pair
// gram over all 64 product columns is T0_low, and the top factor is a pass
// of Xt x Xt complex combinations over the shared-memory tile before the
// store. T0_top needs F with only the top factor uncomputed; it is linear in
// F, so T0_top = P Eti^T with P[x, b] = sum B[(x, d), c] F[(b, d), c], the
// slice gram of the raw tiles, taken right after the load. Each warp adds
// its P into its own slot (one writer per entry, program order), the low
// pair gram goes to the block's slot as in adjoint.cuh, and second kernels
// add the slots in a fixed order: the result does not depend on scheduling.

#include "adjoint.cuh"

namespace {

using dqc::AdjCfg;
using dqc::Operators;
using dqc::cmac;
using dqc::kAdjThreads;

using Cfg = AdjCfg<128>;
constexpr int XL = 128;
constexpr int PC = Cfg::C;               // 64 product columns
constexpr int LD = Cfg::LD;
constexpr int kWarps = kAdjThreads / 32;

template <int XT>
__device__ __forceinline__ void warp_sum_to_slot(float (&pr)[XT][XT],
                                                 float (&pi)[XT][XT],
                                                 float* slot) {
#pragma unroll
  for (int x = 0; x < XT; ++x)
#pragma unroll
    for (int b = 0; b < XT; ++b) {
      float r = pr[x][b], i = pi[x][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        r += __shfl_down_sync(0xffffffffu, r, off);
        i += __shfl_down_sync(0xffffffffu, i, off);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(slot + x * XT + b, r);
        atomicAdd(slot + XT * XT + x * XT + b, i);
      }
    }
}

template <int XT>
__global__ void __launch_bounds__(kAdjThreads, 1)
block_backward_merged_fact_kernel(float* fr, float* fi, float* br, float* bi,
                                  Operators low, const float* __restrict__ eti_r,
                                  const float* __restrict__ eti_i,
                                  const float* __restrict__ et_r,
                                  const float* __restrict__ et_i,
                                  float* part_low, float* part_top, int64_t Q,
                                  int64_t ntiles) {
  constexpr int C = PC / XT;  // columns of each slice
  extern __shared__ float smem[];
  float* sFr = smem;
  float* sFi = sFr + XL * LD;
  float* sBr = sFi + XL * LD;
  float* sBi = sBr + XL * LD;
  float* sOr = sBi + XL * LD;   // the transport's result
  float* sOi = sOr + XL * LD;
  const int half = threadIdx.x / dqc::kHalf;
  float* sTr = sOi + XL * LD + half * 2 * Cfg::KC * XL;  // this half's
  float* sTi = sTr + Cfg::KC * XL;                       // operator tile
  float* slot_low = part_low + (int64_t)blockIdx.x * Cfg::kSlotFloats;
  float* slot_top =
      part_top + ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) * 2 * XT * XT;
  float accr[8][4], acci[8][4];

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * C;
    const int64_t i = g0 / Q;
    const int64_t q0 = g0 - i * Q;
    const int64_t base = i * XT * XL * Q + q0;

    // 1. load F and B: product column p = a C + c is slice a, column c
    __syncthreads();  // the previous tile's stores have read the buffers
    for (int e = threadIdx.x; e < XL * PC; e += kAdjThreads) {
      const int d = e / PC, p = e % PC;
      const int64_t o = base + (int64_t)((p / C) * XL + d) * Q + p % C;
      sFr[d * LD + p] = fr[o];
      sFi[d * LD + p] = fi[o];
      sBr[d * LD + p] = br[o];
      sBi[d * LD + p] = bi[o];
    }
    __syncthreads();

    // 2. the slice gram P[x, b] of the raw tiles, into this warp's slot
    {
      float pr[XT][XT], pi[XT][XT];
#pragma unroll
      for (int x = 0; x < XT; ++x)
#pragma unroll
        for (int b = 0; b < XT; ++b) pr[x][b] = pi[x][b] = 0.f;
      for (int e = threadIdx.x; e < XL * C; e += kAdjThreads) {
        const int d = e / C, c = e % C;
        float f_r[XT], f_i[XT];
#pragma unroll
        for (int b = 0; b < XT; ++b) {
          f_r[b] = sFr[d * LD + b * C + c];
          f_i[b] = sFi[d * LD + b * C + c];
        }
#pragma unroll
        for (int x = 0; x < XT; ++x) {
          const float b_r = sBr[d * LD + x * C + c], b_i = sBi[d * LD + x * C + c];
#pragma unroll
          for (int b = 0; b < XT; ++b) cmac(pr[x][b], pi[x][b], b_r, b_i, f_r[b], f_i[b]);
        }
      }
      warp_sum_to_slot<XT>(pr, pi, slot_top);
    }

    // 3. first half: Eli F (the low uncompute); second half: El^T B
    dqc::op_times_tile<XL>(half ? low.e_r : low.inv_r, half ? low.e_i : low.inv_i,
                           half, half ? sBr : sFr, half ? sBi : sFi, sTr, sTi,
                           accr, acci);
    __syncthreads();  // every thread is done reading F
    dqc::acc_to_tile<XL>(accr, acci, half ? sOr : sFr, half ? sOi : sFi);
    __syncthreads();  // (I (x) Eli) F and (I (x) El^T) B are complete

    // 4. T0_low: the pair gram of the incoming B and (I (x) Eli) F
    dqc::pair_gram<XL>(sBr, sBi, sFr, sFi, slot_low);
    __syncthreads();  // the pair gram has read F

    // 5. the top factor: F <- (Eti (x) I) F, B <- (Et^T (x) I) B
    for (int e = threadIdx.x; e < XL * C; e += kAdjThreads) {
      const int d = e / C, c = e % C;
      float f_r[XT], f_i[XT], b_r[XT], b_i[XT];
#pragma unroll
      for (int b = 0; b < XT; ++b) {
        f_r[b] = sFr[d * LD + b * C + c];
        f_i[b] = sFi[d * LD + b * C + c];
        b_r[b] = sOr[d * LD + b * C + c];
        b_i[b] = sOi[d * LD + b * C + c];
      }
#pragma unroll
      for (int a = 0; a < XT; ++a) {
        float yr = 0.f, yi = 0.f, zr = 0.f, zi = 0.f;
#pragma unroll
        for (int b = 0; b < XT; ++b) {
          cmac(yr, yi, __ldg(eti_r + a * XT + b), __ldg(eti_i + a * XT + b),
               f_r[b], f_i[b]);
          cmac(zr, zi, __ldg(et_r + b * XT + a), __ldg(et_i + b * XT + a),
               b_r[b], b_i[b]);
        }
        sFr[d * LD + a * C + c] = yr;
        sFi[d * LD + a * C + c] = yi;
        sOr[d * LD + a * C + c] = zr;
        sOi[d * LD + a * C + c] = zi;
      }
    }
    __syncthreads();

    // 6. the store, in the load's order
    for (int e = threadIdx.x; e < XL * PC; e += kAdjThreads) {
      const int d = e / PC, p = e % PC;
      const int64_t o = base + (int64_t)((p / C) * XL + d) * Q + p % C;
      fr[o] = sFr[d * LD + p];
      fi[o] = sFi[d * LD + p];
      br[o] = sOr[d * LD + p];
      bi[o] = sOi[d * LD + p];
    }
  }
}

// T0_top[x, y] = sum_b P[x, b] Eti[y, b], P the sum of the nslots slice-gram
// slots in slot order; one thread per entry.
template <int XT>
__global__ void top_finish_kernel(const float* __restrict__ part_top,
                                  int64_t nslots, const float* __restrict__ eti_r,
                                  const float* __restrict__ eti_i,
                                  float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= XT * XT) return;
  const int x = k / XT, y = k % XT;
  float tr = 0.f, ti = 0.f;
  for (int b = 0; b < XT; ++b) {
    float pr = 0.f, pi = 0.f;
    for (int64_t s = 0; s < nslots; ++s) {
      pr += part_top[s * 2 * XT * XT + x * XT + b];
      pi += part_top[s * 2 * XT * XT + XT * XT + x * XT + b];
    }
    cmac(tr, ti, pr, pi, eti_r[y * XT + b], eti_i[y * XT + b]);
  }
  out[k] = tr;
  out[XT * XT + k] = ti;
}

template <int XT>
int launch(float* fr, float* fi, float* br, float* bi, const Operators& low,
           const float* eti_r, const float* eti_i, const float* et_r,
           const float* et_i, float* part_low, float* part_top, float* t0_low,
           float* t0_top, long long A1, long long Q, int nblk,
           cudaStream_t stream) {
  constexpr int C = PC / XT;
  if (Q % C != 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = A1 * (Q / C);
  if (ntiles <= 0 || nblk <= 0 || nblk > ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_backward_merged_fact_kernel<XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  block_backward_merged_fact_kernel<XT><<<nblk, kAdjThreads, Cfg::kSmemBytes,
                                          stream>>>(
      fr, fi, br, bi, low, eti_r, eti_i, et_r, et_i, part_low, part_top,
      (int64_t)Q, (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)dqc::launch_reduce(part_low, t0_low, nblk,
                                        Cfg::kSlotFloats, stream);
  if (err != cudaSuccess) return (int)err;
  top_finish_kernel<XT><<<1, 32, 0, stream>>>(part_top, (int64_t)nblk * kWarps,
                                              eti_r, eti_i, t0_top);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of slice-gram slots per block (the caller sizes part_top:
// nblk * warps * 2 * Xt * Xt floats).
extern "C" int dqc_block_backward_merged_fact_warps() { return kWarps; }

// In place on the merged view (A1, Xt 128, Q = M 128), Xt in {2, 4}: (F, B)
// <- the factorized adjoint step; t0_low = (T0_low re, im), 2 x 128 x 128
// floats, and t0_top = (T0_top re, im), 2 x Xt x Xt. part_low is scratch of
// nblk * 2 * 128 * 128 floats and part_top of nblk * warps * 2 * Xt * Xt,
// both set to zero by the caller; nblk is the number of blocks (at most the
// number of tiles, A1 Q Xt / 64). Returns cudaGetLastError().
extern "C" int dqc_block_backward_merged_fact(
    float* fr, float* fi, float* br, float* bi, const float* eli_r,
    const float* eli_i, const float* el_r, const float* el_i,
    const float* eti_r, const float* eti_i, const float* et_r,
    const float* et_i, float* part_low, float* part_top, float* t0_low,
    float* t0_top, long long A1, int XT, long long Q, int nblk, void* stream) {
  const Operators low{eli_r, eli_i, el_r, el_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (XT) {
    case 2: return launch<2>(fr, fi, br, bi, low, eti_r, eti_i, et_r, et_i,
                             part_low, part_top, t0_low, t0_top, A1, Q, nblk, s);
    case 4: return launch<4>(fr, fi, br, bi, low, eti_r, eti_i, et_r, et_i,
                             part_low, part_top, t0_low, t0_top, A1, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
