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
// Bound: operations. The low factor takes Xl complex multiply-adds per
// amplitude for each of the uncompute, the transport and T0_low, on the
// tensor cores (3xTF32 in the "f32" dot mode: three tf32 passes per real
// product at 495 TFLOP/s; bf16x3: three bf16 passes at 989; a pass fewer
// where a planes operand's lo parts are zero); the top factor and T0_top 3 Xt
// more on the CUDA cores (f32, 67 TFLOP/s); against 32 bytes read and
// written per amplitude (24 / 16 with 16-bit planes). At 29 qubits on f32
// planes with the default bf16x3 T0_low: ~8.3 ms of tensor-core passes and
// ~0.4 ms of f32 top factor against 5.1 ms of HBM traffic.
//
// Design: tc_adjoint.cuh's one-pass step (the high adjoint's at X = 128) on
// tiles of 128 rows d x 64 "product columns" (slice a, column c at a 64 / Xt
// + c: 64 / Xt consecutive columns of one i in each of the Xt slices, tc_at's
// slice stride Xl Q - 64 / Xt): its low factor is the step's uncompute with
// Eli and transport with El^T (both pre-split by the wrapper, streamed
// through the cp.async ring), its pair gram over all 64 product columns is
// T0_low, into the block's slot. Two passes of this kernel's own hook into
// the step (MergedTop), on the tiles in shared memory:
// * after the load, the slice gram of the raw tiles P[x, b] = sum B[(x, d),
//   c] F[(b, d), c]: T0_top needs F with only the top factor uncomputed, and
//   is linear in F, so T0_top = P Eti^T. Each warp adds its P into its own
//   slot (one writer per entry, program order);
// * before the stores, the top factor: F <- (Eti (x) I) F, B <- (Et^T (x) I)
//   B, a pass of Xt x Xt complex combinations in place, each thread holding
//   one (d, c) across the Xt slices.
// Second kernels add the slots in a fixed order: the result does not depend
// on scheduling.
//
// Reduced storage and the dot modes (the TPU kernel's f32_of / store_as,
// dot_mode, bwd_dot_mode and gram_dot_mode at block_backward.py:627-629,
// :643-645): B is stored as f32, bf16 or f16 (bkind) and F as f32 or bf16
// (fkind), both read at run time at the loads and stores only; the low
// uncompute runs bf16x3 with dot_x3, the low transport with bwd_x3 and
// T0_low with gram_x3, else 3xTF32, each independently. The top factor and
// T0_top stay f32 whatever the modes, as the TPU kernel keeps them on the
// VPU at Xt <= 4.

#include "tc_adjoint.cuh"

namespace {

using dqc::cmac;
using dqc::kAdjThreads;
using dqc::TcOps;
using dqc::TcRows;

constexpr int XL = dqc::kGroup;
constexpr int kWarps = kAdjThreads / 32;

// P[x, b] += sum over the tile of B[(x, d), c] F[(b, d), c] (the raw tiles,
// product column p = a C + c of slice a), into this warp's slot: each thread
// sums its (d, c), the warp adds its 32 sums by shuffles and lane 0 adds
// them to the slot.
template <int XT>
__device__ __noinline__ void merged_slice_gram(float* slot) {
  constexpr int C = TcRows::C / XT;
  const float* sFr = dqc::tc_tile(dqc::kTileF);
  const float* sFi = sFr + dqc::kTcTileFloats;
  const float* sBr = dqc::tc_tile(dqc::kTileB);
  const float* sBi = sBr + dqc::kTcTileFloats;
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
      const int o = TcRows::at(d, b * C + c);
      f_r[b] = sFr[o];
      f_i[b] = sFi[o];
    }
#pragma unroll
    for (int x = 0; x < XT; ++x) {
      const int o = TcRows::at(d, x * C + c);
      const float b_r = sBr[o], b_i = sBi[o];
#pragma unroll
      for (int b = 0; b < XT; ++b) cmac(pr[x][b], pi[x][b], b_r, b_i, f_r[b], f_i[b]);
    }
  }
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

// The top factor on the tiles, in place: F <- (Eti (x) I) F, B <- (Et^T (x)
// I) B; each thread reads the Xt slices of its (d, c) before it writes them.
template <int XT>
__device__ __noinline__ void merged_top_factor(const float* __restrict__ eti_r,
                                               const float* __restrict__ eti_i,
                                               const float* __restrict__ et_r,
                                               const float* __restrict__ et_i) {
  constexpr int C = TcRows::C / XT;
  float* sFr = dqc::tc_tile(dqc::kTileF);
  float* sFi = sFr + dqc::kTcTileFloats;
  float* sBr = dqc::tc_tile(dqc::kTileB);
  float* sBi = sBr + dqc::kTcTileFloats;
  for (int e = threadIdx.x; e < XL * C; e += kAdjThreads) {
    const int d = e / C, c = e % C;
    float f_r[XT], f_i[XT], b_r[XT], b_i[XT];
#pragma unroll
    for (int b = 0; b < XT; ++b) {
      const int o = TcRows::at(d, b * C + c);
      f_r[b] = sFr[o];
      f_i[b] = sFi[o];
      b_r[b] = sBr[o];
      b_i[b] = sBi[o];
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
      const int o = TcRows::at(d, a * C + c);
      sFr[o] = yr;
      sFi[o] = yi;
      sBr[o] = zr;
      sBi[o] = zi;
    }
  }
}

// The merged top's slices and passes in the tensor-core step
// (tc_adjoint_tile's Top).
template <int XT>
struct MergedTop {
  int64_t ss;                 // tc_at's slice stride: Xl Q - 64 / Xt
  static constexpr int cshift = XT == 2 ? 5 : 4;  // log2(64 / Xt)
  float* slot;                // this warp's slice-gram slot
  const float* eti_r;
  const float* eti_i;
  const float* et_r;
  const float* et_i;
  __device__ __forceinline__ void after_load() const {
    __syncthreads();  // the raw tiles are loaded
    merged_slice_gram<XT>(slot);
  }
  __device__ __forceinline__ void before_store() const {
    merged_top_factor<XT>(eti_r, eti_i, et_r, et_i);
    __syncthreads();  // the stores read other threads' results
  }
};

// Each block walks the tiles tile = block, block + gridDim.x, ...: 64 / Xt
// columns of one i in each of the Xt slices, a step of tc_adjoint.cuh with
// this kernel's two passes (no run, no staging); one T0_low slot per block
// and one slice-gram slot per warp.
template <int XT, int UM, int TM, bool GX3>
__global__ void __launch_bounds__(kAdjThreads, 1)
block_backward_merged_fact_kernel(char* fr, char* fi, char* br, char* bi,
                                  int bkind, int fkind, TcOps ops,
                                  const float* eti_r, const float* eti_i,
                                  const float* et_r, const float* et_i,
                                  float* part_low, float* part_top, int64_t Q,
                                  int64_t ntiles) {
  constexpr int C = TcRows::C / XT;
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  float* slot = part_low + (int64_t)blockIdx.x * 2 * XL * XL;
  const MergedTop<XT> top{
      (int64_t)XL * Q - C,
      part_top + ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) * 2 * XT * XT,
      eti_r, eti_i, et_r, et_i};
  const dqc::DiagView none{};
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * C;
    const int64_t i = g0 / Q;
    const int64_t t = i * XT * XL * Q + (g0 - i * Q);
    dqc::tc_adjoint_tile<UM, TM, GX3>(
        fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize, bkind,
        fkind, 0, Q, 1, ops, 0, none, none, slot,
        static_cast<const dqc::QHigh*>(nullptr), top);
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

template <int XT, int UM, int TM, bool GX3>
int launch(char* fr, char* fi, char* br, char* bi, int bkind, int fkind,
           const TcOps& ops, const float* eti_r, const float* eti_i,
           const float* et_r, const float* et_i, float* part_low,
           float* part_top, float* t0_low, float* t0_top, long long A1,
           long long Q, int nblk, cudaStream_t stream) {
  constexpr int C = TcRows::C / XT, kSmem = dqc::kTcAdjSmemBytes;
  if (Q % C != 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = A1 * (Q / C);
  if (ntiles <= 0 || nblk <= 0 || nblk > ntiles) return (int)cudaErrorInvalidValue;
  auto kernel = block_backward_merged_fact_kernel<XT, UM, TM, GX3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kAdjThreads, kSmem, stream>>>(
      fr, fi, br, bi, bkind, fkind, ops, eti_r, eti_i, et_r, et_i, part_low,
      part_top, (int64_t)Q, (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)dqc::launch_reduce(part_low, t0_low, nblk, 2 * XL * XL,
                                        stream);
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
// floats, and t0_top = (T0_top re, im), 2 x Xt x Xt. op_inv = Eli pre-split
// in the uncompute's mode (dot_x3), op_t = El^T in the transport's (bwd_x3)
// (ops/kernels/_tc.tc_operator, in three parts where 3xTF32 meets a 16-bit F
// or B); eti / et are the top factor's Eti and Et (f32). part_low is scratch
// of nblk * 2 * 128 * 128 floats and part_top of nblk * warps * 2 * Xt * Xt,
// both set to zero by the caller; nblk is the number of blocks (at most the
// number of tiles, A1 Q Xt / 64). B is stored as bkind (0 f32, 1 bf16, 2
// f16), F as fkind (0 f32, 1 bf16); dot_x3 / bwd_x3 / gram_x3 run the low
// uncompute / transport / T0_low bf16x3, else 3xTF32. The planes are
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int dqc_block_backward_merged_fact(
    void* fr, void* fi, void* br, void* bi, const uint32_t* op_inv,
    const uint32_t* op_t, const float* eti_r, const float* eti_i,
    const float* et_r, const float* et_i, float* part_low, float* part_top,
    float* t0_low, float* t0_top, long long A1, int XT, long long Q, int nblk,
    int bkind, int bwd_x3, int gram_x3, int fkind, int dot_x3, void* stream) {
  if (bkind < 0 || bkind > 2 || fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  constexpr int F = dqc::kTf32x3, H = dqc::kBf16x3;
  using Fn = int (*)(char*, char*, char*, char*, int, int, const TcOps&,
                     const float*, const float*, const float*, const float*,
                     float*, float*, float*, float*, long long, long long, int,
                     cudaStream_t);
#define DQC_MF_TABLE(XX)                                                   \
  {launch<XX, F, F, false>, launch<XX, F, F, true>, launch<XX, F, H, false>, \
   launch<XX, F, H, true>, launch<XX, H, F, false>, launch<XX, H, F, true>,  \
   launch<XX, H, H, false>, launch<XX, H, H, true>}
  static const Fn table[2][8] = {DQC_MF_TABLE(2), DQC_MF_TABLE(4)};
#undef DQC_MF_TABLE
  if (XT != 2 && XT != 4) return (int)cudaErrorInvalidValue;
  const int k = 4 * (dot_x3 != 0) + 2 * (bwd_x3 != 0) + (gram_x3 != 0);
  return table[XT == 4][k](
      static_cast<char*>(fr), static_cast<char*>(fi), static_cast<char*>(br),
      static_cast<char*>(bi), bkind, fkind, TcOps{op_inv, op_t}, eti_r, eti_i,
      et_r, et_i, part_low, part_top, t0_low, t0_top, A1, Q, nblk,
      (cudaStream_t)stream);
}
