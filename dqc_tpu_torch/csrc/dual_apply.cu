// Dual-group apply on the planes: y = Em . X . El^T for every 128x128 slab,
// both products on the tensor cores.
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
// seed reads the forward planes and leaves them intact. x is stored as f32,
// bf16 (the forward planes under "bf16" storage) or f16 (the cotangent the
// per-term fallback of a dense cross-group gate hands it under "f16"), y as
// f32, bf16 or f16 (the seed's cotangent storage, common.cuh's codec; the
// TPU kernel's f32_of / store_as at dual_apply.py:109-113): the
// accumulator is decoded, added to in f32 and encoded.
//
// Bound: operations on the tensor cores. Each amplitude takes 2 x 128
// complex multiply-adds against 16 bytes moved (24 with an accumulator): in
// the "f32" dot mode as 3xTF32 (three tf32 passes per real product at 495
// TFLOP/s; the operator in three parts where it meets 16-bit x, exact in
// tf32: still three passes), in bf16x3 as three bf16 passes at 989 (two
// where x is bf16). At 29 qubits on f32 planes about a 6.7 ms floor against
// 2.6 ms of HBM traffic (on the CUDA cores' FP32 rate the same work was a
// 16.4 ms floor).
//
// Design: one block of 512 threads (16 warps) per slab, on
// csrc/tc_adjoint.cuh's tiles and product (its shared memory: the F and B
// tile places and the three-stage operator ring, 224 KB).
// 1. The block reads the whole slab before it writes anything (so y may be
//    x), decoding x and multiplying the run in when it comes first, as two
//    lane tiles (the tile at tc_tile(h) holds rows s = 64 h .. + 63 as
//    [l][s - 64 h], unpadded and XOR-swizzled), 16 bytes a thread a load,
//    a tile's loads of x and of the run's tables all in flight at once.
// 2. The lane product T = X El^T is separable by rows s: each lane tile
//    goes through tc_op_tile with El (its rows l contracted), which writes
//    T over the same rows.
// 3. The sublane product Em T then runs on the slab's two 64-column tiles
//    (tc_op_tile's SLAB form: the B fragments read T's rows s across both
//    lane tiles, the results go back to the places they came from).
// 4. The stores read the slab in the loads' order: the run when it
//    follows, the conjugate, the accumulator, y's storage rounding.
// Both operators come pre-split in mma fragment order (the wrapper's
// _tc.tc_operator: El, in three parts where 3xTF32 meets exact x; Em),
// streamed through the ring two k-steps a chunk (one in three parts), the
// first two chunks of each product issued before the loads or the product
// before it. Every k-step is summed from zero on the tensor cores and added
// on the CUDA cores (mma.cuh cmma3). T stays f32 in shared memory between
// the products, as the TPU kernel keeps it in VMEM.

#include "tc_adjoint.cuh"

namespace {

using dqc::DiagTables;
using dqc::TcRows;

constexpr int N = dqc::kGroup;

constexpr int kPer = dqc::kTcTileFloats / 4 / dqc::kAdjThreads;  // groups a thread

// This thread's groups j of four neighbouring elements of a lane tile, along
// l (tc_group on rows adjacent in the planes): one l group x for all j, the
// tile's columns c[j] (s = 64 h + c[j]).
__device__ __forceinline__ void dual_groups(int& x, int (&c)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) dqc::tc_group(threadIdx.x + j * dqc::kAdjThreads, true, x, c[j]);
}

// The run's entries D[a, s, l] of this thread's groups of lane tile h, as
// adjoint.cuh's diag_group forms each ((tas tal) tsl): every table load of
// the tile in flight at once (tal shared by the groups), so that a tile
// waits on the tables once.
__device__ __forceinline__ void dual_run(const DiagTables& d, int64_t a, int h, int x,
                                         const int (&c)[kPer], float (&dr)[kPer][4],
                                         float (&di)[kPer][4]) {
  const int64_t al = a * N + x;
  const float4 alr = __ldg(reinterpret_cast<const float4*>(d.al_r + al));
  const float4 ali = __ldg(reinterpret_cast<const float4*>(d.al_i + al));
  float asr[kPer], asi[kPer];
  float4 slr[kPer], sli[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = 64 * h + c[j];
    asr[j] = __ldg(d.as_r + a * N + s);
    asi[j] = __ldg(d.as_i + a * N + s);
    slr[j] = __ldg(reinterpret_cast<const float4*>(d.sl_r + s * N + x));
    sli[j] = __ldg(reinterpret_cast<const float4*>(d.sl_i + s * N + x));
  }
  const float lr[4] = {alr.x, alr.y, alr.z, alr.w}, li[4] = {ali.x, ali.y, ali.z, ali.w};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float tr[4] = {slr[j].x, slr[j].y, slr[j].z, slr[j].w};
    const float ti[4] = {sli[j].x, sli[j].y, sli[j].z, sli[j].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float mr, mi;
      dqc::cmul(asr[j], asi[j], lr[q], li[q], mr, mi);
      dqc::cmul(mr, mi, tr[q], ti[q], dr[j][q], di[j][q]);
    }
  }
}

// x (xkind; XK >= 0 fixes it at compile time) -> the slab as two lane
// tiles, times the run when it comes first: a tile's loads of x and of the
// run's tables all in flight before its first shared-memory store.
template <int XK>
__device__ __noinline__ void dual_load_slab(const char* xr, const char* xi, int xkind,
                                            int run_first, const DiagTables& d, int64_t a) {
  if constexpr (XK >= 0) xkind = XK;
  const int xsize = xkind == dqc::kStoreF32 ? 4 : 2;
  int x, c[kPer];
  dual_groups(x, c);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const char* gr = xr + (64 * h * N) * xsize;
    const char* gi = xi + (64 * h * N) * xsize;
    float vr[kPer][4], vi[kPer][4];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t e4 = dqc::tc_at(x, c[j], 1, N, 0, 6) >> 2;
      dqc::load4(gr, e4, xkind, vr[j]);
      dqc::load4(gi, e4, xkind, vi[j]);
    }
    if (run_first) {
      float dr[kPer][4], di[kPer][4];
      dual_run(d, a, h, x, c, dr, di);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dqc::cmul(vr[j][q], vi[j][q], dr[j][q], di[j][q], vr[j][q], vi[j][q]);
    }
    float* tr = dqc::tc_tile(h);
    float* ti = tr + dqc::kTcTileFloats;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tr[TcRows::at(x + q, c[j])] = vr[j][q];
        ti[TcRows::at(x + q, c[j])] = vi[j][q];
      }
  }
}

// The slab (in the F and B tile places) -> y (ykind), with the run when it
// follows, the conjugate and the accumulator (y's values before the store),
// in the loads' order: a tile's accumulator and table loads all in flight
// before its first store.
__device__ __noinline__ void dual_store_slab(char* yr, char* yi, int ykind,
                                             int run_after, const DiagTables& d,
                                             int64_t a, int conj, int has_acc) {
  const int ysize = ykind == dqc::kStoreF32 ? 4 : 2;
  int x, c[kPer];
  dual_groups(x, c);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const float* tr = dqc::tc_tile(h);
    const float* ti = tr + dqc::kTcTileFloats;
    char* gr = yr + (64 * h * N) * ysize;
    char* gi = yi + (64 * h * N) * ysize;
    float pr[kPer][4], pi[kPer][4];
    if (has_acc) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t e4 = dqc::tc_at(x, c[j], 1, N, 0, 6) >> 2;
        dqc::load4(gr, e4, ykind, pr[j]);
        dqc::load4(gi, e4, ykind, pi[j]);
      }
    }
    float dr[kPer][4], di[kPer][4];
    if (run_after) dual_run(d, a, h, x, c, dr, di);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float vr[4], vi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = tr[TcRows::at(x + q, c[j])];
        vi[q] = ti[TcRows::at(x + q, c[j])];
        if (run_after) dqc::cmul(vr[q], vi[q], dr[j][q], di[j][q], vr[q], vi[q]);
        if (conj) vi[q] = -vi[q];
        if (has_acc) {
          vr[q] += pr[j][q];
          vi[q] += pi[j][q];
        }
      }
      const int64_t e4 = dqc::tc_at(x, c[j], 1, N, 0, 6) >> 2;
      dqc::store4(gr, e4, ykind, vr);
      dqc::store4(gi, e4, ykind, vi);
    }
  }
}

// op_l: El pre-split for MODE (three parts with three_l); op_m: Em.
template <int MODE>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
dual_apply_tc_kernel(const char* xr, const char* xi, char* yr, char* yi,
                     int xkind, int ykind, const uint32_t* __restrict__ op_l,
                     const uint32_t* __restrict__ op_m, int three_l, DiagTables d,
                     int has_diag, int diag_first, int conj, int has_acc) {
  const int64_t a = blockIdx.x;
  const int xsize = xkind == dqc::kStoreF32 ? 4 : 2;
  const int ysize = ykind == dqc::kStoreF32 ? 4 : 2;
  const char* sxr = xr + a * N * N * xsize;
  const char* sxi = xi + a * N * N * xsize;
  const bool run_first = has_diag && diag_first;
  uint32_t* ring = dqc::tc_ring();

  // 1. the slab as two lane tiles, times the run if it comes first
  dqc::tc_prefetch_op<MODE>(ring, op_l, three_l);
  if (xkind == dqc::kStoreF32)
    dual_load_slab<dqc::kStoreF32>(sxr, sxi, xkind, run_first, d, a);
  else
    dual_load_slab<-1>(sxr, sxi, xkind, run_first, d, a);
  // x's lo parts are zero: 16-bit x in 3xTF32 (El then in three parts), bf16
  // x in bf16x3; a run multiplied in leaves f32 values
  const bool x_exact = !run_first && (MODE == dqc::kTf32x3 ? xkind != dqc::kStoreF32
                                                           : xkind == dqc::kStoreBF16);

  // 2. T = X El^T, lane tile by lane tile
  dqc::tc_op_tile_op<MODE>(op_l, 0, x_exact, three_l, dqc::kStoreF32);
  dqc::tc_prefetch_op<MODE>(ring, op_l, three_l);
  dqc::tc_op_tile_op<MODE>(op_l, 1, x_exact, three_l, dqc::kStoreF32);

  // 3. Em T, column tile by column tile
  dqc::tc_prefetch<MODE>(ring, op_m);
  dqc::tc_op_tile<MODE, 4, true>(op_m, 0, false, dqc::kStoreF32);
  dqc::tc_prefetch<MODE>(ring, op_m);
  dqc::tc_op_tile<MODE, 4, true>(op_m, 1, false, dqc::kStoreF32);
  __syncthreads();  // the slab is complete

  // 4. the run when it follows, the seed modes, the store
  dual_store_slab(yr + a * N * N * ysize, yi + a * N * N * ysize, ykind,
                  has_diag && !diag_first, d, a, conj, has_acc);
}

}  // namespace

// On planes (A, 128, 128): y <- [acc +] conj?([D] Em x El^T [D]). y may be
// x (in place, ykind = xkind); with has_acc, y holds the accumulator and is
// added to. x is stored as xkind (0 f32, 1 bf16, 2 f16), y as ykind (0 f32,
// 1 bf16, 2 f16): x f32 into any y, bf16 into bf16 or f16 into f16. x3:
// the products in bf16x3, else 3xTF32. op_l = El and op_m = Em pre-split in
// mma fragment order for that mode (ops/kernels/_tc.tc_operator), op_l in
// three parts (three_l) where 3xTF32 meets 16-bit x and no run comes first.
// The six table pointers may be null when has_diag is 0; the planes are
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int dqc_dual_apply(const void* xr, const void* xi, void* yr,
                              void* yi, int xkind, int ykind,
                              const uint32_t* op_l, const uint32_t* op_m,
                              int three_l, const float* sl_r, const float* sl_i,
                              const float* as_r, const float* as_i,
                              const float* al_r, const float* al_i,
                              int has_diag, int diag_first, int conj,
                              int has_acc, int x3, long long A, void* stream) {
  const bool three = !x3 && xkind != dqc::kStoreF32 && !(has_diag && diag_first);
  if (A <= 0 || A > 0x7fffffffLL || xkind < 0 || xkind > 2 || ykind < 0 ||
      ykind > 2 || (three_l != 0) != three)
    return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  auto kernel = x3 ? dual_apply_tc_kernel<dqc::kBf16x3>
                   : dual_apply_tc_kernel<dqc::kTf32x3>;
  constexpr int kSmem = dqc::kTcAdjSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)A, dqc::kAdjThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const char*>(xr), static_cast<const char*>(xi),
      static_cast<char*>(yr), static_cast<char*>(yi), xkind, ykind, op_l, op_m,
      three_l, d, has_diag, diag_first, conj, has_acc);
  return (int)cudaGetLastError();
}
