// Kronecker-factorized apply on the merged top axis: y = (Et (x) El) x,
// the low factor on the tensor cores.
//
// Replaces the TPU kernel merged_fact_apply_planes
// (dqc_tpu/ops/pallas/high_apply.py:190, body _kernel_fact :148, pallas_call
// at :215). When the top group is tiny (Xt = 2 or 4 wide), a dense block on
// it and one on the group below (Xl = 128) run as one sweep on the merged
// view (A1, Xt Xl, Q = M 128), merged row x = t Xl + d: the low factor El
// acts within each top slice t, the top factor Et mixes the Xt slices
// elementwise. The Kronecker product is never expanded.
//
// Bound: operations. Xl complex multiply-adds per amplitude on the tensor
// cores (3xTF32 in the "f32" dot mode: three tf32 passes per real product
// at 495 TFLOP/s; bf16x3: three bf16 passes at 989) and Xt more on the CUDA
// cores (the top factor, f32 at 67 TFLOP/s), against 16 bytes moved (8 on
// bf16 planes). At 29 qubits on f32 planes, Xt = 2: ~3.3 ms of tensor-core
// passes and ~0.13 ms of f32 top factor against 2.6 ms of HBM traffic.
//
// Design: the two factors commute, y_a = El (sum_b Et[a, b] x_b), so the
// top factor is applied on the load. A block of 512 threads (16 warps)
// takes 64 / Xt consecutive columns (all of one i) of each of the Xt
// slices, the "product columns" (slice a, column c at a 64 / Xt + c) of a
// 128 x 64 tile of csrc/tc_adjoint.cuh (unpadded, XOR-swizzled):
// 1. it reads the Xt slices of its columns, 16 bytes a thread a load, all
//    of a thread's loads in flight at once, forms their Xt combinations in
//    f32 on the CUDA cores (as the TPU kernel's VPU combinations) and
//    writes them into the tile, before it writes anything to the planes (so
//    the sweep is in place);
// 2. tc_op_tile runs El on the tile on mma.sync (3xTF32 or bf16x3, each
//    k-step summed from zero and added on the CUDA cores: mma.cuh cmma3),
//    El pre-split in fragment order by the wrapper (_tc.tc_operator) and
//    streamed through the three-stage cp.async ring, its first two chunks
//    issued before the loads;
// 3. the tile goes back to the slices (tc_store_tile on tc_at's slice
//    stride), rounded to the planes' storage.
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// and its dot_mode): the planes may be stored as bf16 (kind: decoded on
// load, rounded to nearest even on store) and the low factor's product may
// run bf16x3; the top factor stays f32, as the TPU kernel's VPU
// combinations. The combined values are f32 whatever the storage, so the
// product reads their lo parts.

#include "tc_adjoint.cuh"

namespace {

using dqc::TcRows;

constexpr int XL = dqc::kGroup;

// The Xt slices of the block's columns (base: slice 0, row 0, column 0;
// element (t, d, c) at base[(t XL + d) Q + c]), combined by Et as they are
// read, into the F tile: product column a C + c of row d is sum_b Et[a, b]
// x[b, d, c].
template <int XT>
__device__ __noinline__ void merged_load_top(const char* xr, const char* xi, int kind,
                                             int64_t Q, const float* __restrict__ et_r,
                                             const float* __restrict__ et_i) {
  constexpr int C = TcRows::C / XT;
  constexpr int kPer = XL * C / 4 / dqc::kAdjThreads;  // groups of four a thread
  static_assert(kPer * 4 * dqc::kAdjThreads == XL * C, "whole groups");
  const int size = kind == dqc::kStoreF32 ? 4 : 2;
  float* vr = dqc::tc_tile(dqc::kTileF);
  float* vi = vr + dqc::kTcTileFloats;
  float xr4[kPer][XT][4], xi4[kPer][XT][4];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * dqc::kAdjThreads;
    const int d = e / (C / 4), c = 4 * (e % (C / 4));
#pragma unroll
    for (int b = 0; b < XT; ++b) {
      const int64_t o = ((int64_t)(b * XL + d) * Q + c) * size;
      dqc::load4(xr + o, 0, kind, xr4[j][b]);
      dqc::load4(xi + o, 0, kind, xi4[j][b]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * dqc::kAdjThreads;
    const int d = e / (C / 4), c = 4 * (e % (C / 4));
#pragma unroll
    for (int a = 0; a < XT; ++a) {
      float zr[4] = {0.f, 0.f, 0.f, 0.f}, zi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int b = 0; b < XT; ++b) {
        const float er = __ldg(et_r + a * XT + b), ei = __ldg(et_i + a * XT + b);
#pragma unroll
        for (int q = 0; q < 4; ++q) dqc::cmac(zr[q], zi[q], er, ei, xr4[j][b][q], xi4[j][b][q]);
      }
      const int o = TcRows::at(d, a * C + c);
      *reinterpret_cast<float4*>(vr + o) = make_float4(zr[0], zr[1], zr[2], zr[3]);
      *reinterpret_cast<float4*>(vi + o) = make_float4(zi[0], zi[1], zi[2], zi[3]);
    }
  }
}

// One block per tile of 64 / Xt columns of one i in each slice; op is El
// pre-split for MODE.
template <int XT, int MODE>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
merged_fact_apply_tc_kernel(char* xr, char* xi, int kind,
                            const uint32_t* __restrict__ op,
                            const float* __restrict__ et_r,
                            const float* __restrict__ et_i, int64_t Q) {
  constexpr int C = TcRows::C / XT;
  constexpr int cshift = XT == 2 ? 5 : 4;  // log2(C)
  const int size = kind == dqc::kStoreF32 ? 4 : 2;
  const int64_t g0 = (int64_t)blockIdx.x * C;
  const int64_t i = g0 / Q;
  const int64_t t = (i * XT * XL * Q + (g0 - i * Q)) * size;

  dqc::tc_prefetch<MODE>(dqc::tc_ring(), op);
  merged_load_top<XT>(xr + t, xi + t, kind, Q, et_r, et_i);
  dqc::tc_op_tile<MODE>(op, dqc::kTileF, false, dqc::kStoreF32);
  __syncthreads();  // the tile is complete
  const dqc::DiagView none{};
  const int64_t ss = (int64_t)XL * Q - C;  // tc_at's slice stride
  if (kind == dqc::kStoreF32)
    dqc::tc_store_tile<dqc::kStoreF32, false>(xr + t, xi + t, kind, Q, 1, ss, cshift,
                                              dqc::kTileF, 0, none);
  else
    dqc::tc_store_tile<-1, false>(xr + t, xi + t, kind, Q, 1, ss, cshift,
                                  dqc::kTileF, 0, none);
}

template <int XT, int MODE>
int launch(void* xr, void* xi, int kind, const uint32_t* op, const float* et_r,
           const float* et_i, long long A1, long long Q, cudaStream_t stream) {
  constexpr int C = TcRows::C / XT, kSmem = dqc::kTcAdjSmemBytes;
  if (Q % C != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = A1 * (Q / C);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = merged_fact_apply_tc_kernel<XT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, dqc::kAdjThreads, kSmem, stream>>>(
      static_cast<char*>(xr), static_cast<char*>(xi), kind, op, et_r, et_i,
      (int64_t)Q);
  return (int)cudaGetLastError();
}

}  // namespace

// In place on the merged view (A1, Xt 128, Q = M 128), Xt in {2, 4}:
// x <- (Et (x) El) x; op = El (128 x 128) pre-split in mma fragment order
// for the low product's mode (ops/kernels/_tc.tc_operator; x3: bf16x3, else
// 3xTF32), Et (Xt x Xt) as f32 real/imag planes; x stored as kind (0 f32,
// 1 bf16), 16-byte aligned. Returns cudaGetLastError().
extern "C" int dqc_merged_fact_apply(void* xr, void* xi, const uint32_t* op,
                                     const float* et_r, const float* et_i,
                                     long long A1, int XT, long long Q, int kind,
                                     int x3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind < 0 || kind > 1 || (XT != 2 && XT != 4)) return (int)cudaErrorInvalidValue;
  constexpr int F = dqc::kTf32x3, H = dqc::kBf16x3;
  auto fn = XT == 2 ? (x3 ? launch<2, H> : launch<2, F>)
                    : (x3 ? launch<4, H> : launch<4, F>);
  return fn(xr, xi, kind, op, et_r, et_i, A1, Q, s);
}
