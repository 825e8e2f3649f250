// High-group apply at X = 8..64 on the tensor cores, streamed: y <- [acc +]
// conj?([D] E x [D]) along X of the view (A1, X, Q = M 128).
//
// Replaces, with high_apply.cu (X = 128, 256, 512), the TPU kernel
// high_group_apply_planes (dqc_tpu/ops/pallas/high_apply.py:76, pallas_call
// at :133) on the narrow high groups: group 2 at n = 17-20, group 3 at
// n = 24-27 and the CNOT ring's X = 8 span views. A dense operator E (X x
// X) on the contracted axis of the high view, with an optional diagonal run
// multiplied before (diag_first) or after the product, and the seed modes
// of the gradient: conj(y), y added into accumulator planes (has_acc), and
// output planes other than the input. x is stored as f32, bf16 (the forward
// planes under "bf16") or f16 (the cotangent the per-term fallback of a
// dense cross-group gate hands it under "f16"), y as f32, bf16 or f16 (the
// TPU kernel's f32_of / store_as); the product runs in 3xTF32 (the "f32"
// dot mode) or bf16x3. The run's tables are read in their canonical layout
// (tsl (128, 128), tas / tal (A, 128)) at a = (i X + x) post + p for view
// element (i, x, m = p 128 + s, l), four entries at once (adjoint.cuh
// diag_group).
//
// Bound: bytes. X complex multiply-adds per amplitude (8 at X = 8, 64 at
// X = 64) against 16 bytes read and written (24 with an accumulator, 8 on
// 16-bit planes): three tf32 passes (495 TFLOP/s) or bf16 passes (989) of
// them stay under the bytes' time for every X <= 64 (2.56 ms at 2^29 f32
// amplitudes in place), so the design keeps HBM busy and the product off
// the CUDA cores.
//
// Design (small_x.cuh's tiles, as the X = 8..64 adjoint step walks them):
// blocks of 256 threads (8 warps), as many an SM as fit, each walking tiles
// of 2048 amplitudes: X rows at stride Q by C = 2048 / X contiguous
// columns, all of one i.
// 1. E comes pre-split in mma fragment order (the wrapper's _tc.tc_operator
//    in the dot mode; X = 8 as diag(E, E); in three tf32 parts where 3xTF32
//    meets 16-bit x that no run multiplies first) and is copied into shared
//    memory once per block (at most 96 KB, X = 64 in three parts).
// 2. Each tile's raw planes go to a stage of a two-stage ring in shared
//    memory in 16-byte cp.async copies, issued two tiles ahead: they fly
//    while the tiles before them decode, multiply and store. The block
//    decodes the stage into its f32 working tile (16 bytes of f32 or 8 of
//    16-bit values a thread, times the run's entries when it comes first)
//    and refills the stage with the tile two on.
// 3. The product on mma.sync (mma.cuh cmma3: each k-step summed from zero
//    and added on the CUDA cores; the pass that reads x's zero lo parts
//    skipped): E is the A fragment (X / 16 m-tiles, K = X), the tile's
//    columns are N, each warp one m-tile by 16 columns in registers. X = 8
//    runs as 16 rows: the tile's two halves of 128 columns stacked under
//    diag(E, E).
// 4. The results go back over the working tile; the stores read it in the
//    loads' order, 16 (f32) or 8 bytes a thread: the run when it follows,
//    the conjugate, the accumulator (read from y), y's storage rounding.
// Each tile is read whole before it is written, so y may be x. The storage
// kinds and the modes are run-time arguments (a uniform branch each per
// tile), so that one kernel per X builds.
#include "small_x.cuh"

namespace {

using dqc::DiagTables;
using dqc::DiagView;

constexpr int kStages = 2;   // tiles in flight ahead of the one computed

struct HaArgs {
  const char* x[2];       // x re, im
  char* y[2];             // y re, im (x itself in place; the accumulator)
  const uint32_t* op;     // E pre-split for the dot mode
  DiagTables d;
  int64_t Q, post, ntiles;
  int xkind, ykind;
  int x3;                 // bf16x3, else 3xTF32
  int three;              // E in three parts (3xTF32 on exact x)
  int op_words;           // E's 32-bit words in shared memory
  int has_diag, diag_first, conj, has_acc;
};

// The block's n-th tile: false past its last, else its (i, q0) and first
// element t0 = i X Q + q0 of the planes.
template <int X>
__device__ __forceinline__ bool ha_tile(int64_t n, const HaArgs& a, int64_t& i,
                                        int64_t& q0, int64_t& t0) {
  const int64_t grp = blockIdx.x + n * gridDim.x;
  if (grp >= a.ntiles) return false;
  const int64_t g0 = grp * SmTile<X>::C;
  i = g0 / a.Q;
  q0 = g0 - i * a.Q;
  t0 = i * X * a.Q + q0;
  return true;
}

// The copies of the block's n-th tile into a stage (each plane's X rows of
// C elements, 16 bytes a cp.async), or none past its last tile; one
// cp.async group either way.
template <int X>
__device__ __forceinline__ void ha_issue(char* stage, const HaArgs& a, int64_t n) {
  constexpr int C = SmTile<X>::C;
  int64_t i, q0, t0;
  if (ha_tile<X>(n, a, i, q0, t0)) {
    const int es = elem_bytes(a.xkind);
    const int chunks = C * es / 16;  // of a row
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const char* src = a.x[p] + t0 * es;
      char* dst = stage + p * kSmTile * es;
      for (int e = threadIdx.x; e < X * chunks; e += kSmThreads) {
        const int x = e / chunks, ch = e % chunks;
        dqc::cp_async16(dst + x * C * es + 16 * ch, src + x * a.Q * es + 16 * ch);
      }
    }
  }
  dqc::cp_async_commit();
}

// The stage -> the f32 working tile (W: re, then im), times the run's
// entries with run.
template <int X>
__device__ __forceinline__ void ha_decode(const HaArgs& a, const char* stage,
                                          float* W, bool run, const DiagView& dv) {
  constexpr int C = SmTile<X>::C, J = kSmTile / 4 / kSmThreads;
  const int kind = a.xkind, es = elem_bytes(kind);
  float vr[J][4], vm[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    int x, c;
    sm_group<X>(j, x, c);
    dqc::load4(stage, (x * C + c) >> 2, kind, vr[j]);
    dqc::load4(stage + kSmTile * es, (x * C + c) >> 2, kind, vm[j]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    int x, c;
    sm_group<X>(j, x, c);
    if (run) {
      float dr[4], di[4];
      dqc::diag_group<true>(dv, x, c, dr, di);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dqc::cmul(vr[j][q], vm[j][q], dr[q], di[q], vr[j][q], vm[j][q]);
    }
    const int o = SmView<X>::at(x, c);
    *reinterpret_cast<float4*>(W + o) = make_float4(vr[j][0], vr[j][1], vr[j][2], vr[j][3]);
    *reinterpret_cast<float4*>(W + kSmTile + o) =
        make_float4(vm[j][0], vm[j][1], vm[j][2], vm[j][3]);
  }
}

// The working tile -> y at element t0: times the run's entries with run,
// conjugated with conj, added to y's values with has_acc (their loads all
// in flight first), encoded to y's storage.
template <int X>
__device__ __forceinline__ void ha_store(const HaArgs& a, int64_t t0, const float* W,
                                         bool run, const DiagView& dv) {
  constexpr int J = kSmTile / 4 / kSmThreads;
  const int kind = a.ykind, es = elem_bytes(kind);
  char* yr = a.y[0] + t0 * es;
  char* yi = a.y[1] + t0 * es;
  float pr[J][4], pi[J][4];
  if (a.has_acc) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int x, c;
      sm_group<X>(j, x, c);
      const int64_t e4 = (x * a.Q + c) >> 2;
      dqc::load4(yr, e4, kind, pr[j]);
      dqc::load4(yi, e4, kind, pi[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    int x, c;
    sm_group<X>(j, x, c);
    const int o = SmView<X>::at(x, c);
    const float4 r4 = *reinterpret_cast<const float4*>(W + o);
    const float4 i4 = *reinterpret_cast<const float4*>(W + kSmTile + o);
    float vr[4] = {r4.x, r4.y, r4.z, r4.w}, vm[4] = {i4.x, i4.y, i4.z, i4.w};
    float dr[4], di[4];
    if (run) dqc::diag_group<true>(dv, x, c, dr, di);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (run) dqc::cmul(vr[q], vm[q], dr[q], di[q], vr[q], vm[q]);
      if (a.conj) vm[q] = -vm[q];
      if (a.has_acc) {
        vr[q] += pr[j][q];
        vm[q] += pi[j][q];
      }
    }
    const int64_t e4 = (x * a.Q + c) >> 2;
    dqc::store4(yr, e4, kind, vr);
    dqc::store4(yi, e4, kind, vm);
  }
}

template <int X>
__global__ void __launch_bounds__(kSmThreads, 2)
high_apply_small_kernel(const HaArgs a) {
  using Cfg = SmTile<X>;
  extern __shared__ float4 ha_smem4[];  // 16-byte aligned
  uint32_t* s_op = reinterpret_cast<uint32_t*>(ha_smem4);
  float* W = reinterpret_cast<float*>(s_op + a.op_words);  // re, im
  char* stages = reinterpret_cast<char*>(W + 2 * kSmTile);
  const int stage_bytes = 2 * kSmTile * elem_bytes(a.xkind);
  const int warp = threadIdx.x >> 5;
  const int pm = warp / Cfg::CB, pn = 16 * (warp % Cfg::CB);  // this warp's m-tile, columns

  // E, once
  for (int e = threadIdx.x; e < a.op_words / 4; e += kSmThreads)
    dqc::cp_async16(s_op + 4 * e, a.op + 4 * e);
  dqc::cp_async_commit();
  const bool run_first = a.has_diag && a.diag_first;
  const bool run_after = a.has_diag && !a.diag_first;
  // x's lo parts are zero: 16-bit x in 3xTF32 (E then in three parts), bf16
  // x in bf16x3; a run multiplied in first leaves f32 values
  const bool x_exact = !run_first && (a.x3 ? a.xkind == dqc::kStoreBF16
                                            : a.xkind != kStoreF32);
#pragma unroll
  for (int k = 0; k < kStages; ++k) ha_issue<X>(stages + k * stage_bytes, a, k);

  int64_t i, q0, t0;
  for (int64_t n = 0; ha_tile<X>(n, a, i, q0, t0); ++n) {
    const DiagView dv{a.d, 2, i, q0, X, a.post};
    char* stage = stages + (int)(n % kStages) * stage_bytes;
    dqc::cp_async_wait<kStages - 1>();
    __syncthreads();  // E and this tile are in; the last tile's stores read W
    ha_decode<X>(a, stage, W, run_first, dv);
    __syncthreads();  // the tile is in W; its stage is free
    ha_issue<X>(stage, a, n + kStages);
    float pr[2][4], pi[2][4];
    if (a.x3)
      sm_product<X, kBf16x3>(s_op, false, W, W + kSmTile, x_exact, pm, pn, pr, pi);
    else
      sm_product<X, kTf32x3>(s_op, a.three, W, W + kSmTile, x_exact, pm, pn, pr, pi);
    __syncthreads();  // every warp is done reading x
    sm_put<X>(W, W + kSmTile, pm, pn, pr, pi);
    __syncthreads();  // the product is complete
    ha_store<X>(a, t0, W, run_after, dv);
  }
  dqc::cp_async_wait<0>();  // no copy outlives the block
}

template <int X>
int launch_small(HaArgs& a, long long A1, cudaStream_t stream) {
  using Cfg = SmTile<X>;
  if (a.Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  a.ntiles = A1 * (a.Q / Cfg::C);
  if (a.ntiles <= 0) return (int)cudaErrorInvalidValue;
  a.op_words = op_words(Cfg::XR, a.x3, a.three);
  const int bytes = 4 * (a.op_words + 2 * kSmTile) +
                    kStages * 2 * kSmTile * elem_bytes(a.xkind);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = high_apply_small_kernel<X>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the SMs hold at once, each walking its share of tiles
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nblk = a.ntiles < (long long)per_sm * sms ? a.ntiles
                                                             : (long long)per_sm * sms;
  kernel<<<(unsigned)nblk, kSmThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// On the view (A1, X, Q = M 128), X in {8, 16, 32, 64}: y <- [acc +]
// conj?([D] E x [D]). y may be x (in place, of one storage); with has_acc,
// y holds the accumulator and is added to. x is stored as xkind, y as ykind
// (0 f32, 1 bf16, 2 f16). x3: the product in bf16x3, else 3xTF32. op is E
// pre-split for that mode (ops/kernels/_tc.tc_operator; X = 8 as diag(E,
// E), 16 x 16), in three parts (three) exactly where 3xTF32 meets 16-bit x
// and no run comes first. Q must be a multiple of 2048 / X, with has_diag of
// 128 * 128; the planes and the tables are 16-byte aligned, and the six
// table pointers may be null when has_diag is 0. Returns cudaGetLastError().
extern "C" int dqc_high_apply_small(const void* xr, const void* xi, void* yr,
                                    void* yi, int xkind, int ykind,
                                    const uint32_t* op, int three,
                                    const float* sl_r, const float* sl_i,
                                    const float* as_r, const float* as_i,
                                    const float* al_r, const float* al_i,
                                    int has_diag, int diag_first, int conj,
                                    int has_acc, int x3, long long A1, int X,
                                    long long Q, void* stream) {
  const bool want_three = !x3 && xkind != kStoreF32 && !(has_diag && diag_first);
  if (xkind < 0 || xkind > 2 || ykind < 0 || ykind > 2 ||
      (xr == yr && xkind != ykind) || (has_diag && Q % (128 * 128) != 0) ||
      (three != 0) != want_three || A1 <= 0)
    return (int)cudaErrorInvalidValue;
  HaArgs a{};
  a.x[0] = static_cast<const char*>(xr);
  a.x[1] = static_cast<const char*>(xi);
  a.y[0] = static_cast<char*>(yr);
  a.y[1] = static_cast<char*>(yi);
  a.op = op;
  a.d = DiagTables{sl_r, sl_i, as_r, as_i, al_r, al_i};
  a.Q = Q;
  a.post = Q >> 14;
  a.xkind = xkind;
  a.ykind = ykind;
  a.x3 = x3 != 0;
  a.three = three != 0;
  a.has_diag = has_diag;
  a.diag_first = diag_first;
  a.conj = conj;
  a.has_acc = has_acc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 8: return launch_small<8>(a, A1, s);
    case 16: return launch_small<16>(a, A1, s);
    case 32: return launch_small<32>(a, A1, s);
    case 64: return launch_small<64>(a, A1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
