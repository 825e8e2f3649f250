// Group Gram of the planes: S = sum xr xr^T + xi xi^T and C = sum xr xi^T
// over every axis but one, for the view (P, X, Q) of the planes.
//
// Replaces the three TPU Gram kernels of dqc_tpu/ops/pallas/gram.py:
// gram_lane (:58, pallas_call at :70; view P = A 128, X = 128, Q = 1),
// gram_sublane (:97, at :109; view P = A, X = 128, Q = 128) and gram_high
// (:134, at :149; view P = A1, X, Q = M 128; X = 256 / 512 on the merged
// top axis of a tiny top group). The complex group Gram is
// G = S + i (C^T - C) (conj on the second factor), formed by the caller.
//
// Bound: operations. S is symmetric, so the function needs 2 X + 1 real
// multiply-adds per amplitude (X (X + 1) / 2 entries of S at two each, X^2
// of C, per column of X amplitudes) against 8 bytes read (4 on bf16 planes).
//
// X = 128, 256 and 512 run on the tensor cores (mma.sync through mma.cuh):
// the "f32" dot mode as 3xTF32, bf16x3 as three bf16 passes, and bf16
// planes, exact in both formats, as one bf16 pass whatever the mode. A
// block of 8 warps forms one 128 x 128 patch (bx, by) of the outputs over
// its group's 32-column tiles, each warp 32 x 64 of it (2 x 8 m16n8 tiles of
// S and of C in registers). S is formed as P + P^T: a patch's P takes the
// hi hi product at half weight and one of the two cross passes (hi lo for
// the xr xr^T term, lo hi for the xi xi^T one), so that P(bx, by) +
// P(by, bx)^T is the full three-pass product: 4 passes of S and 3 of C per
// 128 x 128 x k, against 6 and 3 that form S's patches one by one; every
// block does the same work. Each k-step is summed from zero and added to the
// f32 accumulators on the CUDA cores, rounded to nearest (the tensor cores'
// sums round toward zero). Tiles stream through a two-stage cp.async ring,
// rows padded so that every fragment read meets 32 banks; bf16 planes stay
// bf16 in shared memory, their pairs of neighbouring columns the bf16
// fragments' registers; the lane view (Q = 1), whose columns are rows of
// 128 in the planes, is kept [column][x]. Registers sum 8 tiles (256
// columns), then go to the block's partial slot (a running sum, one writer
// per entry); a second pass adds the slots in a fixed order and forms S =
// P + P^T: the result does not depend on scheduling, and no f32 sum runs
// over more than a few hundred terms of its own size.
//
// X = 8, 16, 32 and 64 run on the tensor cores too, one X x X patch a
// block: 8 warps, each a 32 x 32 block of the patch (16 x 16 at X = 16, 16 x
// 8 at X = 8, whose A fragments take 8 zero rows) over its share of each
// 128-column tile (64 at X = 64), the warps of one block of the patch
// splitting the tile's columns (8 ways, 2 at X = 64), each such k-group
// with its own partial slot. These views are bound by bytes (2 X + 1
// multiply-adds against 8 bytes; 4 on bf16 planes): the tiles stream
// through a three-stage cp.async ring, 16-byte copies, two blocks an SM.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

// --- X = 128, 256 and 512 on the tensor cores --------------------------------

using dqc::CFrag;
using dqc::kBf16x3;
using dqc::kTf32x3;

constexpr int kTcThreads = 256;  // 8 warps, each 32 x 64 of a 128 x 128 patch
constexpr int kTcCB = 32;        // columns a tile: the products' k
constexpr int kTcFlush = 8;      // tiles summed in registers before a flush

// The tiles of one launch: planes stored as KIND (f32, or bf16 kept bf16 in
// shared memory), products split for MODE, a patch of NRB x NRB; LANE: the
// view (P 128, 128, 1), whose tiles are kept [k][x] (a column of the view is
// a row of 128 in the planes), else [x][k]. Rows are padded so that every
// fragment read meets 32 banks (a bf16x2 register of a lane tile is two
// 16-bit reads, a row apart). A stage holds xr and xi of the patch's rows,
// then of its columns (off the diagonal).
template <int KIND, int MODE, bool LANE, int NRB>
struct TcGram {
  using T = std::conditional_t<KIND == dqc::kStoreF32, float, uint16_t>;
  static constexpr bool kLane = LANE;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int KS = MODE == kTf32x3 ? 8 : 16;  // k of one mma
  static constexpr bool kF32Bf16 = KIND == dqc::kStoreF32 && MODE == kBf16x3;
  static constexpr bool kF32Tf32 = KIND == dqc::kStoreF32 && MODE == kTf32x3;
  static constexpr int LD = LANE ? (kF32Bf16 ? 132 : 136) : kTcCB + (kF32Tf32 ? 4 : 8);
  static constexpr int kRows = LANE ? kTcCB : 128;  // rows of one array
  static constexpr int kCols = LANE ? 128 : kTcCB;  // elements a row holds
  static constexpr int kArr = kRows * LD;           // elements of one array
  static constexpr int kChunksRow = kCols * ES / 16;  // 16-byte copies a row
  static constexpr int kArrays = NRB == 1 ? 2 : 4;
  static constexpr int kStageBytes = kArrays * kArr * ES;
  static constexpr int kSmemBytes = 2 * kStageBytes;
  static_assert((LD * ES) % 16 == 0, "rows 16-byte aligned");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
  static __device__ __forceinline__ int at(int x, int k) {
    return LANE ? k * LD + x : x * LD + k;
  }
};

// The parts of element k of row x (tf32), or of the pair k, k + 1 (a bf16x2
// register): split from f32 values, or the bf16 values themselves (exact:
// their lo parts, zero, are never read).
template <class G>
__device__ __forceinline__ void tcg_part(const typename G::T* s, int x, int k,
                                         uint32_t& hi, uint32_t& lo) {
  if constexpr (!std::is_same<typename G::T, float>::value) {
    if constexpr (G::kLane)  // two rows apart
      hi = (uint32_t)s[G::at(x, k)] | ((uint32_t)s[G::at(x, k + 1)] << 16);
    else
      hi = *reinterpret_cast<const uint32_t*>(s + G::at(x, k));
    lo = 0u;
  } else if constexpr (G::KS == 8) {
    dqc::split_tf32(s[G::at(x, k)], hi, lo);
  } else {
    const float2 v = G::kLane
                         ? make_float2(s[G::at(x, k)], s[G::at(x, k + 1)])
                         : *reinterpret_cast<const float2*>(s + G::at(x, k));
    dqc::split_bf16x2(v, hi, lo);
  }
}

// The A fragment of rows row0 .. row0 + 15 at k0 (xr into re, xi into im)
// and the B fragment of rows n0 .. n0 + 7 (the columns of B^T).
template <class G>
__device__ __forceinline__ void tcg_frag_a(const typename G::T* sr,
                                           const typename G::T* si, int row0,
                                           int k0, CFrag<4>& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int x = row0 + g + 8 * (r & 1);
    const int k = k0 + (G::KS == 8 ? t + 4 * (r >> 1) : 2 * t + 8 * (r >> 1));
    tcg_part<G>(sr, x, k, a.rh[r], a.rl[r]);
    tcg_part<G>(si, x, k, a.ih[r], a.il[r]);
  }
}
template <class G>
__device__ __forceinline__ void tcg_frag_b(const typename G::T* sr,
                                           const typename G::T* si, int n0,
                                           int k0, CFrag<2>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + (G::KS == 8 ? t + 4 * j : 2 * t + 8 * j);
    tcg_part<G>(sr, n0 + g, k, b.rh[j], b.rl[j]);
    tcg_part<G>(si, n0 + g, k, b.ih[j], b.il[j]);
  }
}

// Half of a split register's values (exact: a power of two).
template <int MODE>
__device__ __forceinline__ uint32_t halved(uint32_t v) {
  if constexpr (MODE == kTf32x3) {
    return __float_as_uint(__uint_as_float(v) * 0.5f);
  } else {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
    h = __hmul2(h, __float2bfloat162_rn(0.5f));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// One k-step of a 32 x 8 block of P and C: a[m] the rows' xr (re) and xi
// (im) parts with xi's hi halved, b the columns' with xr's hi halved:
//   P += Hr (Hr / 2)^T + Hr Lr^T + (Hi / 2) Hi^T + Li Hi^T,
//   C += Lr Hi^T + Hr Li^T + Hr Hi^T,
// (with EXACT the lo parts are zero: their passes are skipped), summed from
// zero, the small passes first, and added to the accumulators rounded to
// nearest. P(bx, by) + P(by, bx)^T is xr xr^T + xi xi^T in three passes.
template <int MODE, bool EXACT, int M = 2>
__device__ __forceinline__ void tcg_kstep(float (&accS)[M][4],
                                          float (&accC)[M][4],
                                          const CFrag<4> (&a)[M],
                                          const CFrag<2>& b) {
  using dqc::mma_op;
  using dqc::mma_op0;
  float tS[M][4], tC[M][4];
  if constexpr (!EXACT) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_op0<MODE>(tS[m], a[m].rh, b.rl[0], b.rl[1]);
      mma_op0<MODE>(tC[m], a[m].rl, b.ih[0], b.ih[1]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_op<MODE>(tS[m], a[m].il, b.ih[0], b.ih[1]);
      mma_op<MODE>(tC[m], a[m].rh, b.il[0], b.il[1]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_op<MODE>(tS[m], a[m].rh, b.rh[0], b.rh[1]);
      mma_op<MODE>(tC[m], a[m].rh, b.ih[0], b.ih[1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_op0<MODE>(tS[m], a[m].rh, b.rh[0], b.rh[1]);
      mma_op0<MODE>(tC[m], a[m].rh, b.ih[0], b.ih[1]);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) mma_op<MODE>(tS[m], a[m].ih, b.ih[0], b.ih[1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      accS[m][e] += tS[m][e];
      accC[m][e] += tC[m][e];
    }
}

// Block (bx NRB + by, group) adds the patch (bx, by) of P and C over the
// 32-column tiles tile = group, group + gridDim.y, ... of the view (P, X,
// Q) into part[group][0 / 1][x][y]: each entry has one writer. Warp w forms
// the 32 x 64 block at rows 32 (w / 2), columns 64 (w % 2) of the patch,
// 2 x 8 m16n8 tiles of each in registers, added to the slot every kTcFlush
// tiles.
template <int NRB, int KIND, int MODE, bool LANE>
__global__ void __launch_bounds__(kTcThreads, 1)
gram_tc_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
               float* __restrict__ part, int64_t Q, int64_t ntiles) {
  using G = TcGram<KIND, MODE, LANE, NRB>;
  using T = typename G::T;
  constexpr int X = NRB * 128;
  constexpr int ELEMS = 16 / G::ES;  // elements a 16-byte copy
  extern __shared__ float4 gram_smem4[];  // 16-byte aligned
  char* smem = reinterpret_cast<char*>(gram_smem4);
  const int bx = (int)(blockIdx.x / NRB), by = (int)(blockIdx.x % NRB);
  const bool diag = bx == by;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  auto fetch = [&](int64_t tile, char* stage) {
    if constexpr (LANE) {  // kTcCB rows of 128 elements, xr then xi
      const int64_t base = tile * kTcCB * 128;
#pragma unroll 4
      for (int c = threadIdx.x; c < 2 * kTcCB * G::kChunksRow; c += kTcThreads) {
        const int arr = c / (kTcCB * G::kChunksRow);
        const int k = (c / G::kChunksRow) % kTcCB, piece = c % G::kChunksRow;
        const T* src = static_cast<const T*>(arr ? xi : xr) + base + k * 128 +
                       piece * ELEMS;
        dqc::cp_async16(stage + (arr * G::kArr + k * G::LD + piece * ELEMS) * G::ES,
                        src);
      }
    } else {  // 128 rows of kTcCB elements: xr, xi of rows bx, then of by
      const int64_t g0 = tile * kTcCB, p = g0 / Q;
      const int64_t base = p * X * Q + (g0 - p * Q);
      const int narr = diag ? 2 : 4;
      for (int c = threadIdx.x; c < narr * 128 * G::kChunksRow; c += kTcThreads) {
        const int arr = c / (128 * G::kChunksRow);
        const int x = (c / G::kChunksRow) % 128, piece = c % G::kChunksRow;
        const int rb = arr < 2 ? bx : by;
        const T* src = static_cast<const T*>((arr & 1) ? xi : xr) + base +
                       (int64_t)(rb * 128 + x) * Q + piece * ELEMS;
        dqc::cp_async16(stage + (arr * G::kArr + x * G::LD + piece * ELEMS) * G::ES,
                        src);
      }
    }
    dqc::cp_async_commit();
  };

  float accS[8][2][4], accC[8][2][4];  // [n][m][fragment entry]
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accS[n][m][e] = accC[n][m][e] = 0.f;
  float* out = part + (int64_t)blockIdx.y * 2 * X * X;
  auto flush = [&](bool first) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t x = bx * 128 + wm * 32 + 16 * m + g + 8 * h;
          const int64_t y = by * 128 + wn * 64 + 8 * n + 2 * t;
          float2* ps = reinterpret_cast<float2*>(out + x * X + y);
          float2* pc = reinterpret_cast<float2*>(out + (int64_t)X * X + x * X + y);
          float2 vs = make_float2(accS[n][m][2 * h], accS[n][m][2 * h + 1]);
          float2 vc = make_float2(accC[n][m][2 * h], accC[n][m][2 * h + 1]);
          if (!first) {
            const float2 os = *ps, oc = *pc;
            vs.x += os.x;
            vs.y += os.y;
            vc.x += oc.x;
            vc.y += oc.y;
          }
          *ps = vs;
          *pc = vc;
        }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accS[n][m][e] = accC[n][m][e] = 0.f;
  };

  int64_t tile = blockIdx.y;
  if (tile < ntiles) fetch(tile, smem);
  int k = 0;
  bool first = true;
  for (; tile < ntiles; tile += gridDim.y, ++k) {
    const char* stage = smem + (k & 1) * G::kStageBytes;
    if (tile + gridDim.y < ntiles) {
      fetch(tile + gridDim.y, smem + ((k + 1) & 1) * G::kStageBytes);
      dqc::cp_async_wait<1>();
    } else {
      dqc::cp_async_wait<0>();
    }
    __syncthreads();  // this tile is staged and seen by every warp
    const T* sr = reinterpret_cast<const T*>(stage);
    const T* si = sr + G::kArr;
    const T* tr = diag ? sr : sr + 2 * G::kArr;  // the patch's columns
    const T* ti = diag ? si : sr + 3 * G::kArr;
#pragma unroll
    for (int ks = 0; ks < kTcCB; ks += G::KS) {
      CFrag<4> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        tcg_frag_a<G>(sr, si, wm * 32 + 16 * m, ks, a[m]);
#pragma unroll
        for (int r = 0; r < 4; ++r) a[m].ih[r] = halved<MODE>(a[m].ih[r]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        CFrag<2> b;
        tcg_frag_b<G>(tr, ti, wn * 64 + 8 * n, ks, b);
        b.rh[0] = halved<MODE>(b.rh[0]);
        b.rh[1] = halved<MODE>(b.rh[1]);
        tcg_kstep<MODE, KIND != dqc::kStoreF32>(accS[n], accC[n], a, b);
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
    if ((k + 1) % kTcFlush == 0) {
      flush(first);
      first = false;
    }
  }
  if (k % kTcFlush != 0 || first) flush(first);
}

// out = (S, C) from tot = (sum P, sum C): S = P + P^T.
__global__ void gram_sym_kernel(const float* __restrict__ tot,
                                float* __restrict__ out, int X) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= X * X) return;
  const int x = e / X, y = e % X;
  out[e] = tot[e] + tot[y * X + x];
  out[X * X + e] = tot[X * X + e];
}

template <int NRB, int KIND, int MODE, bool LANE>
int launch_tc(const void* xr, const void* xi, float* part, float* tot,
              float* out, long long P, long long Q, int nblk,
              cudaStream_t stream) {
  using G = TcGram<KIND, MODE, LANE, NRB>;
  constexpr int X = NRB * 128;
  const long long cols = P * Q, ntiles = cols / kTcCB;
  if (cols % kTcCB != 0 || (LANE ? Q != 1 : Q % kTcCB != 0) || nblk <= 0 ||
      nblk > 65535 || nblk > ntiles)
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_tc_kernel<NRB, KIND, MODE, LANE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(NRB * NRB, nblk), kTcThreads, G::kSmemBytes, stream>>>(
      xr, xi, part, (int64_t)Q, (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int code = dqc::launch_reduce(part, tot, nblk, 2 * X * X, stream);
  if (code != 0) return code;
  gram_sym_kernel<<<(X * X + 255) / 256, 256, 0, stream>>>(tot, out, X);
  return (int)cudaGetLastError();
}

// --- X = 8, 16, 32 and 64 on the tensor cores ------------------------------

constexpr int kSmStages = 3;    // the cp.async ring
constexpr int kSmFlush = 8;     // tiles summed in registers before a flush

// The tiles of one launch at X <= 64: planes stored as KIND (bf16 kept bf16
// in shared memory), products split for MODE. A stage holds xr and xi of
// the X rows of CB columns, [x][k], padded so that every fragment read meets
// 32 banks; at X = 8 each array has 16 rows, the last 8 zero (the A
// fragments' rows 8..15). Warps: TILES blocks of the patch, WM x WN each,
// times KG k-groups, each KC columns of a tile a k-group.
template <int KIND, int MODE, int X>
struct SmallGram {
  using T = std::conditional_t<KIND == dqc::kStoreF32, float, uint16_t>;
  static constexpr bool kLane = false;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int KS = MODE == kTf32x3 ? 8 : 16;
  static constexpr int XR = X < 16 ? 16 : X;          // rows of an array
  static constexpr int CB = X < 64 ? 128 : 64;         // columns a tile
  static constexpr int LD = CB + (KIND == dqc::kStoreF32 && MODE == kTf32x3 ? 4 : 8);
  static constexpr int kArr = XR * LD;
  static constexpr int kChunksRow = CB * ES / 16;
  static constexpr int kStageBytes = 2 * kArr * ES;
  static constexpr int kSmemBytes = kSmStages * kStageBytes;
  static constexpr int WM = XR < 32 ? XR : 32, WN = X < 32 ? X : 32;
  static constexpr int MW = WM / 16, NW = WN / 8;      // m- and n-tiles a warp
  static constexpr int TC = X / WN, TILES = (XR / WM) * TC;
  static constexpr int KG = 8 / TILES;                 // k-groups
  static constexpr int KC = CB / KG;                   // their columns a tile
  static_assert((LD * ES) % 16 == 0 && KC % KS == 0 && TILES * KG == 8,
                "aligned rows, whole k-steps, 8 warps");
  static_assert(kSmemBytes <= 232448 / 2, "two blocks an SM");
  static __device__ __forceinline__ int at(int x, int k) { return x * LD + k; }
};

// Block b adds its share of the CB-column tiles tile = b, b + gridDim.x,
// ... of the view (P, X, Q) into the partial slots part[b KG + k-group]
// [0 / 1][x][y] of P and C (one writer an entry, flushed every kSmFlush
// tiles); warp w forms block w % TILES of the patch over k-group w / TILES
// of each tile's columns.
template <int X, int KIND, int MODE>
__global__ void __launch_bounds__(kTcThreads, 2)
gram_tc_small_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
                     float* __restrict__ part, int64_t Q, int64_t ntiles) {
  using G = SmallGram<KIND, MODE, X>;
  using T = typename G::T;
  constexpr int ELEMS = 16 / G::ES;
  extern __shared__ float4 gram_smem4[];
  char* smem = reinterpret_cast<char*>(gram_smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile_of = warp % G::TILES, kg = warp / G::TILES;
  const int row0 = (tile_of / G::TC) * G::WM, col0 = (tile_of % G::TC) * G::WN;

  if constexpr (X < 16) {  // the zero rows, never copied over
    for (int e = threadIdx.x; e < kSmStages * 2 * 8 * G::LD; e += kTcThreads) {
      const int a = e / (8 * G::LD), o = e % (8 * G::LD);
      reinterpret_cast<T*>(smem + (a / 2) * G::kStageBytes)[(a % 2) * G::kArr + 8 * G::LD + o] = T(0);
    }
  }
  auto fetch = [&](int64_t tile, char* stage) {
    const int64_t g0 = tile * G::CB, p = g0 / Q;
    const int64_t base = p * X * Q + (g0 - p * Q);
#pragma unroll 4
    for (int c = threadIdx.x; c < 2 * X * G::kChunksRow; c += kTcThreads) {
      const int arr = c / (X * G::kChunksRow);
      const int x = (c / G::kChunksRow) % X, piece = c % G::kChunksRow;
      const T* src = static_cast<const T*>(arr ? xi : xr) + base + (int64_t)x * Q +
                     piece * ELEMS;
      dqc::cp_async16(stage + (arr * G::kArr + x * G::LD + piece * ELEMS) * G::ES, src);
    }
  };

  float accS[G::NW][G::MW][4], accC[G::NW][G::MW][4];
#pragma unroll
  for (int n = 0; n < G::NW; ++n)
#pragma unroll
    for (int m = 0; m < G::MW; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accS[n][m][e] = accC[n][m][e] = 0.f;
  float* out = part + ((int64_t)blockIdx.x * G::KG + kg) * 2 * X * X;
  auto flush = [&](bool first) {
#pragma unroll
    for (int m = 0; m < G::MW; ++m)
#pragma unroll
      for (int n = 0; n < G::NW; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = row0 + 16 * m + g + 8 * h, y = col0 + 8 * n + 2 * t;
          if (X < 16 && x >= X) continue;
          float2* ps = reinterpret_cast<float2*>(out + x * X + y);
          float2* pc = reinterpret_cast<float2*>(out + X * X + x * X + y);
          float2 vs = make_float2(accS[n][m][2 * h], accS[n][m][2 * h + 1]);
          float2 vc = make_float2(accC[n][m][2 * h], accC[n][m][2 * h + 1]);
          if (!first) {
            const float2 os = *ps, oc = *pc;
            vs.x += os.x;
            vs.y += os.y;
            vc.x += oc.x;
            vc.y += oc.y;
          }
          *ps = vs;
          *pc = vc;
        }
#pragma unroll
    for (int n = 0; n < G::NW; ++n)
#pragma unroll
      for (int m = 0; m < G::MW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accS[n][m][e] = accC[n][m][e] = 0.f;
  };

  const int64_t nt = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
#pragma unroll
  for (int s = 0; s < kSmStages - 1; ++s) {
    if (s < nt) fetch(blockIdx.x + s * (int64_t)gridDim.x, smem + s * G::kStageBytes);
    dqc::cp_async_commit();
  }
  bool first = true;
  int64_t k = 0;
  for (; k < nt; ++k) {
    dqc::cp_async_wait<kSmStages - 2>();
    __syncthreads();  // tile k is staged and seen; tile k - 1's stage is free
    if (k + kSmStages - 1 < nt)
      fetch(blockIdx.x + (k + kSmStages - 1) * gridDim.x,
            smem + ((k + kSmStages - 1) % kSmStages) * G::kStageBytes);
    dqc::cp_async_commit();
    const T* sr = reinterpret_cast<const T*>(smem + (k % kSmStages) * G::kStageBytes);
    const T* si = sr + G::kArr;
#pragma unroll
    for (int ks = 0; ks < G::KC; ks += G::KS) {
      const int k0 = kg * G::KC + ks;
      CFrag<4> a[G::MW];
#pragma unroll
      for (int m = 0; m < G::MW; ++m) {
        tcg_frag_a<G>(sr, si, row0 + 16 * m, k0, a[m]);
#pragma unroll
        for (int r = 0; r < 4; ++r) a[m].ih[r] = halved<MODE>(a[m].ih[r]);
      }
#pragma unroll
      for (int n = 0; n < G::NW; ++n) {
        CFrag<2> b;
        tcg_frag_b<G>(sr, si, col0 + 8 * n, k0, b);
        b.rh[0] = halved<MODE>(b.rh[0]);
        b.rh[1] = halved<MODE>(b.rh[1]);
        tcg_kstep<MODE, KIND != dqc::kStoreF32, G::MW>(accS[n], accC[n], a, b);
      }
    }
    if ((k + 1) % kSmFlush == 0) {
      flush(first);
      first = false;
    }
  }
  dqc::cp_async_wait<0>();
  if (k % kSmFlush != 0 || first) flush(first);
}

template <int X, int KIND, int MODE>
int launch_tc_small(const void* xr, const void* xi, float* part, float* tot,
                    float* out, long long P, long long Q, int nblk,
                    cudaStream_t stream) {
  using G = SmallGram<KIND, MODE, X>;
  const long long cols = P * Q, ntiles = cols / G::CB;
  if (Q % G::CB != 0 || nblk <= 0 || nblk > 65535 || nblk > ntiles)
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_tc_small_kernel<X, KIND, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kTcThreads, G::kSmemBytes, stream>>>(xr, xi, part, (int64_t)Q,
                                                       (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int code = dqc::launch_reduce(part, tot, (int64_t)nblk * G::KG, 2 * X * X, stream);
  if (code != 0) return code;
  gram_sym_kernel<<<(X * X + 255) / 256, 256, 0, stream>>>(tot, out, X);
  return (int)cudaGetLastError();
}

}  // namespace

// (S, C) of the view (P, X, Q), X in {8, 16, 32, 64, 128, 256, 512}, on the
// tensor cores, into out[0] = S, out[1] = C. tot is scratch of 2 * X * X
// floats and part of nslots * 2 * X * X (every entry written): at X >= 128
// nslots = nblk, the column groups (at most 65535 and the number of
// 32-column tiles, P Q / 32), with Q 1 (the lane view, X = 128 only) or a
// multiple of 32; below, nblk blocks (at most the number of tiles, P Q /
// 128, P Q / 64 at X = 64) of 8 slots each, 2 at X = 64, with Q a multiple
// of 128. The planes are stored as kind (0 f32, 1 bf16: one bf16 pass
// whatever the mode); on f32 planes x3 runs the products bf16x3, else
// 3xTF32. Returns cudaGetLastError().
extern "C" int dqc_gram_tc(const void* xr, const void* xi, float* part,
                           float* tot, float* out, long long P, int X,
                           long long Q, int nblk, int kind, int x3,
                           void* stream) {
  using dqc::kBf16x3;
  using dqc::kTf32x3;
  constexpr int F = dqc::kStoreF32, B = dqc::kStoreBF16;
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const bool lane = Q == 1;
  // 0: f32 planes in 3xTF32, 1: f32 planes in bf16x3, 2: bf16 planes
  const int k = kind == B ? 2 : x3 ? 1 : 0;
  using Fn = int (*)(const void*, const void*, float*, float*, float*,
                     long long, long long, int, cudaStream_t);
  static const Fn table[4][3] = {
      {launch_tc<1, F, kTf32x3, false>, launch_tc<1, F, kBf16x3, false>,
       launch_tc<1, B, kBf16x3, false>},
      {launch_tc<1, F, kTf32x3, true>, launch_tc<1, F, kBf16x3, true>,
       launch_tc<1, B, kBf16x3, true>},
      {launch_tc<2, F, kTf32x3, false>, launch_tc<2, F, kBf16x3, false>,
       launch_tc<2, B, kBf16x3, false>},
      {launch_tc<4, F, kTf32x3, false>, launch_tc<4, F, kBf16x3, false>,
       launch_tc<4, B, kBf16x3, false>}};
  static const Fn small[4][3] = {
      {launch_tc_small<8, F, kTf32x3>, launch_tc_small<8, F, kBf16x3>,
       launch_tc_small<8, B, kBf16x3>},
      {launch_tc_small<16, F, kTf32x3>, launch_tc_small<16, F, kBf16x3>,
       launch_tc_small<16, B, kBf16x3>},
      {launch_tc_small<32, F, kTf32x3>, launch_tc_small<32, F, kBf16x3>,
       launch_tc_small<32, B, kBf16x3>},
      {launch_tc_small<64, F, kTf32x3>, launch_tc_small<64, F, kBf16x3>,
       launch_tc_small<64, B, kBf16x3>}};
  const int w = X == 8 ? 0 : X == 16 ? 1 : X == 32 ? 2 : X == 64 ? 3 : -1;
  if (w >= 0 && !lane)
    return small[w][k](xr, xi, part, tot, out, P, Q, nblk, (cudaStream_t)stream);
  const int v = X == 128 ? (lane ? 1 : 0) : X == 256 ? 2 : X == 512 ? 3 : -1;
  if (v < 0) return (int)cudaErrorInvalidValue;
  return table[v][k](xr, xi, part, tot, out, P, Q, nblk, (cudaStream_t)stream);
}
