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
// X = 8..64 run on the CUDA cores (f32 FMA): each block sums its share of
// the columns into registers (each of 512 threads owns a patch of (x, y)
// pairs, or one pair and a slice of the columns for X <= 16), writes one
// partial (S, C), and a second kernel adds the partials in a fixed order.
// Columns stream through shared memory in tiles of 4096 / X columns, stored
// [column][x] with a padded row. A thread's sums run in two levels:
// registers over a chunk of four tiles, then a running sum in shared memory
// (each thread its own entries). There the planes may be stored as bf16
// (XKIND, decoded as the tile is read) and the products may run bf16x3 (X3:
// each value split as it is read from the tile, rows into hi and lo,
// columns into hi and hi + lo, two FMAs per real product). On bf16 planes
// the split of every value has a zero lo part, so bf16x3 and f32 give the
// same sums and such a call runs the f32 products.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunkTiles = 4;   // tiles summed in registers before a flush

template <int X>
struct GramCfg {
  static constexpr int RX = X >= 64 ? 4 : X >= 32 ? 2 : 1;
  static constexpr int RY = X >= 64 ? 2 : 1;
  static constexpr int TR = X / RX;                 // row threads
  static constexpr int TC = X / RY;                 // column threads
  static constexpr int G = kThreads / (TR * TC);    // column groups
  static constexpr int CB = 4096 / X;               // columns per tile
  static constexpr int LD = X + 1;                  // padded tile row
  static constexpr int kTileBytes = 2 * CB * LD * sizeof(float);
  static constexpr int kRunBytes = 2 * RX * RY * kThreads * sizeof(float);
  static constexpr int kSmemBytes = kTileBytes + kRunBytes;
};

// run[(2 (i RY + j) + {0: S, 1: C}) kThreads + thread]: this thread's running
// (S, C) in shared memory. add_chunk adds the register chunk in and clears it.
template <int RX, int RY>
__device__ __forceinline__ void add_chunk(float (&S)[RX][RY], float (&Cc)[RX][RY],
                                          float* run) {
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      float* a = run + 2 * (i * RY + j) * kThreads + threadIdx.x;
      a[0] += S[i][j];
      a[kThreads] += Cc[i][j];
      S[i][j] = Cc[i][j] = 0.f;
    }
}

template <int RX, int RY>
__device__ __forceinline__ void clear_run(float* run) {
#pragma unroll
  for (int k = 0; k < 2 * RX * RY; ++k) run[k * kThreads + threadIdx.x] = 0.f;
}

// The registers <- the running sums (after the last add_chunk).
template <int RX, int RY>
__device__ __forceinline__ void read_run(const float* run, float (&S)[RX][RY],
                                         float (&Cc)[RX][RY]) {
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const float* a = run + 2 * (i * RY + j) * kThreads + threadIdx.x;
      S[i][j] = a[0];
      Cc[i][j] = a[kThreads];
    }
}

// S += ar br + ai bi, C += ar bi over a thread's (rows, columns) patch of
// one tile column; X3 in bf16x3.
template <int RX, int RY, bool X3>
__device__ __forceinline__ void gram_products(const float (&ar)[RX],
                                              const float (&ai)[RX],
                                              const float (&br)[RY],
                                              const float (&bi)[RY],
                                              float (&S)[RX][RY],
                                              float (&Cc)[RX][RY]) {
  if constexpr (X3) {
    float brh[RY], brs[RY], bih[RY], bis[RY];
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      dqc::split_hs(br[j], brh[j], brs[j]);
      dqc::split_hs(bi[j], bih[j], bis[j]);
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      float arh, arl, aih, ail;
      dqc::split_hl(ar[i], arh, arl);
      dqc::split_hl(ai[i], aih, ail);
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        S[i][j] = fmaf(arh, brs[j], S[i][j]);
        S[i][j] = fmaf(arl, brh[j], S[i][j]);
        S[i][j] = fmaf(aih, bis[j], S[i][j]);
        S[i][j] = fmaf(ail, bih[j], S[i][j]);
        Cc[i][j] = fmaf(arh, bis[j], Cc[i][j]);
        Cc[i][j] = fmaf(arl, bih[j], Cc[i][j]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        S[i][j] = fmaf(ar[i], br[j], S[i][j]);
        S[i][j] = fmaf(ai[i], bi[j], S[i][j]);
        Cc[i][j] = fmaf(ar[i], bi[j], Cc[i][j]);
      }
  }
}

template <int X, int XKIND, bool X3>
__global__ void __launch_bounds__(kThreads, 1)
gram_partial_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
                    float* __restrict__ part, int64_t Q, int64_t ntiles) {
  using Cfg = GramCfg<X>;
  constexpr int RX = Cfg::RX, RY = Cfg::RY, TC = Cfg::TC, G = Cfg::G;
  constexpr int CB = Cfg::CB, LD = Cfg::LD;
  constexpr int kPairThreads = Cfg::TR * TC;
  extern __shared__ float smem[];
  float* tr = smem;            // tile [c][x]
  float* ti = tr + CB * LD;
  float* run = ti + CB * LD;   // running sums

  const int tid = threadIdx.x;
  const int grp = tid / kPairThreads;
  const int t = tid % kPairThreads;
  const int rx = (t / TC) * RX;   // rows rx + i
  const int cy = t % TC;          // columns cy + TC * j

  float S[RX][RY], Cc[RX][RY];
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) S[i][j] = Cc[i][j] = 0.f;
  clear_run<RX, RY>(run);

  int chunk = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t g0 = tile * CB;
    __syncthreads();  // the previous tile is consumed
    if (Q == 1) {
      // lane view: a tile is CB * X contiguous floats, x fastest
      const int64_t b0 = g0 * X;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int c = e / X, x = e % X;
        tr[c * LD + x] = dqc::load_plane(xr, b0 + e, XKIND);
        ti[c * LD + x] = dqc::load_plane(xi, b0 + e, XKIND);
      }
    } else {
      // CB divides Q: a tile's columns share p and are contiguous per x
      const int64_t p = g0 / Q, q0 = g0 - p * Q;
      const int64_t b0 = p * X * Q + q0;
      for (int e = tid; e < CB * X; e += kThreads) {
        const int x = e / CB, c = e % CB;
        tr[c * LD + x] = dqc::load_plane(xr, b0 + x * Q + c, XKIND);
        ti[c * LD + x] = dqc::load_plane(xi, b0 + x * Q + c, XKIND);
      }
    }
    __syncthreads();
    for (int c = grp; c < CB; c += G) {
      float ar[RX], ai[RX], br[RY], bi[RY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        ar[i] = tr[c * LD + rx + i];
        ai[i] = ti[c * LD + rx + i];
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        br[j] = tr[c * LD + cy + TC * j];
        bi[j] = ti[c * LD + cy + TC * j];
      }
      gram_products<RX, RY, X3>(ar, ai, br, bi, S, Cc);
    }
    if (++chunk == kChunkTiles) {
      add_chunk<RX, RY>(S, Cc, run);
      chunk = 0;
    }
  }
  add_chunk<RX, RY>(S, Cc, run);
  read_run<RX, RY>(run, S, Cc);

  // this block's partial (S, C) at part[block][0 / 1][x][y]
  float* out = part + (int64_t)blockIdx.x * 2 * X * X;
  if (G == 1) {
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        out[(rx + i) * X + cy + TC * j] = S[i][j];
        out[X * X + (rx + i) * X + cy + TC * j] = Cc[i][j];
      }
  } else {
    // X <= 16: one pair per thread; add the column groups in a fixed order
    __syncthreads();  // the tile buffer is free
    smem[tid] = S[0][0];
    smem[kThreads + tid] = Cc[0][0];
    __syncthreads();
    if (grp == 0) {
      float s = 0.f, cc = 0.f;
      for (int g = 0; g < G; ++g) {
        s += smem[g * kPairThreads + t];
        cc += smem[kThreads + g * kPairThreads + t];
      }
      out[rx * X + cy] = s;
      out[X * X + rx * X + cy] = cc;
    }
  }
}

// out[e] = sum over blocks of part[b][e], e < 2 X X, in block order.
__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int nblk, int n2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n2) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += part[(int64_t)b * n2 + e];
  out[e] = acc;
}

template <int X, int XKIND = dqc::kStoreF32, bool X3 = false>
int launch(const void* xr, const void* xi, float* part, float* out,
           long long P, long long Q, int nblk, cudaStream_t stream) {
  using Cfg = GramCfg<X>;
  const long long cols = P * Q;
  if (cols % Cfg::CB != 0 || (Q != 1 && Q % Cfg::CB != 0) || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_partial_kernel<X, XKIND, X3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kThreads, Cfg::kSmemBytes, stream>>>(
      xr, xi, part, (int64_t)Q, (int64_t)(cols / Cfg::CB));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n2 = 2 * X * X;
  gram_reduce_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(part, out, nblk, n2);
  return (int)cudaGetLastError();
}


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
template <int MODE, bool EXACT>
__device__ __forceinline__ void tcg_kstep(float (&accS)[2][4],
                                          float (&accC)[2][4],
                                          const CFrag<4> (&a)[2],
                                          const CFrag<2>& b) {
  using dqc::mma_op;
  using dqc::mma_op0;
  float tS[2][4], tC[2][4];
  if constexpr (!EXACT) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_op0<MODE>(tS[m], a[m].rh, b.rl[0], b.rl[1]);
      mma_op0<MODE>(tC[m], a[m].rl, b.ih[0], b.ih[1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_op<MODE>(tS[m], a[m].il, b.ih[0], b.ih[1]);
      mma_op<MODE>(tC[m], a[m].rh, b.il[0], b.il[1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_op<MODE>(tS[m], a[m].rh, b.rh[0], b.rh[1]);
      mma_op<MODE>(tC[m], a[m].rh, b.ih[0], b.ih[1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_op0<MODE>(tS[m], a[m].rh, b.rh[0], b.rh[1]);
      mma_op0<MODE>(tC[m], a[m].rh, b.ih[0], b.ih[1]);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) mma_op<MODE>(tS[m], a[m].ih, b.ih[0], b.ih[1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
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

}  // namespace

// (S, C) of the view (P, X, Q), X in {8, 16, 32, 64}, into out[0] = S,
// out[1] = C (each X x X). part is scratch of nblk * 2 * X * X floats and
// nblk the number of partial-sum blocks (at most the number of tiles,
// P Q X / 4096). The planes are stored as kind (0 f32, 1 bf16) and x3 runs
// the products bf16x3. Returns cudaGetLastError().
extern "C" int dqc_gram(const void* xr, const void* xi, float* part,
                        float* out, long long P, int X, long long Q, int nblk,
                        int kind, int x3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int B = dqc::kStoreBF16;
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  if (kind == B || x3) {
    // bf16 values split with a zero lo part: bf16x3 is the f32 product there
    const bool split = kind != B;
    switch (X) {
#define DQC_GRAM_FWD16(XX)                                                    \
  case XX:                                                                    \
    return split ? launch<XX, dqc::kStoreF32, true>(xr, xi, part, out, P, Q,  \
                                                    nblk, s)                  \
                 : launch<XX, B, false>(xr, xi, part, out, P, Q, nblk, s);
      DQC_GRAM_FWD16(8)
      DQC_GRAM_FWD16(16)
      DQC_GRAM_FWD16(32)
      DQC_GRAM_FWD16(64)
#undef DQC_GRAM_FWD16
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (X) {
    case 8: return launch<8>(xr, xi, part, out, P, Q, nblk, s);
    case 16: return launch<16>(xr, xi, part, out, P, Q, nblk, s);
    case 32: return launch<32>(xr, xi, part, out, P, Q, nblk, s);
    case 64: return launch<64>(xr, xi, part, out, P, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// (S, C) of the view (P, X, Q), X in {128, 256, 512}, on the tensor cores,
// into out[0] = S, out[1] = C. part is scratch of nblk * 2 * X * X floats
// (every entry written) and tot of 2 * X * X; nblk is the number of column
// groups (at most 65535 and the number of 32-column tiles, P Q / 32). Q is 1
// (the lane view, X = 128 only) or a multiple of 32. The planes are stored
// as kind (0 f32, 1 bf16: one bf16 pass whatever the mode); on f32 planes
// x3 runs the products bf16x3, else 3xTF32. Returns cudaGetLastError().
extern "C" int dqc_gram_tc(const void* xr, const void* xi, float* part,
                           float* tot, float* out, long long P, int X,
                           long long Q, int nblk, int kind, int x3,
                           void* stream) {
  using dqc::kBf16x3;
  using dqc::kTf32x3;
  constexpr int F = dqc::kStoreF32, B = dqc::kStoreBF16;
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const bool lane = Q == 1;
  if (lane && X != 128) return (int)cudaErrorInvalidValue;
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
  const int v = X == 128 ? (lane ? 1 : 0) : X == 256 ? 2 : X == 512 ? 3 : -1;
  if (v < 0) return (int)cudaErrorInvalidValue;
  return table[v][k](xr, xi, part, tot, out, P, Q, nblk, (cudaStream_t)stream);
}
