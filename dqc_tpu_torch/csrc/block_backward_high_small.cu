// The one-pass adjoint step of a high-group block at X = 8..64 on the tensor
// cores, streamed.
//
// Replaces, with block_backward_high.cu (X = 128, 256, 512), the TPU kernel
// block_backward_high (dqc_tpu/ops/pallas/block_backward.py:906, pallas_call
// at :995, body _kernel_high at :756) on the narrow high groups: group 2 at
// n = 17-20, group 3 at n = 24-27 and the CNOT ring's X = 8 span views. On
// the view (A1, X, Q = M 128) of the forward planes F and the cotangent
// planes B, with the group's operator E (X x X), for every column:
//
//   F <- Einv F,   T0 += B F^T (contract the columns),   B <- E^T B
//
// with a diagonal run rolled back on load or on store and its Q reductions,
// in every storage and dot mode, as block_backward_high.cu's header
// describes (F and B f32 or 16-bit, decoded on load and rounded on store;
// the uncompute, the transport and the pair gram each 3xTF32 or bf16x3).
//
// Bound: bytes. 3 X complex multiply-adds per amplitude (24 at X = 8, 192 at
// X = 64) against 32 bytes read and written (16 with 16-bit planes): on the
// tensor cores (three passes per real product, tf32 at 495 TFLOP/s, bf16 at
// 989) that is under the bytes' time for every X <= 64, so the design is
// about keeping HBM busy and the products off the CUDA cores.
//
// Design: blocks of 256 threads (8 warps), two a SM at X <= 32 and one at X
// = 64, each walking tiles of 2048 amplitudes: X rows at stride Q by C =
// 2048 / X contiguous columns, all of one i (with diag_q one (i, p) group at
// a time, as at X = 128, so that each Qas / Qal entry has one writer).
// 1. The operators come pre-split in mma fragment order (the wrapper's
//    _tc.tc_operator of Einv and of E^T, each in its product's mode, in three
//    parts where 3xTF32 meets 16-bit planes the step holds exact; X = 8 as
//    diag(E, E), 16 x 16) and are copied into shared memory once per block
//    (at most 192 KB, X = 64 with two three-part operators).
// 2. The tile's raw planes go to a stage in shared memory (16 bytes a
//    cp.async, rows of C elements); the block decodes the stage into its f32
//    working tile, 16 bytes of f32 or 8 of 16-bit values a thread (the run's
//    tables read four entries at once, adjoint.cuh diag_group, when a run is
//    rolled back on load), then issues the next tile's copies into the freed
//    stage: they fly while this tile computes and stores (32 KB a block on
//    f32 planes). In place: each tile is read whole before it is written.
//    Where the stage does not fit beside the operators (X = 64, 3xTF32 on
//    16-bit F and B: two three-part operators), the decode reads the planes
//    themselves and nothing flies.
// 3. The uncompute and the transport on mma.sync (mma.cuh cmma3: each
//    k-step summed from zero and added on the CUDA cores, rounded to
//    nearest; the passes that read a zero lo part skipped): the operator is
//    the A fragment (X / 16 m-tiles, K = X), the tile's columns are N, and
//    each warp keeps one m-tile by 16 columns of each product in registers.
//    X = 8 runs as 16 rows: the tile's two halves of 128 columns stacked
//    under diag(E, E).
// 4. The pair gram B fin^T on mma.sync too: each warp owns fixed m16n8 tiles
//    of the X x X gram (16 x 16 at X = 8) over a fixed share of the tile's
//    columns, summed in registers tile after tile and added to its share's
//    slot of the block (each entry one writer thread, red.global) every
//    kFlush tiles; launch_reduce sums the slots in a fixed order. At X = 8
//    the gram of the stacked halves holds T0's two halves on its diagonal
//    8 x 8 blocks, which the thread holding both adds.
// 5. Q (QHigh: adjoint.cuh q_tile on the working tile) and the stores, 16
//    or 8 bytes a thread, the run's entries four at once.
// The modes, the operators' parts and the storage kinds are run-time
// arguments (a uniform branch each per tile), so that one kernel per X
// builds.
#include "block_backward_high.cuh"
#include "small_x.cuh"

namespace {

constexpr int kFlush = 16;      // tiles of the pair gram summed in registers
constexpr int kQScratch = 512;  // floats of q_tile's row-chunk partials

// small_x.cuh's tile, and the pair gram's shares of it.
template <int X>
struct SmCfg : SmTile<X> {
  using SmTile<X>::XR;
  using SmTile<X>::C;
  using SmTile<X>::CR;
  using SmTile<X>::MT;
  // the pair gram: a warp owns GNT n-tiles of one m-tile over KR columns
  static constexpr int GNT = X == 64 ? 4 : 2;
  static constexpr int GNB = XR / 8 / GNT;     // n-tile groups of an m-tile
  static constexpr int WG_OUT = MT * GNB;      // warps over the gram's tiles
  static constexpr int WG_K = kSmWarps / WG_OUT;  // column shares: slots a block
  static constexpr int KR = CR / WG_K;
  static constexpr int kBlocksPerSm = X == 64 ? 1 : 2;
  static_assert(WG_OUT * WG_K == kSmWarps && KR % 16 == 0, "the pair gram's shares");
  static_assert(dqc::QHighCfg<X, C, kSmThreads>::kScratchFloats <= kQScratch,
                "Q's scratch");
};

struct SmArgs {
  char* plane[4];           // F re, F im, B re, B im
  const uint32_t* op_inv;   // Einv, pre-split in the uncompute's mode
  const uint32_t* op_t;     // E^T, pre-split in the transport's mode
  DiagTables dinv, dfwd;
  QOut qo;
  float* part;
  int64_t Q, post, ntiles;
  int fkind, bkind;
  int um, tm, gm;           // bf16x3 (1) or 3xTF32 (0): uncompute, transport, gram
  int u3, t3;               // the uncompute's / transport's operator in three parts
  int inv_words, t_words;   // the operators' 32-bit words in shared memory
  int has_diag, diag_first_fwd, diag_q;
  int prefetch;             // the next tile's copies fly (a stage fits)
};

// The pair gram's share of this warp: gram[n] += B fin^T on its m-tile mt,
// n-tiles nt0 .., over the KR columns from k_begin of the working tiles
// (B: bR, bI; fin: fR, fI); b_exact: B's lo parts are zero.
template <int X, int MODE, int G = SmCfg<X>::GNT>
__device__ __forceinline__ void sm_pair_gram(const float* bR, const float* bI,
                                             const float* fR, const float* fI,
                                             int mt, int nt0, int k_begin,
                                             bool b_exact, float (&gr)[G][4],
                                             float (&gi)[G][4]) {
  using Cfg = SmCfg<X>;
  constexpr int KS = MODE == kTf32x3 ? 8 : 16, N = Cfg::GNT;
#pragma unroll
  for (int k0 = k_begin; k0 < k_begin + Cfg::KR; k0 += KS) {
    CFrag<4> a[1];
    dqc::load_a<MODE, SmRows<X>>(bR, bI, 16 * mt, k0, a[0]);
    CFrag<2> b[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      dqc::load_b_rows<MODE, SmRows<X>>(fR, fI, 8 * (nt0 + n), k0, b[n]);
    cmma3n<MODE, N>(gr, gi, a[0], b, b_exact, false);
  }
}

// The warp's pair-gram sums into its slot (re X x X, then im), then zero.
// At X = 8 the 16 x 16 gram of the stacked halves holds T0's halves on its
// diagonal blocks: T0[g][2 t + e] = G[g][2 t + e] + G[g + 8][8 + 2 t + e].
template <int X, int G = SmCfg<X>::GNT>
__device__ __forceinline__ void sm_flush(float* slot, int mt, int nt0,
                                         float (&gr)[G][4], float (&gi)[G][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (X == 8) {
    dqc::red2(slot + g * 8 + 2 * t, gr[0][0] + gr[1][2], gr[0][1] + gr[1][3]);
    dqc::red2(slot + 64 + g * 8 + 2 * t, gi[0][0] + gi[1][2],
              gi[0][1] + gi[1][3]);
  } else {
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (16 * mt + g + 8 * h) * X + 8 * (nt0 + n) + 2 * t;
        dqc::red2(slot + o, gr[n][2 * h], gr[n][2 * h + 1]);
        dqc::red2(slot + X * X + o, gi[n][2 * h], gi[n][2 * h + 1]);
      }
  }
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gr[n][e] = gi[n][e] = 0.f;
}

// The copies of the tile at element t0 of the planes into the stage: each
// plane's X rows of C elements, 16 bytes a cp.async; one cp.async group.
template <int X>
__device__ __forceinline__ void sm_issue(char* stage, const SmArgs& a, int64_t t0) {
  constexpr int C = SmCfg<X>::C;
  int off = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int es = elem_bytes(p < 2 ? a.fkind : a.bkind);
    const int chunks = C * es / 16;  // of a row
    const char* src = a.plane[p] + t0 * es;
    for (int e = threadIdx.x; e < X * chunks; e += kSmThreads) {
      const int x = e / chunks, ch = e % chunks;
      dqc::cp_async16(stage + off + x * C * es + 16 * ch, src + x * a.Q * es + 16 * ch);
    }
    off += kSmTile * es;
  }
  dqc::cp_async_commit();
}

// The tile at element t0 (the stage's copy with prefetch, else the planes
// themselves) -> the working tiles of F and B in f32, times the run's
// entries (Dinv for F, D for B) with use_diag.
template <int X>
__device__ __forceinline__ void sm_decode(const SmArgs& a, const char* stage,
                                          int64_t t0, float* W, bool use_diag,
                                          const DiagView& vi, const DiagView& vf) {
  using V = SmView<X>;
  constexpr int C = SmCfg<X>::C, J = kSmTile / 4 / kSmThreads;
  float vr[2][J][4], vm[2][J][4];
  int off = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // F, then B: every load first
    const int kind = h ? a.bkind : a.fkind, es = elem_bytes(kind);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int x, c;
      sm_group<X>(j, x, c);
      if (a.prefetch) {
        dqc::load4(stage + off, (x * C + c) >> 2, kind, vr[h][j]);
        dqc::load4(stage + off + kSmTile * es, (x * C + c) >> 2, kind, vm[h][j]);
      } else {
        const int64_t e4 = (x * a.Q + c) >> 2;
        dqc::load4(a.plane[2 * h] + t0 * es, e4, kind, vr[h][j]);
        dqc::load4(a.plane[2 * h + 1] + t0 * es, e4, kind, vm[h][j]);
      }
    }
    off += 2 * kSmTile * es;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int x, c;
      sm_group<X>(j, x, c);
      if (use_diag) {
        float dr[4], di[4];
        dqc::diag_group<true>(h ? vf : vi, x, c, dr, di);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dqc::cmul(vr[h][j][q], vm[h][j][q], dr[q], di[q], vr[h][j][q], vm[h][j][q]);
      }
      const int o = V::at(x, c);
      *reinterpret_cast<float4*>(W + 2 * h * kSmTile + o) =
          make_float4(vr[h][j][0], vr[h][j][1], vr[h][j][2], vr[h][j][3]);
      *reinterpret_cast<float4*>(W + (2 * h + 1) * kSmTile + o) =
          make_float4(vm[h][j][0], vm[h][j][1], vm[h][j][2], vm[h][j][3]);
    }
}

// The working tiles of F and B times the run's entries, in place (a run
// rolled back on load after its Q).
template <int X>
__device__ __forceinline__ void sm_diag(float* W, const DiagView& vi,
                                        const DiagView& vf) {
  using V = SmView<X>;
  constexpr int J = kSmTile / 4 / kSmThreads;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int x, c;
      sm_group<X>(j, x, c);
      float4* pr = reinterpret_cast<float4*>(W + 2 * h * kSmTile + V::at(x, c));
      float4* pi = reinterpret_cast<float4*>(W + (2 * h + 1) * kSmTile + V::at(x, c));
      const float4 r4 = *pr, i4 = *pi;
      float vr[4] = {r4.x, r4.y, r4.z, r4.w}, vm[4] = {i4.x, i4.y, i4.z, i4.w};
      float dr[4], di[4];
      dqc::diag_group<true>(h ? vf : vi, x, c, dr, di);
#pragma unroll
      for (int q = 0; q < 4; ++q) dqc::cmul(vr[q], vm[q], dr[q], di[q], vr[q], vm[q]);
      *pr = make_float4(vr[0], vr[1], vr[2], vr[3]);
      *pi = make_float4(vm[0], vm[1], vm[2], vm[3]);
    }
}

// The working tiles -> the planes at element t0, times the run's entries
// with use_diag, encoded to each plane's storage.
template <int X>
__device__ __forceinline__ void sm_store(const SmArgs& a, int64_t t0,
                                         const float* W, bool use_diag,
                                         const DiagView& vi, const DiagView& vf) {
  using V = SmView<X>;
  constexpr int J = kSmTile / 4 / kSmThreads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kind = h ? a.bkind : a.fkind, es = elem_bytes(kind);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int x, c;
      sm_group<X>(j, x, c);
      const int o = V::at(x, c);
      const float4 r4 = *reinterpret_cast<const float4*>(W + 2 * h * kSmTile + o);
      const float4 i4 = *reinterpret_cast<const float4*>(W + (2 * h + 1) * kSmTile + o);
      float vr[4] = {r4.x, r4.y, r4.z, r4.w}, vm[4] = {i4.x, i4.y, i4.z, i4.w};
      if (use_diag) {
        float dr[4], di[4];
        dqc::diag_group<true>(h ? vf : vi, x, c, dr, di);
#pragma unroll
        for (int q = 0; q < 4; ++q) dqc::cmul(vr[q], vm[q], dr[q], di[q], vr[q], vm[q]);
      }
      const int64_t e4 = (x * a.Q + c) >> 2;
      dqc::store4(a.plane[2 * h] + t0 * es, e4, kind, vr);
      dqc::store4(a.plane[2 * h + 1] + t0 * es, e4, kind, vm);
    }
  }
}

template <int X>
__global__ void __launch_bounds__(kSmThreads, SmCfg<X>::kBlocksPerSm)
block_backward_high_small_kernel(const SmArgs a) {
  using Cfg = SmCfg<X>;
  using LV = SmView<X>;
  constexpr int C = Cfg::C, TA = kSmTile;
  extern __shared__ float4 sm_smem4[];  // 16-byte aligned
  uint32_t* s_inv = reinterpret_cast<uint32_t*>(sm_smem4);
  uint32_t* s_t = s_inv + a.inv_words;
  float* W = reinterpret_cast<float*>(s_t + a.t_words);  // F re, im, B re, im
  float* sFr = W;
  float* sFi = W + TA;
  float* sBr = W + 2 * TA;
  float* sBi = W + 3 * TA;
  float* scratch = W + 4 * TA;
  char* stage = reinterpret_cast<char*>(scratch + kQScratch);
  const int warp = threadIdx.x >> 5;

  // the operators, once
  for (int e = threadIdx.x; e < a.inv_words / 4; e += kSmThreads)
    dqc::cp_async16(s_inv + 4 * e, a.op_inv + 4 * e);
  for (int e = threadIdx.x; e < a.t_words / 4; e += kSmThreads)
    dqc::cp_async16(s_t + 4 * e, a.op_t + 4 * e);
  dqc::cp_async_commit();

  const int diag_mode = a.has_diag ? (a.diag_first_fwd ? 2 : 1) : 0;
  const bool q_on_load = a.diag_q && diag_mode == 1;
  const bool load_diag = diag_mode == 1 && !q_on_load;
  // a planes operand's lo parts are zero: 16-bit planes in 3xTF32, bf16 in
  // bf16x3, as loaded (a run rolled back on load leaves f32 values)
  const bool stored = diag_mode != 1;
  const bool f_exact = stored && a.fkind != kStoreF32;
  const bool b_tf32 = stored && a.bkind != kStoreF32;
  const bool b_bf16 = stored && a.bkind == dqc::kStoreBF16;
  // this warp's m-tile and columns of the products, and its share of the
  // pair gram: m-tile, first n-tile, first column, slot
  const int pm = warp / Cfg::CB, pn = 16 * (warp % Cfg::CB);
  const int go = warp % Cfg::WG_OUT, gk = warp / Cfg::WG_OUT;
  const int gmt = go / Cfg::GNB, gnt = (go % Cfg::GNB) * Cfg::GNT;
  float* slot = a.part + ((int64_t)blockIdx.x * Cfg::WG_K + gk) * 2 * X * X;
  QHigh qh{a.qo.sl_part + (int64_t)blockIdx.x * 2 * kSl, a.qo.as_r, a.qo.as_i,
           a.qo.al_r, a.qo.al_i, 0, 0, a.post};
  float gr[Cfg::GNT][4], gi[Cfg::GNT][4];
#pragma unroll
  for (int n = 0; n < Cfg::GNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gr[n][e] = gi[n][e] = 0.f;

  int64_t i, q0;
  if (a.prefetch && tile_at<C>(0, a.Q, a.ntiles, a.diag_q, i, q0))
    sm_issue<X>(stage, a, i * X * a.Q + q0);
  int since = 0;
  for (int64_t n = 0; tile_at<C>(n, a.Q, a.ntiles, a.diag_q, i, q0); ++n) {
    const int64_t t0 = i * X * a.Q + q0;
    const DiagView vi{a.dinv, 2, i, q0, X, a.post};
    const DiagView vf{a.dfwd, 2, i, q0, X, a.post};
    dqc::cp_async_wait<0>();
    __syncthreads();  // the operators and the stage are in; the last stores read W
    sm_decode<X>(a, stage, t0, W, load_diag, vi, vf);
    __syncthreads();  // the tile is in W; the stage is free
    int64_t i2, q2;
    if (a.prefetch && tile_at<C>(n + 1, a.Q, a.ntiles, a.diag_q, i2, q2))
      sm_issue<X>(stage, a, i2 * X * a.Q + q2);
    qh.i = i;
    qh.q0 = q0;
    if (q_on_load) {
      dqc::q_tile<X, LV, C, kSmThreads>(sFr, sFi, sBr, sBi, qh, scratch);
      __syncthreads();  // every read of the raw tiles is done
      sm_diag<X>(W, vi, vf);
      __syncthreads();
    }
    // fin = Einv F
    float pr[2][4], pi[2][4];
    if (a.um)
      sm_product<X, kBf16x3>(s_inv, false, sFr, sFi, f_exact, pm, pn, pr, pi);
    else
      sm_product<X, kTf32x3>(s_inv, a.u3, sFr, sFi, f_exact, pm, pn, pr, pi);
    __syncthreads();  // every warp is done reading F
    sm_put<X>(sFr, sFi, pm, pn, pr, pi);
    __syncthreads();  // fin is complete
    // the pair gram of the incoming cotangent and fin
    if (a.gm)
      sm_pair_gram<X, kBf16x3>(sBr, sBi, sFr, sFi, gmt, gnt, gk * Cfg::KR, b_bf16, gr, gi);
    else
      sm_pair_gram<X, kTf32x3>(sBr, sBi, sFr, sFi, gmt, gnt, gk * Cfg::KR, b_tf32, gr, gi);
    if (++since == kFlush) {
      sm_flush<X>(slot, gmt, gnt, gr, gi);
      since = 0;
    }
    // bout = E^T B
    if (a.tm)
      sm_product<X, kBf16x3>(s_t, false, sBr, sBi, b_bf16, pm, pn, pr, pi);
    else
      sm_product<X, kTf32x3>(s_t, a.t3, sBr, sBi, b_tf32, pm, pn, pr, pi);
    __syncthreads();  // every read of B is done
    sm_put<X>(sBr, sBi, pm, pn, pr, pi);
    __syncthreads();  // bout is complete
    if (a.diag_q && diag_mode == 2)
      dqc::q_tile<X, LV, C, kSmThreads>(sFr, sFi, sBr, sBi, qh, scratch);
    sm_store<X>(a, t0, W, diag_mode == 2, vi, vf);
  }
  if (since != 0) sm_flush<X>(slot, gmt, gnt, gr, gi);
}

template <int X>
int launch_small(SmArgs& a, long long A1, int nblk, int slots, float* out,
                 float* qsl, cudaStream_t stream) {
  using Cfg = SmCfg<X>;
  if (slots != Cfg::WG_K) return (int)cudaErrorInvalidValue;
  a.ntiles = high_tiles(Cfg::C, A1, a.Q, a.diag_q, nblk);
  if (a.ntiles == 0) return (int)cudaErrorInvalidValue;
  a.inv_words = op_words(Cfg::XR, a.um, a.u3);
  a.t_words = op_words(Cfg::XR, a.tm, a.t3);
  const int base = 4 * (a.inv_words + a.t_words + 4 * kSmTile + kQScratch);
  const int stage = kSmTile * 2 * (elem_bytes(a.fkind) + elem_bytes(a.bkind));
  a.prefetch = base + stage <= kSmemLimit;
  const int bytes = a.prefetch ? base + stage : base;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = block_backward_high_small_kernel<X>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kSmThreads, bytes, stream>>>(a);
  return high_reduce(a.part, out, (long long)nblk * Cfg::WG_K, 2 * X * X,
                     a.diag_q, a.qo, qsl, nblk, stream);
}

}  // namespace

// In place on the view (A1, X, Q = M 128), X in {8, 16, 32, 64}: (F, B) <-
// the adjoint step of E; out = (T0 re, T0 im), 2 x X x X floats. op_inv =
// Einv pre-split in the uncompute's mode (dot_x3), op_t = E^T in the
// transport's (bwd_x3), as ops/kernels/_tc.tc_operator lays them out (X = 8
// as diag(E, E), 16 x 16; in three parts where 3xTF32 meets a 16-bit F or B
// that the step holds exact: not after a run rolled back on load). part is
// scratch of nblk * slots * 2 * X * X floats, set to zero by the caller,
// slots the pair gram's slots a block (8 at X = 8 / 16, 2 at 32, 1 at 64);
// nblk is the number of blocks (at most the number of 2048-amplitude tiles,
// A1 Q X / 2048, or with diag_q of (i, p) groups, A1 Q / (128 128)). With
// has_diag, Q must be a multiple of 128 * 128 and the tables 16-byte
// aligned; the twelve table pointers may be null when has_diag is 0. With
// diag_q (needs has_diag): qas_r/i and qal_r/i are (A, 128) outputs, A = A1
// X Q / (128 128), set to zero by the caller; qpart is scratch of nblk * 2 *
// 128 * 128 floats set to zero, and qsl the (Qsl re, im) output, 2 x 128 x
// 128 floats (all null without). B is stored as bkind (0 f32, 1 bf16, 2
// f16), F as fkind (0 f32, 1 bf16); dot_x3 / bwd_x3 / gram_x3 run the
// uncompute / the transport / the pair gram bf16x3, else 3xTF32. The planes
// are 16-byte aligned. Returns cudaGetLastError().
extern "C" int dqc_block_backward_high_small(
    void* fr, void* fi, void* br, void* bi, const uint32_t* op_inv,
    const uint32_t* op_t, const float* isl_r, const float* isl_i,
    const float* ias_r, const float* ias_i, const float* ial_r,
    const float* ial_i, const float* sl_r, const float* sl_i,
    const float* as_r, const float* as_i, const float* al_r,
    const float* al_i, int has_diag, int diag_first_fwd, int diag_q,
    float* qas_r, float* qas_i, float* qal_r, float* qal_i, float* qpart,
    float* qsl, float* part, float* out, long long A1, int X, long long Q,
    int nblk, int slots, int bkind, int bwd_x3, int gram_x3, int fkind,
    int dot_x3, void* stream) {
  if (!high_kinds_ok(has_diag, diag_q, Q, bkind, fkind))
    return (int)cudaErrorInvalidValue;
  SmArgs a{};
  a.plane[0] = static_cast<char*>(fr);
  a.plane[1] = static_cast<char*>(fi);
  a.plane[2] = static_cast<char*>(br);
  a.plane[3] = static_cast<char*>(bi);
  a.op_inv = op_inv;
  a.op_t = op_t;
  a.dinv = DiagTables{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  a.dfwd = DiagTables{sl_r, sl_i, as_r, as_i, al_r, al_i};
  a.qo = QOut{qas_r, qas_i, qal_r, qal_i, qpart};
  a.part = part;
  a.Q = Q;
  a.post = Q >> 14;
  a.fkind = fkind;
  a.bkind = bkind;
  a.um = dot_x3 != 0;
  a.tm = bwd_x3 != 0;
  a.gm = gram_x3 != 0;
  // in 3xTF32 an operator meets exact planes (16-bit F or B, not rolled
  // back on load) in three parts (_tc.tc_operator's parts=6)
  const bool stored = !(has_diag && !diag_first_fwd);
  a.u3 = !a.um && stored && fkind != dqc::kStoreF32;
  a.t3 = !a.tm && stored && bkind != dqc::kStoreF32;
  a.has_diag = has_diag;
  a.diag_first_fwd = diag_first_fwd;
  a.diag_q = diag_q;
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 8: return launch_small<8>(a, A1, nblk, slots, out, qsl, s);
    case 16: return launch_small<16>(a, A1, nblk, slots, out, qsl, s);
    case 32: return launch_small<32>(a, A1, nblk, slots, out, qsl, s);
    case 64: return launch_small<64>(a, A1, nblk, slots, out, qsl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
