// One-pass adjoint step of a high-group block on f32 planes.
//
// Replaces the TPU kernel block_backward_high
// (dqc_tpu/ops/pallas/block_backward.py:906, pallas_call at :995, body
// _kernel_high at :756), for X <= 128, with its diag_q outputs. On the view
// (A1, X, Q = M 128)
// of the forward planes F and the cotangent planes B, with the group's
// operator E (X x X) on axis X, for every column:
//
//   F <- Einv F,   T0 += B F^T (contract the columns),   B <- E^T B
//
// with an optional fused diagonal run rolled back (F *= Dinv, B *= D) before
// the dense stage when the run followed it in the forward
// (diag_first_fwd = 0), after it otherwise. The run's tables are read in
// their canonical layout, tsl (128, 128) and tas/tal (A, 128), at
// a = (i X + x) post + p for view element (i, x, q = (p 128 + s) 128 + l),
// as csrc/high_apply.cu reads them. With diag_q, the run's Q reductions of
// the holomorphic product Q = B F, taken where the planes meet the run
// (before its update): Qsl (128 x 128, summed over every a), Qas and Qal
// (A x 128, summed over l and over s), a = (i X + x) post + p — the
// gradient sources of a run with variable gates (plane_scan._diag_cts_from_Q).
//
// Bound: operations. Three X-wide complex products per column, 3 X complex
// multiply-adds per amplitude (8 real flops each) against 32 bytes read and
// written: ~96 flop per byte at X = 128, above the H100's FP32 ridge
// (~20 flop/B). f32 FMA on the CUDA cores, no TF32.
//
// Design: adjoint.cuh on tiles of 8192 / X columns (all of one i, since
// they divide Q), in place: 512 threads, the uncompute and the transport at
// once on the two halves of the block. A grid of one block per SM loops over
// the tiles, and the pair grams' per-block, per-group partial slots are
// added in a fixed order by a second kernel. With diag_q the blocks walk
// the tiles one (i, p) group at a time (the 128 x 128 columns of one i and
// p: 16384 / C tiles), so that each Qas and Qal entry is written by one
// block only; the Q phase runs on the tiles already in shared memory
// (adjoint.cuh q_tile for QHigh): Qas and Qal entries are each added by one
// thread, tile after tile, and Qsl goes to one more partial slot per block,
// summed by the same fixed-order second kernel. Q adds 2 complex
// multiply-adds and 3 reductions per amplitude, and 2 x 2 A x 128 + 2 x 128 x
// 128 floats of outputs.
//
// X = 256 and 512, the merged top axis of a tiny top group (a lone dense
// block there as E (x) I, or the unfactorized hpair's merged operator;
// dqc_tpu/ops/planes.py backward_block :1085, backward_merged_top :308), run
// without a diagonal run. There the pair gram is X x X complex, 2 MiB at
// X = 512: it fits neither one block's registers nor its shared memory, so
// the one-pass design above does not carry over. It runs instead as
//
//   G = B F^T (the planes as they come in),  T0 = G Einv^T,
//   F <- Einv F,  B <- E^T B
//
// since B (Einv F)^T = (B F^T) Einv^T. G is a cross-Gram on the patch scheme
// of the wide Gram (csrc/gram.cu at X = 256 / 512): block (patch, column
// group) forms a 128 x 128 patch of G over its group's column tiles, in two
// levels (registers over four tiles, then a running sum in shared memory),
// writes it to its group's partial slot, and a second kernel adds the slots
// in a fixed order. T0 = G Einv^T is one X x X x X product (16 x 16 tiles,
// 0.1% of the work), and the two updates are the in-place wide apply
// (csrc/wide_apply.cuh), E^T read by columns. The planes are read once more
// than in one pass (48 bytes per amplitude against 32), but the work stays
// at the bound's 3 X complex multiply-adds per amplitude. Every sum runs in
// a fixed order.

#include "adjoint.cuh"
#include "wide_apply.cuh"

namespace {

using dqc::AdjCfg;
using dqc::DiagTables;
using dqc::DiagView;
using dqc::Operators;
using dqc::QHigh;

constexpr int kSl = dqc::kGroup * dqc::kGroup;

struct QOut {  // the diag_q outputs: Qas, Qal rows (A, 128), Qsl partial slots
  float* as_r;
  float* as_i;
  float* al_r;
  float* al_i;
  float* sl_part;  // nblk x 2 x 128 x 128
};

template <int X>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_high_kernel(float* fr, float* fi, float* br, float* bi,
                           Operators ops, DiagTables dinv, DiagTables dfwd,
                           int has_diag, int diag_first_fwd, int diag_q,
                           QOut qo, float* part, int64_t Q, int64_t post,
                           int64_t ntiles) {
  using Cfg = AdjCfg<X>;
  extern __shared__ float smem[];
  float* slots = part + (int64_t)blockIdx.x * Cfg::G * Cfg::kSlotFloats;
  const int diag_mode = has_diag ? (diag_first_fwd ? 2 : 1) : 0;
  // with diag_q a block takes whole (i, p) groups of kSl / C tiles
  const int64_t per_group = diag_q ? kSl / Cfg::C : 1;
  QHigh qh{qo.sl_part + (int64_t)blockIdx.x * 2 * kSl, qo.as_r, qo.as_i,
           qo.al_r, qo.al_i, 0, 0, post};
  for (int64_t grp = blockIdx.x; grp < ntiles / per_group; grp += gridDim.x) {
    for (int64_t k = 0; k < per_group; ++k) {
      const int64_t g0 = (grp * per_group + k) * Cfg::C;
      const int64_t i = g0 / Q;
      const int64_t q0 = g0 - i * Q;
      const int64_t t = i * X * Q + q0;
      DiagView vi{dinv, 2, i, q0, X, post};
      DiagView vf{dfwd, 2, i, q0, X, post};
      qh.i = i;
      qh.q0 = q0;
      dqc::adjoint_tile<X, QHigh>(fr + t, fi + t, br + t, bi + t, Q, 1, ops,
                                  diag_mode, vi, vf, slots, smem,
                                  diag_q ? &qh : nullptr);
    }
  }
}

template <int X>
int launch(float* fr, float* fi, float* br, float* bi, const Operators& ops,
           const DiagTables& dinv, const DiagTables& dfwd, int has_diag,
           int diag_first_fwd, int diag_q, const QOut& qo, float* qsl,
           float* part, float* out, long long A1, long long Q, int nblk,
           cudaStream_t stream) {
  using Cfg = AdjCfg<X>;
  if (Q % Cfg::C != 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = A1 * (Q / Cfg::C);
  const long long units = diag_q ? ntiles / (kSl / Cfg::C) : ntiles;
  if (units <= 0 || nblk <= 0 || nblk > units) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_backward_high_kernel<X>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  block_backward_high_kernel<X><<<nblk, dqc::kAdjThreads, Cfg::kSmemBytes,
                                  stream>>>(
      fr, fi, br, bi, ops, dinv, dfwd, has_diag, diag_first_fwd, diag_q, qo,
      part, (int64_t)Q, (int64_t)(Q >> 14), (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = dqc::launch_reduce(part, out, (int64_t)nblk * Cfg::G,
                                Cfg::kSlotFloats, stream);
  if (code != 0 || !diag_q) return code;
  return dqc::launch_reduce(qo.sl_part, qsl, nblk, 2 * kSl, stream);
}

// --- X = 256 / 512 ------------------------------------------------------

constexpr int kXgThreads = 512;
constexpr int kXgChunkTiles = 4;  // tiles summed in registers before a flush

struct XgCfg {
  static constexpr int RX = 8;            // patch rows per thread (of B)
  static constexpr int RY = 4;            // patch columns per thread (of F)
  static constexpr int TC = 128 / RY;     // column threads
  static constexpr int CB = 32;           // columns per tile
  static constexpr int LD = 128 + 1;      // padded tile row
  static constexpr int kTileFloats = CB * LD;
  static constexpr int kRunFloats = 2 * RX * RY * kXgThreads;
  static constexpr int kSmemBytes = (4 * kTileFloats + kRunFloats) * (int)sizeof(float);
  static_assert((128 / RX) * TC == kXgThreads, "one thread per patch cell group");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// run[(2 (i RY + j) + {0: re, 1: im}) kXgThreads + thread] += the register
// sums, which restart at 0: this thread's running sums in shared memory.
__device__ __forceinline__ void xg_flush(float (&Gr)[XgCfg::RX][XgCfg::RY],
                                         float (&Gi)[XgCfg::RX][XgCfg::RY],
                                         float* run) {
#pragma unroll
  for (int i = 0; i < XgCfg::RX; ++i)
#pragma unroll
    for (int j = 0; j < XgCfg::RY; ++j) {
      float* a = run + 2 * (i * XgCfg::RY + j) * kXgThreads + threadIdx.x;
      a[0] += Gr[i][j];
      a[kXgThreads] += Gi[i][j];
      Gr[i][j] = Gi[i][j] = 0.f;
    }
}

// Block (bx NRB + by, group) adds G[x, y] = sum_q B[x, q] F[y, q] (complex,
// no conjugation) for x in patch row bx, y in patch column by, over the
// column tiles tile = group, group + gridDim.y, ... of the view (P, X, Q),
// into part[group][0 / 1][x][y] (re / im): each entry has one writer.
template <int NRB>
__global__ void __launch_bounds__(kXgThreads, 1)
cross_gram_wide_kernel(const float* __restrict__ br, const float* __restrict__ bi,
                       const float* __restrict__ fr, const float* __restrict__ fi,
                       float* __restrict__ part, int64_t Q, int64_t ntiles) {
  constexpr int X = NRB * 128;
  constexpr int RX = XgCfg::RX, RY = XgCfg::RY, TC = XgCfg::TC;
  constexpr int CB = XgCfg::CB, LD = XgCfg::LD;
  extern __shared__ float smem[];
  float* sbr = smem;                 // B rows of patch row bx, tile [c][x]
  float* sbi = sbr + XgCfg::kTileFloats;
  float* sfr = sbi + XgCfg::kTileFloats;  // F rows of patch column by
  float* sfi = sfr + XgCfg::kTileFloats;
  float* run = sfi + XgCfg::kTileFloats;  // running sums, one set per thread

  const int bx = (int)(blockIdx.x / NRB), by = (int)(blockIdx.x % NRB);
  const int tid = threadIdx.x;
  const int rx = (tid / TC) * RX;  // rows rx + i
  const int cy = tid % TC;         // columns cy + TC * j

  float Gr[RX][RY], Gi[RX][RY];
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) Gr[i][j] = Gi[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < 2 * RX * RY; ++k) run[k * kXgThreads + tid] = 0.f;

  int chunk = 0;
  for (int64_t tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int64_t g0 = tile * CB;
    const int64_t p = g0 / Q, q0 = g0 - p * Q;
    const int64_t base = p * X * Q + q0;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < CB * 128; e += kXgThreads) {
      const int x = e / CB, c = e % CB;
      const int64_t ob = base + (int64_t)(bx * 128 + x) * Q + c;
      const int64_t of = base + (int64_t)(by * 128 + x) * Q + c;
      sbr[c * LD + x] = br[ob];
      sbi[c * LD + x] = bi[ob];
      sfr[c * LD + x] = fr[of];
      sfi[c * LD + x] = fi[of];
    }
    __syncthreads();
    for (int c = 0; c < CB; ++c) {
      float ar[RX], ai[RX], vr[RY], vi[RY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        ar[i] = sbr[c * LD + rx + i];
        ai[i] = sbi[c * LD + rx + i];
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        vr[j] = sfr[c * LD + cy + TC * j];
        vi[j] = sfi[c * LD + cy + TC * j];
      }
#pragma unroll
      for (int i = 0; i < RX; ++i)
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          Gr[i][j] = fmaf(ar[i], vr[j], Gr[i][j]);
          Gr[i][j] = fmaf(-ai[i], vi[j], Gr[i][j]);
          Gi[i][j] = fmaf(ar[i], vi[j], Gi[i][j]);
          Gi[i][j] = fmaf(ai[i], vr[j], Gi[i][j]);
        }
    }
    if (++chunk == kXgChunkTiles) {
      xg_flush(Gr, Gi, run);
      chunk = 0;
    }
  }
  xg_flush(Gr, Gi, run);

  float* out = part + (int64_t)blockIdx.y * 2 * X * X;
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const float* a = run + 2 * (i * RY + j) * kXgThreads + tid;
      const int64_t e = (int64_t)(bx * 128 + rx + i) * X + by * 128 + cy + TC * j;
      out[e] = a[0];
      out[(int64_t)X * X + e] = a[kXgThreads];
    }
}

// T0[x, y] = sum_k G[x, k] Einv[y, k] (complex), 16 x 16 output tiles with
// 16-deep tiles of G and Einv through shared memory; g and t0 hold (re, im)
// planes of X x X.
template <int X>
__global__ void __launch_bounds__(256)
gram_times_inv_t_kernel(const float* __restrict__ g,
                        const float* __restrict__ einv_r,
                        const float* __restrict__ einv_i,
                        float* __restrict__ t0) {
  __shared__ float sgr[16][17], sgi[16][17], ser[16][17], sei[16][17];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int x = blockIdx.y * 16 + ty, y = blockIdx.x * 16 + tx;
  const int yrow = blockIdx.x * 16 + ty;  // the Einv row this thread loads
  float accr = 0.f, acci = 0.f;
  for (int k0 = 0; k0 < X; k0 += 16) {
    sgr[ty][tx] = g[x * X + k0 + tx];
    sgi[ty][tx] = g[X * X + x * X + k0 + tx];
    ser[ty][tx] = einv_r[yrow * X + k0 + tx];
    sei[ty][tx] = einv_i[yrow * X + k0 + tx];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float ar = sgr[ty][kk], ai = sgi[ty][kk];
      const float vr = ser[tx][kk], vi = sei[tx][kk];
      accr = fmaf(ar, vr, accr);
      accr = fmaf(-ai, vi, accr);
      acci = fmaf(ar, vi, acci);
      acci = fmaf(ai, vr, acci);
    }
    __syncthreads();
  }
  t0[x * X + y] = accr;
  t0[X * X + x * X + y] = acci;
}

template <int X>
int launch_wide(float* fr, float* fi, float* br, float* bi, const Operators& ops,
                float* part, float* gram, float* out, long long A1,
                long long Q, int nblk, cudaStream_t stream) {
  constexpr int NRB = X / 128;
  const long long ntiles = A1 * (Q / XgCfg::CB);
  if (Q % XgCfg::CB != 0 || nblk <= 0 || nblk > 65535 || nblk > ntiles)
    return (int)cudaErrorInvalidValue;
  // 1. G = B F^T on the planes as they come in
  cudaError_t err = cudaFuncSetAttribute(
      cross_gram_wide_kernel<NRB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      XgCfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cross_gram_wide_kernel<NRB><<<dim3(NRB * NRB, nblk), kXgThreads,
                                XgCfg::kSmemBytes, stream>>>(
      br, bi, fr, fi, part, (int64_t)Q, (int64_t)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = dqc::launch_reduce(part, gram, nblk, 2 * X * X, stream);
  if (code != 0) return code;
  // 2. T0 = G Einv^T
  gram_times_inv_t_kernel<X><<<dim3(X / 16, X / 16), 256, 0, stream>>>(
      gram, ops.inv_r, ops.inv_i, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. F <- Einv F, B <- E^T B, in place
  code = dqc::launch_wide_apply<X>(fr, fi, fr, fi, ops.inv_r, ops.inv_i, 0, 0,
                                   0, A1, Q, stream);
  if (code != 0) return code;
  return dqc::launch_wide_apply<X>(br, bi, br, bi, ops.e_r, ops.e_i, 1, 0, 0,
                                   A1, Q, stream);
}

}  // namespace

// The number of partial slots per block of the pair gram at this X (the
// caller sizes the scratch: nblk * slots * 2 * X * X floats), 0 for an X the
// kernel does not take.
extern "C" int dqc_block_backward_high_slots(int X) {
  switch (X) {
    case 8: return AdjCfg<8>::G;
    case 16: return AdjCfg<16>::G;
    case 32: return AdjCfg<32>::G;
    case 64: return AdjCfg<64>::G;
    case 128: return AdjCfg<128>::G;
    default: return 0;
  }
}

// In place on the view (A1, X, Q = M 128), X in {8, 16, 32, 64, 128}:
// (F, B) <- the adjoint step of E; out = (T0 re, T0 im), 2 x X x X floats.
// part is scratch of nblk * slots(X) * 2 X X floats, set to zero by the
// caller; nblk is the number of blocks (at most the number of tiles,
// A1 Q X / 8192, or with diag_q of (i, p) groups, A1 Q / (128 128)). With
// has_diag, Q must be a multiple of 128 * 128. The twelve table pointers may
// be null when has_diag is 0. With diag_q (needs has_diag): qas_r/i and
// qal_r/i are (A, 128) outputs, A = A1 X Q / (128 128), set to zero by the
// caller; qpart is scratch of nblk * 2 * 128 * 128 floats set to zero, and
// qsl the (Qsl re, im) output, 2 x 128 x 128 floats (all null without).
// Returns cudaGetLastError().
extern "C" int dqc_block_backward_high(
    float* fr, float* fi, float* br, float* bi, const float* einv_r,
    const float* einv_i, const float* e_r, const float* e_i,
    const float* isl_r, const float* isl_i, const float* ias_r,
    const float* ias_i, const float* ial_r, const float* ial_i,
    const float* sl_r, const float* sl_i, const float* as_r,
    const float* as_i, const float* al_r, const float* al_i, int has_diag,
    int diag_first_fwd, int diag_q, float* qas_r, float* qas_i, float* qal_r,
    float* qal_i, float* qpart, float* qsl, float* part, float* out,
    long long A1, int X, long long Q, int nblk, void* stream) {
  if (has_diag && Q % (128 * 128) != 0) return (int)cudaErrorInvalidValue;
  if (diag_q && !has_diag) return (int)cudaErrorInvalidValue;
  const Operators ops{einv_r, einv_i, e_r, e_i};
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const QOut qo{qas_r, qas_i, qal_r, qal_i, qpart};
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 8: return launch<8>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                             diag_first_fwd, diag_q, qo, qsl, part, out, A1,
                             Q, nblk, s);
    case 16: return launch<16>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, diag_q, qo, qsl, part, out, A1,
                               Q, nblk, s);
    case 32: return launch<32>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, diag_q, qo, qsl, part, out, A1,
                               Q, nblk, s);
    case 64: return launch<64>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                               diag_first_fwd, diag_q, qo, qsl, part, out, A1,
                               Q, nblk, s);
    case 128: return launch<128>(fr, fi, br, bi, ops, dinv, dfwd, has_diag,
                                 diag_first_fwd, diag_q, qo, qsl, part, out,
                                 A1, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// In place on the view (A1, X, Q = M 128), X in {256, 512}, Q a multiple of
// 32: (F, B) <- the adjoint step of E without a diagonal run; out = (T0 re,
// T0 im), 2 x X x X floats. part is scratch of nblk * 2 * X * X floats
// (every entry written) and gram of 2 * X * X; nblk is the number of column
// groups (at most 65535 and A1 Q / 32). Returns cudaGetLastError().
extern "C" int dqc_block_backward_high_wide(
    float* fr, float* fi, float* br, float* bi, const float* einv_r,
    const float* einv_i, const float* e_r, const float* e_i, float* part,
    float* gram, float* out, long long A1, int X, long long Q, int nblk,
    void* stream) {
  const Operators ops{einv_r, einv_i, e_r, e_i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 256: return launch_wide<256>(fr, fi, br, bi, ops, part, gram, out, A1,
                                      Q, nblk, s);
    case 512: return launch_wide<512>(fr, fi, br, bi, ops, part, gram, out, A1,
                                      Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
