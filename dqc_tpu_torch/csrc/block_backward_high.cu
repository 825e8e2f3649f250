// One-pass adjoint step of a high-group block on the planes.
//
// Replaces the TPU kernel block_backward_high
// (dqc_tpu/ops/pallas/block_backward.py:906, pallas_call at :995, body
// _kernel_high at :756), with its diag_q outputs. On the view
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
// Bound: at X = 128 operations, three X-wide complex products per column,
// 3 X complex multiply-adds per amplitude (8 real flops each) against 32
// bytes read and written: ~96 flop per byte, above the H100's FP32 ridge
// (~20 flop/B); on the tensor cores, as the dual adjoint's step (3xTF32 or
// bf16x3: three passes per real product at 495 / 989 TFLOP/s, a pass fewer
// where a planes operand's lo parts are zero). X = 8..64 is
// block_backward_high_small.cu's tensor-core step, a library of its own.
//
// Design at X = 128: the tile is 128 rows at stride Q by 64 contiguous
// columns, the dual adjoint's 128 x 64 tile, in place: tc_adjoint.cuh's
// step (its tiles unpadded and swizzled in shared memory, loaded in
// 256-byte row runs, every product on mma.sync on all 16 warps, Einv and
// E^T pre-split by the wrapper and streamed through a cp.async ring),
// without the dual adjoint's staging, one pair-gram slot per block. A grid
// of one block per SM loops over the tiles, and the slots are added in a
// fixed order by a second kernel. With diag_q the blocks walk the tiles one
// (i, p) group at a time (the 128 x 128 columns of one i and p: 256 tiles),
// so that each Qas and Qal entry is written by one block only; the Q phase
// runs on the tiles already in shared memory (adjoint.cuh q_tile for QHigh,
// its row-chunk partials in the idle operator ring): Qas and Qal entries
// are each added by one thread, tile after tile, and Qsl goes to one more
// partial slot per block, summed by the same fixed-order second kernel. Q
// adds 2 complex multiply-adds and 3 reductions per amplitude, and 2 x 2 A x
// 128 + 2 x 128 x 128 floats of outputs.
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
// since B (Einv F)^T = (B F^T) Einv^T. G is a cross-Gram on the tensor
// cores (3xTF32 with f32 grams, three bf16 products with gram_x3; B and F
// decoded from their storage as a 16-column tile is staged, f32 through a
// two-stage cp.async ring): block (patch, column group) forms a 128 x 128
// patch of G over its group's column tiles, 8 warps of 32 x 64 in
// registers (128 accumulators a thread, one block per SM), adds it to its
// group's partial slot every 8 tiles, and a second kernel adds the slots
// in a fixed order. A taller patch does not fit: 256 x 128 complex is the
// SM's whole register file. So the planes are read X / 128 times each (32
// bytes an amplitude at X = 256, 64 at X = 512). T0 = G Einv^T is one X x X
// x X product (16 x 16 tiles, 0.1% of the work). The two updates are not
// launched here: the wrapper runs them as the in-place tensor-core apply of
// the high_apply library (csrc/tc_apply.cuh, dqc_tc_apply) on Einv and E^T,
// each pre-split for its dot mode, after this entry's G. Every sum runs in
// a fixed order.
//
// Reduced storage and bf16x3 (the TPU kernel's bwd_dot_mode and
// gram_dot_mode at block_backward.py:826-835): B is stored as f32, bf16 or
// f16 (bkind; one load and one store per element, as in the TPU kernel),
// the transport runs bf16x3 with bwd_x3 and the pair gram with gram_x3,
// else 3xTF32. X = 256 / 512 takes the same modes: the cross-Gram decodes B
// as it stages it; the transport is the tensor-core apply in place on B in
// its storage, bf16x3 with bwd_x3 (one load and one store of B there, as in
// the TPU kernel; the cross-Gram's read of B comes before it).
//
// "bf16" storage and the forward bf16x3 (the TPU kernel's f32_of / store_as
// on F and its dot_mode), at every X: F may be stored as bf16 (one load and
// one store per element, as in the TPU kernel) and the uncompute runs
// bf16x3 with dot_x3. At X = 128 the tensor-core step takes F's kind at run
// time (one branch per tile to a load and a store of each kind). At X =
// 256 / 512 the cross-Gram decodes F as it stages it and the uncompute is
// the tensor-core apply in place on F in its storage, bf16x3 with dot_x3.
#include "block_backward_high.cuh"
#include "tc_adjoint.cuh"

namespace {

// --- X = 128 on the tensor cores ------------------------------------------

using dqc::TcOps;

// block_backward_high_kernel's walk at X = 128, each tile a step of
// tc_adjoint.cuh without the dual adjoint's staging (stage 0: F and B are
// rounded to their storage once, as they are stored; Q reads the f32
// values); one pair-gram slot per block.
template <int UM, int TM, bool GX3>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_high_tc_kernel(char* fr, char* fi, char* br, char* bi,
                              int bkind, int fkind, TcOps ops, DiagTables dinv,
                              DiagTables dfwd, int has_diag, int diag_first_fwd,
                              int diag_q, QOut qo, float* part, int64_t Q,
                              int64_t post, int64_t ntiles) {
  constexpr int X = dqc::kGroup;
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  float* slot = part + (int64_t)blockIdx.x * 2 * X * X;
  const int diag_mode = has_diag ? (diag_first_fwd ? 2 : 1) : 0;
  QHigh qh{qo.sl_part + (int64_t)blockIdx.x * 2 * kSl, qo.as_r, qo.as_i,
           qo.al_r, qo.al_i, 0, 0, post};
  for_each_tile<dqc::TcRows::C>(Q, ntiles, diag_q, [&](int64_t i, int64_t q0) {
    const int64_t t = i * X * Q + q0;
    DiagView vi{dinv, 2, i, q0, X, post};
    DiagView vf{dfwd, 2, i, q0, X, post};
    qh.i = i;
    qh.q0 = q0;
    dqc::tc_adjoint_tile<UM, TM, GX3>(
        fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize, bkind,
        fkind, 0, Q, 1, ops, diag_mode, vi, vf, slot, diag_q ? &qh : nullptr);
  });
}

template <int UM, int TM, bool GX3>
int launch_high_tc(char* fr, char* fi, char* br, char* bi, int bkind,
                   int fkind, const TcOps& ops, const DiagTables& dinv,
                   const DiagTables& dfwd, int has_diag, int diag_first_fwd,
                   int diag_q, const QOut& qo, float* qsl, float* part,
                   float* out, long long A1, long long Q, int nblk,
                   cudaStream_t stream) {
  constexpr int X = dqc::kGroup, kSmem = dqc::kTcAdjSmemBytes;
  const long long ntiles = high_tiles(dqc::TcRows::C, A1, Q, diag_q, nblk);
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  auto kernel = block_backward_high_tc_kernel<UM, TM, GX3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, dqc::kAdjThreads, kSmem, stream>>>(
      fr, fi, br, bi, bkind, fkind, ops, dinv, dfwd, has_diag, diag_first_fwd,
      diag_q, qo, part, (int64_t)Q, (int64_t)(Q >> 14), (int64_t)ntiles);
  return high_reduce(part, out, nblk, 2 * X * X, diag_q, qo, qsl, nblk, stream);
}

// --- X = 256 / 512 ------------------------------------------------------

constexpr int kXgThreads = 256;

template <int MODE>
struct XgCfg {
  static constexpr int CB = 16;          // columns per tile (the product's k)
  static constexpr int KS = MODE == dqc::kTf32x3 ? 8 : 16;  // k of one mma
  static constexpr int LD = CB + (MODE == dqc::kTf32x3 ? 4 : 8);  // tile row
  static constexpr int kArr = 128 * LD;  // one staged array: 128 rows
  static constexpr int kStage = 4 * kArr;  // B re, im, F re, im
  static constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float);
  static constexpr int kFlushTiles = 8;  // tiles summed in registers (128
                                         // columns) before a flush
};

// One operand pair (re, im) of a tile: 128 rows x CB columns from element
// base (row 0, the tile's first column) of planes stored as kind, into
// dst (re at dst, im at dst + kArr). f32: cp.async straight into the
// tile; 16-bit: two 16-byte loads a thread into held, decoded and stored
// by xg_finish once the tile before it is consumed.
template <int MODE>
__device__ __forceinline__ void xg_issue(float* dst, const void* pr,
                                         const void* pi, int kind,
                                         int64_t base, int64_t Q,
                                         uint4 (&held)[2]) {
  using Cfg = XgCfg<MODE>;
  if (kind == dqc::kStoreF32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 2 arrays x 128 rows x 4 pieces
      const int e = threadIdx.x + kXgThreads * j;
      const int arr = e >> 9, row = (e >> 2) & 127, piece = e & 3;
      const float* src = static_cast<const float*>(arr ? pi : pr) + base +
                         (int64_t)row * Q + 4 * piece;
      dqc::cp_async16(dst + arr * Cfg::kArr + row * Cfg::LD + 4 * piece, src);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 2 arrays x 128 rows x 2 pieces
      const int e = threadIdx.x + kXgThreads * j;
      const int arr = e >> 8, row = (e >> 1) & 127, piece = e & 1;
      held[j] = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(arr ? pi : pr) + base +
          (int64_t)row * Q + 8 * piece));
    }
  }
}

template <int MODE>
__device__ __forceinline__ void xg_finish(float* dst, int kind,
                                          const uint4 (&held)[2]) {
  using Cfg = XgCfg<MODE>;
  if (kind == dqc::kStoreF32) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = threadIdx.x + kXgThreads * j;
    const int arr = e >> 8, row = (e >> 1) & 127, piece = e & 1;
    float v[4], w[4];
    const uint2 lo = make_uint2(held[j].x, held[j].y);
    const uint2 hi = make_uint2(held[j].z, held[j].w);
    dqc::load4(&lo, 0, kind, v);
    dqc::load4(&hi, 0, kind, w);
    float* o = dst + arr * Cfg::kArr + row * Cfg::LD + 8 * piece;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(w[0], w[1], w[2], w[3]);
  }
}

// Block (bx NRB + by, group) adds G[x, y] = sum_q B[x, q] F[y, q] (complex,
// no conjugation) for x in patch row bx, y in patch column by (a 128 x 128
// patch), over the column tiles tile = group, group + gridDim.y, ... of
// the view (P, X, Q), into part[group][0 / 1][x][y] (re / im): each entry
// has one writer. B is stored as bkind, F as fkind (common.cuh codec),
// decoded as a tile is staged. The products run on the tensor cores, 3xTF32
// or bf16x3 (MODE); warp w forms the 32 x 64 block at rows 32 (w / 2),
// columns 64 (w % 2) of the patch, 2 x 8 m16n8 tiles in registers, and
// adds it to its slot every kFlushTiles tiles (a short run in f32, then a
// running sum).
template <int NRB, int MODE>
__global__ void __launch_bounds__(kXgThreads, 1)
cross_gram_tc_kernel(const void* __restrict__ br, const void* __restrict__ bi,
                     const void* __restrict__ fr, const void* __restrict__ fi,
                     int bkind, int fkind, float* __restrict__ part, int64_t Q,
                     int64_t ntiles) {
  using Cfg = XgCfg<MODE>;
  constexpr int X = NRB * 128, CB = Cfg::CB, LD = Cfg::LD;
  extern __shared__ float4 xg_smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(xg_smem4);
  const int bx = (int)(blockIdx.x / NRB), by = (int)(blockIdx.x % NRB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  // the lo parts of 16-bit planes are zero (3xTF32), of bf16 planes in bf16x3
  const bool b_exact = MODE == dqc::kTf32x3 ? bkind != dqc::kStoreF32
                                            : bkind == dqc::kStoreBF16;
  const bool f_exact = MODE == dqc::kTf32x3 ? fkind != dqc::kStoreF32
                                            : fkind == dqc::kStoreBF16;
  auto tile_base = [&](int64_t tile, int rb) {
    const int64_t g0 = tile * CB, p = g0 / Q;
    return p * X * Q + (g0 - p * Q) + (int64_t)rb * 128 * Q;
  };
  auto issue = [&](int64_t tile, float* stage, uint4 (&hb)[2], uint4 (&hf)[2]) {
    xg_issue<MODE>(stage, br, bi, bkind, tile_base(tile, bx), Q, hb);
    xg_issue<MODE>(stage + 2 * Cfg::kArr, fr, fi, fkind, tile_base(tile, by), Q,
                   hf);
    dqc::cp_async_commit();
  };
  auto finish = [&](float* stage, const uint4 (&hb)[2], const uint4 (&hf)[2]) {
    xg_finish<MODE>(stage, bkind, hb);
    xg_finish<MODE>(stage + 2 * Cfg::kArr, fkind, hf);
  };

  float accr[8][2][4], acci[8][2][4];  // [n][m][fragment entry]
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) accr[n][m][e] = acci[n][m][e] = 0.f;
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
          float2* pr = reinterpret_cast<float2*>(out + x * X + y);
          float2* pi = reinterpret_cast<float2*>(out + (int64_t)X * X + x * X + y);
          float2 vr = make_float2(accr[n][m][2 * h], accr[n][m][2 * h + 1]);
          float2 vi = make_float2(acci[n][m][2 * h], acci[n][m][2 * h + 1]);
          if (!first) {
            const float2 sr = *pr, si = *pi;
            vr.x += sr.x;
            vr.y += sr.y;
            vi.x += si.x;
            vi.y += si.y;
          }
          *pr = vr;
          *pi = vi;
        }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) accr[n][m][e] = acci[n][m][e] = 0.f;
  };

  uint4 hb[2], hf[2];
  int64_t tile = blockIdx.y;
  if (tile < ntiles) {
    issue(tile, smem, hb, hf);
    finish(smem, hb, hf);
  }
  int k = 0;
  bool first = true;
  for (; tile < ntiles; tile += gridDim.y, ++k) {
    float* stage = smem + (k & 1) * Cfg::kStage;
    float* next = smem + ((k + 1) & 1) * Cfg::kStage;
    const bool more = tile + gridDim.y < ntiles;
    if (more) {
      issue(tile + gridDim.y, next, hb, hf);
      dqc::cp_async_wait<1>();
    } else {
      dqc::cp_async_wait<0>();
    }
    __syncthreads();  // this tile is staged and seen by every warp
    const float* sbr = stage;
    const float* sbi = stage + Cfg::kArr;
    const float* sfr = stage + 2 * Cfg::kArr;
    const float* sfi = stage + 3 * Cfg::kArr;
#pragma unroll
    for (int ks = 0; ks < CB; ks += Cfg::KS) {
      dqc::CFrag<4> a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        dqc::load_a<MODE, dqc::RowMajor<LD>>(sbr, sbi, wm * 32 + 16 * m, ks, a[m]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        dqc::CFrag<2> b;
        dqc::load_b_rows<MODE, dqc::RowMajor<LD>>(sfr, sfi, wn * 64 + 8 * n, ks, b);
        dqc::cmma3<MODE, 2>(accr[n], acci[n], a, b, b_exact, f_exact);
      }
    }
    if (more) finish(next, hb, hf);  // its stage's last reads ended a tile ago
    __syncthreads();  // this stage consumed before it is refilled
    if ((k + 1) % Cfg::kFlushTiles == 0) {
      flush(first);
      first = false;
    }
  }
  if (k % Cfg::kFlushTiles != 0 || first) flush(first);
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

template <int X, int MODE>
int launch_cross_gram(const void* br, const void* bi, const void* fr,
                      const void* fi, int bkind, int fkind, float* part,
                      long long Q, long long ntiles, int nblk,
                      cudaStream_t stream) {
  constexpr int NRB = X / 128;
  auto kernel = cross_gram_tc_kernel<NRB, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XgCfg<MODE>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(NRB * NRB, nblk), kXgThreads, XgCfg<MODE>::kSmemBytes, stream>>>(
      br, bi, fr, fi, bkind, fkind, part, (int64_t)Q, (int64_t)ntiles);
  return (int)cudaGetLastError();
}

// G = B F^T and T0 = G Einv^T (Einv f32); the planes are left as they are.
template <int X>
int launch_wide(const void* fr, const void* fi, const void* br,
                const void* bi, int bkind, int fkind, int gram_x3,
                const float* einv_r, const float* einv_i, float* part,
                float* gram, float* out, long long A1, long long Q, int nblk,
                cudaStream_t stream) {
  constexpr int CB = XgCfg<dqc::kTf32x3>::CB;
  const long long ntiles = A1 * (Q / CB);
  if (Q % CB != 0 || nblk <= 0 || nblk > 65535 || nblk > ntiles ||
      bkind < 0 || bkind > 2 || fkind < 0 || fkind > 1 ||
      (fkind == dqc::kStoreBF16 && bkind != dqc::kStoreBF16))
    return (int)cudaErrorInvalidValue;
  // 1. G = B F^T on the planes as they come in (bf16 F: "bf16" storage,
  //    where B is bf16 too)
  auto gram_fn = gram_x3 ? launch_cross_gram<X, dqc::kBf16x3>
                         : launch_cross_gram<X, dqc::kTf32x3>;
  int code = gram_fn(br, bi, fr, fi, bkind, fkind, part, Q, ntiles, nblk, stream);
  if (code != 0) return code;
  code = dqc::launch_reduce(part, gram, nblk, 2 * X * X, stream);
  if (code != 0) return code;
  // 2. T0 = G Einv^T
  gram_times_inv_t_kernel<X><<<dim3(X / 16, X / 16), 256, 0, stream>>>(
      gram, einv_r, einv_i, out);
  return (int)cudaGetLastError();
}
}  // namespace

// In place on the view (A1, 128, Q = M 128): (F, B) <- the adjoint step of
// E; out = (T0 re, T0 im), 2 x 128 x 128 floats. op_inv = Einv pre-split in the
// uncompute's mode (dot_x3), op_t = E^T in the transport's (bwd_x3)
// (ops/kernels/_tc.tc_operator, in three parts where 3xTF32 meets a 16-bit
// F or B that the step holds exact: not after a run rolled back on load);
// part is scratch of nblk * 2 * 128 * 128 floats (one slot a block).
// Returns cudaGetLastError().
extern "C" int dqc_block_backward_high_tc(
    void* fr, void* fi, void* br, void* bi, const uint32_t* op_inv,
    const uint32_t* op_t, const float* isl_r, const float* isl_i,
    const float* ias_r, const float* ias_i, const float* ial_r,
    const float* ial_i, const float* sl_r, const float* sl_i,
    const float* as_r, const float* as_i, const float* al_r,
    const float* al_i, int has_diag, int diag_first_fwd, int diag_q,
    float* qas_r, float* qas_i, float* qal_r, float* qal_i, float* qpart,
    float* qsl, float* part, float* out, long long A1, long long Q, int nblk,
    int bkind, int bwd_x3, int gram_x3, int fkind, int dot_x3, void* stream) {
  if (!high_kinds_ok(has_diag, diag_q, Q, bkind, fkind))
    return (int)cudaErrorInvalidValue;
  constexpr int F = dqc::kTf32x3, H = dqc::kBf16x3;
  using Fn = int (*)(char*, char*, char*, char*, int, int, const TcOps&,
                     const DiagTables&, const DiagTables&, int, int, int,
                     const QOut&, float*, float*, float*, long long, long long,
                     int, cudaStream_t);
  static const Fn table[8] = {
      launch_high_tc<F, F, false>, launch_high_tc<F, F, true>,
      launch_high_tc<F, H, false>, launch_high_tc<F, H, true>,
      launch_high_tc<H, F, false>, launch_high_tc<H, F, true>,
      launch_high_tc<H, H, false>, launch_high_tc<H, H, true>};
  const int k = 4 * (dot_x3 != 0) + 2 * (bwd_x3 != 0) + (gram_x3 != 0);
  return table[k](static_cast<char*>(fr), static_cast<char*>(fi),
                  static_cast<char*>(br), static_cast<char*>(bi), bkind, fkind,
                  TcOps{op_inv, op_t},
                  DiagTables{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i},
                  DiagTables{sl_r, sl_i, as_r, as_i, al_r, al_i}, has_diag,
                  diag_first_fwd, diag_q,
                  QOut{qas_r, qas_i, qal_r, qal_i, qpart}, qsl, part, out, A1,
                  Q, nblk, (cudaStream_t)stream);
}

// On the view (A1, X, Q = M 128), X in {256, 512}, Q a multiple of 64, the
// first half of the adjoint step of E without a diagonal run: out = (T0
// re, T0 im) = (B F^T) Einv^T, 2 x X x X floats, from the planes as they
// come in (the caller then updates them: F <- Einv F, B <- E^T B). einv_r /
// einv_i are Einv (f32). part is scratch of nblk * 2 * X * X floats (every
// entry written) and gram of 2 * X * X; nblk is the number of column groups
// (at most 65535 and A1 Q / 16). B is stored as bkind (0 f32, 1 bf16, 2
// f16), F as fkind (0 f32, 1 bf16: with bf16 B, "bf16" storage); gram_x3
// runs the cross-Gram bf16x3, else 3xTF32. Returns cudaGetLastError().
extern "C" int dqc_block_backward_high_wide(
    const void* fr, const void* fi, const void* br, const void* bi, int bkind,
    int fkind, const float* einv_r, const float* einv_i, float* part,
    float* gram, float* out, long long A1, int X, long long Q, int nblk,
    int gram_x3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (X) {
    case 256:
      return launch_wide<256>(fr, fi, br, bi, bkind, fkind, gram_x3, einv_r,
                              einv_i, part, gram, out, A1, Q, nblk, s);
    case 512:
      return launch_wide<512>(fr, fi, br, bi, bkind, fkind, gram_x3, einv_r,
                              einv_i, part, gram, out, A1, Q, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
