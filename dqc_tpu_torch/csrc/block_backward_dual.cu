// One-pass adjoint step of a lane + sublane block pair on the planes.
//
// Replaces the TPU kernel block_backward_dual
// (dqc_tpu/ops/pallas/block_backward.py:437, pallas_call at :499, body
// _kernel_dual at :240), with its diag_q outputs: the backward mirror of
// dual_group_apply_planes. For
// every 128 x 128 slab of the forward planes F and the cotangent planes B
// (A, 128, 128), with lane operator E0 (the last axis) and sublane operator
// E1 (the middle axis), in tape order:
//
//   sublane step: F <- E1inv F, T0_sub += B F^T (contract lanes), B <- E1^T B
//   lane step:    F <- F E0inv^T, T0_lane += B^T F (contract sublanes),
//                 B <- B E0
//
// With g0_first (the lane block came first in the forward) the sublane block
// is rolled back first, so its T0 sees the lane block still applied. A fused
// diagonal run is rolled back (F *= Dinv, B *= D) before both steps when it
// followed the pair in the forward (diag_first_fwd = 0), after them when it
// preceded it. The pair grams are holomorphic (no conjugation) and summed
// over every slab. With diag_q, the run's Q reductions of the holomorphic
// product Q[a, s, l] = B F, taken where the planes meet the run (before its
// update): Qsl (128 x 128, summed over every slab), Qas (A x 128, summed over
// l) and Qal (A x 128, summed over s) — the gradient sources of a run with
// variable gates (plane_scan._diag_cts_from_Q).
//
// The lane adjoint (block_backward_lane, block_backward.py:88, body _kernel
// at :35) is the lane step alone and the sublane adjoint
// (block_backward_sublane, block_backward.py:184, pallas_call at :209, body
// _kernel_sub at :133) the sublane step alone, so this library builds both
// too (dqc_block_backward_lane and dqc_block_backward_sublane below): the
// same kernel with one step, no run.
//
// Bound: operations on the tensor cores. Six 128-wide complex products per
// slab, 768 complex multiply-adds per amplitude: the uncomputes and the
// transports (512) as 3xTF32 ("f32": three tf32 passes per real product at
// 495 TFLOP/s) or bf16x3 (three bf16 passes at 989), the pair grams (256)
// bf16x3 by default or 3xTF32, a pass fewer where a planes operand's lo
// parts are zero; against 32 bytes read and written per amplitude (24 with
// a 16-bit B, 16 with both pairs 16-bit). At 29 qubits on f32 planes with
// the default bf16x3 pair grams: ~16.7 ms of tensor-core passes against
// 5.1 ms of HBM traffic (on the CUDA cores' FP32 rate the same work was a
// 49 ms floor).
//
// Design: F and B of one slab are 256 KB, more than a block's 227 KB of
// shared memory. Each step is separable along the axis it does not
// contract, so a block walks its slab as two 64-wide tiles per step
// (tc_adjoint.cuh: the tiles in shared memory, every product on mma.sync
// through mma.cuh's cmma3, the operators pre-split by the wrapper and
// streamed through a cp.async ring): the sublane step in column tiles, the
// lane step in row tiles, staging the first step's results through the
// slab's own place in the planes, which only this block touches and which
// stays in L2. A grid of one block per SM loops over the slabs; each block
// sums its pair grams into its own partial slots, added in block order by a
// second kernel. The Q reductions are formed in the step that meets the
// run, from the tiles of F and B already in shared memory (adjoint.cuh
// q_tile): Qsl into one more partial slot per block (2 x 64 KB, in the
// tile's order so that a warp's reductions land on adjacent entries:
// transposed when the run meets a lane step), added by the same second
// pass; the rows of Qas and Qal by warp shuffles and a fixed-order sum of
// per-warp column partials, written by the block that owns the slab. Q adds
// 2 complex multiply-adds and 4 reductions per amplitude of the step that
// meets the run, and 2 x 2 A x 128 + 2 x 128 x 128 floats of outputs.
//
// Reduced storage and the dot modes (the TPU kernel's f32_of / store_as,
// dot_mode, bwd_dot_mode and gram_dot_mode at block_backward.py:283-308): B
// is stored as f32, bf16 or f16 (bkind) and F as f32 or bf16 (fkind), both
// kinds read at run time at the loads and stores only; the uncomputes run
// bf16x3 with dot_x3, the transports with bwd_x3, the pair grams with
// gram_x3, else 3xTF32. F and B are rounded to their storage where the TPU
// kernel stores and reloads them: between the two steps (here the staging
// through the planes) and next to the run.

#include "tc_adjoint.cuh"

namespace {

using dqc::DiagTables;
using dqc::DiagView;
using dqc::TcOps;

constexpr int N = dqc::kGroup;
constexpr int kSlab = N * N;
// per block: T0_lane (re, im), T0_sub (re, im) and, with diag_q, Qsl (re, im)
constexpr int kPartFloats = 4 * kSlab;
constexpr int kPartFloatsQ = 6 * kSlab;
constexpr int kPartFloatsOne = 2 * kSlab;  // the lane or sublane adjoint: T0

struct QRows {  // the (A, 128) outputs Qas and Qal
  float* as_r;
  float* as_i;
  float* al_r;
  float* al_i;
};

// nsteps 2: the dual step (sublane and lane, in g0_first's order); 1: one
// step alone, the lane step (g0_first 0: the lane adjoint) or the sublane
// step (g0_first 1: the sublane adjoint), no run, stage off. part holds
// part_floats per block: T0_lane, then T0_sub, then Qsl (one step: its T0).
template <int UM, int TM, bool GX3>
__global__ void __launch_bounds__(dqc::kAdjThreads, 1)
block_backward_dual_kernel(char* fr, char* fi, char* br, char* bi,
                           int bkind, int fkind, TcOps lane, TcOps sub,
                           DiagTables dinv, DiagTables dfwd, int has_diag,
                           int diag_first_fwd, int g0_first, int diag_q,
                           QRows qrows, float* part, int part_floats, int64_t A,
                           int nsteps) {
  const int bsize = bkind == dqc::kStoreF32 ? 4 : 2;  // bytes per B element
  const int fsize = fkind == dqc::kStoreF32 ? 4 : 2;  // bytes per F element
  float* part_lane = part + (int64_t)blockIdx.x * part_floats;
  float* part_sub = part_lane + (nsteps - 1) * 2 * kSlab;
  dqc::QView qv{part_sub + 2 * kSlab, qrows.as_r, qrows.as_i, qrows.al_r,
                qrows.al_i, 0, 0, 0};
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    const int64_t off = a * kSlab;
    for (int step = 0; step < nsteps; ++step) {
      const bool sublane = (step == 0) == (g0_first != 0);
      int diag_mode = 0;
      if (has_diag && step == 0 && !diag_first_fwd) diag_mode = 1;
      if (has_diag && step == 1 && diag_first_fwd) diag_mode = 2;
      for (int h = 0; h < 2; ++h) {
        // sublane step: column tile l in [64 h, 64 h + 64), x = s;
        // lane step: row tile s in [64 h, 64 h + 64), x = l
        const int64_t t = sublane ? off + 64 * h : off + 64 * h * N;
        const int64_t rs = sublane ? N : 1, cs = sublane ? 1 : N;
        DiagView vi{dinv, sublane ? 0 : 1, a, 64 * h, N, 0};
        DiagView vf{dfwd, sublane ? 0 : 1, a, 64 * h, N, 0};
        qv.a = a;
        qv.sublane = sublane;
        qv.c0 = 64 * h;
        dqc::tc_adjoint_tile<UM, TM, GX3>(
            fr + t * fsize, fi + t * fsize, br + t * bsize, bi + t * bsize,
            bkind, fkind, nsteps == 2, rs, cs, sublane ? sub : lane, diag_mode,
            vi, vf, sublane ? part_sub : part_lane,
            diag_q && diag_mode ? &qv : nullptr);
      }
    }
  }
}

template <int UM, int TM, bool GX3>
int launch(void* fr, void* fi, void* br, void* bi, int bkind, int fkind,
           const TcOps& lane, const TcOps& sub, const DiagTables& dinv,
           const DiagTables& dfwd, int has_diag, int diag_first_fwd,
           int g0_first, int diag_q, const QRows& qrows, float* part,
           int part_floats, int64_t A, int nblk, int nsteps, cudaStream_t s) {
  constexpr int kSmem = dqc::kTcAdjSmemBytes;
  auto kernel = block_backward_dual_kernel<UM, TM, GX3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, dqc::kAdjThreads, kSmem, s>>>(
      static_cast<char*>(fr), static_cast<char*>(fi), static_cast<char*>(br),
      static_cast<char*>(bi), bkind, fkind, lane, sub, dinv, dfwd, has_diag,
      diag_first_fwd, g0_first, diag_q, qrows, part, part_floats, A, nsteps);
  return (int)cudaGetLastError();
}

// The instance of the three dot modes (x3: bf16x3, else 3xTF32).
int launch_modes(int dot_x3, int bwd_x3, int gram_x3, void* fr, void* fi,
                 void* br, void* bi, int bkind, int fkind, const TcOps& lane,
                 const TcOps& sub, const DiagTables& dinv,
                 const DiagTables& dfwd, int has_diag, int diag_first_fwd,
                 int g0_first, int diag_q, const QRows& qrows, float* part,
                 int part_floats, int64_t A, int nblk, int nsteps,
                 cudaStream_t s) {
  constexpr int F = dqc::kTf32x3, H = dqc::kBf16x3;
  using Fn = int (*)(void*, void*, void*, void*, int, int, const TcOps&,
                     const TcOps&, const DiagTables&, const DiagTables&, int,
                     int, int, int, const QRows&, float*, int, int64_t, int,
                     int, cudaStream_t);
  static const Fn table[8] = {launch<F, F, false>, launch<F, F, true>,
                              launch<F, H, false>, launch<F, H, true>,
                              launch<H, F, false>, launch<H, F, true>,
                              launch<H, H, false>, launch<H, H, true>};
  const int k = 4 * (dot_x3 != 0) + 2 * (bwd_x3 != 0) + (gram_x3 != 0);
  return table[k](fr, fi, br, bi, bkind, fkind, lane, sub, dinv, dfwd,
                  has_diag, diag_first_fwd, g0_first, diag_q, qrows, part,
                  part_floats, A, nblk, nsteps, s);
}

// One step alone on planes (A, 128, 128): the sublane step, else the lane
// step.
int launch_one(int sublane, void* fr, void* fi, void* br, void* bi, int bkind,
               int fkind, const uint32_t* op_inv, const uint32_t* op_t,
               float* part, float* out, long long A, int nblk, int bwd_x3,
               int gram_x3, int dot_x3, cudaStream_t s) {
  if (A <= 0 || nblk <= 0 || nblk > A || bkind < 0 || bkind > 2 ||
      fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  const TcOps ops{op_inv, op_t};
  const DiagTables none{};
  const QRows no_q{};
  const int code = launch_modes(dot_x3, bwd_x3, gram_x3, fr, fi, br, bi, bkind,
                                fkind, ops, ops, none, none, 0, 0, sublane, 0,
                                no_q, part, kPartFloatsOne, (int64_t)A, nblk, 1,
                                s);
  if (code != 0) return code;
  return dqc::launch_reduce(part, out, nblk, kPartFloatsOne, s);
}

}  // namespace

// In place on planes (A, 128, 128): (F, B) <- the adjoint step of the lane
// operator E0 and sublane operator E1; out = (T0_lane re, im, T0_sub re, im),
// 4 x 128 x 128 floats, then with diag_q (Qsl re, im), 2 x 128 x 128 more,
// transposed ([l][s]) when the run meets the lane step: the step after the
// pair with diag_first_fwd, the step before it otherwise; the lane step is
// the second with g0_first. The operators come pre-split in mma fragment
// order (ops/kernels/_tc.tc_operator): op_e0inv = E0inv and op_e1inv =
// E1inv in the uncomputes' mode (dot_x3), op_e0t = E0^T and op_e1t = E1^T
// in the transports' (bwd_x3). B is stored as bkind (0 f32, 1 bf16, 2 f16 in
// common.cuh's codec), F as fkind (0 f32, 1 bf16); bwd_x3 / gram_x3 /
// dot_x3 run the transports / the pair grams / the uncomputes bf16x3, else
// 3xTF32. part is scratch of nblk * (4 or 6) * 128 * 128 floats, set to
// zero by the caller, and nblk the number of blocks (at most A). The twelve
// table pointers may be null when has_diag is 0. With diag_q (needs
// has_diag), qas_r/i and qal_r/i are (A, 128) outputs set to zero by the
// caller (null without). Returns cudaGetLastError().
extern "C" int dqc_block_backward_dual(
    void* fr, void* fi, void* br, void* bi, const uint32_t* op_e0inv,
    const uint32_t* op_e0t, const uint32_t* op_e1inv, const uint32_t* op_e1t,
    const float* isl_r, const float* isl_i, const float* ias_r,
    const float* ias_i, const float* ial_r, const float* ial_i,
    const float* sl_r, const float* sl_i, const float* as_r,
    const float* as_i, const float* al_r, const float* al_i, int has_diag,
    int diag_first_fwd, int g0_first, int diag_q, float* qas_r, float* qas_i,
    float* qal_r, float* qal_i, float* part, float* out, long long A,
    int nblk, int bkind, int bwd_x3, int gram_x3, int fkind, int dot_x3,
    void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A || (diag_q && !has_diag) || bkind < 0 ||
      bkind > 2 || fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const TcOps lane{op_e0inv, op_e0t};
  const TcOps sub{op_e1inv, op_e1t};
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const QRows qrows{qas_r, qas_i, qal_r, qal_i};
  const int part_floats = diag_q ? kPartFloatsQ : kPartFloats;
  const int code = launch_modes(dot_x3, bwd_x3, gram_x3, fr, fi, br, bi, bkind,
                                fkind, lane, sub, dinv, dfwd, has_diag,
                                diag_first_fwd, g0_first, diag_q, qrows, part,
                                part_floats, (int64_t)A, nblk, 2, s);
  if (code != 0) return code;
  return dqc::launch_reduce(part, out, nblk, part_floats, s);
}

// The lane adjoint (block_backward.py:88), in place on planes (A, 128,
// 128): (F, B) <- the adjoint step of the lane operator E (F <- F Einv^T,
// T0 += B^T F, B <- B E); out = (T0 re, T0 im), 2 x 128 x 128 floats. op_inv
// = Einv pre-split in the uncompute's mode (dot_x3), op_t = E^T in the
// transport's (bwd_x3); part is scratch of nblk * 2 * 128 * 128 floats, set
// to zero by the caller. Kinds and modes as dqc_block_backward_dual's.
// Returns cudaGetLastError().
extern "C" int dqc_block_backward_lane(void* fr, void* fi, void* br, void* bi,
                                       int bkind, int fkind,
                                       const uint32_t* op_inv,
                                       const uint32_t* op_t, float* part,
                                       float* out, long long A, int nblk,
                                       int bwd_x3, int gram_x3, int dot_x3,
                                       void* stream) {
  return launch_one(0, fr, fi, br, bi, bkind, fkind, op_inv, op_t, part,
                    out, A, nblk, bwd_x3, gram_x3, dot_x3, (cudaStream_t)stream);
}

// The sublane adjoint (block_backward.py:184), in place on planes (A, 128,
// 128): (F, B) <- the adjoint step of the sublane operator E (F <- Einv F,
// T0 += B F^T, B <- E^T B); arguments as dqc_block_backward_lane's.
// Returns cudaGetLastError().
extern "C" int dqc_block_backward_sublane(void* fr, void* fi, void* br,
                                          void* bi, int bkind, int fkind,
                                          const uint32_t* op_inv,
                                          const uint32_t* op_t, float* part,
                                          float* out, long long A, int nblk,
                                          int bwd_x3, int gram_x3, int dot_x3,
                                          void* stream) {
  return launch_one(1, fr, fi, br, bi, bkind, fkind, op_inv, op_t,
                    part, out, A, nblk, bwd_x3, gram_x3, dot_x3,
                    (cudaStream_t)stream);
}
