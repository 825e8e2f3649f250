// Fused diagonal-run sweep and its one-pass adjoint on f32 planes.
//
// Replaces the TPU kernels diag_sweep_planes (dqc_tpu/ops/pallas/diag.py:75,
// pallas_call at :90) and diag_backward_planes (:154, at :184, body
// _kernel_bwd at :105) with its Q reductions. A run of commuting diagonal gates is one
// elementwise multiply by its total diagonal, factored over the plane axes
// (a = merged high groups, s = sublane, l = lane) as
// D[a, s, l] = (tas[a, s] tal[a, l]) tsl[s, l], the association order of the
// TPU kernels (common.cuh diag_at):
//
//   sweep:     x   *= D
//   backward:  fwd *= Dinv,  bwd *= D
//
// in place on planes (A, 128, 128). With Q (a run with variable gates) the
// backward also forms the reductions of the holomorphic product
// Q[a, s, l] = bwd fwd, taken before the update: Qsl (128 x 128, summed over
// a), Qas (A x 128, summed over l) and Qal (A x 128, summed over s) — the
// gradient sources of the run's variable gates.
//
// Bound: bytes. One read and one write of each plane, 16 bytes per amplitude
// for the sweep and 32 for the backward, against 3 (6) complex multiplies:
// under 2 flop per byte, far below the H100's FP32 ridge (~20 flop/B).
//
// Design: each thread takes four consecutive lanes of one (a, s) row as
// float4 loads and stores of the planes and of the tal / tsl table rows
// (tables stay in L2: at most 2 x (A + 128) x 128 complex entries), and tas
// as one broadcast complex scalar; a grid-stride loop over the float4s with
// int64 offsets (a 30-qubit plane has 2^30 elements).
//
// The Q mode (the one-pass backward with the reductions) is bound by the
// same bytes plus Q's outputs. Its kernel holds what would cost a round
// trip on the SM: persistent blocks of 512 threads, one an SM, walk their
// slabs a in grid-stride order; each thread loads a group of two rows of a
// slab (32-64 KB of loads in flight an SM) before it uses any, and reads
// and writes each amplitude once: the values it loaded give Q and are
// updated and stored. The block's Qsl partial lives in shared memory
// (128 KB), each entry added to by the one thread that owns it, slab after
// slab, and written to the block's slot once, after the walk; a second
// kernel adds the slots in block order.
// A group's row sums (Qas) go over the lanes as one batched butterfly; a
// column's Qal entry sums 16 per-warp partials in warp order, from a
// shared buffer of two (one barrier a slab, after the next slab's loads are
// issued). No sum depends on scheduling. Q adds 1 complex multiply and 3
// reductions per amplitude, and 2 x 2 A x 128 + 2 x 128 x 128 floats of
// outputs.
//
// Reduced storage (the TPU kernel's f32_of / store_as at diag.py:117-150):
// the backward's B is stored as f32, bf16 or f16 (bkind, common.cuh codec;
// F stays f32), read and written four elements at a time (8 bytes for a
// 16-bit B), decoded to f32 before the multiply and the Q reductions. The
// backward then moves 24 bytes per amplitude against 32.
//
// "bf16" storage: the forward planes may be stored as bf16 too (the sweep's
// x and the backward's F, with or without the Q reductions; the kind a
// template parameter so that the f32 sweeps keep their float4 code),
// decoded on load (Q takes the decoded F, as the TPU kernel's f32_of at
// diag.py:117-120) and rounded on store, 8 bytes per amplitude for the
// sweep against 16.

#include <type_traits>

#include "common.cuh"

namespace {

using dqc::DiagTables;
using dqc::cmul;
using dqc::load4;
using dqc::store4;

constexpr int kThreads = 256;

__device__ __forceinline__ void diag4(const DiagTables& d, int64_t a, int s,
                                      int l0, float (&dr)[4], float (&di)[4]) {
  const int64_t as = a * dqc::kGroup + s;
  const float tas_r = __ldg(d.as_r + as), tas_i = __ldg(d.as_i + as);
  const float4 alr = __ldg(reinterpret_cast<const float4*>(d.al_r + a * dqc::kGroup + l0));
  const float4 ali = __ldg(reinterpret_cast<const float4*>(d.al_i + a * dqc::kGroup + l0));
  const float4 slr = __ldg(reinterpret_cast<const float4*>(d.sl_r + s * dqc::kGroup + l0));
  const float4 sli = __ldg(reinterpret_cast<const float4*>(d.sl_i + s * dqc::kGroup + l0));
  const float al_r[4] = {alr.x, alr.y, alr.z, alr.w};
  const float al_i[4] = {ali.x, ali.y, ali.z, ali.w};
  const float sl_r[4] = {slr.x, slr.y, slr.z, slr.w};
  const float sl_i[4] = {sli.x, sli.y, sli.z, sli.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float mr, mi;
    cmul(tas_r, tas_i, al_r[k], al_i[k], mr, mi);
    cmul(mr, mi, sl_r[k], sl_i[k], dr[k], di[k]);
  }
}

// x[e] *= D at float4 index e of the planes (4 lanes of one (a, s) row).
__device__ __forceinline__ void times_diag(float* xr, float* xi,
                                           const DiagTables& d, int64_t e) {
  const int64_t a = e >> 12;              // 128 * 32 float4s per slab
  const int s = (int)((e >> 5) & 127);
  const int l0 = (int)(e & 31) * 4;
  float dr[4], di[4];
  diag4(d, a, s, l0, dr, di);
  float4* pr = reinterpret_cast<float4*>(xr) + e;
  float4* pi = reinterpret_cast<float4*>(xi) + e;
  const float4 vr = *pr, vi = *pi;
  const float ar[4] = {vr.x, vr.y, vr.z, vr.w};
  const float ai[4] = {vi.x, vi.y, vi.z, vi.w};
  float yr[4], yi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) cmul(ar[k], ai[k], dr[k], di[k], yr[k], yi[k]);
  *pr = make_float4(yr[0], yr[1], yr[2], yr[3]);
  *pi = make_float4(yi[0], yi[1], yi[2], yi[3]);
}

// x[e] *= D at float4 index e of planes stored as kind.
__device__ __forceinline__ void times_diag_kind(void* xr, void* xi, int kind,
                                                const DiagTables& d,
                                                int64_t e) {
  const int64_t a = e >> 12;
  const int s = (int)((e >> 5) & 127);
  const int l0 = (int)(e & 31) * 4;
  float dr[4], di[4], ar[4], ai[4], yr[4], yi[4];
  diag4(d, a, s, l0, dr, di);
  load4(xr, e, kind, ar);
  load4(xi, e, kind, ai);
#pragma unroll
  for (int k = 0; k < 4; ++k) cmul(ar[k], ai[k], dr[k], di[k], yr[k], yi[k]);
  store4(xr, e, kind, yr);
  store4(xi, e, kind, yi);
}

// x[e] *= D at float4 index e of planes stored as KIND (known at compile
// time: the f32 planes keep times_diag's float4 code).
template <int KIND>
__device__ __forceinline__ void times_diag_of(void* xr, void* xi,
                                              const DiagTables& d, int64_t e) {
  if constexpr (KIND == dqc::kStoreF32)
    times_diag(static_cast<float*>(xr), static_cast<float*>(xi), d, e);
  else
    times_diag_kind(xr, xi, KIND, d, e);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
diag_sweep_kernel(void* xr, void* xi, DiagTables d, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads)
    times_diag_of<KIND>(xr, xi, d, e);
}

template <int FKIND>
__global__ void __launch_bounds__(kThreads)
diag_backward_kernel(void* fr, void* fi, void* br, void* bi, int bkind,
                     DiagTables dinv, DiagTables dfwd, int64_t n4) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (int64_t)gridDim.x * kThreads) {
    times_diag_of<FKIND>(fr, fi, dinv, e);
    times_diag_kind(br, bi, bkind, dfwd, e);
  }
}

// --- The backward with the Q reductions ----------------------------------

constexpr int kQThreads = 512;                  // one persistent block an SM
constexpr int kQWarps = kQThreads / 32;
constexpr int kQRows = dqc::kGroup / kQWarps;   // rows of a slab per warp
constexpr int kSlab = dqc::kGroup * dqc::kGroup;
// shared memory: the block's Qsl partial (re, then im) and two buffers of
// the warps' Qal partials [buffer][re, im][warp][l]
constexpr int kColFloats = 2 * kQWarps * dqc::kGroup;
constexpr int kQSmemBytes = (2 * kSlab + 2 * kColFloats) * (int)sizeof(float);

// The rows of a slab a thread loads before it uses any (a group): 32-64 KB
// of loads in flight an SM (more rows a group spilled at the 128 registers
// of 512 threads and ran slower).
constexpr int kQGroupRows = 2;

// Four elements of a plane as stored: a float4, or four 16-bit codes.
template <int KIND>
using Raw4 = std::conditional_t<KIND == dqc::kStoreF32, float4, uint2>;

template <int KIND>
__device__ __forceinline__ Raw4<KIND> load_raw(const void* p, int64_t e) {
  return reinterpret_cast<const Raw4<KIND>*>(p)[e];
}

// x (four decoded elements of row s of slab a) times the run's D, stored
// to the planes as KIND at float4 index e.
template <int KIND>
__device__ __forceinline__ void store_times_diag(void* xr, void* xi,
                                                 const DiagTables& d,
                                                 int64_t a, int s, int l0,
                                                 int64_t e, const float (&ar)[4],
                                                 const float (&ai)[4]) {
  float dr[4], di[4], yr[4], yi[4];
  diag4(d, a, s, l0, dr, di);
#pragma unroll
  for (int k = 0; k < 4; ++k) cmul(ar[k], ai[k], dr[k], di[k], yr[k], yi[k]);
  dqc::store4(xr, e, KIND, yr);
  dqc::store4(xi, e, KIND, yi);
}

// One exchange of the batched butterfly over the warp's lanes, then the
// rest: before the exchange at offset OFF the lane holds N OFF / 16 values
// (at least one); with more than one it keeps the half that its OFF bit
// selects and adds the partner's values of that half, else it adds the
// partner's one value. Every value is thus summed as the tree of xor
// offsets 16, 8, 4, 2, 1 (lane t with t + 16 first), the same on every
// lane that holds it (each pair's sum commutes).
template <int N, int OFF>
__device__ __forceinline__ void lane_tree(float (&v)[N], int lane) {
  if constexpr (OFF > 0) {
    constexpr int n = N * OFF / 16 > 1 ? N * OFF / 16 : 1;
    if constexpr (n > 1) {
      const bool hi = (lane & OFF) != 0;
#pragma unroll
      for (int j = 0; j < n / 2; ++j) {
        const float keep = hi ? v[j + n / 2] : v[j];
        const float send = hi ? v[j] : v[j + n / 2];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    }
    lane_tree<N, OFF / 2>(v, lane);
  }
}

// Persistent blocks of 512 threads, one an SM, walk their slabs a in
// grid-stride order. Thread (w, t) owns lanes l0 = 4 t .. 4 t + 3 of rows
// s = w + 16 k (k = 0..7) of every slab, and the same entries of the
// block's Qsl partial in shared memory: it alone adds to them, slab after
// slab, and writes them to the block's slot once, after the walk. A slab
// goes in groups of G rows: the thread issues the group's plane loads, then
// decodes each row once, forms Q = B F, adds it to Qsl, to its row sums
// ((q0 + q1) + q2) + q3 and to its column partials (rows in k order), and
// stores the row's F Dinv and B D. A group's 2 G row sums go over the lanes
// as one batched butterfly (lane_tree). At the end of a slab each warp's
// column partials go to a shared buffer (two, alternating by slab); after
// the next slab's first loads are issued, one barrier, and 256 threads add
// the 16 warps' partials in warp order into Qal. No sum depends on
// scheduling.
template <int FKIND, int BKIND>
__global__ void __launch_bounds__(kQThreads, 1)
diag_backward_q_kernel(void* fr, void* fi, void* br, void* bi,
                       DiagTables dinv, DiagTables dfwd, float* qas_r,
                       float* qas_i, float* qal_r, float* qal_i, float* part,
                       int64_t A) {
  constexpr int G = kQGroupRows;
  extern __shared__ float4 q_smem[];
  float* qsl = reinterpret_cast<float*>(q_smem);    // [re, im][s][l]
  float* col = qsl + 2 * kSlab;                     // [buffer][re, im][w][l]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = 4 * lane;
#pragma unroll
  for (int k = 0; k < kQRows; ++k) {
    const int at = (warp + kQWarps * k) * dqc::kGroup + l0;
    *reinterpret_cast<float4*>(qsl + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qsl + kSlab + at) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the Qal entries of slab `done`, from the partials in buffer `buf`
  auto column_sums = [&](int64_t done, int buf) {
    __syncthreads();  // every warp's partials of that slab are in place
    if (threadIdx.x < 2 * dqc::kGroup) {
      const int c = threadIdx.x / dqc::kGroup, l = threadIdx.x % dqc::kGroup;
      const float* p = col + (buf * 2 + c) * kQWarps * dqc::kGroup + l;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kQWarps; ++w) t += p[w * dqc::kGroup];
      (c ? qal_i : qal_r)[done * dqc::kGroup + l] = t;
    }
  };
  int64_t done = -1;
  int buf = 0;
  for (int64_t a = blockIdx.x; a < A; a += gridDim.x) {
    float cr[4] = {0.f, 0.f, 0.f, 0.f}, ci[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int g = 0; g < kQRows / G; ++g) {
      Raw4<FKIND> ufr[G], ufi[G];
      Raw4<BKIND> ubr[G], ubi[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int s = warp + kQWarps * (g * G + j);
        const int64_t e = (a * dqc::kGroup + s) * 32 + lane;  // float4 index
        ufr[j] = load_raw<FKIND>(fr, e);
        ufi[j] = load_raw<FKIND>(fi, e);
        ubr[j] = load_raw<BKIND>(br, e);
        ubi[j] = load_raw<BKIND>(bi, e);
      }
      if (g == 0 && done >= 0) column_sums(done, buf ^ 1);
      float rows[2 * G];  // row j's sum of Q over the lane's four: re, im
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int s = warp + kQWarps * (g * G + j);
        const int64_t e = (a * dqc::kGroup + s) * 32 + lane;
        float far[4], fai[4], bar[4], bai[4], qr[4], qi[4];
        // common.cuh's decode, on the values already loaded
        load4(&ufr[j], 0, FKIND, far);
        load4(&ufi[j], 0, FKIND, fai);
        load4(&ubr[j], 0, BKIND, bar);
        load4(&ubi[j], 0, BKIND, bai);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cmul(bar[k], bai[k], far[k], fai[k], qr[k], qi[k]);
          cr[k] += qr[k];
          ci[k] += qi[k];
        }
        float4* sr = reinterpret_cast<float4*>(qsl + s * dqc::kGroup + l0);
        float4* si = reinterpret_cast<float4*>(qsl + kSlab + s * dqc::kGroup + l0);
        float4 vr = *sr, vi = *si;
        vr.x += qr[0]; vr.y += qr[1]; vr.z += qr[2]; vr.w += qr[3];
        vi.x += qi[0]; vi.y += qi[1]; vi.z += qi[2]; vi.w += qi[3];
        *sr = vr;
        *si = vi;
        rows[2 * j] = ((qr[0] + qr[1]) + qr[2]) + qr[3];
        rows[2 * j + 1] = ((qi[0] + qi[1]) + qi[2]) + qi[3];
        store_times_diag<FKIND>(fr, fi, dinv, a, s, l0, e, far, fai);
        store_times_diag<BKIND>(br, bi, dfwd, a, s, l0, e, bar, bai);
      }
      // the lane holds value (lane / (16 / G)) of the group: row v / 2,
      // its real part for even v
      lane_tree<2 * G, 16>(rows, lane);
      if (lane % (16 / G) == 0) {
        const int v = lane / (16 / G);
        const int s = warp + kQWarps * (g * G + v / 2);
        ((v & 1) ? qas_i : qas_r)[a * dqc::kGroup + s] = rows[0];
      }
    }
    float* p = col + buf * 2 * kQWarps * dqc::kGroup + warp * dqc::kGroup + l0;
    *reinterpret_cast<float4*>(p) = make_float4(cr[0], cr[1], cr[2], cr[3]);
    *reinterpret_cast<float4*>(p + kQWarps * dqc::kGroup) =
        make_float4(ci[0], ci[1], ci[2], ci[3]);
    done = a;
    buf ^= 1;
  }
  if (done >= 0) column_sums(done, buf ^ 1);
  float* slot = part + (int64_t)blockIdx.x * 2 * kSlab;
#pragma unroll
  for (int k = 0; k < kQRows; ++k) {
    const int at = (warp + kQWarps * k) * dqc::kGroup + l0;
    *reinterpret_cast<float4*>(slot + at) = *reinterpret_cast<const float4*>(qsl + at);
    *reinterpret_cast<float4*>(slot + kSlab + at) =
        *reinterpret_cast<const float4*>(qsl + kSlab + at);
  }
}

template <int FKIND, int BKIND>
int launch_backward_q(void* fr, void* fi, void* br, void* bi,
                      const DiagTables& dinv, const DiagTables& dfwd,
                      float* qas_r, float* qas_i, float* qal_r, float* qal_i,
                      float* part, int64_t A, int nblk, cudaStream_t s) {
  auto kernel = diag_backward_q_kernel<FKIND, BKIND>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nblk, kQThreads, kQSmemBytes, s>>>(fr, fi, br, bi, dinv, dfwd,
                                              qas_r, qas_i, qal_r, qal_i,
                                              part, A);
  return (int)cudaGetLastError();
}

int grid_for(int64_t n4) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;  // enough blocks in flight per SM
  return (int)(want < cap ? want : cap);
}

}  // namespace

// x <- x * D in place on planes (A, 128, 128) stored as kind (0 f32, 1
// bf16); the tables as in common.cuh, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dqc_diag_sweep(void* xr, void* xi, const float* sl_r,
                              const float* sl_i, const float* as_r,
                              const float* as_i, const float* al_r,
                              const float* al_i, long long A, int kind,
                              void* stream) {
  if (A <= 0 || kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const DiagTables d{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  auto kernel = kind == dqc::kStoreF32 ? diag_sweep_kernel<dqc::kStoreF32>
                                       : diag_sweep_kernel<dqc::kStoreBF16>;
  kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(xr, xi, d, n4);
  return (int)cudaGetLastError();
}

// fwd <- fwd * Dinv, bwd <- bwd * D in place on planes (A, 128, 128): the six
// tables of the run's inverse, then the run's; bwd stored as bkind (0 f32,
// 1 bf16, 2 f16), fwd as fkind (0 f32, 1 bf16). Returns cudaGetLastError().
extern "C" int dqc_diag_backward(void* fr, void* fi, void* br, void* bi,
                                 const float* isl_r, const float* isl_i,
                                 const float* ias_r, const float* ias_i,
                                 const float* ial_r, const float* ial_i,
                                 const float* sl_r, const float* sl_i,
                                 const float* as_r, const float* as_i,
                                 const float* al_r, const float* al_i,
                                 long long A, int bkind, int fkind,
                                 void* stream) {
  if (A <= 0 || bkind < 0 || bkind > 2 || fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  const int64_t n4 = (int64_t)A * 128 * 32;
  auto kernel = fkind == dqc::kStoreF32 ? diag_backward_kernel<dqc::kStoreF32>
                                        : diag_backward_kernel<dqc::kStoreBF16>;
  kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      fr, fi, br, bi, bkind, dinv, dfwd, n4);
  return (int)cudaGetLastError();
}

// The backward with the Q reductions, taken before the update: qas_r/i and
// qal_r/i are (A, 128) outputs; part is scratch of nblk * 2 * 128 * 128
// floats (nblk blocks, at most A, one an SM: each writes its whole slot),
// qsl the (Qsl re, im) output, 2 x 128 x 128 floats; bwd stored as bkind
// (0 f32, 1 bf16, 2 f16), fwd as fkind (0 f32, 1 bf16). Returns
// cudaGetLastError().
extern "C" int dqc_diag_backward_q(void* fr, void* fi, void* br, void* bi,
                                   const float* isl_r, const float* isl_i,
                                   const float* ias_r, const float* ias_i,
                                   const float* ial_r, const float* ial_i,
                                   const float* sl_r, const float* sl_i,
                                   const float* as_r, const float* as_i,
                                   const float* al_r, const float* al_i,
                                   float* qas_r, float* qas_i, float* qal_r,
                                   float* qal_i, float* part, float* qsl,
                                   long long A, int nblk, int bkind,
                                   int fkind, void* stream) {
  if (A <= 0 || nblk <= 0 || nblk > A || bkind < 0 || bkind > 2 ||
      fkind < 0 || fkind > 1)
    return (int)cudaErrorInvalidValue;
  const DiagTables dinv{isl_r, isl_i, ias_r, ias_i, ial_r, ial_i};
  const DiagTables dfwd{sl_r, sl_i, as_r, as_i, al_r, al_i};
  cudaStream_t s = (cudaStream_t)stream;
  using dqc::kStoreBF16;
  using dqc::kStoreF16;
  using dqc::kStoreF32;
  auto launch = launch_backward_q<kStoreF32, kStoreF32>;
  if (fkind == kStoreF32)
    launch = bkind == kStoreF32    ? launch_backward_q<kStoreF32, kStoreF32>
             : bkind == kStoreBF16 ? launch_backward_q<kStoreF32, kStoreBF16>
                                   : launch_backward_q<kStoreF32, kStoreF16>;
  else
    launch = bkind == kStoreF32    ? launch_backward_q<kStoreBF16, kStoreF32>
             : bkind == kStoreBF16 ? launch_backward_q<kStoreBF16, kStoreBF16>
                                   : launch_backward_q<kStoreBF16, kStoreF16>;
  const int code = launch(fr, fi, br, bi, dinv, dfwd, qas_r, qas_i, qal_r,
                          qal_i, part, (int64_t)A, nblk, s);
  if (code != 0) return code;
  return dqc::launch_reduce(part, qsl, nblk, 2 * kSlab, s);
}
