// Tensor-core building blocks of the dqc_tpu_torch kernels: the operand
// splits of the two split-precision products and mma.sync in each.
//
// "f32" dot mode as 3xTF32: hi = tf32(a) and lo = tf32(a - hi), both
// rounded to nearest (ties away, cvt.rna), and a b ~ ah bh + ah bl + al bh
// in m16n8k8 tf32 products with f32 accumulation. One pass of TF32 alone
// keeps ~11 bits, which the "f32" mode does not accept; the three passes
// leave ~2^-21 of each product.
//
// bf16x3 (dqc_tpu/ops/pallas/dots.py _dot_bf16x3): hi = bf16(a), lo =
// bf16(a - hi), the same three products in m16n8k16 bf16, as
// common.cuh's split_hl takes them on the CUDA cores.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace dqc {

enum : int { kTf32x3 = 0, kBf16x3 = 1 };  // the split product modes

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a -> its tf32 hi and lo parts, as mma.sync takes them (f32 bit patterns
// with the low 13 bits zero).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// Two floats (the lower index first) as the hi and lo bf16 parts of a
// bf16x2 register each, for mma.sync.
__device__ __forceinline__ void split_bf16x2(float2 v, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - __low2float(h),
                                                 v.y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation on the tensor
// cores (a: 4 registers of the row-major 16 x 16 A fragment, b: 2 of the
// column-major 16 x 8 B fragment). Not volatile: a pure function of its
// registers, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, one m16n8k8 tf32 product with f32 accumulation (a: the row-major
// 16 x 8 A fragment, b: the column-major 8 x 8 B fragment).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (the accumulator's inputs one zero register: no zeroed copies).
__device__ __forceinline__ void mma_tf32_0(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
__device__ __forceinline__ void mma_bf16_0(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// One k-step of a complex product on fragments split into parts. The A
// fragment (4 registers per part) and the B fragment (2 per part) hold the
// same shapes in both modes: m16n8k8 tf32 (k = 8) or m16n8k16 bf16 (k = 16).
template <int N>
struct CFrag {
  uint32_t rh[N], rl[N], ih[N], il[N];  // re and im, hi and lo parts
};

// The sign bit of every value of a split register.
template <int MODE>
constexpr uint32_t kNegMask = MODE == kTf32x3 ? 0x80000000u : 0x80008000u;

template <int MODE>
__device__ __forceinline__ void mma_op(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (MODE == kTf32x3)
    mma_tf32(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

template <int MODE>
__device__ __forceinline__ void mma_op0(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (MODE == kTf32x3)
    mma_tf32_0(d, a, b0, b1);
  else
    mma_bf16_0(d, a, b0, b1);
}

// The hi (LO false) or lo parts of an A fragment's re and im.
template <bool LO>
__device__ __forceinline__ const uint32_t (&frag_re(const CFrag<4>& f))[4] {
  if constexpr (LO) return f.rl; else return f.rh;
}
template <bool LO>
__device__ __forceinline__ const uint32_t (&frag_im(const CFrag<4>& f))[4] {
  if constexpr (LO) return f.il; else return f.ih;
}

// One pass of a complex product on split fragments: tr[m] (+)= Xr[m] Yr -
// Xi[m] Yi, ti[m] (+)= Xr[m] Yi + Xi[m] Yr for A's hi or lo parts X (ALO)
// and B's parts Y (nyi: Yi with its signs flipped), from zero with ZERO.
// The 2 M chains go one product each in turn, so that neighbouring
// products do not wait on each other.
template <int MODE, int M, bool ZERO, bool ALO>
__device__ __forceinline__ void cmma_pass(float (&tr)[M][4], float (&ti)[M][4],
                                          const CFrag<4> (&a)[M], uint32_t yr0,
                                          uint32_t yr1, uint32_t yi0,
                                          uint32_t yi1, uint32_t nyi0,
                                          uint32_t nyi1) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if constexpr (ZERO) {
      mma_op0<MODE>(tr[m], frag_re<ALO>(a[m]), yr0, yr1);
      mma_op0<MODE>(ti[m], frag_re<ALO>(a[m]), yi0, yi1);
    } else {
      mma_op<MODE>(tr[m], frag_re<ALO>(a[m]), yr0, yr1);
      mma_op<MODE>(ti[m], frag_re<ALO>(a[m]), yi0, yi1);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mma_op<MODE>(tr[m], frag_im<ALO>(a[m]), nyi0, nyi1);
    mma_op<MODE>(ti[m], frag_im<ALO>(a[m]), yr0, yr1);
  }
}

// dr[m] += Ar[m] Br - Ai[m] Bi, di[m] += Ar[m] Bi + Ai[m] Br for M A
// fragments against one B fragment, each real product in three passes (hi
// hi, hi lo, lo hi). a_exact / b_exact: that operand's lo parts are zero
// (values its hi part holds exactly: 16-bit planes), so the passes that
// read them are skipped. The tensor cores' f32 sums round toward zero,
// which over the X / 8 k-steps of a long product would shrink every result
// by up to ~X / 8 * 6 f32 ulps; so each k-step's passes are summed there
// into fresh registers and added to the running sums on the CUDA cores,
// rounded to nearest. Within a k-step the small passes (those that read a
// lo part) go first, from zero, and the hi hi pass last: only the last
// passes round toward zero at the k-step sum's own size.
template <int MODE, int M>
__device__ __forceinline__ void cmma3(float (&dr)[M][4], float (&di)[M][4],
                                      const CFrag<4> (&a)[M], const CFrag<2>& b,
                                      bool a_exact, bool b_exact) {
  constexpr uint32_t neg = kNegMask<MODE>;
  const uint32_t nih0 = b.ih[0] ^ neg, nih1 = b.ih[1] ^ neg;
  const uint32_t nil0 = b.il[0] ^ neg, nil1 = b.il[1] ^ neg;
  float tr[M][4], ti[M][4];
  if (!a_exact) {  // lo hi
    cmma_pass<MODE, M, true, true>(tr, ti, a, b.rh[0], b.rh[1], b.ih[0],
                                   b.ih[1], nih0, nih1);
    if (!b_exact)  // hi lo
      cmma_pass<MODE, M, false, false>(tr, ti, a, b.rl[0], b.rl[1], b.il[0],
                                       b.il[1], nil0, nil1);
  } else if (!b_exact) {
    cmma_pass<MODE, M, true, false>(tr, ti, a, b.rl[0], b.rl[1], b.il[0],
                                    b.il[1], nil0, nil1);
  }
  if (a_exact && b_exact)  // hi hi
    cmma_pass<MODE, M, true, false>(tr, ti, a, b.rh[0], b.rh[1], b.ih[0],
                                    b.ih[1], nih0, nih1);
  else
    cmma_pass<MODE, M, false, false>(tr, ti, a, b.rh[0], b.rh[1], b.ih[0],
                                     b.ih[1], nih0, nih1);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dr[m][e] += tr[m][e];
      di[m][e] += ti[m][e];
    }
}

// dr[m] += A[m] B for a B whose lo parts are zero and an A split in three
// parts (a: hi and lo, a2's hi slots: the second lo, A = hi + lo + lo2 to
// ~2^-33 in tf32: the products then as exact as f32 products). The
// smallest pass first, from zero, as cmma3 orders them.
template <int MODE, int M>
__device__ __forceinline__ void cmma3x(float (&dr)[M][4], float (&di)[M][4],
                                       const CFrag<4> (&a)[M],
                                       const CFrag<4> (&a2)[M],
                                       const CFrag<2>& b) {
  constexpr uint32_t neg = kNegMask<MODE>;
  const uint32_t nih0 = b.ih[0] ^ neg, nih1 = b.ih[1] ^ neg;
  float tr[M][4], ti[M][4];
  cmma_pass<MODE, M, true, false>(tr, ti, a2, b.rh[0], b.rh[1], b.ih[0], b.ih[1],
                                  nih0, nih1);
  cmma_pass<MODE, M, false, true>(tr, ti, a, b.rh[0], b.rh[1], b.ih[0], b.ih[1],
                                  nih0, nih1);
  cmma_pass<MODE, M, false, false>(tr, ti, a, b.rh[0], b.rh[1], b.ih[0], b.ih[1],
                                   nih0, nih1);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dr[m][e] += tr[m][e];
      di[m][e] += ti[m][e];
    }
}

// A tile's layout in shared memory: element (row, column) at L::at(row,
// column). Row-major rows of LD floats:
template <int LD>
struct RowMajor {
  static __device__ __forceinline__ int at(int r, int c) { return r * LD + c; }
};

// The A fragment of a k-step from an f32 tile s[row][k] in layout L (rows
// row0 .. row0 + 15, columns k0 ..; two neighbouring columns adjacent),
// split into its parts.
template <int MODE, class L>
__device__ __forceinline__ void load_a(const float* sr, const float* si,
                                       int row0, int k0, CFrag<4>& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + g + 8 * (r & 1);
    if constexpr (MODE == kTf32x3) {
      const int o = L::at(row, k0 + t + 4 * (r >> 1));
      split_tf32(sr[o], a.rh[r], a.rl[r]);
      split_tf32(si[o], a.ih[r], a.il[r]);
    } else {
      const int o = L::at(row, k0 + 2 * t + 8 * (r >> 1));
      split_bf16x2(*reinterpret_cast<const float2*>(sr + o), a.rh[r], a.rl[r]);
      split_bf16x2(*reinterpret_cast<const float2*>(si + o), a.ih[r], a.il[r]);
    }
  }
}

// The B fragment of a k-step whose columns n0 .. n0 + 7 are rows of an f32
// tile s[n][k] in layout L (k0 ..): B = s^T, split.
template <int MODE, class L>
__device__ __forceinline__ void load_b_rows(const float* sr, const float* si,
                                            int n0, int k0, CFrag<2>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (MODE == kTf32x3) {
      const int o = L::at(n0 + g, k0 + t + 4 * j);
      split_tf32(sr[o], b.rh[j], b.rl[j]);
      split_tf32(si[o], b.ih[j], b.il[j]);
    } else {
      const int o = L::at(n0 + g, k0 + 2 * t + 8 * j);
      split_bf16x2(*reinterpret_cast<const float2*>(sr + o), b.rh[j], b.rl[j]);
      split_bf16x2(*reinterpret_cast<const float2*>(si + o), b.ih[j], b.il[j]);
    }
  }
}

// The B fragment of a k-step from an f32 tile s[k][n] in layout L (rows
// k0 .., columns n0 .. n0 + 7), split.
template <int MODE, class L>
__device__ __forceinline__ void load_b_cols(const float* sr, const float* si,
                                            int k0, int n0, CFrag<2>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (MODE == kTf32x3) {
      const int o = L::at(k0 + t + 4 * j, n0 + g);
      split_tf32(sr[o], b.rh[j], b.rl[j]);
      split_tf32(si[o], b.ih[j], b.il[j]);
    } else {  // rows k, k + 1 in one register
      const int k = k0 + 2 * t + 8 * j;
      const int o0 = L::at(k, n0 + g), o1 = L::at(k + 1, n0 + g);
      split_bf16x2(make_float2(sr[o0], sr[o1]), b.rh[j], b.rl[j]);
      split_bf16x2(make_float2(si[o0], si[o1]), b.ih[j], b.il[j]);
    }
  }
}

}  // namespace dqc
