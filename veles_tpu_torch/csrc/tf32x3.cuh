// Float32-accurate products on Hopper's tensor cores (sm_90a), shared by
// the float32 flash kernels (flash_fwd_tf32x3.cu, flash_bwd_dq_tf32x3.cu,
// flash_bwd_dkv_tf32x3.cu): the 3xTF32 split, the mma.sync product, the
// staged [row][D] float32 tiles' swizzle and the split tiles the
// products read (the cp.async copies are hopper_tc.cuh's).
//
// 3xTF32.  A float32 x is split as x = big + small, big = tf32(x) and
// small = tf32(x - big), both rounded to nearest, ties away (as cvt.rna
// would); x - big is exact in float32, and |small| <= 2^-11 |x|.  Then
//   a.b ~= a_small.b_big + a_big.b_small + a_big.b_big
// dropping a_small.b_small and the rounding of each small part (each
// <= 2^-22 |a||b|), every product exact in the tensor core: about
// float32's own accuracy at three TF32 products' cost.  The two small
// cross terms are added first, the big term last.  Operands staged
// in shared memory are split once, when they land, into a tile of big and
// a tile of small parts, so the warps that read them split nothing.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 g + t:
//   A (16 x 8):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (t, g)  b1 (t + 4, g)                 (k, n)
//   C (16 x 8):  c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// The reduction index k of a product can be mapped to the summed
// dimension in any order, as long as A and B agree.  Two orders are used:
//   * "pairs" (k = t <-> 2t, k = t + 4 <-> 2t + 1 within each 8): a
//     product over head dims reads A and B as float2 pairs (d = 2t, 2t+1);
//   * the same map over keys (or queries) lets the C fragment of one
//     product (columns 2t, 2t + 1) be the A fragment of the next with no
//     shuffle: a = {c0, c2, c1, c3}.
//
// Shared-memory tiles hold rows of D float32, row r at r * D words, with
// the 8-word chunks of a row permuted by an XOR of the row's low bits
// (swz): both reads the kernels make from them, float2 pairs (row n*8 + g,
// d = 2t: B of the products over head dims) and single words
// (rows 2t and 2t + 1, d = n*8 + g: B of the products over keys or
// queries), then hit 32 distinct banks at D = 64; at D = 16 the second
// read is 2-way.

#pragma once

#include <algorithm>

#include "hopper_tc.cuh"

namespace vt_tf32 {

// the copies: 16-byte cp.async (zero-filled past the tensor), the 4-byte
// one, commit and wait
using vt_tc::cp_async16;
using vt_tc::cp_async4;
using vt_tc::cp_async_commit;
using vt_tc::cp_async_wait_all;
using vt_tc::smem_u32;

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions where the cvt takes several
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (see above)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N],
                                      uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// d = a.b, one m16n8k8 TF32 product into a fresh fragment (the zero
// accumulator an input, not four moves into d)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
}

// d += a.b, one m16n8k8 TF32 product into d
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// acc += a.b in 3xTF32, the three products chained in one fresh fragment
// (small cross terms first, the big product last) and the chunk's sum
// added to acc in float32: the tensor core's truncation cuts only this
// chunk's own sum, never a running one, at one float32 add a register
// where mma3 takes three.  The products wait on each other, so a caller
// interleaves independent chunks (columns or output blocks).
__device__ __forceinline__ void mma3c(float (&acc)[4],
                                      const uint32_t (&a_big)[4],
                                      const uint32_t (&a_small)[4],
                                      const uint32_t (&b_big)[2],
                                      const uint32_t (&b_small)[2]) {
    float d[4];
    mma0(d, a_small, b_big);
    mma(d, a_big, b_small);
    mma(d, a_big, b_big);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// acc += a.b in 3xTF32: the three products, each into a fresh fragment,
// then (small cross terms first, the big product last) added to acc in
// float32.  The tensor core's accumulate truncates toward zero relative
// to its largest addend, so a running accumulator fed straight by mma
// drifts with the number of products summed into it (on the H100 at
// T = 2048, 11-58 times an fmaf chain's Frobenius error); each 8-wide
// chunk's sums are cut once and meet in round-to-nearest adds, as fmaf's
// partial sums do.  Three independent products also keep no product
// waiting on another's result.  The backward kernels use this one: on
// mma3c their D = 64 instances reach 255 registers and spill (dQ 124
// bytes of stores, dK/dV 12), and full width gains nothing (dQ + dK/dV
// 7.20-7.24 against 7.22-7.26 ms on an H100 80GB HBM3 at 700 W, PERF.md
// section 6).
__device__ __forceinline__ void mma3(float (&acc)[4],
                                     const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
    float sb[4], bs[4], bb[4];
    mma0(sb, a_small, b_big);
    mma0(bs, a_big, b_small);
    mma0(bb, a_big, b_big);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += (sb[i] + bs[i]) + bb[i];
}

// word offset of (row r, head dim d) in a swizzled [row][D] tile: the
// 8-word chunk index is XORed with 2 bits of the row at D = 64 (chunks
// 0..3 of each 32-word half) and 1 bit at D = 16
template <int D>
__device__ __forceinline__ int swz(int r, int d) {
    if constexpr (D == 64)
        return r * D + (d ^ (((((r ^ (r >> 2)) & 1) | (r & 2))) << 3));
    else
        return r * D + (d ^ (((r >> 1) & 1) << 3));
}

// A-operand tiles (the block's own rows: Q and dO in dQ, K and V in
// dK/dV) are stored in fragment order, split once: lane l of the warp
// that owns rows 16w..16w+15 finds its A fragment of 8-dim chunk c,
// {x[g][8c + 2t], x[g + 8][8c + 2t], x[g][8c + 2t + 1],
//  x[g + 8][8c + 2t + 1]}, as the 16 bytes at word ((w D/8 + c) 32 + l) 4:
// one conflict-free 16-byte read straight into the four registers the
// product takes, where a row-major tile needs two reads and four moves
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float* tile,
                                       int w, int c, int lane) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        tile + ((w * (D / 8) + c) * 32 + lane) * 4);
    a[0] = x.x;
    a[1] = x.y;
    a[2] = x.z;
    a[3] = x.w;
}

// the B fragment of a product over head dims (row n*8 + g of the tile is
// the column): the pair (8c + 2t, 8c + 2t + 1) at word `off`
__device__ __forceinline__ void b_pair(uint32_t (&b)[2], const float* tile,
                                       int off) {
    const uint2 x = *reinterpret_cast<const uint2*>(tile + off);
    b[0] = x.x;
    b[1] = x.y;
}

// the B fragment of a product over tile rows (keys or queries, in pair
// order), column d: rows r and r + 1
template <int D>
__device__ __forceinline__ void b_rows(uint32_t (&b)[2], const float* tile,
                                       int r, int d) {
    b[0] = __float_as_uint(tile[swz<D>(r, d)]);
    b[1] = __float_as_uint(tile[swz<D>(r + 1, d)]);
}

__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
}

// copy `n` rows of D float32 into a swizzled tile (rows past `valid_rows`
// zero-filled): global row r at src + r * stride (floats); `vec` when every
// row start is 16-byte aligned, else word by word
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const float* __restrict__ src,
                                          size_t stride, int n,
                                          int valid_rows, bool vec) {
    if (vec) {
        for (int i = threadIdx.x; i < n * (D / 4); i += blockDim.x) {
            const int r = i / (D / 4);
            const int d = (i - r * (D / 4)) * 4;
            const bool ok = r < valid_rows;
            cp_async16(dst + 4u * swz<D>(r, d),
                       ok ? src + r * stride + d : src, ok);
        }
    } else {
        for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
            const int r = i / D;
            const int d = i - r * D;
            const bool ok = r < valid_rows;
            cp_async4(dst + 4u * swz<D>(r, d),
                      ok ? src + r * stride + d : src, ok);
        }
    }
}

// split `words` float32 of a copied tile into tiles of big and small
// parts in the same (swizzled) layout
__device__ __forceinline__ void split_tile(float* big, float* small,
                                           const float* raw, int words) {
    for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x) {
        uint4 b, s;
        split4(*reinterpret_cast<const float4*>(raw + i), b, s);
        *reinterpret_cast<uint4*>(big + i) = b;
        *reinterpret_cast<uint4*>(small + i) = s;
    }
}

// read `n` rows of D float32 (rows past `valid_rows` as 0; global row r
// at src + r * stride, 16 bytes at a time where `vec`) and store them
// split into big and small A-operand tiles in fragment order (a_frag)
template <int D>
__device__ __forceinline__ void load_split_a(float* big, float* small,
                                             const float* __restrict__ src,
                                             size_t stride, int n,
                                             int valid_rows, bool vec) {
    for (int i = threadIdx.x; i < n * (D / 4); i += blockDim.x) {
        const int r = i / (D / 4);
        const int d = (i - r * (D / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid_rows) {
            const float* p = src + r * stride + d;
            x = vec ? *reinterpret_cast<const float4*>(p)
                    : make_float4(p[0], p[1], p[2], p[3]);
        }
        uint4 b, s;
        split4(x, b, s);
        const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
        const uint32_t sv[4] = {s.x, s.y, s.z, s.w};
        // row r = 16 w + 8 hi + g; dims d..d+3 of chunk c = d / 8
        const int lane_g = (r % 8) * 4;
        const int base = (r / 16 * (D / 8) + d / 8) * 32;
        const int hi = (r % 16) / 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int dd = d % 8 + j;          // 2t + e within the chunk
            const int at = (base + lane_g + dd / 2) * 4 + hi + 2 * (dd % 2);
            big[at] = __uint_as_float(bv[j]);
            small[at] = __uint_as_float(sv[j]);
        }
    }
}

}  // namespace vt_tf32
