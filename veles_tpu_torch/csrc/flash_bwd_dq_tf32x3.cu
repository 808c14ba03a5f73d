// Flash-attention backward, dQ, float32, on Hopper's tensor cores
// (sm_90a, mma.sync in 3xTF32, tf32x3.cuh); plain C interface for ctypes.
// The bf16 instances run in flash_bwd_dq_tc.cu (the wrapper routes by
// dtype).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_bwd`'s
// dQ pallas_call (:384, kernel body `_flash_bwd_dq_kernel` :269-309) for
// float32 inputs.  Wrapper and plain PyTorch version: veles_tpu_torch/ops/
// kernels/flash_bwd_dq.py.
//
// Computes, per (batch b, q head h, query row i), by recompute from the
// forward's row logsumexp (never storing P):
//   s_j  = q_i . k_j * scale            p_j = mask ? exp(s_j - lse_i) : 0
//   dp_j = dO_i . v_j                   ds_j = p_j * (dp_j - delta_i) * scale
//   dq_i = sum_j ds_j * k_j
// over the keys j < Tk (causal: j <= i; window W: j > i - W), with kv head
// kh = h / (H / Hk) (GQA, read in place).  delta_i = rowsum(dO_i * O_i)
// comes from the caller (a PyTorch expression, as the JAX package leaves
// it to XLA).  The cast of dS to k's dtype before dS.K (:297) is the
// identity in float32.  P is forced to 0 by the mask (the TPU kernel's
// `_flash_bwd_mask`), never left to exp underflow: a row with no live key
// carries lse = -1e30 and writes 0.
//
// What bounds it on this card: three products of (T x D) by (D x T) per
// (b, h), 6 B H D T(T+1)/2 operations causal: ~103 GFLOP at the training
// path's full width (B=16, T=2048, H=8, D=64) against ~0.34 GB of
// traffic, so operations; at the curriculum's (B=100, T=64, H=4, D=16)
// 80 MFLOP against 8 MB, so bytes.  Float32 accuracy (the backward's bound is
// 1024 units of 2^-24) on the tensor cores takes a 3xTF32 split, three
// TF32 products for each float32 one: 495 / 3 = 165 TFLOP/s, against 67
// outside the tensor cores.
//
// Design: warps own query rows.  One block per (tile of 16 NW query rows,
// b*h), NW = min(4, ceil(Tq / 16)) warps, so at T = 32 a (b, h) is one
// block of 2 warps and no warp idles; q tiles issued heaviest (latest)
// first.  The block's rows of Q and dO are read once and kept in shared
// memory split (big and small tiles in fragment order, tf32x3.cuh); a
// warp reads its 16 as A fragments and keeps its dQ accumulator, lse and
// delta in registers.  K/V tiles of 32 keys are copied by cp.async (the
// next tile's copy in flight while this one is computed) and split once
// by the whole block.  The split operands take the per-element work of
// 3xTF32 out of the warps' loop: it holds the mma.sync products and their
// float32 adds, shared-memory reads and P/dS.  Per tile and warp:
//   S  = Q . K^T       A = Q, B = K pairs        4 column tiles x D/8
//   dP = dO . V^T      A = dO, B = V pairs
//   P, dS on the C fragments in registers (the mask only on tiles the
//                      diagonal, the window edge, Tq or Tk cut)
//   dQ += dS . K       A = dS from the C fragments ({c0, c2, c1, c3}),
//                      B = K rows 2t, 2t + 1 (keys in pair order)
// each product 3xTF32, every 8-wide chunk of a sum into a zeroed fragment
// added to the sum in float32 (tf32x3.cuh: the tensor core's accumulate
// truncates).  Tiles no row of the warp can see are skipped, and tiles no
// row of the block sees are never loaded (`_flash_block_live`).  No float
// atomics: a warp owns its rows and sums keys in one order, so two runs
// give the same bits.  Ragged T needs no padding (copies past T are
// zero-filled and masked).

#include "tf32x3.cuh"

namespace {

using namespace vt_tf32;

constexpr int BK = 32;         // keys a staged K/V tile
constexpr int NT = BK / 8;     // 8-key column tiles of a tile
constexpr int MAX_WARPS = 4;

template <int D>
struct Dq {
    static constexpr int TILE = BK * D;                 // a K or V tile
    static constexpr int ROWS = 16 * MAX_WARPS * D;     // the block's Q rows
    // K and V as copied; K and V split (big, small); Q and dO split
    static constexpr int SMEM = (2 * TILE + 4 * TILE + 4 * ROWS) * 4;
};

template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS, D == 64 ? 2 : 4)
flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int H, int Hk, float scale, int causal,
                    int window, int vec) {
    constexpr int TILE = Dq<D>::TILE;
    constexpr int ROWS = Dq<D>::ROWS;
    extern __shared__ __align__(16) float smem[];
    float* const raw = smem;                   // K then V, as copied
    float* const k_big = raw + 2 * TILE;
    float* const k_small = k_big + TILE;
    float* const v_big = k_small + TILE;
    float* const v_small = v_big + TILE;
    float* const q_big = v_small + TILE;
    float* const q_small = q_big + ROWS;
    float* const o_big = q_small + ROWS;
    float* const o_small = o_big + ROWS;

    const int nw = blockDim.x / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;

    const int bh = blockIdx.y;                 // b * H + h
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hk);               // GQA kv head
    const int rows = 16 * nw;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;   // heaviest first
    const int w0 = 16 * warp;                  // the warp's first tile row
    const int r0 = q0 + w0;                    // ... and query row
    const int ra = r0 + g, rb = r0 + g + 8;    // this thread's two rows
    const bool live_a = ra < Tq, live_b = rb < Tq;

    const size_t row_stride = (size_t)H * D;
    const size_t q_off = ((size_t)b * Tq + q0) * row_stride + (size_t)h * D;
    load_split_a<D>(q_big, q_small, q + q_off, row_stride, rows, Tq - q0,
                  vec);
    load_split_a<D>(o_big, o_small, dout + q_off, row_stride, rows, Tq - q0,
                  vec);
    float acc[D / 8][4];
#pragma unroll
    for (int m = 0; m < D / 8; ++m)
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    const float lse_a = live_a ? lse[(size_t)bh * Tq + ra] : 0.f;
    const float lse_b = live_b ? lse[(size_t)bh * Tq + rb] : 0.f;
    const float del_a = live_a ? delta[(size_t)bh * Tq + ra] : 0.f;
    const float del_b = live_b ? delta[(size_t)bh * Tq + rb] : 0.f;

    // keys any row of this block can see (whole-tile skipping)
    int k_begin = 0, k_end = Tk;
    if (causal) {
        k_end = min(Tk, q0 + rows);
        if (window > 0) {
            k_begin = max(0, q0 - window + 1);
            k_begin -= k_begin % BK;
        }
    }
    // ... and any row of this warp
    int w_begin = 0, w_end = r0 < Tq ? Tk : 0;
    if (causal && r0 < Tq) {
        w_end = min(Tk, r0 + 16);
        if (window > 0) w_begin = max(0, r0 - window + 1);
    }

    const size_t kv_stride = (size_t)Hk * D;
    const float* k_bh = k + (size_t)b * Tk * kv_stride + (size_t)kh * D;
    const float* v_bh = v + (size_t)b * Tk * kv_stride + (size_t)kh * D;
    auto fetch = [&](int kb) {
        load_tile<D>(smem_u32(raw), k_bh + (size_t)kb * kv_stride,
                     kv_stride, BK, Tk - kb, vec);
        load_tile<D>(smem_u32(raw + TILE), v_bh + (size_t)kb * kv_stride,
                     kv_stride, BK, Tk - kb, vec);
    };

    const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK
                                        : 0;
    if (n_tiles > 0) fetch(k_begin);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
        const int kb = k_begin + it * BK;
        cp_async_wait_all();
        __syncthreads();        // the copy landed; the last tile is done
        split_tile(k_big, k_small, raw, TILE);
        split_tile(v_big, v_small, raw + TILE, TILE);
        __syncthreads();        // split; the copy buffer is free again
        if (it + 1 < n_tiles) fetch(kb + BK);
        cp_async_commit();
        if (kb >= w_end || kb + BK <= w_begin) continue;

        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
            uint32_t qb[4], qs[4], ob[4], os[4];
            a_frag<D>(qb, q_big, warp, c, lane);
            a_frag<D>(qs, q_small, warp, c, lane);
            a_frag<D>(ob, o_big, warp, c, lane);
            a_frag<D>(os, o_small, warp, c, lane);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int off = swz<D>(8 * n + g, 8 * c + 2 * t);
                uint32_t kb2[2], ks2[2], vb2[2], vs2[2];
                b_pair(kb2, k_big, off);
                b_pair(ks2, k_small, off);
                b_pair(vb2, v_big, off);
                b_pair(vs2, v_small, off);
                mma3(s[n], qb, qs, kb2, ks2);
                mma3(dp[n], ob, os, vb2, vs2);
            }
        }
        // P and dS on the fragments: c0/c1 row ra, c2/c3 row rb, keys
        // kb + 8n + 2t (+1); the mask only where the tile is cut
        const bool cut = kb + BK > Tk || r0 + 16 > Tq
            || (causal && (kb + BK - 1 > r0
                           || (window > 0 && kb <= r0 + 15 - window)));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e < 2 ? ra : rb;
                const int key = kb + 8 * n + 2 * t + (e & 1);
                bool ok = true;
                if (cut) {
                    ok = row < Tq && key < Tk;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                }
                const float l = e < 2 ? lse_a : lse_b;
                const float dl = e < 2 ? del_a : del_b;
                const float p = ok ? expf(s[n][e] * scale - l) : 0.f;
                s[n][e] = p * (dp[n][e] - dl) * scale;     // dS
            }
        }
        // dQ += dS . K: keys in pair order (k = t <-> 2t)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float a[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
            uint32_t ab[4], as[4];
            split(a, ab, as);
#pragma unroll
            for (int m = 0; m < D / 8; ++m) {
                uint32_t bb[2], bs[2];
                b_rows<D>(bb, k_big, 8 * n + 2 * t, 8 * m + g);
                b_rows<D>(bs, k_small, 8 * n + 2 * t, 8 * m + g);
                mma3(acc[m], ab, as, bb, bs);
            }
        }
    }

    // C fragment: (row ra, dims 8m + 2t, +1) and the same of row rb
    const size_t off_a = q_off + (size_t)(w0 + g) * row_stride;
    const size_t off_b = off_a + 8 * row_stride;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
        const int d = 8 * m + 2 * t;
        if (live_a) {
            dq[off_a + d] = acc[m][0];
            dq[off_a + d + 1] = acc[m][1];
        }
        if (live_b) {
            dq[off_b + d] = acc[m][2];
            dq[off_b + d + 1] = acc[m][3];
        }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Tq,
           int Tk, int H, int Hk, float scale, int causal, int window,
           bool vec, cudaStream_t stream) {
    const int nw = std::min(MAX_WARPS, (Tq + 15) / 16);
    const int rows = 16 * nw;
    constexpr int smem = Dq<D>::SMEM;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_bwd_dq_tf32x3<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Tq + rows - 1) / rows, B * H);
    flash_bwd_dq_tf32x3<D><<<grid, 32 * nw, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), Tq, Tk, H, Hk, scale, causal, window,
        vec ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v, dout and dq (bfloat16 is flash_bwd_dq_tc.cu's); lse
// and delta are float32 (B, H, Tq).  D is 16 or 64.  window: 0 = none.
// Tiles are copied 16 bytes at a time where q, k, v and dout start on
// 16-byte boundaries, else a word at a time.  Returns the CUDA error code
// of the launch (0 on success); no synchronisation.
int vt_flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int Tq,
                           int Tk, int H, int Hk, int D, float scale,
                           int causal, int window, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) |
                       reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
    if (D == 16)
        return launch<16>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hk,
                          scale, causal, window, vec, st);
    if (D == 64)
        return launch<64>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hk,
                          scale, causal, window, vec, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
