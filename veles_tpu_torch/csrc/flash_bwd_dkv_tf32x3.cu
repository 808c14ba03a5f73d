// Flash-attention backward, dK and dV, float32, on Hopper's tensor cores
// (sm_90a, mma.sync in 3xTF32, tf32x3.cuh); plain C interface for ctypes.
// The bf16 instances run in flash_bwd_dkv_tc.cu (the wrapper routes by
// dtype).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_bwd`'s
// dK/dV pallas_call (:411, kernel body `_flash_bwd_dkv_kernel` :312-357)
// for float32 inputs.  Wrapper and plain PyTorch version: veles_tpu_torch/
// ops/kernels/flash_bwd_dkv.py.
//
// Computes, per (batch b, kv head kh, key row j), by recompute from the
// forward's row logsumexp:
//   p_ij  = mask ? exp(q_i . k_j * scale - lse_i) : 0
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   dv_j  = sum_{g, i} p_ij * dO_i      dk_j = sum_{g, i} ds_ij * q_i
// where the sum runs over the G = H / Hk query heads h = kh * G + g that
// share kv head kh and over their query rows i (causal: i >= j; window W:
// i < j + W).  The casts of P to dO's dtype (:337) and of dS to q's dtype
// (:344) are the identity in float32.  P is forced to 0 by the mask, never
// left to exp underflow (a row with no live key carries lse = -1e30).
//
// What bounds it on this card: four products of (T x D) by (D x T) per
// (b, h), 8 B H D T(T+1)/2 operations causal: ~137 GFLOP at the training
// path's full width (B=16, T=2048, H=8, D=64) against ~0.4 GB, so
// operations; at the curriculum's (B=100, T=64, H=4, D=16) 107 MFLOP
// against ~10 MB, so bytes.  Float32 accuracy on the tensor cores takes a
// 3xTF32 split (495 / 3 = 165 TFLOP/s, against 67 outside them).
//
// Design: warps own key rows.  One block per (tile of 16 NW key rows,
// b*Hk), NW = min(4, ceil(Tk / 16)) warps.  The block's rows of K and V
// are read once and kept in shared memory split (big and small tiles in
// fragment order, tf32x3.cuh); a warp reads its 16 as A fragments and
// keeps its dK and dV accumulators in registers.  For each of the G
// query heads of the group in turn, Q/dO tiles of 32 query rows, with
// their lse and delta, are copied by cp.async (the next tile's copy in
// flight while this one is computed) and split once by the whole block.
// Per tile and warp:
//   S^T  = K . Q^T     A = K, B = Q pairs         4 column tiles x D/8
//   dP^T = V . dO^T    A = V, B = dO pairs
//   P^T, dS^T on the C fragments in registers (lse, delta by column; the
//                      mask only on tiles the diagonal, the window edge,
//                      Tq or Tk cut)
//   dV += P^T . dO     A = P^T from the C fragments ({c0, c2, c1, c3}),
//                      B = dO rows 2t, 2t + 1 (queries in pair order)
//   dK += dS^T . Q     A = dS^T, B = Q rows 2t, 2t + 1
// each product 3xTF32, every 8-wide chunk of a sum into a zeroed fragment
// added to the sum in float32 (tf32x3.cuh); the transposed products
// take their A from registers, which mma.sync allows and wgmma's
// K-major-only tf32 operands would not.  The G heads of a group fold into
// the same registers in a fixed order (g-major, then ascending query
// tile), so there is no float atomic and two runs give the same bits.
// Tiles no key of the warp can see are skipped, and query tiles no key of
// the block sees are never loaded (`_flash_block_live`, as a row range).

#include "tf32x3.cuh"

namespace {

using namespace vt_tf32;

constexpr int BQ = 32;         // query rows a staged Q/dO tile
constexpr int NT = BQ / 8;     // 8-query column tiles of a tile
constexpr int MAX_WARPS = 4;

template <int D>
struct Dkv {
    static constexpr int TILE = BQ * D;                 // a Q or dO tile
    static constexpr int ROWS = 16 * MAX_WARPS * D;     // the block's K rows
    // Q, dO, lse and delta as copied; Q and dO split (big, small), lse and
    // delta; K and V split
    static constexpr int RAW = 2 * TILE + 2 * BQ;
    static constexpr int SMEM = (RAW + 4 * TILE + 2 * BQ + 4 * ROWS) * 4;
};

template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS, D == 64 ? 2 : 4)
flash_bwd_dkv_tf32x3(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int Tq, int Tk, int H, int Hk, float scale, int causal,
                     int window, int vec) {
    constexpr int TILE = Dkv<D>::TILE;
    constexpr int ROWS = Dkv<D>::ROWS;
    extern __shared__ __align__(16) float smem[];
    float* const raw = smem;           // Q, dO, lse, delta as copied
    float* const q_big = raw + Dkv<D>::RAW;
    float* const q_small = q_big + TILE;
    float* const o_big = q_small + TILE;
    float* const o_small = o_big + TILE;
    float* const lse_s = o_small + TILE;
    float* const del_s = lse_s + BQ;
    float* const k_big = del_s + BQ;
    float* const k_small = k_big + ROWS;
    float* const v_big = k_small + ROWS;
    float* const v_small = v_big + ROWS;

    const int nw = blockDim.x / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;

    const int bkh = blockIdx.y;                // b * Hk + kh
    const int b = bkh / Hk;
    const int kh = bkh - b * Hk;
    const int G = H / Hk;
    const int keys = 16 * nw;
    const int k0 = blockIdx.x * keys;          // causal: heaviest first
    const int w0 = 16 * warp;                  // the warp's first tile row
    const int j0 = k0 + w0;                    // ... and key
    const int ja = j0 + g, jb = j0 + g + 8;    // this thread's two keys
    const bool live_a = ja < Tk, live_b = jb < Tk;

    const size_t kv_stride = (size_t)Hk * D;
    const size_t k_off = ((size_t)b * Tk + k0) * kv_stride + (size_t)kh * D;
    load_split_a<D>(k_big, k_small, k + k_off, kv_stride, keys, Tk - k0,
                    vec);
    load_split_a<D>(v_big, v_small, v + k_off, kv_stride, keys, Tk - k0,
                    vec);
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int m = 0; m < D / 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[m][e] = dv_acc[m][e] = 0.f;

    // query rows any key of this block can see (whole-tile skipping)
    int q_begin = 0, q_end = Tq;
    if (causal) {
        q_begin = (k0 / BQ) * BQ;
        if (window > 0) q_end = min(Tq, k0 + keys - 1 + window);
    }
    // ... and any key of this warp
    int w_begin = 0, w_end = j0 < Tk ? Tq : 0;
    if (causal && j0 < Tk) {
        w_begin = j0;
        if (window > 0) w_end = min(Tq, j0 + 15 + window);
    }

    const size_t q_stride = (size_t)H * D;
    const int per_head = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ
                                         : 0;
    const int n_tiles = G * per_head;
    // tile `it`: query head kh * G + it / per_head, rows from
    // q_begin + (it % per_head) * BQ
    auto fetch = [&](int it) {
        const int h = kh * G + it / per_head;
        const int qb = q_begin + (it % per_head) * BQ;
        const uint32_t base = smem_u32(raw);
        const size_t off = ((size_t)b * Tq + qb) * q_stride + (size_t)h * D;
        load_tile<D>(base, q + off, q_stride, BQ, Tq - qb, vec);
        load_tile<D>(base + 4u * TILE, dout + off, q_stride, BQ, Tq - qb,
                     vec);
        const size_t rows = ((size_t)b * H + h) * Tq + qb;
        for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
            const bool ok = qb + r < Tq;
            cp_async4(base + 4u * (2 * TILE + r), ok ? lse + rows + r : lse,
                      ok);
            cp_async4(base + 4u * (2 * TILE + BQ + r),
                      ok ? delta + rows + r : delta, ok);
        }
    };

    if (n_tiles > 0) fetch(0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
        const int qb = q_begin + (it % per_head) * BQ;
        cp_async_wait_all();
        __syncthreads();        // the copy landed; the last tile is done
        split_tile(q_big, q_small, raw, TILE);
        split_tile(o_big, o_small, raw + TILE, TILE);
        for (int r = threadIdx.x; r < 2 * BQ; r += blockDim.x)
            lse_s[r] = raw[2 * TILE + r];       // lse, then delta
        __syncthreads();        // split; the copy buffer is free again
        if (it + 1 < n_tiles) fetch(it + 1);
        cp_async_commit();
        if (qb >= w_end || qb + BQ <= w_begin) continue;

        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
            uint32_t kb[4], ks[4], vb[4], vs[4];
            a_frag<D>(kb, k_big, warp, c, lane);
            a_frag<D>(ks, k_small, warp, c, lane);
            a_frag<D>(vb, v_big, warp, c, lane);
            a_frag<D>(vs, v_small, warp, c, lane);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int off = swz<D>(8 * n + g, 8 * c + 2 * t);
                uint32_t qb2[2], qs2[2], ob2[2], os2[2];
                b_pair(qb2, q_big, off);
                b_pair(qs2, q_small, off);
                b_pair(ob2, o_big, off);
                b_pair(os2, o_small, off);
                mma3(s[n], kb, ks, qb2, qs2);
                mma3(dp[n], vb, vs, ob2, os2);
            }
        }
        // P^T and dS^T on the fragments: c0/c1 key ja, c2/c3 key jb,
        // queries qb + 8n + 2t (+1); the mask only where the tile is cut
        const bool cut = qb + BQ > Tq || j0 + 16 > Tk
            || (causal && (j0 + 15 > qb
                           || (window > 0 && j0 <= qb + BQ - 1 - window)));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 d2 = *reinterpret_cast<const float2*>(del_s + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = e < 2 ? ja : jb;
                const int row = qb + col + (e & 1);
                bool ok = true;
                if (cut) {
                    ok = key < Tk && row < Tq;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                }
                const float l = (e & 1) ? l2.y : l2.x;
                const float dl = (e & 1) ? d2.y : d2.x;
                const float p = ok ? expf(s[n][e] * scale - l) : 0.f;
                dp[n][e] = p * (dp[n][e] - dl) * scale;    // dS^T
                s[n][e] = p;                               // P^T
            }
        }
        // dV += P^T . dO, then dK += dS^T . Q (P^T's registers free for
        // the second): queries in pair order
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float pa[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
            uint32_t pb[4], ps[4];
            split(pa, pb, ps);
#pragma unroll
            for (int m = 0; m < D / 8; ++m) {
                uint32_t bb[2], bs[2];
                b_rows<D>(bb, o_big, 8 * n + 2 * t, 8 * m + g);
                b_rows<D>(bs, o_small, 8 * n + 2 * t, 8 * m + g);
                mma3(dv_acc[m], pb, ps, bb, bs);
            }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float sa[4] = {dp[n][0], dp[n][2], dp[n][1], dp[n][3]};
            uint32_t sb[4], ss[4];
            split(sa, sb, ss);
#pragma unroll
            for (int m = 0; m < D / 8; ++m) {
                uint32_t bb[2], bs[2];
                b_rows<D>(bb, q_big, 8 * n + 2 * t, 8 * m + g);
                b_rows<D>(bs, q_small, 8 * n + 2 * t, 8 * m + g);
                mma3(dk_acc[m], sb, ss, bb, bs);
            }
        }
    }

    // C fragment: (key ja, dims 8m + 2t, +1) and the same of key jb
    const size_t off_a = k_off + (size_t)(w0 + g) * kv_stride;
    const size_t off_b = off_a + 8 * kv_stride;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
        const int d = 8 * m + 2 * t;
        if (live_a) {
            dk[off_a + d] = dk_acc[m][0];
            dk[off_a + d + 1] = dk_acc[m][1];
            dv[off_a + d] = dv_acc[m][0];
            dv[off_a + d + 1] = dv_acc[m][1];
        }
        if (live_b) {
            dk[off_b + d] = dk_acc[m][2];
            dk[off_b + d + 1] = dk_acc[m][3];
            dv[off_b + d] = dv_acc[m][2];
            dv[off_b + d + 1] = dv_acc[m][3];
        }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int Tq, int Tk, int H, int Hk, float scale, int causal,
           int window, bool vec, cudaStream_t stream) {
    const int nw = std::min(MAX_WARPS, (Tk + 15) / 16);
    const int keys = 16 * nw;
    constexpr int smem = Dkv<D>::SMEM;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_bwd_dkv_tf32x3<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Tk + keys - 1) / keys, B * Hk);
    flash_bwd_dkv_tf32x3<D><<<grid, 32 * nw, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H, Hk,
        scale, causal, window, vec ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v, dout, dk and dv (bfloat16 is flash_bwd_dkv_tc.cu's);
// lse and delta are float32 (B, H, Tq).  D is 16 or 64.  window: 0 =
// none.  Tiles are copied 16 bytes at a time where q, k, v and dout start
// on 16-byte boundaries, else a word at a time.  Returns the CUDA error
// code of the launch (0 on success); no synchronisation.
int vt_flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int Tq, int Tk, int H, int Hk, int D,
                            float scale, int causal, int window,
                            void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * Hk > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) |
                       reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
    if (D == 16)
        return launch<16>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H,
                          Hk, scale, causal, window, vec, st);
    if (D == 64)
        return launch<64>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H,
                          Hk, scale, causal, window, vec, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
