// Flash-attention forward, float32, on Hopper's tensor cores (sm_90a,
// mma.sync in 3xTF32, tf32x3.cuh); plain C interface for ctypes.  The
// bf16 instances run in flash_fwd_tc.cu (the wrapper routes by dtype).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_fwd`
// (pallas_call at :205, kernel body `_flash_fwd_kernel` at :85-154) for
// float32 q/k/v.  Wrapper and plain PyTorch version: veles_tpu_torch/ops/
// kernels/flash_attention.py.
//
// Computes, per (batch b, q head h, query row i):
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . k[b,j,kh,:] * scale) @ v[b,:,kh,:]
//   lse[b,h,i]   = m + log(l)  (row logsumexp, kept for the backward)
// over the keys j the mask leaves live (j < Tk; with causal j <= i; with a
// window W also j > i - W), with kh = h / (H / Hk) (grouped-query
// attention: the q head reads its kv head in place, never a repeat).
// Scores, the online softmax state (m, l) and the accumulator are f32.
// Masked scores are -1e30 (not -inf) and their probabilities are forced
// to 0: a row with no live key ends with l = 0 and writes 0 and
// lse = -1e30 + log(1e-30), never NaN.
//
// What bounds it on this card: two products of (T x D) by (D x T) per
// (b, h), 4 B H D T(T+1)/2 operations causal: ~69 GFLOP at the training
// path's full width (B=16, T=2048, H=8, D=64) against ~0.27 GB, so
// operations; at the curriculum's (B=100, T=64, H=4, D=16) 27 MFLOP
// against 6.7 MB, so bytes.  Float32 accuracy (1e-4 against the plain
// version) on the tensor cores takes a 3xTF32 split (495 / 3 = 165
// TFLOP/s, against 67 outside them).
//
// Design: warps own query rows.  One block per (tile of 16 NW query rows,
// b*h), NW = min(4, ceil(Tq / 16)) warps, so at T = 32 a (b, h) is one
// block of 2 warps and no warp idles; query tiles issued heaviest (latest)
// first.  Each warp reads its 16 Q rows once, straight from global memory
// into A fragments in pair order (head dims 2t, 2t + 1 of each 8), split
// into big and small parts, and keeps them in registers for the whole key
// loop with its O accumulator and its two rows' m and l: Q is read by
// nothing else, so it takes no shared memory and no barrier.  K/V tiles of
// BK keys are copied by cp.async (the next tile's copy in flight while
// this one is computed) and split once by the whole block into swizzled
// big and small tiles.  Per tile and warp:
//   S  = Q . K^T       A = Q (registers), B = K pairs   BK/8 x D/8
//   online softmax on the C fragments: the mask (only on tiles the
//                      diagonal, the window edge, Tq or Tk cut), the row
//                      max and row sum over the 4 lanes of a quad
//                      (__shfl_xor_sync), O rescaled by alpha once a tile
//   O += P . V         A = P from the C fragments ({c0, c2, c1, c3}: keys
//                      in pair order), B = V rows 2t, 2t + 1
// each product 3xTF32, the three products of every 8-wide chunk chained
// in one zeroed fragment whose sum is added in float32 (tf32x3.cuh mma3c:
// the tensor core's accumulate truncates, so no running sum goes through
// it; one float32 add a register and chunk where mma3 takes three, which
// took 45 % of the loop's instructions).  exp is __expf (ex2.approx of
// x log2 e: within 2 ulp near 0, where the row's weight is).  Tiles no
// row of the warp can see are skipped, and tiles no
// row of the block sees are never loaded (`_flash_block_live`).  No float
// atomics: a warp owns its rows and sums keys in one order, so two runs
// give the same bits.  Ragged T needs no padding (copies past Tk are
// zero-filled and masked; rows past Tq compute on zeros and write
// nothing).  Tiles are copied 16 bytes at a time where k and v start on
// 16-byte boundaries, else word by word; Q and O go word by word, so any
// 4-byte aligned f32 view is taken.
//
// Tiles of BK = 32 keys, as in the backward: 48 KB of shared memory at
// D = 64, 12 KB at 16; at the pp configs' T = 32 one tile, none half
// empty.

#include "tf32x3.cuh"

namespace {

using namespace vt_tf32;

constexpr int BK = 32;         // keys a staged K/V tile
constexpr int NT = BK / 8;     // 8-key column tiles of a tile
constexpr int MAX_WARPS = 4;
constexpr float NEG = -1e30f;  // masked score, as in the TPU kernel

template <int D>
struct Fwd {
    static constexpr int TILE = BK * D;                 // a K or V tile
    // K and V as copied; K and V split (big, small)
    static constexpr int SMEM = 6 * TILE * 4;
};

// the warp's A fragments of its 16 rows of x (row r at src + r * stride,
// rows >= valid as 0), chunk c = dims 8c..8c+7 in pair order, split
template <int D>
__device__ __forceinline__ void q_frags(uint32_t (&big)[D / 8][4],
                                        uint32_t (&small)[D / 8][4],
                                        const float* __restrict__ src,
                                        size_t stride, int valid, int g,
                                        int t) {
    const bool ok_a = g < valid, ok_b = g + 8 < valid;
    const float* pa = src + (size_t)g * stride;
    const float* pb = pa + 8 * stride;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
        const int d = 8 * c + 2 * t;
        const float x[4] = {ok_a ? pa[d] : 0.f, ok_b ? pb[d] : 0.f,
                            ok_a ? pa[d + 1] : 0.f, ok_b ? pb[d + 1] : 0.f};
        split(x, big[c], small[c]);
    }
}

template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS, D == 64 ? 2 : 3)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hk,
                 float scale, int causal, int window, int vec) {
    constexpr int TILE = Fwd<D>::TILE;
    extern __shared__ __align__(16) float smem[];
    float* const raw = smem;                   // K then V, as copied
    float* const k_big = raw + 2 * TILE;
    float* const k_small = k_big + TILE;
    float* const v_big = k_small + TILE;
    float* const v_small = v_big + TILE;

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
    const int r0 = q0 + 16 * warp;             // the warp's first row
    const int ra = r0 + g, rb = r0 + g + 8;    // this thread's two rows

    const size_t row_stride = (size_t)H * D;
    const size_t q_off = ((size_t)b * Tq + r0) * row_stride + (size_t)h * D;
    uint32_t qb[D / 8][4], qs[D / 8][4];
    q_frags<D>(qb, qs, q + q_off, row_stride, Tq - r0, g, t);
    float acc[D / 8][4];
#pragma unroll
    for (int m = 0; m < D / 8; ++m)
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

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

        // S = Q . K^T: c0/c1 row ra, c2/c3 row rb, keys kb + 8n + 2t (+1)
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int off = swz<D>(8 * n + g, 8 * c + 2 * t);
                uint32_t kb2[2], ks2[2];
                b_pair(kb2, k_big, off);
                b_pair(ks2, k_small, off);
                mma3c(s[n], qb[c], qs[c], kb2, ks2);
            }
        }
        // scale and mask (only where the tile is cut), the tile's row max
        const bool cut = kb + BK > Tk || r0 + 16 > Tq
            || (causal && (kb + BK - 1 > r0
                           || (window > 0 && kb <= r0 + 15 - window)));
        uint32_t dead = 0u;     // bit 4n + e: s[n][e] masked
        float mt_a = NEG, mt_b = NEG;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                bool ok = true;
                if (cut) {
                    const int row = e < 2 ? ra : rb;
                    const int key = kb + 8 * n + 2 * t + (e & 1);
                    ok = row < Tq && key < Tk;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                }
                s[n][e] = ok ? s[n][e] * scale : NEG;
                if (!ok) dead |= 1u << (4 * n + e);
            }
            mt_a = fmaxf(mt_a, fmaxf(s[n][0], s[n][1]));
            mt_b = fmaxf(mt_b, fmaxf(s[n][2], s[n][3]));
        }
        // a row lives in the 4 lanes of a quad
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            mt_a = fmaxf(mt_a, __shfl_xor_sync(0xffffffffu, mt_a, o));
            mt_b = fmaxf(mt_b, __shfl_xor_sync(0xffffffffu, mt_b, o));
        }
        const float mn_a = fmaxf(m_a, mt_a), mn_b = fmaxf(m_b, mt_b);
        const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
        // P (masked keys exactly 0, not exp(-1e30 + 1e30)), its row sums
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float mn = e < 2 ? mn_a : mn_b;
                s[n][e] = (dead >> (4 * n + e)) & 1u
                              ? 0.f : __expf(s[n][e] - mn);
            }
            ps_a += s[n][0] + s[n][1];
            ps_b += s[n][2] + s[n][3];
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            ps_a += __shfl_xor_sync(0xffffffffu, ps_a, o);
            ps_b += __shfl_xor_sync(0xffffffffu, ps_b, o);
        }
        l_a = l_a * al_a + ps_a;
        l_b = l_b * al_b + ps_b;
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int m = 0; m < D / 8; ++m) {
            acc[m][0] *= al_a;
            acc[m][1] *= al_a;
            acc[m][2] *= al_b;
            acc[m][3] *= al_b;
        }
        // O += P . V: keys in pair order (k = t <-> 2t)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float a[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
            uint32_t ab[4], as[4];
            split(a, ab, as);
#pragma unroll
            for (int m = 0; m < D / 8; ++m) {
                uint32_t bb[2], bs[2];
                b_rows<D>(bb, v_big, 8 * n + 2 * t, 8 * m + g);
                b_rows<D>(bs, v_small, 8 * n + 2 * t, 8 * m + g);
                mma3c(acc[m], ab, as, bb, bs);
            }
        }
    }

    // C fragment: (row ra, dims 8m + 2t, +1) and the same of row rb
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    const size_t off_a = q_off + (size_t)g * row_stride;
    const size_t off_b = off_a + 8 * row_stride;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
        const int d = 8 * m + 2 * t;
        if (ra < Tq) {
            out[off_a + d] = acc[m][0] / den_a;
            out[off_a + d + 1] = acc[m][1] / den_a;
        }
        if (rb < Tq) {
            out[off_b + d] = acc[m][2] / den_b;
            out[off_b + d + 1] = acc[m][3] / den_b;
        }
    }
    if (t == 0) {
        if (ra < Tq) lse[(size_t)bh * Tq + ra] = m_a + logf(den_a);
        if (rb < Tq) lse[(size_t)bh * Tq + rb] = m_b + logf(den_b);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Tq, int Tk, int H, int Hk, float scale,
           int causal, int window, bool vec, cudaStream_t stream) {
    const int nw = std::min(MAX_WARPS, (Tq + 15) / 16);
    const int rows = 16 * nw;
    constexpr int smem = Fwd<D>::SMEM;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_tf32x3<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Tq + rows - 1) / rows, B * H);
    flash_fwd_tf32x3<D><<<grid, 32 * nw, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), Tq, Tk, H, Hk, scale, causal, window,
        vec ? 1 : 0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q/k/v/out (bfloat16 is flash_fwd_tc.cu's); lse float32
// (B, H, Tq).  D is 16 or 64.  window: 0 = none.  Returns the CUDA error
// code of the launch (0 on success); no synchronisation.
int vt_flash_fwd_tf32x3(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int Tq, int Tk, int H,
                        int Hk, int D, float scale, int causal, int window,
                        void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = ((reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v)) % 16) == 0;
    if (D == 16)
        return launch<16>(q, k, v, out, lse, B, Tq, Tk, H, Hk, scale,
                          causal, window, vec, st);
    if (D == 64)
        return launch<64>(q, k, v, out, lse, B, Tq, Tk, H, Hk, scale,
                          causal, window, vec, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
