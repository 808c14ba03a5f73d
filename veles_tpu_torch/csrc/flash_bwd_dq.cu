// Flash-attention backward, dQ, for Hopper (sm_90a), float32 instances,
// on the SIMT cores; plain C interface for ctypes.  The bf16 instances run
// on the tensor cores in flash_bwd_dq_tc.cu (the wrapper routes by dtype).
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
//   dq_i = sum_j round(ds_j) * k_j
// over the keys j < Tk (causal: j <= i; window W: j > i - W), with kv head
// kh = h / (H / Hk).  delta_i = rowsum(dO_i * O_i) comes from the caller
// (a PyTorch expression, as the JAX package leaves it to XLA).  round()
// is the cast of dS to k's dtype before the dS.K product (:297): identity
// in float32.  Scores, p, ds, the accumulator and dq are float32.  P is
// forced to 0 by the mask (the TPU kernel's `_flash_bwd_mask`), never left
// to exp underflow: a row with no live key carries lse = -1e30.
//
// What bounds it on this card: three products of (T x D) by (D x T) per
// (b, h), ~3 x 34 GFLOP at the training path's shape (B=16, T=2048, H=8,
// D=64, causal) against ~10 MB of traffic.  In float32 the bound is the
// f32 rate outside the tensor cores (67 TFLOP/s): the tensor cores cannot
// hold f32 to this kernel's bound (1024 units of 2^-24) without a 3xTF32
// split.  The f32 instances serve chip_smoke.py's f32 train step and edge
// cases and configs/induction_lm.json's quality run (f32, D=16).
//
// Design: one block per (b*h, tile of ROWS query rows); TPR = D/16 threads
// per query row, each owning 16 of its head dims (d = lane + TPR * t), so
// a thread keeps q, dO and the dq accumulator as three 16-wide register
// rows (the one-thread-per-row layout of flash_fwd.cu would need three
// D-wide rows, 192 registers at D=64, and its unrolled body is what makes
// that source slow to build).  The TPU grid's sequential k axis becomes a
// loop inside the block over K/V tiles staged once in shared memory as
// float32; the TPR partial dot products of a row meet through warp
// shuffles.  Tiles that no row of the block can see are never loaded
// (`_flash_block_live`, as a key range).  Ragged T needs no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // query rows per block
constexpr int BLOCK_K = 64;    // keys per shared-memory tile
constexpr int PER = 16;        // head dims per thread

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
    return x;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}

// x rounded to T and widened back: the cast the TPU kernel makes before
// a product whose operands are in T
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS * (D / PER))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, int H, int Hk, float scale, int causal,
                    int window) {
    constexpr int TPR = D / PER;               // threads per query row
    __shared__ float ks[BLOCK_K][D];
    __shared__ float vs[BLOCK_K][D];

    const int bh = blockIdx.y;                 // b * H + h
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hk);               // GQA kv head
    const int q0 = blockIdx.x * ROWS;
    const int lane = threadIdx.x % TPR;        // owns dims lane + TPR * t
    const int row = q0 + threadIdx.x / TPR;
    const bool live_row = row < Tq;

    float qr[PER], dor[PER], acc[PER];
    float row_lse = 0.f, row_delta = 0.f;
    const size_t row_off = ((size_t)(b * Tq + row) * H + h) * D;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
        qr[t] = live_row ? to_f<T>(q[row_off + lane + TPR * t]) : 0.f;
        dor[t] = live_row ? to_f<T>(dout[row_off + lane + TPR * t]) : 0.f;
        acc[t] = 0.f;
    }
    if (live_row) {
        row_lse = lse[(size_t)bh * Tq + row];
        row_delta = delta[(size_t)bh * Tq + row];
    }

    // keys any row of this block can see (whole-tile skipping)
    int k_end = Tk;
    int k_begin = 0;
    if (causal) {
        k_end = min(Tk, q0 + ROWS);
        if (window > 0) {
            k_begin = max(0, q0 - window + 1);
            k_begin -= k_begin % BLOCK_K;
        }
    }

    for (int kb = k_begin; kb < k_end; kb += BLOCK_K) {
        for (int i = threadIdx.x; i < BLOCK_K * D; i += blockDim.x) {
            const int j = i / D;
            const int d = i - j * D;
            const int key = kb + j;
            float kv = 0.f, vv = 0.f;
            if (key < Tk) {
                const size_t off = ((size_t)(b * Tk + key) * Hk + kh) * D + d;
                kv = to_f<T>(k[off]);
                vv = to_f<T>(v[off]);
            }
            ks[j][d] = kv;
            vs[j][d] = vv;
        }
        __syncthreads();

        // the trip count is the same for every thread of the block, so
        // every lane reaches the shuffles below
        const int jn = min(BLOCK_K, Tk - kb);
#pragma unroll 2
        for (int j = 0; j < jn; ++j) {
            const int key = kb + j;
            float kr[PER];
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int t = 0; t < PER; ++t) {
                kr[t] = ks[j][lane + TPR * t];
                s = fmaf(qr[t], kr[t], s);
                dp = fmaf(dor[t], vs[j][lane + TPR * t], dp);
            }
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, o);
                dp += __shfl_xor_sync(0xffffffffu, dp, o);
            }
            bool ok = live_row;
            if (causal) {
                ok = ok && key <= row;
                if (window > 0) ok = ok && key > row - window;
            }
            const float p = ok ? expf(s * scale - row_lse) : 0.f;
            const float ds = round_to<T>(p * (dp - row_delta) * scale);
#pragma unroll
            for (int t = 0; t < PER; ++t) acc[t] = fmaf(ds, kr[t], acc[t]);
        }
        __syncthreads();
    }

    if (live_row) {
#pragma unroll
        for (int t = 0; t < PER; ++t)
            dq[row_off + lane + TPR * t] = from_f<T>(acc[t]);
    }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, int B, int Tq,
            int Tk, int H, int Hk, float scale, int causal, int window,
            cudaStream_t stream) {
    dim3 grid((Tq + ROWS - 1) / ROWS, B * H);
    flash_bwd_dq_kernel<T, D><<<grid, ROWS * (D / PER), 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), Tq, Tk, H, Hk, scale, causal, window);
}

}  // namespace

extern "C" {

// float32 q, k, v, dout and dq (bfloat16 is flash_bwd_dq_tc.cu's); lse
// and delta are float32 (B, H, Tq).  D is 16 or 64.  window: 0 = none.
// Returns the CUDA error code of the launch (0 on success); no
// synchronisation.
int vt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int Tq, int Tk, int H, int Hk, int D,
                    float scale, int causal, int window, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_LAUNCH(T, DV)                                                    \
    launch<T, DV>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hk, scale,   \
                  causal, window, st)
    if (D == 16) VT_LAUNCH(float, 16);
    else if (D == 64) VT_LAUNCH(float, 64);
    else return (int)cudaErrorInvalidValue;
#undef VT_LAUNCH
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
