// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_fwd`
// (pallas_call at :205, kernel body `_flash_fwd_kernel` at :85-154).
// Wrapper and plain PyTorch version: veles_tpu_torch/ops/kernels/
// flash_attention.py.
//
// Computes, per (batch b, q head h, query row i):
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . k[b,j,kh,:] * scale) @ v[b,:,kh,:]
//   lse[b,h,i]   = m + log(l)  (row logsumexp, kept for a later backward)
// over the keys j the mask leaves live (j < Tk; with causal j <= i; with a
// window W also j > i - W), with kh = h / (H / Hk) (grouped-query
// attention: the q head reads its kv head in place, never a repeat).
// Inputs are f32 or bf16 in the (B, T, H, D) layout; scores, the online
// softmax state (m, l) and the accumulator are f32; the probabilities are
// rounded to the input type before the P.V product, as the TPU kernel
// does with p.astype(v.dtype).  Masked scores are -1e30 (not -inf): a row
// with no live key ends with l = 0 and writes 0, never NaN.
//
// What bounds it on this card: at the serving path's shape (B=16, T=2048,
// H=8, D=64, causal) the work is ~69 GFLOP against ~8 MB of traffic, so
// the card's bound is its bf16 tensor-core rate (989 TFLOP/s, ~69 us).
// This first version does the arithmetic with plain f32 FMAs (67 TFLOP/s
// peak outside the tensor cores), so it sits far above that bound: it is
// written to be right first; mma/wgmma tiles are later work.
//
// Design against that: one block per (b*h, tile of BLOCK_Q query rows),
// one thread per query row holding its q row and accumulator in
// registers.  The TPU kernel's sequential k grid axis ("arbitrary"
// dimension semantics, scratch m/l/acc carried across grid steps) becomes
// a loop inside the block: K/V tiles of BLOCK_K keys are staged once in
// shared memory (converted to f32) and read by every row of the block as
// broadcasts.  Whole tiles past the causal diagonal, and with a window
// wholly before it, are never loaded (the TPU kernel's
// `_flash_block_live` skip).  Ragged T needs no padding: rows >= Tq do no
// work and write nothing, keys >= Tk are masked, so no padded-row lse is
// ever produced.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 128;   // query rows per block (= threads)
constexpr int BLOCK_K = 32;    // keys per shared-memory tile
constexpr float NEG = -1e30f;  // masked score, as in the TPU kernel

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
        __nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
        float x) {
    return __float2bfloat16(x);  // round to nearest even
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_Q)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hk,
                 float scale, int causal, int window) {
    __shared__ float ks[BLOCK_K][D];
    __shared__ float vs[BLOCK_K][D];

    const int bh = blockIdx.y;                 // b * H + h
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hk);               // GQA kv head
    const int q0 = blockIdx.x * BLOCK_Q;
    const int row = q0 + threadIdx.x;
    const bool live_row = row < Tq;

    float qr[D];
    float acc[D];
    if (live_row) {
        const T* qp = q + ((size_t)(b * Tq + row) * H + h) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) qr[d] = to_f<T>(qp[d]);
    } else {
#pragma unroll
        for (int d = 0; d < D; ++d) qr[d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    float m = NEG;
    float l = 0.f;

    // key range any row of this block can see (whole-tile skipping)
    int k_end = Tk;
    int k_begin = 0;
    if (causal) {
        k_end = min(Tk, q0 + BLOCK_Q);
        if (window > 0) {
            k_begin = max(0, q0 - window + 1);
            k_begin -= k_begin % BLOCK_K;
        }
    }

    for (int kb = k_begin; kb < k_end; kb += BLOCK_K) {
        for (int i = threadIdx.x; i < BLOCK_K * D; i += BLOCK_Q) {
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

        if (live_row) {
            float s[BLOCK_K];
            unsigned live = 0u;
            float mt = NEG;
#pragma unroll
            for (int j = 0; j < BLOCK_K; ++j) {
                const int key = kb + j;
                bool ok = key < Tk;
                if (causal) {
                    ok = ok && key <= row;
                    if (window > 0) ok = ok && key > row - window;
                }
                float dot = 0.f;
#pragma unroll
                for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
                s[j] = ok ? dot * scale : NEG;
                if (ok) live |= 1u << j;
                mt = fmaxf(mt, s[j]);
            }
            if (live) {
                const float m_new = fmaxf(m, mt);
                const float alpha = expf(m - m_new);
#pragma unroll
                for (int d = 0; d < D; ++d) acc[d] *= alpha;
                float psum = 0.f;
#pragma unroll
                for (int j = 0; j < BLOCK_K; ++j) {
                    if (live & (1u << j)) {
                        const float p = expf(s[j] - m_new);
                        psum += p;
                        const float pr = to_f<T>(from_f<T>(p));
#pragma unroll
                        for (int d = 0; d < D; ++d)
                            acc[d] = fmaf(pr, vs[j][d], acc[d]);
                    }
                }
                l = l * alpha + psum;
                m = m_new;
            }
        }
        __syncthreads();
    }

    if (live_row) {
        const float denom = fmaxf(l, 1e-30f);
        T* op = out + ((size_t)(b * Tq + row) * H + h) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) op[d] = from_f<T>(acc[d] / denom);
        lse[(size_t)bh * Tq + row] = m + logf(denom);
    }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int Tq, int Tk, int H, int Hk, float scale,
            int causal, int window, cudaStream_t stream) {
    dim3 grid((Tq + BLOCK_Q - 1) / BLOCK_Q, B * H);
    flash_fwd_kernel<T, D><<<grid, BLOCK_Q, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), Tq, Tk, H, Hk, scale, causal, window);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window: 0 = none.  Returns the CUDA
// error code of the launch (0 on success); no synchronisation.  D is 16 or
// 64: the head widths of the repo's configurations (configs/
// induction_lm*.json and the bench_lm.py-width model).  (D = 128 is not
// built: a thread's q row + accumulator + scores exceed 255 registers
// there, and its fully unrolled body alone took minutes of nvcc time.)
int vt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int Tq, int Tk, int H, int Hk, int D,
                 int dtype, float scale, int causal, int window,
                 void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_LAUNCH(T, DV)                                                    \
    launch<T, DV>(q, k, v, out, lse, B, Tq, Tk, H, Hk, scale, causal,       \
                  window, st)
    if (D == 16 && dtype == 0) VT_LAUNCH(float, 16);
    else if (D == 16) VT_LAUNCH(__nv_bfloat16, 16);
    else if (D == 64 && dtype == 0) VT_LAUNCH(float, 64);
    else if (D == 64) VT_LAUNCH(__nv_bfloat16, 64);
    else return (int)cudaErrorInvalidValue;
#undef VT_LAUNCH
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
