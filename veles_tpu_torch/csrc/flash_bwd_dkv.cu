// Flash-attention backward, dK and dV, for Hopper (sm_90a), float32
// instances, on the SIMT cores; plain C interface for ctypes.  The bf16
// instances run on the tensor cores in flash_bwd_dkv_tc.cu (the wrapper
// routes by dtype).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_bwd`'s
// dK/dV pallas_call (:411, kernel body `_flash_bwd_dkv_kernel` :312-357)
// for float32 inputs.
// Wrapper and plain PyTorch version: veles_tpu_torch/ops/kernels/
// flash_bwd_dkv.py.
//
// Computes, per (batch b, kv head kh, key row j), by recompute from the
// forward's row logsumexp:
//   p_ij  = mask ? exp(q_i . k_j * scale - lse_i) : 0
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   dv_j  = sum_{g, i} round(p_ij) * dO_i      dk_j = sum_{g, i} round(ds_ij) * q_i
// where the sum runs over the G = H / Hk query heads h = kh * G + g that
// share kv head kh and over their query rows i (causal: i >= j; window W:
// i < j + W).  round() is the cast of P to dO's dtype before P^T.dO
// (:337) and of dS to q's dtype before dS^T.Q (:344): identity in float32,
// round-to-nearest-even in bfloat16.  Accumulators are float32; dk and dv
// are written in k's and v's dtype.
//
// What bounds it on this card: four products of (T x D) by (D x T) per
// (b, h), ~4 x 34 GFLOP at the training path's shape (B=16, T=2048, H=8,
// D=64, causal) against ~10 MB of traffic.  In float32 the bound is the
// f32 rate outside the tensor cores (67 TFLOP/s): the tensor cores cannot
// hold f32 to this kernel's bound (1024 units of 2^-24) without a 3xTF32
// split.  The f32 instances serve chip_smoke.py's f32 train step and
// edge cases and configs/induction_lm.json's quality run (f32, D=16).
//
// Design: one block per (b*Hk, tile of ROWS keys); TPR = D/16 threads per
// key row, each owning 16 of its head dims, so a thread keeps k, v and
// both accumulators as four 16-wide register rows.  The TPU grid's minor
// axis (group member g, q block) becomes the block's loop: for each g,
// Q/dO tiles of BLOCK_Q rows (with their lse and delta) are staged in
// shared memory as float32 and every key row of the block sweeps them.
// All G heads of a group fold into the same registers in a fixed order
// (g-major, then ascending query row), so there is no atomicAdd and the
// gradients are the same bits from run to run.  Query tiles that no key
// of the block can see are skipped (`_flash_block_live`, as a row range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // key rows per block
constexpr int BLOCK_Q = 64;    // query rows per shared-memory tile
constexpr int PER = 16;        // head dims per thread

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
    return x;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS * (D / PER))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int H, int Hk,
                     float scale, int causal, int window) {
    constexpr int TPR = D / PER;               // threads per key row
    __shared__ float qs[BLOCK_Q][D];
    __shared__ float dos[BLOCK_Q][D];
    __shared__ float lse_s[BLOCK_Q];
    __shared__ float delta_s[BLOCK_Q];

    const int bkh = blockIdx.y;                // b * Hk + kh
    const int b = bkh / Hk;
    const int kh = bkh - b * Hk;
    const int G = H / Hk;
    const int k0 = blockIdx.x * ROWS;
    const int lane = threadIdx.x % TPR;        // owns dims lane + TPR * t
    const int key = k0 + threadIdx.x / TPR;
    const bool live_key = key < Tk;

    float kr[PER], vr[PER], dk_acc[PER], dv_acc[PER];
    const size_t key_off = ((size_t)(b * Tk + key) * Hk + kh) * D;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
        kr[t] = live_key ? to_f<T>(k[key_off + lane + TPR * t]) : 0.f;
        vr[t] = live_key ? to_f<T>(v[key_off + lane + TPR * t]) : 0.f;
        dk_acc[t] = 0.f;
        dv_acc[t] = 0.f;
    }

    // query rows any key of this block can see (whole-tile skipping)
    int q_begin = 0;
    int q_end = Tq;
    if (causal) {
        q_begin = (k0 / BLOCK_Q) * BLOCK_Q;
        if (window > 0) q_end = min(Tq, k0 + ROWS - 1 + window);
    }

    for (int g = 0; g < G; ++g) {
        const int h = kh * G + g;
        const size_t bh = (size_t)b * H + h;
        for (int qb = q_begin; qb < q_end; qb += BLOCK_Q) {
            for (int i = threadIdx.x; i < BLOCK_Q * D; i += blockDim.x) {
                const int r = i / D;
                const int d = i - r * D;
                const int row = qb + r;
                float qv = 0.f, dov = 0.f;
                if (row < Tq) {
                    const size_t off = ((size_t)(b * Tq + row) * H + h) * D
                                       + d;
                    qv = to_f<T>(q[off]);
                    dov = to_f<T>(dout[off]);
                }
                qs[r][d] = qv;
                dos[r][d] = dov;
            }
            for (int r = threadIdx.x; r < BLOCK_Q; r += blockDim.x) {
                const int row = qb + r;
                lse_s[r] = row < Tq ? lse[bh * Tq + row] : 0.f;
                delta_s[r] = row < Tq ? delta[bh * Tq + row] : 0.f;
            }
            __syncthreads();

            // same trip count for the whole block: every lane reaches
            // the shuffles
            const int rn = min(BLOCK_Q, Tq - qb);
#pragma unroll 2
            for (int r = 0; r < rn; ++r) {
                const int row = qb + r;
                float qv[PER], dov[PER];
                float s = 0.f, dp = 0.f;
#pragma unroll
                for (int t = 0; t < PER; ++t) {
                    qv[t] = qs[r][lane + TPR * t];
                    dov[t] = dos[r][lane + TPR * t];
                    s = fmaf(qv[t], kr[t], s);
                    dp = fmaf(dov[t], vr[t], dp);
                }
#pragma unroll
                for (int o = TPR / 2; o > 0; o >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, o);
                    dp += __shfl_xor_sync(0xffffffffu, dp, o);
                }
                bool ok = live_key;
                if (causal) {
                    ok = ok && key <= row;
                    if (window > 0) ok = ok && key > row - window;
                }
                const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
                const float pr = round_to<T>(p);
                const float ds = round_to<T>(p * (dp - delta_s[r]) * scale);
#pragma unroll
                for (int t = 0; t < PER; ++t) {
                    dv_acc[t] = fmaf(pr, dov[t], dv_acc[t]);
                    dk_acc[t] = fmaf(ds, qv[t], dk_acc[t]);
                }
            }
            __syncthreads();
        }
    }

    if (live_key) {
#pragma unroll
        for (int t = 0; t < PER; ++t) {
            dk[key_off + lane + TPR * t] = from_f<T>(dk_acc[t]);
            dv[key_off + lane + TPR * t] = from_f<T>(dv_acc[t]);
        }
    }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int Tq, int Tk, int H, int Hk, float scale, int causal,
            int window, cudaStream_t stream) {
    dim3 grid((Tk + ROWS - 1) / ROWS, B * Hk);
    flash_bwd_dkv_kernel<T, D><<<grid, ROWS * (D / PER), 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H, Hk, scale,
        causal, window);
}

}  // namespace

extern "C" {

// float32 q, k, v, dout, dk and dv (bfloat16 is flash_bwd_dkv_tc.cu's);
// lse and delta are float32 (B, H, Tq).  D is 16 or 64.  window: 0 =
// none.  Returns the CUDA error code of the launch (0 on success); no
// synchronisation.
int vt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int Tq, int Tk, int H,
                     int Hk, int D, float scale, int causal, int window,
                     void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * Hk > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_LAUNCH(T, DV)                                                    \
    launch<T, DV>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, Hk,      \
                  scale, causal, window, st)
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
