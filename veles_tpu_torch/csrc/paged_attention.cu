// Paged-attention decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py
// `paged_attention_decode` (pallas_call at :612, kernel body
// `_paged_attn_kernel` at :496-553).  Wrapper and plain PyTorch version:
// veles_tpu_torch/ops/kernels/paged_attention.py.
//
// One decode position per batch row b: the query q[b] (B, H, Dh) attends
// the keys/values of positions t <= pos[b] (and t > pos[b] - W with a
// window W), which live in a flat page pool (rows, psz, Hk, Dh): logical
// page j of row b is pool row ptab[b, j].  Output: the (B, H, Dh) f32
// context before the output projection.  q is f32 or bf16 (the model's
// compute type); the pool is f32, the engine's cache type; scores, the
// online softmax and the accumulators are f32.  Dh is 16 or 64: the head
// widths of the repo's configurations (configs/induction_lm*.json and the
// bench_lm.py-width model).
//
// What bounds it on this card: it reads every live K/V byte once and does
// ~4 flops per byte at most, so the bound is memory bandwidth (3.35 TB/s):
// ~18 MB of an f32 pool for 8 slots at mean position ~544, ~5 us.  The
// work per row is small, so the risk is latency (too few loads in
// flight), not arithmetic.
//
// Design against that: one block per (slot row b, kv head kh) covers the
// G = H / Hk query heads of its group, so each K/V row is read once for
// all G heads.  The TPU kernel's scalar prefetch of the page table into
// SMEM (PrefetchScalarGridSpec) has no counterpart: the block reads its
// own ptab row and pos.  The TPU's sequential page sweep becomes a split
// inside the block: NWARPS warps take the live logical pages round-robin,
// each warp keeps its own online-softmax state (a lane holds Dh/32 dims
// of every head, or one dim with Dh 16), and the warps' states merge through shared memory at the end.
// Only live pages are touched: pages wholly past pos, and with a window
// wholly before it, are never read, so page-table entries past a slot's
// span (the scratch row) are never dereferenced.  A live entry outside
// [0, rows) is never read either: the block writes NaN for its heads, so
// a corrupt page table shows in the output instead of passing as a
// softmax over the remaining pages.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int MAX_G = 8;       // query heads per kv head handled per block
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
        __nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

template <typename TQ, int DH>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const TQ* __restrict__ q, const float* __restrict__ kpool,
                    const float* __restrict__ vpool,
                    const int* __restrict__ ptab, const int* __restrict__ pos,
                    float* __restrict__ out, int H, int Hk, int psz,
                    int n_ptab, int rows, float scale, int window) {
    // head dims per lane; with DH < 32 the lanes past DH hold none
    constexpr int DPL = DH >= 32 ? DH / 32 : 1;
    __shared__ float sm_m[NWARPS][MAX_G];
    __shared__ float sm_l[NWARPS][MAX_G];
    __shared__ float sm_acc[NWARPS][MAX_G][DH];
    __shared__ int sm_bad[NWARPS];

    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = H / Hk;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const bool dl = lane * DPL < DH;

    const int p = pos[b];
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    const int j_lo = lo / psz;
    const int j_hi = min(p / psz, n_ptab - 1);

    float qr[MAX_G][DPL];
    float acc[MAX_G][DPL];
    float m[MAX_G];
    float l[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
        m[g] = NEG;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            acc[g][i] = 0.f;
            qr[g][i] = 0.f;
            if (g < G && dl)
                qr[g][i] = to_f<TQ>(
                    q[((size_t)b * H + kh * G + g) * DH + lane * DPL + i]);
        }
    }

    const int* prow = ptab + (size_t)b * n_ptab;
    int bad = 0;                               // a live entry out of range
    for (int j = j_lo + warp; j <= j_hi; j += NWARPS) {
        const int phys = prow[j];
        if (phys < 0 || phys >= rows) {
            bad = 1;
            continue;
        }
        const int t0 = max(j * psz, lo);
        const int t1 = min(j * psz + psz - 1, p);
#pragma unroll 2
        for (int t = t0; t <= t1; ++t) {
            const size_t base =
                (((size_t)phys * psz + (t - j * psz)) * Hk + kh) * DH +
                lane * DPL;
            float kr[DPL], vr[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                kr[i] = dl ? kpool[base + i] : 0.f;
                vr[i] = dl ? vpool[base + i] : 0.f;
            }
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
                if (g < G) {
                    float part = 0.f;
#pragma unroll
                    for (int i = 0; i < DPL; ++i)
                        part = fmaf(qr[g][i], kr[i], part);
                    const float s = warp_sum(part) * scale;
                    const float m_new = fmaxf(m[g], s);
                    const float alpha = expf(m[g] - m_new);
                    const float pe = expf(s - m_new);
                    l[g] = l[g] * alpha + pe;
#pragma unroll
                    for (int i = 0; i < DPL; ++i)
                        acc[g][i] = fmaf(acc[g][i], alpha, pe * vr[i]);
                    m[g] = m_new;
                }
            }
        }
    }

    if (lane == 0) sm_bad[warp] = bad;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
            if (lane == 0) {
                sm_m[warp][g] = m[g];
                sm_l[warp][g] = l[g];
            }
            if (dl) {
#pragma unroll
                for (int i = 0; i < DPL; ++i)
                    sm_acc[warp][g][lane * DPL + i] = acc[g][i];
            }
        }
    }
    __syncthreads();

    int any_bad = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) any_bad |= sm_bad[w];
    for (int idx = threadIdx.x; idx < G * DH; idx += NWARPS * 32) {
        const int g = idx / DH;
        const int d = idx - g * DH;
        float mx = NEG;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
        float lsum = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
            const float f = expf(sm_m[w][g] - mx);
            lsum = fmaf(sm_l[w][g], f, lsum);
            a = fmaf(sm_acc[w][g][d], f, a);
        }
        out[((size_t)b * H + kh * G + g) * DH + d] =
            any_bad ? __int_as_float(0x7fc00000) : a / fmaxf(lsum, 1e-30f);
    }
}

template <typename TQ, int DH>
void launch(const void* q, const void* kp, const void* vp, const int* ptab,
            const int* pos, float* out, int B, int H, int Hk, int psz,
            int n_ptab, int rows, float scale, int window,
            cudaStream_t stream) {
    dim3 grid(B, Hk);
    paged_decode_kernel<TQ, DH><<<grid, NWARPS * 32, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), ptab, pos, out, H, Hk, psz, n_ptab,
        rows, scale, window);
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; the pools are float32 and Dh is 16
// or 64.  window: 0 = none.  Returns the CUDA error code of the launch
// (0 on success).
int vt_paged_attention_decode(const void* q, const void* kpool,
                              const void* vpool, const void* ptab,
                              const void* pos, void* out, int B, int H,
                              int Hk, int Dh, int psz, int n_ptab, int rows,
                              int q_dtype, float scale, int window,
                              void* stream) {
    if (B < 1 || Hk < 1 || H % Hk != 0 || H / Hk > MAX_G || psz < 1 ||
        n_ptab < 1 || rows < 1 || Hk > 65535 || (q_dtype != 0 && q_dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(ptab);
    const int* ps = static_cast<const int*>(pos);
    float* o = static_cast<float*>(out);
#define VT_LAUNCH(TQ, DHV)                                                  \
    launch<TQ, DHV>(q, kpool, vpool, pt, ps, o, B, H, Hk, psz, n_ptab,      \
                    rows, scale, window, st)
    if (Dh == 16 && q_dtype == 0) VT_LAUNCH(float, 16);
    else if (Dh == 16) VT_LAUNCH(__nv_bfloat16, 16);
    else if (Dh == 64 && q_dtype == 0) VT_LAUNCH(float, 64);
    else if (Dh == 64) VT_LAUNCH(__nv_bfloat16, 64);
    else return (int)cudaErrorInvalidValue;
#undef VT_LAUNCH
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
