// Flash-attention forward, bf16, on Hopper's tensor cores (sm_90a, wgmma);
// plain C interface for ctypes.  The float32 instances run in 3xTF32 in
// flash_fwd_tf32x3.cu.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_fwd`
// (pallas_call at :205, kernel body `_flash_fwd_kernel` at :85-154) for
// bf16 q/k/v.  Wrapper and plain PyTorch version: veles_tpu_torch/ops/
// kernels/flash_attention.py, which sends every bf16 call at head dim 16
// or 64 here and nowhere else.
//
// Computes what the TPU kernel computes, per (batch b, q head h, row i):
//   out[b,i,h,:] = sum_j p_ij v[b,j,kh,:] / l_i,  lse[b,h,i] = m_i + log l_i
// with scores s_ij = q_i . k_j * scale, m_i their running maximum, p_ij =
// exp(s_ij - m_i) and l_i = sum_j p_ij, over the live keys j (j < Tk;
// causal: j <= i; window W: also j > i - W); kh = h / (H / Hk) (GQA, read
// in place).  Scores, m, l and the accumulator are f32; p is rounded to
// bf16 before P.V (the TPU kernel's p.astype(v.dtype), :134) -- here for
// free, since P enters the product as bf16 registers.  Masked scores are
// dropped (-inf against the -1e30 start of m, the TPU kernel's -1e30): a
// row with no live key writes 0 and lse = -1e30 + log(1e-30), never NaN.
// The softmax runs in base 2 on scores prescaled by scale * log2(e).
//
// What bounds it on this card: at the training and /predict shape (B=16,
// T=2048, H=8, D=64, causal) ~69 GFLOP against ~8 MB of traffic, so the
// bf16 tensor-core rate (989 TFLOP/s): 0.0695 ms.  The SIMT kernel did the
// same work as f32 FMAs (67 TFLOP/s peak) in 4.57 ms (H100, 700 W).
//
// Design.  One block per (tile of 128 query rows, b*h), two warpgroups of
// 64 rows each, q tiles issued heaviest (latest) first.  Q stays in shared
// memory for the whole block; K/V tiles of BK = 64 keys go through a
// 2-stage ring filled by 16-byte cp.async in the swizzled layout
// (hopper_tc.cuh), tile n+1's copy in flight while tile n is computed; two
// blocks share an SM.  Per K/V tile each warpgroup issues S = Q.K^T as
// D/16 wgmma m64n64k16 (A = Q, B = K, both from shared
// memory), runs the online softmax on the f32 fragments in registers (row
// max and sum across the 4 lanes of a quad), converts P to bf16 pairs in
// place and issues O += P.V as BK/16 wgmma m64nDk16 with A from registers
// and B = the V tile read N-major.  Tiles wholly past the causal diagonal,
// or with a window wholly before it, are never loaded; the mask is applied
// only on tiles the diagonal, the window edge or Tk cuts.  Rows >= Tq
// compute on zero-filled Q and write nothing; keys >= Tk read as zeros and
// are masked.  Not warp-specialised and with one product group in flight
// at a time: the simple form first.

#include "hopper_tc.cuh"

namespace {

using namespace vt_tc;

constexpr int BQ = 128;        // query rows a block (two warpgroups)
constexpr int BK = 64;         // keys a K/V tile (two blocks an SM)
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // start of m, as the TPU kernel's
constexpr float LN2 = 0.6931471805599453f;
#define NEG_INF __int_as_float(0xff800000)   // a masked score

template <int D>
struct Fwd {
    using T = Tile<D>;
    static constexpr int Q_BYTES = BQ * T::ROW_BYTES;
    static constexpr int KV_BYTES = BK * T::ROW_BYTES;
    static constexpr int STAGE_BYTES = 2 * KV_BYTES;        // K then V
    static constexpr int SMEM = Q_BYTES + 2 * STAGE_BYTES + 1024;
    static constexpr int S_REGS = BK / 2;   // score fragment per thread
    static constexpr int O_REGS = D / 2;    // output fragment per thread
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, int Tq, int Tk, int H, int Hk,
             float scale_log2, int causal, int window) {
    using C = Fwd<D>;
    using T = typename C::T;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t ring = q_s + C::Q_BYTES;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;                   // warpgroup: rows 64 wg..
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hk);
    // this thread's two rows: r0 and r0 + 8
    const int r0 = q0 + wg * 64 + warp * 16 + g;

    int k_end = Tk;
    int k_begin = 0;
    if (causal) {
        k_end = min(Tk, q0 + BQ);
        if (window > 0) {
            k_begin = max(0, q0 - window + 1);
            k_begin -= k_begin % BK;
        }
    }
    const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK
                                        : 0;

    const size_t ldq = (size_t)H * D;
    const size_t ldk = (size_t)Hk * D;
    const bf16* kp = k + (size_t)b * Tk * ldk + (size_t)kh * D;
    const bf16* vp = v + (size_t)b * Tk * ldk + (size_t)kh * D;

    T::template load<BQ, THREADS>(
        q_s, q + ((size_t)b * Tq + q0) * ldq + (size_t)h * D, ldq, Tq - q0,
        tid);
    if (n_tiles > 0) {
        T::template load<BK, THREADS>(ring, kp + (size_t)k_begin * ldk, ldk,
                                      Tk - k_begin, tid);
        T::template load<BK, THREADS>(ring + C::KV_BYTES,
                                      vp + (size_t)k_begin * ldk, ldk,
                                      Tk - k_begin, tid);
    }
    cp_async_commit();

    float o[C::O_REGS];
#pragma unroll
    for (int i = 0; i < C::O_REGS; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG};    // running max, base-2 scaled units
    float l[2] = {0.f, 0.f};    // this lane's share of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        const int kb = k_begin + it * BK;
        const uint32_t k_s = ring + (it & 1) * C::STAGE_BYTES;
        const uint32_t v_s = k_s + C::KV_BYTES;
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();       // tile it landed; tile it-1's stage is free
        if (it + 1 < n_tiles) {
            const uint32_t nk = ring + ((it + 1) & 1) * C::STAGE_BYTES;
            const int nb = kb + BK;
            T::template load<BK, THREADS>(nk, kp + (size_t)nb * ldk, ldk,
                                          Tk - nb, tid);
            T::template load<BK, THREADS>(nk + C::KV_BYTES,
                                          vp + (size_t)nb * ldk, ldk,
                                          Tk - nb, tid);
        }
        cp_async_commit();

        // S = Q . K^T
        float s[C::S_REGS];
#pragma unroll
        for (int i = 0; i < C::S_REGS; ++i) s[i] = 0.f;
        fence_regs<C::S_REGS>(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(s, T::desc(q_s + wg * 64 * T::ROW_BYTES + kk * 32),
                     T::desc(k_s + kk * 32), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<C::S_REGS>(s);

        // mask only tiles that the diagonal, the window edge or Tk cuts
        const bool full =
            kb + BK <= Tk &&
            (!causal || (kb + BK - 1 <= q0 &&
                         (window <= 0 || kb > q0 + BQ - 1 - window)));
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int half = e >> 1;
                float x = s[4 * i + e] * scale_log2;
                if (!full) {
                    const int row = r0 + 8 * half;
                    const int key = kb + 8 * i + 2 * t + (e & 1);
                    bool ok = key < Tk;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                    if (!ok) x = NEG_INF;
                }
                s[4 * i + e] = x;
                mx[half] = fmaxf(mx[half], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
            alpha[hf] = exp2f(m[hf] - mx[hf]);
            m[hf] = mx[hf];
            l[hf] *= alpha[hf];
        }
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                p[e] = exp2f(s[4 * i + e] - mx[e >> 1]);   // masked: 0
                l[e >> 1] += p[e];
            }
            pa[i >> 1][2 * (i & 1)] = pack_bf16(p[0], p[1]);
            pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            o[4 * i] *= alpha[0];
            o[4 * i + 1] *= alpha[0];
            o[4 * i + 2] *= alpha[1];
            o[4 * i + 3] *= alpha[1];
        }

        // O += P . V
        fence_regs<C::O_REGS>(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
            wgmma_rs<D>(o, pa[j], T::desc(v_s + j * 16 * T::ROW_BYTES));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<C::O_REGS>(o);
    }
    cp_async_wait_all();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
        l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
        const int row = r0 + 8 * hf;
        if (row >= Tq) continue;
        const float denom = fmaxf(l[hf], 1e-30f);
        bf16* op = out + ((size_t)b * Tq + row) * ldq + (size_t)h * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const uint32_t pr = pack_bf16(o[4 * i + 2 * hf] / denom,
                                          o[4 * i + 2 * hf + 1] / denom);
            *reinterpret_cast<uint32_t*>(op + 8 * i + 2 * t) = pr;
        }
        if (t == 0)
            lse[(size_t)bh * Tq + row] =
                (l[hf] > 0.f ? m[hf] * LN2 : NEG) + logf(denom);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Tq, int Tk, int H, int Hk, float scale,
           int causal, int window, cudaStream_t stream) {
    // shared memory above 48 KB is opt-in (per device: set every call)
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Fwd<D>::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    dim3 grid((Tq + BQ - 1) / BQ, B * H);
    flash_fwd_tc<D><<<grid, THREADS, Fwd<D>::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), Tq, Tk, H, Hk,
        scale * 1.4426950408889634f, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q/k/v/out in (B, T, H, D) with 16-byte aligned bases, f32 lse
// (B, H, Tq).  D is 16 or 64.  window: 0 = none.  Returns the CUDA error
// code of the launch (0 on success); no synchronisation.
int vt_flash_fwd_tc(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int Tq, int Tk, int H, int Hk, int D,
                    float scale, int causal, int window, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535 ||
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out)
         & 15u) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 64)
        return launch<64>(q, k, v, out, lse, B, Tq, Tk, H, Hk, scale, causal,
                          window, st);
    if (D == 16)
        return launch<16>(q, k, v, out, lse, B, Tq, Tk, H, Hk, scale, causal,
                          window, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
