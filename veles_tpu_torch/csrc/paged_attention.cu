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
// context before the output projection, as the TPU kernel's.  q is f32
// or bf16 (the model's compute type); the pool is f32, bf16 or f16 (the
// engine's cache type, ``cache_dtype``), its K and V rows widened to f32
// in registers; scores, the softmax and the accumulators are f32.  Dh is
// 16 or 64: the head widths of the repo's configurations
// (configs/induction_lm*.json and the bench_lm.py-width model).  Each
// (q, pool, Dh) combination is its own instance; the f32-pool instances
// are ``paged_decode_kernel``, the bf16-pool ones
// ``paged_decode_bf16pool_kernel``, the f16-pool ones
// ``paged_decode_f16pool_kernel``.
//
// What bounds it on this card: it reads every live K/V byte once and does
// ~1 flop per byte (2 with a 16-bit pool), so the bound is memory
// bandwidth (3.35 TB/s): ~17.5 MB of an f32 pool for 8 slots at mean
// position ~533, ~5.2 us; half of that with a bf16 or f16 pool.  One query
// against ~533 keys per (b, kh) is little work per group, so the risk is
// latency (too few loads in flight, too few blocks), not arithmetic.
//
// Design against that.  The G = H / Hk query heads of a kv head share
// every K/V byte, so a (b, kh) group is one unit of work -- and its live
// page range is split across a thread-block cluster of SPLITS blocks:
// grid (B, Hk, SPLITS), cluster (1, 1, SPLITS), each block a contiguous
// run of live pages fixed by (pos, SPLITS) (at l_max 1024 / page 16, at
// most 8 pages of 16 keys a block; 512 blocks at the serving shape, not
// 64).  Two warps a block: a cluster's 8 blocks must be resident in one
// GPC at once, and at 41.5 KB of shared memory a block the card holds 77
// such clusters with two warps (62 with four), so the serving shape's 64
// clusters run in one wave.  A block:
//   * reads its pages' table entries once, into per-key pool rows in
//     shared memory; a live entry outside [0, rows) is never read and
//     flags the group;
//   * starts the V rows of its keys into shared memory by 16-byte
//     cp.async, then loads the K rows in 16-byte pieces, 4 f32 or 8
//     bf16/f16 elements a lane (an f32 Dh=64 row is 16 lanes, two keys a
//     warp a load; 16-bit Dh=64 8 lanes, four keys; f32 Dh=16 4 lanes;
//     16-bit Dh=16 2 lanes), KROUND keys a thread in flight, and takes
//     each score with log2(lanes) shuffles within the row's lanes;
//   * writes the scores to shared memory, takes one max over them, then
//     exponentiates and takes P.V from the staged V rows: no per-key
//     rescale (a split longer than CHUNK keys goes in chunks, one rescale
//     a chunk);
//   * leaves its partial state (m, l, acc[G][Dh], the bad flag) in shared
//     memory.
// After a cluster barrier the rank-0 block reads the SPLITS partial states
// through distributed shared memory, merges them in rank order and writes
// the output (NaN for the whole group when any block saw a corrupt live
// entry); a second barrier keeps the other blocks' shared memory alive
// until it has.  One launch per call, no global scratch, no atomics: the
// splits and every reduction order are fixed, so two runs give the same
// bits.  Pages wholly past pos, or wholly before the window, are never
// read, so page-table entries past a slot's span (the scratch row) are
// never dereferenced.

#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "hopper_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using vt_tc::cp_async16;
using vt_tc::cp_async_commit;
using vt_tc::cp_async_wait_all;
using vt_tc::smem_u32;

constexpr int SPLITS = 8;      // blocks a (b, kh) group: the portable cluster
constexpr int NWARPS = 2;      // 64 threads: every cluster in one wave
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_G = 8;       // query heads per kv head handled per group
constexpr int CHUNK = 128;     // keys a block stages at once
constexpr int KROUND = 8;      // K rows a thread has in flight
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
        __nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// a pool element type's 16-byte piece: VEC elements, widened to f32 in
// registers (a bf16 word holds element 2i in its low half: the widening
// is a shift, exact)
template <typename TK> struct Piece;
template <> struct Piece<float> {
    static constexpr int VEC = 4;
    static __device__ __forceinline__ void widen(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x);
        f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z);
        f[3] = __uint_as_float(u.w);
    }
};
template <> struct Piece<__nv_bfloat16> {
    static constexpr int VEC = 8;
    static __device__ __forceinline__ void widen(const uint4& u, float* f) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};
// f16: 8 halves a piece, element 2i in the low half of word i, each
// widened by the exact half -> float conversion
template <> struct Piece<__half> {
    static constexpr int VEC = 8;
    static __device__ __forceinline__ void widen(const uint4& u, float* f) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __half2float(
                __ushort_as_half((unsigned short)(w[i] & 0xffffu)));
            f[2 * i + 1] = __half2float(
                __ushort_as_half((unsigned short)(w[i] >> 16)));
        }
    }
};

// The kernel body, one block of one (b, kh) group's cluster; TK is the
// pool's element type.  A key row of DH elements is LPK lanes of one
// 16-byte piece each (f32 Dh=64: 16 lanes, bf16/f16 Dh=64: 8, f32 Dh=16:
// 4, bf16/f16 Dh=16: 2); every lane keeps VEC accumulators a query head.
template <typename TQ, typename TK, int DH>
__device__ __forceinline__ void paged_decode_body(
        const TQ* __restrict__ q, const TK* __restrict__ kpool,
        const TK* __restrict__ vpool, const int* __restrict__ ptab,
        const int* __restrict__ pos, float* __restrict__ out, int H, int Hk,
        int psz, int n_ptab, int rows, float scale, int window) {
    using P = Piece<TK>;
    constexpr int VEC = P::VEC;
    constexpr int LPK = DH / VEC;          // lanes a key row
    constexpr int KPW = 32 / LPK;          // keys a warp loads at once
    constexpr int SLOTS = NWARPS * KPW;    // keys the block loads at once
    constexpr int KPT = CHUNK / SLOTS;     // keys a thread per chunk
    constexpr int KR = KPT < KROUND ? KPT : KROUND;
    static_assert(NWARPS * MAX_G * DH * 4 <= CHUNK * LPK * 16,
                  "the warps' sums reuse the V staging buffer");
    __shared__ uint4 sm_v[CHUNK * LPK];    // V rows; then the warps' sums
    __shared__ float sm_s[MAX_G][CHUNK];   // scores, then probabilities
    __shared__ int sm_row[CHUNK];          // pool row of each key, -1 bad
    __shared__ __align__(16) float sm_q[MAX_G * DH];
    __shared__ float sm_acc[MAX_G * DH];   // the block's partial P.V
    __shared__ float sm_m[MAX_G], sm_l[MAX_G], sm_alpha[MAX_G];
    __shared__ int sm_bad;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = H / Hk;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int slot = tid / LPK;            // key slot of the block
    const int c = lane % LPK;              // piece of the row

    for (int i = tid; i < G * DH; i += THREADS)
        sm_q[i] = to_f<TQ>(q[((size_t)b * H + kh * G) * DH + i]);
    if (tid < MAX_G) {
        sm_m[tid] = NEG;
        sm_l[tid] = 0.f;
    }
    if (tid == 0) sm_bad = 0;

    // this block's split of the live pages [j_lo, j_hi] and its keys
    const int p = pos[b];
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    const int j_lo = lo / psz;
    const int n_pages = max(0, min(p / psz, n_ptab - 1) - j_lo + 1);
    const int pa = j_lo + rank * n_pages / SPLITS;
    const int pb = j_lo + (rank + 1) * n_pages / SPLITS;
    const int t_begin = max(pa * psz, lo);
    const int n_keys = pb > pa ? min(pb * psz - 1, p) - t_begin + 1 : 0;
    const int* prow = ptab + (size_t)b * n_ptab;
    const float scale_log2 = scale * LOG2E;
    const size_t ld = (size_t)Hk * DH;     // elements a pool position
    const TK* kbase = kpool + (size_t)kh * DH + c * VEC;
    const TK* vbase = vpool + (size_t)kh * DH;

    float acc[MAX_G][VEC];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;

    for (int c0 = 0; c0 < n_keys; c0 += CHUNK) {
        const int n = min(CHUNK, n_keys - c0);
        __syncthreads();       // the last chunk's reads of shared memory
        for (int i = tid; i < n; i += THREADS) {
            const int t = t_begin + c0 + i;
            const int j = t / psz;
            const int phys = prow[j];
            const bool ok = phys >= 0 && phys < rows;
            if (!ok) sm_bad = 1;
            sm_row[i] = ok ? phys * psz + (t - j * psz) : -1;
        }
        __syncthreads();
        // V rows into shared memory, in flight while the scores are taken
        for (int i = tid; i < n * LPK; i += THREADS) {
            const int row = sm_row[i / LPK];
            cp_async16(smem_u32(&sm_v[i]),
                       vbase + (row >= 0 ? row * ld + (i % LPK) * VEC : 0),
                       row >= 0);
        }
        cp_async_commit();

        // scores (base 2), KR K rows a thread in flight
        for (int r0 = 0; r0 < KPT && r0 * SLOTS < n; r0 += KR) {
            uint4 kr[KR];
#pragma unroll
            for (int u = 0; u < KR; ++u) {
                const int idx = (r0 + u) * SLOTS + slot;
                const int row = idx < n ? sm_row[idx] : -1;
                kr[u] = row >= 0
                    ? __ldg(reinterpret_cast<const uint4*>(kbase + row * ld))
                    : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < KR; ++u) {
                const int idx = (r0 + u) * SLOTS + slot;
                float kf[VEC];
                P::widen(kr[u], kf);
#pragma unroll
                for (int g = 0; g < MAX_G; ++g) {
                    if (g < G) {
                        float qv[VEC];
                        const float4* q4 = reinterpret_cast<const float4*>(
                            sm_q + g * DH + c * VEC);
#pragma unroll
                        for (int e4 = 0; e4 < VEC / 4; ++e4) {
                            const float4 t = q4[e4];
                            qv[4 * e4] = t.x;
                            qv[4 * e4 + 1] = t.y;
                            qv[4 * e4 + 2] = t.z;
                            qv[4 * e4 + 3] = t.w;
                        }
                        float part = qv[0] * kf[0];
#pragma unroll
                        for (int e = 1; e < VEC; ++e)
                            part = fmaf(qv[e], kf[e], part);
#pragma unroll
                        for (int o = LPK / 2; o > 0; o >>= 1)
                            part += __shfl_xor_sync(0xffffffffu, part, o);
                        if (c == 0 && idx < n)
                            sm_s[g][idx] =
                                sm_row[idx] >= 0 ? part * scale_log2 : NEG;
                    }
                }
            }
        }
        __syncthreads();

        // one max over the chunk, then P = exp2(s - m); warp w takes the
        // heads g = w, w + NWARPS
        for (int g = warp; g < G; g += NWARPS) {
            const float m_old = sm_m[g];
            float mx = NEG;
            for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sm_s[g][i]);
            const float m_new = fmaxf(m_old, warp_max(mx));
            float sum = 0.f;
            for (int i = lane; i < n; i += 32) {
                const float pe = exp2f(sm_s[g][i] - m_new);
                sm_s[g][i] = pe;
                sum += pe;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = exp2f(m_old - m_new);
                sm_alpha[g] = alpha;
                sm_l[g] = fmaf(sm_l[g], alpha, sum);
                sm_m[g] = m_new;
            }
        }
        cp_async_wait_all();
        __syncthreads();

        // acc = alpha acc + P.V over this thread's keys
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
                const float a = sm_alpha[g];
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
            }
        }
#pragma unroll 4
        for (int idx = slot; idx < n; idx += SLOTS) {
            float vf[VEC];
            P::widen(sm_v[idx * LPK + c], vf);
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
                if (g < G) {
                    const float s = sm_s[g][idx];
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[g][e] = fmaf(s, vf[e], acc[g][e]);
                }
            }
        }
    }

    // the block's P.V: the key slots of a warp (lanes with the same c),
    // then the warps, in a fixed order
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
#pragma unroll
            for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        }
    }
    __syncthreads();           // sm_v is free
    float* red = reinterpret_cast<float*>(sm_v);   // [NWARPS][MAX_G][DH]
    if (lane < LPK) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
            if (g < G)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    red[(warp * MAX_G + g) * DH + lane * VEC + e] =
                        acc[g][e];
    }
    __syncthreads();
    for (int i = tid; i < G * DH; i += THREADS) {
        float a = red[i];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) a += red[w * MAX_G * DH + i];
        sm_acc[i] = a;
    }

    // merge the SPLITS partial states through distributed shared memory
    cluster.sync();
    if (rank == 0) {
        int bad = 0;
#pragma unroll
        for (int r = 0; r < SPLITS; ++r)
            bad |= *cluster.map_shared_rank(&sm_bad, r);
        for (int i = tid; i < G * DH; i += THREADS) {
            const int g = i / DH;
            float mr[SPLITS];
            float mx = NEG;
#pragma unroll
            for (int r = 0; r < SPLITS; ++r) {
                mr[r] = *cluster.map_shared_rank(&sm_m[g], r);
                mx = fmaxf(mx, mr[r]);
            }
            float l = 0.f, a = 0.f;
#pragma unroll
            for (int r = 0; r < SPLITS; ++r) {
                const float f = exp2f(mr[r] - mx);
                l = fmaf(*cluster.map_shared_rank(&sm_l[g], r), f, l);
                a = fmaf(*cluster.map_shared_rank(&sm_acc[i], r), f, a);
            }
            out[((size_t)b * H + kh * G) * DH + i] =
                bad ? __int_as_float(0x7fc00000) : a / fmaxf(l, 1e-30f);
        }
    }
    cluster.sync();            // rank 0 is done with the others' memory
}

// one __global__ name a pool type, so a profiler trace tells them apart
#define VT_PAGED_ARGS(TK)                                                   \
    const TQ* __restrict__ q, const TK* __restrict__ kpool,                 \
        const TK* __restrict__ vpool, const int* __restrict__ ptab,         \
        const int* __restrict__ pos, float* __restrict__ out, int H,        \
        int Hk, int psz, int n_ptab, int rows, float scale, int window

template <typename TQ, int DH>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 4)
paged_decode_kernel(VT_PAGED_ARGS(float)) {
    paged_decode_body<TQ, float, DH>(q, kpool, vpool, ptab, pos, out, H, Hk,
                                     psz, n_ptab, rows, scale, window);
}

template <typename TQ, int DH>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 4)
paged_decode_bf16pool_kernel(VT_PAGED_ARGS(__nv_bfloat16)) {
    paged_decode_body<TQ, __nv_bfloat16, DH>(q, kpool, vpool, ptab, pos,
                                             out, H, Hk, psz, n_ptab, rows,
                                             scale, window);
}

template <typename TQ, int DH>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 4)
paged_decode_f16pool_kernel(VT_PAGED_ARGS(__half)) {
    paged_decode_body<TQ, __half, DH>(q, kpool, vpool, ptab, pos, out, H,
                                      Hk, psz, n_ptab, rows, scale, window);
}
#undef VT_PAGED_ARGS

template <typename TQ, typename TK, int DH>
void launch(const void* q, const void* kp, const void* vp, const int* ptab,
            const int* pos, float* out, int B, int H, int Hk, int psz,
            int n_ptab, int rows, float scale, int window,
            cudaStream_t stream) {
    dim3 grid(B, Hk, SPLITS);
    const TQ* qq = static_cast<const TQ*>(q);
    const TK* k = static_cast<const TK*>(kp);
    const TK* v = static_cast<const TK*>(vp);
    if constexpr (std::is_same<TK, float>::value)
        paged_decode_kernel<TQ, DH><<<grid, THREADS, 0, stream>>>(
            qq, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows, scale,
            window);
    else if constexpr (std::is_same<TK, __half>::value)
        paged_decode_f16pool_kernel<TQ, DH><<<grid, THREADS, 0, stream>>>(
            qq, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows, scale,
            window);
    else
        paged_decode_bf16pool_kernel<TQ, DH><<<grid, THREADS, 0, stream>>>(
            qq, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows, scale,
            window);
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 =
// bfloat16, 2 = float16; the pools have 16-byte aligned bases and Dh is
// 16 or 64.  window: 0 = none.  Returns the CUDA
// error code of the launch (0 on success).
int vt_paged_attention_decode(const void* q, const void* kpool,
                              const void* vpool, const void* ptab,
                              const void* pos, void* out, int B, int H,
                              int Hk, int Dh, int psz, int n_ptab, int rows,
                              int q_dtype, int kv_dtype, float scale,
                              int window, void* stream) {
    if (B < 1 || Hk < 1 || H % Hk != 0 || H / Hk > MAX_G || psz < 1 ||
        n_ptab < 1 || rows < 1 || Hk > 65535 ||
        (q_dtype != 0 && q_dtype != 1) || kv_dtype < 0 || kv_dtype > 2 ||
        (((uintptr_t)kpool | (uintptr_t)vpool) & 15u) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(ptab);
    const int* ps = static_cast<const int*>(pos);
    float* o = static_cast<float*>(out);
#define VT_LAUNCH(TQ, TK, DHV)                                              \
    launch<TQ, TK, DHV>(q, kpool, vpool, pt, ps, o, B, H, Hk, psz, n_ptab,  \
                        rows, scale, window, st)
#define VT_POOL(TQ, DHV)                                                    \
    if (kv_dtype == 0) VT_LAUNCH(TQ, float, DHV);                           \
    else if (kv_dtype == 2) VT_LAUNCH(TQ, __half, DHV);                     \
    else VT_LAUNCH(TQ, __nv_bfloat16, DHV)
    if (Dh == 16 && q_dtype == 0) { VT_POOL(float, 16); }
    else if (Dh == 16) { VT_POOL(__nv_bfloat16, 16); }
    else if (Dh == 64 && q_dtype == 0) { VT_POOL(float, 64); }
    else if (Dh == 64) { VT_POOL(__nv_bfloat16, 64); }
    else return (int)cudaErrorInvalidValue;
#undef VT_POOL
#undef VT_LAUNCH
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
