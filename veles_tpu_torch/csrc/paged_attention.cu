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
// (pool, Dh, G = 1 or not) combination is its own instance (q's type is
// read at run time); the f32-pool instances are ``paged_decode_kernel``,
// the bf16-pool ones ``paged_decode_bf16pool_kernel``, the f16-pool ones
// ``paged_decode_f16pool_kernel``.
//
// What bounds it on this card: it reads every live K/V byte once and does
// ~1 flop per byte (2 with a 16-bit pool), so the bound is memory
// bandwidth (3.35 TB/s): 8.78 MB of a bf16 or f16 pool for 8 slots at
// mean position ~533, 2.62 us; 17.5 MB, 5.23 us, of an f32 pool.  What
// held the kernel back was not the bytes but a fixed chain of dependent
// steps in every block ("NVIDIA H100 80GB HBM3, 700.00 W", PERF.md
// section 6): the body this one replaces took 13.3-13.5 us hot on a
// bf16 or f16 pool and still 8.7-8.9 us with one key a row; stamped
// phase by phase, a block spent 1.4 us on the page table, 3.5-6.5 us on
// K in two register rounds and the scores, 2.2 us on a softmax by one
// warp and P.V, and 1.4 us after the first cluster barrier on a merge by
// rank 0 alone; an empty kernel of the same grid repeats every 2.0 us,
// and two cluster barriers add 1.1-1.2 us to it.
//
// Design against that.  The G = H / Hk query heads of a kv head share
// every K/V byte, so a (b, kh) group is one unit of work, and its live
// page range is split across a thread-block cluster of SPLITS = 4 blocks
// of 4 warps: grid (B, Hk, 4), cluster (1, 1, 4), each block a contiguous
// run of live pages fixed by (pos, SPLITS).  A block:
//   * reads pos, then the page-table entry of each of a thread's keys,
//     all in flight at once, then starts its keys' K and V rows into
//     shared memory by 16-byte cp.async, all at once: one round trip a
//     chunk of 9 keys a key slot (144 keys at a 16-bit pool and Dh=64, 72
//     at f32; 576 and 288 at Dh=16); a live entry outside [0, rows) is
//     never dereferenced and flags the group;
//   * a key row is LPK lanes of one 16-byte piece each (4 f32 or 8
//     bf16/f16 elements a lane), and thread (slot, c) owns piece c of K
//     and V of keys slot, slot + SLOTS, ...: it takes each score with
//     log2(LPK) shuffles and keeps its own online softmax over its keys,
//     one rescale a group of keys (a 16-bit chunk's 9 at once, an f32
//     pool's in threes), so no barrier and no block-wide max;
//   * merges its slots' states lane to lane within each warp, then
//     writes each warp's state into the shared memory of the ranks that
//     own its outputs (rank r owns G x Dh / SPLITS of them); a relaxed
//     cluster arrive at the start, waited for before the first remote
//     store, makes sure every block of the cluster has started;
//   * after one cluster barrier, merges its own outputs from the SPLITS x
//     NWARPS states in its own memory (lane r of a run of SPLITS lanes
//     takes rank r's warps, the run merges across its lanes) and writes
//     them, NaN for the whole group when any block saw a corrupt live
//     entry.  No block reads another's memory after the barrier, so none
//     waits for the others to leave.
// G = 1 (H = Hk, the serving shape) is its own instance, with no dead
// heads; G up to 8 is the other.  One launch per call, no global scratch,
// no atomics: the splits and every reduction order are fixed, so two
// runs give the same bits.  Pages wholly past pos, or wholly before the
// window, are never read, so page-table entries past a slot's span (the
// scratch row) are never dereferenced.
//
// Measured in one call against the body it replaces (PERF.md): bf16
// and f16 pools 13.3-13.5 -> 6.8-6.9 us hot, 19.8-20.2 -> 13.5-13.7 us
// cold; the f32 pool 15.0 -> 9.4 us hot, 24.3 -> 18.3-18.6 cold; the MoE
// chain's shape 7.8 -> 4.3 us.  Stamped, a bf16 block now spends ~2.0 us
// reading pos and its entries, 0.2 us waiting for K and V (3.1 us cold),
// 1.0 us on its scores and P.V, and ~2.3 us on the merges and the
// barrier.  Tried and not kept (the same calls): the old merge (rank 0
// pulling every state through distributed shared memory behind two
// barriers) with the new reads, 8.9-9.0 us; 8 splits of 2 warps with the
// writes into the owners, 7.8 us; 4 splits of 2 warps, 7.9-8.0 us; 16
// splits (a non-portable cluster, which the card grants) of 2 warps, 17.9
// us; the chunk's page-table entries staged once a warp in shared memory
// (fewer loads of the same lines), no faster on a 16-bit pool; an f32
// pool's keys in groups of 9, 0.4 us slower at the MoE chain's shape.
// 4 splits of 8 warps did not build: by our count its G <= 8 instance
// needs ~60 KB of static shared memory, over the 48 KB limit.

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

constexpr int SPLITS = 4;      // blocks a (b, kh) group: a cluster
constexpr int NWARPS = 4;      // 128 threads a block
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_G = 8;       // query heads per kv head handled per group
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float shfl_xor(float x, int o) {
    return __shfl_xor_sync(0xffffffffu, x, o);
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
// pool's element type, MG the most query heads a kv head it serves (1:
// G = 1 exactly; MAX_G: any G, dead heads skipped).  A key row of DH
// elements is LPK lanes of one 16-byte piece each (f32 Dh=64: 16 lanes,
// bf16/f16 Dh=64: 8, f32 Dh=16: 4, bf16/f16 Dh=16: 2); thread (slot, c)
// owns piece c of the keys slot, slot + SLOTS, ... of a chunk, of K and
// of V, and keeps its own softmax state (m, l, acc) over them.
template <typename TK, int DH, int MG>
__device__ __forceinline__ void paged_decode_body(
        const void* __restrict__ q, int q_bf16, const TK* __restrict__ kpool,
        const TK* __restrict__ vpool, const int* __restrict__ ptab,
        const int* __restrict__ pos, float* __restrict__ out, int H, int Hk,
        int psz, int n_ptab, int rows, float scale, int window) {
    using P = Piece<TK>;
    constexpr int VEC = P::VEC;
    constexpr int LPK = DH / VEC;          // lanes a key row
    constexpr int SLOTS = THREADS / LPK;   // keys the block takes at once
    // pieces a thread stages a chunk, of K and of V: 36 KB of shared
    // memory a block
    constexpr int KPT = 9;
    constexpr int CHUNK = KPT * SLOTS;     // keys a block stages at once
    // keys a thread scores before one rescale: a 16-bit chunk's 9 at
    // once; an f32 pool in threes (at the MoE chain's few keys a block the
    // unused scores of larger groups cost more than the rescales)
    constexpr int KG = sizeof(TK) == 4 ? 3 : KPT;
    static_assert(KPT % KG == 0, "whole groups of keys");
    __shared__ uint4 sm_k[KPT * THREADS];  // each thread's own pieces
    __shared__ uint4 sm_v[KPT * THREADS];
    __shared__ __align__(16) float sm_q[MG * DH];
    // the warp states of every rank, of this rank's outputs
    constexpr int PER = MG * DH / SPLITS;
    __shared__ float sm_m[SPLITS * NWARPS * MG], sm_l[SPLITS * NWARPS * MG];
    __shared__ float sm_acc[SPLITS * NWARPS * PER];
    __shared__ int sm_bad[SPLITS * NWARPS];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    // a relaxed arrive: this block has started (waited for before the
    // first store into another block's memory)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int b = blockIdx.x;
    const int kh = blockIdx.y;
    const int G = MG == 1 ? 1 : H / Hk;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int slot = tid / LPK;            // key slot of the block
    const int c = lane % LPK;              // piece of the row

    const int p = pos[b];
    // q, scaled so that q.k is the score in base 2
    const float scale_log2 = scale * LOG2E;
    const size_t q0 = ((size_t)b * H + kh * G) * DH;
    for (int i = tid; i < G * DH; i += THREADS)
        sm_q[i] = scale_log2 * (q_bf16
            ? __bfloat162float(
                  static_cast<const __nv_bfloat16*>(q)[q0 + i])
            : static_cast<const float*>(q)[q0 + i]);

    // this block's split of the live pages [j_lo, j_hi] and its keys
    const int lo = window > 0 ? max(0, p - window + 1) : 0;
    const int j_lo = lo / psz;
    const int n_pages = max(0, min(p / psz, n_ptab - 1) - j_lo + 1);
    const int pa = j_lo + rank * n_pages / SPLITS;
    const int pb = j_lo + (rank + 1) * n_pages / SPLITS;
    const int t_begin = max(pa * psz, lo);
    const int n_keys = pb > pa ? min(pb * psz - 1, p) - t_begin + 1 : 0;
    const int* prow = ptab + (size_t)b * n_ptab;
    const size_t ld = (size_t)Hk * DH;     // elements a pool position
    const TK* kbase = kpool + (size_t)kh * DH + c * VEC;
    const TK* vbase = vpool + (size_t)kh * DH + c * VEC;
    // the first slot of this warp: it has the most keys of the warp
    const int slot0 = warp * (32 / LPK);
    const int step_j = SLOTS / psz, step_off = SLOTS - step_j * psz;

    float m[MG], l[MG], acc[MG][VEC];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
        m[g] = NEG;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }
    bool bad = false;

    for (int c0 = 0; c0 < n_keys; c0 += CHUNK) {
        const int n = min(CHUNK, n_keys - c0);
        // the page-table entries of this thread's keys, all in flight,
        // then their K and V pieces, all in flight (key slot + k SLOTS is
        // at page j, offset off: one division a chunk)
        int ent[KPT], offs[KPT];
        {
            const int t0 = t_begin + c0 + slot;
            int j = t0 / psz, off = t0 - j * psz;
#pragma unroll
            for (int k = 0; k < KPT; ++k) {
                offs[k] = off;
                ent[k] = slot + k * SLOTS < n ? __ldg(prow + j) : 0;
                off += step_off;
                j += step_j;
                if (off >= psz) {
                    off -= psz;
                    ++j;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
            if (slot + k * SLOTS < n) {
                const bool ok = ent[k] >= 0 && ent[k] < rows;
                bad |= !ok;
                const size_t off =
                    ok ? ((size_t)ent[k] * psz + offs[k]) * ld : 0;
                cp_async16(smem_u32(&sm_k[k * THREADS + tid]), kbase + off,
                           ok);
                cp_async16(smem_u32(&sm_v[k * THREADS + tid]), vbase + off,
                           ok);
            }
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();       // sm_q

        // this thread's keys in groups of KG: scores, one rescale a
        // group, then P.V (a key past the chunk scores NEG, adds nothing)
        const int nk = n > slot ? (n - slot - 1) / SLOTS + 1 : 0;
        const int nk_warp = n > slot0 ? (n - slot0 - 1) / SLOTS + 1 : 0;
        for (int k0 = 0; k0 < nk_warp; k0 += KG) {
            float s[MG][KG];
#pragma unroll
            for (int u = 0; u < KG; ++u) {
                float kf[VEC];
                P::widen(sm_k[(k0 + u) * THREADS + tid], kf);
#pragma unroll
                for (int g = 0; g < MG; ++g) {
                    if (MG == 1 || g < G) {
                        const float4* q4 = reinterpret_cast<const float4*>(
                            sm_q + g * DH + c * VEC);
                        float part = 0.f;
#pragma unroll
                        for (int e4 = 0; e4 < VEC / 4; ++e4) {
                            const float4 t = q4[e4];
                            part = fmaf(t.x, kf[4 * e4], part);
                            part = fmaf(t.y, kf[4 * e4 + 1], part);
                            part = fmaf(t.z, kf[4 * e4 + 2], part);
                            part = fmaf(t.w, kf[4 * e4 + 3], part);
                        }
#pragma unroll
                        for (int o = LPK / 2; o > 0; o >>= 1)
                            part += shfl_xor(part, o);
                        s[g][u] = k0 + u < nk ? part : NEG;
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < MG; ++g) {
                if (MG == 1 || g < G) {
                    float mx = m[g];
#pragma unroll
                    for (int u = 0; u < KG; ++u) mx = fmaxf(mx, s[g][u]);
                    const float alpha = exp2f(m[g] - mx);
                    m[g] = mx;
                    l[g] *= alpha;
#pragma unroll
                    for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
                }
            }
#pragma unroll
            for (int u = 0; u < KG; ++u) {
                if (k0 + u < nk) {
                    float vf[VEC];
                    P::widen(sm_v[(k0 + u) * THREADS + tid], vf);
#pragma unroll
                    for (int g = 0; g < MG; ++g) {
                        if (MG == 1 || g < G) {
                            const float pe = exp2f(s[g][u] - m[g]);
                            l[g] += pe;
#pragma unroll
                            for (int e = 0; e < VEC; ++e)
                                acc[g][e] = fmaf(pe, vf[e], acc[g][e]);
                        }
                    }
                }
            }
        }
    }

    // the warp's state: the slots' states merged lane to lane (lanes with
    // the same c), in a fixed order
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            if (MG == 1 || g < G) {
                const float mo = shfl_xor(m[g], o);
                const float lo_ = shfl_xor(l[g], o);
                const float mx = fmaxf(m[g], mo);
                const float a = exp2f(m[g] - mx), ao = exp2f(mo - mx);
                l[g] = l[g] * a + lo_ * ao;
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[g][e] = acc[g][e] * a + shfl_xor(acc[g][e], o) * ao;
                m[g] = mx;
            }
        }
    }
    const bool wbad = __any_sync(0xffffffffu, bad);
    const int per = G * DH / SPLITS;       // outputs a rank

    // every block of the cluster has started: each warp writes its state
    // into the memory of the ranks that own its outputs, then one cluster
    // barrier, and no block reads another's memory after it
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int from = rank * NWARPS + warp;
    if (lane < LPK) {
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            if (MG == 1 || g < G) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    const int o = g * DH + lane * VEC + e;
                    const int to = o / per;
                    cluster.map_shared_rank(sm_acc, to)[
                        from * PER + o - to * per] = acc[g][e];
                }
            }
        }
    }
    if (lane < SPLITS) {
        float* dm = cluster.map_shared_rank(sm_m, lane);
        float* dl = cluster.map_shared_rank(sm_l, lane);
#pragma unroll
        for (int g = 0; g < MG; ++g) {
            dm[from * MG + g] = m[g];
            dl[from * MG + g] = l[g];
        }
        cluster.map_shared_rank(sm_bad, lane)[from] = wbad;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // this rank's share of the group's G x DH outputs: lane r of a run of
    // SPLITS lanes takes rank r's warp states, the run merges them across
    // its lanes in a fixed order
    const int r = tid % SPLITS;
    constexpr int RUNS = THREADS / SPLITS;
    const int steps = (per + RUNS - 1) / RUNS;
    int rbad = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) rbad |= sm_bad[r * NWARPS + w];
#pragma unroll
    for (int s = 1; s < SPLITS; s <<= 1)
        rbad |= __shfl_xor_sync(0xffffffffu, rbad, s);
#pragma unroll
    for (int i = 0; i < (PER + RUNS - 1) / RUNS; ++i) {
        if (i < steps) {
            const int ol = i * RUNS + tid / SPLITS;
            const int oc = min(ol, per - 1);
            const int g = (rank * per + oc) / DH;
            float mw[NWARPS], lw[NWARPS], aw[NWARPS];
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                mw[w] = sm_m[(r * NWARPS + w) * MG + g];
                lw[w] = sm_l[(r * NWARPS + w) * MG + g];
                aw[w] = sm_acc[(r * NWARPS + w) * PER + oc];
            }
            float mx = mw[0];
#pragma unroll
            for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, mw[w]);
            float ls = 0.f, as = 0.f;
#pragma unroll
            for (int w = 0; w < NWARPS; ++w) {
                const float f = exp2f(mw[w] - mx);
                ls = fmaf(lw[w], f, ls);
                as = fmaf(aw[w], f, as);
            }
            float gm = mx;
#pragma unroll
            for (int s = 1; s < SPLITS; s <<= 1)
                gm = fmaxf(gm, shfl_xor(gm, s));
            const float f = exp2f(mx - gm);
            ls *= f;
            as *= f;
#pragma unroll
            for (int s = 1; s < SPLITS; s <<= 1) {
                ls += shfl_xor(ls, s);
                as += shfl_xor(as, s);
            }
            if (r == 0 && ol < per)
                out[q0 + rank * per + ol] =
                    rbad ? __int_as_float(0x7fc00000) : as / fmaxf(ls, 1e-30f);
        }
    }
}

// one __global__ name a pool type, so a profiler trace tells them apart
#define VT_PAGED_ARGS(TK)                                                   \
    const void* __restrict__ q, int q_bf16, const TK* __restrict__ kpool,   \
        const TK* __restrict__ vpool, const int* __restrict__ ptab,         \
        const int* __restrict__ pos, float* __restrict__ out, int H,        \
        int Hk, int psz, int n_ptab, int rows, float scale, int window
#define VT_PAGED_CALL(TK)                                                   \
    paged_decode_body<TK, DH, MG>(q, q_bf16, kpool, vpool, ptab, pos, out,  \
                                  H, Hk, psz, n_ptab, rows, scale, window)

template <int DH, int MG>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 2)
paged_decode_kernel(VT_PAGED_ARGS(float)) {
    VT_PAGED_CALL(float);
}

template <int DH, int MG>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 2)
paged_decode_bf16pool_kernel(VT_PAGED_ARGS(__nv_bfloat16)) {
    VT_PAGED_CALL(__nv_bfloat16);
}

template <int DH, int MG>
__global__ void __cluster_dims__(1, 1, SPLITS) __launch_bounds__(THREADS, 2)
paged_decode_f16pool_kernel(VT_PAGED_ARGS(__half)) {
    VT_PAGED_CALL(__half);
}
#undef VT_PAGED_CALL
#undef VT_PAGED_ARGS

template <typename TK, int DH, int MG>
void launch(const void* q, int q_bf16, const void* kp, const void* vp,
            const int* ptab, const int* pos, float* out, int B, int H,
            int Hk, int psz, int n_ptab, int rows, float scale, int window,
            cudaStream_t stream) {
    dim3 grid(B, Hk, SPLITS);
    const TK* k = static_cast<const TK*>(kp);
    const TK* v = static_cast<const TK*>(vp);
    if constexpr (std::is_same<TK, float>::value)
        paged_decode_kernel<DH, MG><<<grid, THREADS, 0, stream>>>(
            q, q_bf16, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows,
            scale, window);
    else if constexpr (std::is_same<TK, __half>::value)
        paged_decode_f16pool_kernel<DH, MG><<<grid, THREADS, 0, stream>>>(
            q, q_bf16, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows,
            scale, window);
    else
        paged_decode_bf16pool_kernel<DH, MG><<<grid, THREADS, 0, stream>>>(
            q, q_bf16, k, v, ptab, pos, out, H, Hk, psz, n_ptab, rows,
            scale, window);
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
#define VT_LAUNCH(TK, DHV, MG)                                              \
    launch<TK, DHV, MG>(q, q_dtype, kpool, vpool, pt, ps, o, B, H, Hk, psz,  \
                        n_ptab, rows, scale, window, st)
#define VT_GROUP(TK, DHV)                                                   \
    if (H == Hk) VT_LAUNCH(TK, DHV, 1);                                     \
    else VT_LAUNCH(TK, DHV, MAX_G)
#define VT_POOL(DHV)                                                        \
    if (kv_dtype == 0) { VT_GROUP(float, DHV); }                            \
    else if (kv_dtype == 2) { VT_GROUP(__half, DHV); }                      \
    else { VT_GROUP(__nv_bfloat16, DHV); }
    if (Dh == 16) { VT_POOL(16) }
    else if (Dh == 64) { VT_POOL(64) }
    else return (int)cudaErrorInvalidValue;
#undef VT_POOL
#undef VT_GROUP
#undef VT_LAUNCH
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
