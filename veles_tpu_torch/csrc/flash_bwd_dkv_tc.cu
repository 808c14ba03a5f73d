// Flash-attention backward, dK and dV, bf16, on Hopper's tensor cores
// (sm_90a, wgmma); plain C interface for ctypes.  The float32 instances
// are flash_bwd_dkv_tf32x3.cu's (mma.sync, 3xTF32).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_bwd`'s
// dK/dV pallas_call (:411, kernel body `_flash_bwd_dkv_kernel` :312-357)
// for bf16 inputs.  Wrapper and plain PyTorch version: veles_tpu_torch/ops/
// kernels/flash_bwd_dkv.py, which sends every bf16 call at head dim 16 or
// 64 here and nowhere else.
//
// Computes what the TPU kernel computes, per (batch b, kv head kh, key j),
// by recompute from the forward's row logsumexp:
//   p_ij  = mask ? exp(q_i . k_j * scale - lse_i) : 0
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   dv_j  = sum_{g, i} bf16(p_ij) dO_i      dk_j = sum_{g, i} bf16(ds_ij) q_i
// over the G = H / Hk query heads h = kh * G + g of the kv head and their
// rows i (causal: i >= j; window W: i < j + W).  P and dS are rounded to
// bf16 before P^T.dO and dS^T.Q (:337, :344); masked P is 0 by the mask,
// not by underflow; the accumulators are f32 and dk, dv are written bf16.
//
// What bounds it on this card: four products of 2 * B * H * D * T(T+1)/2
// operations at the training shape (B=16, T=2048, H=8, D=64, causal),
// ~137 GFLOP against ~10 MB of traffic: the bf16 tensor-core rate (989
// TFLOP/s), 0.139 ms.  The f32-FMA SIMT kernel took 7.9 ms
// for it (H100, 700 W).
//
// Design.  One block per (tile of 64 keys, b*Hk), one warpgroup, three
// blocks an SM; the block keeps its K and V tiles in shared memory for its
// whole life and dK, dV as f32 wgmma accumulators in registers, keys as
// M.  The TPU grid's minor axis (group member g, q block) becomes the
// block's loop: g in a fixed order, then the query tiles of 64 rows that
// some key of the block can see.  Q, dO, lse and delta of the next tile
// stream in by cp.async through a 2-stage ring while this tile is
// computed.  Per tile the warpgroup issues four products, all with keys
// as M, so neither P nor dS is ever transposed through shared memory:
//   S^T  = K . Q^T    (A = K, B = the Q tile K-major)      m64n64k16 x D/16
//   dP^T = V . dO^T   (A = V, B = the dO tile K-major)     m64n64k16 x D/16
//   dV  += P^T . dO   (A = bf16 P^T from registers, B = dO N-major)
//   dK  += dS^T . Q   (A = bf16 dS^T from registers, B = Q N-major)
//                                                           m64nDk16 x 4
// with P^T and dS^T made in registers between them.  No float atomics: a
// block owns its keys, and the G heads fold into the same registers in one
// order, so two runs give the same bits.  The mask is applied only on
// tiles the diagonal, the window edge, Tq or Tk cuts.

#include "hopper_tc.cuh"

namespace {

using namespace vt_tc;

constexpr int BQ = 64;         // query rows a streamed tile
constexpr int BKV = 64;        // keys a block (one warpgroup)
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Bwd {
    using T = Tile<D>;
    static constexpr int KV_BYTES = BKV * T::ROW_BYTES;
    static constexpr int Q_BYTES = BQ * T::ROW_BYTES;
    static constexpr int STAGE_BYTES = 2 * Q_BYTES;         // Q then dO
    static constexpr int STAT_BYTES = 2 * BQ * 4;           // lse, delta
    static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGE_BYTES
                                + 2 * STAT_BYTES + 1024;
    static constexpr int ACC = D / 2;       // dK / dV fragment per thread
};

template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Tq, int Tk, int H, int Hk,
                 float scale, int causal, int window) {
    using C = Bwd<D>;
    using T = typename C::T;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t k_s = (raw + 1023u) & ~1023u;
    const uint32_t v_s = k_s + C::KV_BYTES;
    const uint32_t ring = v_s + C::KV_BYTES;
    const uint32_t stats = ring + 2 * C::STAGE_BYTES;
    const float* stats_p =
        reinterpret_cast<const float*>(smem_raw + (stats - raw));

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int k0 = blockIdx.x * BKV;           // low keys (most work) first
    const int bkh = blockIdx.y;
    const int b = bkh / Hk;
    const int kh = bkh - b * Hk;
    const int G = H / Hk;
    // this thread's two keys: key0 and key0 + 8
    const int key0 = k0 + warp * 16 + g;

    // query rows any key of this block can see (whole-tile skipping)
    int q_begin = 0;
    int q_end = Tq;
    if (causal) {
        q_begin = (k0 / BQ) * BQ;
        if (window > 0) q_end = min(Tq, k0 + BKV - 1 + window);
    }
    const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
    const int n_it = G * n_q;

    const size_t ldq = (size_t)H * D;
    const size_t ldk = (size_t)Hk * D;
    const size_t kv_off = ((size_t)b * Tk + k0) * ldk + (size_t)kh * D;
    T::template load<BKV, THREADS>(k_s, k + kv_off, ldk, Tk - k0, tid);
    T::template load<BKV, THREADS>(v_s, v + kv_off, ldk, Tk - k0, tid);

    // stage iteration `it`'s Q, dO, lse and delta into ring stage `st`
    auto stage_in = [&](int it, int st) {
        const int gi = it / n_q;
        const int qb = q_begin + (it - gi * n_q) * BQ;
        const int h = kh * G + gi;
        const size_t off = ((size_t)b * Tq + qb) * ldq + (size_t)h * D;
        const uint32_t qd = ring + st * C::STAGE_BYTES;
        T::template load<BQ, THREADS>(qd, q + off, ldq, Tq - qb, tid);
        T::template load<BQ, THREADS>(qd + C::Q_BYTES, dout + off, ldq,
                                      Tq - qb, tid);
        if (tid < 2 * BQ) {
            const int r = tid & (BQ - 1);
            const float* src = (tid < BQ ? lse : delta)
                               + ((size_t)b * H + h) * Tq;
            const bool ok = qb + r < Tq;
            cp_async4(stats + st * C::STAT_BYTES + tid * 4,
                      src + (ok ? qb + r : 0), ok);
        }
    };
    if (n_it > 0) stage_in(0, 0);
    cp_async_commit();

    float dk_acc[C::ACC], dv_acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
    }
    const float scale_log2 = scale * LOG2E;

    for (int it = 0; it < n_it; ++it) {
        const int st = it & 1;
        const int gi = it / n_q;
        const int qb = q_begin + (it - gi * n_q) * BQ;
        const uint32_t q_t = ring + st * C::STAGE_BYTES;
        const uint32_t do_t = q_t + C::Q_BYTES;
        const float* lse_t = stats_p + st * (C::STAT_BYTES / 4);
        const float* delta_t = lse_t + BQ;
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();       // tile it landed; tile it-1's stage is free
        if (it + 1 < n_it) stage_in(it + 1, st ^ 1);
        cp_async_commit();

        // S^T = K . Q^T and dP^T = V . dO^T, one group
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            s[i] = 0.f;
            dp[i] = 0.f;
        }
        fence_regs<32>(s);
        fence_regs<32>(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(s, T::desc(k_s + kk * 32), T::desc(q_t + kk * 32),
                     kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(dp, T::desc(v_s + kk * 32), T::desc(do_t + kk * 32),
                     kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);
        fence_regs<32>(dp);

        // P^T and dS^T (rows: keys, columns: query rows), rounded to bf16
        const bool full =
            qb + BQ <= Tq && k0 + BKV <= Tk &&
            (!causal || (k0 + BKV - 1 <= qb &&
                         (window <= 0 || k0 > qb + BQ - 1 - window)));
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
            const int c = 8 * i + 2 * t;
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = c + (e & 1);
                const float ls = lse_t[col];
                float pe = exp2f(fmaf(s[4 * i + e], scale_log2,
                                      -ls * LOG2E));
                if (!full) {
                    const int key = key0 + 8 * (e >> 1);
                    const int row = qb + col;
                    bool ok = row < Tq && key < Tk;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                    if (!ok) pe = 0.f;
                }
                p[e] = pe;
                ds[e] = pe * (dp[4 * i + e] - delta_t[col]) * scale;
            }
            pa[i >> 1][2 * (i & 1)] = pack_bf16(p[0], p[1]);
            pa[i >> 1][2 * (i & 1) + 1] = pack_bf16(p[2], p[3]);
            dsa[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
            dsa[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dV += P^T . dO and dK += dS^T . Q, one group
        fence_regs<C::ACC>(dv_acc);
        fence_regs<C::ACC>(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
            wgmma_rs<D>(dv_acc, pa[j],
                        T::desc(do_t + j * 16 * T::ROW_BYTES));
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
            wgmma_rs<D>(dk_acc, dsa[j],
                        T::desc(q_t + j * 16 * T::ROW_BYTES));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<C::ACC>(dv_acc);
        fence_regs<C::ACC>(dk_acc);
    }
    cp_async_wait_all();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int key = key0 + 8 * hf;
        if (key >= Tk) continue;
        const size_t off = ((size_t)b * Tk + key) * ldk + (size_t)kh * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const int c = 8 * i + 2 * t;
            *reinterpret_cast<uint32_t*>(dk + off + c) =
                pack_bf16(dk_acc[4 * i + 2 * hf], dk_acc[4 * i + 2 * hf + 1]);
            *reinterpret_cast<uint32_t*>(dv + off + c) =
                pack_bf16(dv_acc[4 * i + 2 * hf], dv_acc[4 * i + 2 * hf + 1]);
        }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int Tq, int Tk, int H, int Hk, float scale, int causal,
           int window, cudaStream_t stream) {
    // shared memory above 48 KB is opt-in (per device: set every call)
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Bwd<D>::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    dim3 grid((Tk + BKV - 1) / BKV, B * Hk);
    flash_bwd_dkv_tc<D><<<grid, THREADS, Bwd<D>::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H, Hk,
        scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, dout, dk and dv in (B, T, H or Hk, D) with 16-byte aligned
// bases; f32 lse and delta (B, H, Tq).  D is 16 or 64.  window: 0 = none.
// Returns the CUDA error code of the launch (0 on success); no
// synchronisation.
int vt_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int B,
                        int Tq, int Tk, int H, int Hk, int D, float scale,
                        int causal, int window, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * Hk > 65535 ||
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
          (uintptr_t)dk | (uintptr_t)dv) & 15u) != 0 ||
        (((uintptr_t)lse | (uintptr_t)delta) & 3u) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 64)
        return launch<64>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, Hk,
                          scale, causal, window, st);
    if (D == 16)
        return launch<16>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, Hk,
                          scale, causal, window, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
