// Flash-attention backward, dQ, bf16, on Hopper's tensor cores (sm_90a,
// wgmma); plain C interface for ctypes.  The float32 instances are
// flash_bwd_dq_tf32x3.cu's (mma.sync, 3xTF32).
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_flash_bwd`'s
// dQ pallas_call (:384, kernel body `_flash_bwd_dq_kernel` :269-309) for
// bf16 inputs.  Wrapper and plain PyTorch version: veles_tpu_torch/ops/
// kernels/flash_bwd_dq.py, which sends every bf16 call at head dim 16 or
// 64 here and nowhere else.
//
// Computes what the TPU kernel computes, per (batch b, q head h, query row
// i), by recompute from the forward's row logsumexp:
//   p_ij  = mask ? exp(q_i . k_j * scale - lse_i) : 0
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   dq_i  = sum_j bf16(ds_ij) k_j
// over the keys j < Tk (causal: j <= i; window W: j > i - W) of kv head
// kh = h / (H / Hk) (GQA, read in place).  dS is rounded to bf16 before
// dS.K (the TPU kernel's ds.astype(k_blk.dtype), :297); masked P is 0 by
// the mask, not by underflow, so a row with no live key (lse = -1e30)
// writes 0; the accumulator is f32 and dq is written bf16.
//
// What bounds it on this card: three products of 2 * B * H * D * T(T+1)/2
// operations at the training shape (B=16, T=2048, H=8, D=64, causal),
// ~103 GFLOP against ~10 MB of traffic: the bf16 tensor-core rate (989
// TFLOP/s), 0.104 ms.  The f32-FMA SIMT kernel took 6.5 ms for it (H100,
// 700 W).
//
// Design: the mirror of flash_bwd_dkv_tc.cu with query rows as M.  One
// block per (tile of 64 query rows, b*h), one warpgroup, three blocks an
// SM, q tiles issued heaviest (latest) first.  The tile's Q and dO stay in
// shared memory for the block's life; each thread reads the lse and delta
// of its two rows once, into registers.  K/V tiles of 64 keys stream in by
// cp.async through a 2-stage ring in the swizzled layout (hopper_tc.cuh),
// tile n+1's copy in flight while tile n is computed.  Per K/V tile:
//   S  = Q . K^T    (A = Q, B = the K tile K-major)      m64n64k16 x D/16
//   dP = dO . V^T   (A = dO, B = the V tile K-major)     m64n64k16 x D/16
//   dQ += dS . K    (A = bf16 dS from registers, B = the same K tile read
//                    N-major)                            m64nDk16 x 4
// with P and dS made on the f32 fragments in registers between them (base
// 2, scores prescaled by scale * log2 e): the accumulator fragment is the
// next product's A fragment, so dS never goes through shared memory.
// Tiles wholly past the causal diagonal, or wholly before the window, are
// never loaded (`_flash_block_live`); the mask runs only on tiles the
// diagonal, the window edge, Tq or Tk cut.  No float atomics: a block owns
// its rows and sums keys in one order, so two runs give the same bits.

#include "hopper_tc.cuh"

namespace {

using namespace vt_tc;

constexpr int BQ = 64;         // query rows a block (one warpgroup)
constexpr int BKV = 64;        // keys a streamed K/V tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Dq {
    using T = Tile<D>;
    static constexpr int Q_BYTES = BQ * T::ROW_BYTES;
    static constexpr int KV_BYTES = BKV * T::ROW_BYTES;
    static constexpr int STAGE_BYTES = 2 * KV_BYTES;        // K then V
    static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGE_BYTES + 1024;
    static constexpr int ACC = D / 2;       // dQ fragment per thread
};

template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int Tq, int Tk, int H, int Hk, float scale, int causal,
                int window) {
    using C = Dq<D>;
    using T = typename C::T;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t do_s = q_s + C::Q_BYTES;
    const uint32_t ring = do_s + C::Q_BYTES;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kh = h / (H / Hk);
    // this thread's two rows: r0 and r0 + 8
    const int r0 = q0 + warp * 16 + g;

    // keys any row of this block can see (whole-tile skipping)
    int k_end = Tk;
    int k_begin = 0;
    if (causal) {
        k_end = min(Tk, q0 + BQ);
        if (window > 0) {
            k_begin = max(0, q0 - window + 1);
            k_begin -= k_begin % BKV;
        }
    }
    const int n_tiles = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV
                                        : 0;

    const size_t ldq = (size_t)H * D;
    const size_t ldk = (size_t)Hk * D;
    const size_t q_off = ((size_t)b * Tq + q0) * ldq + (size_t)h * D;
    const bf16* kp = k + (size_t)b * Tk * ldk + (size_t)kh * D;
    const bf16* vp = v + (size_t)b * Tk * ldk + (size_t)kh * D;

    T::template load<BQ, THREADS>(q_s, q + q_off, ldq, Tq - q0, tid);
    T::template load<BQ, THREADS>(do_s, dout + q_off, ldq, Tq - q0, tid);
    // stage K/V tile `it` into ring stage `st`
    auto stage_in = [&](int it, int st) {
        const int kb = k_begin + it * BKV;
        const uint32_t dst = ring + st * C::STAGE_BYTES;
        T::template load<BKV, THREADS>(dst, kp + (size_t)kb * ldk, ldk,
                                       Tk - kb, tid);
        T::template load<BKV, THREADS>(dst + C::KV_BYTES,
                                       vp + (size_t)kb * ldk, ldk, Tk - kb,
                                       tid);
    };
    if (n_tiles > 0) stage_in(0, 0);
    cp_async_commit();

    // the rows' lse (base 2) and delta, once
    float lse2[2], dlt[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        const bool ok = row < Tq;
        lse2[hf] = ok ? lse[(size_t)bh * Tq + row] * LOG2E : 0.f;
        dlt[hf] = ok ? delta[(size_t)bh * Tq + row] : 0.f;
    }

    float dq_acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) dq_acc[i] = 0.f;
    const float scale_log2 = scale * LOG2E;

    for (int it = 0; it < n_tiles; ++it) {
        const int kb = k_begin + it * BKV;
        const uint32_t k_t = ring + (it & 1) * C::STAGE_BYTES;
        const uint32_t v_t = k_t + C::KV_BYTES;
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();       // tile it landed; tile it-1's stage is free
        if (it + 1 < n_tiles) stage_in(it + 1, (it + 1) & 1);
        cp_async_commit();

        // S = Q . K^T and dP = dO . V^T, one group
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
            wgmma_ss(s, T::desc(q_s + kk * 32), T::desc(k_t + kk * 32),
                     kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(dp, T::desc(do_s + kk * 32), T::desc(v_t + kk * 32),
                     kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);
        fence_regs<32>(dp);

        // dS (rows: query rows, columns: keys), rounded to bf16
        const bool full =
            q0 + BQ <= Tq && kb + BKV <= Tk &&
            (!causal || (kb + BKV - 1 <= q0 &&
                         (window <= 0 || kb > q0 + BQ - 1 - window)));
        uint32_t dsa[BKV / 16][4];
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i) {
            const int c = 8 * i + 2 * t;
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hf = e >> 1;
                float pe = exp2f(fmaf(s[4 * i + e], scale_log2, -lse2[hf]));
                if (!full) {
                    const int key = kb + c + (e & 1);
                    const int row = r0 + 8 * hf;
                    bool ok = row < Tq && key < Tk;
                    if (causal) {
                        ok = ok && key <= row;
                        if (window > 0) ok = ok && key > row - window;
                    }
                    if (!ok) pe = 0.f;
                }
                ds[e] = pe * (dp[4 * i + e] - dlt[hf]) * scale;
            }
            dsa[i >> 1][2 * (i & 1)] = pack_bf16(ds[0], ds[1]);
            dsa[i >> 1][2 * (i & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS . K
        fence_regs<C::ACC>(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j)
            wgmma_rs<D>(dq_acc, dsa[j],
                        T::desc(k_t + j * 16 * T::ROW_BYTES));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<C::ACC>(dq_acc);
    }
    cp_async_wait_all();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        if (row >= Tq) continue;
        const size_t off = ((size_t)b * Tq + row) * ldq + (size_t)h * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const int c = 8 * i + 2 * t;
            *reinterpret_cast<uint32_t*>(dq + off + c) =
                pack_bf16(dq_acc[4 * i + 2 * hf], dq_acc[4 * i + 2 * hf + 1]);
        }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Tq,
           int Tk, int H, int Hk, float scale, int causal, int window,
           cudaStream_t stream) {
    // shared memory above 48 KB is opt-in (per device: set every call)
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Dq<D>::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    dim3 grid((Tq + BQ - 1) / BQ, B * H);
    flash_bwd_dq_tc<D><<<grid, THREADS, Dq<D>::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), Tq, Tk, H, Hk, scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, dout and dq in (B, T, H or Hk, D) with 16-byte aligned
// bases; f32 lse and delta (B, H, Tq).  D is 16 or 64.  window: 0 = none.
// Returns the CUDA error code of the launch (0 on success); no
// synchronisation.
int vt_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int Tq, int Tk, int H, int Hk, int D,
                       float scale, int causal, int window, void* stream) {
    if (B < 1 || Tq < 1 || Tk < 1 || Hk < 1 || H % Hk != 0 ||
        B * H > 65535 ||
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
          (uintptr_t)dq) & 15u) != 0 ||
        (((uintptr_t)lse | (uintptr_t)delta) & 3u) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 64)
        return launch<64>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hk,
                          scale, causal, window, st);
    if (D == 16)
        return launch<16>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, H, Hk,
                          scale, causal, window, st);
    return (int)cudaErrorInvalidValue;
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
