// Tensor-core building blocks for Hopper (sm_90a) shared by the flash
// kernels' bf16 instances (flash_fwd_tc.cu, flash_bwd_dq_tc.cu,
// flash_bwd_dkv_tc.cu): 16-byte cp.async copies into the swizzled
// shared-memory layout that wgmma reads, wgmma shared-memory descriptors,
// and the warpgroup products themselves as inline PTX.  No CUTLASS: the
// handful of instructions the kernels use are written out here, which
// keeps nvcc at seconds per source.  paged_attention.cu and tf32x3.cuh
// (the f32 backward) take the cp.async copies alone.
//
// Shared-memory tiles.  A tile holds rows of D bf16 (D = 64: 128 bytes;
// D = 16: 32 bytes), row r at r * 2D bytes, and its 16-byte chunks
// permuted within the row by the hardware swizzle of that row width:
// 128-byte swizzle (chunk c of row r at c ^ (r % 8)) for D = 64, 32-byte
// swizzle (c ^ ((r / 4) % 2)) for D = 16.  Tiles start on 1024-byte
// boundaries, so the address bits the swizzle reads are the row's own.
// One such [row][d] tile is read by wgmma two ways:
//   * K-major (rows are M or N, d is the reduction): Q.K^T, K.Q^T, V.dO^T;
//     a k16 step moves the start address 32 bytes along the row;
//   * N-major (rows are the reduction, d is N; imm-trans-b = 1): P.V,
//     P^T.dO, dS^T.Q; a k16 step moves it 16 rows.
// Either way the descriptor's stride between 8-row groups is 8 rows.
//
// Accumulator layout of wgmma m64nNk16 (f32): warp w of the warpgroup owns
// rows 16w..16w+15; lane = 4 g + t holds, for each 8-column block i,
// d[4i + 0, 1] = (row 16w + g, columns 8i + 2t, +1) and d[4i + 2, 3] = the
// same columns of row 16w + g + 8.  So a row lives in the 4 lanes of a
// quad, and the bf16 pairs (d[8j + 0, 1], d[8j + 2, 3], d[8j + 4, 5],
// d[8j + 6, 7]) are exactly wgmma's A-from-registers fragment for the k16
// block j of a following product: P never goes through shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace vt_tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the destination is zero-filled (nothing
// read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4-byte copy, zero-filled when !valid (lse and delta rows)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory (cp.async) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int D>
struct Tile {
    static_assert(D == 16 || D == 64, "head dim 16 or 64");
    static constexpr int ROW_BYTES = 2 * D;
    static constexpr int CHUNKS = D / 8;            // 16-byte chunks a row
    static constexpr uint32_t GROUP_BYTES = 8 * ROW_BYTES;
    static constexpr uint64_t MODE = D == 64 ? 1 : 3;   // 128B / 32B swizzle

    // byte offset of chunk c of row r within a tile
    static __device__ __forceinline__ uint32_t offset(int r, int c) {
        const int sw = D == 64 ? (r & 7) : ((r >> 2) & 1);
        return (uint32_t)(r * ROW_BYTES + ((c ^ sw) << 4));
    }

    // wgmma shared-memory descriptor of the tile at `addr`: start address,
    // both byte offsets = one 8-row group (the hardware reads the one its
    // major-ness uses), swizzle mode
    static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
        const uint64_t group = GROUP_BYTES >> 4;
        return (uint64_t)((addr & 0x3FFFF) >> 4) | (group << 16)
               | (group << 32) | (MODE << 62);
    }

    // copy `rows` rows of D from src (row stride ld elements) into the
    // tile at dst, zero-filling rows >= valid; nt threads, this one tid
    template <int ROWS, int NT>
    static __device__ __forceinline__ void load(uint32_t dst, const bf16* src,
                                                size_t ld, int valid,
                                                int tid) {
#pragma unroll
        for (int i = tid; i < ROWS * CHUNKS; i += NT) {
            const int r = i / CHUNKS;
            const int c = i - r * CHUNKS;
            const bool ok = r < valid;
            cp_async16(dst + offset(r, c),
                       src + (ok ? (size_t)r * ld + c * 8 : 0), ok);
        }
    }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // RNE
    return *reinterpret_cast<const uint32_t*>(&v);
}

// d(64 x 64) (+)= A(64 x 16) . B(64 x 16)^T, A and B in shared
// memory, both K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 16) += A(64 x 16) . B(16 x 16), A in registers (bf16
// pairs in the accumulator's layout), B in shared memory N-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 64) += A(64 x 16) . B(16 x 64), A in registers (bf16
// pairs in the accumulator's layout), B in shared memory N-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
    static_assert(N == 16 || N == 64, "N = 16 or 64");
    if constexpr (N == 16) wgmma_rs_n16(d, a, db);
    else wgmma_rs_n64(d, a, db);
}

}  // namespace vt_tc
