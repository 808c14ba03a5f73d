// Minibatch row gather for Hopper (sm_90a); plain C interface for ctypes.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py
// `gather_rows_packed` (pallas_call at :818, kernel body `_gather_kernel`
// :780-784): out[i] = data[idx[i]] for every minibatch index, from the
// dataset held on the card.  Wrapper and plain PyTorch version
// (torch.index_select): veles_tpu_torch/ops/kernels/gather_rows.py.
//
// The TPU kernel issues one HBM->HBM DMA per scalar-prefetched index, and
// needs the rows pre-packed into an (8, 128)-tiled layout
// (`pack_rows`/`unpack_rows`).  Hopper has no such tiling rule, so the
// rows are gathered as they lie and the packing has no counterpart: one
// block per index copies that row's bytes, its threads striding through
// the row in the widest unit (16, 8, 4, 2 or 1 bytes) that divides the
// row size and both base addresses, so an 8 KB token row moves as 512
// 16-byte loads and stores.  The index is read by the block itself (no
// scalar prefetch); the wrapper has checked every index against the row
// count on the host before the launch.
//
// What bounds it on this card: it moves bytes only (each gathered row is
// read once and written once), so the bound is the memory rate, 3.35 TB/s.
// At the training path's minibatch (16 rows of 8 KB) that is ~0.08 us:
// the launch itself costs far more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const V* __restrict__ data, const int* __restrict__ idx,
                   V* __restrict__ out, long long units) {
    const V* src = data + (size_t)idx[blockIdx.x] * units;
    V* dst = out + (size_t)blockIdx.x * units;
    for (long long i = threadIdx.x; i < units; i += THREADS) dst[i] = src[i];
}

template <typename V>
void launch(const void* data, const void* idx, void* out, int m,
            long long row_bytes, cudaStream_t stream) {
    gather_rows_kernel<V><<<m, THREADS, 0, stream>>>(
        static_cast<const V*>(data), static_cast<const int*>(idx),
        static_cast<V*>(out), row_bytes / (long long)sizeof(V));
}

}  // namespace

extern "C" {

// m rows of row_bytes each; idx is int32 on the card, every entry already
// in [0, rows).  unit: the copy width in bytes (16, 8, 4, 2 or 1), which
// must divide row_bytes and both base addresses.  Returns the CUDA error
// code of the launch (0 on success); no synchronisation.
int vt_gather_rows(const void* data, const void* idx, void* out, int m,
                   long long row_bytes, int unit, void* stream) {
    if (m < 1 || row_bytes < 1 || unit < 1 || row_bytes % unit != 0 ||
        (uintptr_t)data % unit != 0 || (uintptr_t)out % unit != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (unit == 16) launch<uint4>(data, idx, out, m, row_bytes, st);
    else if (unit == 8) launch<uint2>(data, idx, out, m, row_bytes, st);
    else if (unit == 4) launch<uint32_t>(data, idx, out, m, row_bytes, st);
    else if (unit == 2) launch<uint16_t>(data, idx, out, m, row_bytes, st);
    else if (unit == 1) launch<uint8_t>(data, idx, out, m, row_bytes, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
