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
//
// So the loaders take `vt_gather_batch`, which gathers a whole minibatch
// of every array of a class in one launch, as the reference loader gathers
// a class's whole tree in one jitted call (veles_tpu/loader/fullbatch.py
// :149-171).  Its grid is (rows x arrays): block (i, j) copies row
// perm[offset + i] of array j in that array's own widest copy unit, and
// block (i, 0) also writes mask[i] = 1.0 for a real row (i < count) and
// 0.0 for padding.  The indices stay on the card: perm is the epoch's
// permutation, uploaded once an epoch, padded with index 0 to a multiple
// of the minibatch and checked against the row count on the host before
// that upload; a batch is (offset, count), passed by value.  So a batch
// costs one launch and no host-to-device copy, and the launch can go onto
// the stream right before a captured train step replays.

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

// One array of a batch gather: its rows, where they go, the row size and
// the copy unit (16, 8, 4, 2 or 1 bytes) that divides the row size and
// both base addresses.
constexpr int MAX_ARRAYS = 8;
struct BatchArrays {
    const char* src[MAX_ARRAYS];
    char* dst[MAX_ARRAYS];
    long long row_bytes[MAX_ARRAYS];
    int unit[MAX_ARRAYS];
};

template <typename V>
__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         long long row_bytes) {
    const V* s = reinterpret_cast<const V*>(src);
    V* d = reinterpret_cast<V*>(dst);
    const long long units = row_bytes / (long long)sizeof(V);
    for (long long i = threadIdx.x; i < units; i += THREADS) d[i] = s[i];
}

__global__ void __launch_bounds__(THREADS)
gather_batch_kernel(BatchArrays a, const int* __restrict__ perm, int offset,
                    int count, float* __restrict__ mask) {
    const int i = blockIdx.x, j = blockIdx.y;
    const long long rb = a.row_bytes[j];
    const char* src = a.src[j] + (size_t)perm[offset + i] * rb;
    char* dst = a.dst[j] + (size_t)i * rb;
    if (j == 0 && threadIdx.x == 0 && mask != nullptr)
        mask[i] = i < count ? 1.0f : 0.0f;
    switch (a.unit[j]) {
        case 16: copy_row<uint4>(src, dst, rb); break;
        case 8: copy_row<uint2>(src, dst, rb); break;
        case 4: copy_row<uint32_t>(src, dst, rb); break;
        case 2: copy_row<uint16_t>(src, dst, rb); break;
        default: copy_row<uint8_t>(src, dst, rb); break;
    }
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

// One minibatch of n arrays (n in [1, 8]) in one launch: for every row
// i < m and array j, dst[j] row i = src[j] row perm[offset + i]; with a
// non-null mask (float32, m entries) mask[i] = i < count.  src/dst are
// device addresses, row_bytes and unit per array as for vt_gather_rows;
// perm is int32 on the card with at least offset + m entries, each already
// checked against its arrays' row count.  Returns the CUDA error code of
// the launch; no synchronisation.
int vt_gather_batch(int n, const void* const* src, void* const* dst,
                    const long long* row_bytes, const int* unit,
                    const void* perm, int offset, int m, int count,
                    void* mask, void* stream) {
    if (n < 1 || n > MAX_ARRAYS || m < 1 || offset < 0 || count < 0 ||
        count > m)
        return (int)cudaErrorInvalidValue;
    BatchArrays a = {};
    for (int j = 0; j < n; ++j) {
        const int u = unit[j];
        if (row_bytes[j] < 1 || (u != 1 && u != 2 && u != 4 && u != 8 &&
                                 u != 16) ||
            row_bytes[j] % u != 0 || (uintptr_t)src[j] % u != 0 ||
            (uintptr_t)dst[j] % u != 0)
            return (int)cudaErrorInvalidValue;
        a.src[j] = static_cast<const char*>(src[j]);
        a.dst[j] = static_cast<char*>(dst[j]);
        a.row_bytes[j] = row_bytes[j];
        a.unit[j] = u;
    }
    gather_batch_kernel<<<dim3(m, n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const int*>(perm), offset, count,
        static_cast<float*>(mask));
    return (int)cudaGetLastError();
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
