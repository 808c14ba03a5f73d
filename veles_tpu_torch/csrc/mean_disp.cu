// Mean/dispersion normalize for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py
// `mean_disp_normalize` (pallas_call at :760, kernel body
// `_mean_disp_kernel` :734-736): out[r, f] = (float(x[r, f]) - mean[f]) *
// rdisp[f] over rows r (samples) and features f (the flattened sample
// shape), x uint8 or float32, mean/rdisp/out float32.  Wrapper and plain
// PyTorch version: veles_tpu_torch/ops/kernels/mean_disp.py.  The
// subtraction and the product are written as __fsub_rn / __fmul_rn, so the
// compiler neither contracts them into an FMA nor reorders them, and each
// result equals the TPU kernel's (and XLA's) bit for bit: uint8 -> float is
// exact, and each step is one correctly rounded float32 operation.
//
// The TPU kernel widens uint8 to int32 outside the kernel (Mosaic has no
// unsigned -> float cast) and pads rows and columns to its block tiling;
// here the kernel reads the bytes as they lie and masks the ragged edge.
// A 2-D grid over (feature block, row) gives every thread its feature
// index without a modulo by the feature count; each thread handles
// ELEMS features of one row, THREADS apart, so a warp's loads and stores
// stay on neighbouring addresses.  Rows past the grid's y extent
// (65535) are walked by a loop.
//
// What bounds it on this card: bytes (each input element read once, each
// float32 output written once, mean and rdisp read once from device memory
// and then from L2).  At AlexNet's norm0 shape (512 x 227 x 227 x 3 uint8)
// that is 79.1 MB in, 316.6 MB out and 1.2 MB of statistics: ~0.1185 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ELEMS = 4;
constexpr int MAX_GRID_Y = 65535;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mean_disp_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rdisp, float* __restrict__ out,
                 long long rows, long long features) {
    const long long f0 = (long long)blockIdx.x * THREADS * ELEMS + threadIdx.x;
    for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
        const T* xr = x + r * features;
        float* orow = out + r * features;
#pragma unroll
        for (int j = 0; j < ELEMS; ++j) {
            const long long f = f0 + (long long)j * THREADS;
            if (f < features)
                orow[f] = __fmul_rn(__fsub_rn((float)xr[f], mean[f]),
                                    rdisp[f]);
        }
    }
}

template <typename T>
int launch(const void* x, const void* mean, const void* rdisp, void* out,
           long long rows, long long features, cudaStream_t stream) {
    const long long per_block = (long long)THREADS * ELEMS;
    dim3 grid((unsigned)((features + per_block - 1) / per_block),
              (unsigned)(rows < MAX_GRID_Y ? rows : MAX_GRID_Y));
    mean_disp_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rdisp), static_cast<float*>(out), rows,
        features);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: rows x features contiguous, dtype 0 uint8 or 1 float32; mean, rdisp:
// features float32; out: rows x features float32.  Returns the CUDA error
// code of the launch (0 on success); no synchronisation.
int vt_mean_disp(const void* x, const void* mean, const void* rdisp,
                 void* out, long long rows, long long features, int dtype,
                 void* stream) {
    if (rows < 1 || features < 1 ||
        (features + (long long)THREADS * ELEMS - 1) / ((long long)THREADS * ELEMS)
            > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(x, mean, rdisp, out, rows, features,
                                       st);
        case 1: return launch<float>(x, mean, rdisp, out, rows, features, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
