// Fused dropout with an in-kernel counter-based mask, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Replaces the TPU kernel veles_tpu/ops/pallas_kernels.py `_dropout_apply`
// (pallas_call at :694, kernel body `_dropout_kernel` :643-665, custom_vjp
// `fused_dropout` :710-727).  Wrapper, autograd Function and plain PyTorch
// version: veles_tpu_torch/ops/kernels/fused_dropout.py.
//
// out[i] = x[i] * keep[i], where element i's mask bit is a hash of its
// index alone: bits = splitmix32(lin ^ splitmix32(seed)), lin the element's
// row-major index in the caller's logical layout taken mod 2^32 (the TPU
// kernel's row * n_cols + col), u = float(int32(bits >> 8)) * 2^-24, keep =
// 1 / (1 - rate) where u >= rate, else 0.  The product is taken in float32
// and rounded to the output type (round to nearest even).  All of it is
// integer-exact or one correctly rounded float32 operation, so the output
// equals the TPU kernel's bit for bit.  The backward pass is this same
// kernel run on the cotangent with the same seed: the mask is never stored.
//
// The seed is read from device memory, as the TPU kernel reads it from
// `seed_ref`: a 4-byte slot the train step's host part fills before each
// step (units/workflow.py `TrainStep.begin`), so a captured step (a CUDA
// graph) replays a new mask every step.  Every thread reads the slot
// (one cached 4-byte load) and whitens it with one splitmix32; forward
// and backward of one step read the same slot.
//
// The TPU kernel tiles (rows, cols) into VMEM blocks and pads to the
// (8, 128) tiling; here the tensor is one flat contiguous array, since the
// mask depends on the flat index only.
//
// What bounds it on this card: it moves bytes only (x read once, out
// written once; the hash is ~15 integer operations per element), so the
// bound is the memory rate, 3.35 TB/s.  At AlexNet's drop6/drop7 shape
// (512 x 4096 float32) that is 16.8 MB, ~0.005 ms.  Each thread moves 16
// bytes per load and store (4 float32 or 8 bf16/fp16 elements) in a
// grid-stride loop; a tensor whose base is not 16-byte aligned, and the
// ragged tail, go element by element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t splitmix32(uint32_t z) {
    z = z + 0x9E3779B9u;
    z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
    z = (z ^ (z >> 13)) * 0xC2B2AE35u;
    return z ^ (z >> 16);
}

__device__ __forceinline__ float keep_scale(uint32_t lin, uint32_t wseed,
                                            float rate, float scale) {
    uint32_t bits = splitmix32(lin ^ wseed);
    float u = __fmul_rn((float)(int32_t)(bits >> 8), 1.0f / 16777216.0f);
    return u >= rate ? scale : 0.0f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
    return __float2half_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
               const uint32_t* __restrict__ seed, float rate, float scale) {
    const uint32_t wseed = splitmix32(__ldg(seed));
    const long long stride = (long long)gridDim.x * THREADS * VEC;
    for (long long base =
             ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
         base < n; base += stride) {
        if (base + VEC <= n) {
            Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + base);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                float k = keep_scale((uint32_t)(base + j), wseed, rate,
                                     scale);
                p.v[j] = from_f<T>(__fmul_rn(to_f(p.v[j]), k));
            }
            *reinterpret_cast<Pack<T, VEC>*>(out + base) = p;
        } else {
            for (long long i = base; i < n; ++i) {
                float k = keep_scale((uint32_t)i, wseed, rate, scale);
                out[i] = from_f<T>(__fmul_rn(to_f(x[i]), k));
            }
        }
    }
}

template <typename T>
int launch(const void* x, void* out, long long n, const uint32_t* seed,
           float rate, float scale, int sms, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
    const int vec = aligned ? VEC : 1;
    long long want = (n + (long long)THREADS * vec - 1) / ((long long)THREADS * vec);
    long long cap = (long long)sms * 16;   // enough blocks to fill every SM
    int blocks = (int)(want < cap ? want : cap);
    if (blocks < 1) blocks = 1;
    const T* xp = static_cast<const T*>(x);
    T* op = static_cast<T*>(out);
    if (aligned)
        dropout_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
            xp, op, n, seed, rate, scale);
    else
        dropout_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(
            xp, op, n, seed, rate, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n contiguous elements of x -> out (same type; they may not overlap).
// dtype: 0 float32, 1 bfloat16, 2 float16.  seed: a device pointer to the
// uint32 seed (read by the kernel, not whitened: the kernel takes its
// splitmix32); rate the float32 drop rate, scale = 1.0f / (float)(1 -
// rate); sms the card's SM count (grid size).  Returns the CUDA error code
// of the launch (0 on success); no synchronisation.
int vt_fused_dropout(const void* x, void* out, long long n, int dtype,
                     const void* seed, float rate, float scale, int sms,
                     void* stream) {
    if (n < 1 || sms < 1 || seed == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* sp = static_cast<const uint32_t*>(seed);
    switch (dtype) {
        case 0: return launch<float>(x, out, n, sp, rate, scale, sms, st);
        case 1: return launch<__nv_bfloat16>(x, out, n, sp, rate, scale,
                                             sms, st);
        case 2: return launch<__half>(x, out, n, sp, rate, scale, sms,
                                      st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* vt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
