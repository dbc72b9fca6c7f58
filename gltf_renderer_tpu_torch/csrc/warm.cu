// One-block warm-up: y = x + 1 over an (8, 128) f32 tile.
//
// Replaces the TPU kernel `_warm_pallas` in bench.py (a one-block Pallas
// `x + 1`). Its role is the same: the CUDA context, the library load and
// the first kernel launch all happen before any clock of a benchmark
// starts. Its plain PyTorch twin is `warm_ref` in ops/warm.py; an f32 add
// of 1 rounds the same on both, so the two agree bit for bit.
//
// What bounds it on an H100: launch latency. The tile is 4 KB in and 4 KB
// out, a few nanoseconds of HBM time; one thread per element is all the
// design there is.

#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = __fadd_rn(x[i], 1.0f);
}

}  // namespace

extern "C" int add_one_launch(const void* x, void* y, int n, void* stream) {
    if (n > 0) {
        const int threads = 1024;
        const int blocks = (n + threads - 1) / threads;
        add_one_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)x, (float*)y, n);
    }
    return (int)cudaGetLastError();
}
