// Per-lane row fetch: a chain of dependent table reads, one chain per lane.
//
// Replaces the two TPU kernels of tools/bench_perlane.py, which size the
// per-lane row fetch a traversal step needs, and computes what they
// compute:
//
// - `onehot_fetch` (TPU `make_onehot_kernel`): ids (16, 128) i32, table
//   (n, c) bf16. Per lane and step i: s = the sum of the lane's row's
//   first 8 columns (left to right, from 0), acc += s,
//   id = (id + int(s) + i) mod n. Out: acc, (16, 128) f32.
// - `shuffle_fetch` (TPU `make_shuffle_kernel`): ids (1, 128) i32, table
//   as G = ceil(n / 128) groups of (c, 128) f32. Per lane and step i:
//   fetched[k] = table[(id / 128) * c + k, id % 128] for k < c,
//   acc[k] += fetched[k], id = (id + int(fetched[0]) + i) mod n. Out: acc,
//   (c, 128) f32.
//
// int() truncates toward zero and mod is the floor modulo, as the JAX
// kernels' astype(int32) and %. An id outside the table fetches zeros, as
// the one-hot row and the group select do there. Every sum is taken in the
// JAX kernels' order with each add rounded on its own (__fadd_rn), and a
// bf16 -> f32 fetch is exact, so the plain PyTorch twins in ops/perlane.py
// and the JAX kernels agree with these bit for bit.
//
// What bounds them on an H100: the chain of `steps` dependent loads, not
// bytes and not operations. Each load is a trip to L2 (the tables, 0.2-2.9
// MB, stay there), or to L1 where the SM fetched its line before; the
// tools' latency floor counts the most such L1 hits the chains allow.
// The bytes that acc actually needs are small: onehot reads 8 bf16 of one
// row per lane per step (2048 x 16 B = 32 KB a step), shuffle reads c f32
// of one column per lane per step (c x 128 x 4 B, 56-80 KB a step). On the
// TPU the one-hot product and the group scan read the whole table every
// step. So the design is one thread per chain: onehot one thread per lane;
// shuffle one thread per (column k, lane), each re-walking its lane's id
// chain from column 0 so that no thread waits on another.

#include <cuda_runtime.h>
#include <stdint.h>

#define SHUFFLE_LANES 128

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
    return __uint_as_float(((uint32_t)h) << 16);
}

__device__ __forceinline__ int floor_mod(int x, int n) {
    const int m = x % n;
    return m < 0 ? m + n : m;
}

__global__ void onehot_fetch_kernel(const int* __restrict__ ids,
                                    const uint16_t* __restrict__ table, int n_rows,
                                    int n_cols, int steps, int n_lanes,
                                    float* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n_lanes) return;
    int id = ids[lane];
    float acc = 0.0f;
    for (int i = 0; i < steps; ++i) {
        float s = 0.0f;
        if (id >= 0 && id < n_rows) {
            const uint16_t* row = table + (size_t)id * n_cols;
#pragma unroll
            for (int k = 0; k < 8; ++k) s = __fadd_rn(s, bf16_to_f32(row[k]));
        }
        acc = __fadd_rn(acc, s);
        id = floor_mod(id + (int)s + i, n_rows);
    }
    out[lane] = acc;
}

__global__ void shuffle_fetch_kernel(const int* __restrict__ ids,
                                     const float* __restrict__ table, int n_rows,
                                     int n_cols, int groups, int steps,
                                     float* __restrict__ out) {
    const int lane = threadIdx.x;  // blockDim.x == SHUFFLE_LANES
    const int k = blockIdx.x;      // column, < n_cols
    int id = ids[lane];
    float acc = 0.0f;
    for (int i = 0; i < steps; ++i) {
        const int grp = id >= 0 ? id / SHUFFLE_LANES : -1;
        float f0 = 0.0f;
        float fk = 0.0f;
        if (grp < groups && grp >= 0) {
            const float* col = table + (size_t)grp * n_cols * SHUFFLE_LANES + id % SHUFFLE_LANES;
            f0 = col[0];
            fk = col[(size_t)k * SHUFFLE_LANES];
        }
        acc = __fadd_rn(acc, fk);
        id = floor_mod(id + (int)f0 + i, n_rows);
    }
    out[(size_t)k * SHUFFLE_LANES + lane] = acc;
}

// The yardstick for both kernels' latency floor: the latency of one load
// that hits L1 (via_l1: ld.global.ca over a chain inside L1) or L2 (else:
// ld.global.cg, which bypasses L1, over a chain larger than L1 and inside
// L2) on this card. One thread follows `steps` links of a chain of indices:
// once to bring the lines into the cache, then again from the start
// between two reads of the global timer. Writes the timed pass's
// nanoseconds and both passes' last index (so neither is optimised away).
__global__ void chase_latency_kernel(const int* __restrict__ chain, int steps, int via_l1,
                                     long long* __restrict__ ns, int* __restrict__ sink) {
    int warm = 0;
    for (int i = 0; i < steps; ++i) warm = via_l1 ? __ldca(chain + warm) : __ldcg(chain + warm);
    long long t0, t1;
    int idx = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) :: "memory");
    if (via_l1) {
        for (int i = 0; i < steps; ++i) idx = __ldca(chain + idx);
    } else {
        for (int i = 0; i < steps; ++i) idx = __ldcg(chain + idx);
    }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) :: "memory");
    ns[0] = t1 - t0;
    sink[0] = warm;
    sink[1] = idx;
}

}  // namespace

extern "C" int chase_latency_launch(const void* chain, int steps, int via_l1, void* ns,
                                    void* sink, void* stream) {
    if (steps <= 0) return (int)cudaErrorInvalidValue;
    chase_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)chain, steps, via_l1,
                                                            (long long*)ns, (int*)sink);
    return (int)cudaGetLastError();
}

extern "C" int onehot_fetch_launch(const void* ids, const void* table, int n_rows, int n_cols,
                                   int steps, int n_lanes, void* out, void* stream) {
    if (n_rows <= 0 || n_cols < 8) return (int)cudaErrorInvalidValue;
    if (n_lanes > 0) {
        const int threads = 128;
        onehot_fetch_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
            (const int*)ids, (const uint16_t*)table, n_rows, n_cols, steps, n_lanes,
            (float*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" int shuffle_fetch_launch(const void* ids, const void* table, int n_rows,
                                    int n_cols, int groups, int steps, void* out,
                                    void* stream) {
    if (n_rows <= 0 || n_cols <= 0 || groups <= 0) return (int)cudaErrorInvalidValue;
    shuffle_fetch_kernel<<<n_cols, SHUFFLE_LANES, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const float*)table, n_rows, n_cols, groups, steps, (float*)out);
    return (int)cudaGetLastError();
}
