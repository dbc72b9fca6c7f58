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
// int() truncates toward zero, saturates to int32 and takes NaN to 0, the
// sum wraps as int32, and mod is the floor modulo, as the JAX kernels'
// astype(int32), + and %. An id outside the table fetches zeros, as
// the one-hot row and the group select do there. Every sum is taken in the
// JAX kernels' order with each add rounded on its own (__fadd_rn), and a
// bf16 -> f32 fetch is exact, so the plain PyTorch twins in ops/perlane.py
// and the JAX kernels agree with these bit for bit.
//
// What bounds them on an H100: the chain of `steps` dependent loads, not
// bytes and not operations. The tables (0.2-2.9 MB) stay in L2 between
// calls. The onehot kernel is one thread a lane reading 8 bf16 of one row a
// step, each load an L2 or L1 hit.
//
// The shuffle kernel is one block of 128 lanes a column. It first walked its
// lanes' chains through the table in place: 185 ns a step on an H100 (the
// steps sweep of `python -m gltf_renderer_tpu_torch.tools.bench_perlane
// --study`), against a floor of 26 ns. Within 32 steps the chains visit
// nearly every 128-byte line of a column, so the early steps missed L1 (an
// L2 round trip on the chain), and 24 dependent instructions ran from one
// load to the next: the F2I, a signed modulo by a run-time n, the signed /
// and % by 128 and a 64-bit address. Now the block first copies column 0
// and its own column into shared memory (cp.async; about what the chains
// would pull from L2 anyway), laid out by id, and carries each lane's id
// as the byte offset 4 id: a step is LDS, FADD.RZ, two multiply-adds side
// by side, an unsigned min of three and the next LDS at that offset
// (fast_next_off), about 28 ns a step on an H100. Two or more columns a
// block lost at every shape the tool times (the copy runs at the L2's
// rate), and a table too large to stage (two columns over 227 KB) or not
// 16-byte aligned is read in place by the same code.

#include <cuda_runtime.h>
#include <stdint.h>

#define SHUFFLE_LANES 128
#define SHUFFLE_SMEM_MAX 232448  // bytes of shared memory a block can use on an H100

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
        id = floor_mod((int)((unsigned)id + (unsigned)__float2int_rz(s) + (unsigned)i), n_rows);
    }
    out[lane] = acc;
}

// int() is __float2int_rz (cvt.rzi), which saturates and maps NaN to 0 as
// XLA's convert does; the sum wraps as the JAX kernels' int32 sum does.
__device__ __forceinline__ int exact_next_id(int id, float f0, int i, int n) {
    return floor_mod((int)((unsigned)id + (unsigned)__float2int_rz(f0) + (unsigned)i), n);
}

// The shuffle kernel's common step, after step 0 (id in [0, n)), on the
// byte offset o = 4 id: for f0 in [0, 2^23), f0 + 2^23 rounded toward zero
// is 2^23 + int(f0), so its bits are F2I_BIAS + int(f0) (an FADD in place
// of the slower F2I); and for x = id + int(f0) + i in [0, bound) (bound =
// 2n, n < 2^29) the next offset 4 floor_mod(x, n) is the unsigned min of
// 4x and 4x - 4n (which wraps above 4x when x < n). Each of the two is one
// multiply-add of the FADD's bits by 4 onto a constant that is ready
// before the load returns, so the chain from load to load is FADD, the two
// adds side by side, one min of three and the next load's address. `rare`
// records a step outside both ranges (bound = 0 makes every step rare);
// the offset is then clamped into the table so that the next fetch stays
// there, and the caller walks the lane again with exact_next_id. No
// branch and no division on the chain.
#define F2I_BIAS 0x4B000000u  // the bits of 2^23

template <bool B>
struct Exact {
    static constexpr bool value = B;
};

__device__ __forceinline__ unsigned fast_next_off(unsigned o, float f0, int i, unsigned n,
                                                  unsigned bound, bool& rare) {
    const unsigned c = o + 4u * ((unsigned)i - F2I_BIAS);
    const unsigned c_less_n = c - 4u * n;
    const unsigned bits = __float_as_uint(__fadd_rz(f0, 8388608.0f));
    unsigned x4, xn4;  // 4x and 4x - 4n; PTX keeps nvcc from chaining the second on the first
    asm("mad.lo.u32 %0, %1, 4, %2;" : "=r"(x4) : "r"(bits), "r"(c));
    asm("mad.lo.u32 %0, %1, 4, %2;" : "=r"(xn4) : "r"(bits), "r"(c_less_n));
    const unsigned x = (o >> 2) + bits + ((unsigned)i - F2I_BIAS);
    rare |= (__float_as_uint(f0) >= F2I_BIAS) | (x >= bound);
    return min(min(x4, xn4), 4u * (n - 1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(s), "l"(gmem) : "memory");
}

// Thread = lane (blockDim.x == SHUFFLE_LANES); block = column k. STAGED:
// the block first copies column 0 and column k whole into shared memory
// (cp.async, 16 B a thread at a time), laid out by id, s[0][id] and
// s[1][id]; a step is then one LDS of f0 at byte offset 4 id,
// fast_next_off and the next LDS. Else every fetch reads the table in
// place.
template <bool STAGED>
__global__ void shuffle_fetch_kernel(const int* __restrict__ ids,
                                     const float* __restrict__ table, int n_rows,
                                     int n_cols, int groups, int steps, unsigned bound,
                                     float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const int lane = threadIdx.x;
    const int k = blockIdx.x;
    const size_t stride = (size_t)n_cols * SHUFFLE_LANES;  // floats a group
    const unsigned slots = (unsigned)groups * SHUFFLE_LANES;  // ids with a column
    const int id0 = ids[lane];
    if constexpr (STAGED) {
        constexpr int QUADS = SHUFFLE_LANES / 4;  // 16-byte pieces of a group's column
        for (int j = 0; j < 2; ++j) {
            for (int q = lane; q < groups * QUADS; q += SHUFFLE_LANES) {
                const int g = q / QUADS, r = (q % QUADS) * 4;
                cp_async16(s + (size_t)j * slots + g * SHUFFLE_LANES + r,
                           table + g * stride + (size_t)(j * k) * SHUFFLE_LANES + r);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
    }
    // Column 0 (j = 0) or column k (j = 1) at byte offset o = 4 id, an id
    // inside the table.
    auto fetch = [&](int j, unsigned o) -> float {
        if constexpr (STAGED)
            return *reinterpret_cast<const float*>(
                reinterpret_cast<const char*>(s + j * slots) + o);
        const unsigned at = o >> 2;
        return __ldg(table + (at >> 7) * stride + (size_t)(j * k) * SHUFFLE_LANES + (at & 127));
    };
    // The lane's chain, summed: step 0, the only one whose id may lie
    // outside the table (fetching zeros), exactly; the rest by
    // fast_next_off, or exactly. Sets `rare` when a fast step was.
    auto walk = [&](auto exact_tag, bool& rare) -> float {
        constexpr bool exact = decltype(exact_tag)::value;
        if (steps <= 0) return 0.0f;
        const bool valid = (unsigned)id0 < slots;
        const unsigned o0 = 4u * (unsigned)id0;
        const float f0 = valid ? fetch(0, o0) : 0.0f;
        float acc = __fadd_rn(0.0f, valid ? fetch(1, o0) : 0.0f);
        unsigned o = 4u * (unsigned)exact_next_id(id0, f0, 0, n_rows);
#pragma unroll 4
        for (int i = 1; i < steps; ++i) {
            const float f = fetch(0, o);
            acc = __fadd_rn(acc, fetch(1, o));
            if constexpr (exact) o = 4u * (unsigned)exact_next_id((int)(o >> 2), f, i, n_rows);
            else o = fast_next_off(o, f, i, (unsigned)n_rows, bound, rare);
        }
        return acc;
    };
    bool rare = false;
    float acc = walk(Exact<false>{}, rare);
    if (rare) acc = walk(Exact<true>{}, rare);
    out[(size_t)k * SHUFFLE_LANES + lane] = acc;
}

// The yardstick for both kernels' latency floor: the latency of one
// dependent load that hits L2 (level 0: ld.global.cg, which bypasses L1,
// over a chain larger than L1 and inside L2), L1 (level 1: ld.global.ca
// over a chain inside L1) or shared memory (level 2: the chain copied into
// it first). `lanes` threads of one warp follow the same cycle of `steps`
// links from evenly spaced starts: once to bring the lines into the
// cache, then again between two reads of the global timer. One lane pays a
// load's latency; 32 lanes at scattered shared-memory words also pay
// their bank conflicts, as the shuffle kernel's lanes do. Writes the timed
// pass's nanoseconds and the last indices (so neither pass is optimised
// away).
template <int LEVEL>
__global__ void chase_latency_kernel(const int* __restrict__ chain, int n_chain, int steps,
                                     long long* __restrict__ ns, int* __restrict__ sink) {
    extern __shared__ int s_chain[];
    const int lane = threadIdx.x;
    if constexpr (LEVEL == 2) {
        for (int j = lane; j < n_chain; j += blockDim.x) s_chain[j] = chain[j];
        __syncwarp();
    }
    auto next = [&](int at) -> int {
        if constexpr (LEVEL == 2) return s_chain[at];
        else if constexpr (LEVEL == 1) return __ldca(chain + at);
        else return __ldcg(chain + at);
    };
    const int start = (lane * (n_chain / (int)blockDim.x)) & ~31;
    int warm = start;
    for (int i = 0; i < steps; ++i) warm = next(warm);
    long long t0, t1;
    int idx = start;
    __syncwarp();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) :: "memory");
    for (int i = 0; i < steps; ++i) idx = next(idx);
    __syncwarp();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) :: "memory");
    if (lane == 0) ns[0] = t1 - t0;
    sink[2 * lane] = warm;
    sink[2 * lane + 1] = idx;
}

}  // namespace

// chain: n_chain ints holding one cycle (every entry on it at a multiple
// of 32 ints, or every int for level 2); sink: 2 x lanes ints.
extern "C" int chase_latency_launch(const void* chain, int n_chain, int steps, int level,
                                    int lanes, void* ns, void* sink, void* stream) {
    if (steps <= 0 || lanes < 1 || lanes > 32 || level < 0 || level > 2 ||
        (level == 2 && n_chain * sizeof(int) > 48 * 1024))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int* c = (const int*)chain;
    if (level == 2)
        chase_latency_kernel<2><<<1, lanes, n_chain * sizeof(int), st>>>(
            c, n_chain, steps, (long long*)ns, (int*)sink);
    else if (level == 1)
        chase_latency_kernel<1><<<1, lanes, 0, st>>>(c, n_chain, steps, (long long*)ns, (int*)sink);
    else
        chase_latency_kernel<0><<<1, lanes, 0, st>>>(c, n_chain, steps, (long long*)ns, (int*)sink);
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

// One block of 128 lanes a column. The block stages its two columns
// (2 groups x 128 f32) in shared memory where they fit a block's and the
// table is 16-byte aligned, else reads the table in place.
extern "C" int shuffle_fetch_launch(const void* ids, const void* table, int n_rows,
                                    int n_cols, int groups, int steps, void* out,
                                    void* stream) {
    if (n_rows <= 0 || n_cols <= 0 || groups != (n_rows + SHUFFLE_LANES - 1) / SHUFFLE_LANES)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned bound = n_rows < (1 << 29) ? 2u * (unsigned)n_rows : 0u;
    const size_t smem = 2 * (size_t)groups * SHUFFLE_LANES * sizeof(float);
    if (smem > SHUFFLE_SMEM_MAX || ((uintptr_t)table & 15) != 0) {
        shuffle_fetch_kernel<false><<<n_cols, SHUFFLE_LANES, 0, st>>>(
            (const int*)ids, (const float*)table, n_rows, n_cols, groups, steps, bound,
            (float*)out);
        return (int)cudaGetLastError();
    }
    // Above 48 KB a block's dynamic shared memory must be allowed first.
    static size_t allowed = 48 * 1024;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            shuffle_fetch_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        allowed = smem;
    }
    shuffle_fetch_kernel<true><<<n_cols, SHUFFLE_LANES, smem, st>>>(
        (const int*)ids, (const float*)table, n_rows, n_cols, groups, steps, bound,
        (float*)out);
    return (int)cudaGetLastError();
}
