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
// the one-hot row and the group select do there. The one-hot product also
// adds 0 x every other row's entry, and 0 x inf and 0 x NaN are NaN: a
// non-finite entry in the first 8 columns of any row makes s NaN for every
// lane but those on its own row, and for those too where another row
// holds one (an id outside the table included). The onehot kernel
// computes the same. Every sum is taken in the JAX kernels' order with
// each add rounded on its own (__fadd_rn), and a bf16 -> f32 fetch is
// exact, so these kernels and their plain PyTorch twins in ops/perlane.py
// agree bit for bit, and with the JAX kernels but in the NaN payloads
// (the hardware's).
//
// What bounds them on an H100: the chain of `steps` dependent loads, not
// bytes and not operations. The tables (0.2-2.9 MB) stay in L2 between
// calls.
//
// The onehot kernel was one thread a lane in 16 blocks of 128 (16 of the
// 132 SMs), reading 8 bf16 of its row at every step from L2 (few L1
// hits) and then running eight dependent adds, the F2I, a signed modulo
// by a run-time n and a 64-bit address: 13.1 us a call at 6400x112 on an
// H100, 21.7x its latency floor. But s depends only on the row. So the
// kernel now first sums every row once, in a cluster of 8 blocks of 256
// lanes: each block sums an eighth of the rows (one 16-byte load a row
// where rows are 16-byte aligned, issued before anything else) and stores
// the sums into every block's shared memory by st.async, which counts
// their bytes on the receiving block's mbarrier: no GPU-scope fence and
// no cluster barrier after the stores (a cluster barrier there, whose
// release is a GPU-scope fence, was slower). Each warp sends the lowest
// and highest row holding a non-finite entry the same way. Once its bytes
// have landed each lane walks its chain on its block's copy with the
// shuffle kernel's step (below), step 0 included: LDS of s at byte offset
// 4 id, the add into acc off the chain, fast_next_off and the next LDS,
// about 27 ns a step; 3.2-4.0 us a call at the tool's shapes, most of it
// the launch (1.2 us) and the staging (1.9 us at 6400 rows, whose loads
// touch one 128-byte line a row: 800 lines an SM). Clusters of 1 (every
// block sums every row) and of 16 blocks lost at every shape, two
// clusters of 8 blocks of 128 lanes at the two larger ones, and copying a
// block's sums with cp.async.bulk lost too; so the cluster's shape is
// fixed at compile time (ONEHOT_CLUSTER, ONEHOT_THREADS). Sums over a
// block's shared memory (n > ~57,800) are read in place by the same code.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SHUFFLE_LANES 128
#define SMEM_MAX 232448      // bytes of shared memory a block can use on an H100
#define ONEHOT_CLUSTER 8     // blocks of a onehot cluster, each staging an eighth of the sums
#define ONEHOT_THREADS 256   // lanes of a onehot block: 8 x 256 = the 2048-lane packet

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
    return __uint_as_float(((uint32_t)h) << 16);
}

__device__ __forceinline__ int floor_mod(int x, int n) {
    const int m = x % n;
    return m < 0 ? m + n : m;
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
// branch and no division on the chain. Both kernels walk every lane fast
// and walk it again exactly where `rare` was set.
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

// A bf16 whose exponent bits are all ones: +-inf or NaN.
__device__ __forceinline__ bool bf16_nonfinite(uint32_t h) { return (h & 0x7F80u) == 0x7F80u; }

// The first 8 columns of row r as 4 words, column 2j in the low half of
// word j: one 16-byte load where the row is 16-byte aligned (`vec`), else
// 8 two-byte loads.
__device__ __forceinline__ void load_row8(const uint16_t* __restrict__ table, int n_cols, int r,
                                          bool vec, uint32_t w[4]) {
    const uint16_t* row = table + (size_t)r * n_cols;
    if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            w[j] = (uint32_t)__ldg(row + 2 * j) | ((uint32_t)__ldg(row + 2 * j + 1) << 16);
    }
}

// Rows q to q + 3 below r1 (load_row8).
__device__ __forceinline__ void load_rows4(const uint16_t* __restrict__ table, int n_cols, int q,
                                           int r1, bool vec, uint32_t w[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (q + j < r1) load_row8(table, n_cols, q + j, vec, w[j]);
}

// s of a row from load_row8's words: the 8 columns added left to right
// from 0, each add rounded; `bad` is set where one of them is non-finite.
__device__ __forceinline__ float row_sum8(const uint32_t w[4], bool& bad) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint32_t h = (k & 1) ? w[k >> 1] >> 16 : w[k >> 1] & 0xFFFFu;
        s = __fadd_rn(s, bf16_to_f32((uint16_t)h));
        bad |= bf16_nonfinite(h);
    }
    return s;
}

// Distributed shared memory by transaction count: a block's mbarrier
// completes its phase once the bytes it expects have landed, each remote
// store (st.async) counting its bytes on the receiving block's mbarrier.
// No fence at GPU scope and no cluster barrier after the stores.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local, unsigned rank) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

__device__ __forceinline__ void st_async_v4(unsigned remote, float4 v, unsigned remote_bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void st_async_v2(unsigned remote, int a, int b, unsigned remote_bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];"
        :: "r"(remote), "r"(a), "r"(b), "r"(remote_bar) : "memory");
}

// Whether the mbarrier at `bar` has completed phase 0 (try_wait: waits a
// while in the hardware before it answers).
__device__ __forceinline__ bool mbarrier_done(unsigned bar) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar) : "memory");
    return done != 0;
}

// Thread = lane, ONEHOT_THREADS lanes a block, blocks in clusters of
// ONEHOT_CLUSTER. Each block of a cluster takes its share of the
// rows (`per`, a multiple of 4, from row rank x per), four consecutive
// rows a thread, sums each row's first 8 columns and, STAGED, stores the
// four sums with one 16-byte st.async into every block's shared memory
// (s[id], by row id). Each warp's lowest and highest row holding a
// non-finite entry go into its slot of every block's `bad_rows`. Each
// block's mbarrier expects all those bytes; once they have landed the
// block reads its own copy: a step is one LDS of s at byte offset 4 id,
// the FADD into acc off the chain and fast_next_off, K5's step, from step
// 0 on. Not STAGED (4n bytes over a block's shared memory) the lanes sum
// their row in place at every step; the rows are still scanned for the
// poison.
template <bool STAGED>
__global__ void __cluster_dims__(ONEHOT_CLUSTER, 1, 1)
    onehot_fetch_kernel(const int* __restrict__ ids, const uint16_t* __restrict__ table,
                        int n_rows, int n_cols, int steps, int n_lanes, int per, unsigned bound,
                        float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    // [rank x warps + warp]: that warp's lowest and highest row holding a
    // non-finite entry, or (INT_MAX, -1).
    constexpr unsigned ranks = ONEHOT_CLUSTER, warps = ONEHOT_THREADS / 32;
    __shared__ int2 bad_rows[ranks * warps];
    __shared__ uint64_t landed;  // the mbarrier counting the bytes stored into this block
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const int tid = threadIdx.x;
    // The rows' loads go out before anything else: they are most of the
    // staging's time.
    const bool vec = ((uintptr_t)table & 15) == 0 && (n_cols & 7) == 0;
    const int r0 = (int)rank * per, r1 = min(n_rows, r0 + per);
    uint32_t w[4][4];
    load_rows4(table, n_cols, r0 + 4 * tid, r1, vec, w);
    const int lane = blockIdx.x * ONEHOT_THREADS + tid;
    const int id0 = lane < n_lanes ? ids[lane] : 0;
    const unsigned bar = smem_addr(&landed);
    const unsigned warp = tid / 32;
    if (tid == 0) {
        // The cluster stores 16 bytes for every 4 rows (ceil(n / 4) stores)
        // and every warp 8 bytes of poison flags into each block.
        const unsigned bytes =
            (STAGED ? 16u * (unsigned)((n_rows + 3) / 4) : 0u) + 8u * ranks * warps;
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // No block stores into another before that one has started and set up
    // its mbarrier: arrive now, wait once the first rows are loaded.
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
    asm volatile("barrier.cluster.wait;" ::: "memory");
    int lo = INT_MAX, hi = -1;  // this thread's lowest and highest bad row
    for (int base = r0; base < r1; base += 4 * ONEHOT_THREADS) {  // the same trips for every thread
        const int q = base + 4 * tid;
        if (base != r0) load_rows4(table, n_cols, q, r1, vec, w);
        if (q < r1) {
            bool bad_row[4] = {false, false, false, false};
            float4 sum;
            sum.x = row_sum8(w[0], bad_row[0]);
            sum.y = q + 1 < r1 ? row_sum8(w[1], bad_row[1]) : 0.0f;
            sum.z = q + 2 < r1 ? row_sum8(w[2], bad_row[2]) : 0.0f;
            sum.w = q + 3 < r1 ? row_sum8(w[3], bad_row[3]) : 0.0f;
            if constexpr (STAGED)
                for (unsigned k = 0; k < ranks; ++k)
                    st_async_v4(cluster_addr(smem_addr(s + q), k), sum, cluster_addr(bar, k));
            for (int j = 0; j < 4; ++j)
                if (bad_row[j]) lo = min(lo, q + j), hi = max(hi, q + j);
        }
    }
    // Each warp's flags, lane k storing them into block k.
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    const unsigned slot = smem_addr(&bad_rows[rank * warps + warp]);
    for (unsigned k = tid % 32; k < ranks; k += 32)
        st_async_v2(cluster_addr(slot, k), lo, hi, cluster_addr(bar, k));
    // Wait for every byte stored into this block: the sums and the flags.
    // Bytes that never land (a fault) end the kernel with an error, not a hang.
    for (unsigned tries = 0; !mbarrier_done(bar); ++tries)
        if (tries > (1u << 22)) __trap();
    // The one-hot product adds 0 x every other row's entry: a non-finite
    // entry poisons every lane's s but those on its own row, when that
    // row is the only one holding one (`keep`). Each warp reads the flags.
    for (unsigned j = tid % 32; j < ranks * warps; j += 32)
        lo = min(lo, bad_rows[j].x), hi = max(hi, bad_rows[j].y);
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    const bool poisoned = hi >= 0;
    const int keep = lo == hi ? lo : -1;
    const float nan = __int_as_float(0x7FFFFFFF);
    if constexpr (STAGED) {
        if (poisoned) {
            for (int r = tid; r < n_rows; r += ONEHOT_THREADS)
                if (r != keep) s[r] = nan;
            __syncthreads();
        }
    }
    if (lane >= n_lanes) return;
    // s of the row at byte offset o = 4 id, an id inside the table.
    auto fetch = [&](unsigned o) -> float {
        if constexpr (STAGED)
            return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(s) + o);
        const int r = (int)(o >> 2);
        uint32_t w[4];
        bool unused = false;
        load_row8(table, n_cols, r, vec, w);
        const float sum = row_sum8(w, unused);
        return poisoned && r != keep ? nan : sum;
    };
    // Steps `first` to steps - 1 from the byte offset o (an id inside the
    // table) and acc: fast (fast_next_off, setting `rare` when a step was
    // rare) or exactly.
    auto walk = [&](auto exact_tag, int first, unsigned o, float acc, bool& rare) -> float {
        constexpr bool exact = decltype(exact_tag)::value;
#pragma unroll 4
        for (int i = first; i < steps; ++i) {
            const float f = fetch(o);
            acc = __fadd_rn(acc, f);
            if constexpr (exact) o = 4u * (unsigned)exact_next_id((int)(o >> 2), f, i, n_rows);
            else o = fast_next_off(o, f, i, (unsigned)n_rows, bound, rare);
        }
        return acc;
    };
    // Fast, step 0 too: an id outside the table makes the lane rare (it is
    // walked from row 0 meanwhile). Exactly: step 0 apart, fetching 0 or,
    // from a poisoned table, NaN where the id lies outside.
    const bool valid = (unsigned)id0 < (unsigned)n_rows;
    bool rare = !valid;
    float acc = walk(Exact<false>{}, 0, valid ? 4u * (unsigned)id0 : 0u, 0.0f, rare);
    if (rare && steps > 0) {
        const float s0 = valid ? fetch(4u * (unsigned)id0) : (poisoned ? nan : 0.0f);
        acc = walk(Exact<true>{}, 1, 4u * (unsigned)exact_next_id(id0, s0, 0, n_rows),
                   __fadd_rn(0.0f, s0), rare);
    }
    out[lane] = acc;
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

// The onehot kernel in clusters of ONEHOT_CLUSTER blocks of ONEHOT_THREADS
// lanes (enough clusters for n_lanes), staged where 4 x n (rounded up to
// 4 rows) bytes of row sums fit a block's shared memory, else in place.
// Ids are carried as byte offsets, so n_rows < 2^30.
extern "C" int onehot_fetch_launch(const void* ids, const void* table, int n_rows, int n_cols,
                                   int steps, int n_lanes, void* out, void* stream) {
    if (n_rows <= 0 || n_rows >= (1 << 30) || n_cols < 8) return (int)cudaErrorInvalidValue;
    if (n_lanes <= 0) return (int)cudaGetLastError();
    const size_t smem = 4 * (((size_t)n_rows + 3) & ~(size_t)3);
    const bool staged = smem + 1024 <= SMEM_MAX;  // beside the kernel's static 520 bytes
    void (*kernel)(const int*, const uint16_t*, int, int, int, int, int, unsigned, float*) =
        staged ? onehot_fetch_kernel<true> : onehot_fetch_kernel<false>;
    // Above 48 KB a block's dynamic shared memory must be allowed first.
    static size_t allowed = 48 * 1024;
    if (staged && smem > allowed) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        allowed = smem;
    }
    constexpr int packet = ONEHOT_CLUSTER * ONEHOT_THREADS;  // lanes a cluster
    const int blocks = (n_lanes + packet - 1) / packet * ONEHOT_CLUSTER;
    const unsigned bound = n_rows < (1 << 29) ? 2u * (unsigned)n_rows : 0u;
    const int per = ((n_rows + ONEHOT_CLUSTER - 1) / ONEHOT_CLUSTER + 3) & ~3;  // rows a block sums
    kernel<<<blocks, ONEHOT_THREADS, staged ? smem : 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const uint16_t*)table, n_rows, n_cols, steps, n_lanes, per, bound,
        (float*)out);
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
    if (smem > SMEM_MAX || ((uintptr_t)table & 15) != 0) {
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
