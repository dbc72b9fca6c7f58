// Brute-force closest hit: every ray against every triangle, keeping a
// packed winner key per ray.
//
// Replaces the TPU kernel `make_brute_kernel` in tools/bench_mxu.py and
// computes what it computes. Moller-Trumbore's det, u*det, v*det and t*det
// are bilinear in (origin, direction), so each is a 16-term dot product of
// a ray's feature row (o, d, d_i*o_k, 1) with a triangle's coefficient
// column. Then, per (ray, triangle) pair, with the TPU kernel's operands:
//   m3 = (det - ud) - vd,  m4 = td - tmin*det,  m5 = tmax*det - td,
//   hit = det > 0 and ud, vd, m3, m4, m5 all >= 0
//      or det < 0 and ud, vd, m3, m4, m5 all <= 0,
//   key = (bits(hit ? td/det : +inf) & ~0x1FF) | lane,
// where lane is the triangle's index in its 512-triangle block. The
// conjunction is the TPU kernel's min/max predicate, NaN included. Per
// block the least key wins; across blocks the running minimum takes a
// block only when its key is strictly less. That is the lexicographic
// minimum of (key, blk) over all pairs, started from (0x7F7FFFFF, -1): a
// miss's key is above 0x7F7FFFFF and never wins.
//
// What bounds it on an H100: the epilogue's f32 operations. Per pair the
// four products are 128 operations, 1.7 ms at 262,144 rays x 49,152
// triangles on the tensor cores at 989 TFLOP/s; the epilogue is 19 f32
// operations (m3, m4, m5: 6; 12 compares; the or), 3.7 ms at 67 TFLOP/s.
// The division and the key are made for hits only, a few per cent of pairs
// at most. The coefficients (6.3 MB at the helmet's width, 35.1 MB at the
// courtyard's) fit the 50 MB L2; every CTA reads them all once, so L2
// serves (R / 256) x that: 6.4 GB and 36 GB at 262,144 rays, about 1 and 6
// ms at ~6 TB/s. Device memory sees them about once.
//
// The design:
// - Products on the tensor cores. `wgmma.mma_async` m64n128k16, bf16 x
//   bf16 -> f32: A is 64 rays' 16 features (one K step), held in registers
//   for the CTA's life; B is one coefficient tile in shared memory, the
//   columns [det | ud | vd | td] of 32 triangles (N = 128). The wrapper
//   (ops/brute.pack_slabs) lays the tiles out once per call, tile after
//   tile, each already in wgmma's no-swizzle K-major layout: 8x8 core
//   matrices of 128 contiguous bytes, the two K halves 128 bytes apart
//   (LBO), groups of 8 columns 256 bytes apart (SBO).
// - Asynchronous tile feed. One producer thread copies tile after tile
//   (4 KB each, contiguous) with 1-D bulk copies into a ring of STAGES
//   buffers, each guarded by a full and an empty mbarrier. Its warpgroup
//   hands registers to the consumers (setmaxnreg): the block holds
//   640 x 96 at launch, and 128 x 24 + 512 x 112 fits in it.
// - Four consumer warpgroups of 64 rays each (one m64 block), 256 rays a
//   CTA, 16 consumer warps a streaming multiprocessor. Each warpgroup
//   issues its tile's wgmma, waits for it and runs the epilogue; the four
//   warpgroups' epilogues hide one another's wgmmas and the epilogue's
//   latency. (Two warpgroups of two m64 blocks with two accumulator sets,
//   the second wgmma in flight under the first epilogue, ran slower: half
//   the warps. Issuing the next tile's wgmma across loop iterations made
//   ptxas serialise every wgmma, C7514.) Because the tile interleaves the
//   four quantities by quarter, one thread's fragment holds det, ud, vd and
//   td of the same 16 (ray, triangle) pairs: the epilogue runs in
//   registers, and a stage is released before it runs.
// - An epilogue that does the reference's work only: m3, m4, m5 and the
//   sign tests, each operation rounded on its own (built with -fmad=false);
//   the division and the key behind a warp-uniform branch taken where a
//   thread of the warp has a hit (no divergent branch touches an
//   accumulator, which would make ptxas serialise the wgmmas); a
//   per-thread running minimum of (key, blk), reduced across the 4 threads
//   of a quad once at the end. No per-block synchronisation.
//
// Its plain PyTorch twin is `brute_closest_ref` in ops/brute.py, which sums
// k = 0..15 in order with every operation rounded. wgmma sums the 16 exact
// bf16 products in an order and at a width the hardware fixes, so the two
// can differ where a term lies within rounding of 0 or two hits tie: they
// are held to each other by ops/brute.compare_winners, not bit for bit.
// `brute_sums_launch` writes the four sums of every pair (the same tile
// loop) for that comparison.

#include <cuda_runtime.h>
#include <stdint.h>

#define TB 512                      // triangles per key block (the key's 9 lane bits)
#define TN 32                       // triangles per tile
#define TILE_N (4 * TN)             // wgmma N: [det | ud | vd | td]
#define TILE_BYTES (TILE_N * 16 * 2)
#define TILES_PER_BLOCK (TB / TN)
#define STAGES 8
#define CONSUMERS 512               // four warpgroups
#define THREADS (CONSUMERS + 128)   // and one producer warpgroup
#define PRODUCER_REGS 24            // setmaxnreg: the producer gives registers
#define CONSUMER_REGS 112           // to the consumers
#define RAYS_PER_CTA 256            // 4 warpgroups x 1 m64 block
#define SMEM_BYTES (STAGES * TILE_BYTES + 2 * STAGES * 8)
#define SMEM_LIMIT (227 * 1024)
#define KEY_INIT 0x7F7FFFFF
#define LANE_BITS 0x1FF

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// No-swizzle K-major B descriptor: start >> 4, LBO 128 B (K), SBO 256 B (N).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
           | ((uint64_t)(256 >> 4) << 32);
}

// Ties the accumulators' values to this point of the program, so the
// compiler reads them after the wgmma wait and not before.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d = A x B (scale-d 0: no accumulation), A from registers, B by descriptor.
__device__ __forceinline__ void wgmma_tile(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    __syncwarp();
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(d);
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Accumulator layout (per warp, 16 rows): d[4j + 2h + e] is row g + 8h,
// column 8j + 2t + e, with g = lane / 4 and t = lane % 4. Column n is
// quantity n / 32 of triangle n % 32, so quantity q of triangle
// 8m + 2t + e, row half h, is d[16q + 4m + 2h + e].
struct RayState {
    float lo[2], hi[2];
    int key[2], blk[2];
};

// The reference's predicate for one pair, every operation rounded on its own.
__device__ __forceinline__ bool pair_hit(float det, float ud, float vd, float td, float lo,
                                         float hi) {
    const float m3 = __fsub_rn(__fsub_rn(det, ud), vd);
    const float m4 = __fsub_rn(td, __fmul_rn(lo, det));
    const float m5 = __fsub_rn(__fmul_rn(hi, det), td);
    const bool pos = det > 0.0f && ud >= 0.0f && vd >= 0.0f && m3 >= 0.0f && m4 >= 0.0f
                     && m5 >= 0.0f;
    const bool neg = det < 0.0f && ud <= 0.0f && vd <= 0.0f && m3 <= 0.0f && m4 <= 0.0f
                     && m5 <= 0.0f;
    return pos || neg;
}

// The unit's 16 pairs: the predicate for all of them, then, only when some
// thread of the warp has a hit (a warp-uniform branch, a few per cent of
// units), the division and the key for every pair, selected by its hit.
__device__ __forceinline__ void epilogue(const float (&d)[64], RayState& rs, int tile, int t4) {
    bool any = false;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 4 * m + 2 * h + e;
                any |= pair_hit(d[i], d[16 + i], d[32 + i], d[48 + i], rs.lo[h], rs.hi[h]);
            }
    if (!__any_sync(0xFFFFFFFFu, any)) return;
    const int blk = tile / TILES_PER_BLOCK;
    const int lane0 = (tile % TILES_PER_BLOCK) * TN + 2 * t4;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 4 * m + 2 * h + e;
                const bool hit = pair_hit(d[i], d[16 + i], d[32 + i], d[48 + i], rs.lo[h],
                                          rs.hi[h]);
                const int key = (__float_as_int(__fdiv_rn(d[48 + i], d[i])) & ~LANE_BITS)
                                | (lane0 + 8 * m + e);
                // Tiles come in order, so blk never decreases: a strict <
                // keeps the lexicographic minimum of (key, blk).
                const bool better = hit && key < rs.key[h];
                rs.key[h] = better ? key : rs.key[h];
                rs.blk[h] = better ? blk : rs.blk[h];
            }
}

// The four sums of every pair of the unit, to sums[(q * n_rays + ray) * n_tris + tri].
__device__ __forceinline__ void write_sums(const float (&d)[64], float* __restrict__ sums,
                                           int row, int tile, int t4, int n_rays, int n_tris) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    sums[((size_t)q * n_rays + row + 8 * h) * n_tris + tile * TN + 8 * m
                         + 2 * t4 + e] = d[16 * q + 4 * m + 2 * h + e];
}

template <bool SUMS>
__global__ void __launch_bounds__(THREADS, 1) brute_kernel(
    const uint32_t* __restrict__ feats,  // (R, 16) bf16 as (R, 8) words
    const float* __restrict__ tmin,      // (R,)
    const float* __restrict__ tmax,      // (R,)
    const uint8_t* __restrict__ tiles,   // n_tiles x TILE_BYTES, ops/brute.pack_slabs
    int n_tris, int* __restrict__ out_key, int* __restrict__ out_blk,
    float* __restrict__ sums) {
    extern __shared__ __align__(128) uint8_t smem[];
    const uint32_t ring = smem_u32(smem);
    const uint32_t full = ring + STAGES * TILE_BYTES;  // STAGES x 8 B each
    const uint32_t empty = full + STAGES * 8;
    const int n_tiles = n_tris / TN;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {  // the producer warpgroup: one thread feeds the ring
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
        if (tid == CONSUMERS) {
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
                mbar_expect_tx(full + 8 * s, TILE_BYTES);
                bulk_load(ring + s * TILE_BYTES, tiles + (size_t)i * TILE_BYTES, TILE_BYTES,
                          full + 8 * s);
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

    const int lane = tid % 32;
    const int t4 = lane % 4;
    // This thread's row in its warpgroup's m64 block (row half 0; half 1 is
    // 8 below): warp w of the warpgroup holds rows 16w..16w+15.
    const int base = blockIdx.x * RAYS_PER_CTA + (tid / 128) * 64 + ((tid % 128) / 32) * 16
                     + lane / 4;
    const int n_rays = gridDim.x * RAYS_PER_CTA;
    uint32_t a[4];
    RayState rs;
    a[0] = feats[(size_t)base * 8 + t4];
    a[1] = feats[(size_t)(base + 8) * 8 + t4];
    a[2] = feats[(size_t)base * 8 + 4 + t4];
    a[3] = feats[(size_t)(base + 8) * 8 + 4 + t4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if constexpr (!SUMS) {
            rs.lo[h] = tmin[base + 8 * h];
            rs.hi[h] = tmax[base + 8 * h];
        }
        rs.key[h] = KEY_INIT;
        rs.blk[h] = -1;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);
        wgmma_tile(acc, a, tile_desc(ring + s * TILE_BYTES));
        wgmma_wait_all();
        fence_acc(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);  // the wgmma has read the stage
        if constexpr (SUMS) write_sums(acc, sums, base, i, t4, n_rays, n_tris);
        else epilogue(acc, rs, i, t4);
    }

    if constexpr (!SUMS) {
        // The quad's four threads hold the same rows: lexicographic minimum.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int key = rs.key[h], blk = rs.blk[h];
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                const int k2 = __shfl_xor_sync(0xFFFFFFFFu, key, off);
                const int b2 = __shfl_xor_sync(0xFFFFFFFFu, blk, off);
                if (k2 < key || (k2 == key && b2 < blk)) {
                    key = k2;
                    blk = b2;
                }
            }
            if (t4 == 0) {
                out_key[base + 8 * h] = key;
                out_blk[base + 8 * h] = blk;
            }
        }
    }
}

template <bool SUMS>
int launch(const void* feats, const void* tmin, const void* tmax, const void* tiles, int n_rays,
           int n_tris, void* out_key, void* out_blk, void* sums, void* stream) {
    static_assert(SMEM_BYTES <= SMEM_LIMIT, "the tile ring does not fit in shared memory");
    static bool configured = false;
    if (n_rays % RAYS_PER_CTA != 0 || n_tris % TB != 0 || n_tris < 0)
        return (int)cudaErrorInvalidValue;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            brute_kernel<SUMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    if (n_rays > 0) {
        brute_kernel<SUMS><<<n_rays / RAYS_PER_CTA, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
            (const uint32_t*)feats, (const float*)tmin, (const float*)tmax,
            (const uint8_t*)tiles, n_tris, (int*)out_key, (int*)out_blk, (float*)sums);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Version of brute_closest_launch's argument list: 1 (no such function) took
// the four (16, T) slabs; 2 takes the packed tiles.
extern "C" int brute_closest_abi(void) { return 2; }

extern "C" int brute_closest_launch(const void* feats, const void* tmin, const void* tmax,
                                    const void* tiles, int n_rays, int n_tris, void* out_key,
                                    void* out_blk, void* stream) {
    return launch<false>(feats, tmin, tmax, tiles, n_rays, n_tris, out_key, out_blk, nullptr,
                         stream);
}

extern "C" int brute_sums_launch(const void* feats, const void* tiles, int n_rays, int n_tris,
                                 void* sums, void* stream) {
    return launch<true>(feats, nullptr, nullptr, tiles, n_rays, n_tris, nullptr, nullptr, sums,
                        stream);
}
