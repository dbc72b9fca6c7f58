// Closest-hit / any-hit traversal of the 4-wide BVH, one thread per ray.
//
// Replaces the TPU kernel `_traverse_kernel` in
// gltf_renderer_tpu/ops/pallas_trace.py (entry `traverse_packets_wide`) and
// computes what it computes: per ray, the closest (or, for any-hit rays, the
// first accepted) triangle over the wide node table and the compact leaf
// tables, with the same slab box test, the same Moller-Trumbore predicate
// (|det| > 1e-12, u, v >= 0, u + v <= 1, t_min < t < t_best, word >= 0), the
// same blend filter, the same culling rule (skipped for double-sided
// triangles and, in lane mode, for any-hit lanes) and the same ray set-up
// (inv = |d| > 1e-20 ? 1/d : sign(d) * 1e30 + 1e30). Its plain PyTorch twin
// is `traverse_wide_ref` in ops/traverse.py, which visits nodes in the same
// order with the same arithmetic; built with -fmad=false the two agree bit
// for bit.
//
// What bounds it on an H100: chains of dependent loads (pop -> node row ->
// box test -> push -> pop) and warp divergence between rays that take
// different paths; not FLOPs and not HBM bandwidth (the bench scene's
// tables are a few MB and stay in the 50 MB L2). The design shortens each
// link of the chain:
// - the stack lives in dynamic shared memory, sized at launch from the
//   tree's stack bound and strided by the block size so that the threads of
//   a warp hit different banks; the entry being processed stays in a
//   register, so a node's nearest child is never pushed and popped, and
//   the stack needs one entry fewer than the bound (a local-memory stack
//   was as fast at the bench tree's depth, within 3%, but has a compiled
//   depth limit; this one is limited only by a block's 227 KB);
// - node boxes are read as 6 float4 and child meta as one int4, a leaf's
//   records as 36 float4 (4 triangles per 9) and its words as 4 int4, all
//   through the read-only path, the leaf's 4 groups unrolled so that their
//   loads are in flight together;
// - children whose box the ray enters are visited nearest first (entry
//   distance, then child index), so a closest-hit ray shrinks t_best
//   before it reaches the leaves behind its hit;
// - each ray visits nodes until it holds a leaf, and only then tests it
//   (the "while-while" loop of Aila and Laine, HPG 2009), so a warp's rays
//   test their leaves together instead of one branch waiting on the
//   other; the visit order of each ray is unchanged.
//
// Tried and not kept (PERF.md): entry distances kept on the stack to drop
// far entries at the pop, and persistent warps that fetch rays from a
// counter (Aila and Laine, HPG 2009). Left for later work: a wavefront
// layout that regroups rays by path, and ray sorting. The TPU kernel's
// packet union, deferred leaf queue, trash slots, multi-pop, HBM leaf tiles
// and bf16 boxes are TPU workarounds and are not carried over.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define THREADS 128  // rays a block
#define SMEM_LIMIT 232448  // shared memory one block may use on Hopper
#define LEAF_SIZE 16
#define REC_GEO (9 * LEAF_SIZE)
#define WIDE_LEAF_BIT (1 << 30)
#define WIDE_ID_MASK (WIDE_LEAF_BIT - 1)
#define FLAG_BLEND (1 << 29)
#define FLAG_DOUBLE_SIDED (1 << 30)
#define BLEND_EXCLUDE 1
#define BLEND_ONLY 2
#define NEG_BIG (-3.0e38f)

namespace {

__device__ __forceinline__ float inv_dir(float d) {
    if (fabsf(d) > 1e-20f) return 1.0f / d;
    float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    return s * 1e30f + 1e30f;
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, t_min;
    bool lane_any, cull;
    int cull_sign, blend_mode;
};

struct Best {
    float t, u, v;
    int word;
};

// One Moller-Trumbore test of triangle (p0, e1, e2) = g[0:9]. Returns true
// when it retires an any-hit ray.
__device__ __forceinline__ bool test_triangle(const float* g, int word, const Ray& r, Best& b) {
    const float p0x = g[0], p0y = g[1], p0z = g[2];
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool det_ok = fabsf(det) > 1e-12f;
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
    const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    bool h = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f
             && tt > r.t_min && tt < b.t && word >= 0;
    if (r.blend_mode == BLEND_EXCLUDE) h = h && (word & FLAG_BLEND) == 0;
    else if (r.blend_mode == BLEND_ONLY) h = h && (word & FLAG_BLEND) != 0;
    if (r.cull && det * (float)r.cull_sign < 0.0f && (word & FLAG_DOUBLE_SIDED) == 0) h = false;
    if (!h) return false;
    b.u = uu;
    b.v = vv;
    b.word = word;
    if (r.lane_any) {
        // The first accepted hit retires an any-hit lane.
        b.t = NEG_BIG;
        return true;
    }
    b.t = tt;
    return false;
}

// Test all 16 triangles of leaf `id`; returns true when the ray retires.
__device__ __forceinline__ bool test_leaf(const float* __restrict__ records,
                                          const int* __restrict__ words, int id,
                                          const Ray& r, Best& b) {
    // 4 triangles = 36 floats = 9 float4, so every group starts 16-byte
    // aligned in the 576-byte row.
    const float4* rec = reinterpret_cast<const float4*>(records) + (size_t)id * (REC_GEO / 4);
    const int4* wrd = reinterpret_cast<const int4*>(words) + (size_t)id * (LEAF_SIZE / 4);
#pragma unroll
    for (int grp = 0; grp < LEAF_SIZE / 4; ++grp) {
        float g[36];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            const float4 f = __ldg(rec + 9 * grp + q);
            g[4 * q] = f.x; g[4 * q + 1] = f.y; g[4 * q + 2] = f.z; g[4 * q + 3] = f.w;
        }
        const int4 w4 = __ldg(wrd + grp);
        const int w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (test_triangle(g + 9 * k, w[k], r, b)) return true;
        }
    }
    return false;
}

// Order children (key, index) ascending: one compare-exchange of the
// sorting network, carrying each child's entry along.
__device__ __forceinline__ void order2(float& ka, int& ia, int& ma, float& kb, int& ib, int& mb) {
    if (kb < ka || (kb == ka && ib < ia)) {
        float k = ka; ka = kb; kb = k;
        int i = ia; ia = ib; ib = i;
        int m = ma; ma = mb; mb = m;
    }
}

// The traversal stack of one thread, in shared memory strided by the block
// size so that a warp's threads hit different banks.
struct Stack {
    int* ent;
    __device__ __forceinline__ int& at(int k) { return ent[k * THREADS]; }
    int sp;

    __device__ __forceinline__ void push(int e) { at(sp++) = e; }

    // The next entry to visit into `e`; false when none is left.
    __device__ __forceinline__ bool pop(int& e) {
        if (sp == 0) return false;
        e = at(--sp);
        return true;
    }
};

// Box-test the 4 children of node `id`, push those the ray enters except
// the first to visit, and return that one (-1 when the ray enters none).
__device__ __forceinline__ int visit_node(const float4* __restrict__ nodes,
                                          const int4* __restrict__ meta, int id, const Ray& r,
                                          float ix, float iy, float iz, float t_best, Stack& st) {
    const float4* row = nodes + 6 * id;
    float box[24];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
        const float4 f = __ldg(row + q);
        box[4 * q] = f.x; box[4 * q + 1] = f.y;
        box[4 * q + 2] = f.z; box[4 * q + 3] = f.w;
    }
    const int4 m = __ldg(meta + id);
    const int ms[4] = {m.x, m.y, m.z, m.w};
    // Child c's sort key (entry distance, +inf if its box is missed),
    // index, and entry (-1 if missed).
    float key[4];
    int idx[4], ent[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const float tx0 = (box[6 * c] - r.ox) * ix;
        const float tx1 = (box[6 * c + 3] - r.ox) * ix;
        const float ty0 = (box[6 * c + 1] - r.oy) * iy;
        const float ty1 = (box[6 * c + 4] - r.oy) * iy;
        const float tz0 = (box[6 * c + 2] - r.oz) * iz;
        const float tz1 = (box[6 * c + 5] - r.oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        const bool hit = (tf >= fmaxf(tn, r.t_min)) && (tn <= t_best);
        key[c] = hit ? tn : CUDART_INF_F;
        idx[c] = c;
        ent[c] = hit ? ms[c] : -1;
    }
    order2(key[0], idx[0], ent[0], key[1], idx[1], ent[1]);
    order2(key[2], idx[2], ent[2], key[3], idx[3], ent[3]);
    order2(key[0], idx[0], ent[0], key[2], idx[2], ent[2]);
    order2(key[1], idx[1], ent[1], key[3], idx[3], ent[3]);
    order2(key[1], idx[1], ent[1], key[2], idx[2], ent[2]);
    // Visit order is ent[0], ent[1], ...: push the later ones first and
    // return the first rather than pushing it.
    int next = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
        if (ent[j] >= 0) {
            if (next >= 0) st.push(next);
            next = ent[j];
        }
    }
    return next;
}

// any_mode: 0 = every lane closest, 1 = every lane any-hit, 2 = per lane
// (mode[i] > 0 marks an any-hit lane).
__device__ __forceinline__ void trace_ray(
    int i, Stack& st, const float4* __restrict__ nodes, const int4* __restrict__ meta,
    const float* __restrict__ records, const int* __restrict__ words,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_min_in, const float* __restrict__ t_max_in,
    const int* __restrict__ mode, int root_meta, int any_mode, int cull_sign, int blend_mode,
    float* __restrict__ out_t, float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_word) {
    Ray r;
    r.ox = origin[3 * i]; r.oy = origin[3 * i + 1]; r.oz = origin[3 * i + 2];
    r.dx = direction[3 * i]; r.dy = direction[3 * i + 1]; r.dz = direction[3 * i + 2];
    r.t_min = t_min_in[i];
    const float t_cap = t_max_in[i];
    const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
    r.lane_any = any_mode == 1 || (any_mode == 2 && mode[i] > 0);
    // Culling applies to closest lanes only in lane mode (and to every lane
    // otherwise, as in the TPU kernel).
    r.cull = cull_sign != 0 && !(any_mode == 2 && r.lane_any);
    r.cull_sign = cull_sign;
    r.blend_mode = blend_mode;

    Best b = {t_cap, 0.0f, 0.0f, -1};
    int entry = root_meta;
    st.sp = 0;
    // Lanes with an empty interval are dead: no triangle can satisfy
    // t_min < t < t_max, so they retire with a miss at once.
    bool live = r.t_min <= t_cap;
    while (live) {
        // Visit nodes until the ray holds a leaf, then test the leaf.
        while (live && (entry & WIDE_LEAF_BIT) == 0) {
            const int next = visit_node(nodes, meta, entry & WIDE_ID_MASK, r, ix, iy, iz, b.t, st);
            if (next >= 0) entry = next;
            else live = st.pop(entry);
        }
        if (!live || (entry & WIDE_LEAF_BIT) == 0) continue;
        if (test_leaf(records, words, entry & WIDE_ID_MASK, r, b)) break;
        live = st.pop(entry);
    }
    out_t[i] = b.t;
    out_u[i] = b.u;
    out_v[i] = b.v;
    out_word[i] = b.word;
}

__global__ void __launch_bounds__(THREADS) traverse_wide_kernel(
    const float4* __restrict__ nodes,   // (N4, 6) float4 = (N4, 24) f32
    const int4* __restrict__ meta,      // (N4,) int4 = (N4, 4) i32
    const float* __restrict__ records,  // (L, REC_GEO) f32, 16-byte aligned
    const int* __restrict__ words,      // (L, LEAF_SIZE) i32, 16-byte aligned
    const float* __restrict__ origin,   // (R, 3)
    const float* __restrict__ direction,
    const float* __restrict__ t_min_in, // (R,)
    const float* __restrict__ t_max_in,
    const int* __restrict__ mode,       // (R,) or null
    int n_rays, int root_meta, int any_mode, int cull_sign, int blend_mode,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_word) {
    extern __shared__ int smem_stack[];  // (stack entries, THREADS)
    Stack st;
    st.ent = smem_stack + threadIdx.x;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_rays) return;
    trace_ray(i, st, nodes, meta, records, words, origin, direction, t_min_in, t_max_in, mode,
              root_meta, any_mode, cull_sign, blend_mode, out_t, out_u, out_v, out_word);
}

// Stack entries the kernel keeps for a tree whose traversal stack holds at
// most `stack_bound` entries: the entry in hand is not stored.
int stack_entries(int stack_bound) { return stack_bound > 1 ? stack_bound - 1 : 1; }

}  // namespace

// Largest stack bound the kernel takes: its stack must fit a block's
// shared memory.
extern "C" int traverse_wide_max_stack() {
    return SMEM_LIMIT / (THREADS * (int)sizeof(int)) + 1;
}

// Version of traverse_wide_launch's argument list, for tools that launch an
// older build of this file: 2 takes `stack_bound` after `blend_mode`; a
// library without this symbol is version 1, which does not.
extern "C" int traverse_wide_abi() { return 2; }

extern "C" int traverse_wide_launch(
    const void* nodes, const void* meta, const void* records, const void* words,
    const void* origin, const void* direction, const void* t_min, const void* t_max,
    const void* mode, int n_rays, int root_meta, int any_mode, int cull_sign,
    int blend_mode, int stack_bound, void* out_t, void* out_u, void* out_v,
    void* out_word, void* stream) {
    if (stack_bound < 1 || stack_bound > traverse_wide_max_stack()) return (int)cudaErrorInvalidValue;
    if (n_rays <= 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)THREADS * stack_entries(stack_bound) * sizeof(int);
    // Above 48 KB a block's dynamic shared memory must be allowed first.
    static size_t allowed = 48 * 1024;
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            traverse_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        allowed = smem;
    }
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    traverse_wide_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float4*)nodes, (const int4*)meta, (const float*)records,
        (const int*)words, (const float*)origin, (const float*)direction,
        (const float*)t_min, (const float*)t_max, (const int*)mode, n_rays,
        root_meta, any_mode, cull_sign, blend_mode, (float*)out_t,
        (float*)out_u, (float*)out_v, (int*)out_word);
    return (int)cudaGetLastError();
}
