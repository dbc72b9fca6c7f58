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
// different paths. Not FLOPs and not HBM bandwidth: the bench scene's node,
// meta and leaf tables are a few MB and stay resident in the 50 MB L2. The
// design therefore keeps it simple: node boxes are read as float4 rows and
// child meta as int4 rows through the read-only path, the stack is a
// per-thread int array sized by the host from the tree's depth, and a leaf
// is tested (all 16 triangles) when it is popped.
//
// Left for later work: nearest-child-first push order, a wavefront or
// persistent-thread layout that regroups rays by path, and ray sorting. The
// TPU kernel's packet union, deferred leaf queue, trash slots, multi-pop,
// HBM leaf tiles and bf16 boxes are TPU workarounds and are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_STACK 64
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

// any_mode: 0 = every lane closest, 1 = every lane any-hit, 2 = per lane
// (mode[i] > 0 marks an any-hit lane).
__global__ void __launch_bounds__(128) traverse_wide_kernel(
    const float4* __restrict__ nodes,   // (N4, 6) float4 = (N4, 24) f32
    const int4* __restrict__ meta,      // (N4,) int4 = (N4, 4) i32
    const float* __restrict__ records,  // (L, REC_GEO) f32
    const int* __restrict__ words,      // (L, LEAF_SIZE) i32
    const float* __restrict__ origin,   // (R, 3)
    const float* __restrict__ direction,
    const float* __restrict__ t_min_in, // (R,)
    const float* __restrict__ t_max_in,
    const int* __restrict__ mode,       // (R,) or null
    int n_rays, int root_meta, int any_mode, int cull_sign, int blend_mode,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_word) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;

    const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
    const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
    const float t_min = t_min_in[i];
    const float t_cap = t_max_in[i];
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    const bool lane_any = any_mode == 1 || (any_mode == 2 && mode[i] > 0);
    // Culling applies to closest lanes only in lane mode (and to every lane
    // otherwise, as in the TPU kernel).
    const bool cull = cull_sign != 0 && !(any_mode == 2 && lane_any);

    float t_best = t_cap, u_best = 0.0f, v_best = 0.0f;
    int w_best = -1;
    int stack[MAX_STACK];
    int sp = 0;
    // Lanes with an empty interval are dead: no triangle can satisfy
    // t_min < t < t_max, so they retire with a miss at once.
    if (t_min <= t_cap) stack[sp++] = root_meta;

    while (sp > 0) {
        const int entry = stack[--sp];
        const int id = entry & WIDE_ID_MASK;
        if ((entry & WIDE_LEAF_BIT) == 0) {
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
            bool hit[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float tx0 = (box[6 * c] - ox) * ix;
                const float tx1 = (box[6 * c + 3] - ox) * ix;
                const float ty0 = (box[6 * c + 1] - oy) * iy;
                const float ty1 = (box[6 * c + 4] - oy) * iy;
                const float tz0 = (box[6 * c + 2] - oz) * iz;
                const float tz1 = (box[6 * c + 5] - oz) * iz;
                const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
                const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
                hit[c] = (tf >= fmaxf(tn, t_min)) && (tn <= t_best);
            }
            // Push in reverse so child 0 is popped first (plain DFS order).
#pragma unroll
            for (int c = 3; c >= 0; --c) {
                if (hit[c]) stack[sp++] = ms[c];
            }
            continue;
        }
        const float* rec = records + (size_t)id * REC_GEO;
        const int* wrd = words + (size_t)id * LEAF_SIZE;
        bool retired = false;
        for (int k = 0; k < LEAF_SIZE; ++k) {
            const int word = __ldg(wrd + k);
            const float p0x = __ldg(rec + 9 * k), p0y = __ldg(rec + 9 * k + 1), p0z = __ldg(rec + 9 * k + 2);
            const float e1x = __ldg(rec + 9 * k + 3), e1y = __ldg(rec + 9 * k + 4), e1z = __ldg(rec + 9 * k + 5);
            const float e2x = __ldg(rec + 9 * k + 6), e2y = __ldg(rec + 9 * k + 7), e2z = __ldg(rec + 9 * k + 8);
            const float pvx = dy * e2z - dz * e2y;
            const float pvy = dz * e2x - dx * e2z;
            const float pvz = dx * e2y - dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const bool det_ok = fabsf(det) > 1e-12f;
            const float inv_det = det_ok ? 1.0f / det : 0.0f;
            const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
            const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
            const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
            bool h = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f
                     && tt > t_min && tt < t_best && word >= 0;
            if (blend_mode == BLEND_EXCLUDE) h = h && (word & FLAG_BLEND) == 0;
            else if (blend_mode == BLEND_ONLY) h = h && (word & FLAG_BLEND) != 0;
            if (cull && det * (float)cull_sign < 0.0f && (word & FLAG_DOUBLE_SIDED) == 0) h = false;
            if (h) {
                u_best = uu;
                v_best = vv;
                w_best = word;
                if (lane_any) {
                    // First accepted hit retires an any-hit lane.
                    t_best = NEG_BIG;
                    retired = true;
                    break;
                }
                t_best = tt;
            }
        }
        if (retired) break;
    }
    out_t[i] = t_best;
    out_u[i] = u_best;
    out_v[i] = v_best;
    out_word[i] = w_best;
}

}  // namespace

extern "C" int traverse_wide_launch(
    const void* nodes, const void* meta, const void* records, const void* words,
    const void* origin, const void* direction, const void* t_min, const void* t_max,
    const void* mode, int n_rays, int root_meta, int any_mode, int cull_sign,
    int blend_mode, void* out_t, void* out_u, void* out_v, void* out_word,
    void* stream) {
    if (n_rays > 0) {
        const int threads = 128;
        const int blocks = (n_rays + threads - 1) / threads;
        traverse_wide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float4*)nodes, (const int4*)meta, (const float*)records,
            (const int*)words, (const float*)origin, (const float*)direction,
            (const float*)t_min, (const float*)t_max, (const int*)mode, n_rays,
            root_meta, any_mode, cull_sign, blend_mode, (float*)out_t,
            (float*)out_u, (float*)out_v, (int*)out_word);
    }
    return (int)cudaGetLastError();
}

extern "C" int traverse_wide_max_stack() { return MAX_STACK; }
