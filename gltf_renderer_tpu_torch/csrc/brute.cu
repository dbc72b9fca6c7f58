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
// where lane is the triangle's index in its 512-triangle block. The TPU
// kernel wrote the predicate as min/max of the five terms against 0; the
// conjunction here is the same predicate, NaN included (a NaN term fails
// every comparison, as it makes min/max NaN). Per block the least key
// wins; across blocks the running minimum takes a block only when its key
// is strictly less, so the earlier block keeps a tie. key starts at
// 0x7F7FFFFF and blk at -1, and a miss keeps both.
//
// Its plain PyTorch twin is `brute_closest_ref` in ops/brute.py. Both sum
// each product in order k = 0..15 with every multiply and add rounded on
// its own (__fmul_rn / __fadd_rn, never contracted), and both divide with
// IEEE division, so key and blk agree bit for bit.
//
// What bounds it on an H100: operations. Per pair the four products are
// 128 flops, which the tensor cores could run at 989 TFLOP/s in bf16, and
// the epilogue is about 22 f32 operations at 67 TFLOP/s: at 262,144 rays
// that is roughly 1.7 ms of products and 4.2 ms of epilogue for the
// helmet's 49,152 triangles and 9.3 and 23.6 ms for the courtyard's
// 274,432. The two units run side by side, so the bound is the larger,
// the epilogue's 4.2 and 23.6 ms (chip_smoke.py's `bound`). The
// bytes (6.3 MB and 35.1 MB of coefficients, 8 MB of features) are
// microseconds. This first kernel is simple: one thread per ray with its
// 16 features in f32 registers (bf16 values are exact there), and the four
// coefficient slabs staged through shared memory 128 triangles at a time
// as f32, read back by every thread as broadcast float4 loads. It runs the
// products on the CUDA cores, not the tensor cores; a `wgmma` tile loop
// with the epilogue on the accumulator fragments is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define TB 512           // triangles per key block (the key's 9 lane bits)
#define TS 128           // triangles staged in shared memory per pass
#define CSTRIDE 68       // floats per staged triangle: 4 x 16 + 4 pad, 16-byte aligned
#define THREADS 256      // rays per CTA
#define KEY_INIT 0x7F7FFFFF
#define LANE_BITS 0x1FF

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
    return __uint_as_float(((uint32_t)h) << 16);
}

// sum_k f[k] * c[k], k = 0..15 in order, each operation rounded on its own.
__device__ __forceinline__ float dot16(const float (&f)[16], const float4* __restrict__ c) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = c[q];
        const float p0 = __fmul_rn(f[4 * q + 0], v.x);
        acc = q == 0 ? p0 : __fadd_rn(acc, p0);
        acc = __fadd_rn(acc, __fmul_rn(f[4 * q + 1], v.y));
        acc = __fadd_rn(acc, __fmul_rn(f[4 * q + 2], v.z));
        acc = __fadd_rn(acc, __fmul_rn(f[4 * q + 3], v.w));
    }
    return acc;
}

__global__ void __launch_bounds__(THREADS) brute_closest_kernel(
    const uint16_t* __restrict__ feats,  // (R, 16) bf16
    const float* __restrict__ tmin,      // (R,)
    const float* __restrict__ tmax,      // (R,)
    const uint16_t* __restrict__ cdet,   // (16, T) bf16, and the same for the others
    const uint16_t* __restrict__ cud,
    const uint16_t* __restrict__ cvd,
    const uint16_t* __restrict__ ctd,
    int n_tris, int* __restrict__ out_key, int* __restrict__ out_blk) {
    __shared__ __align__(16) float sc[TS * CSTRIDE];
    const int r = blockIdx.x * THREADS + threadIdx.x;  // R is a multiple of THREADS

    float f[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = bf16_to_f32(feats[(size_t)r * 16 + k]);
    const float lo = tmin[r];
    const float hi = tmax[r];

    int rkey = KEY_INIT;
    int rblk = -1;
    const int n_blocks = n_tris / TB;
    for (int j = 0; j < n_blocks; ++j) {
        int kmin = 0x7FFFFFFF;
        for (int s = 0; s < TB; s += TS) {
            const int t0 = j * TB + s;
            __syncthreads();  // the previous pass is done reading sc
            for (int idx = threadIdx.x; idx < 4 * 16 * TS; idx += THREADS) {
                const int t = idx % TS;
                const int k = (idx / TS) % 16;
                const int m = idx / (16 * TS);
                const uint16_t* src = m == 0 ? cdet : (m == 1 ? cud : (m == 2 ? cvd : ctd));
                sc[t * CSTRIDE + m * 16 + k] = bf16_to_f32(src[(size_t)k * n_tris + t0 + t]);
            }
            __syncthreads();
            for (int t = 0; t < TS; ++t) {
                const float4* c = reinterpret_cast<const float4*>(sc + t * CSTRIDE);
                const float det = dot16(f, c);
                const float ud = dot16(f, c + 4);
                const float vd = dot16(f, c + 8);
                const float td = dot16(f, c + 12);
                const float m3 = __fsub_rn(__fsub_rn(det, ud), vd);
                const float m4 = __fsub_rn(td, __fmul_rn(lo, det));
                const float m5 = __fsub_rn(__fmul_rn(hi, det), td);
                const bool pos = det > 0.0f && ud >= 0.0f && vd >= 0.0f && m3 >= 0.0f
                                 && m4 >= 0.0f && m5 >= 0.0f;
                const bool neg = det < 0.0f && ud <= 0.0f && vd <= 0.0f && m3 <= 0.0f
                                 && m4 <= 0.0f && m5 <= 0.0f;
                const float tb = (pos || neg) ? __fdiv_rn(td, det) : __int_as_float(0x7F800000);
                const int key = (__float_as_int(tb) & ~LANE_BITS) | (s + t);
                kmin = min(kmin, key);
            }
        }
        if (kmin < rkey) {
            rkey = kmin;
            rblk = j;
        }
    }
    out_key[r] = rkey;
    out_blk[r] = rblk;
}

}  // namespace

extern "C" int brute_closest_launch(
    const void* feats, const void* tmin, const void* tmax, const void* cdet,
    const void* cud, const void* cvd, const void* ctd, int n_rays, int n_tris,
    void* out_key, void* out_blk, void* stream) {
    if (n_rays % THREADS != 0 || n_tris % TB != 0) return (int)cudaErrorInvalidValue;
    if (n_rays > 0) {
        brute_closest_kernel<<<n_rays / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint16_t*)feats, (const float*)tmin, (const float*)tmax,
            (const uint16_t*)cdet, (const uint16_t*)cud, (const uint16_t*)cvd,
            (const uint16_t*)ctd, n_tris, (int*)out_key, (int*)out_blk);
    }
    return (int)cudaGetLastError();
}
