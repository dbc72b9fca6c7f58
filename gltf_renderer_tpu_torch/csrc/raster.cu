// Tile rasterizer: one CTA per 16x128 screen tile walks the tile's binned
// triangle list and keeps a reversed-Z GREATER z-buffer.
//
// Replaces the TPU kernel `_raster_kernel` in
// gltf_renderer_tpu/ops/pallas_raster.py (entry `rasterize_tiles`, reached
// from `rasterize_device`) and computes what it computes, per pixel centre
// (x0 + col + 0.5, y0 + row + 0.5): the three edge functions and the signed
// area in the TPU kernel's operand order; is_back = area > 0 and the inside
// test by that sign; culling by cull_sign in {-1, 0, 1}, skipped for a
// double-sided triangle (flags & 1); inv_area = 1/area guarded at 1e-12 and
// l_k = e_k * inv_area; z = l0*z0 + l1*z1 + l2*z2; perspective-correct
// barycentrics of the SOURCE triangle from row columns 12-17 with the 1e-20
// guard; take = inside & z > zb & 0 <= z <= 1 & |area| > 1e-12. Clears: depth
// 0, triangle -1, u = v = 0. Triangles are tested in list order (the list is
// sorted stably by tile), so with the strict > the first of equal depths
// wins. Its plain PyTorch twin is `rasterize_tiles_ref` in ops/raster.py;
// built with -fmad=false the two agree bit for bit.
//
// What bounds it on an H100: operations. Each (triangle, tile) pair costs
// about 41 f32 operations for each of the tile's 2,048 pixels, while the
// bytes are small (setup rows, the pair list and four output images, a few
// tens of MB at 1080p). The design: every thread owns 8 pixels of its CTA's
// tile and keeps their depth, triangle and barycentrics in registers for
// the whole list; the tile's triangle rows (18 f32 + id + flags) are staged
// through shared memory in batches of RASTER_BATCH, so each row is read from
// L2 once per CTA and then broadcast to all threads; the per-triangle terms
// (area, its reciprocal, the cull decision) are computed once per thread and
// culled or degenerate triangles are skipped whole; outputs are written
// straight into the (tiles_y*16, tiles_x*128) image, coalesced along rows.
//
// Left for later work: the 16x128 tile is the TPU's register block (kept so
// pair lists agree exactly with the JAX package); smaller tiles would waste
// fewer edge tests on pixels outside a triangle's box, and tiles with long
// lists dominate the run time (load imbalance). The TPU kernel's compact-tile
// scatter, TRI_BATCH tail re-test and SMEM/VMEM list split are TPU layouts
// and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_H 16
#define TILE_W 128
#define TILE_PIX (TILE_H * TILE_W)
#define RASTER_THREADS 256
#define PIX_PER_THREAD (TILE_PIX / RASTER_THREADS)
#define RASTER_BATCH 128
#define SETUP_WIDTH 24
#define SETUP_INT_WIDTH 8
#define STAGED_F 18
#define STAGED_I 2

namespace {

__global__ void __launch_bounds__(RASTER_THREADS) raster_tiles_kernel(
    const float* __restrict__ rows,      // (T', 24) f32 setup rows
    const int* __restrict__ rows_i,      // (T', 8) i32 [id, flags, ...]
    const int* __restrict__ tri_list,    // pair list, sorted by tile
    const int* __restrict__ offsets,     // (n_tiles + 1,) CSR starts
    int tiles_x, int cull_sign,
    float* __restrict__ out_z, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ float s_f[RASTER_BATCH * STAGED_F];
    __shared__ int s_i[RASTER_BATCH * STAGED_I];

    const int tile = blockIdx.x;
    const int tile_x = tile % tiles_x;
    const int tile_y = tile / tiles_x;
    const float x0 = (float)(tile_x * TILE_W);
    const float y0 = (float)(tile_y * TILE_H);
    const int start = offsets[tile];
    const int count = offsets[tile + 1] - start;

    float px[PIX_PER_THREAD], py[PIX_PER_THREAD];
    float zb[PIX_PER_THREAD], ub[PIX_PER_THREAD], vb[PIX_PER_THREAD];
    int tb[PIX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        px[k] = x0 + (float)(p % TILE_W) + 0.5f;
        py[k] = y0 + (float)(p / TILE_W) + 0.5f;
        zb[k] = 0.0f;
        ub[k] = 0.0f;
        vb[k] = 0.0f;
        tb[k] = -1;
    }

    for (int b0 = 0; b0 < count; b0 += RASTER_BATCH) {
        const int nb = min(RASTER_BATCH, count - b0);
        __syncthreads();  // the previous batch has been consumed
        for (int idx = threadIdx.x; idx < nb * (STAGED_F + STAGED_I); idx += RASTER_THREADS) {
            const int t = idx / (STAGED_F + STAGED_I);
            const int c = idx % (STAGED_F + STAGED_I);
            const int slot = tri_list[start + b0 + t];
            if (c < STAGED_F) {
                s_f[t * STAGED_F + c] = rows[(size_t)slot * SETUP_WIDTH + c];
            } else {
                s_i[t * STAGED_I + (c - STAGED_F)] =
                    rows_i[(size_t)slot * SETUP_INT_WIDTH + (c - STAGED_F)];
            }
        }
        __syncthreads();

        for (int t = 0; t < nb; ++t) {
            const float* r = s_f + t * STAGED_F;
            const float ax = r[0], ay = r[1], bx = r[2], by = r[3], cx = r[4], cy = r[5];
            const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
            const bool is_back = area > 0.0f;
            const bool area_ok = fabsf(area) > 1e-12f;
            bool culled = false;
            if (cull_sign != 0) {
                const bool side = cull_sign > 0 ? is_back : !is_back;
                culled = side && (s_i[t * STAGED_I + 1] & 1) == 0;
            }
            // No pixel can take a culled or degenerate triangle.
            if (culled || !area_ok) continue;
            const float inv_area = 1.0f / area;
            const float z0 = r[6], z1 = r[7], z2 = r[8];
            const float iw0 = r[9], iw1 = r[10], iw2 = r[11];
            const float u0 = r[12], v0 = r[13], u1 = r[14], v1 = r[15], u2 = r[16], v2 = r[17];
            const int word = s_i[t * STAGED_I];
#pragma unroll
            for (int k = 0; k < PIX_PER_THREAD; ++k) {
                const float e0 = (cx - bx) * (py[k] - by) - (cy - by) * (px[k] - bx);
                const float e1 = (ax - cx) * (py[k] - cy) - (ay - cy) * (px[k] - cx);
                const float e2 = (bx - ax) * (py[k] - ay) - (by - ay) * (px[k] - ax);
                const bool inside = is_back ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                                            : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
                const float l0 = e0 * inv_area;
                const float l1 = e1 * inv_area;
                const float l2 = e2 * inv_area;
                const float z = l0 * z0 + l1 * z1 + l2 * z2;
                if (!(inside && z > zb[k] && z <= 1.0f && z >= 0.0f)) continue;
                const float pw0 = l0 * iw0;
                const float pw1 = l1 * iw1;
                const float pw2 = l2 * iw2;
                const float denom = pw0 + pw1 + pw2;
                const float inv_denom = fabsf(denom) > 1e-20f ? 1.0f / denom : 0.0f;
                zb[k] = z;
                tb[k] = word;
                ub[k] = (pw0 * u0 + pw1 * u1 + pw2 * u2) * inv_denom;
                vb[k] = (pw0 * v0 + pw1 * v1 + pw2 * v2) * inv_denom;
            }
        }
    }

    const int img_w = tiles_x * TILE_W;
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        const size_t o = (size_t)(tile_y * TILE_H + p / TILE_W) * img_w
                         + tile_x * TILE_W + p % TILE_W;
        out_z[o] = zb[k];
        out_tri[o] = tb[k];
        out_u[o] = ub[k];
        out_v[o] = vb[k];
    }
}

}  // namespace

extern "C" int raster_tiles_launch(
    const void* rows, const void* rows_i, const void* tri_list, const void* offsets,
    int tiles_x, int tiles_y, int cull_sign,
    void* out_z, void* out_tri, void* out_u, void* out_v, void* stream) {
    const int n_tiles = tiles_x * tiles_y;
    if (n_tiles > 0) {
        raster_tiles_kernel<<<n_tiles, RASTER_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)rows, (const int*)rows_i, (const int*)tri_list,
            (const int*)offsets, tiles_x, cull_sign, (float*)out_z, (int*)out_tri,
            (float*)out_u, (float*)out_v);
    }
    return (int)cudaGetLastError();
}
