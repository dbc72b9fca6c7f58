// Tile rasterizer: the per-tile reversed-Z GREATER z-buffer over binned
// triangle lists, split into work items of RASTER_CHUNK list entries.
//
// Replaces the TPU kernel `_raster_kernel` in
// gltf_renderer_tpu/ops/pallas_raster.py (entry `rasterize_tiles`, reached
// from `rasterize_device`) and computes what it computes, per pixel centre
// (x0 + col + 0.5, y0 + row + 0.5) of each 16x128 tile: the three edge
// functions and the signed area in the TPU kernel's operand order; is_back =
// area > 0 and the inside test by that sign; culling by cull_sign in
// {-1, 0, 1}, skipped for a double-sided triangle (flags & 1); inv_area =
// 1/area and l_k = e_k * inv_area; z = l0*z0 + l1*z1 + l2*z2; take = inside
// & z > zb & 0 <= z <= 1 & |area| > 1e-12, triangles in list order (the list
// is sorted stably by tile), so the winner is the largest z and, among equal
// depths, the first listed. The winner's perspective-correct barycentrics in
// the SOURCE triangle come from row columns 9-17 with the 1e-20 guard.
// Clears: depth 0, triangle -1, u = v = 0. Its plain PyTorch twin is
// `rasterize_tiles_ref` in ops/raster.py; built with -fmad=false the two
// agree bit for bit.
//
// What bounds it on an H100. The arithmetic a frame needs is small: about
// 29 f32 operations on each pixel centre inside each live (triangle, tile)
// pair's box, 0.8 M such centres on the helmet's 1080p bench view and 4.0 M
// on the courtyard's, tens of MFLOP; the bytes (setup rows, the pair list,
// four output images) are about 40-70 MB, so bytes bound it. What held the one-block-per-tile design back was neither: load
// imbalance (one tile can list thousands of triangles while most list none,
// and its block then sets the time) and edge tests on pixels that a
// triangle's box already rules out (98% of them on the bench views).
//
// The design:
// 1. Work items. A tile's list is cut into items of at most RASTER_CHUNK
//    entries, one 256-thread block each: item j < n_tiles is the head of
//    tile j (its first RASTER_CHUNK entries); item n_tiles + e takes the
//    list window [e*C, (e+1)*C) minus every tile's head. Tails (entries
//    past a head) of two tiles lie at least C entries apart, so a window
//    meets at most one tail, that of the tile holding entry e*C: one binary
//    search over the offsets finds it, and a window that meets no tail
//    exits at once. The grid, n_tiles + ceil(list_len / C), is known on the
//    host without reading the offsets.
// 2. Pixel pairs. Each staged triangle gets the rectangle of its tile's
//    pixel centres that its rejection box (3.) may contain; the block lays
//    the rectangles of its item end to end (a prefix sum) and its threads
//    take the (triangle, pixel) pairs in turn, so every lane tests a pixel
//    that the box leaves in, whatever the triangles' sizes. A pair that the
//    reference would take (inside, 0 < z <= 1) offers the 64-bit key (high
//    word the depth's bits, low word the bitwise complement of the entry's
//    list position) to its pixel by a shared-memory atomicMax. A take needs
//    0 < z <= 1, where float bits order as the values, so the largest key
//    is the reference's winner (largest z, then the first listed), whatever
//    order the pairs run in. A tile that fits one item writes its outputs
//    from the block's keys; the items of a longer tile merge their keys
//    into the wrapper's per-pixel key buffer (global atomicMax), and a
//    resolve pass turns those into outputs. A zero key gives the clears.
// 3. The rejection box. The triangle's screen box widened by m = E/256 +
//    R/2^22 pixels (E = max(width, height), R = the largest |coordinate| of
//    the box), given only to a triangle with |area| >= E^2 / 1024 (area =
//    twice the signed area, as computed) and E, R <= 2^22; any other live
//    triangle gets the whole tile, culled and degenerate ones nothing. No
//    pixel outside the box can be taken: a point outside the exact box by d
//    has a barycentric coordinate below -d/(2E), so one exact edge function
//    has the sign opposite to the area and magnitude at least d|area|/(2E)
//    >= d*k*E/2 with k ~ 2^-10 (the area test, less the area's own rounding,
//    at most 10uE^2 with u = 2^-24). Each edge function, a difference of two
//    products of rounded differences, is within 5u(|p| + |q|) <= 10uE(E + d)
//    of its exact value, and so keeps its strict sign when d > 20uE/(k -
//    20u) ~ E/817; the area keeps its sign too. Then that edge fails the
//    inclusive inside test under either winding. m exceeds E/817 by more
//    than the rounding of the widened box's coordinates (u(R + m)). The
//    rectangle is rounded outwards, so it holds every centre in the box.
// 4. Only the winner pays for barycentrics: the pairs compute edges, the
//    inside test and z; u and v are computed once a pixel, from the
//    winner's row, with the plain version's operations in its order.
//
// Launch: the clear of the merged tiles' keys, the items, the resolve
// pass: three kernels on the caller's stream, no host synchronisation. The
// key buffer is scratch the function does not need; its bytes (three
// passes over 16 KB for each merged tile) are the design's overhead.

#include <cuda_runtime.h>
#include <math.h>

#define TILE_H 16
#define TILE_W 128
#define TILE_PIX (TILE_H * TILE_W)
#define RASTER_THREADS 256
#define PIX_PER_THREAD (TILE_PIX / RASTER_THREADS)
#define RASTER_CHUNK 128
#define SETUP_WIDTH 24
#define SETUP_INT_WIDTH 8
#define REJECT_LIMIT 4194304.0f  // 2^22: largest extent and coordinate given a rejection box

static_assert(RASTER_CHUNK % 32 == 0 && RASTER_CHUNK <= RASTER_THREADS, "an item is staged by whole warps");

namespace {

// Triangles of one work item, staged once per block (structure of arrays).
struct Staged {
    float ax[RASTER_CHUNK], ay[RASTER_CHUNK], bx[RASTER_CHUNK], by[RASTER_CHUNK];
    float cx[RASTER_CHUNK], cy[RASTER_CHUNK];
    float z0[RASTER_CHUNK], z1[RASTER_CHUNK], z2[RASTER_CHUNK];
    float area[RASTER_CHUNK], inv_area[RASTER_CHUNK];
    float inv_nx[RASTER_CHUNK];  // 1 / the rectangle's width
    int c0[RASTER_CHUNK], r0[RASTER_CHUNK], nx[RASTER_CHUNK];  // rectangle, tile pixels
    int start[RASTER_CHUNK + 1];  // first pixel pair of each triangle; start[n] = all
};

// The winner's triangle id and barycentrics at pixel centre (px, py), with
// the plain version's operations in its order.
__device__ void resolve_pixel(const float* __restrict__ rows, const int* __restrict__ rows_i,
                              int slot, float px, float py, int* tri, float* u, float* v) {
    // Row columns 0-19 as five 16-byte loads (a row is 96 bytes).
    const float4* r = reinterpret_cast<const float4*>(rows + (size_t)slot * SETUP_WIDTH);
    const float4 f0 = r[0], f1 = r[1], f2 = r[2], f3 = r[3], f4 = r[4];
    const float ax = f0.x, ay = f0.y, bx = f0.z, by = f0.w, cx = f1.x, cy = f1.y;
    const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
    const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
    const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
    const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    const float inv_area = 1.0f / area;  // a winner has |area| > 1e-12
    const float l0 = e0 * inv_area;
    const float l1 = e1 * inv_area;
    const float l2 = e2 * inv_area;
    const float pw0 = l0 * f2.y;
    const float pw1 = l1 * f2.z;
    const float pw2 = l2 * f2.w;
    const float denom = pw0 + pw1 + pw2;
    const float inv_denom = fabsf(denom) > 1e-20f ? 1.0f / denom : 0.0f;
    *u = (pw0 * f3.x + pw1 * f3.z + pw2 * f4.x) * inv_denom;
    *v = (pw0 * f3.y + pw1 * f3.w + pw2 * f4.y) * inv_denom;
    *tri = rows_i[(size_t)slot * SETUP_INT_WIDTH];
}

// Outputs of this thread's PIX_PER_THREAD pixels of the tile at (x0, y0)
// (pixel threadIdx.x + k * RASTER_THREADS of the tile) from their keys;
// each step's loads are issued for all of them before they are used.
__device__ void write_pixels(const unsigned long long (&key)[PIX_PER_THREAD],
                             const float* __restrict__ rows, const int* __restrict__ rows_i,
                             const int* __restrict__ tri_list, int x0, int y0, int img_w,
                             float* __restrict__ out_z, int* __restrict__ out_tri,
                             float* __restrict__ out_u, float* __restrict__ out_v) {
    int slot[PIX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        slot[k] = key[k] != 0ull ? tri_list[(int)~(unsigned)(key[k] & 0xffffffffull)] : -1;
    }
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        const int col = x0 + p % TILE_W, row = y0 + p / TILE_W;
        int tri = -1;
        float u = 0.0f, v = 0.0f;
        if (slot[k] >= 0) {
            resolve_pixel(rows, rows_i, slot[k], (float)col + 0.5f, (float)row + 0.5f,
                          &tri, &u, &v);
        }
        const size_t o = (size_t)row * img_w + col;
        out_z[o] = __uint_as_float((unsigned)(key[k] >> 32));
        out_tri[o] = tri;
        out_u[o] = u;
        out_v[o] = v;
    }
}

// Stage list entry `pos` as triangle t of a tile whose first pixel is at
// (x0, y0): vertices, depths, area terms, and the rectangle of tile pixels
// whose centres its rejection box may hold. Returns the rectangle's size.
__device__ int stage(Staged& s, int t, int pos, const float* __restrict__ rows,
                     const int* __restrict__ rows_i, const int* __restrict__ tri_list,
                     int cull_sign, int x0, int y0) {
    const int slot = tri_list[pos];
    const float4* r = reinterpret_cast<const float4*>(rows + (size_t)slot * SETUP_WIDTH);
    const float4 f0 = r[0], f1 = r[1];
    const float ax = f0.x, ay = f0.y, bx = f0.z, by = f0.w, cx = f1.x, cy = f1.y;
    const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    const bool is_back = area > 0.0f;
    bool culled = false;
    if (cull_sign != 0) {
        const bool side = cull_sign > 0 ? is_back : !is_back;
        culled = side && (rows_i[(size_t)slot * SETUP_INT_WIDTH + 1] & 1) == 0;
    }
    int c0 = 0, c1 = -1, r0 = 0, r1 = -1;  // empty: no pixel can take it
    if (!culled && fabsf(area) > 1e-12f) {
        const float x_min = fminf(fminf(ax, bx), cx), x_max = fmaxf(fmaxf(ax, bx), cx);
        const float y_min = fminf(fminf(ay, by), cy), y_max = fmaxf(fmaxf(ay, by), cy);
        const float ext = fmaxf(x_max - x_min, y_max - y_min);
        const float reach = fmaxf(fmaxf(fabsf(x_min), fabsf(x_max)),
                                  fmaxf(fabsf(y_min), fabsf(y_max)));
        c1 = TILE_W - 1;
        r1 = TILE_H - 1;
        if (ext <= REJECT_LIMIT && reach <= REJECT_LIMIT
            && fabsf(area) >= ext * ext * (1.0f / 1024.0f)) {
            // Centre x0 + c + 0.5 lies in [x_min - m, x_max + m] only for c
            // in [lo, hi] of the exact bounds; floor / ceil of the rounded
            // bounds (off by under one unit) can only widen that range.
            const float m = ext * (1.0f / 256.0f) + reach * (1.0f / REJECT_LIMIT);
            const float fx = (float)x0 + 0.5f, fy = (float)y0 + 0.5f;
            c0 = max(c0, (int)fmaxf(floorf(x_min - m - fx), -1.0f));
            c1 = min(c1, (int)fminf(ceilf(x_max + m - fx), (float)TILE_W));
            r0 = max(r0, (int)fmaxf(floorf(y_min - m - fy), -1.0f));
            r1 = min(r1, (int)fminf(ceilf(y_max + m - fy), (float)TILE_H));
        }
    }
    const int nx = max(c1 - c0 + 1, 0), ny = max(r1 - r0 + 1, 0);
    s.ax[t] = ax; s.ay[t] = ay; s.bx[t] = bx; s.by[t] = by; s.cx[t] = cx; s.cy[t] = cy;
    s.z0[t] = f1.z; s.z1[t] = f1.w; s.z2[t] = r[2].x;
    s.area[t] = area;
    s.inv_area[t] = 1.0f / area;
    s.c0[t] = c0;
    s.r0[t] = r0;
    s.nx[t] = nx;
    s.inv_nx[t] = 1.0f / (float)max(nx, 1);
    return nx * ny;
}

// One work item: entries [lo, hi) of `tile`'s list. `merged`: the tile has
// more than one item, so its keys go to the key buffer; else the item writes
// the tile's outputs.
__device__ void run_item(Staged& s, unsigned long long* s_key, int* s_warp_sum,
                         int tile, int lo, int hi, bool merged,
                         const float* __restrict__ rows, const int* __restrict__ rows_i,
                         const int* __restrict__ tri_list, int tiles_x, int cull_sign,
                         unsigned long long* __restrict__ keys,
                         float* __restrict__ out_z, int* __restrict__ out_tri,
                         float* __restrict__ out_u, float* __restrict__ out_v) {
    const int n = hi - lo;
    const int x0 = (tile % tiles_x) * TILE_W, y0 = (tile / tiles_x) * TILE_H;
    const int img_w = tiles_x * TILE_W;
    const int lane = threadIdx.x & 31;

#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) s_key[threadIdx.x + k * RASTER_THREADS] = 0ull;
    // Stage, and lay the rectangles end to end: an inclusive prefix sum
    // over threads 0..RASTER_CHUNK-1, by warps, then the warps' totals.
    if (threadIdx.x < RASTER_CHUNK) {
        int count = threadIdx.x < n
            ? stage(s, threadIdx.x, lo + threadIdx.x, rows, rows_i, tri_list, cull_sign, x0, y0)
            : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(~0u, count, d);
            if (lane >= d) count += up;
        }
        if (lane == 31) s_warp_sum[threadIdx.x >> 5] = count;
        s.start[threadIdx.x + 1] = count;
        if (threadIdx.x == 0) s.start[0] = 0;
    }
    __syncthreads();
    if (threadIdx.x >= 32 && threadIdx.x < RASTER_CHUNK) {
        int before = 0;
        for (int w = 0; w < (threadIdx.x >> 5); ++w) before += s_warp_sum[w];
        s.start[threadIdx.x + 1] += before;
    }
    __syncthreads();

    // The item's (triangle, pixel) pairs, in turns over the block's threads.
    const int n_pairs = s.start[n];
    int t = -1, next = 0;
    float ax = 0, ay = 0, bx = 0, by = 0, cx = 0, cy = 0, z0 = 0, z1 = 0, z2 = 0;
    float inv_area = 0, inv_nx = 0;
    int first = 0, c0 = 0, r0 = 0, nx = 0;
    bool is_back = false;
    for (int q = threadIdx.x; q < n_pairs; q += RASTER_THREADS) {
        if (q >= next) {  // a new triangle for this thread
            do {
                ++t;
            } while (s.start[t + 1] <= q);
            first = s.start[t];
            next = s.start[t + 1];
            ax = s.ax[t]; ay = s.ay[t]; bx = s.bx[t]; by = s.by[t]; cx = s.cx[t]; cy = s.cy[t];
            z0 = s.z0[t]; z1 = s.z1[t]; z2 = s.z2[t];
            inv_area = s.inv_area[t];
            is_back = s.area[t] > 0.0f;
            c0 = s.c0[t]; r0 = s.r0[t]; nx = s.nx[t]; inv_nx = s.inv_nx[t];
        }
        // Row of the pair in the rectangle: (local + 0.5) / nx is at least
        // 0.5 / 128 from an integer, far more than the product's rounding.
        const int local = q - first;
        const int row = (int)(((float)local + 0.5f) * inv_nx);
        const int col = local - row * nx;
        const float px = (float)(x0 + c0 + col) + 0.5f;
        const float py = (float)(y0 + r0 + row) + 0.5f;
        const float e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
        const float e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
        const float e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
        const bool inside = is_back ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                                    : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
        const float z = e0 * inv_area * z0 + e1 * inv_area * z1 + e2 * inv_area * z2;
        if (inside && z > 0.0f && z <= 1.0f) {
            const unsigned long long key = ((unsigned long long)__float_as_uint(z) << 32)
                                           | (unsigned long long)(~(unsigned)(lo + t));
            unsigned long long* slot = s_key + (r0 + row) * TILE_W + c0 + col;
            if (key > *slot) atomicMax(slot, key);
        }
    }
    __syncthreads();

    unsigned long long key[PIX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) key[k] = s_key[threadIdx.x + k * RASTER_THREADS];
    if (!merged) {
        write_pixels(key, rows, rows_i, tri_list, x0, y0, img_w, out_z, out_tri, out_u, out_v);
        return;
    }
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        if (key[k] != 0ull) {
            atomicMax(keys + (size_t)(y0 + p / TILE_W) * img_w + x0 + p % TILE_W, key[k]);
        }
    }
}

__global__ void __launch_bounds__(RASTER_THREADS) raster_items_kernel(
    const float* __restrict__ rows,      // (T', 24) f32 setup rows
    const int* __restrict__ rows_i,      // (T', 8) i32 [id, flags, ...]
    const int* __restrict__ tri_list,    // pair list, sorted by tile
    const int* __restrict__ offsets,     // (n_tiles + 1,) CSR starts
    int n_tiles, int tiles_x, int cull_sign,
    unsigned long long* __restrict__ keys,
    float* __restrict__ out_z, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    __shared__ Staged s;
    __shared__ unsigned long long s_key[TILE_PIX];
    __shared__ int s_warp_sum[RASTER_CHUNK / 32];

    // Which tile and which entries [lo, hi) this item takes (uniform).
    const int item = blockIdx.x;
    if (item < n_tiles) {  // a tile's head
        const int lo = offsets[item], end = offsets[item + 1];
        run_item(s, s_key, s_warp_sum, item, lo, min(lo + RASTER_CHUNK, end),
                 end - lo > RASTER_CHUNK, rows, rows_i, tri_list, tiles_x, cull_sign, keys,
                 out_z, out_tri, out_u, out_v);
        return;
    }
    const int w0 = (item - n_tiles) * RASTER_CHUNK;
    if (w0 >= offsets[n_tiles]) return;
    int a = 0, b = n_tiles - 1;  // the last tile whose start is <= w0
    while (a < b) {
        const int mid = (a + b + 1) >> 1;
        if (offsets[mid] <= w0) a = mid; else b = mid - 1;
    }
    const int lo = max(w0, offsets[a] + RASTER_CHUNK);
    const int hi = min(w0 + RASTER_CHUNK, offsets[a + 1]);
    if (lo < hi) {
        run_item(s, s_key, s_warp_sum, a, lo, hi, true, rows, rows_i, tri_list, tiles_x,
                 cull_sign, keys, out_z, out_tri, out_u, out_v);
    }
}

// Zero the keys of the tiles with more than one item: only their items
// merge into the key buffer, and only the resolve pass reads it.
__global__ void __launch_bounds__(RASTER_THREADS) raster_clear_kernel(
    const int* __restrict__ offsets, int tiles_x, unsigned long long* __restrict__ keys) {
    const int tile = blockIdx.x;
    if (offsets[tile + 1] - offsets[tile] <= RASTER_CHUNK) return;
    const int img_w = tiles_x * TILE_W;
    const int x0 = (tile % tiles_x) * TILE_W, y0 = (tile / tiles_x) * TILE_H;
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        keys[(size_t)(y0 + p / TILE_W) * img_w + x0 + p % TILE_W] = 0ull;
    }
}

// Outputs of the tiles with more than one item, from their merged keys.
__global__ void __launch_bounds__(RASTER_THREADS) raster_resolve_kernel(
    const float* __restrict__ rows, const int* __restrict__ rows_i,
    const int* __restrict__ tri_list, const int* __restrict__ offsets, int tiles_x,
    const unsigned long long* __restrict__ keys,
    float* __restrict__ out_z, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v) {
    const int tile = blockIdx.x;
    if (offsets[tile + 1] - offsets[tile] <= RASTER_CHUNK) return;
    const int img_w = tiles_x * TILE_W;
    const int x0 = (tile % tiles_x) * TILE_W, y0 = (tile / tiles_x) * TILE_H;
    unsigned long long key[PIX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int p = threadIdx.x + k * RASTER_THREADS;
        key[k] = keys[(size_t)(y0 + p / TILE_W) * img_w + x0 + p % TILE_W];
    }
    write_pixels(key, rows, rows_i, tri_list, x0, y0, img_w, out_z, out_tri, out_u, out_v);
}

}  // namespace

// Version of raster_tiles_launch's argument list, for tools that launch an
// older build of this file: 2 takes the list length after the four inputs
// and the key buffer before the outputs; a library without this symbol is
// version 1, (rows, rows_i, tri_list, offsets, tiles_x, tiles_y, cull_sign,
// out_z, out_tri, out_u, out_v, stream).
extern "C" int raster_tiles_abi() { return 2; }

// keys: (tiles_y * 16) * (tiles_x * 128) 64-bit words of scratch, in any
// state: the launch clears the part it uses.
extern "C" int raster_tiles_launch(
    const void* rows, const void* rows_i, const void* tri_list, const void* offsets,
    int list_len, int tiles_x, int tiles_y, int cull_sign, void* keys,
    void* out_z, void* out_tri, void* out_u, void* out_v, void* stream) {
    const int n_tiles = tiles_x * tiles_y;
    if (n_tiles <= 0 || list_len < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    raster_clear_kernel<<<n_tiles, RASTER_THREADS, 0, st>>>(
        (const int*)offsets, tiles_x, (unsigned long long*)keys);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int items = n_tiles + (list_len + RASTER_CHUNK - 1) / RASTER_CHUNK;
    raster_items_kernel<<<items, RASTER_THREADS, 0, st>>>(
        (const float*)rows, (const int*)rows_i, (const int*)tri_list, (const int*)offsets,
        n_tiles, tiles_x, cull_sign, (unsigned long long*)keys, (float*)out_z, (int*)out_tri,
        (float*)out_u, (float*)out_v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    raster_resolve_kernel<<<n_tiles, RASTER_THREADS, 0, st>>>(
        (const float*)rows, (const int*)rows_i, (const int*)tri_list, (const int*)offsets,
        tiles_x, (const unsigned long long*)keys, (float*)out_z, (int*)out_tri,
        (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}
