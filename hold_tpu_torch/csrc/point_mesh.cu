// Minimum distance from points to a vertex set, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// hold_tpu_torch/ops/_cuda.py; launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "knn_common.cuh"

namespace {

constexpr int BLOCK = 128;            // four warps
constexpr int PPT = 4;                // points a thread
constexpr int WARP_PTS = 32 * PPT;    // a warp's points: base + lane + 32 i
constexpr int CHUNK = 2048;           // vertices staged a round (34 KB with the boxes)

// Replaces hold_tpu/ops/point_mesh.py min_vertex_dist_pallas
// (point_mesh.py:228).  The result is sqrt(max(min d2, 0)) with d2 =
// (|v|^2 + |p|^2) - 2 p.v rounded op by op as ops/point_mesh.py
// min_vertex_dist (knn_common.cuh sqdist_raw, the factor 2 folded into the
// point), so it equals the plain version bit for bit.
//
// Bound: by brute force P x V distance evaluations, 8 f32 instructions each
// (no FMA in the exact order), 1e9 pairs at 125,440 points and the object's
// 8,192-row buffer; skipping work is the only way far below that.  Design:
// - each thread holds 4 points, so each vertex read from shared memory feeds
//   four pairs; a warp's 128 points are consecutive samples of one or two
//   rays and lie in a small box;
// - the buffer passes through shared memory in chunks of 2,048 vertices, in
//   tiles of 32 in `order` (the hand's subdivided mesh in a spatial order
//   made once a scene, the object's buffer as it lies), each tile with its
//   box (knn_common.cuh stage_set);
// - a warp visits its chunk's tile nearest to the centre of its points' box
//   first, so that every point has a running minimum; then it tests 32 tiles
//   at once, one a lane, box against box with the warp's largest minimum
//   (a ballot), and each tile that passes point by point against each
//   point's minimum (tile_far, with knn_common.cuh's rounding margin): a tile
//   is skipped only when it cannot lower any of the warp's 128 minima.  The
//   object's far-padding rows (1e4) go as soon as one real tile has set the
//   minima;
// - a tile whose box is a single point (every vertex equal, as in the
//   all-padding empty object state) is one evaluation.
__global__ void __launch_bounds__(BLOCK)
min_vertex_dist_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                       const int* __restrict__ order, float* __restrict__ out, int P, int V,
                       unsigned long long* stats) {
    __shared__ float4 s_set[set_float4s(CHUNK)];
    const int lane = threadIdx.x & 31;
    const int base = (blockIdx.x * (BLOCK / 32) + (threadIdx.x >> 5)) * WARP_PTS + lane;
    float qx[PPT], qy[PPT], qz[PPT], psq[PPT], dmin[PPT];
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    float psq_max = 0.0f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const size_t p = min(base + 32 * i, P - 1);
        const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
        qx[i] = 2.0f * x;
        qy[i] = 2.0f * y;
        qz[i] = 2.0f * z;
        psq[i] = sq3(x, y, z);
        psq_max = fmaxf(psq_max, psq[i]);
        dmin[i] = INFINITY;
        lo[0] = fminf(lo[0], x), lo[1] = fminf(lo[1], y), lo[2] = fminf(lo[2], z);
        hi[0] = fmaxf(hi[0], x), hi[1] = fmaxf(hi[1], y), hi[2] = fmaxf(hi[2], z);
    }
    // the warp's box and the centre the nearest tile is measured from
    float c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        lo[d] = warp_min(lo[d]);
        hi[d] = warp_max(hi[d]);
        c[d] = 0.5f * (lo[d] + hi[d]);
    }
    psq_max = warp_max(psq_max);
    int visited = 0, culled = 0;

    for (int c0 = 0; c0 < V; c0 += CHUNK) {
        const int n = min(CHUNK, V - c0);
        __syncthreads();  // every warp is done with the previous chunk
        const VertexSet set = stage_set(verts, order + c0, n, s_set);
        const int nt = set_tiles(n);
        // the chunk's tile nearest to the warp's centre
        float key = INFINITY;
        int first = 0;
        for (int t = lane; t < nt; t += 32) {
            const float4 a = set.box[2 * t], b = set.box[2 * t + 1];
            const float gx = gap(a.x, b.x, c[0]), gy = gap(a.y, b.y, c[1]),
                        gz = gap(a.z, b.z, c[2]);
            const float k = gx * gx + gy * gy + gz * gz;
            if (k < key) {
                key = k;
                first = t;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ok = __shfl_xor_sync(FULL, key, off);
            const int ot = __shfl_xor_sync(FULL, first, off);
            if (ok < key || (ok == key && ot < first)) {
                key = ok;
                first = ot;
            }
        }
        // the nearest tile, then the chunk's tiles 32 at a time
        for (int g = -32; g < nt; g += 32) {
            unsigned todo;
            if (g < 0) {
                todo = 1u;
            } else {
                // box against box: the warp's points against tile g + lane,
                // with the largest of the warp's minima
                float thr = 0.0f;
#pragma unroll
                for (int i = 0; i < PPT; ++i) thr = fmaxf(thr, fmaxf(dmin[i], 0.0f));
                thr = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(thr)));
                const int t = g + lane;
                bool near = false;
                if (t < nt && t != first) {
                    const float4 a = set.box[2 * t], b = set.box[2 * t + 1];
                    const float gx = fmaxf(fmaxf(a.x - hi[0], lo[0] - b.x), 0.0f);
                    const float gy = fmaxf(fmaxf(a.y - hi[1], lo[1] - b.y), 0.0f);
                    const float gz = fmaxf(fmaxf(a.z - hi[2], lo[2] - b.z), 0.0f);
                    const float L = gx * gx + gy * gy + gz * gz;
                    near = !(L > thr + MARGIN * ((a.w + psq_max) + thr));
                }
                todo = __ballot_sync(FULL, near);
                culled += min(32, nt - g) - (g <= first && first < g + 32) - __popc(todo);
            }
            while (todo != 0u) {
                const int t = g < 0 ? first : g + __ffs(todo) - 1;
                todo &= todo - 1u;
                const float4 a = set.box[2 * t], b = set.box[2 * t + 1];
                bool far = true;
#pragma unroll
                for (int i = 0; i < PPT; ++i)
                    far = far && tile_far(a, b, 0.5f * qx[i], 0.5f * qy[i], 0.5f * qz[i], psq[i],
                                          fmaxf(dmin[i], 0.0f));
                if (__all_sync(FULL, far)) {
                    ++culled;
                    continue;
                }
                ++visited;
                const int s0 = TILE_V * t;
                const int nv = (a.x == b.x && a.y == b.y && a.z == b.z) ? 1 : min(TILE_V, n - s0);
#pragma unroll 4
                for (int s = s0; s < s0 + nv; ++s) {
                    const float4 v = set.v[s];
#pragma unroll
                    for (int i = 0; i < PPT; ++i)
                        dmin[i] = fminf(dmin[i], sqdist_raw(v, qx[i], qy[i], qz[i], psq[i]));
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i)
        if (base + 32 * i < P) out[base + 32 * i] = sqrtf(fmaxf(dmin[i], 0.0f));
    if (stats != nullptr && lane == 0 && base < P) {
        atomicAdd(stats, (unsigned long long)min(WARP_PTS, P - base));
        atomicAdd(stats + 2, (unsigned long long)visited);
        atomicAdd(stats + 3, (unsigned long long)culled);
    }
}

}  // namespace

extern "C" {

// pts (P,3), verts (V,3), order (V,) int32 -> out (P,).
int hold_min_vertex_dist(const void* pts, const void* verts, const void* order, void* out, int P,
                         int V, void* stats, void* stream) {
    if (P == 0) return cudaSuccess;
    const int grid = (P + BLOCK * PPT - 1) / (BLOCK * PPT);
    min_vertex_dist_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)verts, (const int*)order, (float*)out, P, V,
        (unsigned long long*)stats);
    return cudaGetLastError();
}

}  // extern "C"
