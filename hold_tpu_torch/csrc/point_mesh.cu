// Minimum distance from points to a vertex set, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// hold_tpu_torch/ops/_cuda.py; launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 256;   // one point per thread
constexpr int TILE = 2048;   // vertices per shared-memory tile (32 KB)

// Replaces hold_tpu/ops/point_mesh.py min_vertex_dist_pallas
// (point_mesh.py:228).  Bound: P x V distance evaluations, ~8 FP32 ops each
// (1e9 for the object's 8192-row vertex buffer at 125,440 points): the FP32
// pipes, not memory.  Design: vertex tiles (xyz, |v|^2) pass through shared
// memory and every thread of a warp reads the same vertex (a broadcast), the
// running minimum stays in a register, and the result is
// sqrt(max(min d2, 0)) with d2 = |v|^2 + |p|^2 - 2 p.v as in the TPU kernel.
// Far-padding rows (1e4) give d2 ~ 3e8 and lose to every real vertex.
__global__ void __launch_bounds__(BLOCK)
min_vertex_dist_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                       float* __restrict__ out, int P, int V) {
    __shared__ float4 s_v[TILE];
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (p < P) {
        px = pts[3 * (size_t)p];
        py = pts[3 * (size_t)p + 1];
        pz = pts[3 * (size_t)p + 2];
    }
    const float psq = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                                __fmul_rn(pz, pz));
    float dmin = INFINITY;
    for (int base = 0; base < V; base += TILE) {
        const int n = min(TILE, V - base);
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += BLOCK) {
            const float* v = verts + 3 * (size_t)(base + i);
            const float x = v[0], y = v[1], z = v[2];
            s_v[i] = make_float4(
                x, y, z,
                __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
        }
        __syncthreads();
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
            const float4 v = s_v[i];
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(v.x, px), __fmul_rn(v.y, py)),
                                          __fmul_rn(v.z, pz));
            dmin = fminf(dmin, __fsub_rn(__fadd_rn(v.w, psq), __fmul_rn(2.0f, cross)));
        }
    }
    if (p < P) out[p] = sqrtf(fmaxf(dmin, 0.0f));
}

}  // namespace

extern "C" {

// pts (P,3), verts (V,3) -> out (P,).
int hold_min_vertex_dist(const void* pts, const void* verts, void* out, int P, int V,
                         void* stream) {
    if (P == 0) return cudaSuccess;
    min_vertex_dist_kernel<<<(P + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)verts, (float*)out, P, V);
    return cudaGetLastError();
}

}  // extern "C"
