// Fused inference render query, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas kernels of hold_tpu/ops/fused_render.py, one template
// instance each of the warp step:
//   <HAND>   fused_hand_render   (fused_render.py:480)
//   <!HAND>  fused_object_render (fused_render.py:514)
//
// Per world point, in two kernels a call and with no gradient:
//   render_warp_kernel<HAND>: -> canonical point x_c: the hand's KNN blend vs
//      the POSED vertices and inverse skinning (knn_common.cuh), with the
//      nearest-vertex distance sqrt(min(min d2, 4)) from the same sweep; the
//      object's Rinv (x - t), rounded op by op; -> J^-1: the hand's second KNN
//      blend vs the CANONICAL vertices at x_c, inverse of sum_j w_j R_j; the
//      object's Rinv.  x_c and the distance go to the outputs, J^-1 to a
//      buffer: 52 bytes a point, which stay in L2;
//   render_shade_kernel: the training shade's forward at those points
//      (shade_common.cuh, shade::run<false>), the normal over max(|n|, 1e-6):
//      sdf, rgb and normal.
// Outputs sdf, rgb, normal, nearest distance, x_c: 44 bytes a point.
//
// Bound: 1.25 M multiply-adds a point on the tensor cores (RENDER_MACS:
// trunk and head, the reverse pass, the feature head, the colour MLP), i.e.
// 2.5 MFLOP; the hand adds two neighbour searches over its 778 vertices.  Input and
// output bytes (12 in, 44 out a point) are negligible beside it; the shade's
// sigmoid scratch is not (shade_common.cuh).
//
// Design: the two halves want opposite shapes, as in the fused query.  The
// warp step is latency-bound scalar work that wants many resident warps: one
// CTA of 128 threads per 128 points of a frame, one point a thread, the
// frame's posed, then its canonical vertices staged in shared memory in tiles
// with their boxes beside the warps' candidate queues (29 KB for MANO's 778,
// so several CTAs share an SM; knn_common.cuh).  The shade wants the whole SM:
// a persistent grid of one CTA an SM, two consumer warpgroups on wgmma, the
// weights staged once a tile by cp.async.bulk (shade_common.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "shade_common.cuh"
#include "trunk_common.cuh"

namespace {

constexpr int WARP_THREADS = 128;  // points a CTA of the warp step

struct WarpArgs {
    const float* pts;      // (B, N, 3)
    const float* verts;    // posed vertices (B, V, 3)       [HAND]
    const float* verts_c;  // canonical vertices (B, V, 3)   [HAND]
    const float* skin;     // skinning weights (B, V, J)     [HAND]
    const float* tfs;      // bone transforms (B, J, 4, 4)   [HAND]
    const int* order;      // the vertices' tile order (V,) [HAND]
    unsigned long long* stats;  // the search's counters or null [HAND]
    const float* tf12;     // [Rinv row-major | t] (B, 12)   [!HAND]
    float* xc;             // (B, N, 3)
    float* jinv;           // (B, N, 9) row-major
    float* dist;           // (B, N)
    int N, V, J, K;
};

// One point a thread: canonical point, J^-1, nearest distance.  The hand
// stages its posed vertices, searches them for every point, then stages its
// canonical vertices in the same place and searches them at x_c: one set in
// shared memory at a time.  A lane past the last point searches a copy of
// the last one (the search is warp-wide) and writes nothing.
template <bool HAND>
__global__ void __launch_bounds__(WARP_THREADS) render_warp_kernel(const WarpArgs q) {
    extern __shared__ __align__(16) unsigned char warp_smem[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    const int p = blockIdx.x * WARP_THREADS + threadIdx.x;
    const size_t i = (size_t)b * q.N + min(p, q.N - 1);
    const float px = q.pts[3 * i], py = q.pts[3 * i + 1], pz = q.pts[3 * i + 2];
    float xc[3], jinv[9];
    float dist = 0.0f;
    if constexpr (HAND) {
        stage_tfs(q.tfs + (size_t)b * q.J * 16, q.J, s_tf);
        const float* skin = q.skin + (size_t)b * q.V * q.J;
        float x[3] = {px, py, pz};
        // the blend vs the posed vertices, then vs the canonical ones at x_c:
        // one loop, so that the search's code and registers exist once
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
            if (pass) __syncthreads();  // every warp is done with the posed set
            const VertexSet set = stage_set((pass ? q.verts_c : q.verts) + (size_t)b * q.V * 3,
                                            q.order, q.V, set_base(warp_smem));
            float wb[JMAX];
            const float dmin = knn_blend(set, warp_queue(warp_smem), skin, q.J, q.K, x[0], x[1],
                                         x[2], p < q.N, wb, q.stats);
            if (pass == 0) {
                float inv[9];
                inverse_skin(wb, s_tf, q.J, x[0], x[1], x[2], inv, xc);
                dist = sqrtf(fminf(dmin, CLAMP));
#pragma unroll
                for (int d = 0; d < 3; ++d) x[d] = xc[d];
            } else {
                blend_jacobian_inverse(wb, s_tf, q.J, jinv);
            }
        }
    } else {  // Rinv (x - t), rounded op by op as the plain version
        const float* tf = q.tf12 + 12 * b;
        const float d0 = px - tf[9], d1 = py - tf[10], d2 = pz - tf[11];
#pragma unroll
        for (int r = 0; r < 3; ++r)
            xc[r] = __fadd_rn(__fadd_rn(__fmul_rn(tf[3 * r], d0), __fmul_rn(tf[3 * r + 1], d1)),
                              __fmul_rn(tf[3 * r + 2], d2));
#pragma unroll
        for (int c = 0; c < 9; ++c) jinv[c] = tf[c];
    }
    if (p >= q.N) return;
#pragma unroll
    for (int d = 0; d < 3; ++d) q.xc[3 * i + d] = xc[d];
#pragma unroll
    for (int c = 0; c < 9; ++c) q.jinv[9 * i + c] = jinv[c];
    q.dist[i] = dist;
}

__global__ void __launch_bounds__(shade::THREADS, 1) render_shade_kernel(const shade::Args q) {
    shade::run<false>(q);
}

// the warp step, then the shade on its outputs
template <bool HAND>
cudaError_t launch(const WarpArgs& w, shade::Args s, int B, int ctas, cudaStream_t stream) {
    if (B == 0 || w.N == 0) return cudaSuccess;
    const int vert_bytes = HAND ? (int)search_smem(w.V) : 0;
    cudaError_t err = cudaFuncSetAttribute(render_warp_kernel<HAND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, vert_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((w.N + WARP_THREADS - 1) / WARP_THREADS, B);
    render_warp_kernel<HAND><<<grid, WARP_THREADS, vert_bytes, stream>>>(w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s.xc = w.xc;
    s.jinv = w.jinv;
    return shade::launch(render_shade_kernel, s, ctas, stream);
}

shade::Args shade_args(const void* window, const void* slabs, const void* fpack, const void* cb,
                       const void* fb0, void* scratch, void* sdf, void* rgb, void* nrm, int B,
                       int N, int multires) {
    shade::Args q = {};
    q.window = (const float*)window;
    q.slabs = (const __nv_bfloat16*)slabs;
    q.F = (const float*)fpack;
    q.CB = (const float*)cb;
    q.fb0 = (const float*)fb0;
    q.scratch = (uint4*)scratch;
    q.sdf = (float*)sdf;
    q.rgb = (float*)rgb;
    q.nrm = (float*)nrm;
    q.total = B * N;
    q.N = N;
    q.multires = multires;
    return q;
}

WarpArgs warp_args(const void* pts, void* jinv, void* dist, void* xc, int N) {
    WarpArgs w = {};
    w.pts = (const float*)pts;
    w.jinv = (float*)jinv;
    w.dist = (float*)dist;
    w.xc = (float*)xc;
    w.N = N;
    return w;
}

}  // namespace

extern "C" {

// Words of scratch one shade CTA needs (the wrapper allocates ctas times it).
int hold_fused_render_scratch_words() { return shade::SCRATCH_WORDS; }

// pts (B, N, 3), verts and verts_c (B, V, 3), skin (B, V, J), tfs (B, J, 4, 4),
// order (V,) int32, fb0 (B, 256) -> sdf (B, N), rgb (B, N, 3),
// nrm (B, N, 3), dist (B, N), xc (B, N, 3); stats null or the search's four
// counters (knn_common.cuh).
// slabs: the forward's weight stream; jinv: a (B, N, 9) f32 buffer.
int hold_fused_hand_render(const void* pts, const void* verts, const void* verts_c,
                           const void* skin, const void* tfs, const void* order,
                           const void* window, const void* slabs, const void* fpack,
                           const void* cb, const void* fb0, void* jinv, void* scratch, void* sdf,
                           void* rgb, void* nrm, void* dist, void* xc, int B, int N, int V, int J,
                           int K, int multires, int ctas, void* stats, void* stream) {
    WarpArgs w = warp_args(pts, jinv, dist, xc, N);
    w.verts = (const float*)verts;
    w.verts_c = (const float*)verts_c;
    w.skin = (const float*)skin;
    w.tfs = (const float*)tfs;
    w.order = (const int*)order;
    w.stats = (unsigned long long*)stats;
    w.V = V;
    w.J = J;
    w.K = K;
    return launch<true>(w, shade_args(window, slabs, fpack, cb, fb0, scratch, sdf, rgb, nrm, B, N,
                                      multires),
                        B, ctas, (cudaStream_t)stream);
}

// pts (B, N, 3), tf12 (B, 12), fb0 (B, 256) -> as the hand; dist is 0.
int hold_fused_object_render(const void* pts, const void* tf12, const void* window,
                             const void* slabs, const void* fpack, const void* cb, const void* fb0,
                             void* jinv, void* scratch, void* sdf, void* rgb, void* nrm,
                             void* dist, void* xc, int B, int N, int multires, int ctas,
                             void* stream) {
    WarpArgs w = warp_args(pts, jinv, dist, xc, N);
    w.tf12 = (const float*)tf12;
    return launch<false>(w, shade_args(window, slabs, fpack, cb, fb0, scratch, sdf, rgb, nrm, B,
                                       N, multires),
                         B, ctas, (cudaStream_t)stream);
}

}  // extern "C"
