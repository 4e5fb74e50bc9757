// Fused inference render query, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas kernels of hold_tpu/ops/fused_render.py, one template
// instance each:
//   <HAND>   fused_hand_render   (fused_render.py:480)
//   <!HAND>  fused_object_render (fused_render.py:514)
//
// Per world point, in one pass and with no gradient:
//   -> canonical point x_c: the hand's KNN blend vs the POSED vertices and
//      inverse skinning (knn_common.cuh), with the nearest-vertex distance
//      sqrt(min(min d2, 4)) from the same sweep; the object's Rinv (x - t);
//   -> J^-1: the hand's second KNN blend vs the CANONICAL vertices at x_c,
//      inverse of sum_j w_j R_j; the object's Rinv;
//   -> Fourier/BARF embedding, the 8x256 softplus100 trunk (trunk_common.cuh)
//      keeping each layer's sigmoid(100 a) in bf16, the f32 SDF head;
//   -> the 256-wide feature head on bf16(h7), plus its bias;
//   -> a reverse pass through the scalar head only: da7 = head_w * s7, then
//      da_{l-1} = (bf16(da_l) . W_l) * s_{l-1} down to the embedding, summing
//      the skip layer's embedding rows; d emb -> dSDF/dx_c; the normal
//      n_j = sum_i g_i J^-1[3i+j] over max(|n|, 1e-6);
//   -> the 'pose'-mode colour MLP: [x_c, n, 0..] . C0a + bf16(feat) . C0f +
//      the frame's layer-0 bias, relu, three 256x256 relu layers, 3 outputs
//      plus bias, sigmoid in f32.
// Outputs sdf, rgb, normal, nearest distance, x_c: 44 bytes a point.
//
// Bound: 1.30 M multiply-adds a point on the tensor cores (trunk forward
// 483,584 in the packed layout, reverse pass 483,328, feature head 65,536,
// colour MLP 268,288), i.e. 2.6 MFLOP; the hand adds four sweeps over its
// 778 vertices.  Input and output bytes (12 in, 44 out a point) are
// negligible beside it.
//
// Design: one CTA of 256 threads per tile of 128 points, as the fused query
// (fused_query.cu): threads 0..127 warp, invert and embed one point each;
// each of the 8 warps then owns 16 rows through every product, with its
// activations in one 16 x 256 bf16 shared buffer overwritten in place.  What
// the reverse pass needs from the forward, the eight sigmoid tiles, is 4 KB a
// point: 512 KB for a 128-point CTA, more than a CTA may hold.  A product's
// f32 output fragment has the layout of the next product's A fragment, so
// every value a lane stores for later (sigmoids, feature head, the
// embedding-gradient partial) is read back by the same lane.  Those go to a
// lane-private global scratch (600 words a lane, coalesced per warp, no
// barrier), sized for the resident CTAs only: the grid is at most two CTAs
// per SM and loops over the tiles, so the scratch (~160 MB on an H100) is
// reused and partly held in L2.  Its traffic is 4.8 KB a point each way
// beside 2.6 MFLOP.  Weights are read as MMA B fragments from device memory
// (L1/L2 resident), the reverse pass through transposed copies of the trunk
// (pack_trunk_transposed).  Not done here (a later step): wgmma, TMA, staged
// weight tiles, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "shade_common.cuh"
#include "trunk_common.cuh"

namespace {

// One point: canonical point, J^-1, nearest distance, embedding row.
template <bool HAND>
__device__ __forceinline__ void point_stage(const RenderArgs& q, int b, int p,
                                            const float4* s_vp, const float4* s_vc,
                                            const float* s_tf, float* sp, __nv_bfloat16* erow) {
    float xc[3] = {0.0f, 0.0f, 0.0f};
    float jinv[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float dist = 0.0f;
    if (p < q.N) {
        const float* x = q.pts + 3 * ((size_t)b * q.N + p);
        const float px = x[0], py = x[1], pz = x[2];
        if constexpr (HAND) {
            const float* skin = q.skin + (size_t)b * q.V * q.J;
            float wb[JMAX], inv[9];
            const float dmin = knn_blend(s_vp, q.V, skin, q.J, q.K, px, py, pz, wb);
            inverse_skin(wb, s_tf, q.J, px, py, pz, inv, xc);
            dist = sqrtf(fminf(dmin, CLAMP));
            knn_blend(s_vc, q.V, skin, q.J, q.K, xc[0], xc[1], xc[2], wb);
            blend_jacobian_inverse(wb, s_tf, q.J, jinv);
        } else {  // Rinv (x - t), rounded op by op as the plain version
            const float* tf = q.tf12 + 12 * b;
            const float d0 = px - tf[9], d1 = py - tf[10], d2 = pz - tf[11];
#pragma unroll
            for (int i = 0; i < 3; ++i)
                xc[i] = __fadd_rn(__fadd_rn(__fmul_rn(tf[3 * i], d0), __fmul_rn(tf[3 * i + 1], d1)),
                                  __fmul_rn(tf[3 * i + 2], d2));
#pragma unroll
            for (int c = 0; c < 9; ++c) jinv[c] = tf[c];
        }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) sp[d] = xc[d];
#pragma unroll
    for (int c = 0; c < 9; ++c) sp[3 + c] = jinv[c];
    sp[12] = dist;
    write_embedding(xc, q.window, q.multires, erow);
}

template <bool HAND>
__global__ void __launch_bounds__(THREADS, 2) fused_render_kernel(const RenderArgs q) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_tf[JMAX * 16];
    __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem);  // TILE x LDE
    __nv_bfloat16* act = emb + TILE * LDE;                          // TILE x LDA
    float* s_pt = reinterpret_cast<float*>(act + TILE * LDA);       // TILE x PT
    // the hand's posed and canonical vertices live in the activation buffer
    // until the trunk starts
    float4* s_vp = reinterpret_cast<float4*>(act);
    float4* s_vc = s_vp + (HAND ? q.V : 0);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    uint32_t* scr = q.scratch + ((size_t)blockIdx.x * WARPS + warp) * SCR_WORDS * 32 + lane;
    const int tiles_per_frame = (q.N + TILE - 1) / TILE;
    const int ntiles = q.B * tiles_per_frame;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int b = tile / tiles_per_frame;
        const int tile0 = (tile - b * tiles_per_frame) * TILE;
        __syncthreads();  // the previous tile is done with shared memory
        if constexpr (HAND) {
            stage_frame(q.verts + (size_t)b * q.V * 3, q.tfs + (size_t)b * q.J * 16, q.V, q.J,
                        s_vp, s_tf);
            stage_frame(q.verts_c + (size_t)b * q.V * 3, nullptr, q.V, 0, s_vc, s_tf);
        }
        if (tid < TILE)
            point_stage<HAND>(q, b, tile0 + tid, s_vp, s_vc, s_tf, s_pt + tid * PT,
                              emb + tid * LDE);
        __syncthreads();  // embedding rows written; the staged vertices are dead
        shade_rows<false>(q, b, tile0 + warp * 16, emb + warp * 16 * LDE, act + warp * 16 * LDA,
                   s_pt + warp * 16 * PT, scr, lane);
    }
}

template <bool HAND>
cudaError_t launch(const RenderArgs& q, int ctas, void* stream) {
    if (q.B == 0 || q.N == 0) return cudaSuccess;
    const size_t smem = (size_t)TILE * LDE * sizeof(__nv_bfloat16) +
                        (size_t)TILE * LDA * sizeof(__nv_bfloat16) + (size_t)TILE * PT * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fused_render_kernel<HAND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fused_render_kernel<HAND><<<ctas, THREADS, smem, (cudaStream_t)stream>>>(q);
    return cudaGetLastError();
}

RenderArgs render_args(const void* pts, const void* window, const void* wts, const void* fpack,
                       const void* wts_t, const void* cw, const void* cb, const void* fb0,
                       void* scratch, void* sdf, void* rgb, void* nrm, void* dist, void* xc, int B,
                       int N, int multires) {
    RenderArgs q = {};
    q.pts = (const float*)pts;
    q.window = (const float*)window;
    q.wts = (const __nv_bfloat16*)wts;
    q.fpack = (const float*)fpack;
    q.wts_t = (const __nv_bfloat16*)wts_t;
    q.cw = (const __nv_bfloat16*)cw;
    q.cb = (const float*)cb;
    q.fb0 = (const float*)fb0;
    q.scratch = (uint32_t*)scratch;
    q.sdf = (float*)sdf;
    q.rgb = (float*)rgb;
    q.nrm = (float*)nrm;
    q.dist = (float*)dist;
    q.xc = (float*)xc;
    q.B = B;
    q.N = N;
    q.multires = multires;
    return q;
}

}  // namespace

extern "C" {

// Words of lane scratch one CTA needs (the wrapper allocates ctas times it).
int hold_fused_render_scratch_words() { return WARPS * SCR_WORDS * 32; }

// pts (B, N, 3), verts and verts_c (B, V, 3), skin (B, V, J), tfs (B, J, 4, 4),
// fb0 (B, 256) -> sdf (B, N), rgb (B, N, 3), nrm (B, N, 3), dist (B, N), xc (B, N, 3).
int hold_fused_hand_render(const void* pts, const void* verts, const void* verts_c,
                           const void* skin, const void* tfs, const void* window, const void* wts,
                           const void* fpack, const void* wts_t, const void* cw, const void* cb,
                           const void* fb0, void* scratch, void* sdf, void* rgb, void* nrm,
                           void* dist, void* xc, int B, int N, int V, int J, int K, int multires,
                           int ctas, void* stream) {
    RenderArgs q = render_args(pts, window, wts, fpack, wts_t, cw, cb, fb0, scratch, sdf, rgb, nrm,
                               dist, xc, B, N, multires);
    q.verts = (const float*)verts;
    q.verts_c = (const float*)verts_c;
    q.skin = (const float*)skin;
    q.tfs = (const float*)tfs;
    q.V = V;
    q.J = J;
    q.K = K;
    return launch<true>(q, ctas, stream);
}

// pts (B, N, 3), tf12 (B, 12), fb0 (B, 256) -> as the hand; dist is 0.
int hold_fused_object_render(const void* pts, const void* tf12, const void* window,
                             const void* wts, const void* fpack, const void* wts_t, const void* cw,
                             const void* cb, const void* fb0, void* scratch, void* sdf, void* rgb,
                             void* nrm, void* dist, void* xc, int B, int N, int multires, int ctas,
                             void* stream) {
    RenderArgs q = render_args(pts, window, wts, fpack, wts_t, cw, cb, fb0, scratch, sdf, rgb, nrm,
                               dist, xc, B, N, multires);
    q.tf12 = (const float*)tf12;
    return launch<false>(q, ctas, stream);
}

}  // extern "C"
