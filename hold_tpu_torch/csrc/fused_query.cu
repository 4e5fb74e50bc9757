// Fused sampler SDF query, hand-written for Hopper (sm_90a).
//
// Replaces four Pallas kernels of hold_tpu/ops/fused_query.py, one template
// instance each:
//   <HAND, ZTAB>   fused_hand_sampler_sdf_z   (fused_query.py:484)
//   <!HAND, ZTAB>  fused_object_sampler_sdf_z (fused_query.py:520)
//   <HAND, !ZTAB>  fused_hand_sampler_sdf     (fused_query.py:389)
//   <!HAND, !ZTAB> fused_object_sampler_sdf   (fused_query.py:419)
//
// Per query point, in one pass: the world point (cam + z*dir from the
// sampler's z table, or a point buffer) -> canonical space (the hand's KNN
// blend and inverse skinning from knn_common.cuh; the object's rigid inverse
// Rinv (x - t)) -> Fourier/BARF embedding, rounded to bf16 -> the 8x256
// softplus(100x)/100 trunk with bf16 products and f32 sums, each hidden
// activation rounded to bf16 -> layer 7 in f32 -> the f32 SDF head.  Only the
// SDF (4 bytes a point) reaches device memory.
//
// Bound: the trunk, 0.97 MFLOP a point (483,584 MACs in the packed layout),
// and the 8 x 256 softplus evaluations (expf + log1pf) a point; the hand adds
// two sweeps over its 778 vertices.  A SIMT fp32 loop would take the whole
// sampler stage's budget, so the products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// Design: one CTA of 256 threads per tile of 128 points.  Threads 0..127
// warp and embed one point each (the hand's frame vertices staged in shared
// memory, as in knn.cu) and write the bf16 embedding row to shared memory.
// The trunk is row-wise, so each of the 8 warps then owns 16 rows (one MMA
// row tile) for all eight layers with no block-wide barrier: a warp loads its
// rows' input fragments into registers, which lets the layer's output
// overwrite the same shared-memory rows (one 128 x 256 bf16 buffer, no
// ping-pong), 32 output columns per pass.  Weights (0.97 MB of bf16 for the
// whole trunk) are read as MMA B fragments straight from device memory and
// stay in L1/L2; every CTA reads all of them.  Shared memory is 80 KB a CTA,
// so two CTAs fit one SM.  Not done here (a later step): wgmma, TMA, staged
// weight tiles, warp specialisation, persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knn_common.cuh"
#include "trunk_common.cuh"

namespace {

constexpr int TILE = 128;             // points per CTA
constexpr int WARPS = TILE / 16;      // each warp owns one 16-row MMA tile
constexpr int THREADS = 32 * WARPS;   // 256

struct QueryArgs {
    const float* pts;      // point buffer (B, NP, 3)             [!ZTAB]
    const float* dirs;     // ray directions (B*P, 3)             [ZTAB]
    const float* cam;      // ray origins (B*P, 3)                [ZTAB]
    const float* z;        // depth table (B, P, S)               [ZTAB]
    const float* verts;    // posed vertices (B, V, 3)            [HAND]
    const float* skin;     // skinning weights (B, V, J)          [HAND]
    const float* tfs;      // bone transforms (B, J, 4, 4)        [HAND]
    const float* tf12;     // [Rinv row-major | t] (B, 12)        [!HAND]
    const float* window;   // embedding window (E,)
    const __nv_bfloat16* wts;
    const float* fpack;
    float* out;            // sdf (B, NP)
    int NP;                // points per frame (P*S for the z table)
    int P, S;
    int V, J, K;
    int multires;
};

template <bool HAND, bool ZTAB>
__global__ void __launch_bounds__(THREADS, 2) fused_query_kernel(const QueryArgs q) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_tf[JMAX * 16];
    __nv_bfloat16* emb = reinterpret_cast<__nv_bfloat16*>(smem);  // TILE x LDE
    __nv_bfloat16* act = emb + TILE * LDE;                          // TILE x LDA
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int tile0 = blockIdx.x * TILE;

    // --- warp + embedding: one thread per point.  The hand's vertices live in
    // the activation buffer until the trunk starts.
    float4* s_verts = reinterpret_cast<float4*>(act);
    if constexpr (HAND)
        stage_frame(q.verts + (size_t)b * q.V * 3, q.tfs + (size_t)b * q.J * 16, q.V, q.J,
                    s_verts, s_tf);
    if (tid < TILE) {
        const int p = tile0 + tid;
        float xc[3] = {0.0f, 0.0f, 0.0f};
        if (p < q.NP) {
            float x[3];
            if constexpr (ZTAB) {
                const size_t ray = (size_t)b * q.P + p / q.S;
                const float z = q.z[(size_t)b * q.NP + p];
#pragma unroll
                for (int m = 0; m < 3; ++m)  // cam + z*dir, rounded as two ops (no FMA)
                    x[m] = __fadd_rn(q.cam[3 * ray + m], __fmul_rn(z, q.dirs[3 * ray + m]));
            } else {
#pragma unroll
                for (int m = 0; m < 3; ++m) x[m] = q.pts[3 * ((size_t)b * q.NP + p) + m];
            }
            if constexpr (HAND) {
                float wb[JMAX], inv[9];
                knn_blend(s_verts, q.V, q.skin + (size_t)b * q.V * q.J, q.J, q.K, x[0], x[1],
                          x[2], wb);
                inverse_skin(wb, s_tf, q.J, x[0], x[1], x[2], inv, xc);
            } else {  // Rinv (x - t), rounded op by op as the plain version
                const float* tf = q.tf12 + 12 * b;
                const float d0 = x[0] - tf[9], d1 = x[1] - tf[10], d2 = x[2] - tf[11];
#pragma unroll
                for (int i = 0; i < 3; ++i)
                    xc[i] = __fadd_rn(__fadd_rn(__fmul_rn(tf[3 * i], d0),
                                                __fmul_rn(tf[3 * i + 1], d1)),
                                      __fmul_rn(tf[3 * i + 2], d2));
            }
        }
        write_embedding(xc, q.window, q.multires, emb + tid * LDE);
    }
    __syncthreads();  // embedding rows written; the staged vertices are dead

    // --- trunk: warp w owns rows 16w .. 16w+15 through all eight layers.
    const int warp = tid >> 5, lane = tid & 31;
    __nv_bfloat16* rows = act + warp * 16 * LDA;
    const __nv_bfloat16* erows = emb + warp * 16 * LDE;
    const __nv_bfloat16* W = q.wts;
    const float* F = q.fpack;
    float rowsum[2] = {0.0f, 0.0f};
    trunk_layer<3, false, false>(erows, LDE, W + OFF_W0, EP, nullptr, nullptr, F, nullptr, rows,
                                 lane, rowsum);
    trunk_layer<16, false, false>(rows, LDA, W + OFF_W1, H, nullptr, nullptr, F + H, nullptr,
                                  rows, lane, rowsum);
    trunk_layer<16, false, false>(rows, LDA, W + OFF_W2, H, nullptr, nullptr, F + 2 * H,
                                  nullptr, rows, lane, rowsum);
    trunk_layer<16, false, false>(rows, LDA, W + OFF_W3, H, nullptr, nullptr, F + 3 * H,
                                  nullptr, rows, lane, rowsum);
    trunk_layer<16, true, false>(rows, LDA, W + OFF_W4H, H, erows, W + OFF_W4E, F + 4 * H,
                                 nullptr, rows, lane, rowsum);
    trunk_layer<16, false, false>(rows, LDA, W + OFF_W5, H, nullptr, nullptr, F + 5 * H,
                                  nullptr, rows, lane, rowsum);
    trunk_layer<16, false, false>(rows, LDA, W + OFF_W6, H, nullptr, nullptr, F + 6 * H,
                                  nullptr, rows, lane, rowsum);
    trunk_layer<16, false, true>(rows, LDA, W + OFF_W7, H, nullptr, nullptr, F + 7 * H,
                                 F + OFF_HEAD_W, rows, lane, rowsum);

    // the four lanes of a row group hold disjoint columns of the head dot
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        rowsum[0] += __shfl_xor_sync(0xffffffffu, rowsum[0], o);
        rowsum[1] += __shfl_xor_sync(0xffffffffu, rowsum[1], o);
    }
    if ((lane & 3) == 0) {
        const float hb = F[OFF_HEAD_B];
        const int p = tile0 + warp * 16 + (lane >> 2);
        if (p < q.NP) q.out[(size_t)b * q.NP + p] = rowsum[0] + hb;
        if (p + 8 < q.NP) q.out[(size_t)b * q.NP + p + 8] = rowsum[1] + hb;
    }
}

template <bool HAND, bool ZTAB>
cudaError_t launch(const QueryArgs& q, int B, void* stream) {
    if (B == 0 || q.NP == 0) return cudaSuccess;
    const size_t act_bytes = (size_t)TILE * LDA * sizeof(__nv_bfloat16);
    const size_t vert_bytes = HAND ? (size_t)q.V * sizeof(float4) : 0;
    const size_t smem = (size_t)TILE * LDE * sizeof(__nv_bfloat16) +
                        (act_bytes > vert_bytes ? act_bytes : vert_bytes);
    cudaError_t err = cudaFuncSetAttribute(fused_query_kernel<HAND, ZTAB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((q.NP + TILE - 1) / TILE, B);
    fused_query_kernel<HAND, ZTAB><<<grid, THREADS, smem, (cudaStream_t)stream>>>(q);
    return cudaGetLastError();
}

QueryArgs trunk_args(const void* window, int multires, const void* wts, const void* fpack,
                     void* out, int NP) {
    QueryArgs q = {};
    q.window = (const float*)window;
    q.multires = multires;
    q.wts = (const __nv_bfloat16*)wts;
    q.fpack = (const float*)fpack;
    q.out = (float*)out;
    q.NP = NP;
    return q;
}

}  // namespace

extern "C" {

// dirs, cam (B*P, 3), z (B, P, S), verts (B, V, 3), skin (B, V, J),
// tfs (B, J, 4, 4) -> out (B, P, S).
int hold_fused_hand_sdf_z(const void* dirs, const void* cam, const void* z, const void* verts,
                          const void* skin, const void* tfs, const void* window, const void* wts,
                          const void* fpack, void* out, int B, int P, int S, int V, int J, int K,
                          int multires, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, out, P * S);
    q.dirs = (const float*)dirs;
    q.cam = (const float*)cam;
    q.z = (const float*)z;
    q.P = P;
    q.S = S;
    q.verts = (const float*)verts;
    q.skin = (const float*)skin;
    q.tfs = (const float*)tfs;
    q.V = V;
    q.J = J;
    q.K = K;
    return launch<true, true>(q, B, stream);
}

// dirs, cam (B*P, 3), z (B, P, S), tf12 (B, 12) -> out (B, P, S).
int hold_fused_object_sdf_z(const void* dirs, const void* cam, const void* z, const void* tf12,
                            const void* window, const void* wts, const void* fpack, void* out,
                            int B, int P, int S, int multires, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, out, P * S);
    q.dirs = (const float*)dirs;
    q.cam = (const float*)cam;
    q.z = (const float*)z;
    q.P = P;
    q.S = S;
    q.tf12 = (const float*)tf12;
    return launch<false, true>(q, B, stream);
}

// pts (B, N, 3), verts (B, V, 3), skin (B, V, J), tfs (B, J, 4, 4) -> out (B, N).
int hold_fused_hand_sdf(const void* pts, const void* verts, const void* skin, const void* tfs,
                        const void* window, const void* wts, const void* fpack, void* out, int B,
                        int N, int V, int J, int K, int multires, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, out, N);
    q.pts = (const float*)pts;
    q.verts = (const float*)verts;
    q.skin = (const float*)skin;
    q.tfs = (const float*)tfs;
    q.V = V;
    q.J = J;
    q.K = K;
    return launch<true, false>(q, B, stream);
}

// pts (B, N, 3), tf12 (B, 12) -> out (B, N).
int hold_fused_object_sdf(const void* pts, const void* tf12, const void* window, const void* wts,
                          const void* fpack, void* out, int B, int N, int multires,
                          void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, out, N);
    q.pts = (const float*)pts;
    q.tf12 = (const float*)tf12;
    return launch<false, false>(q, B, stream);
}

}  // extern "C"
