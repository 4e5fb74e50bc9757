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

namespace {

constexpr int TILE = 128;             // points per CTA
constexpr int WARPS = TILE / 16;      // each warp owns one 16-row MMA tile
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int H = 256;                // trunk width
constexpr int EP = 48;                // embedding columns multiplied (3 k-steps)
constexpr int LDA = H + 8;            // activation row stride (bf16), 4-bank skew
constexpr int LDE = EP + 8;           // embedding row stride (bf16)
constexpr int NCHUNK = 32;            // output columns per MMA pass

// Packed bf16 trunk (ops/fused_query.py pack_trunk_weights), every matrix
// (out, in) row-major: exactly the "col" B operand of mma.sync.
constexpr int OFF_W0 = 0;                   // 256 x 48, columns >= E zero
constexpr int OFF_W1 = OFF_W0 + H * EP;
constexpr int OFF_W2 = OFF_W1 + H * H;
constexpr int OFF_W3 = OFF_W2 + H * H;      // rows >= 256 - E zero
constexpr int OFF_W4H = OFF_W3 + H * H;     // / sqrt(2), columns >= 256 - E zero
constexpr int OFF_W4E = OFF_W4H + H * H;    // 256 x 48, / sqrt(2)
constexpr int OFF_W5 = OFF_W4E + H * EP;
constexpr int OFF_W6 = OFF_W5 + H * H;
constexpr int OFF_W7 = OFF_W6 + H * H;
// f32 pack: bias (8 x 256) | head row (256) | head bias (1)
constexpr int OFF_HEAD_W = 8 * H;
constexpr int OFF_HEAD_B = OFF_HEAD_W + H;

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

__device__ __forceinline__ float softplus100(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(100.0f * x))) / 100.0f;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of a warp's 16 rows (row stride ld), KS k-steps of 16 columns.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns 2t, 2t+1
// and 2t+8, 2t+9 of each k-step.
template <int KS>
__device__ __forceinline__ void load_a(const __nv_bfloat16* rows, int ld, int lane,
                                       uint32_t (&a)[KS][4]) {
    const __nv_bfloat16* r0 = rows + (lane >> 2) * ld + 2 * (lane & 3);
    const __nv_bfloat16* r8 = r0 + 8 * ld;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        a[ks][0] = lds32(r0 + 16 * ks);
        a[ks][1] = lds32(r8 + 16 * ks);
        a[ks][2] = lds32(r0 + 16 * ks + 8);
        a[ks][3] = lds32(r8 + 16 * ks + 8);
    }
}

// acc[nt] += A . W[n0 + 8 nt + (0..7), 0 .. 16 KS)^T, nt = 0..3.
template <int KS>
__device__ __forceinline__ void mma_pass(float (&acc)[4][4], const uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* __restrict__ W, int ldw, int n0,
                                         int lane) {
    const __nv_bfloat16* wl = W + (size_t)(n0 + (lane >> 2)) * ldw + 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* w = wl + (size_t)(8 * nt) * ldw + 16 * ks;
            mma_bf16(acc[nt], a[ks], ldg32(w), ldg32(w + 8));
        }
    }
}

// One trunk layer on a warp's 16 rows: softplus100(src . W^T [+ emb . We^T]
// + b).  The input fragments are in registers before any lane writes, so dst
// may be the source rows.  Hidden layers write bf16 to dst; the LAST layer
// keeps f32 and adds its dot with the head row into rowsum (rows g, g + 8).
template <int KS, bool SKIP, bool LAST>
__device__ __forceinline__ void trunk_layer(const __nv_bfloat16* src, int lds,
                                            const __nv_bfloat16* __restrict__ W, int ldw,
                                            const __nv_bfloat16* emb,
                                            const __nv_bfloat16* __restrict__ We,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ head_w,
                                            __nv_bfloat16* dst, int lane, float (&rowsum)[2]) {
    uint32_t a[KS][4];
    load_a<KS>(src, lds, lane, a);
    uint32_t ae[SKIP ? 3 : 1][4];
    if constexpr (SKIP) load_a<3>(emb, LDE, lane, ae);
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
    for (int n0 = 0; n0 < H; n0 += NCHUNK) {
        float acc[4][4] = {};
        mma_pass<KS>(acc, a, W, ldw, n0, lane);
        if constexpr (SKIP) mma_pass<3>(acc, ae, We, EP, n0, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + 8 * nt + 2 * t;
            const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
            const float v00 = softplus100(acc[nt][0] + b0);
            const float v01 = softplus100(acc[nt][1] + b1);
            const float v10 = softplus100(acc[nt][2] + b0);
            const float v11 = softplus100(acc[nt][3] + b1);
            if constexpr (LAST) {
                const float h0 = __ldg(head_w + col), h1 = __ldg(head_w + col + 1);
                rowsum[0] += v00 * h0 + v01 * h1;
                rowsum[1] += v10 * h0 + v11 * h1;
            } else {
                *reinterpret_cast<__nv_bfloat162*>(dst + g * LDA + col) =
                    __floats2bfloat162_rn(v00, v01);
                *reinterpret_cast<__nv_bfloat162*>(dst + (g + 8) * LDA + col) =
                    __floats2bfloat162_rn(v10, v11);
            }
        }
    }
    __syncwarp();
}

// [x | sin(2^k x), cos(2^k x) for k < multires] * window, rounded to bf16;
// columns E..EP-1 zero.  Full-precision sinf/cosf: arguments reach 2^5 |x|.
__device__ __forceinline__ void write_embedding(const float* xc, const float* __restrict__ window,
                                                int multires, __nv_bfloat16* row) {
#pragma unroll
    for (int d = 0; d < 3; ++d) row[d] = __float2bfloat16_rn(xc[d] * __ldg(window + d));
    int c = 3;
    for (int k = 0; k < multires; ++k) {
        const float f = (float)(1 << k);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const float arg = xc[d] * f;
            row[c + d] = __float2bfloat16_rn(sinf(arg) * __ldg(window + c + d));
            row[c + 3 + d] = __float2bfloat16_rn(cosf(arg) * __ldg(window + c + 3 + d));
        }
        c += 6;
    }
    for (; c < EP; ++c) row[c] = __float2bfloat16_rn(0.0f);
}

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
