// Fused sampler SDF query, hand-written for Hopper (sm_90a).
//
// Replaces four Pallas kernels of hold_tpu/ops/fused_query.py, one template
// instance each:
//   <HAND, ZTAB>   fused_hand_sampler_sdf_z   (fused_query.py:484)
//   <!HAND, ZTAB>  fused_object_sampler_sdf_z (fused_query.py:520)
//   <HAND, !ZTAB>  fused_hand_sampler_sdf     (fused_query.py:389)
//   <!HAND, !ZTAB> fused_object_sampler_sdf   (fused_query.py:419)
//
// Each in two trunk instances: query_trunk_kernel<false> is the TPU kernel's
// default, query_trunk_kernel<true> its relu=True form (HOLD_SAMPLER_RELU,
// fused_query.py:159-202): the seven hidden layers take relu in place of
// softplus100, layer 7 (into the head) keeps softplus100.
//
// Per query point, in one pass: the world point (cam + z*dir from the
// sampler's z table, or a point buffer) -> canonical space (the hand's KNN
// blend and inverse skinning from knn_common.cuh; the object's rigid inverse
// Rinv (x - t)) -> Fourier/BARF embedding, rounded to bf16 -> the 8x256
// softplus(100x)/100 trunk with bf16 products and f32 sums, each hidden
// activation rounded to bf16 -> layer 7 in f32 -> the f32 SDF head.  Only the
// SDF (4 bytes a point) reaches device memory.
//
// Bound: operations.  The trunk is 0.97 MFLOP a point (483,584 MACs in the
// packed layout); its 8 x 256 softplus evaluations a point cost more
// instruction slots than the products cost tensor time, and the hand adds the
// neighbour search over its 778 vertices (knn_common.cuh: one sweep over
// the tiles near a warp's points).  What held the earlier per-warp kernel back
// was none of these: every warp pulled the whole 0.97 MB of weights through
// L1/L2 as 4-byte mma.sync fragments.
//
// Design: two kernels a call, because the two halves want opposite shapes.
//
// query_embed_kernel (the warp step) is latency-bound scalar work that wants many
// resident warps: one CTA of 128 threads per tile of 128 points of one frame,
// the hand's frame vertices staged in shared memory in tiles with their boxes
// beside the warps' candidate queues (29 KB for MANO's 778, so several CTAs
// share an SM), one point a thread.  It writes the bf16 embedding row (48
// columns) straight into the tile image the trunk's wgmma reads: 16 KB a
// tile, 96 bytes a point, which stay in L2.
//
// query_trunk_kernel (cta_gemm.cuh) wants the whole SM: one CTA of 288 threads per
// tile, 213 KB of shared memory.  Warps 0-7 are two consumer warpgroups of 64
// rows each, warp 8 the producer.  The producer brings the tile's embedding
// (one 16 KB bulk copy) and streams the trunk's 30 weight slabs (32 KB each,
// in the layout tile_for_kernel gives them) through a 4-stage shared-memory
// ring with cp.async.bulk and mbarriers, once per CTA, up to four slabs ahead:
// a layer's first slabs arrive during the previous layer's epilogue.  Each
// layer is wgmma m64n256k16 from shared memory on both operands into 128 f32
// registers a thread; the epilogue (bias from shared memory, softplus100, bf16
// rounding) writes the next layer's A tile in place, in the swizzle wgmma
// reads: a warp's rows are read by its own products only, so the two
// warpgroups never wait for each other and one's epilogue overlaps the
// other's products.  Layer 4 adds the embedding's 48-column product into the
// same accumulator; layer 7 stays f32 and is dotted with the head row.
// The softplus is the epilogue's cost: with expf, log1pf and a division by
// 100 it took 84 % of an object call (1.82 of them against 0.29 ms without,
// NVIDIA H100 80GB HBM3 at 700 W, scripts/probe_query_softplus.py), so it uses
// the hardware's exp2 and log2 approximations (softplus100_fast), within 2e-9
// of the exact form.  Not done: persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cta_gemm.cuh"
#include "knn_common.cuh"
#include "trunk_common.cuh"

namespace {

constexpr int TILE = cta::TILE_M;                    // points per CTA
constexpr int CONSUMERS = 32 * cta::CONSUMER_WARPS;  // 256 threads
constexpr int THREADS = CONSUMERS + 32;              // + the producer warp
constexpr int N_SLABS = 30;                          // the trunk in 64-column slabs
constexpr int F_FLOATS = OFF_HEAD_B + 1;             // biases | head row | head bias

// query_trunk_kernel's dynamic shared memory, from a 1024-byte aligned base
constexpr int SM_RING = 0;
constexpr int SM_ACT = SM_RING + cta::STAGES * cta::SLAB_BYTES;
constexpr int SM_EMB = SM_ACT + 4 * cta::A_SLAB_BYTES;
constexpr int SM_F = SM_EMB + cta::A_SLAB_BYTES;
constexpr int SM_BAR = SM_F + ((F_FLOATS * 4 + 15) / 16) * 16;
constexpr int SM_TOTAL = SM_BAR + (2 * cta::STAGES + 1) * 8;
constexpr int SM_BYTES = SM_TOTAL + 1024;  // room to align the base

struct QueryArgs {
    const float* pts;      // point buffer (B, NP, 3)             [!ZTAB]
    const float* dirs;     // ray directions (B*P, 3)             [ZTAB]
    const float* cam;      // ray origins (B*P, 3)                [ZTAB]
    const float* z;        // depth table (B, P, S)               [ZTAB]
    const float* verts;    // posed vertices (B, V, 3)            [HAND]
    const float* skin;     // skinning weights (B, V, J)          [HAND]
    const float* tfs;      // bone transforms (B, J, 4, 4)        [HAND]
    const int* order;      // the vertices' tile order (V,) [HAND]
    unsigned long long* stats;  // the search's counters or null [HAND]
    const float* tf12;     // [Rinv row-major | t] (B, 12)        [!HAND]
    const float* window;   // embedding window (E,)
    const __nv_bfloat16* wts;  // the trunk's slabs (tile_for_kernel)
    const float* fpack;
    unsigned char* emb;    // scratch: one 16 KB embedding tile image a tile
    float* out;            // sdf (B, NP)
    int NP;                // points per frame (P*S for the z table)
    int P, S;
    int V, J, K;
    int multires;
};

// softplus(100 x) / 100 = max(x, 0) + log(1 + exp(-|100 x|)) / 100 with the
// hardware's exp2 and log2 (ex2.approx, lg2.approx).  The log term is at most
// 0.0069 and the approximations' absolute error on it about 1e-7, so the
// result lies within 2e-9 of the exact form (log1pf, expf, / 100.0f),
// five orders under a bf16 step of the smallest activation; beyond
// |x| = 0.166 the term (under 6e-10) is dropped.
__device__ __forceinline__ float softplus100_fast(float x) {
    return fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(100.0f * x))) * 0.01f;
}

// --- the warp step: world point -> canonical point -> bf16 embedding row,
// one thread per point, written into the trunk's tile image.  A lane past
// the last point searches a copy of the last one (the hand's search is
// warp-wide) and embeds x_c = 0.
template <bool HAND, bool ZTAB>
__global__ void __launch_bounds__(TILE) query_embed_kernel(const QueryArgs q) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int p = blockIdx.x * TILE + tid;
    const int pc = min(p, q.NP - 1);
    float x[3];
    if constexpr (ZTAB) {
        const size_t ray = (size_t)b * q.P + pc / q.S;
        const float z = q.z[(size_t)b * q.NP + pc];
#pragma unroll
        for (int m = 0; m < 3; ++m)  // cam + z*dir, rounded as two ops (no FMA)
            x[m] = __fadd_rn(q.cam[3 * ray + m], __fmul_rn(z, q.dirs[3 * ray + m]));
    } else {
#pragma unroll
        for (int m = 0; m < 3; ++m) x[m] = q.pts[3 * ((size_t)b * q.NP + pc) + m];
    }
    float xc[3];
    if constexpr (HAND) {
        stage_tfs(q.tfs + (size_t)b * q.J * 16, q.J, s_tf);
        const VertexSet set = stage_set(q.verts + (size_t)b * q.V * 3, q.order, q.V,
                                        set_base(smem));
        float wb[JMAX], inv[9];
        knn_blend(set, warp_queue(smem), q.skin + (size_t)b * q.V * q.J, q.J, q.K, x[0], x[1],
                  x[2], p < q.NP, wb, q.stats);
        inverse_skin(wb, s_tf, q.J, x[0], x[1], x[2], inv, xc);
    } else {  // Rinv (x - t), rounded op by op as the plain version
        const float* tf = q.tf12 + 12 * b;
        const float d0 = x[0] - tf[9], d1 = x[1] - tf[10], d2 = x[2] - tf[11];
#pragma unroll
        for (int i = 0; i < 3; ++i)
            xc[i] = __fadd_rn(__fadd_rn(__fmul_rn(tf[3 * i], d0), __fmul_rn(tf[3 * i + 1], d1)),
                              __fmul_rn(tf[3 * i + 2], d2));
    }
    if (p >= q.NP) xc[0] = xc[1] = xc[2] = 0.0f;
    // the row's 48 columns as six 16-byte chunks at their swizzled places;
    // columns 48..63 of the image are never read
    __align__(16) __nv_bfloat16 e[EP];
    write_embedding(xc, q.window, q.multires, e);
    unsigned char* tile = q.emb + ((size_t)b * gridDim.x + blockIdx.x) * cta::A_SLAB_BYTES;
#pragma unroll
    for (int c = 0; c < EP / 8; ++c)
        *reinterpret_cast<uint4*>(tile + cta::a_offset(tid, 8 * c)) =
            *reinterpret_cast<const uint4*>(e + 8 * c);
}

// a trunk layer's activation: softplus100, or relu for the relu trunk's
// hidden layers
template <bool SOFTPLUS>
__device__ __forceinline__ float activation(float x) {
    if constexpr (SOFTPLUS)
        return softplus100_fast(x);
    else
        return fmaxf(x, 0.0f);
}

// bias + activation on a warpgroup's accumulator.  Hidden layers round to
// bf16 and write the next A tile (rows of this warp) in the wgmma swizzle; the
// LAST layer stays f32 and adds its dot with the head row into rowsum (rows g
// and g + 8 of the warp).  With RELU the hidden layers take relu; the LAST
// layer's activation is softplus100 either way.
template <bool LAST, bool RELU>
__device__ __forceinline__ void epilogue(const float (&d)[128], const float* bias,
                                         const float* head_w, unsigned char* act_wg, int row,
                                         int t, float (&rowsum)[2]) {
    constexpr bool SOFTPLUS = LAST || !RELU;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        const float v0 = activation<SOFTPLUS>(d[4 * j] + b.x);
        const float v1 = activation<SOFTPLUS>(d[4 * j + 1] + b.y);
        const float v2 = activation<SOFTPLUS>(d[4 * j + 2] + b.x);
        const float v3 = activation<SOFTPLUS>(d[4 * j + 3] + b.y);
        if constexpr (LAST) {
            const float2 h = *reinterpret_cast<const float2*>(head_w + col);
            rowsum[0] += v0 * h.x + v1 * h.y;
            rowsum[1] += v2 * h.x + v3 * h.y;
        } else {
            *reinterpret_cast<uint32_t*>(act_wg + cta::a_offset(row, col)) = pack_bf16(v0, v1);
            *reinterpret_cast<uint32_t*>(act_wg + cta::a_offset(row + 8, col)) =
                pack_bf16(v2, v3);
        }
    }
}

// --- the trunk and the head on one tile of 128 embedded points
template <bool RELU>
__global__ void __launch_bounds__(THREADS, 1) query_trunk_kernel(const QueryArgs q) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (cta::smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* act = smem + SM_ACT;
    unsigned char* emb = smem + SM_EMB;
    float* s_f = reinterpret_cast<float*>(smem + SM_F);
    const int b = blockIdx.y;
    const int tid = threadIdx.x;

    cta::Ring ring;
    ring.stages = cta::smem_u32(smem + SM_RING);
    ring.full = cta::smem_u32(smem + SM_BAR);
    ring.empty = ring.full + 8 * cta::STAGES;
    ring.it = 0;
    const uint32_t emb_full = ring.empty + 8 * cta::STAGES;
    if (tid == 0) {
        cta::mbar_init(emb_full, 1);
        ring.init();
    }
    for (int i = tid; i < F_FLOATS; i += THREADS) s_f[i] = q.fpack[i];
    __syncthreads();

    if (tid >= CONSUMERS) {
        // --- producer: one thread brings the embedding tile and streams the
        // trunk's slabs through the ring
        if (tid == CONSUMERS) {
            cta::mbar_expect_tx(emb_full, cta::A_SLAB_BYTES);
            cta::bulk_copy(cta::smem_u32(emb),
                           q.emb + ((size_t)b * gridDim.x + blockIdx.x) * cta::A_SLAB_BYTES,
                           cta::A_SLAB_BYTES, emb_full);
            ring.produce(q.wts, N_SLABS);
        }
        return;
    }

    // --- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 through all layers
    const int wg = tid >> 7, lane = tid & 31;
    const int row = 16 * ((tid >> 5) & 3) + (lane >> 2), t = lane & 3;  // in the warpgroup
    unsigned char* act_wg = act + wg * cta::WG_ROWS * 128;
    const uint32_t a_wg = cta::smem_u32(act_wg);
    const uint32_t e_wg = cta::smem_u32(emb + wg * cta::WG_ROWS * 128);
    float d[128];
    float rowsum[2] = {0.0f, 0.0f};
    cta::mbar_wait(emb_full, 0);
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
        if (l == 0)
            cta::product<0, true>(d, a_wg, e_wg, ring);
        else if (l == 4)
            cta::product<4, true>(d, a_wg, e_wg, ring);
        else
            cta::product<4, false>(d, a_wg, e_wg, ring);
        if (l < 7) {
            epilogue<false, RELU>(d, s_f + l * H, nullptr, act_wg, row, t, rowsum);
            // the next layer's wgmma reads what this warpgroup has just written
            cta::fence_proxy_async();
            cta::named_barrier(1 + wg, 128);
        } else {
            epilogue<true, RELU>(d, s_f + l * H, s_f + OFF_HEAD_W, act_wg, row, t, rowsum);
        }
    }

    // the four lanes of a row group hold disjoint columns of the head dot
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        rowsum[0] += __shfl_xor_sync(0xffffffffu, rowsum[0], o);
        rowsum[1] += __shfl_xor_sync(0xffffffffu, rowsum[1], o);
    }
    if (t == 0) {
        const float hb = s_f[OFF_HEAD_B];
        const int p = blockIdx.x * TILE + wg * cta::WG_ROWS + row;
        if (p < q.NP) q.out[(size_t)b * q.NP + p] = rowsum[0] + hb;
        if (p + 8 < q.NP) q.out[(size_t)b * q.NP + p + 8] = rowsum[1] + hb;
    }
}

template <bool RELU>
cudaError_t launch_trunk(const QueryArgs& q, const dim3 grid, void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        query_trunk_kernel<RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_BYTES);
    if (err != cudaSuccess) return err;
    query_trunk_kernel<RELU><<<grid, THREADS, SM_BYTES, (cudaStream_t)stream>>>(q);
    return cudaGetLastError();
}

template <bool HAND, bool ZTAB>
cudaError_t launch(const QueryArgs& q, int B, int relu, void* stream) {
    if (B == 0 || q.NP == 0) return cudaSuccess;
    const int vert_bytes = HAND ? (int)search_smem(q.V) : 0;
    cudaError_t err = cudaFuncSetAttribute(query_embed_kernel<HAND, ZTAB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           vert_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((q.NP + TILE - 1) / TILE, B);
    query_embed_kernel<HAND, ZTAB><<<grid, TILE, vert_bytes, (cudaStream_t)stream>>>(q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return relu ? launch_trunk<true>(q, grid, stream) : launch_trunk<false>(q, grid, stream);
}

QueryArgs trunk_args(const void* window, int multires, const void* wts, const void* fpack,
                     void* emb, void* out, int NP) {
    QueryArgs q = {};
    q.window = (const float*)window;
    q.multires = multires;
    q.wts = (const __nv_bfloat16*)wts;
    q.fpack = (const float*)fpack;
    q.emb = (unsigned char*)emb;
    q.out = (float*)out;
    q.NP = NP;
    return q;
}

}  // namespace

extern "C" {

// dirs, cam (B*P, 3), z (B, P, S), verts (B, V, 3), skin (B, V, J),
// tfs (B, J, 4, 4), order (V,) int32 -> out (B, P, S); stats null or the
// search's six counters (knn_common.cuh).  emb: scratch of 16 KB per 128-point tile of a
// frame, in every entry point; relu: 1 for the relu trunk, 0 for softplus100.
int hold_fused_hand_sdf_z(const void* dirs, const void* cam, const void* z, const void* verts,
                          const void* skin, const void* tfs, const void* order,
                          const void* window, const void* wts, const void* fpack, void* emb,
                          void* out, int B, int P, int S, int V, int J, int K, int multires,
                          int relu, void* stats, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, emb, out, P * S);
    q.dirs = (const float*)dirs;
    q.cam = (const float*)cam;
    q.z = (const float*)z;
    q.P = P;
    q.S = S;
    q.verts = (const float*)verts;
    q.skin = (const float*)skin;
    q.tfs = (const float*)tfs;
    q.order = (const int*)order;
    q.stats = (unsigned long long*)stats;
    q.V = V;
    q.J = J;
    q.K = K;
    return launch<true, true>(q, B, relu, stream);
}

// dirs, cam (B*P, 3), z (B, P, S), tf12 (B, 12) -> out (B, P, S).
int hold_fused_object_sdf_z(const void* dirs, const void* cam, const void* z, const void* tf12,
                            const void* window, const void* wts, const void* fpack, void* emb,
                            void* out, int B, int P, int S, int multires, int relu,
                            void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, emb, out, P * S);
    q.dirs = (const float*)dirs;
    q.cam = (const float*)cam;
    q.z = (const float*)z;
    q.P = P;
    q.S = S;
    q.tf12 = (const float*)tf12;
    return launch<false, true>(q, B, relu, stream);
}

// pts (B, N, 3), verts (B, V, 3), skin (B, V, J), tfs (B, J, 4, 4), order (V,)
// int32 -> out (B, N).
int hold_fused_hand_sdf(const void* pts, const void* verts, const void* skin, const void* tfs,
                        const void* order, const void* window, const void* wts,
                        const void* fpack, void* emb, void* out, int B, int N, int V, int J,
                        int K, int multires, int relu, void* stats, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, emb, out, N);
    q.pts = (const float*)pts;
    q.verts = (const float*)verts;
    q.skin = (const float*)skin;
    q.tfs = (const float*)tfs;
    q.order = (const int*)order;
    q.stats = (unsigned long long*)stats;
    q.V = V;
    q.J = J;
    q.K = K;
    return launch<true, false>(q, B, relu, stream);
}

// pts (B, N, 3), tf12 (B, 12) -> out (B, N).
int hold_fused_object_sdf(const void* pts, const void* tf12, const void* window, const void* wts,
                          const void* fpack, void* emb, void* out, int B, int N, int multires,
                          int relu, void* stream) {
    QueryArgs q = trunk_args(window, multires, wts, fpack, emb, out, N);
    q.pts = (const float*)pts;
    q.tf12 = (const float*)tf12;
    return launch<false, false>(q, B, relu, stream);
}

}  // extern "C"
