// KNN skinning warps for the MANO deformer, hand-written for Hopper (sm_90a).
//
// Plain C interface (loaded with ctypes by hold_tpu_torch/ops/_cuda.py). Every
// entry point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The neighbour blend and its semantics are in knn_common.cuh; the outlier
// distance is sqrt(min(min_v d2, 4)).

#include <cuda_runtime.h>
#include <math.h>

#include "knn_common.cuh"

namespace {

constexpr int BLOCK = SEARCH_THREADS;   // one point per thread

// Replaces hold_tpu/ops/knn.py _knn_warp_single (knn.py:416) [RESID=false]
// and the forward of knn_inverse_warp_diff (knn.py:547) [RESID=true].
// Bound: by brute force one sweep over the V vertices (V = 778 for MANO) of
// ~10 f32 operations a vertex and point, then the blend of the K nearest;
// the tile culling of knn_common.cuh evaluates only the tiles near each
// warp's points, so the kernel may run under that count.  Memory traffic is
// ~50 bytes a point.  Design (knn_common.cuh knn_blend): one point a thread,
// the frame's vertices staged in shared memory in tiles of 32 with their
// boxes, every thread of a warp reading the same vertex (a broadcast); the
// K-list and the blend in registers, candidates through a per-lane queue in
// shared memory, so nothing P x V reaches device memory.  Skin weights (V x
// 16 floats, 50 KB a frame) stay in global memory and are read through the
// read-only cache for the K vertices of the list only.
template <bool RESID>
__global__ void __launch_bounds__(BLOCK)
knn_warp_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                    const float* __restrict__ w, const float* __restrict__ tfs,
                    const int* __restrict__ order, float* __restrict__ xc,
                    unsigned char* __restrict__ outlier, float* __restrict__ inv_out,
                    float* __restrict__ wb_out, int P, int V, int J, int K, float max_dist,
                    unsigned long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    stage_tfs(tfs + (size_t)b * J * 16, J, s_tf);
    const VertexSet set = stage_set(verts + (size_t)b * V * 3, order, V, set_base(smem));
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    const size_t q = (size_t)b * P + min(p, P - 1);
    const float px = pts[3 * q], py = pts[3 * q + 1], pz = pts[3 * q + 2];

    float wb[JMAX];
    const float dmin = knn_blend(set, warp_queue(smem), w + (size_t)b * V * J, J, K, px, py, pz,
                                 p < P, wb, stats);
    if (p >= P) return;

    float inv[9], x[3];
    inverse_skin(wb, s_tf, J, px, py, pz, inv, x);
#pragma unroll
    for (int i = 0; i < 3; ++i) xc[3 * q + i] = x[i];
    outlier[q] = sqrtf(fminf(dmin, CLAMP)) > max_dist ? 1 : 0;
    if (RESID) {
#pragma unroll
        for (int c = 0; c < 9; ++c) inv_out[9 * q + c] = inv[c];
#pragma unroll
        for (int j = 0; j < JMAX; ++j)
            if (j < J) wb_out[q * J + j] = wb[j];
    }
}

// Replaces the forward of hold_tpu/ops/knn.py knn_jacobian_inverse
// (knn.py:737): KNN against the CANONICAL vertices, J = sum_j w_j R_j, J^-1
// row-major.  Bound and design as knn_warp_fwd_kernel.
__global__ void __launch_bounds__(BLOCK)
knn_jinv_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                    const float* __restrict__ w, const float* __restrict__ tfs,
                    const int* __restrict__ order, float* __restrict__ inv_out,
                    float* __restrict__ wb_out, int P, int V, int J, int K,
                    unsigned long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    stage_tfs(tfs + (size_t)b * J * 16, J, s_tf);
    const VertexSet set = stage_set(verts + (size_t)b * V * 3, order, V, set_base(smem));
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    const size_t q = (size_t)b * P + min(p, P - 1);
    float wb[JMAX];
    knn_blend(set, warp_queue(smem), w + (size_t)b * V * J, J, K, pts[3 * q], pts[3 * q + 1],
              pts[3 * q + 2], p < P, wb, stats);
    if (p >= P) return;
    float inv[9];
    blend_jacobian_inverse(wb, s_tf, J, inv);
#pragma unroll
    for (int c = 0; c < 9; ++c) inv_out[9 * q + c] = inv[c];
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
        if (j < J) wb_out[q * J + j] = wb[j];
}

// Replaces hold_tpu/ops/knn.py knn_blend_weights_pallas (knn.py:144)
// [TRANSPOSED=false, weights (B,P,J)] and knn_blend_weights_t (knn.py:254)
// [TRANSPOSED=true, weights (B,J,P)]: the blended skinning weights and the
// outlier mask, stop-gradient.  Bound and design as knn_warp_fwd_kernel; the
// transposed form writes each joint's row with consecutive threads on
// consecutive points.  It asks for 5 resident CTAs (102 registers at most):
// without a count ptxas gave it 72 registers and spills (scripts/probe_knn.py).
template <bool TRANSPOSED>
__global__ void __launch_bounds__(BLOCK, 5)
knn_blend_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                 const float* __restrict__ w, const int* __restrict__ order,
                 float* __restrict__ wout, unsigned char* __restrict__ outlier, int P, int V,
                 int J, int K, float max_dist, unsigned long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.y;
    const VertexSet set = stage_set(verts + (size_t)b * V * 3, order, V, set_base(smem));
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    const size_t q = (size_t)b * P + min(p, P - 1);
    float wb[JMAX];
    const float dmin = knn_blend(set, warp_queue(smem), w + (size_t)b * V * J, J, K, pts[3 * q],
                                 pts[3 * q + 1], pts[3 * q + 2], p < P, wb, stats);
    if (p >= P) return;
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
        if (j < J) {
            if (TRANSPOSED)
                wout[((size_t)b * J + j) * P + p] = wb[j];
            else
                wout[q * J + j] = wb[j];
        }
    outlier[q] = sqrtf(fminf(dmin, CLAMP)) > max_dist ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Backward of rows 2-3: the per-frame sums to the bone transforms
// ---------------------------------------------------------------------------
//
// Both VJPs end in dtfs[b, j, r, :] = sum over the frame's points of
// wb[p, j] * T[p, r, :] for rows r = 0..2 of each 4x4 (row 3 is zero), with
// per-point terms T from g and the forward's J^-1 (and x_c).  The TPU
// kernels carried that sum across their sequential grid, in a fixed order.
// Here the sum runs in a fixed order too, with no atomics and no memset:
//
// 1. knn_tfs_bwd_kernel: a CTA per range of BWD_RANGE consecutive points of
//    one frame (grid (ranges, B): 490 CTAs at a training step's shape, all
//    resident at once, ~4 an SM).  Its range's records are contiguous, so
//    the CTA stages all of them at once, BWD_TILES tiles of BWD_TILE points,
//    by cp.async (16 bytes a copy where aligned) into shared memory: every
//    byte of the range is in flight before the first tile is used.  A tile's
//    per-point terms are formed once a point (u = A^-T g; or dA = -A^-T G
//    A^-T) into shared memory, from which row 2's dpts = u is written
//    coalesced.  Then thread (grp, j) adds wb[p, j] times the point's terms
//    (12, or 9) over the tile's points p = grp, grp + NG, ... (NG =
//    BWD_THREADS / J groups), tile after tile; the groups' sums are added in
//    group order, and the CTA writes its range's partial (J x 12, or J x 9)
//    to a workspace.
// 2. knn_tfs_bwd_final_kernel: a CTA per frame adds the ranges' partials in
//    range order and writes every entry of each 4x4, zeros included.
//
// Each product and sum is one rounded f32 operation (__fmul_rn /
// __fadd_rn: no contraction to FMA), so the result is the same bit for bit
// from call to call and equals ops/knn.py's warp_bwd_fixed_order /
// jinv_bwd_fixed_order, which repeat this order in PyTorch.  Bound: the
// bytes, each record read once (124 or 136 B a point) and dpts written
// once; ~50 f32 operations a point are far below them.

constexpr int BWD_THREADS = 256;
constexpr int BWD_TILE = 128;                     // points staged at a time
constexpr int BWD_TILES = 2;                      // tiles a range, all in flight at once
constexpr int BWD_RANGE = BWD_TILE * BWD_TILES;   // points a CTA

// A tile's staged records (floats, at BWD_TILE points each): g (3 or 9
// a point), J^-1 (9), for row 2 x_c (3), wb (JMAX room for J).
template <bool JINV>
struct BwdLayout {
    static constexpr int GW = JINV ? 9 : 3;        // g's floats a point
    static constexpr int XC = GW + 9;              // x_c's offset (row 2)
    static constexpr int WB = XC + (JINV ? 0 : 3); // wb's offset
    static constexpr int TILE = (WB + JMAX) * BWD_TILE;
    static constexpr int AW = JINV ? 9 : 3;        // per-point terms: dA, or u
    static constexpr int NC = JINV ? 3 : 4;        // columns of a 4x4 row reached
    static constexpr int NS = 3 * NC;              // sums a joint
    // floats: the staged tiles, the per-point terms, the threads' sums
    static constexpr int SMEM = BWD_TILES * TILE + AW * BWD_TILE + BWD_THREADS * NS;
};

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// n contiguous floats from global to shared memory, 16 bytes a copy when
// the source allows it (the destination is 16-byte aligned by layout)
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n) {
    if ((reinterpret_cast<size_t>(src) & 15) == 0 && (n & 3) == 0) {
        for (int k = 4 * threadIdx.x; k < n; k += 4 * BWD_THREADS) cp_async(dst + k, src + k, 1);
    } else {
        for (int k = threadIdx.x; k < n; k += BWD_THREADS) cp_async(dst + k, src + k, 0);
    }
}

// wait until at most `pending` (0 or 1) of this thread's copy groups are in
// flight, then for every thread of the CTA to have done so
static_assert(BWD_TILES <= 2, "wait_tiles waits with at most one group in flight");
__device__ __forceinline__ void wait_tiles(int pending) {
    if (pending == 0)
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
}

// Replaces the backwards of knn_inverse_warp_diff (knn.py:581) [JINV=false]:
// u = A^-T g, dpts = u, dtfs rows = -sum wb u (x_c, 1); and of
// knn_jacobian_inverse (knn.py:781) [JINV=true]: dA = -A^-T G A^-T, dtfs
// rotation block = sum wb dA (no gradient to the points).  Writes the
// range's partial to part (B, ranges, J, NS), row 2's already negated.
template <bool JINV>
__global__ void __launch_bounds__(BWD_THREADS)
knn_tfs_bwd_kernel(const float* __restrict__ g, const float* __restrict__ inv,
                   const float* __restrict__ xc, const float* __restrict__ wb,
                   float* __restrict__ dpts, float* __restrict__ part, int P, int J) {
    using L = BwdLayout<JINV>;
    extern __shared__ __align__(16) float sm[];
    float* s_a = sm + BWD_TILES * L::TILE;
    float* s_sum = s_a + L::AW * BWD_TILE;
    const int b = blockIdx.y, t = threadIdx.x;
    const int start = blockIdx.x * BWD_RANGE;
    const int n_range = min(BWD_RANGE, P - start);
    const int n_tiles = (n_range + BWD_TILE - 1) / BWD_TILE;
    const size_t q0 = (size_t)b * P + start;
    for (int k = 0; k < n_tiles; ++k) {
        const int n = min(BWD_TILE, n_range - k * BWD_TILE);
        const size_t q = q0 + (size_t)k * BWD_TILE;
        float* buf = sm + k * L::TILE;
        stage_floats(buf, g + q * L::GW, L::GW * n);
        stage_floats(buf + L::GW * BWD_TILE, inv + q * 9, 9 * n);
        if constexpr (!JINV) stage_floats(buf + L::XC * BWD_TILE, xc + q * 3, 3 * n);
        stage_floats(buf + L::WB * BWD_TILE, wb + q * J, J * n);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    const int NG = BWD_THREADS / J, grp = t / J, j = t - grp * J;
    float acc[L::NS];  // row r's column c at r * NC + c
#pragma unroll
    for (int e = 0; e < L::NS; ++e) acc[e] = 0.0f;
    for (int k = 0; k < n_tiles; ++k) {
        wait_tiles(n_tiles - 1 - k);  // tile k has landed; the last tile's sums are done
        const int n = min(BWD_TILE, n_range - k * BWD_TILE);
        const float* buf = sm + k * L::TILE;
        if (t < n) {
            const float* m = buf + L::GW * BWD_TILE + 9 * t;  // J^-1, row-major
            const float* gp = buf + L::GW * t;
            if constexpr (!JINV) {
#pragma unroll
                for (int r = 0; r < 3; ++r)
                    s_a[3 * t + r] = __fadd_rn(__fadd_rn(__fmul_rn(m[r], gp[0]),
                                                         __fmul_rn(m[3 + r], gp[1])),
                                               __fmul_rn(m[6 + r], gp[2]));
            } else {
                // Pk[r][c] = sum_s m[s][r] G[s][c];  dA[r][c] = -sum_s Pk[r][s] m[c][s]
                float pk[9];
#pragma unroll
                for (int r = 0; r < 3; ++r)
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        pk[3 * r + c] = __fadd_rn(__fadd_rn(__fmul_rn(m[r], gp[c]),
                                                            __fmul_rn(m[3 + r], gp[3 + c])),
                                                  __fmul_rn(m[6 + r], gp[6 + c]));
#pragma unroll
                for (int r = 0; r < 3; ++r)
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        s_a[9 * t + 3 * r + c] = -__fadd_rn(
                            __fadd_rn(__fmul_rn(pk[3 * r], m[3 * c]),
                                      __fmul_rn(pk[3 * r + 1], m[3 * c + 1])),
                            __fmul_rn(pk[3 * r + 2], m[3 * c + 2]));
            }
        }
        __syncthreads();
        if constexpr (!JINV) {  // dpts = u, coalesced
            float* out = dpts + (q0 + (size_t)k * BWD_TILE) * 3;
            for (int e = t; e < 3 * n; e += BWD_THREADS) out[e] = s_a[e];
        }
        if (grp < NG) {
            const float* w = buf + L::WB * BWD_TILE + j;
            for (int p = grp; p < n; p += NG) {
                const float wj = w[p * J];
                if constexpr (!JINV) {
                    const float* x = buf + L::XC * BWD_TILE + 3 * p;
                    const float x0 = x[0], x1 = x[1], x2 = x[2];
#pragma unroll
                    for (int r = 0; r < 3; ++r) {
                        const float wu = __fmul_rn(wj, s_a[3 * p + r]);
                        acc[4 * r] = __fadd_rn(acc[4 * r], __fmul_rn(wu, x0));
                        acc[4 * r + 1] = __fadd_rn(acc[4 * r + 1], __fmul_rn(wu, x1));
                        acc[4 * r + 2] = __fadd_rn(acc[4 * r + 2], __fmul_rn(wu, x2));
                        acc[4 * r + 3] = __fadd_rn(acc[4 * r + 3], wu);
                    }
                } else {
                    const float* a = s_a + 9 * p;
#pragma unroll
                    for (int e = 0; e < 9; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj, a[e]));
                }
            }
        }
    }
    if (grp < NG) {
#pragma unroll
        for (int e = 0; e < L::NS; ++e) s_sum[t * L::NS + e] = acc[e];
    }
    __syncthreads();
    if (t < J * L::NS) {  // thread (j, e): the groups' sums in group order
        float s = s_sum[t];
        for (int k = 1; k < NG; ++k) s = __fadd_rn(s, s_sum[k * J * L::NS + t]);
        part[((size_t)b * gridDim.x + blockIdx.x) * J * L::NS + t] = JINV ? s : -s;
    }
}

// The ranges' partials (B, C, J, NS) added in range order into dtfs
// (B, J, 4, 4): a CTA per frame, a thread per entry (J <= 16), every entry
// written, those the VJP does not reach as zeros (row 3 of each 4x4; for
// row 3's VJP also column 3).
template <bool JINV>
__global__ void __launch_bounds__(JMAX * 16)
knn_tfs_bwd_final_kernel(const float* __restrict__ part, float* __restrict__ dtfs, int C,
                         int J) {
    using L = BwdLayout<JINV>;
    const int b = blockIdx.x, t = threadIdx.x;
    const int j = t >> 4, r = (t >> 2) & 3, c = t & 3;
    if (j >= J) return;
    float s = 0.0f;
    if (r < 3 && c < L::NC) {
        const float* src = part + ((size_t)b * C * J + j) * L::NS + r * L::NC + c;
        for (int k = 0; k < C; ++k) s = __fadd_rn(s, src[(size_t)k * J * L::NS]);
    }
    dtfs[((size_t)b * J + j) * 16 + (t & 15)] = s;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

// rows 2-3 backward: the ranges' partials, then their sum; ranges = ceil(P
// / BWD_RANGE) (ops/knn.py bwd_ranges), part holds B x ranges x J x NS floats
template <bool JINV>
cudaError_t tfs_bwd(const void* g, const void* inv, const void* xc, const void* wb, void* dpts,
                    void* part, void* dtfs, int B, int P, int J, cudaStream_t s) {
    if (B == 0) return cudaSuccess;
    const int C = (P + BWD_RANGE - 1) / BWD_RANGE;
    if (C > 0) {
        const size_t smem = BwdLayout<JINV>::SMEM * sizeof(float);
        cudaError_t err = allow_smem(knn_tfs_bwd_kernel<JINV>, smem);
        if (err != cudaSuccess) return err;
        knn_tfs_bwd_kernel<JINV><<<dim3(C, B), BWD_THREADS, smem, s>>>(
            (const float*)g, (const float*)inv, (const float*)xc, (const float*)wb,
            (float*)dpts, (float*)part, P, J);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    knn_tfs_bwd_final_kernel<JINV><<<B, JMAX * 16, 0, s>>>((const float*)part, (float*)dtfs, C,
                                                           J);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts (B,P,3), verts (B,V,3), w (B,V,J), tfs (B,J,4,4), order (V,) int32
// -> xc (B,P,3), outlier (B,P) u8; with inv_out/wb_out non-null also
// inv (B,P,9), wb (B,P,J).  stats: null, or six counters (knn_common.cuh).
int hold_knn_warp_fwd(const void* pts, const void* verts, const void* w, const void* tfs,
                      const void* order, void* xc, void* outlier, void* inv_out, void* wb_out,
                      int B, int P, int V, int J, int K, float max_dist, void* stats,
                      void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = search_smem(V);
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (inv_out != nullptr) {
        if ((err = allow_smem(knn_warp_fwd_kernel<true>, smem)) != cudaSuccess) return err;
        knn_warp_fwd_kernel<true><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
            (const int*)order, (float*)xc, (unsigned char*)outlier, (float*)inv_out,
            (float*)wb_out, P, V, J, K, max_dist, (unsigned long long*)stats);
    } else {
        if ((err = allow_smem(knn_warp_fwd_kernel<false>, smem)) != cudaSuccess) return err;
        knn_warp_fwd_kernel<false><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
            (const int*)order, (float*)xc, (unsigned char*)outlier, nullptr, nullptr, P, V, J,
            K, max_dist, (unsigned long long*)stats);
    }
    return cudaGetLastError();
}

// pts (B,P,3), verts (B,V,3), w (B,V,J), order (V,) int32 ->
// weights (B,P,J), or (B,J,P) with transposed != 0, and outlier (B,P) u8.
int hold_knn_blend(const void* pts, const void* verts, const void* w, const void* order,
                   void* wout, void* outlier, int B, int P, int V, int J, int K, float max_dist,
                   int transposed, void* stats, void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = search_smem(V);
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (transposed) {
        if ((err = allow_smem(knn_blend_kernel<true>, smem)) != cudaSuccess) return err;
        knn_blend_kernel<true><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const int*)order,
            (float*)wout, (unsigned char*)outlier, P, V, J, K, max_dist,
            (unsigned long long*)stats);
    } else {
        if ((err = allow_smem(knn_blend_kernel<false>, smem)) != cudaSuccess) return err;
        knn_blend_kernel<false><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const int*)order,
            (float*)wout, (unsigned char*)outlier, P, V, J, K, max_dist,
            (unsigned long long*)stats);
    }
    return cudaGetLastError();
}

// g (B,P,3), inv (B,P,9), xc (B,P,3), wb (B,P,J) -> dpts (B,P,3), dtfs
// (B,J,4,4); part: a workspace of B x ceil(P / 256) x J x 12 floats.
int hold_knn_warp_bwd(const void* g, const void* inv, const void* xc, const void* wb,
                      void* dpts, void* part, void* dtfs, int B, int P, int J, void* stream) {
    return tfs_bwd<false>(g, inv, xc, wb, dpts, part, dtfs, B, P, J, (cudaStream_t)stream);
}

// pts (B,P,3), verts (B,V,3), w (B,V,J), tfs (B,J,4,4), order (V,) int32
// -> inv (B,P,9), wb (B,P,J).
int hold_knn_jinv_fwd(const void* pts, const void* verts, const void* w, const void* tfs,
                      const void* order, void* inv_out, void* wb_out, int B, int P, int V, int J,
                      int K, void* stats, void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = search_smem(V);
    cudaError_t err = allow_smem(knn_jinv_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    knn_jinv_fwd_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
        (const int*)order, (float*)inv_out, (float*)wb_out, P, V, J, K,
        (unsigned long long*)stats);
    return cudaGetLastError();
}

// g (B,P,9), inv (B,P,9), wb (B,P,J) -> dtfs (B,J,4,4) (rotation block
// only); part: a workspace of B x ceil(P / 256) x J x 9 floats.
int hold_knn_jinv_bwd(const void* g, const void* inv, const void* wb, void* part, void* dtfs,
                      int B, int P, int J, void* stream) {
    return tfs_bwd<true>(g, inv, nullptr, wb, nullptr, part, dtfs, B, P, J,
                         (cudaStream_t)stream);
}

}  // extern "C"
