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

constexpr int BLOCK = 128;   // one point per thread

// Replaces hold_tpu/ops/knn.py _knn_warp_single (knn.py:416) [RESID=false]
// and the forward of knn_inverse_warp_diff (knn.py:547) [RESID=true].
// Bound: the two vertex sweeps, 2 x V x ~12 FP32 ops per point (V = 778 for
// MANO); memory traffic is ~50 bytes per point.  Design: one thread per
// point, the frame's vertices broadcast from shared memory (every thread of a
// warp reads the same vertex), the top-K list and the blend in registers, so
// nothing P x V ever reaches device memory.  Skin weights (V x 16 floats,
// 50 KB per frame) stay in global memory and are read through the read-only
// cache only for the ~K vertices that pass the threshold.
template <bool RESID>
__global__ void __launch_bounds__(BLOCK)
knn_warp_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                    const float* __restrict__ w, const float* __restrict__ tfs,
                    float* __restrict__ xc, unsigned char* __restrict__ outlier,
                    float* __restrict__ inv_out, float* __restrict__ wb_out, int P,
                    int V, int J, int K, float max_dist) {
    extern __shared__ float4 s_verts[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    stage_frame(verts + (size_t)b * V * 3, tfs + (size_t)b * J * 16, V, J, s_verts, s_tf);
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= P) return;
    const size_t q = (size_t)b * P + p;
    const float px = pts[3 * q], py = pts[3 * q + 1], pz = pts[3 * q + 2];

    float wb[JMAX];
    const float dmin = knn_blend(s_verts, V, w + (size_t)b * V * J, J, K, px, py, pz, wb);

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
                    float* __restrict__ inv_out, float* __restrict__ wb_out, int P, int V,
                    int J, int K) {
    extern __shared__ float4 s_verts[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    stage_frame(verts + (size_t)b * V * 3, tfs + (size_t)b * J * 16, V, J, s_verts, s_tf);
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= P) return;
    const size_t q = (size_t)b * P + p;
    float wb[JMAX];
    knn_blend(s_verts, V, w + (size_t)b * V * J, J, K, pts[3 * q], pts[3 * q + 1],
              pts[3 * q + 2], wb);
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
// consecutive points.
template <bool TRANSPOSED>
__global__ void __launch_bounds__(BLOCK)
knn_blend_kernel(const float* __restrict__ pts, const float* __restrict__ verts,
                 const float* __restrict__ w, float* __restrict__ wout,
                 unsigned char* __restrict__ outlier, int P, int V, int J, int K,
                 float max_dist) {
    extern __shared__ float4 s_verts[];
    __shared__ float s_tf[JMAX * 16];
    const int b = blockIdx.y;
    stage_frame(verts + (size_t)b * V * 3, nullptr, V, 0, s_verts, s_tf);
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= P) return;
    const size_t q = (size_t)b * P + p;
    float wb[JMAX];
    const float dmin = knn_blend(s_verts, V, w + (size_t)b * V * J, J, K, pts[3 * q],
                                 pts[3 * q + 1], pts[3 * q + 2], wb);
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

// Block reduction of sum_points G[c] * wb[j] into dtfs[b, j, c/4, c%4]
// (dtfs holds 16 floats per joint).  Rows are padded to BLOCK + 1 floats so
// threads reading different rows at one column hit different banks.
template <int NC>
__device__ __forceinline__ void reduce_to_dtfs(const float* G, const float* W, int J,
                                               float (*sG)[BLOCK + 1],
                                               float (*sW)[BLOCK + 1],
                                               const int* col_of, float* dtfs_b) {
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < NC; ++c) sG[c][t] = G[c];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) sW[j][t] = W[j];
    __syncthreads();
    for (int idx = t; idx < NC * J; idx += BLOCK) {
        const int c = idx / J, j = idx - (idx / J) * J;
        float s = 0.0f;
        for (int k = 0; k < BLOCK; ++k) s += sG[c][k] * sW[j][k];
        atomicAdd(dtfs_b + j * 16 + col_of[c], s);
    }
}

// Replaces the backward of knn_inverse_warp_diff (knn.py:581):
// u = A^-T g, dpts = u, dA = -u x_c^T, dt = -u, dtfs = sum_points wb (x) [dA|dt].
// Bound: ~25 loads/stores per point plus the (12 x J) per-block reduction;
// the TPU kernel carried that sum across its sequential grid, here each block
// reduces its 128 points in shared memory and adds one partial per (c, j)
// with atomicAdd (order varies from run to run: sums agree to fp32 rounding).
__global__ void __launch_bounds__(BLOCK)
knn_warp_bwd_kernel(const float* __restrict__ g, const float* __restrict__ inv,
                    const float* __restrict__ xc, const float* __restrict__ wb,
                    float* __restrict__ dpts, float* __restrict__ dtfs, int P, int J) {
    __shared__ float sG[12][BLOCK + 1];
    __shared__ float sW[JMAX][BLOCK + 1];
    __shared__ int col_of[12];
    const int b = blockIdx.y;
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (threadIdx.x < 12) col_of[threadIdx.x] = threadIdx.x;  // rows 0..2 of the 4x4
    float G[12], W[JMAX];
#pragma unroll
    for (int c = 0; c < 12; ++c) G[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) W[j] = 0.0f;
    if (p < P) {
        const size_t q = (size_t)b * P + p;
        float m[9], u[3];
#pragma unroll
        for (int c = 0; c < 9; ++c) m[c] = inv[9 * q + c];
        const float g0 = g[3 * q], g1 = g[3 * q + 1], g2 = g[3 * q + 2];
#pragma unroll
        for (int i = 0; i < 3; ++i) u[i] = m[i] * g0 + m[3 + i] * g1 + m[6 + i] * g2;
        const float x0 = xc[3 * q], x1 = xc[3 * q + 1], x2 = xc[3 * q + 2];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            dpts[3 * q + i] = u[i];
            G[4 * i] = -u[i] * x0;
            G[4 * i + 1] = -u[i] * x1;
            G[4 * i + 2] = -u[i] * x2;
            G[4 * i + 3] = -u[i];
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j)
            if (j < J) W[j] = wb[q * J + j];
    }
    reduce_to_dtfs<12>(G, W, J, sG, sW, col_of, dtfs + (size_t)b * J * 16);
}

// Replaces the backward of knn_jacobian_inverse (knn.py:781):
// dA = -A^-T G A^-T, blended to the bone rotations; no gradient to the
// points (detached by contract).  Bound and reduction as knn_warp_bwd_kernel.
__global__ void __launch_bounds__(BLOCK)
knn_jinv_bwd_kernel(const float* __restrict__ g, const float* __restrict__ inv,
                    const float* __restrict__ wb, float* __restrict__ dtfs, int P, int J) {
    __shared__ float sG[9][BLOCK + 1];
    __shared__ float sW[JMAX][BLOCK + 1];
    __shared__ int col_of[9];
    const int b = blockIdx.y;
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (threadIdx.x < 9) col_of[threadIdx.x] = 4 * (threadIdx.x / 3) + threadIdx.x % 3;
    float dA[9], W[JMAX];
#pragma unroll
    for (int c = 0; c < 9; ++c) dA[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) W[j] = 0.0f;
    if (p < P) {
        const size_t q = (size_t)b * P + p;
        float m[9], G[9], Pk[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
            m[c] = inv[9 * q + c];
            G[c] = g[9 * q + c];
        }
        // P_ik = sum_j inv[3j+i] G[3j+k];  dA_im = -sum_k P_ik inv[3m+k]
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                Pk[3 * i + k] = m[i] * G[k] + m[3 + i] * G[3 + k] + m[6 + i] * G[6 + k];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int mm = 0; mm < 3; ++mm)
                dA[3 * i + mm] = -(Pk[3 * i] * m[3 * mm] + Pk[3 * i + 1] * m[3 * mm + 1] +
                                   Pk[3 * i + 2] * m[3 * mm + 2]);
#pragma unroll
        for (int j = 0; j < JMAX; ++j)
            if (j < J) W[j] = wb[q * J + j];
    }
    reduce_to_dtfs<9>(dA, W, J, sG, sW, col_of, dtfs + (size_t)b * J * 16);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

}  // namespace

extern "C" {

// pts (B,P,3), verts (B,V,3), w (B,V,J), tfs (B,J,4,4) -> xc (B,P,3),
// outlier (B,P) u8; with inv_out/wb_out non-null also inv (B,P,9), wb (B,P,J).
int hold_knn_warp_fwd(const void* pts, const void* verts, const void* w, const void* tfs,
                      void* xc, void* outlier, void* inv_out, void* wb_out, int B, int P,
                      int V, int J, int K, float max_dist, void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = (size_t)V * sizeof(float4);
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (inv_out != nullptr) {
        if ((err = allow_smem(knn_warp_fwd_kernel<true>, smem)) != cudaSuccess) return err;
        knn_warp_fwd_kernel<true><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
            (float*)xc, (unsigned char*)outlier, (float*)inv_out, (float*)wb_out, P, V, J,
            K, max_dist);
    } else {
        if ((err = allow_smem(knn_warp_fwd_kernel<false>, smem)) != cudaSuccess) return err;
        knn_warp_fwd_kernel<false><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
            (float*)xc, (unsigned char*)outlier, nullptr, nullptr, P, V, J, K, max_dist);
    }
    return cudaGetLastError();
}

// pts (B,P,3), verts (B,V,3), w (B,V,J) -> weights (B,P,J), or (B,J,P) with
// transposed != 0, and outlier (B,P) u8.
int hold_knn_blend(const void* pts, const void* verts, const void* w, void* wout, void* outlier,
                   int B, int P, int V, int J, int K, float max_dist, int transposed,
                   void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = (size_t)V * sizeof(float4);
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (transposed) {
        if ((err = allow_smem(knn_blend_kernel<true>, smem)) != cudaSuccess) return err;
        knn_blend_kernel<true><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (float*)wout,
            (unsigned char*)outlier, P, V, J, K, max_dist);
    } else {
        if ((err = allow_smem(knn_blend_kernel<false>, smem)) != cudaSuccess) return err;
        knn_blend_kernel<false><<<grid, BLOCK, smem, s>>>(
            (const float*)pts, (const float*)verts, (const float*)w, (float*)wout,
            (unsigned char*)outlier, P, V, J, K, max_dist);
    }
    return cudaGetLastError();
}

// g (B,P,3), inv (B,P,9), xc (B,P,3), wb (B,P,J) -> dpts (B,P,3), dtfs (B,J,4,4).
int hold_knn_warp_bwd(const void* g, const void* inv, const void* xc, const void* wb,
                      void* dpts, void* dtfs, int B, int P, int J, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(dtfs, 0, (size_t)B * J * 16 * sizeof(float), s);
    if (err != cudaSuccess || P == 0 || B == 0) return err;
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    knn_warp_bwd_kernel<<<grid, BLOCK, 0, s>>>((const float*)g, (const float*)inv,
                                               (const float*)xc, (const float*)wb,
                                               (float*)dpts, (float*)dtfs, P, J);
    return cudaGetLastError();
}

// pts (B,P,3), verts (B,V,3), w (B,V,J), tfs (B,J,4,4) -> inv (B,P,9), wb (B,P,J).
int hold_knn_jinv_fwd(const void* pts, const void* verts, const void* w, const void* tfs,
                      void* inv_out, void* wb_out, int B, int P, int V, int J, int K,
                      void* stream) {
    if (P == 0 || B == 0) return cudaSuccess;
    const size_t smem = (size_t)V * sizeof(float4);
    cudaError_t err = allow_smem(knn_jinv_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    knn_jinv_fwd_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)verts, (const float*)w, (const float*)tfs,
        (float*)inv_out, (float*)wb_out, P, V, J, K);
    return cudaGetLastError();
}

// g (B,P,9), inv (B,P,9), wb (B,P,J) -> dtfs (B,J,4,4) (rotation block only).
int hold_knn_jinv_bwd(const void* g, const void* inv, const void* wb, void* dtfs, int B,
                      int P, int J, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(dtfs, 0, (size_t)B * J * 16 * sizeof(float), s);
    if (err != cudaSuccess || P == 0 || B == 0) return err;
    const dim3 grid((P + BLOCK - 1) / BLOCK, B);
    knn_jinv_bwd_kernel<<<grid, BLOCK, 0, s>>>((const float*)g, (const float*)inv,
                                               (const float*)wb, (float*)dtfs, P, J);
    return cudaGetLastError();
}

}  // extern "C"
