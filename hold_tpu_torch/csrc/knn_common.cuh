// KNN skinning-weight blend shared by the deformer kernels (knn.cu) and the
// fused sampler query (fused_query.cu).  Both must see bit-identical squared
// distances: the K-th smallest distinct d2 often falls inside a cluster of
// distances equal up to rounding, so every d2 is evaluated here, once, with
// round-to-nearest intrinsics and no FMA contraction.
//
// Semantics are the TPU kernels', not the jnp fallback's: the K nearest
// vertices are every vertex whose unclamped squared distance is <= the K-th
// smallest DISTINCT squared distance (ties included), confidences are
// exp(-min(d2, 4)) normalised over that set.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 16;     // largest K the register top-list holds
constexpr int JMAX = 16;     // largest joint count (MANO has 16)
constexpr float CLAMP = 4.0f;
constexpr float BIG = 1e9f;

__device__ __forceinline__ float sq3(float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// v.w holds |v|^2.
__device__ __forceinline__ float sqdist(const float4 v, float px, float py, float pz,
                                        float psq) {
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(v.x, px), __fmul_rn(v.y, py)), __fmul_rn(v.z, pz));
    return fmaxf(__fsub_rn(__fadd_rn(v.w, psq), __fmul_rn(2.0f, cross)), 0.0f);
}

// Adjugate inverse of a row-major 3x3 with the JAX package's determinant
// clamp (utils/transforms.py inverse_mat3).
__device__ __forceinline__ void inv3(const float* m, float* o) {
    const float a = m[0], b = m[1], c = m[2];
    const float d = m[3], e = m[4], f = m[5];
    const float g = m[6], h = m[7], i = m[8];
    const float A = e * i - f * h;
    const float B = -(d * i - f * g);
    const float C = d * h - e * g;
    const float det = a * A + b * B + c * C;
    const float sgn = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
    const float dd = fabsf(det) < 1e-12f ? sgn * 1e-12f + 1e-20f : det;
    const float r = 1.0f / dd;
    o[0] = A * r;
    o[1] = -(b * i - c * h) * r;
    o[2] = (b * f - c * e) * r;
    o[3] = B * r;
    o[4] = (a * i - c * g) * r;
    o[5] = -(a * f - c * d) * r;
    o[6] = C * r;
    o[7] = -(a * h - b * g) * r;
    o[8] = (a * e - b * d) * r;
}

// Two sweeps over the frame's vertices (staged in shared memory).  Sweep 1
// keeps the running minimum and the KMAX smallest distinct d2 in a sorted
// register list; sweep 2 blends the skinning weights of every vertex at or
// under the K-th value.  Returns the running minimum; wb gets the normalised
// blend.
__device__ __forceinline__ float knn_blend(const float4* __restrict__ s_verts, int V,
                                           const float* __restrict__ w, int J, int K,
                                           float px, float py, float pz, float* wb) {
    const float psq = sq3(px, py, pz);
    float top[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) top[k] = BIG;
    float dmin = INFINITY;
    for (int v = 0; v < V; ++v) {
        const float d2 = sqdist(s_verts[v], px, py, pz, psq);
        dmin = fminf(dmin, d2);
        if (d2 < top[KMAX - 1]) {
            bool dup = false;
#pragma unroll
            for (int k = 0; k < KMAX; ++k) dup |= (top[k] == d2);
            if (!dup) {
                float x = d2;
#pragma unroll
                for (int k = 0; k < KMAX; ++k) {
                    const float t = top[k];
                    const bool lt = x < t;
                    top[k] = lt ? x : t;
                    x = lt ? t : x;
                }
            }
        }
    }
    float kth = top[0];
#pragma unroll
    for (int k = 1; k < KMAX; ++k)
        if (k == K - 1) kth = top[k];

#pragma unroll
    for (int j = 0; j < JMAX; ++j) wb[j] = 0.0f;
    float csum = 0.0f;
    for (int v = 0; v < V; ++v) {
        const float d2 = sqdist(s_verts[v], px, py, pz, psq);
        if (d2 <= kth) {
            const float c = expf(-fminf(d2, CLAMP));
            csum += c;
            const float* wr = w + (size_t)v * J;
#pragma unroll
            for (int j = 0; j < JMAX; ++j)
                if (j < J) wb[j] += c * __ldg(wr + j);
        }
    }
    const float rs = 1.0f / csum;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) wb[j] *= rs;
    return dmin;
}

// Stage one frame's vertices (xyz, |v|^2) and bone transforms in shared memory.
__device__ __forceinline__ void stage_frame(const float* __restrict__ verts,
                                            const float* __restrict__ tfs, int V, int J,
                                            float4* s_verts, float* s_tf) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
        const float x = verts[3 * v], y = verts[3 * v + 1], z = verts[3 * v + 2];
        s_verts[v] = make_float4(x, y, z, sq3(x, y, z));
    }
    for (int i = threadIdx.x; i < J * 16; i += blockDim.x) s_tf[i] = tfs[i];
    __syncthreads();
}

// Inverse skinning of one point with its blended weights: A = sum_j wb_j T_j
// (rows 0..2 of the 4x4), inv = A[:3,:3]^-1, xc = inv (p - A[:3,3]).
__device__ __forceinline__ void inverse_skin(const float* wb, const float* s_tf, int J,
                                             float px, float py, float pz, float* inv,
                                             float* xc) {
    float A[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < JMAX; ++j)
            if (j < J) s += wb[j] * s_tf[j * 16 + c];
        A[c] = s;
    }
    const float r[9] = {A[0], A[1], A[2], A[4], A[5], A[6], A[8], A[9], A[10]};
    inv3(r, inv);
    const float d0 = px - A[3], d1 = py - A[7], d2 = pz - A[11];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        xc[i] = inv[3 * i] * d0 + inv[3 * i + 1] * d1 + inv[3 * i + 2] * d2;
}

}  // namespace
