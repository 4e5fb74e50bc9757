// The bf16 8x256 softplus100 SDF trunk on the tensor cores, shared by the
// fused sampler query (fused_query.cu) and the fused render (fused_render.cu).
//
// A warp owns 16 rows (points) of a tile and multiplies them with
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  Activations live in shared
// memory as bf16 rows; weights are (out, in) row-major bf16 matrices read as
// B fragments straight from device memory (they stay in L1/L2).  The
// fragment layout of an m16n16 block of the f32 output equals the A fragment
// layout of an m16k16 block of the next product (lane (g, t) holds rows g and
// g + 8 at columns 2t, 2t+1 and 2t+8, 2t+9), which the render kernel uses to
// keep values it alone reads back in lane-private scratch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float softplus100(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(100.0f * x))) / 100.0f;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
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

// acc[nt] += A . W[n0 + 8 nt + (0..7), 0 .. 16 KS)^T, nt = 0..NT-1.
template <int KS, int NT = 4>
__device__ __forceinline__ void mma_pass(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* __restrict__ W, int ldw, int n0,
                                         int lane) {
    const __nv_bfloat16* wl = W + (size_t)(n0 + (lane >> 2)) * ldw + 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* w = wl + (size_t)(8 * nt) * ldw + 16 * ks;
            mma_bf16(acc[nt], a[ks], ldg32(w), ldg32(w + 8));
        }
    }
}

// One trunk layer on a warp's 16 rows: softplus100(src . W^T [+ emb . We^T]
// + b).  The input fragments are in registers before any lane writes, so dst
// may be the source rows.  Hidden layers write bf16 to dst; the LAST layer
// keeps f32 and adds its dot with the head row into rowsum (rows g, g + 8).
// With SIG (the render kernel) every layer also writes sigmoid(100 a), the
// derivative of softplus100, rounded to bf16, to the lane's scratch words
// 2 nt' + (0: row g, 1: row g + 8) of global n-tile nt' (stride 32 words),
// and the LAST layer also writes its activation rounded to bf16 to dst.
template <int KS, bool SKIP, bool LAST, bool SIG = false>
__device__ __forceinline__ void trunk_layer(const __nv_bfloat16* src, int lds,
                                            const __nv_bfloat16* __restrict__ W, int ldw,
                                            const __nv_bfloat16* emb,
                                            const __nv_bfloat16* __restrict__ We,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ head_w,
                                            __nv_bfloat16* dst, int lane, float (&rowsum)[2],
                                            uint32_t* sig = nullptr) {
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
            float v[4];
            if constexpr (SIG) {
                float s[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float x = acc[nt][r] + ((r & 1) ? b1 : b0);
                    const float e = expf(-fabsf(100.0f * x));
                    v[r] = fmaxf(x, 0.0f) + log1pf(e) / 100.0f;
                    s[r] = (x >= 0.0f ? 1.0f : e) / (1.0f + e);
                }
                const int w = 2 * (n0 / 8 + nt);
                sig[w * 32] = pack_bf16(s[0], s[1]);
                sig[(w + 1) * 32] = pack_bf16(s[2], s[3]);
            } else {
                v[0] = softplus100(acc[nt][0] + b0);
                v[1] = softplus100(acc[nt][1] + b1);
                v[2] = softplus100(acc[nt][2] + b0);
                v[3] = softplus100(acc[nt][3] + b1);
            }
            if constexpr (LAST) {
                const float h0 = __ldg(head_w + col), h1 = __ldg(head_w + col + 1);
                rowsum[0] += v[0] * h0 + v[1] * h1;
                rowsum[1] += v[2] * h0 + v[3] * h1;
            }
            if constexpr (!LAST || SIG) {
                *reinterpret_cast<__nv_bfloat162*>(dst + g * LDA + col) =
                    __floats2bfloat162_rn(v[0], v[1]);
                *reinterpret_cast<__nv_bfloat162*>(dst + (g + 8) * LDA + col) =
                    __floats2bfloat162_rn(v[2], v[3]);
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

}  // namespace
