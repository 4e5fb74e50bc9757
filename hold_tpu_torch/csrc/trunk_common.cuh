// The bf16 8x256 softplus100 SDF trunk's packed layout and the per-point
// helpers shared by the fused sampler query (fused_query.cu), the fused
// render (fused_render.cu) and the fused training shade (fused_shade.cu):
// the pack's offsets, bf16 pairs, the embedding row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H = 256;                // trunk width
constexpr int EP = 48;                // embedding columns multiplied (3 k-steps)

// Packed bf16 trunk (ops/fused_query.py pack_trunk_weights), every matrix
// (out, in) row-major.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
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
