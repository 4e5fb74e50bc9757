// The per-point shade of the fused render and of the fused training shade's
// forward, hand-written for Hopper: the trunk keeping each layer's
// sigmoid(100 a), the SDF and feature heads, the reverse pass through the
// scalar head for dSDF/dx_c, the normal and the 'pose'-mode colour MLP, on
// a warp's 16 rows (fused_render.cu's header says how, and why the lane
// scratch).  Included by fused_render.cu (the render, with its warps) and
// fused_shade.cu (the training shade, from x_c and J^-1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trunk_common.cuh"

namespace {

constexpr int TILE = 128;             // points per CTA
constexpr int WARPS = TILE / 16;      // each warp owns one 16-row MMA tile
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int C0A = 16;               // colour layer-0 columns for [x_c | n | 0 ...]
constexpr int PT = 13;                // per-point floats in shared: x_c 3 | J^-1 9 | dist

// Transposed trunk pack (ops/fused_render.py pack_trunk_transposed): every
// matrix (in, out) row-major, the B operand of the reverse products; then
// the feature head (rows 1: of the output layer), (out, in).
constexpr int OFF_W0T = 0;                   // 48 x 256
constexpr int OFF_W1T = OFF_W0T + EP * H;
constexpr int OFF_W2T = OFF_W1T + H * H;
constexpr int OFF_W3T = OFF_W2T + H * H;     // columns >= 256 - E zero
constexpr int OFF_W4HT = OFF_W3T + H * H;    // rows >= 256 - E zero
constexpr int OFF_W4ET = OFF_W4HT + H * H;   // 48 x 256
constexpr int OFF_W5T = OFF_W4ET + EP * H;
constexpr int OFF_W6T = OFF_W5T + H * H;
constexpr int OFF_W7T = OFF_W6T + H * H;
constexpr int OFF_FEAT = OFF_W7T + H * H;
// Colour pack (pack_color_weights), (out, in) row-major bf16, and its f32
// biases: feature head | layer 1 | layer 2 | layer 3 | layer 4 (3 used).
constexpr int OFF_C0A = 0;                   // 256 x 16, columns >= 6 zero
constexpr int OFF_C0F = OFF_C0A + H * C0A;
constexpr int OFF_C1 = OFF_C0F + H * H;
constexpr int OFF_C2 = OFF_C1 + H * H;
constexpr int OFF_C3 = OFF_C2 + H * H;
constexpr int OFF_C4 = OFF_C3 + H * H;       // 8 x 256, rows >= 3 zero
// Lane scratch, in words of 32 bits, word w of a lane at w * 32.
constexpr int SCR_SIG = 0;                   // 8 layers x 64 bf16 pairs
constexpr int SCR_FEAT = 8 * 64;             // 64 bf16 pairs, A-fragment order
constexpr int SCR_DEMB = SCR_FEAT + 64;      // 24 f32: d emb partial, 6 n-tiles
constexpr int SCR_WORDS = SCR_DEMB + 24;

struct RenderArgs {
    const float* pts;      // (B, N, 3); the training shade's x_c
    const float* jinv;     // the training shade's J^-1, (B, N, 9) row-major
    const float* verts;    // posed vertices (B, V, 3)       [HAND]
    const float* verts_c;  // canonical vertices (B, V, 3)   [HAND]
    const float* skin;     // skinning weights (B, V, J)     [HAND]
    const float* tfs;      // bone transforms (B, J, 4, 4)   [HAND]
    const float* tf12;     // [Rinv row-major | t] (B, 12)   [!HAND]
    const float* window;   // embedding window (E,)
    const __nv_bfloat16* wts;    // forward trunk pack
    const float* fpack;
    const __nv_bfloat16* wts_t;  // transposed trunk + feature head
    const __nv_bfloat16* cw;     // colour weights
    const float* cb;             // colour biases (5 x 256)
    const float* fb0;            // frame layer-0 bias (B, 256)
    uint32_t* scratch;           // gridDim.x * WARPS * SCR_WORDS * 32 words
    float* sdf;                  // (B, N)
    float* rgb;                  // (B, N, 3)
    float* nrm;                  // (B, N, 3)
    float* dist;                 // (B, N)
    float* xc;                   // (B, N, 3)
    int B, N, V, J, K, multires;
};

// Reverse through one trunk layer on a warp's 16 rows, in place:
// rows <- bf16((rows . WT^T) * s), s the stored sigmoid pairs of the layer
// below.  With EMB (the skip layer) also rows . WeT^T, the embedding rows of
// the gradient, to the lane's d-emb scratch.
template <bool EMB>
__device__ __forceinline__ void reverse_layer(__nv_bfloat16* rows,
                                              const __nv_bfloat16* __restrict__ WT,
                                              const uint32_t* sig,
                                              const __nv_bfloat16* __restrict__ WeT,
                                              uint32_t* demb, int lane) {
    uint32_t a[16][4];
    load_a<16>(rows, LDA, lane, a);
    __syncwarp();
    if constexpr (EMB) {
        float acc[6][4] = {};
        mma_pass<16, 6>(acc, a, WeT, H, 0, lane);
#pragma unroll
        for (int i = 0; i < 24; ++i) demb[i * 32] = __float_as_uint(acc[i / 4][i % 4]);
    }
    const int g = lane >> 2, t = lane & 3;
    for (int n0 = 0; n0 < H; n0 += NCHUNK) {
        float acc[4][4] = {};
        mma_pass<16>(acc, a, WT, H, n0, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + 8 * nt + 2 * t;
            const int w = 2 * (n0 / 8 + nt);
            const float2 s0 = unpack_bf16(sig[w * 32]), s1 = unpack_bf16(sig[(w + 1) * 32]);
            *reinterpret_cast<__nv_bfloat162*>(rows + g * LDA + col) =
                __floats2bfloat162_rn(acc[nt][0] * s0.x, acc[nt][1] * s0.y);
            *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * LDA + col) =
                __floats2bfloat162_rn(acc[nt][2] * s1.x, acc[nt][3] * s1.y);
        }
    }
    __syncwarp();
}

// rows <- bf16(relu(rows . W^T + bias)), in place.
__device__ __forceinline__ void relu_layer(__nv_bfloat16* rows, const __nv_bfloat16* __restrict__ W,
                                           const float* __restrict__ bias, int lane) {
    uint32_t a[16][4];
    load_a<16>(rows, LDA, lane, a);
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
    for (int n0 = 0; n0 < H; n0 += NCHUNK) {
        float acc[4][4] = {};
        mma_pass<16>(acc, a, W, H, n0, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + 8 * nt + 2 * t;
            const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
            *reinterpret_cast<__nv_bfloat162*>(rows + g * LDA + col) = __floats2bfloat162_rn(
                fmaxf(acc[nt][0] + b0, 0.0f), fmaxf(acc[nt][1] + b1, 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * LDA + col) = __floats2bfloat162_rn(
                fmaxf(acc[nt][2] + b0, 0.0f), fmaxf(acc[nt][3] + b1, 0.0f));
        }
    }
    __syncwarp();
}

// A warp's 16 rows (points p0 .. p0 + 15 of frame b) from the embedding to
// every output.  TRAIN (the training shade's forward) divides the normal by
// max(sqrt(|n|^2 + 1e-12), 1e-6) and writes sdf, rgb and normal only; the
// render divides by max(|n|, 1e-6) and also writes x_c and the distance.
template <bool TRAIN>
__device__ __forceinline__ void shade_rows(const RenderArgs& q, int b, int p0,
                                           __nv_bfloat16* erows, __nv_bfloat16* rows,
                                           const float* spts, uint32_t* scr, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* W = q.wts;
    const __nv_bfloat16* WT = q.wts_t;
    const float* F = q.fpack;
    uint32_t* sig = scr + SCR_SIG * 32;
    constexpr int SL = 64 * 32;  // one layer's sigmoid words
    float rowsum[2] = {0.0f, 0.0f};

    // --- forward trunk, storing sigmoid(100 a); rows end as bf16(h7)
    trunk_layer<3, false, false, true>(erows, LDE, W + OFF_W0, EP, nullptr, nullptr, F, nullptr,
                                       rows, lane, rowsum, sig);
    trunk_layer<16, false, false, true>(rows, LDA, W + OFF_W1, H, nullptr, nullptr, F + H, nullptr,
                                        rows, lane, rowsum, sig + SL);
    trunk_layer<16, false, false, true>(rows, LDA, W + OFF_W2, H, nullptr, nullptr, F + 2 * H,
                                        nullptr, rows, lane, rowsum, sig + 2 * SL);
    trunk_layer<16, false, false, true>(rows, LDA, W + OFF_W3, H, nullptr, nullptr, F + 3 * H,
                                        nullptr, rows, lane, rowsum, sig + 3 * SL);
    trunk_layer<16, true, false, true>(rows, LDA, W + OFF_W4H, H, erows, W + OFF_W4E, F + 4 * H,
                                       nullptr, rows, lane, rowsum, sig + 4 * SL);
    trunk_layer<16, false, false, true>(rows, LDA, W + OFF_W5, H, nullptr, nullptr, F + 5 * H,
                                        nullptr, rows, lane, rowsum, sig + 5 * SL);
    trunk_layer<16, false, false, true>(rows, LDA, W + OFF_W6, H, nullptr, nullptr, F + 6 * H,
                                        nullptr, rows, lane, rowsum, sig + 6 * SL);
    trunk_layer<16, false, true, true>(rows, LDA, W + OFF_W7, H, nullptr, nullptr, F + 7 * H,
                                       F + OFF_HEAD_W, rows, lane, rowsum, sig + 7 * SL);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        rowsum[0] += __shfl_xor_sync(0xffffffffu, rowsum[0], o);
        rowsum[1] += __shfl_xor_sync(0xffffffffu, rowsum[1], o);
    }
    const int pa = p0 + g, pb = p0 + g + 8;  // the lane's two rows
    const size_t qa = (size_t)b * q.N + pa, qb = (size_t)b * q.N + pb;
    if (t == 0) {
        const float hb = F[OFF_HEAD_B];
        if (pa < q.N) q.sdf[qa] = rowsum[0] + hb;
        if (pb < q.N) q.sdf[qb] = rowsum[1] + hb;
    }

    // --- feature head: bf16(h7) . Wf^T + bias, kept as bf16 A fragments
    uint32_t* feat = scr + SCR_FEAT * 32;
    {
        uint32_t a[16][4];
        load_a<16>(rows, LDA, lane, a);
        __syncwarp();
        for (int n0 = 0; n0 < H; n0 += NCHUNK) {
            float acc[4][4] = {};
            mma_pass<16>(acc, a, WT + OFF_FEAT, H, n0, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int col = n0 + 8 * nt + 2 * t;
                const float b0 = __ldg(q.cb + col), b1 = __ldg(q.cb + col + 1);
                const int w = 2 * (n0 / 8 + nt);
                feat[w * 32] = pack_bf16(acc[nt][0] + b0, acc[nt][1] + b1);
                feat[(w + 1) * 32] = pack_bf16(acc[nt][2] + b0, acc[nt][3] + b1);
            }
        }
    }

    // --- reverse pass through the scalar head: seed da7 = head_w * s7
    {
        const uint32_t* s7 = sig + 7 * SL;
        for (int nt = 0; nt < H / 8; ++nt) {
            const int col = 8 * nt + 2 * t;
            const float h0 = __ldg(F + OFF_HEAD_W + col), h1 = __ldg(F + OFF_HEAD_W + col + 1);
            const float2 s0 = unpack_bf16(s7[2 * nt * 32]), s1 = unpack_bf16(s7[(2 * nt + 1) * 32]);
            *reinterpret_cast<__nv_bfloat162*>(rows + g * LDA + col) =
                __floats2bfloat162_rn(h0 * s0.x, h1 * s0.y);
            *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * LDA + col) =
                __floats2bfloat162_rn(h0 * s1.x, h1 * s1.y);
        }
        __syncwarp();
    }
    uint32_t* demb = scr + SCR_DEMB * 32;
    reverse_layer<false>(rows, WT + OFF_W7T, sig + 6 * SL, nullptr, nullptr, lane);
    reverse_layer<false>(rows, WT + OFF_W6T, sig + 5 * SL, nullptr, nullptr, lane);
    reverse_layer<false>(rows, WT + OFF_W5T, sig + 4 * SL, nullptr, nullptr, lane);
    reverse_layer<true>(rows, WT + OFF_W4HT, sig + 3 * SL, WT + OFF_W4ET, demb, lane);
    reverse_layer<false>(rows, WT + OFF_W3T, sig + 2 * SL, nullptr, nullptr, lane);
    reverse_layer<false>(rows, WT + OFF_W2T, sig + SL, nullptr, nullptr, lane);
    reverse_layer<false>(rows, WT + OFF_W1T, sig, nullptr, nullptr, lane);

    // d emb = skip-layer part + da0 . W0
    float de[6][4];
    {
        uint32_t a[16][4];
        load_a<16>(rows, LDA, lane, a);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 24; ++i) de[i / 4][i % 4] = __uint_as_float(demb[i * 32]);
        mma_pass<16, 6>(de, a, WT + OFF_W0T, H, 0, lane);
    }

    // d emb -> dSDF/dx_c: column c is x_d (c < 3), or sin / cos of 2^k x_d
    const float* sa = spts + g * PT;
    const float* sb = spts + (g + 8) * PT;
    const int E = 3 + 6 * q.multires;
    float gx[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int c = 8 * nt + 2 * t + e;
            if (c >= E) continue;
            const float win = __ldg(q.window + c);
            int d = c;
            float f = 1.0f;
            bool trig = false, is_cos = false;
            if (c >= 3) {
                const int k = (c - 3) / 6, r = (c - 3) % 6;
                d = r % 3;
                f = (float)(1 << k);
                trig = true;
                is_cos = r >= 3;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float x = (h ? sb : sa)[d];
                float dv = de[nt][2 * h + e];
                if (trig) dv *= is_cos ? -sinf(x * f) : cosf(x * f);
                gx[h][d] += f * (dv * win);
            }
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int d = 0; d < 3; ++d) gx[h][d] += __shfl_xor_sync(0xffffffffu, gx[h][d], o);

    // normal, per-row outputs and the colour net's [x_c | n | 0] rows
    if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float* s = h ? sb : sa;
            float n[3];
#pragma unroll
            for (int j = 0; j < 3; ++j)
                n[j] = gx[h][0] * s[3 + j] + gx[h][1] * s[6 + j] + gx[h][2] * s[9 + j];
            float denom;
            if constexpr (TRAIN)
                denom = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2] + 1e-12f), 1e-6f);
            else
                denom = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1e-6f);
#pragma unroll
            for (int j = 0; j < 3; ++j) n[j] = n[j] / denom;
            __nv_bfloat16* er = erows + (g + 8 * h) * LDE;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                er[j] = __float2bfloat16_rn(s[j]);
                er[3 + j] = __float2bfloat16_rn(n[j]);
            }
#pragma unroll
            for (int c = 6; c < C0A; ++c) er[c] = __float2bfloat16_rn(0.0f);
            const int p = h ? pb : pa;
            const size_t qi = h ? qb : qa;
            if (p < q.N) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    q.nrm[3 * qi + j] = n[j];
                    if constexpr (!TRAIN) q.xc[3 * qi + j] = s[j];
                }
                if constexpr (!TRAIN) q.dist[qi] = s[12];
            }
        }
    }
    __syncwarp();

    // --- colour MLP, layer 0: [x_c | n | 0] . C0a + bf16(feat) . C0f + frame bias
    const __nv_bfloat16* CW = q.cw;
    {
        uint32_t a0[1][4], a[16][4];
        load_a<1>(erows, LDE, lane, a0);
#pragma unroll
        for (int ks = 0; ks < 16; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) a[ks][r] = feat[(4 * ks + r) * 32];
        const float* fb = q.fb0 + (size_t)b * H;
        for (int n0 = 0; n0 < H; n0 += NCHUNK) {
            float acc[4][4] = {};
            mma_pass<1>(acc, a0, CW + OFF_C0A, C0A, n0, lane);
            mma_pass<16>(acc, a, CW + OFF_C0F, H, n0, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int col = n0 + 8 * nt + 2 * t;
                const float b0 = __ldg(fb + col), b1 = __ldg(fb + col + 1);
                *reinterpret_cast<__nv_bfloat162*>(rows + g * LDA + col) = __floats2bfloat162_rn(
                    fmaxf(acc[nt][0] + b0, 0.0f), fmaxf(acc[nt][1] + b1, 0.0f));
                *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * LDA + col) =
                    __floats2bfloat162_rn(fmaxf(acc[nt][2] + b0, 0.0f),
                                          fmaxf(acc[nt][3] + b1, 0.0f));
            }
        }
        __syncwarp();
    }
    relu_layer(rows, CW + OFF_C1, q.cb + H, lane);
    relu_layer(rows, CW + OFF_C2, q.cb + 2 * H, lane);
    relu_layer(rows, CW + OFF_C3, q.cb + 3 * H, lane);
    {
        uint32_t a[16][4];
        load_a<16>(rows, LDA, lane, a);
        float acc[1][4] = {};
        mma_pass<16, 1>(acc, a, CW + OFF_C4, H, 0, lane);
        const float* b4 = q.cb + 4 * H;
        if (t < 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = h ? pb : pa;
                if (p >= q.N) continue;
                const size_t qi = h ? qb : qa;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = 2 * t + e;
                    if (c < 3)
                        q.rgb[3 * qi + c] = 1.0f / (1.0f + expf(-(acc[0][2 * h + e] + __ldg(b4 + c))));
                }
            }
        }
        __syncwarp();
    }
}

}  // namespace
