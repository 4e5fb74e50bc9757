// The per-point shade of the fused render (rows 8-9, fused_render.cu) and of
// the fused training shade's forward (row 7, fused_shade.cu), hand-written for
// Hopper (sm_90a) on the CTA-level block of cta_gemm.cuh; and the packs'
// offsets the training shade's backward shares.
//
// Per canonical point x_c with its J^-1, as ops/fused_render.py _shade_plain:
// the embedding; the 8x256 softplus100 trunk, keeping each layer's
// sigmoid(100 a) in bf16; layer 7 in f32 into the f32 SDF head; the feature
// head on bf16(h7) plus its bias, rounded to bf16; the reverse pass through
// the scalar head, d7 = bf16(head_w s7), d_{l-1} = bf16((d_l . W_l) s_{l-1}),
// the skip layer's and layer 0's embedding rows summed into d emb; d emb ->
// dSDF/dx_c -> the normal n_j = sum_i g_i J^-1[3i+j] over
// max(sqrt(|n|^2 + 1e-12), 1e-6) (TRAIN) or max(|n|, 1e-6) (the render); the
// 'pose'-mode colour MLP: [x_c | n | 0] . C0a + bf16(feat) . C0f + the
// frame's bias, relu, three 256x256 relu layers, three outputs plus bias,
// sigmoid in f32.  Outputs sdf, rgb, normal.
//
// Design.  A persistent grid, one CTA an SM (384 threads, 216 KB of shared
// memory), loops over tiles of 128 points of the flattened (B, N); each row
// takes its own frame's bias.  Warps 0-7 are two consumer warpgroups of 64
// rows; one thread of the last warpgroup streams the forward's 82 weight
// stages (ops/fused_render.py tile_shade_fwd: the first 82 of the backward's
// stream) through a 4-stage ring with cp.async.bulk, once a tile, running on
// into the next tile's.  Every product is wgmma with both operands in shared
// memory: m64n256k16 on the 128 x 256 bf16 tile that the epilogue before wrote
// in place; W0 (48 columns) and C0a (16) on a 128 x 64 tile that holds the
// embedding, then [x_c | n | 0]; the two d-emb products m64n48, the colour
// head m64n8.  The trunk's softplus and sigmoid use the hardware's ex2, lg2
// and rcp approximations, as the fused query's softplus100_fast does.
//
// Scratch.  The reverse pass reads the eight layers' sigmoids back, 4 KB a
// point (512 KB a tile), and the colour net the features, 512 B a point,
// after the reverse pass has used the tile: more than shared memory holds.
// They go to device memory, to a scratch sized for the resident CTAs (the
// grid loops over the tiles): a consumer thread writes and reads back its own
// accumulator fragments only, in 16-byte slots (Q_*), lane-interleaved so
// that a warp's access is 512 contiguous bytes, and reads a block of slots
// before its first store.  2,400 B a thread, 600 KB a CTA, 79 MB for 132
// CTAs, more than L2's 50 MB; each point writes 4,800 B and reads them back,
// 1.20 GB a training node of 125,440 points (0.36 ms at 3.35 TB/s) against
// 0.32 ms of tensor-core work at the bf16 peak.  Measured on an H100 80GB
// HBM3 at 700 W (scripts/probe_shade_fwd.py), the scratch's bytes are the
// largest part of the kernel: 1.54 ms a training node with them, 1.04
// without.  Each line is dropped from L2 once it is read (each_slot), which
// spares its write-back: 1.60 ms without that.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cta_gemm.cuh"
#include "trunk_common.cuh"

namespace {

constexpr int C0A = 16;  // colour layer-0 columns for [x_c | n | 0 ...]

// Transposed trunk pack (ops/fused_render.py pack_trunk_transposed): every
// matrix (in, out) row-major; then the feature head (rows 1: of the output
// layer), (out, in).
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

namespace shade {

using bf16 = __nv_bfloat16;

constexpr int ROWS = cta::TILE_M;                    // points a tile
constexpr int CONSUMERS = 32 * cta::CONSUMER_WARPS;  // 256 threads
constexpr int THREADS = CONSUMERS + 128;             // + the producer's warpgroup
constexpr int STAGES = 4;                            // the weight ring's depth
constexpr int N_SLABS = 82;                          // stages a tile consumes
using Ring = cta::RingT<STAGES>;

// A consumer thread's scratch, in 16-byte slots: per trunk layer 16 slots of
// sigmoid pairs (slot q: the bf16 pairs of columns 16 q + 2 t, + 1 and
// 16 q + 8 + 2 t, + 1 of its rows g and g + 8), the features alike, d emb's
// skip-layer part in f32.
constexpr int Q_SIG = 0;
constexpr int Q_FEAT = Q_SIG + 8 * 16;
constexpr int Q_DEMB = Q_FEAT + 16;
constexpr int Q_LANE = Q_DEMB + 6;
constexpr int SCRATCH_WORDS = cta::CONSUMER_WARPS * Q_LANE * 32 * 4;  // a CTA, 32-bit words

// per-row values in shared memory: x_c | J^-1
constexpr int RX = 0, RJ = 3, RW = 13;

// dynamic shared memory, from a 1024-byte aligned base
constexpr int S_RING = 0;
constexpr int S_CUR = S_RING + STAGES * cta::SLAB_BYTES;  // 128 x 256 bf16: the chain's A tile
constexpr int S_SMALL = S_CUR + 4 * cta::A_SLAB_BYTES;    // 128 x 64: the narrow A tile
constexpr int S_RD = S_SMALL + cta::A_SLAB_BYTES;
constexpr int S_BAR = S_RD + ROWS * RW * 4;
constexpr int SMEM_BYTES = S_BAR + 2 * STAGES * 8 + 1024;  // + room to align the base

struct Args {
    const float* xc;      // (total, 3)
    const float* jinv;    // (total, 9) row-major
    const float* fb0;     // frame layer-0 bias (B, 256)
    const float* window;  // (E,)
    const float* F;       // the trunk's biases | head row | head bias
    const float* CB;      // colour biases (5 x 256)
    const bf16* slabs;    // the forward's weight stream
    uint4* scratch;       // gridDim.x x SCRATCH_WORDS
    float* sdf;           // (total,)
    float* rgb;           // (total, 3)
    float* nrm;           // (total, 3)
    int total, N, multires;
};

// What a consumer thread knows of its place.
struct Place {
    int row0;               // the warp's first row in the flattened points
    unsigned char* cur_w;   // the warp's rows of the chain's A tile
    unsigned char* small_w; // ... of the narrow A tile
    uint32_t cur_wg, small_wg;  // the warpgroup's first row of each, shared addresses
    float* rd;              // the warp's rows of the per-row values
    uint4* sq;              // the thread's scratch: slot s at sq[32 s]
    int lane, wg;
};

// a bf16 pair, or a packed one, into an A tile (cta_gemm.cuh's swizzle), row of the warp
__device__ __forceinline__ void st2t(unsigned char* tile_w, int row, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(tile_w + cta::a_offset(row, col)) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void stw(unsigned char* tile_w, int row, int col, uint32_t w) {
    *reinterpret_cast<uint32_t*>(tile_w + cta::a_offset(row, col)) = w;
}
__device__ __forceinline__ float2 ldg2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}

// what the warpgroup's threads have written to the A tiles becomes visible to
// its next wgmma
__device__ __forceinline__ void publish(const Place& pl) {
    cta::fence_proxy_async();
    cta::named_barrier(1 + pl.wg, 128);
}

// d = cur . W^T over the ring's next four slabs, with TAIL48 one more
// 48-column slab against the narrow tile (the skip layer's embedding)
__device__ __forceinline__ void full_product(float (&d)[128], const Place& pl, Ring& ring,
                                             bool tail48 = false) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
        cta::mma_slab<4>(d, pl.cur_wg + s * cta::A_SLAB_BYTES, ring, s > 0, s > 0);
    if (tail48) cta::mma_slab<3>(d, pl.small_wg, ring, true, true);
    cta::mma_done(d, ring);
}

// a narrow slab (KS k-steps) against the narrow tile, then with THEN_FULL
// cur's four
template <int KS, bool THEN_FULL>
__device__ __forceinline__ void head_product(float (&d)[128], const Place& pl, Ring& ring) {
    cta::mma_slab<KS>(d, pl.small_wg, ring, false, false);
    if constexpr (THEN_FULL) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
            cta::mma_slab<4>(d, pl.cur_wg + s * cta::A_SLAB_BYTES, ring, true, true);
    }
    cta::mma_done(d, ring);
}

// softplus(100 a) / 100 (the fused query's softplus100_fast) and
// sigmoid(100 a), from one ex2.approx, with lg2.approx and rcp.approx
__device__ __forceinline__ void softplus_sigmoid(float a, float& h, float& s) {
    const float e = __expf(-fabsf(100.0f * a));
    h = fmaxf(a, 0.0f) + __logf(1.0f + e) * 0.01f;
    s = __fdividef(a >= 0.0f ? 1.0f : e, 1.0f + e);
}

// Trunk layer epilogue on the accumulator: a = d + bias, h = softplus100(a)
// into the chain's tile in bf16 (in place), bf16(sigmoid(100 a)) to the
// layer's scratch slots; the LAST layer also dots f32 h with the head row
// into rowsum (rows g, g + 8).
template <bool LAST>
__device__ __forceinline__ void trunk_epilogue(const float (&d)[128], const float* bias,
                                               const float* head_w, const Place& pl, uint4* sig,
                                               float (&rowsum)[2]) {
    const int g = pl.lane >> 2, t = pl.lane & 3;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * q + jj, col = 8 * j + 2 * t;
            const float2 b = ldg2(bias + col);
            float h[4], s[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                softplus_sigmoid(d[4 * j + r] + ((r & 1) ? b.y : b.x), h[r], s[r]);
            w[2 * jj] = pack_bf16(s[0], s[1]);
            w[2 * jj + 1] = pack_bf16(s[2], s[3]);
            st2t(pl.cur_w, g, col, h[0], h[1]);
            st2t(pl.cur_w, g + 8, col, h[2], h[3]);
            if constexpr (LAST) {
                const float2 hw = ldg2(head_w + col);
                rowsum[0] += h[0] * hw.x + h[1] * hw.y;
                rowsum[1] += h[2] * hw.x + h[3] * hw.y;
            }
        }
        sig[32 * q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// fn(q, slot) for the 16 scratch slots from `src` on, in blocks of NB whose
// loads are all in flight before the block's first store: the compiler must
// take the epilogue's shared-memory stores to alias its later loads.  Each
// slot is read once, so once the warp has read a block, the lanes that start
// a 128-byte line drop it from L2 (discard.global.L2), which then writes none
// of it back to memory.
template <int NB, class Fn>
__device__ __forceinline__ void each_slot(const uint4* src, Fn fn) {
#pragma unroll
    for (int q0 = 0; q0 < 16; q0 += NB) {
        uint4 v[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) v[i] = src[32 * (q0 + i)];
#pragma unroll
        for (int i = 0; i < NB; ++i) fn(q0 + i, v[i]);
        __syncwarp();
        if ((threadIdx.x & 7) == 0) {
#pragma unroll
            for (int i = 0; i < NB; ++i)
                asm volatile("discard.global.L2 [%0], 128;" ::"l"(src + 32 * (q0 + i)) : "memory");
        }
    }
}

// the chain's tile <- bf16(x * s) for the accumulator x and the sigmoid pairs
// of slot q (columns 16 q + 2 t and 16 q + 8 + 2 t); with HEAD x is the head row
template <bool HEAD>
__device__ __forceinline__ void scale_slot(const float (&d)[128], const float* head_w,
                                           const Place& pl, int q, uint4 s) {
    const int g = pl.lane >> 2, t = pl.lane & 3;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * q + jj, col = 8 * j + 2 * t;
        const float2 s0 = unpack_bf16(jj ? s.z : s.x), s1 = unpack_bf16(jj ? s.w : s.y);
        if constexpr (HEAD) {
            const float2 hw = ldg2(head_w + col);
            st2t(pl.cur_w, g, col, hw.x * s0.x, hw.y * s0.y);
            st2t(pl.cur_w, g + 8, col, hw.x * s1.x, hw.y * s1.y);
        } else {
            st2t(pl.cur_w, g, col, d[4 * j] * s0.x, d[4 * j + 1] * s0.y);
            st2t(pl.cur_w, g + 8, col, d[4 * j + 2] * s1.x, d[4 * j + 3] * s1.y);
        }
    }
}

// the chain's tile <- bf16(relu(d + b)), b the bias of row g (ba) and g + 8 (bb)
__device__ __forceinline__ void relu_epilogue(const float (&d)[128], const float* ba,
                                              const float* bb, const Place& pl) {
    const int g = pl.lane >> 2, t = pl.lane & 3;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 b0 = ldg2(ba + col), b1 = ldg2(bb + col);
        st2t(pl.cur_w, g, col, fmaxf(d[4 * j] + b0.x, 0.0f), fmaxf(d[4 * j + 1] + b0.y, 0.0f));
        st2t(pl.cur_w, g + 8, col, fmaxf(d[4 * j + 2] + b1.x, 0.0f),
             fmaxf(d[4 * j + 3] + b1.y, 0.0f));
    }
}

// One tile of 128 points, from a consumer thread: its warp's 16 rows through
// every product of its warpgroup.
template <bool TRAIN>
__device__ __forceinline__ void shade_tile(const Args& q, const Place& pl, Ring& ring) {
    const int lane = pl.lane, g = lane >> 2, t = lane & 3;
    const float* F = q.F;
    float d[128];

    // --- the rows: x_c and J^-1 to shared memory, the embedding to the narrow tile
    if (lane < 16) {
        const int qi = pl.row0 + lane;
        float* r = pl.rd + lane * RW;
        float x[3] = {0.0f, 0.0f, 0.0f};
        float jv[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
        if (qi < q.total) {
#pragma unroll
            for (int c = 0; c < 3; ++c) x[c] = q.xc[3 * (size_t)qi + c];
#pragma unroll
            for (int c = 0; c < 9; ++c) jv[c] = q.jinv[9 * (size_t)qi + c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) r[RX + c] = x[c];
#pragma unroll
        for (int c = 0; c < 9; ++c) r[RJ + c] = jv[c];
        __align__(16) bf16 e[EP];
        write_embedding(x, q.window, q.multires, e);
#pragma unroll
        for (int c = 0; c < EP / 8; ++c)
            *reinterpret_cast<uint4*>(pl.small_w + cta::a_offset(lane, 8 * c)) =
                *reinterpret_cast<const uint4*>(e + 8 * c);
    }
    publish(pl);

    // --- trunk; the tile ends as bf16(h7)
    float rowsum[2] = {0.0f, 0.0f};
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
        if (l == 0)
            head_product<3, false>(d, pl, ring);
        else
            full_product(d, pl, ring, l == 4);
        uint4* sig = pl.sq + 32 * (Q_SIG + 16 * l);
        if (l < 7)
            trunk_epilogue<false>(d, F + l * H, nullptr, pl, sig, rowsum);
        else
            trunk_epilogue<true>(d, F + l * H, F + OFF_HEAD_W, pl, sig, rowsum);
        publish(pl);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        rowsum[0] += __shfl_xor_sync(0xffffffffu, rowsum[0], o);
        rowsum[1] += __shfl_xor_sync(0xffffffffu, rowsum[1], o);
    }
    if (t == 0) {
        const float hb = __ldg(F + OFF_HEAD_B);
        if (pl.row0 + g < q.total) q.sdf[pl.row0 + g] = rowsum[0] + hb;
        if (pl.row0 + g + 8 < q.total) q.sdf[pl.row0 + g + 8] = rowsum[1] + hb;
    }

    // --- feature head, bf16(h7) . Wf^T + bias, to the scratch in bf16; the
    // tile then takes d7 = head_w s7, the reverse pass's first operand
    full_product(d, pl, ring);
    {
        uint4* feat = pl.sq + 32 * Q_FEAT;
        each_slot<4>(pl.sq + 32 * (Q_SIG + 16 * 7), [&](int qs, uint4 s) {
            uint32_t w[4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * qs + jj;
                const float2 cb = ldg2(q.CB + 8 * j + 2 * t);
                w[2 * jj] = pack_bf16(d[4 * j] + cb.x, d[4 * j + 1] + cb.y);
                w[2 * jj + 1] = pack_bf16(d[4 * j + 2] + cb.x, d[4 * j + 3] + cb.y);
            }
            feat[32 * qs] = make_uint4(w[0], w[1], w[2], w[3]);
            scale_slot<true>(d, F + OFF_HEAD_W, pl, qs, s);
        });
    }
    publish(pl);

    // --- reverse pass: d_{l-1} = bf16((d_l . W_l) s_{l-1}); the skip layer's
    // embedding rows of the gradient wait in the scratch
#pragma unroll 1
    for (int l = 7; l >= 1; --l) {
        if (l == 4) {
            float de[24];
            cta::narrow_product<48>(de, pl.cur_wg, ring, false);
#pragma unroll
            for (int i = 0; i < 6; ++i)
                pl.sq[32 * (Q_DEMB + i)] =
                    make_uint4(__float_as_uint(de[4 * i]), __float_as_uint(de[4 * i + 1]),
                               __float_as_uint(de[4 * i + 2]), __float_as_uint(de[4 * i + 3]));
        }
        full_product(d, pl, ring);
        each_slot<4>(pl.sq + 32 * (Q_SIG + 16 * (l - 1)),
                     [&](int qs, uint4 s) { scale_slot<false>(d, nullptr, pl, qs, s); });
        publish(pl);
    }
    // d emb = the skip layer's part + d0 . W0
    float de[24];
    cta::narrow_product<48>(de, pl.cur_wg, ring, false);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const uint4 v = pl.sq[32 * (Q_DEMB + i)];
        de[4 * i] = __uint_as_float(v.x) + de[4 * i];
        de[4 * i + 1] = __uint_as_float(v.y) + de[4 * i + 1];
        de[4 * i + 2] = __uint_as_float(v.z) + de[4 * i + 2];
        de[4 * i + 3] = __uint_as_float(v.w) + de[4 * i + 3];
    }

    // --- d emb -> dSDF/dx_c: column c is x_d (c < 3), or sin / cos of 2^k x_d
    const int E = 3 + 6 * q.multires;
    float gx[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int c = 8 * nt + 2 * t + e;
            if (c >= E) continue;
            const float win = __ldg(q.window + c);
            int dd = c;
            float f = 1.0f;
            int kind = 0;
            if (c >= 3) {
                const int k = (c - 3) / 6, r = (c - 3) % 6;
                dd = r % 3;
                f = (float)(1 << k);
                kind = r >= 3 ? 2 : 1;
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const float x = pl.rd[(g + 8 * hh) * RW + RX + dd];
                float dv = de[4 * nt + 2 * hh + e];
                if (kind) dv *= kind == 2 ? -sinf(x * f) : cosf(x * f);
                const float v = f * (dv * win);
                // selects, not an index: the sums stay in registers
                gx[hh][0] += dd == 0 ? v : 0.0f;
                gx[hh][1] += dd == 1 ? v : 0.0f;
                gx[hh][2] += dd == 2 ? v : 0.0f;
            }
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int c = 0; c < 3; ++c) gx[hh][c] += __shfl_xor_sync(0xffffffffu, gx[hh][c], o);

    // --- the normal, and the colour net's [x_c | n | 0] rows in the narrow tile
    if (t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = g + 8 * hh, qi = pl.row0 + row;
            const float* r = pl.rd + row * RW;
            float n[3];
#pragma unroll
            for (int j = 0; j < 3; ++j)
                n[j] = gx[hh][0] * r[RJ + j] + gx[hh][1] * r[RJ + 3 + j] + gx[hh][2] * r[RJ + 6 + j];
            const float nn = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
            const float den = TRAIN ? fmaxf(sqrtf(nn + 1e-12f), 1e-6f) : fmaxf(sqrtf(nn), 1e-6f);
            __align__(16) bf16 inp[C0A];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                n[j] = n[j] / den;
                inp[j] = __float2bfloat16_rn(r[RX + j]);
                inp[3 + j] = __float2bfloat16_rn(n[j]);
                if (qi < q.total) q.nrm[3 * (size_t)qi + j] = n[j];
            }
#pragma unroll
            for (int c = 6; c < C0A; ++c) inp[c] = __float2bfloat16_rn(0.0f);
#pragma unroll
            for (int c = 0; c < C0A / 8; ++c)
                *reinterpret_cast<uint4*>(pl.small_w + cta::a_offset(row, 8 * c)) =
                    *reinterpret_cast<const uint4*>(inp + 8 * c);
        }
    }
    // the features come back, as the colour net's second operand
    each_slot<16>(pl.sq + 32 * Q_FEAT, [&](int qs, uint4 f) {
        stw(pl.cur_w, g, 16 * qs + 2 * t, f.x);
        stw(pl.cur_w, g + 8, 16 * qs + 2 * t, f.y);
        stw(pl.cur_w, g, 16 * qs + 8 + 2 * t, f.z);
        stw(pl.cur_w, g + 8, 16 * qs + 8 + 2 * t, f.w);
    });
    publish(pl);

    // --- colour MLP
    head_product<1, true>(d, pl, ring);
    {
        const int qa = min(pl.row0 + g, q.total - 1), qb = min(pl.row0 + g + 8, q.total - 1);
        relu_epilogue(d, q.fb0 + (size_t)(qa / q.N) * H, q.fb0 + (size_t)(qb / q.N) * H, pl);
    }
    publish(pl);
#pragma unroll 1
    for (int l = 1; l < 4; ++l) {
        full_product(d, pl, ring);
        relu_epilogue(d, q.CB + l * H, q.CB + l * H, pl);
        publish(pl);
    }
    float acc[4];
    cta::narrow_product<8>(acc, pl.cur_wg, ring, false);
    if (t < 2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int qi = pl.row0 + g + 8 * hh;
            if (qi >= q.total) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 2 * t + e;
                if (c < 3)
                    q.rgb[3 * (size_t)qi + c] =
                        1.0f / (1.0f + expf(-(acc[2 * hh + e] + __ldg(q.CB + 4 * H + c))));
            }
        }
    }
}

// The kernel's body: roles, then the consumers' loop over the tiles.
template <bool TRAIN>
__device__ __forceinline__ void run(const Args& q) {
    extern __shared__ unsigned char shade_smem_raw[];
    unsigned char* smem = shade_smem_raw + ((1024 - (cta::smem_u32(shade_smem_raw) & 1023)) & 1023);
    const int tid = threadIdx.x;
    const int ntiles = (q.total + ROWS - 1) / ROWS;
    Ring ring;
    ring.stages = cta::smem_u32(smem + S_RING);
    ring.full = cta::smem_u32(smem + S_BAR);
    ring.empty = ring.full + 8 * STAGES;
    ring.it = 0;
    if (tid == 0) ring.init();
    __syncthreads();
    if (tid >= CONSUMERS) {
        // the producer's warpgroup gives its registers up; one thread of it
        // streams the weights, once a tile
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == CONSUMERS)
            for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
                ring.produce(q.slabs, N_SLABS);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid >> 5;
    Place pl;
    pl.lane = tid & 31;
    pl.wg = tid >> 7;
    pl.cur_w = smem + S_CUR + 16 * warp * 128;
    pl.small_w = smem + S_SMALL + 16 * warp * 128;
    pl.cur_wg = cta::smem_u32(smem + S_CUR + pl.wg * cta::WG_ROWS * 128);
    pl.small_wg = cta::smem_u32(smem + S_SMALL + pl.wg * cta::WG_ROWS * 128);
    pl.rd = reinterpret_cast<float*>(smem + S_RD) + 16 * warp * RW;
    pl.sq = q.scratch + ((size_t)blockIdx.x * cta::CONSUMER_WARPS + warp) * Q_LANE * 32 + pl.lane;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        pl.row0 = tile * ROWS + 16 * warp;
        shade_tile<TRAIN>(q, pl, ring);
    }
}

// launches `kernel` (a __global__ wrapper of run<TRAIN>) on `ctas` CTAs
inline cudaError_t launch(void (*kernel)(Args), Args q, int ctas, cudaStream_t stream) {
    if (q.total == 0) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    void* argv[] = {&q};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(ctas), dim3(THREADS), argv,
                           SMEM_BYTES, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace shade

}  // namespace
