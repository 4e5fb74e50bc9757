// KNN skinning-weight blend shared by the deformer kernels (knn.cu), the
// fused sampler query (fused_query.cu) and the fused render
// (fused_render.cu), and the vertex tiles that min_vertex_dist_kernel
// (point_mesh.cu) culls the same way.  All of them must see bit-identical
// squared distances: the K-th smallest distinct d2 often falls inside a
// cluster of distances equal up to rounding, so every d2 is evaluated here,
// once, with round-to-nearest intrinsics and no FMA contraction.
//
// Semantics are the TPU kernels', not the jnp fallback's: the K nearest
// vertices are every vertex whose unclamped squared distance is <= the K-th
// smallest DISTINCT squared distance (ties included; every vertex when there
// are fewer than K distinct values), confidences are exp(-min(d2, 4))
// normalised over that set.
//
// The search (knn_blend) is one sweep per point, one point a lane, the 32
// lanes of a warp together:
// - the vertex set is staged in shared memory in TILES of 32 vertices that
//   lie close in space (a fixed order made once per vertex set on the host,
//   ops/knn.py tile_order), each tile with its axis-aligned box;
// - a lane's K smallest distinct d2 and their vertices stay in a sorted
//   register list, filled first from the lane's own nearest tile;
// - the warp then visits the tiles nearest first to the centre of its
//   points' box and skips a tile when, for every lane, it is the lane's own
//   or its box lies farther than the lane's current K-th value plus a
//   rounding margin (tile_far): such a tile can neither enter the set nor
//   move the minimum.  The inner loop only computes d2 and pushes a
//   candidate (d2 <= the lane's K-th value) with its slot into a short
//   per-lane queue in shared memory, predicated, without a branch; when
//   some lane's queue fills, every lane merges its queue into its list at
//   once (thread queue / warp merge), each insertion a fixed set of compares
//   and selects with no chain through the list;
// - a lane whose merge meets a d2 already in its list, or whose list is not
//   full at the end, sets a tie flag: the set may hold more vertices than the
//   list.  Only such lanes sweep the tiles again and blend every vertex at or
//   under their K-th value; the others blend their list's K vertices.
//
// stats, when not null, gathers six counts for chip_smoke.py: lanes
// searched, lanes that took the tie sweep, tiles a warp's sweep visited and
// skipped (beside the lanes' own tiles, which every lane evaluates once), the
// insertion rounds a warp ran (every lane inserts in each, +inf when it has
// nothing left), the candidates lanes inserted.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 16;     // largest K the register list holds
constexpr int JMAX = 16;     // largest joint count (MANO has 16)
constexpr int TILE_V = 32;   // vertices a tile
constexpr int QLEN = 16;     // candidate queue slots a lane
constexpr int QSTEP = 4;     // vertices between two looks at the queues
constexpr float CLAMP = 4.0f;
constexpr float BIG = 1e9f;
constexpr unsigned FULL = 0xffffffffu;

// The rounding margin of tile_far, 2^-18 = 64 u (u = 2^-24, the unit
// roundoff of f32).  For a vertex v and a point p, with S = |v|^2 + |p|^2:
// - sqdist's |v|^2 and |p|^2 carry a relative error of at most 3u (sums of
//   three non-negative rounded products), its dot product an absolute error
//   of at most 3u |v| |p| <= 1.5u S, so (|v|^2 + |p|^2) - 2 p.v lies within
//   7u S of |v - p|^2 before its last rounding and within 9u S after it
//   (|v - p|^2 <= 2S); the clamp at 0 only moves it towards the truth.  So
//   the computed d2 >= |v - p|^2 - 9u S.
// - The box bound L (sum of the squared gaps between p and the box) is
//   rounded up by at most 5u L, and L <= |v - p|^2 <= 2S for every v of the
//   tile: the computed L_c <= |v - p|^2 + 10.1u S.
// - So every vertex of the tile has d2 >= L_c - 19.1u S.  tile_far asks for
//   L_c > thr + 2^-18 (S_max + thr), with S_max = max|v|^2 of the tile +
//   |p|^2 >= S; after the comparison's own roundings (a few u of thr and of
//   the margin) every d2 of the tile still exceeds thr by at least
//   44u S + 62u thr > 0 (S = thr = 0 never culls: L_c > 0 fails).
constexpr float MARGIN = 3.814697265625e-06f;  // 2^-18

__device__ __forceinline__ float sq3(float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// max(|v|^2 + |p|^2 - 2 p.v, 0), unclamped form below.  v.w holds |v|^2 and
// (qx, qy, qz) = 2p: scaling by two is exact and commutes with every
// rounding of the dot product, so the result is bit for bit that of
// __fmul_rn(2, v.p) (outside the subnormal range, products under 2^-126,
// which no coordinate of a scene reaches).
__device__ __forceinline__ float sqdist_raw(const float4 v, float qx, float qy, float qz,
                                            float psq) {
    const float cross2 =
        __fadd_rn(__fadd_rn(__fmul_rn(v.x, qx), __fmul_rn(v.y, qy)), __fmul_rn(v.z, qz));
    return __fsub_rn(__fadd_rn(v.w, psq), cross2);
}

__device__ __forceinline__ float sqdist2(const float4 v, float qx, float qy, float qz,
                                         float psq) {
    return fmaxf(sqdist_raw(v, qx, qy, qz, psq), 0.0f);
}

// Squared gap between a point and a box along one axis.
__device__ __forceinline__ float gap(float lo, float hi, float p) {
    return fmaxf(fmaxf(lo - p, p - hi), 0.0f);
}

// True when no vertex of the tile (box lo.xyz .. hi.xyz, lo.w = max |v|^2)
// can have a computed d2 <= thr at point p (|p|^2 = psq): see MARGIN.
// thr = +inf never culls.
__device__ __forceinline__ bool tile_far(const float4 lo, const float4 hi, float px, float py,
                                         float pz, float psq, float thr) {
    const float gx = gap(lo.x, hi.x, px), gy = gap(lo.y, hi.y, py), gz = gap(lo.z, hi.z, pz);
    const float L = gx * gx + gy * gy + gz * gz;
    return L > thr + MARGIN * ((lo.w + psq) + thr);
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

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

// A vertex set staged in shared memory in tile order: v[s] = (x, y, z,
// |v|^2) of vertex order[s]; tile t holds slots
// 32t .. 32t + 31, its box in box[2t] = (lo.xyz, max |v|^2), box[2t + 1] =
// (hi.xyz, 0).
struct VertexSet {
    const float4* v;
    const float4* box;
    const int* order;  // global, slot -> vertex index
    int V;
};

__device__ __forceinline__ int set_tiles(int V) { return (V + TILE_V - 1) / TILE_V; }

// float4s of shared memory a staged set of V vertices takes (the vertices,
// then the boxes).
__host__ __device__ constexpr int set_float4s(int V) { return V + 2 * ((V + TILE_V - 1) / TILE_V); }

// Stage V vertices (verts (V, 3), read in order (V,)) and their tile boxes
// at s (set_float4s(V) float4s).  Every thread of the CTA calls it; blockDim.x
// is a multiple of 32.
__device__ __forceinline__ VertexSet stage_set(const float* __restrict__ verts,
                                               const int* __restrict__ order, int V,
                                               float4* s) {
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
        const int v = __ldg(order + i);
        const float x = verts[3 * v], y = verts[3 * v + 1], z = verts[3 * v + 2];
        s[i] = make_float4(x, y, z, sq3(x, y, z));
    }
    __syncthreads();
    float4* box = s + V;
    const int lane = threadIdx.x & 31;
    for (int t = threadIdx.x >> 5; t < set_tiles(V); t += blockDim.x >> 5) {
        // the last tile's empty lanes repeat its last vertex
        const float4 v = s[min(TILE_V * t + lane, V - 1)];
        const float4 lo = make_float4(warp_min(v.x), warp_min(v.y), warp_min(v.z), warp_max(v.w));
        const float4 hi = make_float4(warp_max(v.x), warp_max(v.y), warp_max(v.z), 0.0f);
        if (lane == 0) {
            box[2 * t] = lo;
            box[2 * t + 1] = hi;
        }
    }
    __syncthreads();
    return VertexSet{s, box, order, V};
}

// The dynamic shared memory of a CTA of SEARCH_THREADS that searches one
// vertex set at a time: its warps' candidate queues (QLEN entries (d2, slot)
// of 8 bytes a lane), then the staged set.
constexpr int SEARCH_THREADS = 128;
constexpr int QUEUE_BYTES = (SEARCH_THREADS / 32) * QLEN * 32 * 8;

__device__ __forceinline__ float2* warp_queue(unsigned char* smem) {
    return reinterpret_cast<float2*>(smem) + (threadIdx.x >> 5) * QLEN * 32;
}

__device__ __forceinline__ float4* set_base(unsigned char* smem) {
    return reinterpret_cast<float4*>(smem + QUEUE_BYTES);
}

inline size_t search_smem(int V) {
    return QUEUE_BYTES + (size_t)set_float4s(V) * sizeof(float4);
}

// Stage one frame's bone transforms (J x 16 floats).
__device__ __forceinline__ void stage_tfs(const float* __restrict__ tfs, int J, float* s_tf) {
    for (int i = threadIdx.x; i < J * 16; i += blockDim.x) s_tf[i] = tfs[i];
}

// The visiting order of a warp's tiles: the key of tile t is the squared gap
// between its box and the centre of the warp's points.  With at most 32
// tiles, lane i ends up holding the i-th nearest tile (a bitonic sort of
// (key, tile) across the warp); with more, the nearest tile comes first and
// the rest follow in slot order (first_tile).
struct TileOrder {
    int id;     // lane i: the i-th tile (at most 32 tiles)
    int first;  // the nearest tile (more than 32 tiles)
    int nt;
};

__device__ __forceinline__ TileOrder tile_order(const VertexSet& set, float px, float py,
                                                float pz) {
    const int lane = threadIdx.x & 31;
    const float cx = 0.5f * (warp_min(px) + warp_max(px));
    const float cy = 0.5f * (warp_min(py) + warp_max(py));
    const float cz = 0.5f * (warp_min(pz) + warp_max(pz));
    TileOrder o;
    o.nt = set_tiles(set.V);
    float key = INFINITY;
    int id = lane;
    for (int t = lane; t < o.nt; t += 32) {  // lane keeps its nearest tile
        const float4 lo = set.box[2 * t], hi = set.box[2 * t + 1];
        const float gx = gap(lo.x, hi.x, cx), gy = gap(lo.y, hi.y, cy), gz = gap(lo.z, hi.z, cz);
        const float k = gx * gx + gy * gy + gz * gz;
        if (k < key) {
            key = k;
            id = t;
        }
    }
    if (o.nt <= 32) {
#pragma unroll
        for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
            for (int j = k >> 1; j > 0; j >>= 1) {
                const float ok = __shfl_xor_sync(FULL, key, j);
                const int oi = __shfl_xor_sync(FULL, id, j);
                const bool less = ok < key || (ok == key && oi < id);
                const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
                if (keep_min == less) {
                    key = ok;
                    id = oi;
                }
            }
        o.id = id;
        o.first = 0;
    } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ok = __shfl_xor_sync(FULL, key, off);
            const int oi = __shfl_xor_sync(FULL, id, off);
            if (ok < key || (ok == key && oi < id)) {
                key = ok;
                id = oi;
            }
        }
        o.id = lane;
        o.first = id;
    }
    return o;
}

// The i-th tile a warp visits.
__device__ __forceinline__ int tile_at(const TileOrder& o, int i) {
    if (o.nt <= 32) return __shfl_sync(FULL, o.id, i);
    if (i == 0) return o.first;
    return i - 1 < o.first ? i - 1 : i;
}

// The K-th entry of the sorted list, the largest of its first K: a select an
// entry, where reading top[K - 1] would index the list by a value known only
// at run time and move it to local memory.
__device__ __forceinline__ float kth_of(const float (&top)[KMAX], int K) {
    float kth = top[0];
#pragma unroll
    for (int k = 1; k < KMAX; ++k) kth = fmaxf(kth, k < K ? top[k] : top[0]);
    return kth;
}

// Insert (x, s) into the sorted list of distinct values; a value already in
// the list is not inserted again and sets tie.  The list is sorted, so x <
// top[k] holds from some k on: every entry moves by the comparisons with the
// old list alone, and no step waits on the one before (a shift register
// would chain all KMAX of them).
__device__ __forceinline__ void list_insert(float (&top)[KMAX], int (&slot)[KMAX], float x, int s,
                                            bool& tie) {
    bool eq[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) eq[k] = top[k] == x;
#pragma unroll
    for (int w = 1; w < KMAX; w <<= 1)  // a balanced OR, not a chain
#pragma unroll
        for (int k = 0; k + w < KMAX; k += 2 * w) eq[k] = eq[k] | eq[k + w];
    tie |= eq[0];
    x = eq[0] ? INFINITY : x;
#pragma unroll
    for (int k = KMAX - 1; k > 0; --k) {
        const bool here = x < top[k], before = x < top[k - 1];
        top[k] = before ? top[k - 1] : (here ? x : top[k]);
        slot[k] = before ? slot[k - 1] : (here ? s : slot[k]);
    }
    const bool first = x < top[0];
    top[0] = first ? x : top[0];
    slot[0] = first ? s : slot[0];
}

// Merge the warp's queues (each lane's cnt entries (d2, slot), 32 apart) into
// the lists, all lanes in step: entry e of a lane that has fewer inserts
// +inf, which changes nothing.  Returns the rounds run, the largest cnt.
__device__ __forceinline__ int merge_queue(const float2* q, int& cnt, float (&top)[KMAX],
                                           int (&slot)[KMAX], bool& tie) {
    const int m = __reduce_max_sync(FULL, (unsigned)cnt);
    for (int e = 0; e < m; ++e) {
        const float2 c = q[32 * e];
        list_insert(top, slot, e < cnt ? c.x : INFINITY, __float_as_int(c.y), tie);
    }
    cnt = 0;
    return m;
}

// c * the skinning weights of vertex v, added into wb.
__device__ __forceinline__ void add_weights(const float* __restrict__ w, int v, int J, float c,
                                            float* wb) {
    const float* wr = w + (size_t)v * J;
#pragma unroll
    for (int j = 0; j < JMAX; ++j)
        if (j < J) wb[j] += c * __ldg(wr + j);
}

// The neighbour search and blend of one point a lane; every lane of the warp
// calls it together (a lane without a point passes a copy of another lane's,
// with active false: it changes no decision, and counts in no statistic).
// queue: this warp's QLEN x 32 entries of shared memory.  Returns the
// minimum d2 (exact whenever it is under BIG; callers read min(it, 4)); wb
// gets the normalised blend.
__device__ __forceinline__ float knn_blend(const VertexSet& set, float2* queue,
                                           const float* __restrict__ w, int J, int K, float px,
                                           float py, float pz, bool active, float* wb,
                                           unsigned long long* stats) {
    const int lane = threadIdx.x & 31;
    const float psq = sq3(px, py, pz);
    const float qx = 2.0f * px, qy = 2.0f * py, qz = 2.0f * pz;
    float2* q = queue + lane;
    float top[KMAX];
    int slot[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        top[k] = BIG;
        slot[k] = 0;
    }
    bool tie = false;
    int cnt = 0, pushed = 0, rounds = 0;
    const TileOrder order = tile_order(set, px, py, pz);
    // each lane's own nearest tile goes straight into its list: the list is
    // not full yet, so every vertex of it is a candidate.  A warp-wide first
    // tile would leave the lanes far from it with a loose K-th value, and the
    // merges run as many rounds as the lane with most candidates needs.
    int mine = 0;
    {
        float best = INFINITY;
        for (int t = 0; t < order.nt; ++t) {
            const float4 lo = set.box[2 * t], hi = set.box[2 * t + 1];
            const float gx = gap(lo.x, hi.x, px), gy = gap(lo.y, hi.y, py),
                        gz = gap(lo.z, hi.z, pz);
            const float k = gx * gx + gy * gy + gz * gz;
            mine = k < best ? t : mine;
            best = fminf(k, best);
        }
        const int s0 = TILE_V * mine, n = min(TILE_V, set.V - s0);
        for (int j = 0; j < TILE_V; ++j) {
            const int s = s0 + min(j, n - 1);
            list_insert(top, slot, j < n ? sqdist2(set.v[s], qx, qy, qz, psq) : INFINITY, s, tie);
        }
        rounds = TILE_V;
        pushed = n;
    }
    float thr = kth_of(top, K);
    int visited = 0;
    for (int i = 0; i < order.nt; ++i) {
        // a lane skips its own tile, already in its list
        const int t = tile_at(order, i);
        if (__all_sync(FULL, t == mine || tile_far(set.box[2 * t], set.box[2 * t + 1], px, py,
                                                   pz, psq, thr)))
            continue;
        ++visited;
        const int s0 = TILE_V * t, n = min(TILE_V, set.V - s0);
        for (int c = 0; c < n; c += QSTEP) {
            if (__any_sync(FULL, cnt > QLEN - QSTEP)) {
                pushed += cnt;
                rounds += merge_queue(q, cnt, top, slot, tie);
                thr = kth_of(top, K);
            }
            // the step's vertices are read before any push is stored: the
            // compiler cannot move a read of the set past a store to the
            // queue, both being shared memory
            float d2[QSTEP];
#pragma unroll
            for (int u = 0; u < QSTEP; ++u)
                d2[u] = sqdist2(set.v[s0 + min(c + u, n - 1)], qx, qy, qz, psq);
#pragma unroll
            for (int u = 0; u < QSTEP; ++u) {
                const bool push = t != mine && c + u < n && d2[u] <= thr;
                if (push) q[32 * cnt] = make_float2(d2[u], __int_as_float(s0 + c + u));
                cnt += push;
            }
        }
    }
    pushed += cnt;
    rounds += merge_queue(q, cnt, top, slot, tie);
    thr = kth_of(top, K);
    tie |= !(thr < BIG);  // fewer than K distinct values: every vertex is in the set

#pragma unroll
    for (int j = 0; j < JMAX; ++j) wb[j] = 0.0f;
    float csum = 0.0f;
    if (!tie) {  // the set is the list's K vertices
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                const float c = expf(-fminf(top[k], CLAMP));
                csum += c;
                add_weights(w, __ldg(set.order + slot[k]), J, c, wb);
            }
        }
    }
    // the tie sweep: every vertex at or under the K-th value, tiles culled
    // as in the search
    if (__any_sync(FULL, tie)) {
        for (int t = 0; t < order.nt; ++t) {
            if (__all_sync(FULL, !tie || tile_far(set.box[2 * t], set.box[2 * t + 1], px, py,
                                                  pz, psq, thr)))
                continue;
            const int s0 = TILE_V * t, n = min(TILE_V, set.V - s0);
            for (int s = s0; s < s0 + n; ++s) {
                const float d2 = sqdist2(set.v[s], qx, qy, qz, psq);
                if (tie && d2 <= thr) {
                    const float c = expf(-fminf(d2, CLAMP));
                    csum += c;
                    add_weights(w, __ldg(set.order + s), J, c, wb);
                }
            }
        }
    }
    const float rs = 1.0f / csum;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) wb[j] *= rs;
    if (stats != nullptr) {
        const unsigned act = __ballot_sync(FULL, active);
        const unsigned tied = __ballot_sync(FULL, active && tie);
        const unsigned ins = __reduce_add_sync(FULL, active ? (unsigned)pushed : 0u);
        if (lane == 0 && act != 0u) {
            atomicAdd(stats, (unsigned long long)__popc(act));
            atomicAdd(stats + 1, (unsigned long long)__popc(tied));
            atomicAdd(stats + 2, (unsigned long long)visited);
            atomicAdd(stats + 3, (unsigned long long)(order.nt - visited));
            atomicAdd(stats + 4, (unsigned long long)rounds);
            atomicAdd(stats + 5, (unsigned long long)ins);
        }
    }
    return top[0];
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

// Inverse skinning Jacobian of one point: J = sum_j wb_j R_j (the rotation
// blocks of the bone transforms), inv = J^-1 row-major.
__device__ __forceinline__ void blend_jacobian_inverse(const float* wb, const float* s_tf, int J,
                                                       float* inv) {
    float R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < JMAX; ++j)
                if (j < J) s += wb[j] * s_tf[j * 16 + 4 * i + m];
            R[3 * i + m] = s;
        }
    inv3(R, inv);
}

}  // namespace
