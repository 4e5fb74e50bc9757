// The error-bound sampler's rounds (hold_tpu_torch/render/ray_sampler.py
// error_bound_z_vals), hand-written for Hopper (sm_90a).  Plain C interface,
// loaded with ctypes by hold_tpu_torch/ops/_cuda.py; launches on the
// caller's stream and returns cudaGetLastError().
//
// Replaces no TPU kernel: in the JAX package this math is jnp that XLA fuses
// (hold_tpu/render/ray_sampler.py).  Eager PyTorch ran it op by op, ~600
// launches a round and ~3,000 a node's call, each of a few microseconds, so
// the card waited on the host.  Here a round is one launch and the last step
// another; the queries between rounds stay where they are.
//
// The numbers are those of ray_sampler.py's plain steps: each float32
// operation rounded where the eager op rounds (__fmul_rn / __fadd_rn /
// __fsub_rn: no contraction to FMA; divisions and sqrtf IEEE), the
// exponentials that go through _exp64 computed in float64 and rounded to
// float32 at the same points, expm1 in float32.  Only the order of the sums
// differs (each thread's run of entries after the sums of the threads before
// it), so a bisection test that lands within rounding of eps can go the
// other way.
//
// Bound: per ray and round, 1 + beta_iters error bounds over the S - 1
// intervals, each three float64 exponentials, one expm1 and ~20 float32
// operations an interval, and two scans; ~20 bytes an interval in and out.
// So the work is arithmetic and the chain of block-wide steps a ray takes
// (each error bound two scans and a max).  Design: one block of 128 threads
// a ray, its table (z, sdf, d_star and two scratch rows) in shared memory,
// every pass a thread's contiguous run of entries, so the scans are a
// sequential sum per thread and one warp-shuffle scan over the thread sums.
// The merge sorts the table and the new samples together (bitonic, on
// (value, position) keys: torch.sort(stable=True)'s order, NaN last).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// ray_sampler._exp64: exp in float64, rounded to float32
__device__ __forceinline__ float exp64(float x) { return (float)exp((double)x); }
// torch.clamp with one side: NaN passes through
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }
// torch.amax: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float sign(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

// _laplace_density_beta: (1 / beta) * (0.5 + 0.5 sign(sdf) expm1(-|sdf| / beta))
__device__ __forceinline__ float laplace_density(float sdf, float beta) {
    const float e = expm1f(-fabsf(sdf) / beta);
    return mul(1.0f / beta, add(0.5f, mul(mul(0.5f, sign(sdf)), e)));
}

// This thread's run [lo, hi) of n entries: runs in thread order.
__device__ __forceinline__ void slice(int n, int& lo, int& hi) {
    const int per = (n + BLOCK - 1) / BLOCK;
    lo = min((int)threadIdx.x * per, n);
    hi = min(lo + per, n);
}

// a and b replaced by the sums of the values of the threads before this one.
__device__ void exclusive2(float& a, float& b, float* red) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    float ia = a, ib = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float ta = __shfl_up_sync(FULL, ia, o), tb = __shfl_up_sync(FULL, ib, o);
        if (lane >= o) {
            ia = add(ta, ia);
            ib = add(tb, ib);
        }
    }
    float ea = __shfl_up_sync(FULL, ia, 1), eb = __shfl_up_sync(FULL, ib, 1);
    if (lane == 0) ea = eb = 0.0f;
    __syncthreads();  // red is free
    if (lane == 31) {
        red[w] = ia;
        red[WARPS + w] = ib;
    }
    __syncthreads();
    float pa = 0.0f, pb = 0.0f;
    for (int k = 0; k < w; ++k) {
        pa = add(pa, red[k]);
        pb = add(pb, red[WARPS + k]);
    }
    a = add(pa, ea);
    b = add(pb, eb);
}

// The block's largest v (NaN wins) or sum of v, the same in every thread.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float t = __shfl_xor_sync(FULL, v, o);
        v = MAX ? nan_max(v, t) : add(v, t);
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float r = red[0];
    for (int k = 1; k < WARPS; ++k) r = MAX ? nan_max(r, red[k]) : add(r, red[k]);
    return r;
}

// torch.sort's order: numbers before NaN, ties by position (stable); pads
// (position >= n) after everything.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib, int n) {
    if ((ia >= n) != (ib >= n)) return ib >= n;
    const bool na = isnan(a), nb = isnan(b);
    if (na != nb) return nb;
    if (!na && a != b) return a < b;
    return ia < ib;
}

// Bitonic sort of p (a power of two) (key, position) pairs, n of them real.
__device__ void bitonic_sort(float* key, int* pos, int p, int n) {
    for (int k = 2; k <= p; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < p / 2; q += BLOCK) {
                const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                const int l = i | j;
                if (before(key[l], pos[l], key[i], pos[i], n) == ((i & k) == 0)) {
                    const float tk = key[i];
                    key[i] = key[l];
                    key[l] = tk;
                    const int tp = pos[i];
                    pos[i] = pos[l];
                    pos[l] = tp;
                }
            }
            __syncthreads();
        }
    }
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// One ray's table in shared memory: S samples, S - 1 intervals.
struct Table {
    float* z;      // [S] sorted
    float* sdf;    // [S]
    float* dstar;  // [S] d_star of each interval (the merge's scratch first)
    float* xs;     // [P] dists * density at the beta being tried (the sort's keys first)
    float* es;     // [P] the error an interval, then the pdf, then the cdf (positions first)
    float* red;    // [2 * WARPS]
    int S;
};

__device__ Table carve(float* smem, int S) {
    Table t;
    const int p = pow2_at_least(S);
    t.S = S;
    t.z = smem;
    t.sdf = t.z + S;
    t.dstar = t.sdf + S;
    t.xs = t.dstar + S;
    t.es = t.xs + p;
    t.red = t.es + p;
    return t;
}

// Shared-memory floats of a table of S samples (and a final sort of m).
__host__ __device__ __forceinline__ size_t table_floats(int S, int m) {
    return 3 * (size_t)S + 2 * (size_t)pow2_at_least(S) + 2 * WARPS + 2 * (size_t)pow2_at_least(m);
}

// The ray's table: z, sdf (s_old a ray), with the previous round's samples
// nz, nsdf (ne a ray) merged in as torch.sort(cat, stable=True) and a gather
// place them (old entries first on ties).
__device__ void load_table(Table& t, const float* z, const float* sdf, int s_old,
                           const float* nz, const float* nsdf, int ne, size_t ray) {
    const int S = s_old + ne;
    const float* zr = z + ray * s_old;
    const float* sr = sdf + ray * s_old;
    if (ne == 0) {
        for (int i = threadIdx.x; i < S; i += BLOCK) {
            t.z[i] = zr[i];
            t.sdf[i] = sr[i];
        }
        __syncthreads();
        return;
    }
    const int p = pow2_at_least(S);
    int* pos = reinterpret_cast<int*>(t.es);
    for (int i = threadIdx.x; i < p; i += BLOCK) {
        float v = NAN;
        if (i < s_old) {
            v = zr[i];
            t.dstar[i] = sr[i];
        } else if (i < S) {
            v = nz[ray * ne + (i - s_old)];
            t.dstar[i] = nsdf[ray * ne + (i - s_old)];
        }
        t.xs[i] = v;
        pos[i] = i;
    }
    __syncthreads();
    bitonic_sort(t.xs, pos, p, S);
    for (int i = threadIdx.x; i < S; i += BLOCK) {
        t.z[i] = t.xs[i];
        t.sdf[i] = t.dstar[pos[i]];
    }
    __syncthreads();
}

// _d_star: a lower bound on the distance to the surface inside each interval.
__device__ void d_star(const Table& t) {
    int lo, hi;
    slice(t.S - 1, lo, hi);
    for (int i = lo; i < hi; ++i) {
        const float a = sub(t.z[i + 1], t.z[i]);
        const float b = fabsf(t.sdf[i]), c = fabsf(t.sdf[i + 1]);
        const float a2 = mul(a, a), b2 = mul(b, b), c2 = mul(c, c);
        const bool first = add(a2, b2) <= c2;
        const bool second = add(a2, c2) <= b2;
        const float s = add(add(a, b), c) / 2.0f;
        const float area = clamp_min(mul(mul(mul(s, sub(s, a)), sub(s, b)), sub(s, c)), 0.0f);
        const float h = mul(2.0f, sqrtf(area)) / clamp_min(a, 1e-12f);
        const bool mid = !first && !second && sub(add(b, c), a) > 0.0f;
        const float d = first ? b : (second ? c : (mid ? h : 0.0f));
        t.dstar[i] = mul(sign(t.sdf[i + 1]), sign(t.sdf[i])) == 1.0f ? d : 0.0f;
    }
    __syncthreads();
}

enum Mode { BOUND, PDF_ROUND, PDF_FINAL };

// _error_bound at beta: the largest bound over the intervals (BOUND).
// PDF_ROUND instead writes each interval's bounded opacity + add_tiny to es
// (the same terms: the round's transmittance is the integral's scan and its
// error the same sum), PDF_FINAL its weight + 1e-5; both return 0.
__device__ float error_bound(const Table& t, float beta, Mode mode, float add_tiny) {
    int lo, hi;
    slice(t.S - 1, lo, hi);
    const float four_b2 = mul(4.0f, mul(beta, beta));
    float sx = 0.0f, se = 0.0f;
    for (int i = lo; i < hi; ++i) {
        const float dz = sub(t.z[i + 1], t.z[i]);
        const float x = mul(dz, laplace_density(t.sdf[i], beta));
        const float e = mul(exp64(-t.dstar[i] / beta), mul(dz, dz)) / four_b2;
        t.xs[i] = x;
        t.es[i] = e;
        sx = add(sx, x);
        se = add(se, e);
    }
    exclusive2(sx, se, t.red);
    float m = -INFINITY;
    for (int i = lo; i < hi; ++i) {
        const float trans = exp64(-sx);  // the integral before the interval
        sx = add(sx, t.xs[i]);
        se = add(se, t.es[i]);           // the error integral through it
        if (mode == PDF_FINAL) {
            t.es[i] = add(mul(sub(1.0f, exp64(-t.xs[i])), trans), 1e-5f);
        } else {
            const float b = mul(sub(clamp_max(exp64(se), 1e6f), 1.0f), trans);
            m = nan_max(m, b);
            if (mode == PDF_ROUND) t.es[i] = add(b, add_tiny);
        }
    }
    return mode == BOUND ? block_reduce<true>(m, t.red) : 0.0f;
}

// The bisection: beta for the ray's table.
__device__ float bisect(const Table& t, float beta, float beta0, int iters, bool conv_beta0,
                        float eps) {
    const float conv = error_bound(t, conv_beta0 ? beta0 : beta, BOUND, 0.0f);
    float lo = beta0, hi = conv <= eps ? beta0 : beta;
    for (int k = 0; k < iters; ++k) {
        const float mid = mul(0.5f, add(lo, hi));
        const bool ok = error_bound(t, mid, BOUND, 0.0f) <= eps;
        lo = ok ? lo : mid;
        hi = ok ? mid : hi;
    }
    return hi;
}

// es's pdf terms over their sum (floored at lo), then their running sum: the cdf.
__device__ void pdf_to_cdf(const Table& t, float lo_sum) {
    int lo, hi;
    slice(t.S - 1, lo, hi);
    float s = 0.0f;
    for (int i = lo; i < hi; ++i) s = add(s, t.es[i]);
    const float total = clamp_min(block_reduce<false>(s, t.red), lo_sum);
    float c = 0.0f, unused = 0.0f;
    for (int i = lo; i < hi; ++i) {
        t.es[i] = t.es[i] / total;
        c = add(c, t.es[i]);
    }
    exclusive2(c, unused, t.red);
    for (int i = lo; i < hi; ++i) {
        c = add(c, t.es[i]);
        t.es[i] = c;
    }
    __syncthreads();
}

// sample_pdf at u: the bins are z, the cdf es without its leading zero; the
// bin is searchsorted(cdf0, u, right=True) clamped to S - 1.
__device__ float sample_at(const Table& t, float u) {
    int lo = 0, hi = t.S;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((mid == 0 ? 0.0f : t.es[mid - 1]) > u) hi = mid;
        else lo = mid + 1;
    }
    const int above = min(lo, t.S - 1), below = max(above - 1, 0);
    const float c1 = above == 0 ? 0.0f : t.es[above - 1];
    const float c0 = below == 0 ? 0.0f : t.es[below - 1];
    float denom = sub(c1, c0);
    if (denom < 1e-5f) denom = 1.0f;
    return add(t.z[below], mul(sub(u, c0) / denom, sub(t.z[above], t.z[below])));
}

struct Refine {
    const float* z;     // (R, s_old) the sorted table
    const float* sdf;   // (R, s_old)
    const float* nz;    // (R, ne) the previous round's samples, or null (ne = 0)
    const float* nsdf;  // (R, ne) their sdf
    const float* beta;  // (R,)
    const float* beta0; // (1,)
    int s_old, ne, beta_iters, conv_beta0;
    float eps;
};

struct RoundOut {
    float* z;        // (R, s_old + ne) the merged table, written when ne > 0
    float* sdf;
    float* beta;     // (R,)
    const float* u;  // (nu,) the grid
    float* samples;  // (R, nu)
    int nu;
    float add_tiny;
};

// One refinement round of one ray: merge, d_star, bisection, the bounded
// opacity's pdf, the next samples at the grid.
__global__ void __launch_bounds__(BLOCK) eb_round_kernel(Refine a, RoundOut o) {
    extern __shared__ float smem[];
    const size_t ray = blockIdx.x;
    const int S = a.s_old + a.ne;
    Table t = carve(smem, S);
    load_table(t, a.z, a.sdf, a.s_old, a.nz, a.nsdf, a.ne, ray);
    if (a.ne > 0) {
        for (int i = threadIdx.x; i < S; i += BLOCK) {
            o.z[ray * S + i] = t.z[i];
            o.sdf[ray * S + i] = t.sdf[i];
        }
    }
    d_star(t);
    const float beta = bisect(t, a.beta[ray], *a.beta0, a.beta_iters, a.conv_beta0 != 0, a.eps);
    if (threadIdx.x == 0) o.beta[ray] = beta;
    error_bound(t, beta, PDF_ROUND, o.add_tiny);
    pdf_to_cdf(t, 1e-30f);
    for (int j = threadIdx.x; j < o.nu; j += BLOCK) o.samples[ray * o.nu + j] = sample_at(t, o.u[j]);
}

struct FinalOut {
    const float* u;         // (R, n) draws (u_stride n) or (n,) the grid (u_stride 0)
    const int64_t* idx;     // (n_extra,) table positions of the extra samples
    const float* near;      // (R, 1), rows near_stride apart
    const float* far;       // (R, 1), rows far_stride apart
    float* out;             // (R, n + 2 + n_extra) sorted
    int n, u_stride, n_extra, near_stride, far_stride;
};

// The last step of one ray: merge, d_star, bisection, the weights' pdf, the
// final samples at u with near, far and the extras, sorted.
__global__ void __launch_bounds__(BLOCK) eb_final_kernel(Refine a, FinalOut o) {
    extern __shared__ float smem[];
    const size_t ray = blockIdx.x;
    const int S = a.s_old + a.ne;
    const int m = o.n + 2 + o.n_extra;
    Table t = carve(smem, S);
    load_table(t, a.z, a.sdf, a.s_old, a.nz, a.nsdf, a.ne, ray);
    d_star(t);
    const float beta = bisect(t, a.beta[ray], *a.beta0, a.beta_iters, a.conv_beta0 != 0, a.eps);
    error_bound(t, beta, PDF_FINAL, 0.0f);
    pdf_to_cdf(t, -INFINITY);
    const int p = pow2_at_least(m);
    float* key = t.red + 2 * WARPS;
    int* pos = reinterpret_cast<int*>(key + p);
    for (int i = threadIdx.x; i < p; i += BLOCK) {
        float v = NAN;
        if (i < o.n) v = sample_at(t, o.u[ray * o.u_stride + i]);
        else if (i == o.n) v = o.near[ray * o.near_stride];
        else if (i == o.n + 1) v = o.far[ray * o.far_stride];
        else if (i < m) v = t.z[o.idx[i - o.n - 2]];
        key[i] = v;
        pos[i] = i;
    }
    __syncthreads();
    bitonic_sort(key, pos, p, m);
    for (int i = threadIdx.x; i < m; i += BLOCK) o.out[ray * m + i] = key[i];
}

template <class Out>
int launch(void (*kernel)(Refine, Out), const Refine& a, const Out& o, int R, int m,
           void* stream) {
    if (R == 0) return cudaSuccess;
    const size_t bytes = sizeof(float) * table_floats(a.s_old + a.ne, m);
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<R, BLOCK, bytes, (cudaStream_t)stream>>>(a, o);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a ray of a table of S samples takes, for the wrapper's check.
int hold_eb_smem_bytes(int S, int m) { return (int)(sizeof(float) * table_floats(S, m)); }

// One round for R rays: table z, sdf (R, S) with the previous round's nz,
// nsdf (R, ne) merged in (null, ne = 0: none) into zo, sdfo (R, S + ne);
// beta (R,) -> beta_out (R,); the samples (R, nu) at the grid u (nu,).
int hold_eb_round(const void* z, const void* sdf, const void* nz, const void* nsdf,
                  const void* beta, const void* beta0, void* zo, void* sdfo, void* beta_out,
                  const void* u, void* samples, int R, int S, int ne, int nu, int beta_iters,
                  int conv_beta0, float eps, float add_tiny, void* stream) {
    const Refine a{(const float*)z, (const float*)sdf, (const float*)nz, (const float*)nsdf,
                   (const float*)beta, (const float*)beta0, S, ne, beta_iters, conv_beta0, eps};
    const RoundOut o{(float*)zo, (float*)sdfo, (float*)beta_out, (const float*)u,
                     (float*)samples, nu, add_tiny};
    return launch(eb_round_kernel, a, o, R, 1, stream);
}

// The last step for R rays: the table as hold_eb_round takes it; draws u
// (R, n) or the grid (n,) (u_stride 0); idx (n_extra,) int64; near, far
// (R, 1) with row strides -> out (R, n + 2 + n_extra).
int hold_eb_final(const void* z, const void* sdf, const void* nz, const void* nsdf,
                  const void* beta, const void* beta0, const void* u, const void* idx,
                  const void* near, const void* far, void* out, int R, int S, int ne, int n,
                  int u_stride, int n_extra, int near_stride, int far_stride, int beta_iters,
                  int conv_beta0, float eps, void* stream) {
    const Refine a{(const float*)z, (const float*)sdf, (const float*)nz, (const float*)nsdf,
                   (const float*)beta, (const float*)beta0, S, ne, beta_iters, conv_beta0, eps};
    const FinalOut o{(const float*)u, (const int64_t*)idx, (const float*)near, (const float*)far,
                     (float*)out, n, u_stride, n_extra, near_stride, far_stride};
    return launch(eb_final_kernel, a, o, R, n + 2 + n_extra, stream);
}

}  // extern "C"
