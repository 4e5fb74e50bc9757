// CTA-level products for the 256-wide trunk on Hopper (sm_90a):
//   D (M x 256, f32) = A (M x K, bf16) . W^T,   W (256 x K, bf16), K in {48, 256}
// with the weights crossing L2 once per CTA and product, staged in shared
// memory by the copy engine and multiplied by wgmma.
//
// Slabs.  A weight matrix is cut along k into slabs of 64 columns (a 48-column
// matrix is one slab, its last 16 columns zero).  A slab is the shared-memory
// image one pipeline stage needs, 256 rows of 128 bytes in the 128-byte
// swizzle wgmma reads (K-major): element (n, k) of the slab sits at byte
//   n * 128 + (((k / 8) ^ (n % 8)) * 16) + (k % 8) * 2.
// ops/fused_query.py tile_for_kernel lays the packed trunk out as its 30 slabs
// in the order the layers consume them (W0 | W1 x4 | W2 x4 | W3 x4 | W4h x4 |
// W4e | W5 x4 | W6 x4 | W7 x4), so one cp.async.bulk of 32 KB fills a stage and
// no tensor map is needed.
//
// Ring.  STAGES slabs of shared memory with a full and an empty mbarrier
// each.  One producer thread waits for a stage to be empty, announces the
// bytes (arrive.expect_tx) and starts the bulk copy, which completes on the
// full barrier; it runs up to STAGES slabs ahead, through layer and tile
// boundaries, so the next product's first slabs arrive during this one's
// epilogue.  Every consumer warp hands a stage back (one arrive a warp) once
// the wgmma group that read it has completed.
//
// Consumers.  A warpgroup owns 64 rows of the CTA's tile.  Its A operand is a
// shared-memory tile in the same swizzle, cut into slabs of 64 columns of
// TILE_M rows: element (r, c) at byte
//   (c / 64) * TILE_M * 128 + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2.
// Per slab it runs four (three for a 48-column slab) wgmma m64n256k16, bf16
// in, f32 out; the accumulator (128 registers a thread) has mma.sync's
// fragment layout per 8 columns: thread (warp w, lane 4 g + t) holds rows
// 16 w + g and + 8, columns 8 j + 2 t, + 1 in d[4 j .. 4 j + 3].  An epilogue
// that writes the next A tile with ordinary stores must run
// fence_proxy_async() and a warpgroup barrier before the next wgmma reads it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cta {

constexpr int N_OUT = 256;                       // output columns of every product
constexpr int SLAB_K = 64;                       // k columns a slab holds
constexpr int SLAB_BYTES = N_OUT * SLAB_K * 2;   // 32 KB: one stage
constexpr int STAGES = 4;                        // the ring's depth unless a kernel names another
constexpr int TILE_M = 128;                      // rows (points) a CTA owns
constexpr int WG_ROWS = 64;                      // rows a consumer warpgroup owns
constexpr int A_SLAB_BYTES = TILE_M * SLAB_K * 2;  // 16 KB
constexpr int CONSUMER_WARPS = 2 * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and the copy engine
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// returns once the barrier has left the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// 1-D bulk copy device -> shared memory, completing on an mbarrier; bytes a
// multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// orders this thread's ordinary shared-memory stores before later reads by
// the asynchronous proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- bulk stores ------------------------------------------------------------

// 2-D tensor store shared -> global (TMA): the box at shared address src to
// coordinates (c0 innermost, c1) of the tensor map at tmap (a __grid_constant__
// parameter), in this thread's current bulk async-group
__device__ __forceinline__ void tensor_store_2d(const void* tmap, uint32_t src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                 ::"l"(tmap), "r"(src), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk groups but the newest N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// this thread's bulk groups have completed, their writes ordered before this
// thread's later ordinary loads
__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// barrier among `threads` threads (a multiple of 32) on hardware barrier `id`
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- the ring ---------------------------------------------------------------

// Shared-memory addresses of the ring and the slab counter of one thread.
// Producer and consumers count the same slabs in the same order.
template <int NSTAGES>
struct RingT {
    static constexpr uint32_t STAGES = NSTAGES;
    uint32_t stages;  // STAGES x SLAB_BYTES, 1024-byte aligned
    uint32_t full;    // STAGES mbarriers, count 1 (the producer's expect_tx)
    uint32_t empty;   // STAGES mbarriers, count CONSUMER_WARPS
    uint32_t it;      // slabs this thread has gone through

    __device__ __forceinline__ uint32_t stage_addr(uint32_t i) const {
        return stages + (i % STAGES) * SLAB_BYTES;
    }
    __device__ __forceinline__ uint32_t full_bar(uint32_t i) const {
        return full + 8 * (i % STAGES);
    }
    __device__ __forceinline__ uint32_t empty_bar(uint32_t i) const {
        return empty + 8 * (i % STAGES);
    }
    // one thread of the CTA, before the barrier that starts the roles
    __device__ __forceinline__ void init() const {
        for (uint32_t s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMER_WARPS);
        }
        fence_barrier_init();
    }
    // producer thread: stream `n` slabs from `src` (device memory, slab-major)
    __device__ __forceinline__ void produce(const void* src, int n) {
        const char* p = static_cast<const char*>(src);
        for (int s = 0; s < n; ++s, ++it) {
            mbar_wait(empty_bar(it), ((it / STAGES) & 1) ^ 1);  // first round passes
            mbar_expect_tx(full_bar(it), SLAB_BYTES);
            bulk_copy(stage_addr(it), p + (size_t)s * SLAB_BYTES, SLAB_BYTES, full_bar(it));
        }
    }
    // consumer: wait for the current slab
    __device__ __forceinline__ void wait_full() const {
        mbar_wait(full_bar(it), (it / STAGES) & 1);
    }
    // consumer warp: hand slab i back (its wgmma group has completed)
    __device__ __forceinline__ void release(uint32_t i) const {
        if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar(i));
    }
};
using Ring = RingT<STAGES>;

// ---- wgmma --------------------------------------------------------------------

// Descriptor of a K-major operand in the 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO), the leading offset unused (1), layout type 1 (B128).  The
// k-step of 16 columns inside a slab advances the address by 32 bytes, which
// is + 2 on the descriptor.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
           (1ull << 62);
}

// Descriptor of an MN-major operand in the 128-byte swizzle: rows are k
// (points), 64 contiguous values of the M or N dimension a row of 128 bytes,
// 8-row groups along k 1024 bytes apart (SBO), the next 64 values of M or N
// `lbo` bytes on (LBO).  A k-step of 16 rows advances the address by 2048.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t saddr, uint32_t lbo) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define HOLD_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOLD_D16(i) HOLD_D4(i), HOLD_D4(i + 4), HOLD_D4(i + 8), HOLD_D4(i + 12)
#define HOLD_D64(i) HOLD_D16(i), HOLD_D16(i + 16), HOLD_D16(i + 32), HOLD_D16(i + 48)

// keeps the compiler from reading an accumulator before the wait that
// completes it
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
    asm volatile("" : HOLD_D64(0), HOLD_D64(64)::"memory");
}

// d (+)= A . B^T for a 64 x 16 block of A and a 256 x 16 block of B, both from
// shared memory; accumulate == 0 overwrites d.  TA / TB = 1 reads that operand
// MN-major (make_desc_mn), 0 K-major (make_desc).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : HOLD_D64(0), HOLD_D64(64)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// the same with 8, 16, 48 and 64 output columns (4, 8, 24 and 32 registers)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3},"
        " %4, %5, p, 1, 1, %7, %8;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23},"
        " %24, %25, p, 1, 1, %27, %28;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// One slab of a product of a consumer warpgroup: d (+)= A_slab . W_slab^T
// with KS k-steps of 16 columns (4 for a full slab, 3 for a 48-column one, 1
// for a 16-column one), A_slab at shared address a (the warpgroup's first
// row), the weights in the ring's current stage.  `pending` says that the
// slab before belongs to the same product and is still in flight: it is
// handed back once its group completes.  mma_done ends the product.
template <int KS, class R>
__device__ __forceinline__ void mma_slab(float (&d)[128], uint32_t a, R& ring, bool accumulate,
                                         bool pending) {
    const uint64_t da = make_desc(a);
    ring.wait_full();
    const uint64_t db = make_desc(ring.stage_addr(ring.it));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_m64n256k16(d, da + 2 * k, db + 2 * k, accumulate || k > 0);
    wgmma_commit();
    if (pending) {
        wgmma_wait<1>();
        ring.release(ring.it - 1);
    }
    ++ring.it;
}

// the product's last group has completed: its stage goes back, d is final and
// the A tiles may be overwritten by the warp's own rows
template <class R>
__device__ __forceinline__ void mma_done(float (&d)[128], R& ring) {
    wgmma_wait<0>();
    ring.release(ring.it - 1);
    fence_acc(d);
}

// One product of a consumer warpgroup: d = A . W^T over the next NA slabs of
// the ring against the A tile's slabs 0 .. NA-1 (64 columns each, at a_wg:
// the warpgroup's first row of slab 0), then, with TAIL, one 48-column slab
// against the tile at tail_wg (the embedding), added into the same d.
template <int NA, bool TAIL, class R>
__device__ __forceinline__ void product(float (&d)[128], uint32_t a_wg, uint32_t tail_wg,
                                        R& ring) {
#pragma unroll
    for (int s = 0; s < NA; ++s) mma_slab<4>(d, a_wg + s * A_SLAB_BYTES, ring, s > 0, s > 0);
    if constexpr (TAIL) mma_slab<3>(d, tail_wg, ring, NA > 0, NA > 0);
    mma_done(d, ring);
}

// A whole product with N in {8, 16, 48} output columns in one stage of the
// ring: the stage holds the four k-slabs of the (N x 256) weights, N rows of
// 128 bytes each, one after the other.  d (+)= A . W^T with A the tile at a_wg.
template <int N, class R>
__device__ __forceinline__ void narrow_product(float (&d)[N / 2], uint32_t a_wg, R& ring,
                                               bool accumulate) {
    ring.wait_full();
    const uint32_t stage = ring.stage_addr(ring.it);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const uint64_t da = make_desc(a_wg + s * A_SLAB_BYTES);
        const uint64_t db = make_desc(stage + s * N * 128);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int acc = accumulate || (s | k) != 0;
            if constexpr (N == 8) wgmma_m64n8k16<0, 0>(d, da + 2 * k, db + 2 * k, acc);
            if constexpr (N == 16) wgmma_m64n16k16<0, 0>(d, da + 2 * k, db + 2 * k, acc);
            if constexpr (N == 48) wgmma_m64n48k16<0, 0>(d, da + 2 * k, db + 2 * k, acc);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(ring.it);
    ++ring.it;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of element (r, c) of an A tile (see the header comment)
__device__ __forceinline__ uint32_t a_offset(int r, int c) {
    return (c >> 6) * A_SLAB_BYTES + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

}  // namespace cta
