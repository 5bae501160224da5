// matrix_ingest: batched sketch ingest as an int32 atomic scatter-add.
// Two entry points: `matrix_ingest_launch` on the TPU's rectangles (the
// Pallas function's counterpart) and `matrix_ingest_edges_launch` on the
// raw edges (the whole width-class / P = 1 ingest in one launch; below).
//
// Replaces: src/repro/kernels/matrix_ingest.py, `matrix_ingest` (Pallas body
// `_ingest_kernel`).  The TPU kernel reformulates counting as a one-hot
// matrix product U^T (V * wt) because the TPU has no atomics; Hopper has
// native integer atomics, so this kernel computes the function itself:
//
//     pool[r, p, hi[r,p,c], hj[r,p,c]] += wt[p, c]   for every (r, p, c)
//
// with wt == 0 marking padding, and slots whose hi or hj lies outside
// [0, w) dropped (the one-hot product drops them too).
//
// Bound on this card: bytes.  Each slot is a few integer operations; the
// work is reading hi, hj and wt once and one read-modify-write of a pool
// cell per live slot.  Design: one thread per (r, p, c) slot, a block row
// per (r, p), so the hi/hj/wt reads are coalesced; padding slots
// (wt == 0) stop after the wt read; live slots do one atomicAdd into the
// pool in device memory.  Integer atomics commute, so the result is
// bit-exact run to run and exact at any count (the one-hot f32 product is
// exact only below 2^24 per tile).  The pools of the main path are small
// (at most a few hundred KB), so the atomics hit L2.  Privatizing the w x w
// tile in shared memory is later work.
#include <cuda_runtime.h>

#include "sketch_addr.cuh"

namespace {

// blockIdx.y is the (layer, partition) pair rp = r * P + p; x strides over
// the slots, so no thread divides by anything but P (once).
__global__ void matrix_ingest_kernel(int* __restrict__ pool,
                                     const int* __restrict__ hi,
                                     const int* __restrict__ hj,
                                     const int* __restrict__ wt,
                                     int P, int w, int C) {
    const int rp = blockIdx.y;
    const int* wt_p = wt + (size_t)(rp % P) * C;
    const int* hi_rp = hi + (size_t)rp * C;
    const int* hj_rp = hj + (size_t)rp * C;
    int* tile = pool + (size_t)rp * w * w;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
         c += gridDim.x * blockDim.x) {
        const int v = wt_p[c];
        if (v == 0) continue;
        const int i = hi_rp[c];
        const int j = hj_rp[c];
        if ((unsigned)i >= (unsigned)w || (unsigned)j >= (unsigned)w) continue;
        atomicAdd(tile + i * w + j, v);
    }
}

}  // namespace

// d * P must be at most 65535 (grid y); the wrapper checks it.
extern "C" int matrix_ingest_launch(void* pool, const void* hi, const void* hj,
                                    const void* wt, int d, int P, int w, int C,
                                    void* stream) {
    if (d == 0 || P == 0 || C == 0) return 0;
    const int threads = 256;
    int blocks_x = (C + threads - 1) / threads;
    if (blocks_x > 1024) blocks_x = 1024;  // grid-stride beyond 1024 x-blocks
    const dim3 grid(blocks_x, d * P);
    matrix_ingest_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (int*)pool, (const int*)hi, (const int*)hj, (const int*)wt, P, w, C);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matrix_ingest_edges: the whole ingest of one batch, from the raw edges.
//
// Replaces, as one launch: src/repro/kernels/ops.py `kmatrix_accel_ingest`
// (routing, hashing, the (P_c, capacity) rectangles, one Pallas
// `matrix_ingest` per class, the overflow scatter and the conn scatter)
// and `accel_matrix_ingest` (two hash passes and the P = 1 kernel).  The
// rectangles exist because the TPU has no atomics; with atomics the cell of
// every edge is known from the edge alone, so each thread routes, hashes and
// adds its edge itself:
//
//   routed (width-class kMatrix), for weight > 0 only, partition p = route(src):
//     pools[class(p)][r, index(p), fastrange(mix_r(src), w_c),
//                                  fastrange(mix_r(dst), w_c)] += weight
//   and for every weight, when conn_w > 0:
//     conn[r, fastrange(mix_r(src), conn_w), fastrange(mix_r(dst), conn_w)] += weight
//   overflow += sum_p max(0, n_live(p) - capacity)   (the rectangles' tally)
//
//   P = 1 (TCM, gMatrix), every nonzero weight, negative ones too:
//     pools[0][r, 0, fastrange(mix_r(src), w), fastrange(mix_r(dst), w)] += weight
//
// The in-capacity and overflow paths of the rectangle dispatch add the same
// cells (a partition's width is its class's), so the pools do not depend on
// capacity; only the tally does.  It is counted with one atomicAdd per live
// edge into an int32[P] scratch, zeroed here on the same stream, and skipped
// when capacity >= B (no partition can overflow).
//
// Bound on this card: bytes.  The work is reading src, dst and weight once,
// the route keys a search touches, and one read-modify-write sector per
// updated counter: at the main path (B = 8,192, d = 7; pools [7,14,16,16],
// [7,2,32,32], [7,1,64,64] and conn [7,43,43], 324 KB) well under a
// microsecond at 3.35 TB/s, so the kernel is launch-bound and what it saves
// is the host's hundred-odd operations per batch.  Design: one thread per
// (edge, layer group); blockIdx.x runs over the edges (coalesced reads),
// blockIdx.y over the layer groups, and each thread loops over its group's
// layers (`matrix_ingest.LAYERS_PER_THREAD` sets the group size).  Global
// int32 atomicAdds; the counters stay in L2.  The class pools travel by value
// in the kernel's parameters, so no pointer table is copied per batch.  Not
// privatized in shared memory: a layer holds more counters (9,728, 11,577
// with conn) than a batch has edges.  Integer atomics commute: the result is
// bit-exact run to run and exact at any count.

namespace {

constexpr int kMaxClasses = 16;  // the wrapper refuses more

struct ClassPools {
    int* base[kMaxClasses];   // int32[d, parts, width, width] per class
    int parts[kMaxClasses];
    int width[kMaxClasses];
};

template <bool kRouted>
__global__ void matrix_ingest_edges_kernel(
        ClassPools pools, const int* __restrict__ src,
        const int* __restrict__ dst, const int* __restrict__ wt,
        const long long* __restrict__ a, const long long* __restrict__ b,
        int B, int d, const int* __restrict__ keys,
        const int* __restrict__ key_part, int n_keys, int outlier,
        const int* __restrict__ part_class, const int* __restrict__ part_index,
        int* __restrict__ conn, int conn_w, int* __restrict__ live_count,
        int capacity, int* __restrict__ overflow) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= B) return;
    const int v = wt[e];
    if (v == 0) return;  // adds nothing to any counter and is not live
    const int s = src[e];
    const int t = dst[e];
    bool to_pool = true;  // P = 1: every nonzero weight
    int cls = 0, row = 0;
    if (kRouted) {
        to_pool = v > 0;  // the rectangle dispatch parks weight <= 0
        if (to_pool) {
            const int p = sketch::route(keys, key_part, n_keys, outlier, s);
            cls = __ldg(part_class + p);
            row = __ldg(part_index + p);
            if (live_count != nullptr && blockIdx.y == 0 &&
                atomicAdd(live_count + p, 1) >= capacity) {
                atomicAdd(overflow, 1);
            }
        }
    }
    int* const pool = pools.base[cls];
    const uint32_t w = (uint32_t)pools.width[cls];
    const size_t parts = (size_t)pools.parts[cls];
    const uint32_t cw = (uint32_t)conn_w;
    for (int r = blockIdx.y; r < d; r += gridDim.y) {
        const uint32_t ar = (uint32_t)__ldg(a + r);
        const uint32_t br = (uint32_t)__ldg(b + r);
        const uint32_t hs = sketch::mix(ar, br, (uint32_t)s);
        const uint32_t ht = sketch::mix(ar, br, (uint32_t)t);
        if (to_pool) {
            const size_t tile = ((size_t)r * parts + row) * w;
            atomicAdd(pool + (tile + sketch::fastrange(hs, w)) * w
                          + sketch::fastrange(ht, w), v);
        }
        if (kRouted && cw > 0) {
            atomicAdd(conn + ((size_t)r * cw + sketch::fastrange(hs, cw)) * cw
                          + sketch::fastrange(ht, cw), v);
        }
    }
}

}  // namespace

// Routed when `routed` is nonzero (keys .. overflow are then the sketch's
// own device tensors), else P = 1 into pool_base[0].  live_count is an
// int32[n_parts] scratch, read only when capacity < B.  The wrapper checks
// shapes, types and 1 <= n_classes <= 16.
extern "C" int matrix_ingest_edges_launch(
        void* const* pool_base, const int* pool_parts, const int* pool_width,
        int n_classes, const void* src, const void* dst, const void* wt,
        const void* a, const void* b, int B, int d, int routed,
        const void* keys, const void* key_part, int n_keys, int outlier,
        const void* part_class, const void* part_index, int n_parts,
        void* conn, int conn_w, void* live_count, int capacity, void* overflow,
        int layer_groups, void* stream) {
    if (B == 0 || d == 0) return 0;
    if (n_classes < 1 || n_classes > kMaxClasses || layer_groups < 1 ||
        layer_groups > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    ClassPools pools = {};
    for (int c = 0; c < n_classes; ++c) {
        pools.base[c] = (int*)pool_base[c];
        pools.parts[c] = pool_parts[c];
        pools.width[c] = pool_width[c];
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const bool count = routed && capacity < B;
    if (count) {
        const cudaError_t err =
            cudaMemsetAsync(live_count, 0, (size_t)n_parts * sizeof(int), s);
        if (err != cudaSuccess) return (int)err;
    }
    const int threads = 256;
    const dim3 grid((B + threads - 1) / threads, layer_groups);
    if (routed) {
        matrix_ingest_edges_kernel<true><<<grid, threads, 0, s>>>(
            pools, (const int*)src, (const int*)dst, (const int*)wt,
            (const long long*)a, (const long long*)b, B, d, (const int*)keys,
            (const int*)key_part, n_keys, outlier, (const int*)part_class,
            (const int*)part_index, (int*)conn, conn_w,
            count ? (int*)live_count : nullptr, capacity, (int*)overflow);
    } else {
        matrix_ingest_edges_kernel<false><<<grid, threads, 0, s>>>(
            pools, (const int*)src, (const int*)dst, (const int*)wt,
            (const long long*)a, (const long long*)b, B, d, nullptr, nullptr,
            0, 0, nullptr, nullptr, nullptr, 0, nullptr, 0, nullptr);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* matrix_ingest_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
