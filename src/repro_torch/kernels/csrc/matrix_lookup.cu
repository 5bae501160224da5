// matrix_lookup: batched sketch point queries, a gather and a min over layers.
// Four entry points: `matrix_lookup_launch` on given hi/hj (the Pallas
// function's counterpart), `matrix_lookup_edges_launch` on the raw query
// endpoints, hashed in the kernel, and the width-class kMatrix's routed
// `kmatrix_lookup_edges_launch` and `kmatrix_node_out_launch` (below).
//
// Replaces: src/repro/kernels/matrix_lookup.py, `matrix_lookup` (Pallas body
// `_lookup_kernel`).  The TPU kernel reads the addressed cell as a one-hot
// matrix product (U @ M) * V row-summed on the MXU, on a grid
// (P, C / TQ, d) with the layer axis innermost so that its min accumulator
// stays resident.  Hopper can gather, so this kernel computes the function
// itself:
//
//     out[p, c] = min_r pool[r, p, hi[r,p,c], hj[r,p,c]]
//
// pool int32[d, P, w, w], hi/hj int32[d, P, C], out int32[P, C].  hi and hj
// must lie in [0, w): the wrapper's precondition, which the query path meets
// by computing them with fastrange into [0, w).
//
// Bound on this card: bytes.  The work is reading hi and hj once, one
// int32 of the pool per (layer, query), and writing out once: at the main
// path's shape (pool [7, 1, 136, 136], C = 10,000) about 0.9 MB, 0.27 us at
// 3.35 TB/s, far below one launch's cost, so at that shape the kernel is
// launch-bound.  Design: one thread per (p, c) query, looping over the d
// layers with an int32 running min in a register (the loop takes the place
// of the TPU's sequential layer axis, so no accumulator lives in memory).
// blockIdx.y is p and x runs over c, so neighbouring threads read
// neighbouring hi/hj words (coalesced); the pool reads are gathers, and a
// pool this small (518 KB at the main path) stays in L2.  The ragged edge
// of C is masked, so any C works.  Integer min is exact at any count (the
// one-hot f32 product is exact only below 2^24).
#include <cuda_runtime.h>
#include <climits>

#include "sketch_addr.cuh"

namespace {

__global__ void matrix_lookup_kernel(const int* __restrict__ pool,
                                     const int* __restrict__ hi,
                                     const int* __restrict__ hj,
                                     int* __restrict__ out,
                                     int d, int P, int w, int C) {
    const int p = blockIdx.y;
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const size_t plane = (size_t)w * w;
    int best = INT_MAX;
    for (int r = 0; r < d; ++r) {
        const size_t rp = (size_t)r * P + p;
        const int i = hi[rp * C + c];
        const int j = hj[rp * C + c];
        best = min(best, __ldg(pool + rp * plane + (size_t)i * w + j));
    }
    out[(size_t)p * C + c] = best;
}

}  // namespace

// P must be at most 65535 (grid y) and C below 2^30; the wrapper checks both.
extern "C" int matrix_lookup_launch(const void* pool, const void* hi,
                                    const void* hj, void* out, int d, int P,
                                    int w, int C, void* stream) {
    if (P == 0 || C == 0) return 0;
    const int threads = 256;
    const dim3 grid((C + threads - 1) / threads, P);
    matrix_lookup_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int*)pool, (const int*)hi, (const int*)hj, (int*)out, d, P, w, C);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matrix_lookup_edges: the whole `accel_matrix_edge_freq` in one launch.
//
// Replaces: src/repro/kernels/ops.py `accel_matrix_edge_freq` (two hash
// passes, then the Pallas `matrix_lookup` at P = 1):
//
//     out[q] = min_r table[r, fastrange(mix_r(src[q]), w),
//                             fastrange(mix_r(dst[q]), w)]
//
// table int32[d, w, w], src/dst int32[n], out int32[n], any n.  The cells
// are hashed into [0, w) here, so no range precondition remains.
//
// Bound on this card: bytes, and at the query path (table [7,136,136],
// n = 10,000) far below a launch's cost.  Design: one thread per query,
// the layer loop and its running min in registers, as in
// matrix_lookup_kernel, the layers taken in predicated chunks of 8 so that
// a thread's gathers are in flight together (a wide table's miss L2: at
// [7, 2048, 2048] and 10^6 queries a plain loop waited on each in turn);
// the endpoint reads are coalesced.

namespace {

__global__ void matrix_lookup_edges_kernel(const int* __restrict__ table,
                                           const long long* __restrict__ a,
                                           const long long* __restrict__ b,
                                           const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           int* __restrict__ out,
                                           int d, int w, int n) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const uint32_t s = (uint32_t)src[q];
    const uint32_t t = (uint32_t)dst[q];
    const uint32_t uw = (uint32_t)w;
    int best = INT_MAX;
    for (int r0 = 0; r0 < d; r0 += 8) {
        int cell[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int r = r0 + k;
            cell[k] = INT_MAX;
            if (r < d) {
                const uint32_t ar = (uint32_t)__ldg(a + r);
                const uint32_t br = (uint32_t)__ldg(b + r);
                const uint32_t i = sketch::fastrange(sketch::mix(ar, br, s), uw);
                const uint32_t j = sketch::fastrange(sketch::mix(ar, br, t), uw);
                cell[k] = __ldg(table + ((size_t)r * uw + i) * uw + j);
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) best = min(best, cell[k]);
    }
    out[q] = best;
}

}  // namespace

// d >= 1 and n below 2^31; the wrapper checks both.
extern "C" int matrix_lookup_edges_launch(const void* table, const void* a,
                                          const void* b, const void* src,
                                          const void* dst, void* out, int d,
                                          int w, int n, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)(((long long)n + threads - 1) / threads);
    matrix_lookup_edges_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)table, (const long long*)a, (const long long*)b,
        (const int*)src, (const int*)dst, (int*)out, d, w, n);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kmatrix_lookup_edges and kmatrix_node_out: the width-class kMatrix's point
// queries, routing and class-table gather included, one launch each.
//
// Replaces no TPU kernel: the JAX package answers these queries with plain
// gathers outside any kernel (src/repro/core/kmatrix_accel.py `edge_freq`
// and `node_out_freq`, one masked gather per width class), and the port did
// the same until these kernels.  On this card those gathers are
// launch-bound: some 70-100 eager operators a call (two emulated-uint32
// hash passes, a route search, a compare, where, clamp, gather and min per
// class), each microseconds of host dispatch for nanoseconds of device
// work.  Here each call is one launch:
//
//   kmatrix_lookup_edges, p = route(src[q]), c = class(p), w = width(c):
//     out[q] = min_r pools[c][r, index(p), fastrange(mix_r(src[q]), w),
//                                          fastrange(mix_r(dst[q]), w)]
//   kmatrix_node_out, p = route(v[q]), c = class(p), w = width(c):
//     out[q] = min_r sum_j pools[c][r, index(p), fastrange(mix_r(v[q]), w), j]
//
// with the row sum in int32 that wraps mod 2^32, as
// `sum(dim=-1, dtype=torch.int32)` does.  pools are the class pools
// int32[d, P_c, w_c, w_c] (widths powers of two, at most 16 classes, passed
// by value in a class table of this file's own), ids int32[n], any n.
// Precondition, as a sketch's own tables meet it: route parts lie in
// [0, P) and part_class / part_index address the pools.
//
// Bound on this card: bytes, and far below a launch.  At the serving path
// (d = 7; pools [7,14,16,16], [7,2,32,32], [7,1,64,64], 324 KB, in L2):
// an edge query needs its two ids, its answer and 7 cells; a node query its
// id, its answer and 7 rows of at most 256 bytes, and no call needs more
// than the pools once.  512 edge queries need about 20 KB, 4,096 node ids
// at most the 324 KB and 32 KB of ids and answers: 6 ns and 0.11 us at
// 3.35 TB/s, far below a launch.  Design.  Edges: one thread per
// query (coalesced id reads), the route search, then the layers in
// predicated chunks of 8 as in matrix_lookup_edges_kernel, so that a
// query's gathers are in flight together; an int32 running min in a
// register.  Node rows: a thread per query would wait on up to 7 x 16
// loads in turn, so a warp takes each query.  Its lanes split into groups
// of G = min(S, 32) lanes, S the row's 16-byte segments (4-byte where a row
// is narrower than 16 bytes), one layer's row to a group; 32 / G layers go
// in one pass and up to 8 passes are loaded before any is reduced, so all
// of a query's loads are in flight together.  Shuffles sum each group's
// row and then take the min across groups; a row wider than 32 segments is
// looped over.  Integer sums and mins are exact: the answers equal the
// plain gathers bit for bit.

namespace {

constexpr int kMaxLookupClasses = 16;  // the wrapper refuses more

struct LookupClasses {
    const int* base[kMaxLookupClasses];  // int32[d, parts, width, width]
    int parts[kMaxLookupClasses];
    int width[kMaxLookupClasses];
};

__global__ void kmatrix_lookup_edges_kernel(
        LookupClasses pools, const long long* __restrict__ a,
        const long long* __restrict__ b, int d,
        const int* __restrict__ keys, const int* __restrict__ key_part,
        int n_keys, int outlier, const int* __restrict__ part_class,
        const int* __restrict__ part_index, const int* __restrict__ src,
        const int* __restrict__ dst, int* __restrict__ out, int n) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    const int s = src[q];
    const uint32_t t = (uint32_t)dst[q];
    const int p = sketch::route(keys, key_part, n_keys, outlier, s);
    const int cls = __ldg(part_class + p);
    const size_t row = (size_t)__ldg(part_index + p);
    const int* const pool = pools.base[cls];
    const uint32_t w = (uint32_t)pools.width[cls];
    const size_t parts = (size_t)pools.parts[cls];
    int best = INT_MAX;
    for (int r0 = 0; r0 < d; r0 += 8) {
        int cell[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int r = r0 + k;
            cell[k] = INT_MAX;
            if (r < d) {
                const uint32_t ar = (uint32_t)__ldg(a + r);
                const uint32_t br = (uint32_t)__ldg(b + r);
                const uint32_t i =
                    sketch::fastrange(sketch::mix(ar, br, (uint32_t)s), w);
                const uint32_t j = sketch::fastrange(sketch::mix(ar, br, t), w);
                cell[k] = __ldg(pool + (((size_t)r * parts + row) * w + i) * w + j);
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) best = min(best, cell[k]);
    }
    out[q] = best;
}

// One segment of a row: 4 int32 in one 16-byte load, or one int32.
template <bool kVec>
__device__ __forceinline__ uint32_t segment_sum(const int* row, int k) {
    if (kVec) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(row) + k);
        return (uint32_t)x.x + (uint32_t)x.y + (uint32_t)x.z + (uint32_t)x.w;
    }
    return (uint32_t)__ldg(row + k);
}

// The min over layers of one query's row sums; every lane of the warp
// calls it with the same query (the loop bounds are the warp's own).
template <bool kVec>
__device__ __forceinline__ int node_out_rows(
        const int* pool, size_t parts, size_t row, uint32_t w, uint32_t v,
        const long long* __restrict__ a, const long long* __restrict__ b,
        int d, int lane) {
    constexpr unsigned kAll = 0xFFFFFFFFu;
    const int segments = kVec ? (int)(w >> 2) : (int)w;
    const int group = segments < 32 ? segments : 32;  // lanes per row
    const int per_pass = 32 / group;                  // rows per pass
    const int layer_in_pass = lane / group;
    const int seg0 = lane % group;
    int best = INT_MAX;
    for (int r0 = 0; r0 < d; r0 += 8 * per_pass) {
        const int* rows[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const int r = r0 + t * per_pass + layer_in_pass;
            rows[t] = nullptr;
            if (r < d) {
                const uint32_t hi = sketch::fastrange(
                    sketch::mix((uint32_t)__ldg(a + r), (uint32_t)__ldg(b + r), v),
                    w);
                rows[t] = pool + (((size_t)r * parts + row) * w + hi) * w;
            }
        }
        uint32_t sum[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) sum[t] = 0;
        for (int k = seg0; k < segments; k += group) {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                if (rows[t] != nullptr) sum[t] += segment_sum<kVec>(rows[t], k);
            }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            if (r0 + t * per_pass >= d) break;  // the same on every lane
            uint32_t x = sum[t];
            for (int off = group >> 1; off > 0; off >>= 1) {
                x += __shfl_xor_sync(kAll, x, off);
            }
            int m = rows[t] != nullptr ? (int)x : INT_MAX;
            for (int off = group; off < 32; off <<= 1) {
                m = min(m, __shfl_xor_sync(kAll, m, off));
            }
            best = min(best, m);
        }
    }
    return best;
}

__global__ void kmatrix_node_out_kernel(
        LookupClasses pools, const long long* __restrict__ a,
        const long long* __restrict__ b, int d,
        const int* __restrict__ keys, const int* __restrict__ key_part,
        int n_keys, int outlier, const int* __restrict__ part_class,
        const int* __restrict__ part_index, const int* __restrict__ ids,
        int* __restrict__ out, int n) {
    const int q = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (q >= n) return;  // the whole warp: a warp is one query
    const int v = ids[q];
    const int p = sketch::route(keys, key_part, n_keys, outlier, v);
    const int cls = __ldg(part_class + p);
    const size_t row = (size_t)__ldg(part_index + p);
    const int* const pool = pools.base[cls];
    const uint32_t w = (uint32_t)pools.width[cls];
    const size_t parts = (size_t)pools.parts[cls];
    // rows of 4 or more int32 lie at multiples of 16 bytes of a pool, which
    // the allocator aligns to 16 at least; narrower rows take 4-byte loads
    const bool vec = w >= 4 && (reinterpret_cast<uintptr_t>(pool) & 15) == 0;
    const int best =
        vec ? node_out_rows<true>(pool, parts, row, w, (uint32_t)v, a, b, d, lane)
            : node_out_rows<false>(pool, parts, row, w, (uint32_t)v, a, b, d, lane);
    if (lane == 0) out[q] = best;
}

}  // namespace

// The class table comes as a host LookupClasses (the wrapper keeps one per
// set of pools) and is copied into the kernel's parameters.  d >= 1, n
// below 2^31 and 1 <= n_classes <= 16; the wrapper checks them.
extern "C" int kmatrix_lookup_edges_launch(
        const void* classes, int n_classes, const void* a, const void* b, int d,
        const void* keys, const void* key_part, int n_keys, int outlier,
        const void* part_class, const void* part_index, const void* src,
        const void* dst, void* out, int n, void* stream) {
    if (n_classes < 1 || n_classes > kMaxLookupClasses) {
        return (int)cudaErrorInvalidValue;
    }
    const LookupClasses pools = *(const LookupClasses*)classes;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)(((long long)n + threads - 1) / threads);
    kmatrix_lookup_edges_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pools, (const long long*)a, (const long long*)b, d, (const int*)keys,
        (const int*)key_part, n_keys, outlier, (const int*)part_class,
        (const int*)part_index, (const int*)src, (const int*)dst, (int*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int kmatrix_node_out_launch(
        const void* classes, int n_classes, const void* a, const void* b, int d,
        const void* keys, const void* key_part, int n_keys, int outlier,
        const void* part_class, const void* part_index, const void* ids,
        void* out, int n, void* stream) {
    if (n_classes < 1 || n_classes > kMaxLookupClasses) {
        return (int)cudaErrorInvalidValue;
    }
    const LookupClasses pools = *(const LookupClasses*)classes;
    if (n == 0) return 0;
    const int threads = 256;  // 8 queries a block
    const unsigned blocks = (unsigned)(((long long)n * 32 + threads - 1) / threads);
    kmatrix_node_out_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pools, (const long long*)a, (const long long*)b, d, (const int*)keys,
        (const int*)key_part, n_keys, outlier, (const int*)part_class,
        (const int*)part_index, (const int*)ids, (int*)out, n);
    return (int)cudaGetLastError();
}

extern "C" const char* matrix_lookup_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
