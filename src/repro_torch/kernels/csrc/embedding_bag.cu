// embedding_bag: fixed-arity embedding bag, a row gather and a sum per bag;
// embedding_bag_backward (below): its gradient with respect to the table.
//
// Replaces: src/repro/kernels/embedding_bag.py, `embedding_bag` (Pallas body
// `_bag_kernel`).  The TPU kernel walks a (B, F) grid with the field axis
// innermost: scalar prefetch hands each step's BlockSpec the row
// idx[b, f], Pallas streams that one row HBM -> VMEM and adds it into the
// bag's (1, D) output tile, which stays resident across the field axis.
// Its table must be lane-aligned (D a multiple of 128), so the FM pads its
// 10-wide table to 128.  Hopper has neither constraint:
//
//     out[b, d] = sum_f w[b, f] * table[idx[b, f], d]
//
// table f32[V, D] with any D >= 1, idx int32[B, F], w f32[B, F] or null
// (unweighted), out f32[B, D].  idx must lie in [0, V): the wrapper's
// precondition, which the FM meets by construction (field offset plus a
// floor mod by the field's vocabulary).
//
// Order of operations: f = 0 .. F-1 in order from 0.0f, one rounding per
// step: acc + row unweighted, fmaf(row, w, acc) weighted.  That is the
// Pallas kernel's order (its grid is sequential and XLA fuses the
// weighted step into one multiply-add), so this kernel, its plain
// PyTorch version and the Pallas kernel agree bit for bit.  Loads run
// ahead of the adds; the adds are never reordered.
//
// Bound on this card: bytes.  A bag reads its F indices (and weights)
// once, F gathered rows of D floats, and writes D floats; there are no
// operations to speak of.  What costs is latency: each gathered row is a
// random read, at the FM's shapes (D = 10, rows over a 400 MB table) two
// or three 32-byte sectors, and a thread that waits for one row before
// asking for the next keeps one read in flight.  Design:
//
//  * A block owns a run of NB neighbouring bags, whose indices (and
//    weights) are one contiguous run of NB F words.  The block copies them
//    into shared memory with 16-byte loads (a scalar head and tail where
//    the run is not 16-byte aligned) before any gather.  They are read
//    once, so they are loaded evict-first (__ldcs), and do not push the
//    table's rows out of L2.  Every thread then reads its idx[b, f] from
//    shared memory: at D = 1, where one thread owns a whole bag, loads of
//    its own from device memory would be F words apart from its
//    neighbours' and never coalesce.  A bag's fields sit at a stride FS = F rounded up to
//    odd, so the threads of a warp, each on its own bag, hit distinct
//    banks.  A run longer than the staging space is taken in chunks of
//    fields, the partial sum kept in `out` between chunks (exact: a float
//    stored and read back is the same float).
//  * Each thread owns V neighbouring output elements of one bag (V = 4,
//    2 or 1, the widest that divides D and the table pointer's
//    alignment; the wrapper decides) and loads them as one float4, float2
//    or float.  D = 10 rows are 40 bytes and 8-byte aligned: float2.
//  * The field loop is unrolled by UNROLL: a chunk's row loads are
//    issued before its adds, so that many reads are in flight per thread
//    and nothing waits on the previous row.  16 at V = 1, whose rows (4
//    bytes of a 40 MB table that L2 mostly holds) are latency-bound; 8
//    for wider rows, where the random sectors from device memory bound
//    the bag and 8 measured faster than 16 on an H100 at D = 10.  Rows
//    are loaded L2-only (__ldcg): a random row is seldom read again by the
//    same SM, so L1 would only hold it to no use (measured a little faster
//    there).
//  * The wrapper sizes NB so that small batches still spread over the SMs
//    (a serve_p99 bag of 512 rows runs as 128 blocks, not 2).
//
// Row offsets are 64-bit (V * D may pass 2^31); the flat output index fits
// 32 bits, since the wrapper checks B * D < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/block/block_store.cuh>

namespace {

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float2 vzero(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float4 vzero(float4) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

// one rounding per element, never contracted
__device__ __forceinline__ float vadd(float a, float x) { return __fadd_rn(a, x); }
__device__ __forceinline__ float2 vadd(float2 a, float2 x) {
    return make_float2(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 x) {
    return make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                       __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
}

__device__ __forceinline__ float vfma(float x, float w, float a) {
    return fmaf(x, w, a);
}
__device__ __forceinline__ float2 vfma(float2 x, float w, float2 a) {
    return make_float2(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y));
}
__device__ __forceinline__ float4 vfma(float4 x, float w, float4 a) {
    return make_float4(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y),
                       fmaf(x.z, w, a.z), fmaf(x.w, w, a.w));
}

// Copy fields [f0, f0 + fc) of bags [b0, b0 + nb) of a [B, F] word array
// into dst[bag * FS + field].  All fields at once are one contiguous run:
// 16-byte loads, with a scalar head up to the first 16-byte boundary and a
// scalar tail.
__device__ void stage(int* __restrict__ dst, const int* __restrict__ src,
                      int b0, int nb, int F, int f0, int fc, int FS) {
    if (fc == F) {
        const int* p = src + (long long)b0 * F;
        const int n = nb * F;
        auto put = [&](int j, int v) {
            dst[FS == F ? j : (j / F) * FS + j % F] = v;
        };
        const int head = min(n, (int)((16 - ((uintptr_t)p & 15)) & 15) / 4);
        const int nv = (n - head) / 4;
        for (int j = threadIdx.x; j < head; j += blockDim.x) put(j, __ldcs(p + j));
        const int4* q = reinterpret_cast<const int4*>(p + head);
        for (int i = threadIdx.x; i < nv; i += blockDim.x) {
            const int4 v = __ldcs(q + i);
            const int j = head + 4 * i;
            put(j, v.x);
            put(j + 1, v.y);
            put(j + 2, v.z);
            put(j + 3, v.w);
        }
        for (int j = head + 4 * nv + threadIdx.x; j < n; j += blockDim.x)
            put(j, __ldcs(p + j));
    } else {
        for (int e = threadIdx.x; e < nb * fc; e += blockDim.x) {
            const int bag = e / fc, f = e - bag * fc;
            dst[bag * FS + f] = __ldcs(src + (long long)(b0 + bag) * F + f0 + f);
        }
    }
}

template <int V, bool kWeighted>
__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int B, int F,
                                     int D, int NB, int FC, int FS) {
    using T = typename Vec<V>::T;
    constexpr int UNROLL = V == 1 ? 16 : 8;  // row loads in flight a thread
    extern __shared__ int smem[];
    int* s_idx = smem;
    float* s_w = reinterpret_cast<float*>(smem + NB * FS);
    const int DV = D / V;
    const int b0 = blockIdx.x * NB;
    const int nb = min(NB, B - b0);
    const int n_out = nb * DV;
    const T* rows = reinterpret_cast<const T*>(table);
    T* o = reinterpret_cast<T*>(out) + (size_t)b0 * DV;

    for (int f0 = 0;; f0 += FC) {
        const int fc = min(FC, F - f0);
        stage(s_idx, idx, b0, nb, F, f0, fc, FS);
        if (kWeighted)
            stage(reinterpret_cast<int*>(s_w),
                  reinterpret_cast<const int*>(w), b0, nb, F, f0, fc, FS);
        __syncthreads();
        for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
            const int bag = e / DV, dv = e - bag * DV;
            const int* bag_idx = s_idx + bag * FS;
            const float* bag_w = s_w + bag * FS;
            T acc = f0 == 0 ? vzero(T{}) : o[e];
            for (int f = 0; f < fc; f += UNROLL) {
                T x[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
                    if (f + u < fc)
                        x[u] = __ldcg(rows + (long long)bag_idx[f + u] * DV + dv);
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
                    if (f + u < fc)
                        acc = kWeighted ? vfma(x[u], bag_w[f + u], acc)
                                        : vadd(acc, x[u]);
            }
            o[e] = acc;
        }
        if (f0 + FC >= F) break;
        __syncthreads();  // before the next chunk overwrites the staging
    }
}

template <int V>
void launch(const float* table, const int* idx, const float* w, float* out,
            int B, int F, int D, int NB, int threads, int FC, int FS,
            cudaStream_t s) {
    const unsigned blocks = (unsigned)((B + NB - 1) / NB);
    const size_t smem = (size_t)NB * FS * sizeof(int) * (w ? 2 : 1);
    if (w != nullptr) {
        embedding_bag_kernel<V, true><<<blocks, threads, smem, s>>>(
            table, idx, w, out, B, F, D, NB, FC, FS);
    } else {
        embedding_bag_kernel<V, false><<<blocks, threads, smem, s>>>(
            table, idx, nullptr, out, B, F, D, NB, FC, FS);
    }
}

}  // namespace

// ---------------------------------------------------------------- backward --
//
// embedding_bag_backward: the gradient of the unweighted bag with respect
// to its table, for training the FM.  No TPU kernel has it: the Pallas
// `embedding_bag` has no custom_vjp, and the JAX package trains through the
// plain gather `params["emb"][rows]`, whose transpose XLA emits as a
// scatter-add.  This is that scatter-add, with the FM's squared table
// folded in:
//
//     grad[idx[b, f], d] = sum over the pairs (b, f) that hit the row of
//                          grad_out[b, d] (+ 2 table[idx[b, f], d] grad_sq[b, d])
//
// grad_out f32[B, D], idx int32[B, F] in [0, V), table f32[V, D] and
// grad_sq f32[B, D] both given or both null, grad f32[V, D] written whole
// (the wrapper does not clear it).  With the squared term, one call gives
// the whole gradient of a table read by a Σv bag and a Σv² bag (the bag of
// table * table): d(Σv²)/dv = 2 v.
//
// Order of addition, the plain version's: the pairs in order p = f B + b
// (field-major), each contribution rounded once, fmaf(2 t, g_sq, g) (2 t is
// exact), summed in float64 from 0.0 with one rounding per step, and the
// sum rounded to float32 once.  So the result is bit-equal to the plain
// version and the same from call to call.
//
// Bound on this card: bytes.  At the FM's shapes (a 10,000,384 x 10 table,
// B = 65,536, F = 39) the dense gradient written once is 400 MB against
// about 60 MB of inputs.  So the gradient is written exactly once, in row
// order: no fill before, no atomics, no read-modify-write of its rows.  The
// table is cut into tiles of R = 2^rlog rows (the wrapper's `backward_plan`
// picks R), and each tile's pairs are brought together first, in pair
// order, by four passes over the B F pairs (p = f B + b):
//
//  0. transpose: key[p] = idx[b, f], through shared memory so that reads
//     and writes coalesce (read in place, idx's column f is one word of
//     every 32-byte sector).
//  1. count: a block per chunk of CHUNK = 4,096 pairs counts them per tile
//     (a shared histogram) into cnt[chunk][tile].
//  2. colscan: cnt[c][t] becomes the pairs of tile t in chunks before c and
//     tot[t] all of t's pairs; the last block to finish (a ticket) writes
//     base, the exclusive scan of tot: tile t's bucket starts at base[t].
//  3. scatter: a block sorts its chunk by tile (CUB's block radix sort,
//     stable, on keys tile << 12 | place in the chunk) and puts each pair
//     at base[t] + cnt[c][t] + its rank among the chunk's pairs of t, so
//     every bucket holds its pairs in pair order; the entries pass through
//     shared memory to a striped order, so that a warp writes a run's
//     places side by side.  An entry packs (row within the tile) << bbits
//     | b, the wrapper checking that rlog + bbits <= 32.
//  4. reduce: a block per tile, the tiles at the table's end first.  It
//     sorts its bucket stably by row in shared memory (CUB again, on the
//     entries' row bits, at 1,024, 4,096 or 8,192 keys; a bucket of at
//     most 256 entries is ranked directly) and marks each row's run of
//     entries.  Then, a run of rows at a time, it gathers the run's
//     contributions, every (entry, d) apart and each rounded once, into a
//     shared buffer of CBUF floats (so the scattered reads of grad_out and
//     grad_sq overlap), and sweeps the run's elements in row order: a row
//     with no pair stores 0, a hit row's element sums its contributions
//     from the buffer in pair order.  Parallel over rows and D, never over
//     a row's pairs.  A row with more pairs than the buffer holds sums
//     straight from device memory.  The table rows the squared term reads
//     are the tile's own, one local region.  A bucket larger than the sort
//     (K = 8,192 entries) is taken in windows of K / 4 elements (their
//     float64 running sums in shared memory) and, in each window, chunks
//     of K / 2 entries in order, each chunk placed by one warp
//     (__match_any_sync ranks); each element adds its chunk's pairs to its
//     running sum, so the order stays the pairs' order.  That path is slow
//     (each window reads the whole bucket) and the FM's buckets never take
//     it.
//
// What bounds it (measured on an H100, PERF.md): the reduce, whose blocks
// run their sort, gather and sweep one after another, two blocks a SM (the
// 8,192-key sort takes 128 registers); the sweeps stream at about the
// card's write rate while they run, but no faster than the other phases
// let them.  The four bucketing passes are most of a D = 1 call.
//
// The scratch (key, bucket, cnt, tot, base, ticket) comes from the
// wrapper, uninitialised: every word is written before it is read.
namespace bwd {

constexpr int WARPS = 8;  // every backward kernel runs blocks of 8 warps
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no tile, no row: a key no lane matches

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// Exclusive scan of a[0, n) in shared memory, in place, by the whole block;
// returns the total.  ws: WARPS words of shared scratch.
__device__ unsigned block_scan(unsigned* a, int n, unsigned* ws) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (n + THREADS - 1) / THREADS;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    unsigned s = 0;
    for (int i = lo; i < hi; ++i) s += a[i];
    unsigned x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned w = lane < WARPS ? ws[lane] : 0;
#pragma unroll
        for (int o = 1; o < WARPS; o <<= 1) {
            const unsigned y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        if (lane < WARPS) ws[lane] = w;
    }
    __syncthreads();
    unsigned run = x - s + (warp ? ws[warp - 1] : 0);
    for (int i = lo; i < hi; ++i) {
        const unsigned v = a[i];
        a[i] = run;
        run += v;
    }
    const unsigned total = ws[WARPS - 1];
    __syncthreads();
    return total;
}

// The tile of a row, relative to t0, or NONE when it lies outside
// [t0, t0 + nt) (a row outside [0, V) has no tile).
__device__ __forceinline__ unsigned tile_of(int row, int V, int rlog, int t0,
                                            int nt) {
    const unsigned t = ((unsigned)row >> rlog) - (unsigned)t0;
    return (unsigned)row < (unsigned)V && t < (unsigned)nt ? t : NONE;
}

// Pass 0.  key[f B + b] = idx[b, f]: idx in pair order, through shared
// memory in tiles of 32 bags x 32 fields, so reads and writes coalesce.
__global__ void __launch_bounds__(THREADS)
bwd_transpose(const int* __restrict__ idx, int* __restrict__ key, int B,
              int F) {
    __shared__ int tile[32][33];
    const int b0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < 32; i += WARPS) {
        const int b = b0 + i, f = f0 + lane;
        if (b < B && f < F) tile[i][lane] = __ldg(idx + (long long)b * F + f);
    }
    __syncthreads();
    for (int i = warp; i < 32; i += WARPS) {
        const int f = f0 + i, b = b0 + lane;
        if (b < B && f < F) key[(long long)f * B + b] = tile[lane][i];
    }
}

// Pairs a chunk holds: what pass 3 sorts at once, 16 a thread.
constexpr int CHUNK_IPT = 16;
constexpr int CHUNK = THREADS * CHUNK_IPT;

// Pass 1.  Block c: the pairs of chunk c, [c CHUNK, c CHUNK + CHUNK), per
// tile into cnt[c][t] (tiles in ranges of Ts when T > Ts).  Block 0 also
// clears the ticket that pass 2's blocks take.
__global__ void __launch_bounds__(THREADS)
bwd_count(const int* __restrict__ key, unsigned* __restrict__ cnt,
          unsigned* __restrict__ ticket, int N, int V, int rlog, int T,
          int Ts) {
    extern __shared__ unsigned hist[];
    if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;
    const int c = blockIdx.x, p0 = c * CHUNK, p1 = min(N, p0 + CHUNK);
    for (int t0 = 0; t0 < T; t0 += Ts) {
        const int nt = min(Ts, T - t0);
        for (int i = threadIdx.x; i < nt; i += THREADS) hist[i] = 0;
        __syncthreads();
#pragma unroll 4
        for (int p = p0 + threadIdx.x; p < p1; p += THREADS) {
            const unsigned t = tile_of(key[p], V, rlog, t0, nt);
            if (t != NONE) atomicAdd(hist + t, 1u);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < nt; i += THREADS)
            cnt[(long long)c * T + t0 + i] = hist[i];
        __syncthreads();
    }
}

// Pass 2.  Lane l of block x owns tile 32 x + l; warp w a run of chunks.
// The last block to finish also writes base: the exclusive scan of tot
// (base[T] = every pair).
__global__ void __launch_bounds__(THREADS)
bwd_colscan(unsigned* __restrict__ cnt, unsigned* __restrict__ tot,
            unsigned* __restrict__ base, unsigned* __restrict__ ticket, int C,
            int T) {
    constexpr int SPAN = 8 * THREADS;  // totals the last block scans at once
    __shared__ unsigned seg[WARPS][32];
    __shared__ unsigned buf[SPAN];
    __shared__ unsigned ws[WARPS];
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = blockIdx.x * 32 + lane;
    const int cs = (C + WARPS - 1) / WARPS;
    const int c0 = min(C, warp * cs), c1 = min(C, c0 + cs);
    unsigned s = 0;
    if (t < T) {
#pragma unroll 8
        for (int c = c0; c < c1; ++c) s += cnt[(long long)c * T + t];
    }
    seg[warp][lane] = s;
    __syncthreads();
    unsigned run = 0, all = 0;
    for (int w = 0; w < WARPS; ++w) {
        const unsigned v = seg[w][lane];
        run += w < warp ? v : 0;
        all += v;
    }
    if (t < T) {
        for (int c = c0; c < c1; c += 8) {  // 8 loads ahead of their stores
            unsigned v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                v[u] = c + u < c1 ? cnt[(long long)(c + u) * T + t] : 0;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                if (c + u < c1) cnt[(long long)(c + u) * T + t] = run;
                run += v[u];
            }
        }
        if (warp == 0) tot[t] = all;
    }
    __threadfence();  // tot visible to every block before the ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    unsigned carry = 0;
    for (int t0 = 0; t0 < T; t0 += SPAN) {
        const int nt = min(SPAN, T - t0);
        for (int i = threadIdx.x; i < nt; i += THREADS)
            buf[i] = __ldcg(tot + t0 + i);
        __syncthreads();
        const unsigned total = block_scan(buf, nt, ws);
        for (int i = threadIdx.x; i < nt; i += THREADS)
            base[t0 + i] = carry + buf[i];
        carry += total;
        __syncthreads();
    }
    if (threadIdx.x == 0) base[T] = carry;
}

// Pass 3.  Block c places the pairs of chunk c into the tile buckets: a
// stable radix sort by tile (the pair's place in the chunk and its row in
// the tile riding along), then each pair at base[t] + (t's pairs in
// earlier chunks) + (its rank among t's pairs in this chunk: its index
// less its run's first).
using ChunkSort = cub::BlockRadixSort<unsigned, THREADS, CHUNK_IPT>;
using RunScan = cub::BlockScan<unsigned, THREADS>;
struct MaxOp {
    __device__ unsigned operator()(unsigned a, unsigned b) const {
        return a > b ? a : b;
    }
};
constexpr int OFF_BITS = 12;  // a place in a chunk: CHUNK = 2^12
static_assert(CHUNK == 1 << OFF_BITS, "a chunk's places take OFF_BITS bits");

// Keys (tile << OFF_BITS | place), sorted on the tile bits only; a key's
// pair is key[p0 + place].  tbits + OFF_BITS <= 32 (the wrapper's check).
__global__ void __launch_bounds__(THREADS)
bwd_scatter(const int* __restrict__ key, const unsigned* __restrict__ cnt,
            const unsigned* __restrict__ base, unsigned* __restrict__ bucket,
            int B, int N, int V, int rlog, int T, int tbits, int bbits) {
    __shared__ union {
        typename ChunkSort::TempStorage sort;
        typename RunScan::TempStorage scan;
    } tmp;
    static_assert(sizeof(tmp) >= CHUNK * sizeof(unsigned),
                  "the sort's storage holds a word per pair after it");
    __shared__ unsigned st[CHUNK];  // the sorted tiles
    const int c = blockIdx.x, p0 = c * CHUNK, n = min(CHUNK, N - p0);
    const unsigned none = (1u << tbits) - 1;  // >= T: sorts last
    const unsigned lmask = (1u << rlog) - 1;
    const unsigned pmask = CHUNK - 1;
    unsigned keys[CHUNK_IPT], first[CHUNK_IPT];
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k) {
        const int i = threadIdx.x * CHUNK_IPT + k;
        unsigned t = none;
        if (i < n) {
            const int row = key[p0 + i];
            if ((unsigned)row < (unsigned)V) t = (unsigned)row >> rlog;
        }
        keys[k] = t << OFF_BITS | (unsigned)i;
    }
    ChunkSort(tmp.sort).Sort(keys, OFF_BITS, OFF_BITS + tbits);
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k)
        st[threadIdx.x * CHUNK_IPT + k] = keys[k] >> OFF_BITS;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k) {
        const int i = threadIdx.x * CHUNK_IPT + k;
        first[k] = i == 0 || st[i - 1] != keys[k] >> OFF_BITS ? i : 0;
    }
    RunScan(tmp.scan).InclusiveScan(first, first, MaxOp());
    unsigned at[CHUNK_IPT];
    int rows[CHUNK_IPT];
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k) {  // every load before any store
        const unsigned t = keys[k] >> OFF_BITS;
        at[k] = t == none ? 0 : base[t] + cnt[(long long)c * T + t];
        rows[k] = t == none ? 0 : key[p0 + (int)(keys[k] & pmask)];
    }
    // each entry's place and word, passed from the sorted (blocked) order
    // to a striped one, so that a warp writes a run's places side by side
    unsigned* place = st;
    unsigned* word = reinterpret_cast<unsigned*>(&tmp);
    __syncthreads();  // st and the scan's storage are free
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k) {
        const int i = threadIdx.x * CHUNK_IPT + k;
        const int p = p0 + (int)(keys[k] & pmask);
        const int f = p / B;
        place[i] = keys[k] >> OFF_BITS == none ? FULL : at[k] + (i - first[k]);
        word[i] = (((unsigned)rows[k] & lmask) << bbits) | (unsigned)(p - f * B);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CHUNK_IPT; ++k) {
        const int i = k * THREADS + threadIdx.x;
        if (place[i] != FULL) bucket[place[i]] = word[i];
    }
}

// Sorts the entries of e[0, m) whose row lies in [r0, r0 + nr), stably by
// row: afterwards row r0 + i's b's, in pair order, are
// sorted[cur[i - 1], cur[i]) (cur[-1] = 0).
__device__ void sort_chunk(const unsigned* __restrict__ e, int m, int r0,
                           int nr, int bbits, unsigned* sorted, unsigned* cur,
                           unsigned* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < nr; i += THREADS) cur[i] = 0;
    __syncthreads();
    for (int q = warp * 32; q < m; q += THREADS) {
        const int i = q + lane;
        const unsigned r = i < m ? (e[i] >> bbits) - (unsigned)r0 : NONE;
        const unsigned k = r < (unsigned)nr ? r : NONE;
        const unsigned peers = __match_any_sync(FULL, k);
        if (k != NONE && lane == __ffs(peers) - 1)
            atomicAdd(cur + k, (unsigned)__popc(peers));
    }
    __syncthreads();
    block_scan(cur, nr, ws);
    if (warp == 0) {
        const unsigned bmask = bbits >= 32 ? FULL : (1u << bbits) - 1;
        unsigned next = lane < m ? e[lane] : 0;
        for (int q = 0; q < m; q += 32) {
            const unsigned v = next;
            if (q + 32 + lane < m) next = e[q + 32 + lane];  // one step ahead
            const unsigned r = q + lane < m ? (v >> bbits) - (unsigned)r0 : NONE;
            const unsigned k = r < (unsigned)nr ? r : NONE;
            const unsigned peers = __match_any_sync(FULL, k);
            if (k != NONE) {
                const unsigned rank = __popc(peers & lanemask_lt());
                const unsigned pos = cur[k] + rank;
                sorted[pos] = v & bmask;
                __syncwarp(peers);
                if (rank == (unsigned)__popc(peers) - 1) cur[k] = pos + 1;
            }
            __syncwarp();
        }
    }
    __syncthreads();
}

// Element (row, d) of the gradient: `a` plus its pairs' contributions
// sorted[s, e) (entries whose low bbits are b), in order, each rounded
// once, summed in float64.
template <bool kSq>
__device__ __forceinline__ double add_pairs(
    double a, const unsigned* sorted, unsigned s, unsigned e, unsigned bmask,
    long long row, int d, int D, const float* __restrict__ g,
    const float* __restrict__ table, const float* __restrict__ gsq) {
    const float two_t = kSq ? 2.f * __ldg(table + row * D + d) : 0.f;
    for (unsigned j = s; j < e; ++j) {
        const long long at = (long long)(sorted[j] & bmask) * D + d;
        float c = __ldg(g + at);
        if (kSq) c = fmaf(two_t, __ldg(gsq + at), c);
        a = __dadd_rn(a, (double)c);
    }
    return a;
}

// A bucket of at most SORT_MAX entries is sorted by CUB's block radix sort
// (stable: LSD, each pass ranking ties in their blocked order) on the row
// bits of the packed entries, at the smallest of three sizes that holds
// it (a bucket of at most THREADS entries is ranked instead, rank_sort).
constexpr int SORT_MAX = THREADS * 32;
template <int IPT>
using BlockSort = cub::BlockRadixSort<unsigned, THREADS, IPT>;
union SortStorage {
    typename BlockSort<4>::TempStorage s4;
    typename BlockSort<16>::TempStorage s16;
    typename BlockSort<32>::TempStorage s32;
};
// Contributions a reduce block gathers at once: floats of its buffer.
constexpr int CBUF = 8192;
constexpr int GATHER_AHEAD = 8;  // (entry, d) items a thread loads at once
constexpr int SWEEP_AHEAD = 4;   // elements a thread sums at once

// e[0, n) (n <= THREADS IPT) sorted stably by row into sorted[0, n).
// `tmp` aliases `sorted`.
template <int IPT>
__device__ void sort_bucket(const unsigned* __restrict__ e, int n, int rlog,
                            int bbits, unsigned* sorted, SortStorage& tmp) {
    unsigned keys[IPT];
    cub::LoadDirectBlocked(threadIdx.x, e, keys, n, FULL);  // FULL: last
    BlockSort<IPT>(reinterpret_cast<typename BlockSort<IPT>::TempStorage&>(tmp))
        .Sort(keys, bbits, bbits + rlog);
    __syncthreads();  // the sort's storage is the output's
    cub::StoreDirectBlocked(threadIdx.x, sorted, keys, n);
}

// e[0, n) (n <= THREADS) sorted stably by row into sorted[0, n): each
// thread ranks its entry against every one staged in `stage`, (row, place)
// order, all threads reading the same word at once.
__device__ void rank_sort(const unsigned* __restrict__ e, int n, int bbits,
                          unsigned* sorted, unsigned* stage) {
    const int tid = threadIdx.x;
    const unsigned mine = tid < n ? e[tid] : 0;
    if (tid < n) stage[tid] = mine;
    __syncthreads();
    if (tid < n) {
        const unsigned r = mine >> bbits;
        int rank = 0;
        for (int j = 0; j < n; ++j) {
            const unsigned rj = stage[j] >> bbits;
            rank += rj < r || (rj == r && j < tid);
        }
        sorted[rank] = mine;
    }
}

// Words of a reduce block's shared memory: the sort's storage and sorted
// entries, each row's run of entries (R + 1 words, rounded up to 16
// bytes), the contribution buffer (CBUF words).
constexpr int SORT_WORDS = ((sizeof(SortStorage) + 15) / 16 * 4 > SORT_MAX
                                ? (int)((sizeof(SortStorage) + 15) / 16 * 4)
                                : SORT_MAX);
__host__ __device__ constexpr int run_words(int rlog) {
    return ((1 << rlog) + 1 + 3) / 4 * 4;
}

// Pass 4.  Block t writes rows [t R, t R + R) of grad, every element once.
template <bool kSq>
__global__ void __launch_bounds__(THREADS)
bwd_reduce(const unsigned* __restrict__ bucket,
           const unsigned* __restrict__ base, const float* __restrict__ g,
           const float* __restrict__ table, const float* __restrict__ gsq,
           float* __restrict__ grad, int V, int D, int rlog, int bbits) {
    constexpr int K = SORT_MAX;
    extern __shared__ __align__(16) unsigned sm[];
    unsigned* sorted = sm;
    unsigned* cur = sm + SORT_WORDS;
    float* cbuf = reinterpret_cast<float*>(cur + run_words(rlog));
    __shared__ unsigned ws[WARPS];
    __shared__ int range[3];
    const int tid = threadIdx.x;
    const int R = 1 << rlog;
    // tiles from the table's end first: the FM's small, dense fields lie
    // there, so its heaviest buckets start first and overlap the rest
    const unsigned tile = gridDim.x - 1 - blockIdx.x;
    const int row0 = tile << rlog;
    const int nrows = min(R, V - row0);
    const int n_el = nrows * D;
    float* out = grad + (long long)row0 * D;
    const unsigned lo = base[tile];
    const unsigned n = base[tile + 1] - lo;
    const unsigned* e = bucket + lo;
    const unsigned bmask = (1u << bbits) - 1;
    if (n == 0) {  // 16-byte stores where the tile starts 16-byte aligned
        const int n4 = ((uintptr_t)out & 15) == 0 ? n_el / 4 : 0;
        for (int q = tid; q < n4; q += THREADS)
            __stcs(reinterpret_cast<float4*>(out) + q,
                   make_float4(0.f, 0.f, 0.f, 0.f));
        for (int i = 4 * n4 + tid; i < n_el; i += THREADS) __stcs(out + i, 0.f);
        return;
    }
    if (n <= (unsigned)SORT_MAX) {
        // row r's entries are sorted[first[r], last[r]) (both 0: none)
        unsigned short* first = reinterpret_cast<unsigned short*>(cur);
        unsigned short* last = first + R;
        for (int i = tid; i < R; i += THREADS) cur[i] = 0;
        SortStorage& tmp = *reinterpret_cast<SortStorage*>(sm);
        if (rlog == 0)  // one row: already in order
            for (int i = tid; i < (int)n; i += THREADS) sorted[i] = e[i];
        else if (n <= THREADS)
            rank_sort(e, n, bbits, sorted, reinterpret_cast<unsigned*>(cbuf));
        else if (n <= 4 * THREADS)
            sort_bucket<4>(e, n, rlog, bbits, sorted, tmp);
        else if (n <= 16 * THREADS)
            sort_bucket<16>(e, n, rlog, bbits, sorted, tmp);
        else
            sort_bucket<32>(e, n, rlog, bbits, sorted, tmp);
        __syncthreads();
        for (int j = tid; j < (int)n; j += THREADS) {
            const unsigned r = sorted[j] >> bbits;
            if (j == 0 || (sorted[j - 1] >> bbits) != r) first[r] = j;
            if (j == (int)n - 1 || (sorted[j + 1] >> bbits) != r) last[r] = j + 1;
        }
        __syncthreads();
        // Runs of rows at a time, as many whole rows as their entries'
        // D-float contributions fill the buffer; a row with more entries
        // than that sums straight from device memory.  Phase 1 gathers the
        // contributions, every (entry, d) apart, GATHER_AHEAD loads a thread
        // in flight; phase 2 sums each element's from shared memory in
        // order, SWEEP_AHEAD elements a thread at once, and stores every
        // element of the rows once.
        const int cap = CBUF / D;  // entries the buffer holds
        const int sr = THREADS / D, sd = THREADS - sr * D;
        int r_lo = 0, j0 = 0;
        while (r_lo < nrows) {
            if (tid == 0) {
                int r_hi = nrows, j1 = n, next = n;
                if (j0 + cap < (int)n) {
                    const int r_at = sorted[j0 + cap] >> bbits;
                    j1 = next = first[r_at];
                    r_hi = r_at;
                    if (j1 == j0) {  // row r_at alone is over the buffer
                        r_hi = r_at + 1;
                        next = last[r_at];
                    }
                }
                range[0] = r_hi;
                range[1] = j1;
                range[2] = next;
            }
            __syncthreads();
            const int r_hi = range[0], j1 = range[1], next = range[2];
            {
                const int total = (j1 - j0) * D;
                int jo = tid / D, d = tid - jo * D;
                for (int i = tid; i < total; i += GATHER_AHEAD * THREADS) {
                    float gv[GATHER_AHEAD], sv[GATHER_AHEAD], tv[GATHER_AHEAD];
                    int ju = jo, du = d;
#pragma unroll
                    for (int u = 0; u < GATHER_AHEAD; ++u) {
                        if (i + u * THREADS < total) {
                            const unsigned k = sorted[j0 + ju];
                            const long long at = (long long)(k & bmask) * D + du;
                            gv[u] = __ldg(g + at);
                            if (kSq) {
                                sv[u] = __ldg(gsq + at);
                                tv[u] = __ldg(table + ((long long)row0 + (k >> bbits)) * D + du);
                            }
                        }
                        ju += sr;
                        du += sd;
                        if (du >= D) { du -= D; ++ju; }
                    }
#pragma unroll
                    for (int u = 0; u < GATHER_AHEAD; ++u)
                        if (i + u * THREADS < total)
                            cbuf[i + u * THREADS] =
                                kSq ? fmaf(2.f * tv[u], sv[u], gv[u]) : gv[u];
                    jo = ju;
                    d = du;
                }
            }
            __syncthreads();
            {
                const int end = r_hi * D;
                int r = r_lo + tid / D, d = tid % D;
                for (int i = r_lo * D + tid; i < end; i += SWEEP_AHEAD * THREADS) {
                    int s0[SWEEP_AHEAD], s1[SWEEP_AHEAD], rr[SWEEP_AHEAD], dd[SWEEP_AHEAD];
                    float v[SWEEP_AHEAD];
#pragma unroll
                    for (int u = 0; u < SWEEP_AHEAD; ++u) {
                        rr[u] = r;
                        dd[u] = d;
                        const bool in = i + u * THREADS < end;
                        s0[u] = in ? first[r] : 0;
                        s1[u] = in ? last[r] : 0;
                        r += sr;
                        d += sd;
                        if (d >= D) { d -= D; ++r; }
                    }
#pragma unroll
                    for (int u = 0; u < SWEEP_AHEAD; ++u) {
                        v[u] = 0.f;
                        if (s0[u] < s1[u] && s1[u] <= j1) {
                            double a = 0.0;
                            for (int j = s0[u]; j < s1[u]; ++j)
                                a = __dadd_rn(a, (double)cbuf[(j - j0) * D + dd[u]]);
                            v[u] = __double2float_rn(a);
                        } else if (s0[u] < s1[u]) {  // a row over the buffer
                            v[u] = __double2float_rn(add_pairs<kSq>(
                                0.0, sorted, s0[u], s1[u], bmask,
                                (long long)row0 + rr[u], dd[u], D, g, table, gsq));
                        }
                    }
#pragma unroll
                    for (int u = 0; u < SWEEP_AHEAD; ++u)
                        if (i + u * THREADS < end) __stcs(out + i + u * THREADS, v[u]);
                }
            }
            __syncthreads();  // before the next rows overwrite the buffer
            r_lo = r_hi;
            j0 = next;
        }
        return;
    }
    // a bucket over K = SORT_MAX: windows of K / 4 elements, chunks of K / 2
    // entries, each chunk sorted by one warp in order (sort_chunk)
    const int KC = K / 2, E = K / 4;
    double* acc = reinterpret_cast<double*>(sorted + KC);
    for (int e0 = 0; e0 < n_el; e0 += E) {
        const int e1 = min(n_el, e0 + E), r0 = e0 / D;
        const int nr = (e1 - 1) / D - r0 + 1;
        for (int i = tid; i < e1 - e0; i += THREADS) acc[i] = 0.0;
        for (unsigned c0 = 0; c0 < n; c0 += KC) {
            sort_chunk(e + c0, (int)min((unsigned)KC, n - c0), r0, nr, bbits,
                       sorted, cur, ws);
            for (int i = tid; i < e1 - e0; i += THREADS) {
                const int r = (e0 + i) / D, d = e0 + i - r * D, k = r - r0;
                const unsigned s = k ? cur[k - 1] : 0, end = cur[k];
                if (s < end)
                    acc[i] = add_pairs<kSq>(acc[i], sorted, s, end, bmask,
                                            (long long)row0 + r, d, D, g,
                                            table, gsq);
            }
            __syncthreads();  // before the next chunk's sort
        }
        for (int i = tid; i < e1 - e0; i += THREADS)
            __stcs(out + e0 + i, __double2float_rn(acc[i]));
    }
}

// Dynamic shared memory of a launch: with the kernel's static words (1 KB
// at most here) above 48 KB only with the attribute set.
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, size_t bytes) {
    if (bytes + 1024 <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace bwd

// The wrapper's plan: vec (1, 2 or 4; D % vec == 0 and the table 4 vec-byte
// aligned), NB bags per block of `threads` threads, FC fields per staged
// chunk at stride FS (odd, >= FC), NB FS words (twice that weighted) under
// 48 KB.  B * D must be below 2^31; w null = unweighted.
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* w, void* out, int B, int F,
                                    int D, int vec, int NB, int threads,
                                    int FC, int FS, void* stream) {
    if ((long long)B * D == 0) return 0;
    const float* t = (const float*)table;
    const int* i = (const int*)idx;
    const float* wt = (const float*)w;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (vec) {
        case 1: launch<1>(t, i, wt, o, B, F, D, NB, threads, FC, FS, s); break;
        case 2: launch<2>(t, i, wt, o, B, F, D, NB, threads, FC, FS, s); break;
        case 4: launch<4>(t, i, wt, o, B, F, D, NB, threads, FC, FS, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* embedding_bag_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// grad (f32[V, D]) = the gradient of the unweighted bag whose output
// gradient is grad_out (f32[B, D]) over idx (int32[B, F]), plus the squared
// term when table (f32[V, D]) and grad_sq (f32[B, D]) are given; five
// launches on `stream`.  Scratch from the wrapper: key (B F int32), bucket
// (B F words), cnt (C T words), tot (T words), base (T + 1 words), ticket
// (1 word), where T = ceil(V / 2^rlog).  Plan (the wrapper's
// `backward_plan`): tiles of 2^rlog rows, rlog + bbits <= 32,
// B <= 2^bbits; C = ceil(B F / CHUNK) chunks (at least 1); the count
// kernel takes tiles in ranges of ts_count.  F <= 65,535 * 32, T < 2^20.
extern "C" int embedding_bag_backward_launch(
    const void* grad_out, const void* idx, const void* table,
    const void* grad_sq, void* grad, void* key, void* bucket, void* cnt,
    void* tot, void* base, void* ticket, int B, int F, int D, int V,
    int rlog, int bbits, int C, int ts_count, void* stream) {
    using namespace bwd;
    if ((long long)V * D == 0) return 0;
    const int N = B * F;
    const int T = (int)(((long long)V + (1LL << rlog) - 1) >> rlog);
    int tbits = 1;
    while ((1LL << tbits) <= T) ++tbits;  // 2^tbits - 1 >= T: "no tile"
    if (tbits + OFF_BITS > 32) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int* k = (int*)key;
    unsigned* cn = (unsigned*)cnt;
    unsigned* bs = (unsigned*)base;
    unsigned* tk = (unsigned*)ticket;
    unsigned* bk = (unsigned*)bucket;
    const size_t smem_count = (size_t)ts_count * sizeof(unsigned);
    const size_t smem_reduce =
        ((size_t)SORT_WORDS + run_words(rlog) + CBUF) * sizeof(unsigned);
    cudaError_t err;
    if (N > 0) {
        bwd_transpose<<<dim3((B + 31) / 32, (F + 31) / 32), THREADS, 0, s>>>(
            (const int*)idx, k, B, F);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if ((err = smem_limit(bwd_count, smem_count)) != cudaSuccess) return (int)err;
    bwd_count<<<C, THREADS, smem_count, s>>>(k, cn, tk, N, V, rlog, T, ts_count);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_colscan<<<(T + 31) / 32, THREADS, 0, s>>>(cn, (unsigned*)tot, bs, tk,
                                                  C, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_scatter<<<C, THREADS, 0, s>>>(k, cn, bs, bk, B, N, V, rlog, T, tbits,
                                      bbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const float* g = (const float*)grad_out;
    const float* t = (const float*)table;
    const float* gs = (const float*)grad_sq;
    float* o = (float*)grad;
    if (table != nullptr) {
        if ((err = smem_limit(bwd_reduce<true>, smem_reduce)) != cudaSuccess) return (int)err;
        bwd_reduce<true><<<T, THREADS, smem_reduce, s>>>(bk, bs, g, t, gs, o, V,
                                                         D, rlog, bbits);
    } else {
        if ((err = smem_limit(bwd_reduce<false>, smem_reduce)) != cudaSuccess) return (int)err;
        bwd_reduce<false><<<T, THREADS, smem_reduce, s>>>(bk, bs, g, nullptr,
                                                          nullptr, o, V, D,
                                                          rlog, bbits);
    }
    return (int)cudaGetLastError();
}
