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

// ---------------------------------------------------------------- backward --
//
// embedding_bag_backward: the gradient of the unweighted bag with respect
// to its table, for training the FM.  No TPU kernel has it: the Pallas
// `embedding_bag` has no custom_vjp, and the JAX package trains through the
// plain gather `params["emb"][rows]`, whose transpose XLA emits as a
// scatter-add.  This kernel is that scatter-add, with the FM's squared
// table folded in:
//
//     grad[idx[b, f], d] += grad_out[b, d]
//                           (+ 2 table[idx[b, f], d] grad_sq[b, d])
//
// grad_out f32[B, D], idx int32[B, F] in [0, V), table f32[V, D] and
// grad_sq f32[B, D] both given or both null, grad f32[V, D] zeroed by the
// wrapper.  With the squared term, one pass over the B F gathered rows
// gives the whole gradient of a table read by a Σv bag and a Σv² bag (the
// bag of table * table): d(Σv²)/dv = 2 v.  The [B, F, D] rows are never
// formed.
//
// Order of addition: float atomicAdd (its result unused, so the compiler
// emits red.global.add.f32), in no fixed order.  Each contribution is
// rounded once, fmaf(2 t, g_sq, g) (2 t is exact), so it is bit-equal to
// the plain version's; only the order of the sum over the (b, f) that hit
// one row differs, and the plain version sums in float64 and rounds once.
// A row hit k times differs from it by at most about k float32 roundings
// of the running sum; the tests and chip_smoke.py state the tolerance.
//
// Bound on this card: bytes.  It reads idx, grad_out (and grad_sq, and
// the gathered table rows) and writes the dense gradient, whose zeroing by
// the wrapper is most of the bytes at the FM's shapes (400 MB for a
// 10,000,384 x 10 table, against about 60 MB read).  Contention is low: at
// B = 65,536 the smallest field holds 38,573 rows, so a row takes a few
// atomics at most.  Design: one thread per (b, f) pair and V neighbouring
// elements of its row (V = 4, 2 or 1, as the forward chooses), a
// grid-stride loop; the DV threads of one pair are neighbours, so their
// idx, grad_out and table loads coalesce.
template <int V, bool kSq>
__global__ void embedding_bag_backward_kernel(
    const float* __restrict__ g, const int* __restrict__ idx,
    const float* __restrict__ table, const float* __restrict__ gsq,
    float* __restrict__ grad, int B, int F, int D) {
    using T = typename Vec<V>::T;
    const int DV = D / V;
    const long long n = (long long)B * F * DV;
    const T* gv = reinterpret_cast<const T*>(g);
    const T* sv = reinterpret_cast<const T*>(gsq);
    const T* rows = reinterpret_cast<const T*>(table);
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x) {
        const long long pair = e / DV;
        const int dv = (int)(e - pair * DV);
        const long long b = pair / F;
        const long long row = __ldg(idx + pair);
        T c = __ldg(gv + b * DV + dv);
        if (kSq) {
            const T t = __ldcg(rows + row * DV + dv);
            const T s = __ldg(sv + b * DV + dv);
            const float* tf = reinterpret_cast<const float*>(&t);
            const float* sf = reinterpret_cast<const float*>(&s);
            float* cf = reinterpret_cast<float*>(&c);
#pragma unroll
            for (int i = 0; i < V; ++i) cf[i] = fmaf(2.f * tf[i], sf[i], cf[i]);
        }
        const float* cf = reinterpret_cast<const float*>(&c);
        float* dst = grad + row * D + (long long)dv * V;
#pragma unroll
        for (int i = 0; i < V; ++i) atomicAdd(dst + i, cf[i]);
    }
}

template <int V>
void launch_backward(const float* g, const int* idx, const float* table,
                     const float* gsq, float* grad, int B, int F, int D,
                     int blocks, int threads, cudaStream_t s) {
    if (table != nullptr) {
        embedding_bag_backward_kernel<V, true><<<blocks, threads, 0, s>>>(
            g, idx, table, gsq, grad, B, F, D);
    } else {
        embedding_bag_backward_kernel<V, false><<<blocks, threads, 0, s>>>(
            g, idx, nullptr, nullptr, grad, B, F, D);
    }
}

}  // namespace

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

// grad (f32[V, D], zeroed) += the scatter of grad_out (f32[B, D]) over idx
// (int32[B, F]), plus 2 table[row] grad_sq[b] when table (f32[V, D]) and
// grad_sq (f32[B, D]) are given.  vec: 1, 2 or 4, dividing D, every
// pointer 4 vec-byte aligned (the wrapper decides).
extern "C" int embedding_bag_backward_launch(const void* grad_out,
                                             const void* idx,
                                             const void* table,
                                             const void* grad_sq, void* grad,
                                             int B, int F, int D, int vec,
                                             int blocks, int threads,
                                             void* stream) {
    if ((long long)B * F * D == 0) return 0;
    const float* g = (const float*)grad_out;
    const int* i = (const int*)idx;
    const float* t = (const float*)table;
    const float* s = (const float*)grad_sq;
    float* o = (float*)grad;
    cudaStream_t st = (cudaStream_t)stream;
    switch (vec) {
        case 1: launch_backward<1>(g, i, t, s, o, B, F, D, blocks, threads, st); break;
        case 2: launch_backward<2>(g, i, t, s, o, B, F, D, blocks, threads, st); break;
        case 4: launch_backward<4>(g, i, t, s, o, B, F, D, blocks, threads, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
