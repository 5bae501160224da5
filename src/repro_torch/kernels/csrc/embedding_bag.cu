// embedding_bag: fixed-arity embedding bag, a row gather and a sum per bag.
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
