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
// PyTorch version and the Pallas kernel agree bit for bit.
//
// Bound on this card: bytes.  A bag reads its F indices (and weights)
// once, F gathered rows of D floats, and writes D floats; there are no
// operations to speak of (one add per element read).  The gathered rows
// are what matters: at the FM's serving shapes (D = 10, rows scattered
// over a 400 MB table) a 40-byte row spans two or three 32-byte sectors,
// so the card moves 64-96 bytes for each 40 useful ones; PERF.md states
// both counts.  Design: one thread per output element (b, d), threads of a
// warp on neighbouring elements of the flat [B, D] output, so a row's D
// floats are read by neighbouring threads (one or two requests per row)
// and the output is written coalesced.  Each thread loads its own idx[b, f]
// (the threads of one bag load the same word, a broadcast): a block loads
// its own indices, nothing is prefetched.  The loop over f takes the
// place of the TPU's sequential field axis, so the sum lives in a
// register and no accumulator lives in memory.  Row offsets are 64-bit
// (V * D may pass 2^31); the flat output index fits 32 bits, since the
// wrapper checks B * D < 2^31.
#include <cuda_runtime.h>

namespace {

template <bool kWeighted>
__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out,
                                     int B, int F, int D) {
    const long long tt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tt >= (long long)B * D) return;
    const int t = (int)tt;
    const int b = t / D;
    const int d = t - b * D;
    const int* bag = idx + (long long)b * F;
    const float* bag_w = kWeighted ? w + (long long)b * F : nullptr;
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) {
        const long long row = __ldg(bag + f);
        const float x = __ldg(table + row * D + d);
        if (kWeighted) {
            acc = fmaf(x, __ldg(bag_w + f), acc);
        } else {
            acc = __fadd_rn(acc, x);  // one rounding, never contracted
        }
    }
    out[t] = acc;
}

}  // namespace

// B * D must be below 2^31 (the wrapper checks it); w null = unweighted.
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* w, void* out, int B, int F,
                                    int D, void* stream) {
    const long long n = (long long)B * D;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (w != nullptr) {
        embedding_bag_kernel<true><<<blocks, threads, 0, s>>>(
            (const float*)table, (const int*)idx, (const float*)w,
            (float*)out, B, F, D);
    } else {
        embedding_bag_kernel<false><<<blocks, threads, 0, s>>>(
            (const float*)table, (const int*)idx, nullptr, (float*)out, B,
            F, D);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* embedding_bag_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
