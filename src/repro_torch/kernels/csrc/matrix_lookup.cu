// matrix_lookup: batched sketch point queries, a gather and a min over layers.
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

extern "C" const char* matrix_lookup_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
