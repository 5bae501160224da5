// matrix_ingest: batched sketch ingest as an int32 atomic scatter-add.
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

extern "C" const char* matrix_ingest_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
