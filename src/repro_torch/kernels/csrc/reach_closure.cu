// reach_step: one boolean-closure squaring R <- min(R @ R, 1) for every
// layer of a batch of f32[w, w] matrices, in one launch.
//
// Replaces: src/repro/kernels/reach_closure.py, `reach_step` (Pallas body
// `_closure_step_kernel`), which squares one layer per call and is vmapped
// over the d layers by ops.accel_reach_closure; here blockIdx.z is the
// layer.  The TPU kernel needs w to be a multiple of its block, so the JAX
// package pads; this kernel masks the ragged edge instead (padded rows and
// columns of the TPU version carry only their own diagonal, so its cropped
// closure equals this one).
//
// Bound on this card: operations for large w (2 w^3 flops per layer against
// 8 w^2 bytes), launch latency for the main path's w = 43.  Design: a
// classic shared-memory tiled product, 64 x 64 output tile per block of 256
// threads, 4 x 4 outputs per thread, K in steps of 16, an f32 FMA
// accumulator and the clamp fused into the epilogue.  Inputs are 0/1 and
// every partial sum is an integer below 2^24, so the f32 accumulation is
// exact in any order and the result equals clamp(bmm(R, R), max=1) bit for
// bit.  Tensor cores (exact on 0/1 in bf16 or TF32) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
reach_step_kernel(const float* __restrict__ reach, float* __restrict__ out,
                  int w) {
    const size_t layer = (size_t)blockIdx.z * w * w;
    const float* A = reach + layer;
    float* O = out + layer;
    __shared__ float As[BK][BM + 4];  // As[k][m] = A[row0 + m][k0 + k]
    __shared__ float Bs[BK][BN + 4];  // Bs[k][n] = A[k0 + k][col0 + n]
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < w; k0 += BK) {
        for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
            const int m = e / BK, k = e % BK;
            const int gr = row0 + m, gk = k0 + k;
            As[k][m] = (gr < w && gk < w) ? A[(size_t)gr * w + gk] : 0.f;
        }
        for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
            const int k = e / BN, n = e % BN;
            const int gk = k0 + k, gc = col0 + n;
            Bs[k][n] = (gk < w && gc < w) ? A[(size_t)gk * w + gc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty + 16 * i;
        if (r >= w) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = col0 + tx + 16 * j;
            if (c < w) O[(size_t)r * w + c] = fminf(acc[i][j], 1.f);
        }
    }
}

}  // namespace

extern "C" int reach_step_launch(const void* reach, void* out, int d, int w,
                                 void* stream) {
    if (d == 0 || w == 0) return 0;
    const dim3 grid((w + BN - 1) / BN, (w + BM - 1) / BM, d);
    reach_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)reach, (float*)out, w);
    return (int)cudaGetLastError();
}

extern "C" const char* reach_step_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
