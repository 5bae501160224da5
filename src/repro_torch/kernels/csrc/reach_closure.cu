// Boolean transitive closure on tensor cores: two entry points.
//
//   reach_step     one squaring R <- min(R @ R, 1) of every layer of a batch
//                  of f32[w, w] 0/1 matrices, in one launch (any w).
//   reach_closure  the whole closure of every layer of int32[d, w, w]
//                  counters -> bool[d, w, w], in one launch: adj + I, then
//                  up to n_steps squarings with the layer in shared memory
//                  (w up to the wrapper's limit).
//
// Replaces: src/repro/kernels/reach_closure.py, `reach_step` (Pallas body
// `_closure_step_kernel`), which squares one layer per call, vmapped over
// the d layers and called once per squaring by ops.accel_reach_closure.
// The TPU kernel needs w to be a multiple of its block, so the JAX package
// pads; these kernels mask the ragged edge instead (padded rows and columns
// of the TPU version carry only their own diagonal, so its cropped closure
// equals this one).
//
// Exactness.  Inputs are 0 or 1, which bf16 holds exactly, so converting
// them as they are staged loses nothing.  Every product is 0 or 1 and every
// partial sum an integer no larger than w < 2^24, which the f32 accumulator
// of mma.sync holds exactly in any order of summation.  So the clamped
// result equals clamp(bmm(R, R), max=1) bit for bit.  The 0/1 input is the
// wrapper's precondition (checked on the CPU only).
//
// Bound on this card: operations for large w (2 w^3 per layer and squaring
// against 8 w^2 bytes), launch latency at the main path's w = 43 and 136.
// Design: mma.sync m16n8k16 bf16 -> f32 with ldmatrix fragments.  A layer
// here is a few KB to a few MB, so tiles are small and the operands sit in
// shared memory or L2; wgmma and TMA pay off for 64-row warpgroup tiles fed
// from device memory, which these widths do not need.  B (= R) must be
// column-major for the tensor core: ldmatrix.trans reads it from the same
// row-major tile, so one staged copy serves both operands.  Shared-memory
// rows are padded by 16 bytes, an odd number of 16-byte chunks, so the eight
// row addresses of each ldmatrix phase fall in distinct banks.
//
// reach_step tiles: 128 x 128 outputs per block of 8 warps where that
// gives every SM a block (448 blocks at [7,1024,1024]; registers capped for
// two blocks an SM, which measured faster there on an H100), else 32 x
// 32 per block of 4 warps (175 blocks at [7,136,136], 567 at [7,273,273];
// a 64 x 64 tile measured slower at both); K in steps of 32 for the large
// tile and 64 for the small one (fewer dependent loads where w is small),
// the next K tile loaded into registers while the current one is
// multiplied, two shared buffers, one barrier per K tile.
//
// reach_closure: one block of 32 warps per layer.  The layer lives in
// shared memory as bf16 in two copies (ping-pong), padded to W = 16 ceil(w
// / 16) rows of S = W + 8 columns: 2 W S 2 bytes (87,552 at w = 136), so w
// <= 224 within the 227 KB a block may have.  The block builds adj + I from
// the counters in quads of four columns a thread, int4 loads where w % 4
// == 0, eight quads in flight a thread: one element a thread leaves this
// phase, on the few SMs the layers occupy, instruction- and latency-bound
// and dearer than a squaring.
// A warp's task in a squaring is a 16 x 48 piece of the output (16 x 16
// where the layer has fewer than six 16-row strips): six independent mma
// chains per K step sharing one A fragment, the K step's fragments loaded
// before its mma.  Each squaring reads one copy and writes the other; a
// block-wide vote (__syncthreads_or) after it both orders the copies and
// stops the loop once a squaring changed nothing: a closed matrix is a
// fixed point of the squaring, so the result is the same as after n_steps
// squarings.  Padding rows and columns stay zero.  An s8 m16n8k32 version
// halves the mma count and the fragment bytes, but ldmatrix cannot
// transpose bytes, so it keeps the transpose beside each copy; on the
// path's closures (one or two squarings) its longer set-up outweighed
// that on an H100, and it won only at eight squarings.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Register i holds this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

// c (16 x 8, f32) += a (16 x 16, row-major) * b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets of an x4 ldmatrix over a 16 x 16 tile: matrices 0..3 are
// (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).  As A
// (row-major) that is the m16n8k16 A fragment a0..a7; as B through .trans it
// is the B fragments (b0 b1, b2 b3) of the left and then the right n8 tile.
__device__ __forceinline__ int frag_row(int lane) {
    return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane) { return (lane >> 4) * 8; }

__device__ __forceinline__ uint32_t pack_clamped(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(fminf(lo, 1.f), fminf(hi, 1.f));
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- reach_step

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
reach_step_kernel(const float* __restrict__ reach, float* __restrict__ out,
                  int w) {
    constexpr int THREADS = WARPS_M * WARPS_N * 32;
    constexpr int AS = BK + 8;  // A tile [BM][AS]: A[row0 + m][k0 + k]
    constexpr int BS = BN + 8;  // B tile [BK][BS]: A[k0 + k][col0 + n]
    constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
    constexpr int MI = WTM / 16, NJ = WTN / 16;  // 16 x 16 pieces per warp
    constexpr int A_QUADS = BM * BK / 4 / THREADS;
    constexpr int B_QUADS = BK * BN / 4 / THREADS;
    static_assert(MI >= 1 && NJ >= 1 && A_QUADS >= 1 && B_QUADS >= 1, "tile");
    __shared__ __align__(16) bf16 As[2][BM * AS];
    __shared__ __align__(16) bf16 Bs[2][BK * BS];

    const size_t layer = (size_t)blockIdx.z * w * w;
    const float* A = reach + layer;
    float* O = out + layer;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
    const int lr = frag_row(lane), lc = frag_col(lane);

    // Staging: each thread moves quads of neighbouring elements, so a warp
    // reads whole 128-byte rows, one float4 each where w % 4 == 0 (a quad
    // then lies wholly inside or outside the layer, and is 16-byte
    // aligned); the quad is converted and stored as two bf16x2.  Elements
    // outside the layer are zero (the ragged edge).
    const bool vec4 = (w & 3) == 0;
    float4 ra[A_QUADS], rb[B_QUADS];
    auto quad = [&](int r, int c) {
        if (vec4)
            return (r < w && c < w)
                       ? __ldg(reinterpret_cast<const float4*>(A + (size_t)r * w + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        const float* p = A + (size_t)r * w + c;
        const bool in = r < w;
        return make_float4(in && c < w ? __ldg(p) : 0.f,
                           in && c + 1 < w ? __ldg(p + 1) : 0.f,
                           in && c + 2 < w ? __ldg(p + 2) : 0.f,
                           in && c + 3 < w ? __ldg(p + 3) : 0.f);
    };
    auto load = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_QUADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int m = e / (BK / 4), k = (e % (BK / 4)) * 4;
            ra[i] = quad(row0 + m, k0 + k);
        }
#pragma unroll
        for (int i = 0; i < B_QUADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int k = e / (BN / 4), n = (e % (BN / 4)) * 4;
            rb[i] = quad(k0 + k, col0 + n);
        }
    };
    auto put = [](bf16* dst, float4 v) {
        reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(v.x, v.y);
        reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(v.z, v.w);
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int i = 0; i < A_QUADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int m = e / (BK / 4), k = (e % (BK / 4)) * 4;
            put(&As[buf][m * AS + k], ra[i]);
        }
#pragma unroll
        for (int i = 0; i < B_QUADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int k = e / (BN / 4), n = (e % (BN / 4)) * 4;
            put(&Bs[buf][k * BS + n], rb[i]);
        }
    };

    float acc[MI][2 * NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    const int nk = (w + BK - 1) / BK;
    load(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the mma
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[MI][4], b[NJ][4];
#pragma unroll
            for (int i = 0; i < MI; ++i)
                ldmatrix_x4(a[i], &As[buf][(wm + i * 16 + lr) * AS + kk + lc]);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                ldmatrix_x4_trans(b[j], &Bs[buf][(kk + lr) * BS + wn + j * 16 + lc]);
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
                    mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
                }
        }
        if (kt + 1 < nk) store(buf ^ 1);
        __syncthreads();
    }

    // epilogue: c0 c1 at (g, 2 t4 + {0, 1}), c2 c3 eight rows below
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row0 + wm + i * 16 + g + 8 * h;
                const int c = col0 + wn + j * 8 + 2 * t4;
                if (r >= w) continue;
                if (c < w) O[(size_t)r * w + c] = fminf(acc[i][j][2 * h], 1.f);
                if (c + 1 < w)
                    O[(size_t)r * w + c + 1] = fminf(acc[i][j][2 * h + 1], 1.f);
            }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
void launch_step(const float* reach, float* out, int d, int w,
                 cudaStream_t stream) {
    const dim3 grid((w + BN - 1) / BN, (w + BM - 1) / BM, d);
    reach_step_kernel<BM, BN, BK, WARPS_M, WARPS_N, MIN_BLOCKS>
        <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(reach, out, w);
}

// ------------------------------------------------------------- reach_closure

constexpr int CLOSURE_THREADS = 1024;
constexpr int CHUNK = 3;  // 16 x 16 pieces per warp task: 16 x 48 outputs
constexpr int LOADS = 8;  // quads a thread loads before it stores

__global__ void __launch_bounds__(CLOSURE_THREADS)
reach_closure_kernel(const int* __restrict__ table,
                     unsigned char* __restrict__ out, int w, int n_steps) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int W = (w + 15) / 16 * 16, S = W + 8;
    bf16* const base = reinterpret_cast<bf16*>(smem);  // copies at 0, W S
    const size_t layer = (size_t)blockIdx.x * w * w;
    const int* T = table + layer;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    // adj + I from the counters, zero padding.  Each thread takes quads of
    // four neighbouring columns, neighbouring threads neighbouring quads,
    // so reads are coalesced (one int4 load where w % 4 == 0 and the table
    // is 16-byte aligned) and few instructions move each element; a thread
    // issues the reads of up to LOADS quads before it stores any, so they
    // are in flight together.
    const bool vec4 = (w & 3) == 0 && ((uintptr_t)table & 15) == 0;
    const int qw = W / 4, n_quads = W * qw;
    for (int e0 = threadIdx.x; e0 < n_quads; e0 += LOADS * blockDim.x) {
        int4 v[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int e = e0 + u * blockDim.x, i = e / qw, j = (e - i * qw) * 4;
            const int* p = T + (size_t)i * w + j;
            const bool row = e < n_quads && i < w;
            if (vec4) {
                v[u] = row && j < w ? __ldg(reinterpret_cast<const int4*>(p))
                                    : make_int4(0, 0, 0, 0);
            } else {
                v[u] = make_int4(row && j < w ? __ldg(p) : 0,
                                 row && j + 1 < w ? __ldg(p + 1) : 0,
                                 row && j + 2 < w ? __ldg(p + 2) : 0,
                                 row && j + 3 < w ? __ldg(p + 3) : 0);
            }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int e = e0 + u * blockDim.x, i = e / qw, j = (e - i * qw) * 4;
            if (e >= n_quads) break;
            // the diagonal is set; padding (i or j >= w) was loaded as 0
            auto bit = [&](int x, int jj) {
                return (x > 0 || (i == jj && i < w)) ? 1.f : 0.f;
            };
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(base + i * S + j);
            dst[0] = __floats2bfloat162_rn(bit(v[u].x, j), bit(v[u].y, j + 1));
            dst[1] = __floats2bfloat162_rn(bit(v[u].z, j + 2), bit(v[u].w, j + 3));
        }
    }
    __syncthreads();

    const int lr = frag_row(lane), lc = frag_col(lane);
    const int g = lane >> 2, t4 = lane & 3;
    // a warp's task: a 16-row strip times `chunk` 16-column pieces; three
    // where the layer is wide enough to keep every warp busy with them
    const int strips = W / 16;
    const int chunk = strips >= 6 ? CHUNK : 1;
    const int chunks = (strips + chunk - 1) / chunk;
    int cur = 0;
    for (int s = 0; s < n_steps; ++s) {
        const bf16* R = base + cur * W * S;
        bf16* N = base + (cur ^ 1) * W * S;
        int changed = 0;
        for (int t = warp; t < strips * chunks; t += nwarps) {
            const int m0 = (t / chunks) * 16, n0 = (t % chunks) * 16 * chunk;
            const int pieces = min(chunk, (W - n0) / 16);  // warp-uniform
            float c[CHUNK][2][4];
#pragma unroll
            for (int p = 0; p < CHUNK; ++p)
#pragma unroll
                for (int r = 0; r < 4; ++r) c[p][0][r] = c[p][1][r] = 0.f;
            for (int k0 = 0; k0 < W; k0 += 16) {
                // every fragment of the K step first, then the mma chains
                uint32_t a[4], b[CHUNK][4];
                ldmatrix_x4(a, R + (m0 + lr) * S + k0 + lc);
#pragma unroll
                for (int p = 0; p < CHUNK; ++p)
                    if (p < pieces)
                        ldmatrix_x4_trans(b[p], R + (k0 + lr) * S + n0 + 16 * p + lc);
#pragma unroll
                for (int p = 0; p < CHUNK; ++p)
                    if (p < pieces) {
                        mma_bf16(c[p][0], a, b[p][0], b[p][1]);
                        mma_bf16(c[p][1], a, b[p][2], b[p][3]);
                    }
            }
#pragma unroll
            for (int p = 0; p < CHUNK; ++p) {
                if (p >= pieces) break;
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int at = (m0 + g + 8 * h) * S + n0 + 16 * p + 8 * j
                                       + 2 * t4;
                        const uint32_t v =
                            pack_clamped(c[p][j][2 * h], c[p][j][2 * h + 1]);
                        changed |= v != *reinterpret_cast<const uint32_t*>(R + at);
                        *reinterpret_cast<uint32_t*>(N + at) = v;
                    }
            }
        }
        cur ^= 1;
        // barrier for the ping-pong and the block-wide vote in one
        if (!__syncthreads_or(changed)) break;
    }

    // the closure as bytes: four columns a lane, one 4-byte store where
    // w % 4 == 0
    const bool ovec4 = (w & 3) == 0 && ((uintptr_t)out & 3) == 0;
    const bf16* R = base + cur * W * S;
    unsigned char* O = out + layer;
    const int oq = (w + 3) / 4;
    for (int e = threadIdx.x; e < w * oq; e += blockDim.x) {
        const int i = e / oq, j = (e - i * oq) * 4;
        const uint2 raw = *reinterpret_cast<const uint2*>(R + i * S + j);
        // bf16 1.0 is 0x3f80, 0.0 is 0: a nonzero half is a set bit
        const unsigned char b0 = (raw.x & 0xffffu) != 0, b1 = (raw.x >> 16) != 0,
                            b2 = (raw.y & 0xffffu) != 0, b3 = (raw.y >> 16) != 0;
        unsigned char* o = O + (size_t)i * w + j;
        if (ovec4) {
            *reinterpret_cast<uchar4*>(o) = make_uchar4(b0, b1, b2, b3);
        } else {
            o[0] = b0;
            if (j + 1 < w) o[1] = b1;
            if (j + 2 < w) o[2] = b2;
            if (j + 3 < w) o[3] = b3;
        }
    }
}

}  // namespace

// tile: 32 or 128 (the wrapper's choice from d and w); d <= 65535.
extern "C" int reach_step_launch(const void* reach, void* out, int d, int w,
                                 int tile, void* stream) {
    if (d == 0 || w == 0) return 0;
    const float* r = (const float*)reach;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (tile) {
        case 32: launch_step<32, 32, 64, 2, 2, 1>(r, o, d, w, s); break;
        case 128: launch_step<128, 128, 32, 2, 4, 2>(r, o, d, w, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// out: bool[d, w, w] (one byte each); the wrapper checks that 2 W S 2 bytes
// fit the 232,448 a block may have.
extern "C" int reach_closure_launch(const void* table, void* out, int d, int w,
                                    int n_steps, void* stream) {
    if (d == 0 || w == 0) return 0;
    const int W = (w + 15) / 16 * 16, S = W + 8;
    const int smem = 2 * W * S * (int)sizeof(bf16);
    if (smem > 48 * 1024) {  // above 48 KB only with the attribute set
        const cudaError_t err = cudaFuncSetAttribute(
            reach_closure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
    }
    reach_closure_kernel<<<d, CLOSURE_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)table, (unsigned char*)out, w, n_steps);
    return (int)cudaGetLastError();
}

extern "C" const char* reach_step_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* reach_closure_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
