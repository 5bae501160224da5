// sketch_addr.cuh: the sketches' cell addressing on the card, shared by
// matrix_ingest.cu and matrix_lookup.cu.
//
// Each function is bit-equal to its host counterpart in the port:
//   mix        common/hashing.py `mix` (and `np_hash_into` before fastrange)
//   fastrange  common/hashing.py `fastrange`: (h * w) >> 32, exact
//   route      core/routing.py `RouteTable.lookup`
// Vertex ids enter as their uint32 two's-complement value, as `_as_u32`
// maps them; the hash parameters a and b are the sketch's int64 tensors
// holding uint32 values, read as they are.
#pragma once

#include <cstdint>

namespace sketch {

// One function of the multiply-shift family and its xorshift-multiply
// round, in uint32 arithmetic that wraps as the host's masks do.
__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b, uint32_t x) {
    uint32_t h = a * x + b;
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    return h;
}

// Map a uniform uint32 into [0, w): the high word of the 64-bit product.
// For w = 2^k it equals h >> (32 - k) (0 when k = 0).
__device__ __forceinline__ uint32_t fastrange(uint32_t h, uint32_t w) {
    return __umulhi(h, w);
}

// Partition of vertex v: a left binary search over the n_keys sorted keys
// with a signed compare (torch.searchsorted on int32), part[pos] where the
// key is found, else the outlier partition (also when n_keys == 0).
__device__ __forceinline__ int route(const int* __restrict__ keys,
                                     const int* __restrict__ part,
                                     int n_keys, int outlier, int v) {
    int lo = 0, hi = n_keys;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(keys + mid) < v) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return (lo < n_keys && __ldg(keys + lo) == v) ? __ldg(part + lo) : outlier;
}

}  // namespace sketch
