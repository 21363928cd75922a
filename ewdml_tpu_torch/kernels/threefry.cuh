// The threefry2x32 block cipher of jax.random (jax._src.prng.threefry2x32_p,
// 20 rounds), shared by the kernels that draw the JAX package's random
// bits: precision.cu (the seeded bf16 store) and random.cu
// (jax.random.bits and uniform).
//
// uint32 arithmetic wraps as the cipher's does; the rotations are funnel
// shifts. A key is the two words (k0, k1) of jax.random.key_data; in device
// memory it is packed as one uint64, k0 << 32 | k1 (utils/prng.packed_key).

#pragma once

#include <stdint.h>

namespace ewdml {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32(k0, k1, x0, x1): both output words.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define EWDML_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r) ^ x0;
#define EWDML_ROUNDS_A \
  EWDML_ROUND(13) EWDML_ROUND(15) EWDML_ROUND(26) EWDML_ROUND(6)
#define EWDML_ROUNDS_B \
  EWDML_ROUND(17) EWDML_ROUND(29) EWDML_ROUND(16) EWDML_ROUND(24)
  EWDML_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  EWDML_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  EWDML_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  EWDML_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  EWDML_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef EWDML_ROUNDS_B
#undef EWDML_ROUNDS_A
#undef EWDML_ROUND
  return make_uint2(x0, x1);
}

// y0 ^ y1 of threefry2x32(k0, k1, x0, x1): element i of jax.random.bits
// under the partitionable layout is threefry_bits(k0, k1, i >> 32, i).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint2 y = threefry2x32(k0, k1, x0, x1);
  return y.x ^ y.y;
}

// jax.random.fold_in(key, data): threefry of the counter pair (0, data).
__device__ __forceinline__ uint2 fold_in(uint2 k, uint32_t data) {
  return threefry2x32(k.x, k.y, 0u, data);
}

// The packed key: read from device memory where `ptr` is given (a key-table
// slot, so a captured launch reads each replay's key), else `value`.
__device__ __forceinline__ uint2 load_key(const unsigned long long* ptr,
                                          unsigned long long value) {
  const unsigned long long kw = ptr ? __ldg(ptr) : value;
  return make_uint2((uint32_t)(kw >> 32), (uint32_t)kw);
}

}  // namespace ewdml
