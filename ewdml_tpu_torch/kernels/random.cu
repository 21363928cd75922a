// Hopper (sm_90a) kernel of the port's jax.random draws.
//
// Element i of jax.random.bits(key, (n,), uint32) under the partitionable
// threefry layout: y0 ^ y1 of threefry2x32(k0, k1, i >> 32, i & 0xFFFFFFFF)
// (utils/prng.random_bits, and the XLA code of ewdml_tpu/ops/qsgd.py:122,230
// and ewdml_tpu/data/device_feed.py:100-102: QSGD's threefry stream below
// the kernels' size gate, the shared-scale encodes of the async server,
// the device feed's epoch permutation, crops and flips). Two outputs: the
// bits as int64 holding uint32 values (what permutation, randint and
// bernoulli take), or jax.random.uniform's f32 in [0, 1),
// ((bits >> 9) | 0x3F800000) as a float minus 1 (exact). Held bit for bit
// against the plain PyTorch version (ops/kernels.random_bits_ref).
//
// The key (k0 << 32 | k1) is read from device memory where a pointer is
// given (a key-table slot: a captured launch draws each replay's bits),
// else passed by value. What bounds it: the 20 threefry rounds, 68
// integer operations an element (70 for a uniform) against 8 (int64) or 4
// (f32) bytes written, so the instruction issue at the path's sizes, where
// a launch's floor is most of the time anyway. A thread takes 4 consecutive elements
// and writes them with 16-byte stores.
//
// Plain C interface, as compress.cu: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPer = 4;  // consecutive elements a thread takes

template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
    random_bits_kernel(const unsigned long long* __restrict__ key,
                       unsigned long long key_value, uint32_t n,
                       void* __restrict__ out) {
  const uint2 k = ewdml::load_key(key, key_value);
  const unsigned long long stride =
      (unsigned long long)gridDim.x * kThreads * kPer;
  for (unsigned long long i0 =
           ((unsigned long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
       i0 < n; i0 += stride) {
    const uint32_t i = (uint32_t)i0;
    uint32_t b[kPer];
#pragma unroll
    for (uint32_t q = 0; q < kPer; ++q) {
      b[q] = ewdml::threefry_bits(k.x, k.y, 0u, i + q);
    }
    if (kUniform) {
      float f[kPer];
#pragma unroll
      for (uint32_t q = 0; q < kPer; ++q) {
        f[q] = __uint_as_float((b[q] >> 9) | 0x3F800000u) - 1.0f;
      }
      float* o = static_cast<float*>(out) + i;
      if (i0 + kPer <= n) {
        *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
#pragma unroll
        for (uint32_t q = 0; q < kPer; ++q) {
          if (i0 + q < n) o[q] = f[q];
        }
      }
    } else {
      long long* o = static_cast<long long*>(out) + i;
      if (i0 + kPer <= n) {
        reinterpret_cast<longlong2*>(o)[0] = make_longlong2(b[0], b[1]);
        reinterpret_cast<longlong2*>(o)[1] = make_longlong2(b[2], b[3]);
      } else {
#pragma unroll
        for (uint32_t q = 0; q < kPer; ++q) {
          if (i0 + q < n) o[q] = b[q];
        }
      }
    }
  }
}

int grid_for(int64_t n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t per_block = (int64_t)kThreads * kPer;
  const int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// key: the packed key in device memory, or null to take key_value;
// n < 2^32; out: n int64 (uniform 0) or n f32 (uniform 1), 16-byte
// aligned.
int ewdml_random_bits(const unsigned long long* key,
                      unsigned long long key_value, int64_t n, int uniform,
                      void* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n >= (int64_t)1 << 32) return (int)cudaErrorInvalidValue;
  if (uniform) {
    random_bits_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        key, key_value, (uint32_t)n, out);
  } else {
    random_bits_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        key, key_value, (uint32_t)n, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
