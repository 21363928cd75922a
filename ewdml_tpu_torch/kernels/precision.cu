// Hopper (sm_90a) kernel of the precision policy's bf16 store.
//
// Seeded stochastic rounding f32 -> bf16, the port's counterpart of
// ewdml_tpu/core/precision.py:87 (stochastic_round, computed there by XLA,
// not Pallas). Held bit for bit against the plain PyTorch version beside
// its wrapper in ewdml_tpu_torch/ops/kernels.py.
//
// For element t the dither is the low 16 bits of jax.random.bits under the
// partitionable threefry layout: (y0, y1) = threefry2x32(k0, k1, j >> 32,
// j & 0xFFFFFFFF), bits = y0 ^ y1, with j the element's flat index in the
// JAX package's layout. A leaf held in PyTorch's layout (OIHW convolution
// kernels, [out, in] dense kernels) maps its index to the JAX one (HWIO,
// [in, out]) in the kernel, so the draw is the JAX package's for the same
// leaf. The rounded value is (bits(x) + dither) & 0xFFFF0000, whose upper
// half is the bf16; a non-finite x takes the plain cast (inf keeps its
// bits, NaN becomes the canonical 0x7FC0 that PyTorch's cast gives).
//
// The key (k0 << 32 | k1) is read from device memory: a slot of the step's
// key table, so a CUDA graph that captured the launch rounds each replay
// under that replay's key. uint32 arithmetic wraps as the threefry of
// jax.random does; the rotations are funnel shifts.
//
// Plain C interface, as compress.cu: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds (jax._src.prng.threefry2x32_p), y0 ^ y1.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
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
  return x0 ^ x1;
}

// The PyTorch layout's dims (innermost last, padded with 1) and, for each,
// the stride of that coordinate in the JAX layout.
struct Layout {
  uint32_t dim[4];
  uint32_t stride[4];
};

__device__ __forceinline__ uint32_t jax_index(uint32_t t, const Layout& l) {
  const uint32_t c3 = t % l.dim[3];
  t /= l.dim[3];
  const uint32_t c2 = t % l.dim[2];
  t /= l.dim[2];
  const uint32_t c1 = t % l.dim[1];
  const uint32_t c0 = t / l.dim[1];
  return c0 * l.stride[0] + c1 * l.stride[1] + c2 * l.stride[2] +
         c3 * l.stride[3];
}

__device__ __forceinline__ uint16_t round_one(float v, uint32_t k0,
                                              uint32_t k1, uint64_t j) {
  const uint32_t b = __float_as_uint(v);
  if ((b & 0x7F800000u) == 0x7F800000u) {  // inf or NaN: the plain cast
    return (b & 0x007FFFFFu) ? (uint16_t)0x7FC0u : (uint16_t)(b >> 16);
  }
  const uint32_t dither =
      threefry_bits(k0, k1, (uint32_t)(j >> 32), (uint32_t)j) & 0xFFFFu;
  return (uint16_t)((b + dither) >> 16);
}

// One thread per element in a grid-stride loop; no shared memory. The
// element's f32 is read once and its bf16 written once (6 bytes); the 20
// threefry rounds dominate, so the instruction rate, not HBM, bounds it.
template <bool kPermuted>
__global__ void __launch_bounds__(kThreads)
    stochastic_round_kernel(const float* __restrict__ x, int64_t n,
                            const uint64_t* __restrict__ key, Layout layout,
                            uint16_t* __restrict__ out) {
  const uint64_t kw = __ldg(reinterpret_cast<const unsigned long long*>(key));
  const uint32_t k0 = (uint32_t)(kw >> 32), k1 = (uint32_t)kw;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const uint64_t j =
        kPermuted ? (uint64_t)jax_index((uint32_t)t, layout) : (uint64_t)t;
    out[t] = round_one(__ldg(x + t), k0, k1, j);
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
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;  // 64 warps per SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// x: n contiguous f32; key: one uint64 (k0 << 32 | k1) in device memory;
// dims/strides: the PyTorch dims and their JAX strides (4 each), or null
// when the two layouts agree; out: n bf16 (as uint16).
int ewdml_stochastic_round(const float* x, int64_t n, const uint64_t* key,
                           const int64_t* dims, const int64_t* strides,
                           uint16_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  Layout l;
  for (int d = 0; d < 4; ++d) {
    l.dim[d] = dims ? (uint32_t)dims[d] : 1u;
    l.stride[d] = strides ? (uint32_t)strides[d] : 0u;
  }
  if (dims) {
    stochastic_round_kernel<true>
        <<<grid_for(n), kThreads, 0, stream>>>(x, n, key, l, out);
  } else {
    stochastic_round_kernel<false>
        <<<grid_for(n), kThreads, 0, stream>>>(x, n, key, l, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
