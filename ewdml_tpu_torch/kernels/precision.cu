// Hopper (sm_90a) kernel of the precision policy's bf16 store.
//
// Seeded stochastic rounding f32 -> bf16, the port's counterpart of
// ewdml_tpu/core/precision.py:87 (stochastic_round, computed there by XLA,
// not Pallas). Held bit for bit against the plain PyTorch version beside
// its wrapper in ewdml_tpu_torch/ops/kernels.py.
//
// For element t of a leaf the dither is the low 16 bits of jax.random.bits
// under the partitionable threefry layout: threefry_bits(k0, k1, 0, j), with
// j the element's flat index in the JAX package's layout and (k0, k1) the
// leaf's key. A leaf held in PyTorch's layout (OIHW convolution kernels,
// [out, in] dense kernels) maps its index to the JAX one (HWIO, [in, out])
// in the kernel, so the draw is the JAX package's for the same leaf. The
// rounded value is (bits(x) + dither) & 0xFFFF0000, whose upper half is
// the bf16; NaN takes the canonical 0x7FC0 of PyTorch's cast (an infinity
// plus a dither below 2^16 keeps its upper half, so it needs no case).
//
// One launch rounds a store set: every leaf one optimizer update stores
// (both moments under Adam), or every residual of a step or bucket. Each
// leaf's descriptor travels in the kernel's parameters, by value: nothing
// is copied to the device, and a CUDA graph that captured the launch
// replays it as it is. The set's parent key is read once from device
// memory (a key-table slot, so a replay rounds under that replay's key),
// or passed by value; each leaf's key is the parent folded with the leaf's
// path of up to three words ((i) for SGD, (i, 0) and (i, 1) for Adam's
// moments, (RESIDUAL_TAG, r, i) for a residual), derived once per thread
// block by its first warp.
//
// What bounds it: the 20 threefry rounds, about 72 integer operations an
// element against 6 bytes of traffic, so the instruction issue (and the
// INT32 pipe that runs the shifts and xors) bounds it, not HBM. A thread
// takes 8 consecutive elements: two 16-byte loads and one 16-byte store.
// The JAX index of the first is computed by multiply-high and a shift in
// place of division (the multipliers are the host's), and each next one by
// a step of the innermost JAX stride, plus an adjustment past the one
// place where the innermost coordinate wraps (a compare and a select; a
// carry chain where the innermost dim is shorter than 8): the index map
// costs a few instructions an element where three divisions cost some
// sixty.
//
// Plain C interface, as compress.cu: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kVec = 8;    // consecutive elements a thread takes
constexpr uint32_t kIters = 2;  // vectors a thread takes in a block
constexpr uint32_t kBlockElems = kThreads * kVec * kIters;
// Leaves a launch takes: their descriptors hold its parameters under the
// 32 KB that CUDA 12.1 and later allow (ops/kernels.ROUND_MAX_LEAVES).
constexpr int kMaxLeaves = 448;

// RoundLeaf::meta: shift of d1 | shift of d2 << 8 | path depth << 16 | flags
constexpr uint32_t kPermuted = 1u << 24;  // the JAX layout differs
constexpr uint32_t kAligned = 1u << 25;   // x and out on 16-byte boundaries

// One leaf of a set, packed by the host (ops/kernels.round_descriptors).
// PyTorch's element t has coordinates (c0, c1, c2), innermost c2, over
// dims (-, d1, d2) (size-1 dims dropped, dims contiguous in both layouts
// merged), and JAX index c0 * s0 + c1 * s1 + c2 * s2. m1, m2 are the
// multipliers of the division by d1, d2.
struct RoundLeaf {
  unsigned long long x;    // const float*
  unsigned long long out;  // uint16_t*: the bf16 bits
  uint32_t n;
  uint32_t first_block;    // the leaf's first thread block in the launch
  uint32_t d1, d2;
  uint32_t m1, m2;
  uint32_t s0, s1, s2;
  uint32_t meta;
  uint32_t path[3];
  uint32_t pad;
};
static_assert(sizeof(RoundLeaf) == 72, "the host packs 72-byte leaves");

struct RoundSet {
  const unsigned long long* key;  // the parent key in device memory, or null
  unsigned long long key_value;   // the parent key where `key` is null
  uint32_t count;
  uint32_t pad;
  RoundLeaf leaf[kMaxLeaves];
};
static_assert(sizeof(RoundSet) <= 32764, "32 KB of parameters");

// t / d for the multiplier m and shift s of d (the host's round-up
// multiplier), exact for every 32-bit t: the sum is taken in 64 bits.
__device__ __forceinline__ uint32_t div_magic(uint32_t t, uint32_t m,
                                              uint32_t s) {
  return (uint32_t)(((unsigned long long)__umulhi(t, m) + t) >> s);
}

__device__ __forceinline__ uint32_t round_bits(uint32_t b, uint32_t bits) {
  return (b & 0x7FFFFFFFu) > 0x7F800000u ? 0x7FC0u
                                         : (b + (bits & 0xFFFFu)) >> 16;
}

// How a block maps a leaf's indices: the identity (the layouts agree), or
// a permuted leaf whose innermost dim is at least kVec long ("wide": c2
// wraps at most once in a vector, so each element's index is the first's
// plus k strides plus, past the wrap, one adjustment), or shorter
// ("narrow": a carry chain per element).
enum Map { kIdentity, kWide, kNarrow };

// The JAX indices of PyTorch's elements t .. t + kVec - 1.
template <Map kMap>
__device__ __forceinline__ void jax_indices(const RoundLeaf& L, uint32_t t,
                                            uint32_t (&j)[kVec]) {
  if (kMap == kIdentity) {
#pragma unroll
    for (uint32_t k = 0; k < kVec; ++k) j[k] = t + k;
    return;
  }
  const uint32_t q = div_magic(t, L.m2, (L.meta >> 8) & 0xFFu);
  uint32_t c2 = t - q * L.d2;
  const uint32_t c0 = div_magic(q, L.m1, L.meta & 0xFFu);
  uint32_t c1 = q - c0 * L.d1;
  // What a wrap of c2 (of c1) adds to the index besides its own step.
  const uint32_t wrap2 = L.s1 - L.d2 * L.s2;
  const uint32_t wrap1 = L.s0 - L.d1 * L.s1;
  uint32_t jj = c0 * L.s0 + c1 * L.s1 + c2 * L.s2;
  if (kMap == kWide) {
    const uint32_t until = L.d2 - c2;  // c2 wraps at element `until`
    const uint32_t adj = wrap2 + (c1 + 1 == L.d1 ? wrap1 : 0u);
#pragma unroll
    for (uint32_t k = 0; k < kVec; ++k) {
      j[k] = jj + (k >= until ? adj : 0u);
      jj += L.s2;
    }
    return;
  }
  j[0] = jj;
#pragma unroll
  for (uint32_t k = 1; k < kVec; ++k) {
    ++c2;
    jj += L.s2;
    const bool w2 = c2 == L.d2;
    c2 = w2 ? 0u : c2;
    c1 += w2;
    jj += w2 ? wrap2 : 0u;
    const bool w1 = c1 == L.d1;
    c1 = w1 ? 0u : c1;
    jj += w1 ? wrap1 : 0u;
    j[k] = jj;
  }
}

// The whole vectors of [lo, hi) (hi - lo a multiple of kVec, both
// 16-byte aligned in x and out): two 16-byte loads, one 16-byte store.
template <Map kMap>
__device__ __forceinline__ void round_vectors(const RoundLeaf& L, uint2 key,
                                              uint32_t lo, uint32_t hi) {
  const float* __restrict__ x = reinterpret_cast<const float*>(L.x);
  uint16_t* __restrict__ out = reinterpret_cast<uint16_t*>(L.out);
#pragma unroll 1
  for (uint32_t t = lo + threadIdx.x * kVec; t < hi; t += kThreads * kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + t));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + t) + 1);
    const uint32_t v[kVec] = {__float_as_uint(a.x), __float_as_uint(a.y),
                              __float_as_uint(a.z), __float_as_uint(a.w),
                              __float_as_uint(b.x), __float_as_uint(b.y),
                              __float_as_uint(b.z), __float_as_uint(b.w)};
    uint32_t j[kVec];
    jax_indices<kMap>(L, t, j);
    uint32_t r[kVec];
#pragma unroll
    for (uint32_t k = 0; k < kVec; ++k) {
      r[k] = round_bits(v[k], ewdml::threefry_bits(key.x, key.y, 0u, j[k]));
    }
    uint4 o;
    o.x = r[0] | (r[1] << 16);
    o.y = r[2] | (r[3] << 16);
    o.z = r[4] | (r[5] << 16);
    o.w = r[6] | (r[7] << 16);
    *reinterpret_cast<uint4*>(out + t) = o;
  }
}

// Elements t .. end - 1 (at most kVec) one at a time: a leaf's tail, or a
// leaf off a 16-byte boundary.
template <Map kMap>
__device__ __forceinline__ void round_scalar(const RoundLeaf& L, uint2 key,
                                             uint32_t t, uint32_t end) {
  const float* __restrict__ x = reinterpret_cast<const float*>(L.x);
  uint16_t* __restrict__ out = reinterpret_cast<uint16_t*>(L.out);
  uint32_t j[kVec];
  jax_indices<kMap>(L, t, j);
#pragma unroll
  for (uint32_t k = 0; k < kVec; ++k) {
    if (t + k < end) {
      const uint32_t bits = ewdml::threefry_bits(key.x, key.y, 0u, j[k]);
      out[t + k] = (uint16_t)round_bits(__float_as_uint(__ldg(x + t + k)),
                                        bits);
    }
  }
}

template <Map kMap>
__device__ __forceinline__ void round_block(const RoundLeaf& L, uint2 key,
                                            uint32_t begin, uint32_t end) {
  if (L.meta & kAligned) {
    const uint32_t vend = begin + ((end - begin) & ~(kVec - 1));
    round_vectors<kMap>(L, key, begin, vend);
    if (vend < end && threadIdx.x == 0) round_scalar<kMap>(L, key, vend, end);
  } else {
#pragma unroll 1
    for (uint32_t t = begin + threadIdx.x * kVec; t < end;
         t += kThreads * kVec) {
      round_scalar<kMap>(L, key, t, min(t + kVec, end));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    stochastic_round_kernel(const __grid_constant__ RoundSet set) {
  // The block's leaf: the last whose first block is at most blockIdx.x.
  uint32_t lo = 0, hi = set.count;
  while (hi - lo > 1) {
    const uint32_t mid = (lo + hi) >> 1;
    if (set.leaf[mid].first_block <= blockIdx.x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const RoundLeaf& L = set.leaf[lo];
  __shared__ uint2 leaf_key;
  if (threadIdx.x < 32) {
    uint2 k = ewdml::load_key(set.key, set.key_value);
    const uint32_t depth = (L.meta >> 16) & 0xFFu;
#pragma unroll 1
    for (uint32_t d = 0; d < depth; ++d) k = ewdml::fold_in(k, L.path[d]);
    if (threadIdx.x == 0) leaf_key = k;
  }
  __syncthreads();
  const uint2 key = leaf_key;
  const uint32_t begin = (blockIdx.x - L.first_block) * kBlockElems;
  const uint32_t end = min(L.n, begin + kBlockElems);
  if (!(L.meta & kPermuted)) {
    round_block<kIdentity>(L, key, begin, end);
  } else if (L.d2 >= kVec) {
    round_block<kWide>(L, key, begin, end);
  } else {
    round_block<kNarrow>(L, key, begin, end);
  }
}

}  // namespace

extern "C" {

// key: the parent key (k0 << 32 | k1) in device memory, or null to take
// key_value; leaves: `count` (at most kMaxLeaves) packed RoundLeaf
// descriptors in host memory, in order of first_block (numbered by
// kBlockElems, ops/kernels.ROUND_BLOCK_ELEMS), the first at block 0, none
// empty.
int ewdml_stochastic_round_set(const unsigned long long* key,
                               unsigned long long key_value,
                               const void* leaves, int count,
                               cudaStream_t stream) {
  if (count <= 0) return 0;
  if (count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  RoundSet set;
  set.key = key;
  set.key_value = key_value;
  set.count = (uint32_t)count;
  set.pad = 0;
  memcpy(set.leaf, leaves, sizeof(RoundLeaf) * count);
  const RoundLeaf& last = set.leaf[count - 1];
  const uint32_t blocks =
      last.first_block + (last.n + kBlockElems - 1) / kBlockElems;
  stochastic_round_kernel<<<blocks, kThreads, 0, stream>>>(set);
  return (int)cudaGetLastError();
}

}  // extern "C"
