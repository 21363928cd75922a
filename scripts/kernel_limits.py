#!/usr/bin/env python3
"""What holds the port's kernels at their largest path shapes, and the
schedules that were tried for them.

    python3 scripts/kernel_limits.py        # on a machine with an NVIDIA GPU

``limits`` lines: each kernel beside a pass that moves the same bytes on
its schedule with next to no arithmetic, under two L2 flushes before every
launch: chip_smoke.py's (a 512 MB ``zero_()``, which leaves the L2 full of
dirty lines that the kernel's own lines must evict) and a read of the same
buffer (clean lines).
- qsgd_quantize (per tensor and blockwise 4096, 2 359 296 elements) and
  chunk_encode (fused_q's 596 blocks of 4096 at W = 4 on VGG11-BN) beside
  a pass on qsgd_quantize's schedule with a sign in place of the quantize
  (5n bytes: an f32 read and an int8 write per element);
- int_accumulate and dequant_mean (per tensor) at K = W = 4 over the
  2 359 296 bucket beside a pass on their shared schedule that XORs the K
  words (K int8 rows read, one 4-byte plane written);
- acc_decode (per tensor, a decode set of one) over the bucket beside a
  copy on the old per-element schedule (4n bytes in, 4n out);
- the decode set at VGG11-BN's and ResNet50's homomorphic apply sets (38
  and 161 leaves, per tensor, k = 4) beside a copy on the set's own
  schedule (a resident wave of 4096-element tiles, each brought into
  shared memory by a 1-D TMA bulk copy).

``variant`` lines: the same shapes through other schedules of the same
arithmetic, each bit-checked against the plain version and timed after
chip_smoke.py's flush, beside the tree's kernel:
- the quantize and the encode: a grid-stride quantize with one unhinted
  float4 per thread and a 64-bit norm index, and an encode with one CTA of
  256 per block, two barriers and the draw at the quantize (the kernels'
  earlier schedules); one resident wave of whole tiles, 16 elements a
  thread with the draw while the loads are in flight; and persistent CTAs
  that stage later tiles into shared memory with cp.async;
- the worker-axis reduce (int_accumulate, dequant_mean) at K = 4: word
  columns with 4 or 2 words of each row a lane (the kept schedule is 4),
  and 16-byte loads of 16 elements a lane with four uint4 stores at a
  64-byte lane stride, or with the outputs transposed through shared
  memory (one or two tiles a thread in flight);
- dequant_mean at [4, 530 442], whose rows 1 and 3 start 2-byte aligned:
  the interior tiles realigned with a branch on the alignment per word or
  per row, with the upper word taken from the next lane by shuffle, or
  without the L2 prefetch hint;
- the decode set: the schedule the bulk copies replaced (four 16-byte
  loads in flight a thread, then the decode) and its copy, beside the
  kept one (each tile by a 1-D TMA bulk copy, ``cp.async.bulk``
  completing on an ``mbarrier``, two 16 KB stages a CTA, the next tile's
  copy in flight while a tile is decoded).

    python3 scripts/kernel_limits.py --decode-only   # the decode set alone

Times are medians of 25 CUDA-event timings, and the kernel's own time on
the card from a ``torch.profiler`` trace. The source below is built here
with nvcc; it is a yardstick, not a kernel of the port.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float uniform_hash(uint32_t idx, uint32_t seed) {
  uint32_t x = (idx * 2654435761u) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return __fmul_rn((float)(int32_t)(x >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ int8_t quantize_level(float x, float scale,
                                                 float u) {
  float level_float = __fmul_rn(scale, fabsf(x));
  float previous = floorf(level_float);
  float frac = __fsub_rn(level_float, previous);
  float level = __fadd_rn(previous, u < frac ? 1.0f : 0.0f);
  float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  float v = __fmul_rn(sgn, level);
  v = fminf(fmaxf(v, -128.0f), 127.0f);
  return (int8_t)__float2int_rz(v);
}

__device__ __forceinline__ float safe_scale(float s, float norm) {
  return __fdiv_rn(s, norm == 0.0f ? 1.0f : norm);
}

__device__ __forceinline__ char4 quantize4(float4 x, float scale,
                                           const float* u) {
  return make_char4(quantize_level(x.x, scale, u[0]),
                    quantize_level(x.y, scale, u[1]),
                    quantize_level(x.z, scale, u[2]),
                    quantize_level(x.w, scale, u[3]));
}

// The bytes alone, on the port quantize's schedule.
__global__ void bytes_pass_kernel(const float4* __restrict__ x, int64_t nvec,
                                  char4* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    float4 e;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(e.x), "=f"(e.y), "=f"(e.z), "=f"(e.w) : "l"(x + v));
    out[v] = make_char4(e.x > 0.0f, e.y > 0.0f, e.z > 0.0f, e.w > 0.0f);
  }
}

// A grid-stride quantize, one unhinted float4 per thread (n % 4 == 0 here).
__global__ void gridstride_quantize_kernel(const float4* __restrict__ x,
                                    const float* __restrict__ norms,
                                    int64_t nvec, int64_t block,
                                    uint32_t seed, float s,
                                    char4* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const int64_t i = v * 4;
    const float scale = safe_scale(s, norms[block ? i / block : 0]);
    const float4 xv = x[v];
    float u[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = uniform_hash((uint32_t)(i + c), seed);
    out[v] = quantize4(xv, scale, u);
  }
}

// Whole tiles of kT * 16 elements in one resident wave (n a multiple of
// the tile here): thread t holds 4 * (t + kT * j) + c, loads first, draws
// while they are in flight. kReduce: the tile is a quantization block whose
// norm is reduced in the ring order (kT = 256 for 4096).
template <bool kReduce, int kT>
__global__ void __launch_bounds__(kT, 1280 / kT)
    tile_kernel(const float4* __restrict__ x, const float* __restrict__ norms,
                int tiles_per_norm, uint32_t seed, float s,
                char4* __restrict__ out, float* __restrict__ out_norms) {
  const int t = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * (kT * 4) + t;  // in vectors
  float norm = 0.0f;
  if constexpr (!kReduce) {
    norm = norms[tiles_per_norm ? (int)blockIdx.x / tiles_per_norm : 0];
  }
  float4 x4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x4[j] = x[first + kT * j];
  float u[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      u[4 * j + c] =
          uniform_hash((uint32_t)(4 * (first + kT * j)) + c, seed);
    }
  }
  if constexpr (kReduce) {
    __shared__ float warp_sums[kT / 32];
    const int lane = t & 31;
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ss = __fadd_rn(ss, __fmul_rn(x4[j].x, x4[j].x));
      ss = __fadd_rn(ss, __fmul_rn(x4[j].y, x4[j].y));
      ss = __fadd_rn(ss, __fmul_rn(x4[j].z, x4[j].z));
      ss = __fadd_rn(ss, __fmul_rn(x4[j].w, x4[j].w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
    }
    if (lane == 0) warp_sums[t >> 5] = ss;
    __syncthreads();
    float w = lane < kT / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = kT / 64; off > 0; off >>= 1) {
      w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, off));
    }
    norm = __shfl_sync(0xffffffffu, __fsqrt_rn(w), 0);
    if (t == 0) out_norms[blockIdx.x] = norm;
  }
  const float scale = safe_scale(s, norm);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[first + kT * j] = quantize4(x4[j], scale, u + 4 * j);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// Persistent CTAs walking tiles blockIdx.x, + gridDim.x, ...: each thread
// copies its own 16 elements of the tile kS - 1 steps ahead into shared
// memory with cp.async, draws, waits for the current tile, quantizes.
template <bool kReduce, int kT, int kS>
__global__ void __launch_bounds__(kT)
    staged_kernel(const float4* __restrict__ x,
                  const float* __restrict__ norms, int tiles_per_norm,
                  int64_t ntiles, uint32_t seed, float s,
                  char4* __restrict__ out, float* __restrict__ out_norms) {
  extern __shared__ float4 stage[];  // [kS][4][kT]
  __shared__ float warp_sums[2][kT / 32];
  const int t = threadIdx.x;
  auto prefetch = [&](int64_t tile, int st) {
    if (tile < ntiles) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cp_async16(&stage[(st * 4 + j) * kT + t],
                   x + tile * (kT * 4) + t + kT * j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int64_t tile = blockIdx.x;
  for (int st = 0; st < kS - 1; ++st) prefetch(tile + st * gridDim.x, st);
  for (int k = 0; tile < ntiles; ++k, tile += gridDim.x) {
    prefetch(tile + (kS - 1) * gridDim.x, (k + kS - 1) % kS);
    const int64_t first = tile * (kT * 4) + t;
    float u[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        u[4 * j + c] =
            uniform_hash((uint32_t)(4 * (first + kT * j)) + c, seed);
      }
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kS - 1) : "memory");
    float4 x4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x4[j] = stage[((k % kS) * 4 + j) * kT + t];
    float norm;
    if constexpr (kReduce) {
      const int lane = t & 31;
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ss = __fadd_rn(ss, __fmul_rn(x4[j].x, x4[j].x));
        ss = __fadd_rn(ss, __fmul_rn(x4[j].y, x4[j].y));
        ss = __fadd_rn(ss, __fmul_rn(x4[j].z, x4[j].z));
        ss = __fadd_rn(ss, __fmul_rn(x4[j].w, x4[j].w));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
      }
      if (lane == 0) warp_sums[k & 1][t >> 5] = ss;
      __syncthreads();
      float w = lane < kT / 32 ? warp_sums[k & 1][lane] : 0.0f;
#pragma unroll
      for (int off = kT / 64; off > 0; off >>= 1) {
        w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, off));
      }
      norm = __shfl_sync(0xffffffffu, __fsqrt_rn(w), 0);
      if (t == 0) out_norms[tile] = norm;
    } else {
      norm = norms[tiles_per_norm ? (int)(tile / tiles_per_norm) : 0];
    }
    const float scale = safe_scale(s, norm);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[first + kT * j] = quantize4(x4[j], scale, u + 4 * j);
  }
}

// chunk_encode with one CTA of 256 per 4096-block, two barriers, the draw
// at the quantize.
__global__ void cta_encode_kernel(const float4* __restrict__ x, uint32_t seed,
                                  float s, char4* __restrict__ out,
                                  float* __restrict__ out_norms) {
  __shared__ float warp_sums[8];
  __shared__ float block_norm;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t first = (int64_t)blockIdx.x * 1024 + t;
  float4 x4[4];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x4[j] = x[first + 256 * j];
    ss = __fadd_rn(ss, __fmul_rn(x4[j].x, x4[j].x));
    ss = __fadd_rn(ss, __fmul_rn(x4[j].y, x4[j].y));
    ss = __fadd_rn(ss, __fmul_rn(x4[j].z, x4[j].z));
    ss = __fadd_rn(ss, __fmul_rn(x4[j].w, x4[j].w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
  }
  if (lane == 0) warp_sums[t >> 5] = ss;
  __syncthreads();
  if (t < 32) {
    float w = lane < 8 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, off));
    }
    if (lane == 0) {
      block_norm = __fsqrt_rn(w);
      out_norms[blockIdx.x] = block_norm;
    }
  }
  __syncthreads();
  const float scale = safe_scale(s, block_norm);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float u[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      u[c] = uniform_hash((uint32_t)(4 * (first + 256 * j)) + c, seed);
    }
    out[first + 256 * j] = quantize4(x4[j], scale, u);
  }
}

template <bool kReduce, int kT, int kS>
int staged(const float* x, const float* norms, int64_t n, int64_t block,
           uint32_t seed, int8_t* out, float* out_norms, int ctas_per_sm,
           cudaStream_t stream) {
  constexpr int smem = kS * 4 * kT * 16;
  const int64_t ntiles = n / (kT * 16);
  int64_t grid = 132 * (int64_t)ctas_per_sm;
  if (grid > ntiles) grid = ntiles;
  cudaFuncSetAttribute(staged_kernel<kReduce, kT, kS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  staged_kernel<kReduce, kT, kS><<<(unsigned)grid, kT, smem, stream>>>(
      reinterpret_cast<const float4*>(x), norms,
      block ? (int)(block / (kT * 16)) : 0, ntiles, seed, 127.0f,
      reinterpret_cast<char4*>(out), out_norms);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes n a multiple of the tile (4096), the seed, and for the
// quantize the norms and the block (0: per tensor).
extern "C" {

int bytes_pass(const float* x, int64_t n, int8_t* out, cudaStream_t stream) {
  int64_t blocks = (n / 4 + 1 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bytes_pass_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), n / 4,
      reinterpret_cast<char4*>(out));
  return (int)cudaGetLastError();
}

int gridstride_quantize(const float* x, const float* norms, int64_t n, int64_t block,
                 uint32_t seed, int8_t* out, cudaStream_t stream) {
  int64_t blocks = (n / 4 + 1 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gridstride_quantize_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), norms, n / 4, block, seed, 127.0f,
      reinterpret_cast<char4*>(out));
  return (int)cudaGetLastError();
}

int tile_quantize(const float* x, const float* norms, int64_t n,
                  int64_t block, uint32_t seed, int8_t* out,
                  cudaStream_t stream) {
  tile_kernel<false, 128><<<(unsigned)(n / 2048), 128, 0, stream>>>(
      reinterpret_cast<const float4*>(x), norms, (int)(block / 2048), seed,
      127.0f, reinterpret_cast<char4*>(out), nullptr);
  return (int)cudaGetLastError();
}

int staged_quantize(const float* x, const float* norms, int64_t n,
                    int64_t block, uint32_t seed, int8_t* out,
                    cudaStream_t stream) {
  return staged<false, 128, 4>(x, norms, n, block, seed, out, nullptr, 4,
                               stream);
}

int cta_encode(const float* x, int64_t n, uint32_t seed, int8_t* out,
               float* norms, cudaStream_t stream) {
  cta_encode_kernel<<<(unsigned)(n / 4096), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), seed, 127.0f,
      reinterpret_cast<char4*>(out), norms);
  return (int)cudaGetLastError();
}

int tile_encode(const float* x, int64_t n, uint32_t seed, int8_t* out,
                float* norms, cudaStream_t stream) {
  tile_kernel<true, 256><<<(unsigned)(n / 4096), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), nullptr, 0, seed, 127.0f,
      reinterpret_cast<char4*>(out), norms);
  return (int)cudaGetLastError();
}

int staged_encode(const float* x, int64_t n, uint32_t seed, int8_t* out,
                  float* norms, cudaStream_t stream) {
  return staged<true, 256, 2>(x, nullptr, n, 0, seed, out, norms, 2, stream);
}

}  // extern "C"
"""

REDUCE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 ld_once_v4(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_once_u32(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int sbyte(uint32_t w, int c) {
  return (int)(w << (24 - 8 * c)) >> 24;
}

// The epilogues: 0 the int32 sum (int_accumulate), 1 the per-tensor
// dequantized mean (dequant_mean), 2 the bytes alone (an XOR of the K words,
// spread over the four outputs of a word).
template <int kEpi, int K>
__device__ __forceinline__ uint4 reduce_word(const uint32_t* w,
                                             const float* nm, float factor) {
  if constexpr (kEpi == 2) {
    uint32_t x = w[0];
#pragma unroll
    for (int k = 1; k < K; ++k) x ^= w[k];
    return make_uint4(x, x >> 8, x >> 16, x >> 24);
  } else if constexpr (kEpi == 0) {
    int s[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] += sbyte(w[k], c);
    }
    return make_uint4(s[0], s[1], s[2], s[3]);
  } else {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[c] = __fadd_rn(a[c], __fmul_rn(nm[k], (float)sbyte(w[k], c)));
      }
    }
    return make_uint4(__float_as_uint(__fmul_rn(a[0], factor)),
                      __float_as_uint(__fmul_rn(a[1], factor)),
                      __float_as_uint(__fmul_rn(a[2], factor)),
                      __float_as_uint(__fmul_rn(a[3], factor)));
  }
}

// Word columns (CTAs of 128, as compress.cu's worker_reduce): lane l of a
// warp tile owns the words 4 (l + 32 j), j < J, of
// every row (a warp load covers 128 contiguous bytes of a row) and stores
// their 4 J outputs as J uint4 (a warp store covers 512 contiguous bytes).
template <int kEpi, int K, int J>
__global__ void __launch_bounds__(128)
    word_reduce_kernel(const int8_t* __restrict__ levels,
                       const float* __restrict__ norms, int64_t n,
                       float factor, uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t tiles = n / (128 * J);
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  float nm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) nm[k] = kEpi == 1 ? norms[k] : 0.0f;
  for (int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
       tile < tiles; tile += warps) {
    const int64_t e0 = tile * 128 * J + 4 * lane;
    uint32_t w[J][K];
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        w[j][k] = ld_once_u32(levels + (int64_t)k * n + e0 + 128 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      out[(e0 + 128 * j) / 4] = reduce_word<kEpi, K>(w[j], nm, factor);
    }
  }
}

// 16-byte columns: lane l of a warp tile of 512 elements loads the 16
// bytes 16 l of every row (G tiles in flight a thread). kSmem: the 16
// outputs go through a swizzled shared-memory tile so that a warp store
// covers 512 contiguous bytes; otherwise each thread stores its four uint4
// at a 64-byte lane stride.
template <int kEpi, int K, bool kSmem, int G>
__global__ void __launch_bounds__(256)
    vec_reduce_kernel(const int8_t* __restrict__ levels,
                      const float* __restrict__ norms, int64_t n,
                      float factor, uint4* __restrict__ out) {
  __shared__ uint4 stage[kSmem ? 8 * 128 : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = n / 512;
  const int64_t warps = (int64_t)gridDim.x * 8;
  float nm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) nm[k] = kEpi == 1 ? norms[k] : 0.0f;
  for (int64_t t0 = (int64_t)blockIdx.x * 8 + warp; t0 < tiles;
       t0 += warps * G) {
    uint4 v[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t tile = t0 + warps * g;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[g][k] = tile < tiles
                      ? ld_once_v4(levels + (int64_t)k * n + tile * 512 + 16 * lane)
                      : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t tile = t0 + warps * g;
      if (tile >= tiles) break;
      uint4 r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t w[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          w[k] = c == 0 ? v[g][k].x : c == 1 ? v[g][k].y : c == 2 ? v[g][k].z : v[g][k].w;
        }
        r[c] = reduce_word<kEpi, K>(w, nm, factor);
      }
      uint4* o = out + tile * 128;
      if constexpr (kSmem) {
        uint4* st = stage + warp * 128;
#pragma unroll
        for (int c = 0; c < 4; ++c) st[4 * lane + (c ^ ((lane >> 1) & 3))] = r[c];
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int q = 32 * s + lane;  // the uint4 of the tile this lane stores
          const int src = q >> 2;       // the lane that computed it
          o[q] = st[4 * src + ((q & 3) ^ ((src >> 1) & 3))];
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[4 * lane + c] = r[c];
      }
    }
  }
}

// The word columns of the kept schedule on rows that start anywhere (K = 4,
// the dequant epilogue, the interior tiles [1, (n - 4) / 512) only). A row
// whose start is not 4-byte aligned (r = its address % 4) realigns each
// word from the two aligned words that cover it. kMode 0: the branch on r
// per word (the kept kernel's first build); 1: one branch on r per row;
// 2: one branch per row, and the word above taken from the next lane with
// a shuffle (lane 31 takes lane 0's next column, or loads it); 3: as 1
// with plain ld.global.nc loads (no L2 prefetch hint).
template <int kMode>
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  if constexpr (kMode == 3) {
    uint32_t v;
    asm("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  } else {
    return ld_once_u32(p);
  }
}

template <int kMode>
__global__ void __launch_bounds__(128)
    realign_kernel(const int8_t* __restrict__ levels,
                   const float* __restrict__ norms, int64_t n, float factor,
                   uint4* __restrict__ out) {
  constexpr int J = 4;
  const int lane = threadIdx.x & 31;
  const int64_t end = n >= 4 ? (n - 4) / 512 : 0;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  float nm[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) nm[k] = norms[k];
  for (int64_t t = 1 + (int64_t)blockIdx.x * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       t < end; t += warps) {
    const int64_t e0 = t * 512 + 4 * lane;
    uint32_t w[J][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int8_t* row = levels + (int64_t)k * n;
      const uint32_t r = (uint32_t)(reinterpret_cast<uintptr_t>(row) & 3);
      if constexpr (kMode == 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const uintptr_t addr = reinterpret_cast<uintptr_t>(row + e0 + 128 * j);
          const uint32_t rr = (uint32_t)(addr & 3);
          const uint32_t* q = reinterpret_cast<const uint32_t*>(addr - rr);
          w[j][k] = rr == 0 ? ld_word<0>(q)
                            : __funnelshift_r(ld_word<0>(q), ld_word<0>(q + 1),
                                              8 * rr);
        }
      } else {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(row + e0) - r);
        if (r == 0) {
#pragma unroll
          for (int j = 0; j < J; ++j) w[j][k] = ld_word<kMode>(q + 32 * j);
        } else if constexpr (kMode == 2) {
          uint32_t lo[J];
#pragma unroll
          for (int j = 0; j < J; ++j) lo[j] = ld_word<kMode>(q + 32 * j);
          const uint32_t extra =
              lane == 31 ? ld_word<kMode>(q + 32 * (J - 1) + 1) : 0u;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            uint32_t hi = __shfl_down_sync(0xffffffffu, lo[j], 1);
            const uint32_t wrap =
                __shfl_sync(0xffffffffu, j + 1 < J ? lo[j + 1] : 0u, 0);
            if (lane == 31) hi = j + 1 < J ? wrap : extra;
            w[j][k] = __funnelshift_r(lo[j], hi, 8 * r);
          }
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            w[j][k] = __funnelshift_r(ld_word<kMode>(q + 32 * j),
                                      ld_word<kMode>(q + 32 * j + 1), 8 * r);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      out[(e0 + 128 * j) / 4] = reduce_word<1, 4>(w[j], nm, factor);
    }
  }
}

// acc_decode's schedule moving its bytes (4n in, 4n out) with no arithmetic.
__global__ void decode_bytes_kernel(const int4* __restrict__ acc, int64_t nvec,
                                    int4* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    out[v] = acc[v];
  }
}

template <typename Kernel>
int resident_grid(Kernel kernel, int threads) {
  static int sms = 0;
  if (!sms) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm;
}

template <int kMode>
int realign(const int8_t* levels, const float* norms, int64_t n, float factor,
            void* out, cudaStream_t stream) {
  realign_kernel<kMode><<<resident_grid(realign_kernel<kMode>, 128), 128, 0,
                          stream>>>(levels, norms, n, factor,
                                    reinterpret_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

template <int kEpi, int J>
int word_reduce(const int8_t* levels, const float* norms, int64_t n,
                float factor, void* out, cudaStream_t stream) {
  word_reduce_kernel<kEpi, 4, J><<<
      resident_grid(word_reduce_kernel<kEpi, 4, J>, 128), 128, 0, stream>>>(
      levels, norms, n, factor, reinterpret_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

template <int kEpi, bool kSmem, int G>
int vec_reduce(const int8_t* levels, const float* norms, int64_t n,
               float factor, void* out, cudaStream_t stream) {
  vec_reduce_kernel<kEpi, 4, kSmem, G><<<
      resident_grid(vec_reduce_kernel<kEpi, 4, kSmem, G>, 256), 256, 0,
      stream>>>(
      levels, norms, n, factor, reinterpret_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

template <int E> int word4(const int8_t* l, const float* m, int64_t n, float f, void* o, cudaStream_t s) { return word_reduce<E, 4>(l, m, n, f, o, s); }
template <int E> int word2(const int8_t* l, const float* m, int64_t n, float f, void* o, cudaStream_t s) { return word_reduce<E, 2>(l, m, n, f, o, s); }
template <int E> int vec_strided(const int8_t* l, const float* m, int64_t n, float f, void* o, cudaStream_t s) { return vec_reduce<E, false, 1>(l, m, n, f, o, s); }
template <int E> int vec_smem(const int8_t* l, const float* m, int64_t n, float f, void* o, cudaStream_t s) { return vec_reduce<E, true, 1>(l, m, n, f, o, s); }
template <int E> int vec_smem2(const int8_t* l, const float* m, int64_t n, float f, void* o, cudaStream_t s) { return vec_reduce<E, true, 2>(l, m, n, f, o, s); }

}  // namespace

// Every reduce entry takes K = 4 rows [4, n] with n a multiple of 512 and
// a 16-byte aligned base, per-tensor norms [4] (the dequant epilogue) and
// the mean's factor; `epi` is 0 (int32 sum), 1 (dequant mean), 2 (bytes).
extern "C" {

#define REDUCE_ENTRY(name, call)                                            \
  int name(int epi, const int8_t* levels, const float* norms, int64_t n,    \
           float factor, void* out, cudaStream_t stream) {                  \
    if (epi == 0) return call<0>(levels, norms, n, factor, out, stream);    \
    if (epi == 1) return call<1>(levels, norms, n, factor, out, stream);    \
    return call<2>(levels, norms, n, factor, out, stream);                  \
  }


REDUCE_ENTRY(reduce_word4, word4)
REDUCE_ENTRY(reduce_word2, word2)
REDUCE_ENTRY(reduce_vec_strided, vec_strided)
REDUCE_ENTRY(reduce_vec_smem, vec_smem)
REDUCE_ENTRY(reduce_vec_smem2, vec_smem2)

int realign_per_word(const int8_t* l, const float* m, int64_t n, float f,
                     void* o, cudaStream_t s) {
  return realign<0>(l, m, n, f, o, s);
}
int realign_per_row(const int8_t* l, const float* m, int64_t n, float f,
                    void* o, cudaStream_t s) {
  return realign<1>(l, m, n, f, o, s);
}
int realign_shuffle(const int8_t* l, const float* m, int64_t n, float f,
                    void* o, cudaStream_t s) {
  return realign<2>(l, m, n, f, o, s);
}
int realign_unhinted(const int8_t* l, const float* m, int64_t n, float f,
                     void* o, cudaStream_t s) {
  return realign<3>(l, m, n, f, o, s);
}

int decode_bytes(const int32_t* acc, int64_t n, int32_t* out,
                 cudaStream_t stream) {
  int64_t blocks = (n / 4 + 1 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  decode_bytes_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const int4*>(acc), n / 4, reinterpret_cast<int4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
"""


DECODE_SOURCE = r"""
// The decode set's schedules (kernels/decode.cu), on its descriptors.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;
constexpr uint32_t kTile = kThreads * kVecs * 4;
constexpr int kMaxLeaves = 448;

struct DecodeLeaf {
  unsigned long long acc, out, scales;
  uint32_t n, first_tile, tiles_per_block;
  float inv_k;
};
struct DecodeSet {
  uint32_t count, tiles;
  DecodeLeaf leaf[kMaxLeaves];
};

__device__ __forceinline__ const DecodeLeaf& leaf_of(const DecodeSet& set,
                                                     uint32_t t) {
  uint32_t lo = 0, hi = set.count;
  while (hi - lo > 1) {
    const uint32_t mid = (lo + hi) >> 1;
    if (set.leaf[mid].first_tile <= t) lo = mid; else hi = mid;
  }
  return set.leaf[lo];
}

__device__ __forceinline__ float decode_one(int32_t a, float f) {
  return __fmul_rn(__int2float_rn(a), f);
}

__device__ __forceinline__ float tile_factor(const DecodeLeaf& L,
                                             uint32_t tile) {
  const float* sc = reinterpret_cast<const float*>(L.scales);
  return __fmul_rn(
      __ldg(sc + (L.tiles_per_block ? tile / L.tiles_per_block : 0u)),
      L.inv_k);
}

// The schedule decode.cu replaced: four 16-byte loads in flight a thread,
// then the decode (kDecode) or a copy of the sums (its bytes alone).
template <bool kDecode>
__global__ void __launch_bounds__(kThreads)
    set_loads_kernel(const __grid_constant__ DecodeSet set) {
  for (uint32_t t = blockIdx.x; t < set.tiles; t += gridDim.x) {
    const DecodeLeaf& L = leaf_of(set, t);
    const uint32_t tile = t - L.first_tile;
    const float f = kDecode ? tile_factor(L, tile) : 0.0f;
    const int64_t begin = (int64_t)tile * kTile;
    const int64_t rest = (int64_t)L.n - begin;
    const uint32_t m = rest < kTile ? (uint32_t)rest : kTile;
    const int4* a4 = reinterpret_cast<const int4*>(L.acc) + begin / 4;
    int4* o4 = reinterpret_cast<int4*>(L.out) + begin / 4;
    const uint32_t nvec = m / 4;
    int4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t i = threadIdx.x + j * kThreads;
      if (i < nvec) v[j] = __ldcs(a4 + i);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t i = threadIdx.x + j * kThreads;
      if (i < nvec) {
        o4[i] = kDecode ? make_int4(__float_as_int(decode_one(v[j].x, f)),
                                    __float_as_int(decode_one(v[j].y, f)),
                                    __float_as_int(decode_one(v[j].z, f)),
                                    __float_as_int(decode_one(v[j].w, f)))
                        : v[j];
      }
    }
    const uint32_t e = nvec * 4 + threadIdx.x;
    if (e < m) {
      const int32_t a = reinterpret_cast<const int32_t*>(L.acc)[begin + e];
      reinterpret_cast<int32_t*>(L.out)[begin + e] =
          kDecode ? __float_as_int(decode_one(a, f)) : a;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: the whole vectors of tile t into `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(const DecodeSet& set, uint32_t t,
                                          int4* dst, uint64_t* bar) {
  const DecodeLeaf& L = leaf_of(set, t);
  const int64_t begin = (int64_t)(t - L.first_tile) * kTile;
  const int64_t rest = (int64_t)L.n - begin;
  const uint32_t m = rest < kTile ? (uint32_t)rest : kTile;
  const uint32_t bytes = (m / 4) * 16;
  const int32_t* src = reinterpret_cast<const int32_t*>(L.acc) + begin;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}"
      :: "r"(smem_addr(bar)), "r"(phase) : "memory");
}

// decode.cu's schedule (1-D TMA bulk copies, two 16 KB stages a CTA)
// copying the staged sums out with no arithmetic: its bytes alone.
__global__ void __launch_bounds__(kThreads)
    set_bulk_kernel(const __grid_constant__ DecodeSet set) {
  __shared__ alignas(128) int4 buf[2][kTile / 4];
  __shared__ alignas(8) uint64_t bar[2];
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar[b])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t t = blockIdx.x;
  if (threadIdx.x == 0 && t < set.tiles) bulk_load(set, t, buf[0], &bar[0]);
  for (uint32_t i = 0; t < set.tiles; t += gridDim.x, ++i) {
    const uint32_t b = i & 1;
    const uint32_t next = t + gridDim.x;
    if (threadIdx.x == 0 && next < set.tiles) {
      bulk_load(set, next, buf[b ^ 1], &bar[b ^ 1]);
    }
    const DecodeLeaf& L = leaf_of(set, t);
    const int64_t begin = (int64_t)(t - L.first_tile) * kTile;
    const int64_t rest = (int64_t)L.n - begin;
    const uint32_t m = rest < kTile ? (uint32_t)rest : kTile;
    const uint32_t nvec = m / 4;
    int4* o4 = reinterpret_cast<int4*>(L.out) + begin / 4;
    wait_phase(&bar[b], (i >> 1) & 1);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t k = threadIdx.x + j * kThreads;
      if (k < nvec) o4[k] = buf[b][k];
    }
    const uint32_t e = nvec * 4 + threadIdx.x;
    if (e < m) {
      reinterpret_cast<int32_t*>(L.out)[begin + e] =
          reinterpret_cast<const int32_t*>(L.acc)[begin + e];
    }
    __syncthreads();
  }
}

template <typename Kernel>
int launch_set(Kernel kernel, const void* leaves, int count,
               unsigned long long acc_base, unsigned long long out_base,
               cudaStream_t stream) {
  if (count <= 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  DecodeSet set;
  set.count = (uint32_t)count;
  memcpy(set.leaf, leaves, sizeof(DecodeLeaf) * count);
  for (int i = 0; i < count; ++i) {
    set.leaf[i].acc += acc_base;
    set.leaf[i].out += out_base;
  }
  const DecodeLeaf& last = set.leaf[count - 1];
  set.tiles = last.first_tile + (last.n + kTile - 1) / kTile;
  const uint32_t resident = (uint32_t)(sms * (per_sm > 0 ? per_sm : 1));
  kernel<<<set.tiles < resident ? set.tiles : resident, kThreads, 0,
           stream>>>(set);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 1: a copy on the replaced schedule; 2: the replaced schedule's
// decode; 3: a copy on decode.cu's bulk-copy schedule.
int decode_set_variant(int mode, const void* leaves, int count,
                       unsigned long long acc_base,
                       unsigned long long out_base, cudaStream_t stream) {
  if (mode == 1) {
    return launch_set(set_loads_kernel<false>, leaves, count, acc_base,
                      out_base, stream);
  }
  if (mode == 2) {
    return launch_set(set_loads_kernel<true>, leaves, count, acc_base,
                      out_base, stream);
  }
  return launch_set(set_bulk_kernel, leaves, count, acc_base, out_base,
                    stream);
}

}  // extern "C"
"""

# The decode set's schedules: mode, what it does, its kernel's name, and
# whether it copies the sums (else it decodes them).
DECODE_VARIANTS = {
    1: ("a copy on the replaced schedule (four 16-byte loads in flight a "
        "thread)", "set_loads_kernel", True),
    2: ("the replaced schedule's decode", "set_loads_kernel", False),
    3: ("a copy on the kept schedule (1-D TMA bulk copies, two 16 KB "
        "stages)", "set_bulk_kernel", True),
}


def decode_limits(torch, lib, kernels, events, alone, stream) -> None:
    """The decode set (``DecodeSet.launch``: decode.cu's bulk-copy
    schedule) at VGG11-BN's and ResNet50's apply sets beside a copy on
    the same schedule, and the schedule it replaced with its copy, each
    bit-checked (a copy against the sums' bits)."""
    import chip_smoke

    g = torch.Generator(device="cuda").manual_seed(61)
    for network in ("VGG11", "ResNet50"):
        sizes = chip_smoke.apply_sizes(network)
        dset, acc, items = chip_smoke.decode_layout(torch, kernels, sizes, 4,
                                                    None, g)
        want = kernels.decode_sum_set_ref(items)
        out = torch.empty(dset.total, dtype=torch.float32, device="cuda")
        what = f"decode set {network} ({len(sizes)} leaves, {sum(sizes)})"

        def run(mode):
            def go():
                rc = 0
                for desc in dset._descs:
                    rc |= lib.decode_set_variant(
                        mode, desc.ctypes.data, len(desc), acc.data_ptr(),
                        out.data_ptr(), stream)
                return rc
            return go

        def same(views, bits=False):
            ref = dset.views(acc) if bits else want
            return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(views, ref))
        variants = [(f"{what} (the tree)", lambda: dset.launch(acc),
                     "acc_decode_set_kernel",
                     lambda: same(dset.views(dset.launch(acc))))]
        for mode, (how, kname, copy) in DECODE_VARIANTS.items():
            def check(mode=mode, copy=copy):
                out.zero_()
                return run(mode)() == 0 and same(dset.views(out), copy)
            variants.append((f"{what} {how}", run(mode), kname, check))
        for _ in range(2):
            for name, fn, kname, check in variants:
                if not check():
                    raise AssertionError(f"{name}: differs from the plain "
                                         "version")
                print(f"variant {name}: dirty flush {events(fn, False):.4f} "
                      f"ms, clean flush {events(fn, True):.4f} ms, alone "
                      f"{alone(fn, (kname,))}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_limits: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ewdml_tpu_torch.kernels import nvcc_path
    from ewdml_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp()
    src, lib_path = os.path.join(tmp, "limits.cu"), os.path.join(tmp, "limits.so")
    with open(src, "w") as f:
        f.write(SOURCE + REDUCE_SOURCE + DECODE_SOURCE)
    subprocess.run([nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    lib.bytes_pass.argtypes = [p, i64, p, p]
    for fn in (lib.gridstride_quantize, lib.tile_quantize, lib.staged_quantize):
        fn.argtypes = [p, p, i64, i64, u32, p, p]
    for fn in (lib.cta_encode, lib.tile_encode, lib.staged_encode):
        fn.argtypes = [p, i64, u32, p, p, p]
    for name in REDUCE_VARIANTS:
        getattr(lib, name).argtypes = [ctypes.c_int, p, p, i64,
                                       ctypes.c_float, p, p]
    lib.decode_bytes.argtypes = [p, i64, p, p]
    lib.decode_set_variant.argtypes = [ctypes.c_int, p, ctypes.c_int,
                                       ctypes.c_uint64, ctypes.c_uint64, p]
    for name in REALIGN_VARIANTS:
        getattr(lib, name).argtypes = [p, p, i64, ctypes.c_float, p, p]
    timer = chip_smoke.Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream

    def events(fn, clean: bool) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(25):
            if clean:
                timer.flush.max()
            else:
                timer.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def alone(fn, names) -> str:
        ms = timer.device(fn, names)
        return "not measured" if ms is None else f"{ms:.4f} ms"

    decode_limits(torch, lib, kernels, events, alone, stream)
    if "--decode-only" in sys.argv[1:]:
        return 0

    g = torch.Generator(device="cuda").manual_seed(50)
    n_q, n_e = chip_smoke.BUCKET, 596 * 4096
    xq = torch.randn(n_q, device="cuda", generator=g) * 1e-2
    xe = torch.randn(n_e, device="cuda", generator=g) * 1e-2
    norm = torch.linalg.vector_norm(xq)
    bnorms = torch.linalg.vector_norm(xq.reshape(-1, 4096), dim=1)
    out = torch.empty(n_e, dtype=torch.int8, device="cuda")
    onorms = torch.empty(596, device="cuda")

    limits = []
    for n, x in ((n_q, xq), (n_e, xe)):
        limits.append((f"bytes pass n={n}",
                       lambda x=x, n=n: lib.bytes_pass(x.data_ptr(), n,
                                                       out.data_ptr(), stream),
                       ("bytes_pass_kernel",)))
        if n == n_q:
            limits.append((f"qsgd_quantize n={n} per tensor",
                           lambda: kernels.qsgd_quantize(xq, norm, 5, 127),
                           ("qsgd_quantize_kernel",)))
            limits.append((f"qsgd_quantize n={n} block 4096",
                           lambda: kernels.qsgd_quantize(xq, bnorms, 5, 127,
                                                         block=4096),
                           ("qsgd_quantize_kernel",)))
        else:
            limits.append((f"chunk_encode {n // 4096} blocks",
                           lambda: kernels.chunk_encode(xe, 5, 127),
                           ("ring_hop_kernel", "ring_encode_kernel")))
    for _ in range(2):
        for name, fn, names in limits:
            dirty, clean = events(fn, False), events(fn, True)
            print(f"limits {name}: dirty flush {dirty:.4f} ms, clean flush "
                  f"{clean:.4f} ms, alone (dirty) {alone(fn, names)}",
                  flush=True)

    # (name, the timed call, its kernel's name, a check against the plain
    # version that makes its own call).
    variants = []
    for block, nm in ((0, norm), (4096, bnorms)):
        want = kernels.qsgd_quantize_ref(xq, nm, 5, 127, block=block or None)
        how = "per tensor" if block == 0 else f"block {block}"
        for name, fn, kname in (
                ("grid-stride, one unhinted float4 a thread", lib.gridstride_quantize, "gridstride_quantize_kernel"),
                ("one wave of 2048-element tiles", lib.tile_quantize,
                 "tile_kernel"),
                ("cp.async-staged, 4 CTAs of 128 per SM, 4 stages",
                 lib.staged_quantize, "staged_kernel")):
            def run(fn=fn, nm=nm, block=block):
                return fn(xq.data_ptr(), nm.data_ptr(), n_q, block, 5,
                          out.data_ptr(), stream)

            def check(run=run, want=want):
                out.zero_()
                return run() == 0 and torch.equal(out[:n_q], want)
            variants.append((f"qsgd_quantize {how} {name}", run, kname,
                             check))

        def tree(nm=nm, block=block):
            return kernels.qsgd_quantize(xq, nm, 5, 127, block=block or None)
        variants.append((f"qsgd_quantize {how} (the tree)", tree,
                         "qsgd_quantize_kernel",
                         lambda tree=tree, want=want: torch.equal(tree(),
                                                                  want)))
    want_l, want_n = kernels.chunk_encode_ref(xe, 5, 127)
    for name, fn, kname in (
            ("one CTA of 256 per block, draw at the quantize", lib.cta_encode, "cta_encode_kernel"),
            ("one wave, draw while loading", lib.tile_encode, "tile_kernel"),
            ("cp.async-staged, 2 CTAs per SM, 2 stages", lib.staged_encode,
             "staged_kernel")):
        def run(fn=fn):
            return fn(xe.data_ptr(), n_e, 5, out.data_ptr(),
                      onorms.data_ptr(), stream)

        def check(run=run):
            out.zero_()
            return (run() == 0 and torch.equal(out, want_l)
                    and torch.equal(onorms.view(torch.int32),
                                    want_n.view(torch.int32)))
        variants.append((f"chunk_encode 596 blocks {name}", run, kname,
                         check))

    def tree_check():
        lv, nm = kernels.chunk_encode(xe, 5, 127)
        return (torch.equal(lv, want_l)
                and torch.equal(nm.view(torch.int32), want_n.view(torch.int32)))
    variants.append(("chunk_encode 596 blocks (the tree)",
                     lambda: kernels.chunk_encode(xe, 5, 127),
                     "ring_hop_kernel", tree_check))
    for _ in range(2):
        for name, run, kname, check in variants:
            if not check():
                raise AssertionError(f"{name}: differs from the plain version")
            print(f"variant {name}: {events(run, False):.4f} ms, alone "
                  f"{alone(run, (kname,))}", flush=True)
    reduce_limits(torch, lib, kernels, events, alone, stream)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


# The worker-axis reduce schedules (K = 4 rows): entry point, what it does,
# its kernel's name in a trace.
REDUCE_VARIANTS = {
    "reduce_word4": ("word columns, 4 words of each row a thread, uint4 "
                     "stores (the kept schedule)", "word_reduce_kernel"),
    "reduce_word2": ("word columns, 2 words of each row a thread, uint4 "
                     "stores", "word_reduce_kernel"),
    "reduce_vec_strided": ("16-byte loads, four uint4 stores at a 64-byte "
                           "lane stride", "vec_reduce_kernel"),
    "reduce_vec_smem": ("16-byte loads, shared-memory transpose, uint4 "
                        "stores", "vec_reduce_kernel"),
    "reduce_vec_smem2": ("16-byte loads of two tiles, shared-memory "
                         "transpose, uint4 stores", "vec_reduce_kernel"),
}
# Realignments of rows that are not 4-byte aligned (dequant_mean at
# VGG11-BN's 530 442-element unit, W = 4: rows 1 and 3 start 2-byte
# aligned): entry point, what it does.
REALIGN_VARIANTS = {
    "realign_per_word": "a branch on the row's alignment per word",
    "realign_per_row": "one branch on the row's alignment per row",
    "realign_shuffle": "one branch per row, the upper word from the next "
                       "lane by shuffle",
    "realign_unhinted": "one branch per row, no L2 prefetch hint",
}
# The schedule compress.cu's dequant_mean and int_accumulate keep.
KEPT_REDUCE = "reduce_word4"


def reduce_limits(torch, lib, kernels, events, alone, stream) -> None:
    """dequant_mean and int_accumulate at K = W = 4 over the 2 359 296
    bucket beside the same bytes (K int8 rows in, one 4-byte plane out) on
    the kept schedule, acc_decode beside its own bytes (4n in, 4n out) on
    its schedule; then the reduce schedules tried, each bit-checked."""
    import chip_smoke

    n = chip_smoke.BUCKET
    g = torch.Generator(device="cuda").manual_seed(60)
    lv = torch.randint(-127, 128, (4, n), device="cuda", generator=g).to(
        torch.int8)
    nm = torch.rand(4, device="cuda", generator=g) * 3
    acc = kernels.int_accumulate(lv)
    sc = torch.rand(1, device="cuda", generator=g) * 1e-3
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    factor = 1.0 / (127 * 4)

    def reduce_pass(entry, epi):
        return lambda: getattr(lib, entry)(epi, lv.data_ptr(), nm.data_ptr(),
                                           n, factor, out.data_ptr(), stream)

    limits = [
        (f"bytes pass [4, {n}] on the kept reduce schedule",
         reduce_pass(KEPT_REDUCE, 2), REDUCE_VARIANTS[KEPT_REDUCE][1]),
        (f"int_accumulate [4, {n}]", lambda: kernels.int_accumulate(lv),
         "int_accumulate_kernel"),
        (f"dequant_mean [4, {n}] per tensor",
         lambda: kernels.dequant_mean(lv, nm, 127), "dequant_mean_kernel"),
        (f"bytes pass {n} on acc_decode's schedule",
         lambda: lib.decode_bytes(acc.data_ptr(), n, out.data_ptr(), stream),
         "decode_bytes_kernel"),
        (f"acc_decode {n} per tensor (a decode set of one)",
         lambda: kernels.acc_decode(acc, sc, 4), "acc_decode_set_kernel"),
    ]
    for _ in range(2):
        for name, fn, kname in limits:
            dirty, clean = events(fn, False), events(fn, True)
            print(f"limits {name}: dirty flush {dirty:.4f} ms, clean flush "
                  f"{clean:.4f} ms, alone (dirty) {alone(fn, (kname,))}",
                  flush=True)

    want = {0: kernels.int_accumulate_ref(lv),
            1: kernels.dequant_mean_ref(lv, nm, 127).view(torch.int32)}
    tree = {0: ("int_accumulate", lambda: kernels.int_accumulate(lv),
                "int_accumulate_kernel"),
            1: ("dequant_mean", lambda: kernels.dequant_mean(lv, nm, 127),
                "dequant_mean_kernel")}
    variants = []
    for epi, (kname_tree, fn_tree, trace_tree) in tree.items():
        for entry, (what, kname) in REDUCE_VARIANTS.items():
            run = reduce_pass(entry, epi)

            def check(run=run, epi=epi):
                out.zero_()
                return run() == 0 and torch.equal(out, want[epi])
            variants.append((f"{kname_tree} [4, {n}] {what}", run, kname,
                             check))
        variants.append((
            f"{kname_tree} [4, {n}] (the tree)", fn_tree, trace_tree,
            lambda fn=fn_tree, epi=epi: torch.equal(
                fn().view(torch.int32), want[epi])))
    # The unit of 530 442: the interior tiles of each realignment against
    # the plain version, then timed beside the tree.
    m = chip_smoke.TAIL_CHUNK
    lvm = torch.randint(-127, 128, (4, m), device="cuda", generator=g).to(
        torch.int8)
    wantm = kernels.dequant_mean_ref(lvm, nm, 127).view(torch.int32)
    inner = slice(512, (m - 4) // 512 * 512)
    for entry, what in REALIGN_VARIANTS.items():
        def run(entry=entry):
            return getattr(lib, entry)(lvm.data_ptr(), nm.data_ptr(), m,
                                       factor, out.data_ptr(), stream)

        def check(run=run):
            out.zero_()
            return run() == 0 and torch.equal(out[inner], wantm[inner])
        variants.append((f"dequant_mean [4, {m}] {what}", run,
                         "realign_kernel", check))
    variants.append((
        f"dequant_mean [4, {m}] (the tree)",
        lambda: kernels.dequant_mean(lvm, nm, 127), "dequant_mean_kernel",
        lambda: torch.equal(kernels.dequant_mean(lvm, nm, 127).view(
            torch.int32), wantm)))
    for _ in range(2):
        for name, run, kname, check in variants:
            if not check():
                raise AssertionError(f"{name}: differs from the plain version")
            print(f"variant {name}: {events(run, False):.4f} ms, alone "
                  f"{alone(run, (kname,))}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
