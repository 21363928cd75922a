// Hopper (sm_90a) kernels of the gradient-compression hot path.
//
// Hand-written counterparts of the Pallas TPU kernels in
// ewdml_tpu/ops/pallas_kernels.py. Each is held bit for bit (quantize,
// block_top1, the ring hops, the server apply's int_accumulate and
// acc_decode) or within its stated bound (dequant_mean)
// against the plain PyTorch version beside its wrapper in
// ewdml_tpu_torch/ops/kernels.py.
// Every float operation that could be contracted into an FMA is written
// with an explicit round-to-nearest intrinsic, so the order of rounding is
// the one the TPU kernel and the plain version use.
//
// The interface is plain C (built with nvcc into a shared library, loaded
// with ctypes): each entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Counter-based uniform in [0, 1) from (flat index, seed): the murmur3
// finalizer of pallas_kernels._uniform_hash. The TPU kernel's counter
// b * 4096 + r * 128 + c is the flat element index, so this is a function of
// the index alone. uint32 arithmetic wraps exactly as jnp.uint32 does.
__device__ __forceinline__ float uniform_hash(uint32_t idx, uint32_t seed) {
  uint32_t x = (idx * 2654435761u) ^ seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  // x >> 8 < 2^24: exact in f32, and the scale by 2^-24 is exact.
  return __fmul_rn((float)(int32_t)(x >> 8), 1.0f / 16777216.0f);
}

// One element of pallas_kernels._quantize_kernel:
// sign(x) * (floor(s/norm * |x|) + [u < frac]) as int8, zero levels for a
// zero norm. The float-to-int8 conversion saturates, as XLA's does.
__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t idx, uint32_t seed) {
  float level_float = __fmul_rn(scale, fabsf(x));
  float previous = floorf(level_float);
  float frac = __fsub_rn(level_float, previous);
  float u = uniform_hash(idx, seed);
  float level = __fadd_rn(previous, u < frac ? 1.0f : 0.0f);
  float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  float v = __fmul_rn(sgn, level);
  v = fminf(fmaxf(v, -128.0f), 127.0f);
  return (int8_t)__float2int_rz(v);
}

__device__ __forceinline__ float safe_scale(float s, float norm) {
  return __fdiv_rn(s, norm == 0.0f ? 1.0f : norm);
}

// QSGD quantize: a grid-stride pass, four elements per thread with one
// 16-byte load and one 4-byte store. Blockwise norms need block % 4 == 0
// (the wrapper only passes multiples of 4096), so the four elements of a
// vector share one norm. Bound: 5n bytes of HBM traffic.
__global__ void qsgd_quantize_kernel(const float* __restrict__ x,
                                     const float* __restrict__ norms,
                                     int64_t n, int64_t block, uint32_t seed,
                                     float s, int8_t* __restrict__ out) {
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* out4 = reinterpret_cast<char4*>(out);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const int64_t i = v * 4;
    const float scale = safe_scale(s, norms[block ? i / block : 0]);
    const float4 xv = x4[v];
    char4 q;
    q.x = quantize_one(xv.x, scale, (uint32_t)i, seed);
    q.y = quantize_one(xv.y, scale, (uint32_t)(i + 1), seed);
    q.z = quantize_one(xv.z, scale, (uint32_t)(i + 2), seed);
    q.w = quantize_one(xv.w, scale, (uint32_t)(i + 3), seed);
    out4[v] = q;
  }
  // Ragged tail (n % 4 elements), one thread each.
  const int64_t t = nvec * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const float scale = safe_scale(s, norms[block ? t / block : 0]);
    out[t] = quantize_one(x[t], scale, (uint32_t)t, seed);
  }
}

// Dequantize + mean over W gathered payloads: each thread owns four
// consecutive elements and walks the W workers in order, accumulating
// norm[w, b] * level in the TPU kernel's order, then scales by
// 1 / (s * W). Bound: (W + 4) * n bytes.
__global__ void dequant_mean_kernel(const int8_t* __restrict__ levels,
                                    const float* __restrict__ norms,
                                    int world, int64_t n, int64_t nb,
                                    int64_t block, float factor,
                                    float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t base = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       base < n; base += stride) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < world; ++w) {
      const int8_t* row = levels + (int64_t)w * n;
      const float* wn = norms + (int64_t)w * nb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = base + j;
        if (i < n) {
          const float nm = wn[block ? i / block : 0];
          acc[j] = __fadd_rn(acc[j], __fmul_rn(nm, (float)row[i]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base + j < n) out[base + j] = __fmul_rn(acc[j], factor);
    }
  }
}

// Strided block-top-1: one thread per column of the row-major (R, C)
// matrix, walking the R rows; a warp reads 32 neighbouring columns of one
// row per step (coalesced). The strict '>' keeps the first row of the
// column maximum, as the TPU kernel's min-over-hit-rows does, and the
// winner is written as v + 0 like the TPU kernel's masked sum (-0 -> +0).
// Bound: 4 * R * C bytes read.
__global__ void block_top1_kernel(const float* __restrict__ x, int rows,
                                  int cols, float* __restrict__ vals,
                                  int32_t* __restrict__ locs) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float best = fabsf(x[c]);
  float val = x[c];
  int loc = 0;
  for (int r = 1; r < rows; ++r) {
    const float v = x[(int64_t)r * cols + c];
    const float a = fabsf(v);
    if (a > best) {
      best = a;
      val = v;
      loc = r;
    }
  }
  vals[c] = __fadd_rn(val, 0.0f);
  locs[c] = loc;
}

// The fused ring hops: chunk_encode (pallas_kernels.py:431) and
// dequant_acc_requant (pallas_kernels.py:479), one kernel body for both.
// One thread block owns one quantization block of `block` elements with
// T = block / 16 threads (256 for the 4096-element block); thread t holds
// the 16 elements 4 * (t + T * j) + c (j, c in 0..3) in registers, read with
// four 16-byte loads (neighbouring threads on neighbouring addresses). The
// block's L2 norm is reduced in one fixed order: per thread in (j, c) order
// from 0, then a halving tree over each warp's lanes (offsets 16 ... 1,
// shuffles), then a halving tree over the T / 32 warp sums (offsets
// T / 64 ... 1, in the first warp), then a correctly rounded sqrt. The
// block is then quantized from the registers. So the input is read from
// HBM once, and a hop's f32 partial sum never reaches HBM, as in the TPU
// kernels; the plain versions (block_norms_ref, chunk_encode_ref,
// dequant_acc_requant_ref) repeat that order, so the two agree bit for bit.
// A hop computes (local + (norm[b] * (1/s)) * level) * scale per element.
// Padding past n enters as zeros (adds nothing to the norm, never stored).
// Bound: HBM bytes, 5n + 4nb for the encode and 6n + 8nb for a hop.
constexpr int kRingVec = 16;  // elements per thread

__device__ __forceinline__ float hop_value(float local, int8_t level,
                                           float coef, float scale) {
  return __fmul_rn(__fadd_rn(local, __fmul_rn(coef, (float)level)), scale);
}

template <bool kHop>
__global__ void ring_encode_kernel(const float* __restrict__ x,
                                   const int8_t* __restrict__ in_levels,
                                   const float* __restrict__ in_norms,
                                   float inv_s, float scale, int64_t n,
                                   uint32_t seed, float s,
                                   int8_t* __restrict__ out,
                                   float* __restrict__ out_norms) {
  __shared__ float warp_sums[32];
  __shared__ float block_norm;
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t b = blockIdx.x;
  const int64_t first = b * (int64_t)threads * kRingVec;
  float coef = 0.0f;
  if constexpr (kHop) coef = __fmul_rn(in_norms[b], inv_s);

  float v[kRingVec];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
    float e[4];
    if (i + 4 <= n) {
      const float4 xv = *reinterpret_cast<const float4*>(x + i);
      e[0] = xv.x;
      e[1] = xv.y;
      e[2] = xv.z;
      e[3] = xv.w;
      if constexpr (kHop) {
        const char4 lv = *reinterpret_cast<const char4*>(in_levels + i);
        e[0] = hop_value(e[0], lv.x, coef, scale);
        e[1] = hop_value(e[1], lv.y, coef, scale);
        e[2] = hop_value(e[2], lv.z, coef, scale);
        e[3] = hop_value(e[3], lv.w, coef, scale);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = i + c < n;
        e[c] = in ? x[i + c] : 0.0f;
        if constexpr (kHop) {
          e[c] = hop_value(e[c], in ? in_levels[i + c] : (int8_t)0, coef,
                           scale);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[4 * j + c] = e[c];
      ss = __fadd_rn(ss, __fmul_rn(e[c], e[c]));
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
  }
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int warps = threads >> 5;
    float w = lane < warps ? warp_sums[lane] : 0.0f;
    for (int off = warps >> 1; off > 0; off >>= 1) {
      w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, off));
    }
    if (lane == 0) {
      const float norm = __fsqrt_rn(w);
      block_norm = norm;
      out_norms[b] = norm;
    }
  }
  __syncthreads();

  const float qscale = safe_scale(s, block_norm);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
    int8_t q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q[c] = quantize_one(v[4 * j + c], qscale, (uint32_t)(i + c), seed);
    }
    if (i + 4 <= n) {
      *reinterpret_cast<char4*>(out + i) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i + c < n) out[i + c] = q[c];
      }
    }
  }
}

// The compressed-domain server apply (--server-agg homomorphic):
// int_accumulate (pallas_kernels.py:587) and acc_decode
// (pallas_kernels.py:629). Neither draws random bits, and the accumulate is
// exact integer arithmetic, so both are bit-equal to their plain versions
// by construction.
//
// int_accumulate: the exact int32 sum of K int8 planes [K, n]. One thread
// owns 16 consecutive output elements and walks the K rows in order. Row w
// starts at byte w * n, so the 16-byte vector loads are legal only when n
// and the base address are multiples of 16 (kVec); otherwise every load is
// a single byte. Bound: K * n + 4 * n bytes.
constexpr int kAccVec = 16;  // elements per thread of int_accumulate

template <bool kVec>
__global__ void int_accumulate_kernel(const int8_t* __restrict__ levels,
                                      int world, int64_t n,
                                      int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t * kAccVec < n; t += stride) {
    const int64_t base = t * kAccVec;
    int32_t acc[kAccVec];
#pragma unroll
    for (int j = 0; j < kAccVec; ++j) acc[j] = 0;
    for (int w = 0; w < world; ++w) {
      const int8_t* row = levels + (int64_t)w * n + base;
      if constexpr (kVec) {
        const int4 v = *reinterpret_cast<const int4*>(row);
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < kAccVec; ++j) acc[j] += (int32_t)b[j];
      } else {
#pragma unroll
        for (int j = 0; j < kAccVec; ++j) {
          if (base + j < n) acc[j] += (int32_t)row[j];
        }
      }
    }
    if constexpr (kVec) {
      int4* o = reinterpret_cast<int4*>(out + base);
#pragma unroll
      for (int q = 0; q < kAccVec / 4; ++q) {
        o[q] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kAccVec; ++j) {
        if (base + j < n) out[base + j] = acc[j];
      }
    }
  }
}

// acc_decode: out = f32(acc) * (scale[b] * inv_k), the factor formed once per
// element's block in that order and every product rounded on its own (no
// FMA), as the TPU kernel and the plain version do. `inv_k` is 1/k rounded
// to f32 on the host. Four elements per thread with one 16-byte load and
// store; a blockwise scale needs block % 4 == 0 (the wrapper passes
// multiples of 4096), so the four share one scale. Bound: 8n bytes.
__device__ __forceinline__ float decode_one(int32_t a, float factor) {
  return __fmul_rn(__int2float_rn(a), factor);
}

__global__ void acc_decode_kernel(const int32_t* __restrict__ acc,
                                  const float* __restrict__ scales,
                                  float inv_k, int64_t n, int64_t block,
                                  float* __restrict__ out) {
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int4* a4 = reinterpret_cast<const int4*>(acc);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const int64_t i = v * 4;
    const float factor = __fmul_rn(scales[block ? i / block : 0], inv_k);
    const int4 a = a4[v];
    o4[v] = make_float4(decode_one(a.x, factor), decode_one(a.y, factor),
                        decode_one(a.z, factor), decode_one(a.w, factor));
  }
  const int64_t t = nvec * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    out[t] = decode_one(acc[t],
                        __fmul_rn(scales[block ? t / block : 0], inv_k));
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond ~16 per SM
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

int ewdml_qsgd_quantize(const float* x, const float* norms, int64_t n,
                        int64_t block, uint32_t seed, int s, int8_t* out,
                        cudaStream_t stream) {
  if (n > 0) {
    qsgd_quantize_kernel<<<grid_for(n / 4 + 1), kThreads, 0, stream>>>(
        x, norms, n, block, seed, (float)s, out);
  }
  return (int)cudaGetLastError();
}

int ewdml_dequant_mean(const int8_t* levels, const float* norms, int world,
                       int64_t n, int64_t nb, int64_t block, float factor,
                       float* out, cudaStream_t stream) {
  if (n > 0) {
    dequant_mean_kernel<<<grid_for((n + 3) / 4), kThreads, 0, stream>>>(
        levels, norms, world, n, nb, block, factor, out);
  }
  return (int)cudaGetLastError();
}

int ewdml_block_top1(const float* x, int rows, int cols, float* vals,
                     int32_t* locs, cudaStream_t stream) {
  if (cols > 0) {
    block_top1_kernel<<<(cols + 127) / 128, 128, 0, stream>>>(x, rows, cols,
                                                              vals, locs);
  }
  return (int)cudaGetLastError();
}

// `block` is a multiple of 4096 and at most 16384 (T <= 1024 threads);
// the wrapper checks both.
int ewdml_chunk_encode(const float* x, int64_t n, int64_t block,
                       uint32_t seed, int s, int8_t* levels, float* norms,
                       cudaStream_t stream) {
  if (n > 0) {
    const int64_t nb = (n + block - 1) / block;
    ring_encode_kernel<false><<<(unsigned)nb, (unsigned)(block / kRingVec), 0,
                                stream>>>(x, nullptr, nullptr, 0.0f, 1.0f, n,
                                          seed, (float)s, levels, norms);
  }
  return (int)cudaGetLastError();
}

int ewdml_dequant_acc_requant(const int8_t* levels, const float* norms,
                              const float* local, int64_t n, int64_t block,
                              uint32_t seed, int s, float inv_s, float scale,
                              int8_t* out, float* out_norms,
                              cudaStream_t stream) {
  if (n > 0) {
    const int64_t nb = (n + block - 1) / block;
    ring_encode_kernel<true><<<(unsigned)nb, (unsigned)(block / kRingVec), 0,
                               stream>>>(local, levels, norms, inv_s, scale, n,
                                         seed, (float)s, out, out_norms);
  }
  return (int)cudaGetLastError();
}

// `vec` != 0 only when n % 16 == 0 and `levels` is 16-byte aligned (the
// wrapper decides).
int ewdml_int_accumulate(const int8_t* levels, int world, int64_t n, int vec,
                         int32_t* out, cudaStream_t stream) {
  if (n > 0) {
    const int grid = grid_for((n + kAccVec - 1) / kAccVec);
    if (vec) {
      int_accumulate_kernel<true><<<grid, kThreads, 0, stream>>>(levels, world,
                                                                 n, out);
    } else {
      int_accumulate_kernel<false><<<grid, kThreads, 0, stream>>>(
          levels, world, n, out);
    }
  }
  return (int)cudaGetLastError();
}

// `block` is 0 (one scale) or a multiple of 4096; `acc` is 16-byte aligned.
int ewdml_acc_decode(const int32_t* acc, const float* scales, float inv_k,
                     int64_t n, int64_t block, float* out,
                     cudaStream_t stream) {
  if (n > 0) {
    acc_decode_kernel<<<grid_for(n / 4 + 1), kThreads, 0, stream>>>(
        acc, scales, inv_k, n, block, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
