// Hopper (sm_90a) kernels of the gradient-compression hot path.
//
// Hand-written counterparts of the Pallas TPU kernels in
// ewdml_tpu/ops/pallas_kernels.py. Each is held bit for bit (quantize,
// block_top1) or within its stated bound (dequant_mean) against the plain
// PyTorch version beside its wrapper in ewdml_tpu_torch/ops/kernels.py.
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

}  // extern "C"
