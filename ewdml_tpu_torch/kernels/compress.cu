// Hopper (sm_90a) kernels of the gradient-compression hot path.
//
// Hand-written counterparts of the Pallas TPU kernels in
// ewdml_tpu/ops/pallas_kernels.py. Each is held bit for bit against the
// plain PyTorch version beside its wrapper in
// ewdml_tpu_torch/ops/kernels.py.
// Every float operation that could be contracted into an FMA is written
// with an explicit round-to-nearest intrinsic, so the order of rounding is
// the one the TPU kernel and the plain version use.
//
// The interface is plain C (built with nvcc into a shared library, loaded
// with ctypes): each entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// Counter-based uniform in [0, 1) from (flat index, seed): the murmur3
// finalizer of pallas_kernels._uniform_hash. The TPU kernel's counter
// b * 4096 + r * 128 + c is the flat element index, so this is a function of
// the index alone. uint32 arithmetic wraps exactly as jnp.uint32 does.
// The kernels that draw read their seed from device memory (a slot of the
// step's key table), once per thread: a CUDA graph that captured a launch
// then draws a new stream on each replay.
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

// One element of pallas_kernels._quantize_kernel, given its uniform u:
// sign(x) * (floor(s/norm * |x|) + [u < frac]) as int8, zero levels for a
// zero norm. The float-to-int8 conversion saturates, as XLA's does.
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

__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t idx, uint32_t seed) {
  return quantize_level(x, scale, uniform_hash(idx, seed));
}

__device__ __forceinline__ float safe_scale(float s, float norm) {
  return __fdiv_rn(s, norm == 0.0f ? 1.0f : norm);
}

// A 16-byte load of data read once: it bypasses L1 (so the L1 lines of a
// blockwise norm stay) and asks L2 for 256 bytes at a time.
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// QSGD quantize (pallas_kernels.py:169, _quantize_kernel :138): a
// grid-stride pass, four elements per thread with one 16-byte load and one
// 4-byte store, at most 16 CTAs of 256 threads per SM. Bound: 5n bytes of
// HBM traffic, 0.0035 ms for the 2 359 296-element bucket; the ~25
// instructions an element takes would fill half of that at the instruction rate.
// With 64 warps on every SM, some warps' loads are in flight while others
// draw and quantize, and the draw (a function of the index and the seed)
// does not wait for the load, so the arithmetic hides under the bytes: on
// the H100 the kernel takes within 0.0007 ms of the same schedule with a
// sign in place of the quantize, which moves the same bytes. Schedules that
// put 16 elements per thread in one resident wave, or stage tiles through
// shared memory with cp.async, were no faster at the bucket and slower at
// smaller sizes (PERF.md; scripts/kernel_limits.py). What the design saves
// is per-vector work in blockwise mode: the norm is indexed in 32-bit
// arithmetic (vectors per norm; the wrapper passes only blocks that are
// multiples of 4096, so the four elements of a vector share one norm) and
// stays in L1 (load_once); per tensor the scale is formed once per thread.
__global__ void qsgd_quantize_kernel(const float* __restrict__ x,
                                     const float* __restrict__ norms,
                                     int64_t n, int vecs_per_norm,
                                     const uint32_t* __restrict__ seed_ptr,
                                     float s, int8_t* __restrict__ out) {
  const uint32_t seed = __ldg(seed_ptr);
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* out4 = reinterpret_cast<char4*>(out);
  const float tensor_scale = vecs_per_norm ? 0.0f : safe_scale(s, norms[0]);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const float4 xv = load_once(x4 + v);
    const uint32_t i = (uint32_t)(v * 4);
    const float scale =
        vecs_per_norm
            ? safe_scale(s, norms[(uint32_t)v / (uint32_t)vecs_per_norm])
            : tensor_scale;
    out4[v] = make_char4(quantize_one(xv.x, scale, i, seed),
                         quantize_one(xv.y, scale, i + 1, seed),
                         quantize_one(xv.z, scale, i + 2, seed),
                         quantize_one(xv.w, scale, i + 3, seed));
  }
  // Ragged tail (n % 4 elements), one thread each.
  const int64_t t = nvec * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const float scale =
        vecs_per_norm
            ? safe_scale(s, norms[(uint32_t)(t / 4) / (uint32_t)vecs_per_norm])
            : tensor_scale;
    out[t] = quantize_one(x[t], scale, (uint32_t)t, seed);
  }
}

// Strided block-top-1 (pallas_kernels.py:290, block_top1): per column of
// the row-major (R, C) matrix, the signed value and the first row of the
// largest |x|. Bound: 4RC + 8C bytes of HBM traffic, a few microseconds at
// the path's shapes, so the time is the latency of getting every row of a
// column in flight. A thread block owns 32 neighbouring columns (one per
// lane, so a warp reads 128 contiguous bytes of one row) and splits their
// R rows into 8 slices of R / 8 rows (one per warp; R % 8 == 0). A thread
// issues the loads of up to kTop1Rows rows before its first compare, so a
// column's rows are all in flight at once for R <= 128 (the 1% ratio has
// R = 104), and (C / 32) blocks cover the 132 SMs at every path shape.
// Within a slice the strict '>' over ascending rows keeps the first row of
// the slice maximum; the slices are then combined in ascending order with
// the same strict '>', so the result is the first row of the column
// maximum, as the TPU kernel's min-over-hit-rows gives. NaN never wins.
// The winner is written as v + 0 like the TPU kernel's masked sum
// (-0 -> +0).
constexpr int kTop1Cols = 32;    // columns per thread block, one per lane
constexpr int kTop1Slices = 8;   // row slices per column, one per warp
constexpr int kTop1Rows = 16;    // row loads a thread has in flight

__global__ void __launch_bounds__(kTop1Cols * kTop1Slices)
    block_top1_kernel(const float* __restrict__ x, int rows, int cols,
                      float* __restrict__ vals, int32_t* __restrict__ locs) {
  __shared__ float s_abs[kTop1Slices][kTop1Cols];
  __shared__ float s_val[kTop1Slices][kTop1Cols];
  __shared__ int s_loc[kTop1Slices][kTop1Cols];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int c = blockIdx.x * kTop1Cols + lane;
  const int per = rows / kTop1Slices;
  const int lo = slice * per;
  const int hi = lo + per;
  float best = -1.0f;
  float val = 0.0f;
  int loc = lo;
  for (int r0 = lo; r0 < hi; r0 += kTop1Rows) {
    float v[kTop1Rows];
#pragma unroll
    for (int k = 0; k < kTop1Rows; ++k) {
      v[k] = r0 + k < hi ? __ldg(x + (int64_t)(r0 + k) * cols + c) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kTop1Rows; ++k) {
      const float a = fabsf(v[k]);
      if (r0 + k < hi && a > best) {
        best = a;
        val = v[k];
        loc = r0 + k;
      }
    }
  }
  s_abs[slice][lane] = best;
  s_val[slice][lane] = val;
  s_loc[slice][lane] = loc;
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int k = 1; k < kTop1Slices; ++k) {
      const float a = s_abs[k][lane];
      if (a > best) {
        best = a;
        val = s_val[k][lane];
        loc = s_loc[k][lane];
      }
    }
    vals[c] = __fadd_rn(val, 0.0f);
    locs[c] = loc;
  }
}

// The fused ring kernels: chunk_encode (pallas_kernels.py:431) and the
// hop dequant_acc_requant (pallas_kernels.py:479). One quantization block of
// `block` elements is spread over T = block / 16 threads (256 for the
// 4096-element block); thread t holds the 16 elements 4 * (t + T * j) + c
// (j, c in 0..3) in registers. The block's L2 norm is reduced in one fixed
// order: per thread in (j, c) order from 0, then a halving tree over each
// warp's lanes (offsets 16 ... 1, shuffles), then a halving tree over the
// T / 32 warp sums (offsets tree_top(T / 32) ... 1), then a correctly
// rounded sqrt. The block is then quantized from the registers. So the
// input is read from HBM once, and a hop's f32 partial sum never reaches
// HBM, as in the TPU kernels; the plain versions (block_norms_ref,
// chunk_encode_ref, dequant_acc_requant_ref) repeat that order, so the two
// agree bit for bit. A hop computes (local + (norm[b] * (1/s)) * level) *
// scale per element. Padding past n enters as zeros (adds nothing to the
// norm, never stored). Bound: HBM bytes, 5n + 4nb for the encode and
// 6n + 8nb for a hop.
constexpr int kRingVec = 16;  // elements per thread

// The first offset of the halving tree over `warps` warp sums: half the
// next power of two, so that a count that is no power of two (24 warps for
// a block of 12288) still sums every warp (the lanes past it add zeros).
__host__ __device__ constexpr int tree_top(int warps) {
  int p = 1;
  while (p < warps) p <<= 1;
  return p >> 1;
}

__device__ __forceinline__ void store_c4(int8_t* __restrict__ out, int64_t i,
                                         int64_t n, char4 q) {
  if (i + 4 <= n) {
    *reinterpret_cast<char4*>(out + i) = q;
  } else {
    const int8_t e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (i + c < n) out[i + c] = e[c];
    }
  }
}

__device__ __forceinline__ float hop_value(float local, int8_t level,
                                           float coef, float scale) {
  return __fmul_rn(__fadd_rn(local, __fmul_rn(coef, (float)level)), scale);
}

// The hop on a chunk of more than kHopClusterMaxBlocks blocks: one CTA of T
// threads per block, the uniforms drawn at the quantize (40 registers, 6
// CTAs per SM: fused_q's 596 blocks in one wave).
__global__ void ring_encode_kernel(const float* __restrict__ x,
                                   const int8_t* __restrict__ in_levels,
                                   const float* __restrict__ in_norms,
                                   float inv_s, float scale, int64_t n,
                                   const uint32_t* __restrict__ seed_ptr,
                                   float s, int8_t* __restrict__ out,
                                   float* __restrict__ out_norms) {
  __shared__ float warp_sums[32];
  __shared__ float block_norm;
  const uint32_t seed = __ldg(seed_ptr);
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t b = blockIdx.x;
  const int64_t first = b * (int64_t)threads * kRingVec;
  const float coef = __fmul_rn(in_norms[b], inv_s);

  float v[kRingVec];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
    float e[4];
    if (i + 4 <= n) {
      const float4 xv = *reinterpret_cast<const float4*>(x + i);
      const char4 lv = *reinterpret_cast<const char4*>(in_levels + i);
      e[0] = hop_value(xv.x, lv.x, coef, scale);
      e[1] = hop_value(xv.y, lv.y, coef, scale);
      e[2] = hop_value(xv.z, lv.z, coef, scale);
      e[3] = hop_value(xv.w, lv.w, coef, scale);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = i + c < n;
        e[c] = hop_value(in ? x[i + c] : 0.0f,
                         in ? in_levels[i + c] : (int8_t)0, coef, scale);
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
    for (int off = tree_top(warps); off > 0; off >>= 1) {
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
    store_c4(out, i, n, make_char4(q[0], q[1], q[2], q[3]));
  }
}

// chunk_encode at every size, and the hop on a chunk of at most
// kHopClusterMaxBlocks blocks (every ring_rs chunk of VGG11-BN: 1 to 144
// blocks of 4096). The bound there is at most 0.0011 ms, under the
// ~0.005 ms a launch takes, so the time is the latency of one block's
// chain: load, norm, hash and quantize, store. The kernel shortens that
// chain in two ways.
// - Early draw: the uniforms depend on the element's index and the seed
//   alone, so each thread draws its 16 while its loads are in flight, and
//   only the quantize arithmetic waits for the norm. The 16 uniforms cost
//   16 registers (55 a thread for the encode, 56 for the hop).
// - A block's T threads are spread over a thread-block cluster of
//   kHopCluster = 2 CTAs on two SMs (thread t = rank * blockDim.x +
//   threadIdx.x keeps its elements and its place in the norm order), so
//   each SM runs half of the block's arithmetic. The warp sums cross the
//   cluster through distributed shared memory: lane r of each warp pushes
//   the warp's sum into CTA r's `warp_sums` with an asynchronous remote
//   store that completes on CTA r's mbarrier, and each CTA waits on its own
//   mbarrier for all T / 32 sums, then runs the same tree over its own
//   copy, so all CTAs quantize with the same norm bits; rank 0 stores the
//   norm. A CTA leaves only after every store into its shared memory has
//   landed, and no CTA reads a peer's, so none exits while a peer still
//   needs it. The relaxed cluster arrive at the start, waited for just
//   before the first remote store, guarantees that every peer has started
//   and initialised its mbarrier.
// kHop selects the hop (levels and norms in, decode-accumulate before the
// norm) or chunk_encode (the chunk itself is the block's values).
// On fused_q's 596 blocks the encode also runs faster this way than one CTA
// of 256 per block, with the draw at the quantize or early (PERF.md): its
// CTAs of 128 threads spread the blocks over the SMs more evenly, and the
// card holds nearly all of them at once. The hop's does not (measured):
// with the levels array its CTAs need a second wave, so above
// kHopClusterMaxBlocks, two blocks per SM of the H100's 132, the hop takes
// ring_encode_kernel. That switch only has to separate the ring_rs chunks
// (at most 144 blocks) from the fused_q chunk (596), since the training
// paths make no chunk in between.
constexpr int kHopCluster = 2;  // CTAs per quantization block
constexpr int64_t kHopClusterMaxBlocks = 2 * 132;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of `local_addr` (this CTA's shared memory) in CTA `rank` of
// the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local_addr,
                                              uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local_addr), "r"(rank));
  return out;
}

template <bool kHop>
__global__ void __cluster_dims__(kHopCluster, 1, 1)
    ring_hop_kernel(const float* __restrict__ local,
                    const int8_t* __restrict__ in_levels,
                    const float* __restrict__ in_norms, float inv_s,
                    float scale, int64_t n,
                    const uint32_t* __restrict__ seed_ptr, float s,
                    int8_t* __restrict__ out, float* __restrict__ out_norms) {
  __shared__ float warp_sums[32];
  __shared__ alignas(8) uint64_t sums_ready;  // mbarrier of the exchange
  const uint32_t seed = __ldg(seed_ptr);
  const int rank = (int)cg::this_cluster().block_rank();
  const int threads = blockDim.x * kHopCluster;
  const int warps = threads >> 5;
  const int t = rank * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x / kHopCluster;
  const int64_t first = b * (int64_t)threads * kRingVec;
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n"
        "fence.mbarrier_init.release.cluster;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :
        : "r"(smem_u32(&sums_ready)), "r"(4 * warps)
        : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float4 x4[4];
  char4 l4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
    if (i + 4 <= n) {
      x4[j] = *reinterpret_cast<const float4*>(local + i);
      if constexpr (kHop) {
        l4[j] = *reinterpret_cast<const char4*>(in_levels + i);
      }
    } else {
      float e[4];
      int8_t q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = i + c < n;
        e[c] = in ? local[i + c] : 0.0f;
        if constexpr (kHop) q[c] = in ? in_levels[i + c] : (int8_t)0;
      }
      x4[j] = make_float4(e[0], e[1], e[2], e[3]);
      if constexpr (kHop) l4[j] = make_char4(q[0], q[1], q[2], q[3]);
    }
  }
  float coef = 0.0f;
  if constexpr (kHop) coef = __fmul_rn(in_norms[b], inv_s);
  float u[kRingVec];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      u[4 * j + c] = uniform_hash((uint32_t)(i + c), seed);
    }
  }

  float v[kRingVec];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kHop) {
      v[4 * j] = hop_value(x4[j].x, l4[j].x, coef, scale);
      v[4 * j + 1] = hop_value(x4[j].y, l4[j].y, coef, scale);
      v[4 * j + 2] = hop_value(x4[j].z, l4[j].z, coef, scale);
      v[4 * j + 3] = hop_value(x4[j].w, l4[j].w, coef, scale);
    } else {
      v[4 * j] = x4[j].x;
      v[4 * j + 1] = x4[j].y;
      v[4 * j + 2] = x4[j].z;
      v[4 * j + 3] = x4[j].w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ss = __fadd_rn(ss, __fmul_rn(v[4 * j + c], v[4 * j + c]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_down_sync(0xffffffffu, ss, off));
  }
  ss = __shfl_sync(0xffffffffu, ss, 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane < kHopCluster) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];\n"
        :
        : "r"(peer_addr(smem_u32(&warp_sums[t >> 5]), lane)),
          "r"(__float_as_uint(ss)),
          "r"(peer_addr(smem_u32(&sums_ready), lane))
        : "memory");
  }
  asm volatile(
      "{\n"
      ".reg .pred ready;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], 0;\n"
      "@!ready bra WAIT;\n"
      "}\n"
      :
      : "r"(smem_u32(&sums_ready))
      : "memory");
  float w = lane < warps ? warp_sums[lane] : 0.0f;
  for (int off = tree_top(warps); off > 0; off >>= 1) {
    w = __fadd_rn(w, __shfl_down_sync(0xffffffffu, w, off));
  }
  const float norm = __shfl_sync(0xffffffffu, __fsqrt_rn(w), 0);
  if (rank == 0 && threadIdx.x == 0) out_norms[b] = norm;

  const float qscale = safe_scale(s, norm);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = first + 4 * ((int64_t)t + (int64_t)threads * j);
    store_c4(out, i, n,
             make_char4(quantize_level(v[4 * j], qscale, u[4 * j]),
                        quantize_level(v[4 * j + 1], qscale, u[4 * j + 1]),
                        quantize_level(v[4 * j + 2], qscale, u[4 * j + 2]),
                        quantize_level(v[4 * j + 3], qscale, u[4 * j + 3])));
  }
}

// The compressed-domain server apply (--server-agg homomorphic):
// int_accumulate (pallas_kernels.py:587) here, and its decode
// (pallas_kernels.py:629) in decode.cu, one launch for every quantized
// leaf of an apply. Neither draws random bits, and the accumulate is
// exact integer arithmetic, so both are bit-equal to their plain versions
// by construction.
//
// The worker-axis reduce of dequant_mean (pallas_kernels.py:232) and
// int_accumulate (pallas_kernels.py:587): K int8 rows [K, n] in, one 4-byte
// plane [n] out. Bound: K * n + 4 * n bytes of HBM traffic (0.0056 ms at
// K = 4 over the 2 359 296-element bucket); a few operations a byte.
// - Word columns. A warp owns a tile of kReduceTile = 512 elements: lane l
//   loads the 4-byte words 4 (l + 32 j), j < 4, of every row (a warp load
//   covers 128 contiguous bytes of a row) and stores the four outputs of
//   each word as one uint4 (a warp store covers 512 contiguous bytes).
//   16-byte loads give a thread 16 consecutive outputs, which it can only
//   store at a 64-byte lane stride (~0.004 ms slower at the bucket on the
//   H100) or through
//   a shared-memory transpose (no faster than word columns); two words a
//   lane instead of four are no faster either (PERF.md;
//   scripts/kernel_limits.py).
// - All rows in flight. K is a template parameter for K <= 8, so a thread
//   issues the 4 K loads of a tile before its first add; other K take the
//   rows four at a time. Loads skip L1 and fetch 256 B into L2.
// - One resident wave: the grid is the CTAs the card holds at once (or
//   fewer), and the warps stride over the tiles, so no warp takes more than
//   one tile beyond any other's.
// - Scales hoisted (dequant_mean): per tensor the K norms are read once per
//   thread; blockwise (a multiple of 4096 elements, so a tile never crosses
//   a block) one 32-bit block index per tile, its K norm loads issued with
//   the level loads.
// - Rows not 4-byte aligned (row w starts at byte w * n; VGG11-BN's unit of
//   530 442 elements puts rows 1 and 3 on 2-byte boundaries): a lane loads
//   the aligned word below each of its words, takes the word above from
//   the next lane with a shuffle once every load of the tile is issued, and
//   realigns the pair in registers (__funnelshift_r); lane 31 loads one
//   word more. No load leaves [levels, levels + K n): in the first
//   and last tiles each word load is predicated on lying inside it, and an
//   aligned word that straddles either end (a base or an end that is not
//   4-byte aligned) is read a byte at a time after all the tile's other
//   loads are issued, and only in a tile that holds such a word: an edge
//   tile runs on one warp, so its extra instructions, or a load it waits
//   on before the next word's loads issue, add straight to the kernel's
//   time (about 0.001 and 0.004 ms at the 530 442 unit in builds that had
//   them; PERF.md).
// dequant_mean accumulates acc = acc + norm[w, b] * level in w order from 0,
// every product and sum rounded on its own, then acc * factor: the order of
// dequant_mean_ref, so the two are bit-equal. The accumulate is exact.
constexpr int kReduceWords = 4;                         // words a lane, a row
constexpr int kReduceTile = 32 * 4 * kReduceWords;      // elements a warp tile
constexpr int kReduceThreads = 128;

struct ReduceArgs {
  const int8_t* levels;  // [world, n]
  const float* norms;    // dequant_mean: [world, nb]
  int world;
  int64_t n;
  int64_t nb;
  int tiles_per_block;   // dequant_mean blockwise: block / kReduceTile; else 0
  float factor;          // dequant_mean: f32(1 / (s * world))
  uint32_t* out;         // [n] f32 or int32
};

__device__ __forceinline__ uint32_t load_word_once(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];"
      : "=r"(v)
      : "l"(p));
  return v;
}

// The aligned word at `p` (read once, skipping L1, 256 B fetched into L2).
__device__ __forceinline__ uint32_t aligned_word(const int8_t* p) {
  return load_word_once(reinterpret_cast<const uint32_t*>(p));
}

// The words of the first and last tiles. Every load there is predicated on
// lying wholly inside the buffer [lo, hi) (words outside read as 0), so the
// loads of a tile are still all issued before their first use. Bytes past a
// row's end but inside the buffer are read and not stored.
__device__ __forceinline__ bool word_inside(uintptr_t q, uintptr_t lo,
                                            uintptr_t hi) {
  return q >= lo && q + 4 <= hi;
}

template <bool kAligned>
__device__ __forceinline__ uint32_t edge_word(const int8_t* p, uintptr_t lo,
                                              uintptr_t hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint32_t r = kAligned ? 0u : (uint32_t)(addr & 3);
  const uintptr_t q = addr - r;
  const uint32_t a =
      word_inside(q, lo, hi)
          ? load_word_once(reinterpret_cast<const uint32_t*>(q)) : 0u;
  if constexpr (kAligned) return a;
  const uint32_t b =
      r && word_inside(q + 4, lo, hi)
          ? load_word_once(reinterpret_cast<const uint32_t*>(q + 4)) : 0u;
  return __funnelshift_r(a, b, 8 * r);
}

// The one-byte path: an aligned word that straddles `lo` (a base that is not
// 4-byte aligned) or `hi` (an end that is not) is read a byte at a time.
__device__ __forceinline__ bool word_straddles(uintptr_t q, uintptr_t lo,
                                               uintptr_t hi) {
  return (q < lo && q + 4 > lo) || (q < hi && q + 4 > hi);
}

__device__ __forceinline__ uint32_t word_bytes(uintptr_t q, uintptr_t lo,
                                               uintptr_t hi) {
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (q + c >= lo && q + c < hi) {
      w |= (uint32_t)(uint8_t)__ldg(reinterpret_cast<const int8_t*>(q + c))
           << (8 * c);
    }
  }
  return w;
}

// edge_word again for a word that needs the one-byte path, else `word`.
__device__ __forceinline__ uint32_t edge_fixup(const int8_t* p, uintptr_t lo,
                                               uintptr_t hi, uint32_t word) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint32_t r = (uint32_t)(addr & 3);
  const uintptr_t q = addr - r;
  if (!word_straddles(q, lo, hi) && !(r && word_straddles(q + 4, lo, hi))) {
    return word;
  }
  return __funnelshift_r(word_bytes(q, lo, hi),
                         r ? word_bytes(q + 4, lo, hi) : 0u, 8 * r);
}

__device__ __forceinline__ int level_of(uint32_t w, int c) {
  return (int)(int8_t)(w >> (8 * c));
}

// One warp tile. K = 0: a runtime row count, taken four rows at a time.
template <bool kMean, int K, bool kAligned, bool kEdge>
__device__ __forceinline__ void reduce_tile(const ReduceArgs a, int64_t t,
                                            int lane, const float* tensor_nm) {
  constexpr int kRows = K ? K : 4;
  const int rows = K ? K : a.world;
  const int64_t e0 = t * kReduceTile + 4 * lane;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a.levels);
  const uintptr_t hi = lo + (uintptr_t)((int64_t)a.world * a.n);
  const uint32_t b = a.tiles_per_block
                         ? (uint32_t)t / (uint32_t)a.tiles_per_block : 0u;
  int isum[kReduceWords][4] = {};
  float fsum[kReduceWords][4] = {};
  for (int w0 = 0; w0 < rows; w0 += kRows) {
    uint32_t v[kRows][kReduceWords];
    uint32_t above[kRows];
    float nm[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int w = w0 + i;
      if (K == 0 && w >= rows) break;
      const int8_t* row = a.levels + (int64_t)w * a.n;
      if constexpr (kMean && K > 0) {
        nm[i] = a.tiles_per_block ? a.norms[(int64_t)w * a.nb + b]
                                  : tensor_nm[i];
      } else if constexpr (kMean) {
        nm[i] = a.norms[(int64_t)w * a.nb + b];
      }
      // Interior: the aligned word below each of the lane's words (the
      // word itself where the row is aligned) and, for lane 31 of a row
      // that is not aligned, the word above its last one.
      const uint32_t r = kAligned ? 0u : (uint32_t)(
          reinterpret_cast<uintptr_t>(row) & 3);
#pragma unroll
      for (int j = 0; j < kReduceWords; ++j) {
        const int64_t e = e0 + 32 * 4 * j;
        v[i][j] = kEdge ? edge_word<kAligned>(row + e, lo, hi)
                        : aligned_word(row + e - r);
      }
      if constexpr (!kEdge && !kAligned) {
        above[i] = r && lane == 31
                       ? aligned_word(row + e0 + 32 * 4 * (kReduceWords - 1)
                                      - r + 4)
                       : 0u;
      }
    }
    if constexpr (!kEdge && !kAligned) {
      // Realign each row that is not 4-byte aligned: the word above a
      // lane's word is the next lane's (lane 0's next column for lane 31,
      // or the word it loaded past the last column), all loads issued.
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (K == 0 && w0 + i >= rows) break;
        const int8_t* row = a.levels + (int64_t)(w0 + i) * a.n;
        const uint32_t r = (uint32_t)(reinterpret_cast<uintptr_t>(row) & 3);
        if (r == 0) continue;
#pragma unroll
        for (int j = 0; j < kReduceWords; ++j) {
          uint32_t up = __shfl_down_sync(0xffffffffu, v[i][j], 1);
          const uint32_t wrap = __shfl_sync(
              0xffffffffu, j + 1 < kReduceWords ? v[i][j + 1] : 0u, 0);
          if (lane == 31) up = j + 1 < kReduceWords ? wrap : above[i];
          v[i][j] = __funnelshift_r(v[i][j], up, 8 * r);
        }
      }
    }
    // Only a base or an end that is not 4-byte aligned has a word that
    // straddles it, in the first or the last tile.
    if (kEdge && !kAligned && (((lo & 3) && t == 0) || (hi & 3))) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (K == 0 && w0 + i >= rows) break;
        const int8_t* row = a.levels + (int64_t)(w0 + i) * a.n;
#pragma unroll
        for (int j = 0; j < kReduceWords; ++j) {
          v[i][j] = edge_fixup(row + e0 + 32 * 4 * j, lo, hi, v[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (K == 0 && w0 + i >= rows) break;
#pragma unroll
      for (int j = 0; j < kReduceWords; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kMean) {
            fsum[j][c] = __fadd_rn(
                fsum[j][c], __fmul_rn(nm[i], (float)level_of(v[i][j], c)));
          } else {
            isum[j][c] += level_of(v[i][j], c);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kReduceWords; ++j) {
    const int64_t e = e0 + 32 * 4 * j;
    uint32_t o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c] = kMean ? __float_as_uint(__fmul_rn(fsum[j][c], a.factor))
                   : (uint32_t)isum[j][c];
    }
    if (!kEdge || e + 4 <= a.n) {
      *reinterpret_cast<uint4*>(a.out + e) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e + c < a.n) a.out[e + c] = o[c];
      }
    }
  }
}

template <bool kMean, int K, bool kAligned>
__device__ __forceinline__ void worker_reduce(const ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t tiles = (a.n + kReduceTile - 1) / kReduceTile;
  // Tiles [first, interior_end) read only whole words inside the buffer
  // and store whole uint4; tile 0 reads below a base that is not 4-byte
  // aligned.
  const int64_t interior_end = a.n >= 4 ? (a.n - 4) / kReduceTile : 0;
  const bool first_is_edge =
      !kAligned && (reinterpret_cast<uintptr_t>(a.levels) & 3);
  float tensor_nm[K ? K : 1];
  if constexpr (kMean && K > 0) {
    if (!a.tiles_per_block) {
#pragma unroll
      for (int i = 0; i < K; ++i) tensor_nm[i] = a.norms[(int64_t)i * a.nb];
    }
  }
  const int64_t first_tile =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  for (int64_t t = first_tile; t < tiles; t += warps) {
    if (t >= interior_end || (t == 0 && first_is_edge)) {
      reduce_tile<kMean, K, kAligned, true>(a, t, lane, tensor_nm);
    } else {
      reduce_tile<kMean, K, kAligned, false>(a, t, lane, tensor_nm);
    }
  }
}

template <int K, bool kAligned>
__global__ void __launch_bounds__(kReduceThreads)
    dequant_mean_kernel(const ReduceArgs a) {
  worker_reduce<true, K, kAligned>(a);
}

template <int K, bool kAligned>
__global__ void __launch_bounds__(kReduceThreads)
    int_accumulate_kernel(const ReduceArgs a) {
  worker_reduce<false, K, kAligned>(a);
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond ~16 per SM
  return blocks < 1 ? 1 : (int)blocks;
}

// One resident wave of the reduce kernel (at most), cached per
// instantiation: the SMs of the current device times the CTAs of
// kReduceThreads each SM holds.
template <bool kMean, int K, bool kAligned>
int launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  static int resident = 0;  // written once; racing writers agree
  if (!resident) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if constexpr (kMean) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dequant_mean_kernel<K, kAligned>, kReduceThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int_accumulate_kernel<K, kAligned>, kReduceThreads, 0);
    }
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int kWarps = kReduceThreads / 32;
  const int64_t tiles = (a.n + kReduceTile - 1) / kReduceTile;
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  const int grid = (int)(needed < resident ? needed : resident);
  if constexpr (kMean) {
    dequant_mean_kernel<K, kAligned><<<grid, kReduceThreads, 0, stream>>>(a);
  } else {
    int_accumulate_kernel<K, kAligned><<<grid, kReduceThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kMean, bool kAligned>
int reduce_for_rows(const ReduceArgs& a, cudaStream_t stream) {
  switch (a.world) {
    case 1: return launch_reduce<kMean, 1, kAligned>(a, stream);
    case 2: return launch_reduce<kMean, 2, kAligned>(a, stream);
    case 3: return launch_reduce<kMean, 3, kAligned>(a, stream);
    case 4: return launch_reduce<kMean, 4, kAligned>(a, stream);
    case 5: return launch_reduce<kMean, 5, kAligned>(a, stream);
    case 6: return launch_reduce<kMean, 6, kAligned>(a, stream);
    case 7: return launch_reduce<kMean, 7, kAligned>(a, stream);
    case 8: return launch_reduce<kMean, 8, kAligned>(a, stream);
    default: return launch_reduce<kMean, 0, kAligned>(a, stream);
  }
}

// Every row starts 4-byte aligned when the base does and n % 4 == 0.
template <bool kMean>
int worker_reduce_launch(const ReduceArgs& a, cudaStream_t stream) {
  if (a.n <= 0 || a.world <= 0) return (int)cudaGetLastError();
  const bool aligned =
      reinterpret_cast<uintptr_t>(a.levels) % 4 == 0 && a.n % 4 == 0;
  return aligned ? reduce_for_rows<kMean, true>(a, stream)
                 : reduce_for_rows<kMean, false>(a, stream);
}

}  // namespace

extern "C" {

int ewdml_qsgd_quantize(const float* x, const float* norms, int64_t n,
                        int64_t block, const uint32_t* seed, int s, int8_t* out,
                        cudaStream_t stream) {
  if (n > 0) {
    qsgd_quantize_kernel<<<grid_for(n / 4 + 1), kThreads, 0, stream>>>(
        x, norms, n, (int)(block / 4), seed, (float)s, out);
  }
  return (int)cudaGetLastError();
}

// `block` is 0 (per tensor, nb == 1) or a multiple of 4096; `out` is
// 16-byte aligned.
int ewdml_dequant_mean(const int8_t* levels, const float* norms, int world,
                       int64_t n, int64_t nb, int64_t block, float factor,
                       float* out, cudaStream_t stream) {
  const ReduceArgs a{levels, norms, world, n, nb,
                     (int)(block / kReduceTile), factor,
                     reinterpret_cast<uint32_t*>(out)};
  return worker_reduce_launch<true>(a, stream);
}

// `cols` % 128 == 0 and `rows` % 8 == 0 (the wrapper checks both).
int ewdml_block_top1(const float* x, int rows, int cols, float* vals,
                     int32_t* locs, cudaStream_t stream) {
  if (cols > 0) {
    block_top1_kernel<<<cols / kTop1Cols, kTop1Cols * kTop1Slices, 0,
                        stream>>>(x, rows, cols, vals, locs);
  }
  return (int)cudaGetLastError();
}

// `block` is a multiple of 4096 and at most 16384 (T <= 1024 threads);
// the wrapper checks both.
int ewdml_chunk_encode(const float* x, int64_t n, int64_t block,
                       const uint32_t* seed, int s, int8_t* levels,
                       float* norms,
                       cudaStream_t stream) {
  if (n > 0) {
    const int64_t nb = (n + block - 1) / block;
    ring_hop_kernel<false><<<(unsigned)(nb * kHopCluster),
                             (unsigned)(block / kRingVec / kHopCluster), 0,
                             stream>>>(x, nullptr, nullptr, 0.0f, 1.0f, n,
                                       seed, (float)s, levels, norms);
  }
  return (int)cudaGetLastError();
}

// A chunk of at most kHopClusterMaxBlocks blocks takes ring_hop_kernel<true>,
// a cluster of kHopCluster CTAs per block; a larger one ring_encode_kernel,
// one CTA per block.
int ewdml_dequant_acc_requant(const int8_t* levels, const float* norms,
                              const float* local, int64_t n, int64_t block,
                              const uint32_t* seed, int s, float inv_s,
                              float scale,
                              int8_t* out, float* out_norms,
                              cudaStream_t stream) {
  if (n > 0) {
    const int64_t nb = (n + block - 1) / block;
    if (nb > kHopClusterMaxBlocks) {
      ring_encode_kernel<<<(unsigned)nb, (unsigned)(block / kRingVec), 0,
                           stream>>>(local, levels, norms, inv_s, scale, n,
                                     seed, (float)s, out, out_norms);
    } else {
      ring_hop_kernel<true><<<(unsigned)(nb * kHopCluster),
                              (unsigned)(block / kRingVec / kHopCluster), 0,
                              stream>>>(local, levels, norms, inv_s, scale, n,
                                        seed, (float)s, out, out_norms);
    }
  }
  return (int)cudaGetLastError();
}

// `out` is 16-byte aligned; `levels` may start anywhere.
int ewdml_int_accumulate(const int8_t* levels, int world, int64_t n,
                         int32_t* out, cudaStream_t stream) {
  const ReduceArgs a{levels, nullptr, world, n, 0, 0, 1.0f,
                     reinterpret_cast<uint32_t*>(out)};
  return worker_reduce_launch<false>(a, stream);
}

}  // extern "C"
