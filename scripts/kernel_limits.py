#!/usr/bin/env python3
"""What holds qsgd_quantize and chunk_encode at their largest path shapes,
and the schedules that were tried for them.

    python3 scripts/kernel_limits.py        # on a machine with an NVIDIA GPU

``limits`` lines: the port's qsgd_quantize (per tensor and blockwise 4096,
2 359 296 elements) and chunk_encode (fused_q's 596 blocks of 4096 at
W = 4 on VGG11-BN) beside a pass that moves the same bytes on
qsgd_quantize's schedule with a sign in place of the quantize (5n bytes: an
f32 read and an int8 write per element). Each under two L2 flushes before
every launch: chip_smoke.py's (a 512 MB ``zero_()``, which leaves the L2
full of dirty lines that the kernel's own lines must evict) and a read of
the same buffer (clean lines).

``variant`` lines: the same two shapes through other schedules of the same
arithmetic, each bit-checked against the plain version and timed after
chip_smoke.py's flush: a grid-stride quantize with one unhinted float4 per
thread and a 64-bit norm index, and an encode with one CTA of 256 per
block, two barriers and the draw at the quantize (the kernels' earlier
schedules); one resident wave of whole tiles, 16
elements a thread with the draw while the loads are in flight; and
persistent CTAs that stage later tiles into shared memory with cp.async.

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
        f.write(SOURCE)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
