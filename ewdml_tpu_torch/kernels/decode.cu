// Hopper (sm_90a) kernel of the compressed-domain server apply's decode.
//
// acc_decode_set replaces acc_decode (ewdml_tpu/ops/pallas_kernels.py:629)
// for a whole apply: one launch decodes every quantized leaf of a
// homomorphic mean. For leaf i, out_i = f32(acc_i) * (scale_i[b] * inv_k_i)
// with the factor formed first and each product rounded on its own (no
// FMA), as the TPU kernel and the plain version beside the wrapper
// (ewdml_tpu_torch/ops/kernels.py, decode_sum_set_ref) compute it, so the
// two are bit-equal. `inv_k` is 1/k rounded to f32 on the host.
//
// What bounds it: 8 bytes an element (an int32 read, an f32 write) and two
// operations, so HBM; at the sets an apply gives it (38 leaves and 9.75 M
// elements on VGG11-BN, 161 and 23.5 M on ResNet50) the bound is tens of
// microseconds. The JAX package runs the apply under jit, where XLA fuses
// the per-leaf decodes; the port dispatches eagerly, so one launch for
// the set takes the place of a launch per large leaf and three plain ops
// per small one.
// - The set travels in the kernel's parameters (__grid_constant__), one
//   40-byte descriptor a leaf: pointers, n, the scale block in tiles, 1/k
//   and the leaf's first tile in the launch. Nothing is copied to the
//   device, and a CUDA graph that captured the launch replays it as it is.
// - A tile is 4096 elements (16 KB in, 16 KB out); a blockwise scale's
//   block is a multiple of 4096, so a tile never crosses one and its
//   factor is formed once, from one 32-bit division a tile.
// - One resident wave of CTAs walks the tiles; a CTA finds its tile's leaf
//   by a binary search over the descriptors' first tiles (uniform across
//   the CTA, read from the parameter bank).
// - Each tile's sums come into shared memory by one 1-D TMA bulk copy
//   (cp.async.bulk completing on an mbarrier), two 16 KB stages a CTA:
//   thread 0 issues the CTA's next tile before the CTA decodes this one,
//   so a copy is always in flight and no thread spends registers or
//   instructions on the loads. Measured against the schedule it replaced
//   (four 16-byte loads in flight a thread, which moved its bytes as fast
//   as a plain copy on the same walk) it is 3-5% faster at the VGG11-BN
//   and ResNet50 sets (PERF.md; scripts/kernel_limits.py).
// - acc and out start on 16-byte boundaries (the wrapper aligns acc and
//   cuts the outputs from one arena at 16-byte offsets), as the bulk copy
//   needs. Only a leaf's last tile is partial: its whole vectors through
//   the stage, then its last n % 4 elements one at a time from global.
//
// Plain C interface, as compress.cu: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a thread decodes in a tile
constexpr uint32_t kTile = kThreads * kVecs * 4;  // 4096 elements
// Leaves a launch takes (ops/kernels.DECODE_MAX_LEAVES), as the round set
// of precision.cu.
constexpr int kMaxLeaves = 448;

// One leaf of a set, packed by the host (ops/kernels.decode_descriptors).
struct DecodeLeaf {
  unsigned long long acc;     // const int32_t*, 16-byte aligned
  unsigned long long out;     // float*, 16-byte aligned
  unsigned long long scales;  // const float*
  uint32_t n;                 // elements, 1 .. 2^31 - 1
  uint32_t first_tile;        // the leaf's first tile in the launch
  uint32_t tiles_per_block;   // scale block / kTile; 0: one scale
  float inv_k;                // 1/k rounded to f32
};
static_assert(sizeof(DecodeLeaf) == 40, "the host packs 40-byte leaves");

struct DecodeSet {
  uint32_t count;
  uint32_t tiles;  // the launch's tiles, over all its leaves
  DecodeLeaf leaf[kMaxLeaves];
};
static_assert(sizeof(DecodeSet) <= 32764, "32 KB of parameters");

// The tile's leaf: the last whose first tile is at most t (uniform across
// the CTA, read from the parameter bank).
__device__ __forceinline__ const DecodeLeaf& leaf_of(const DecodeSet& set,
                                                     uint32_t t) {
  uint32_t lo = 0, hi = set.count;
  while (hi - lo > 1) {
    const uint32_t mid = (lo + hi) >> 1;
    if (set.leaf[mid].first_tile <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return set.leaf[lo];
}

// The elements of tile t of its leaf L: kTile, or fewer in its last tile.
__device__ __forceinline__ uint32_t tile_elems(const DecodeLeaf& L,
                                               uint32_t t) {
  const int64_t rest =
      (int64_t)L.n - (int64_t)(t - L.first_tile) * kTile;
  return rest < kTile ? (uint32_t)rest : kTile;
}

__device__ __forceinline__ float decode_one(int32_t a, float factor) {
  return __fmul_rn(__int2float_rn(a), factor);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0: the whole vectors of tile t into `dst` by one bulk copy that
// completes on `bar` (a tile of fewer than 4 elements copies nothing and
// completes at once).
__device__ __forceinline__ void bulk_load(const DecodeSet& set, uint32_t t,
                                          int4* dst, uint64_t* bar) {
  const DecodeLeaf& L = leaf_of(set, t);
  const uint32_t bytes = tile_elems(L, t) / 4 * 16;
  const int32_t* src = reinterpret_cast<const int32_t*>(L.acc) +
                       (int64_t)(t - L.first_tile) * kTile;
  // The stage was last read through the generic proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
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
      "{\n\t.reg .pred done;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@done bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}"
      :: "r"(smem_addr(bar)), "r"(phase) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    acc_decode_set_kernel(const __grid_constant__ DecodeSet set) {
  __shared__ alignas(128) int4 stage[2][kTile / 4];
  __shared__ alignas(8) uint64_t bar[2];
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar[b])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t t = blockIdx.x;  // the grid is at most the set's tiles
  if (threadIdx.x == 0) bulk_load(set, t, stage[0], &bar[0]);
#pragma unroll 1
  for (uint32_t i = 0; t < set.tiles; t += gridDim.x, ++i) {
    const uint32_t b = i & 1;
    // The other stage was drained before the barrier that closed the
    // last tile: its next tile's copy runs while this one is decoded.
    if (threadIdx.x == 0 && t + gridDim.x < set.tiles) {
      bulk_load(set, t + gridDim.x, stage[b ^ 1], &bar[b ^ 1]);
    }
    const DecodeLeaf& L = leaf_of(set, t);
    const uint32_t tile = t - L.first_tile;
    const float* scales = reinterpret_cast<const float*>(L.scales);
    const float factor = __fmul_rn(
        __ldg(scales + (L.tiles_per_block ? tile / L.tiles_per_block : 0u)),
        L.inv_k);
    const int64_t begin = (int64_t)tile * kTile;
    const uint32_t m = tile_elems(L, t);
    const uint32_t nvec = m / 4;
    float4* __restrict__ o4 = reinterpret_cast<float4*>(L.out) + begin / 4;
    wait_phase(&bar[b], (i >> 1) & 1);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint32_t k = threadIdx.x + j * kThreads;
      if (k < nvec) {
        const int4 a = stage[b][k];
        o4[k] = make_float4(decode_one(a.x, factor), decode_one(a.y, factor),
                            decode_one(a.z, factor), decode_one(a.w, factor));
      }
    }
    const uint32_t e = nvec * 4 + threadIdx.x;
    if (e < m) {  // the leaf's last n % 4 elements
      reinterpret_cast<float*>(L.out)[begin + e] = decode_one(
          reinterpret_cast<const int32_t*>(L.acc)[begin + e], factor);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// leaves: `count` (at most kMaxLeaves) packed DecodeLeaf descriptors in
// host memory, in order of first_tile (numbered by kTile,
// ops/kernels.DECODE_TILE), the first at tile 0, none empty; each acc and
// out is an offset from acc_base and out_base (0 where the descriptors
// hold whole pointers), so a set whose sums and means lie in two arenas
// is packed once and launched on any pair. The grid is one resident wave
// of the card, or the set's tiles where fewer.
int ewdml_acc_decode_set(const void* leaves, int count,
                         unsigned long long acc_base,
                         unsigned long long out_base, cudaStream_t stream) {
  if (count <= 0) return 0;
  if (count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  static int resident = 0;  // written once; racing writers agree
  if (!resident) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, acc_decode_set_kernel, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  DecodeSet set;
  set.count = (uint32_t)count;
  memcpy(set.leaf, leaves, sizeof(DecodeLeaf) * count);
  for (int i = 0; i < count; ++i) {
    set.leaf[i].acc += acc_base;
    set.leaf[i].out += out_base;
  }
  const DecodeLeaf& last = set.leaf[count - 1];
  set.tiles = last.first_tile + (last.n + kTile - 1) / kTile;
  const int grid = (int)(set.tiles < (uint32_t)resident ? set.tiles
                                                        : (uint32_t)resident);
  acc_decode_set_kernel<<<grid, kThreads, 0, stream>>>(set);
  return (int)cudaGetLastError();
}

}  // extern "C"
