// The staged route shared by csrc/mixing.cu (the dense mix),
// csrc/sparse_mixing.cu (the ELL gather) and csrc/quant_mixing.cu (both
// over a quantized payload, whose slabs hold container bytes that the
// consumers decode once a tile): persistent CTAs walk column tiles of X,
// and a producer warp keeps a ring of X slabs (all n rows of one column
// tile) in dynamic shared memory filled by TMA bulk copies, while the
// consumer warps compute on the slab that has landed and store its
// outputs.  Each of the three sources builds into its own library, so an
// edit here renames all three (repro_torch/kernels/_build.py).
//
//   * A CTA is kConsumerWarps consumer warps and one producer warp.  CTA b
//     takes the column tiles b, b + gridDim.x, b + 2 gridDim.x, ...; its
//     j-th tile goes to stage j % kStages of the ring.  A tile's result
//     does not depend on which CTA computes it, so the outputs are
//     deterministic.
//   * Two stages.  At the paper's n = 70 a CTA then holds 86-99 KB of
//     shared memory (the quantized kernels 63-81 KB, with their fp32
//     slab), so two CTAs (16 consumer warps) share an SM, one
//     refilling its ring while the other computes.  One CTA an SM with
//     four stages, or with 16 consumer warps, measured slower on the
//     H100: the consumers' shared-memory latency wants the warps.
//   * The producer fills a stage with one 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx) per row of X, its lanes
//     taking rows lane, lane + 32, ...; the full barrier of the stage
//     completes when all of the slab's bytes have landed.  The last tile
//     is ragged: its copies are trimmed to the columns inside p.
//   * A consumer warp releases a stage with one arrive on its empty
//     barrier (kConsumerWarps arrivals complete it) as soon as its lanes
//     are done reading the slab; the producer then refills the stage while
//     the consumers store their outputs and compute on the next slab.
//   * Waits trap after 2^24 tries (seconds), so a parity mistake or a
//     copy that never lands shows as a launch error, not a hung card.
//
// TMA's rules, which the callers' route rule guarantees: the global
// source of a copy and its shared destination are 16-byte aligned and
// its size is a multiple of 16 bytes (X 16-byte aligned and p * itemsize
// a multiple of 16, so every row and every tile starts aligned).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace staged {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;         // 256 threads
constexpr int kThreads = kConsumers + 32;               // + the producer
constexpr int kStages = 2;
constexpr int kBarBytes = 128;     // 2 kStages mbarriers, then the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of `bar` has completed; a wait
// that outlasts any real one traps
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 24)) __trap();
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps alone (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The ring in dynamic shared memory: the full and empty barriers of each
// stage in the first kBarBytes, then kStages slabs of n rows of
// `row_bytes` each; what a kernel keeps resident starts at
// slab_offset(kStages).  `smem` is the dynamic shared base.
struct Ring {
  uint32_t bars, slabs;
  int n;
  uint32_t row_bytes;

  __device__ Ring(unsigned char* smem, int n_, int row_bytes_)
      : bars(smem_u32(smem)), slabs(smem_u32(smem) + kBarBytes), n(n_),
        row_bytes((uint32_t)row_bytes_) {}

  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const {
    return bars + 8u * (kStages + s);
  }
  __device__ uint32_t slab_bytes() const { return row_bytes * n; }
  // byte offset of stage s's slab from the dynamic shared base
  __device__ uint32_t slab_offset(int s) const {
    return kBarBytes + s * slab_bytes();
  }

  // one thread, before the __syncthreads that precedes any wait
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the producer warp: fill the ring with this CTA's tiles of X, whose
  // rows are `row_stride` bytes apart; a tile is row_bytes of each row
  __device__ void produce(const unsigned char* X, long long row_stride,
                          long long tiles) const {
    const int lane = threadIdx.x % 32;
    int j = 0;
    for (long long tile = blockIdx.x; tile < tiles;
         tile += gridDim.x, ++j) {
      const int s = j % kStages;
      mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
      const long long off = tile * row_bytes;
      const long long left = row_stride - off;
      const uint32_t bytes =
          left < (long long)row_bytes ? (uint32_t)left : row_bytes;
      if (lane == 0) mbar_expect_tx(full(s), bytes * n);
      __syncwarp();
      const uint32_t dst = slabs + s * slab_bytes();
      for (int r = lane; r < n; r += 32)
        bulk_load(dst + r * row_bytes, X + r * row_stride + off, bytes,
                  full(s));
    }
  }

  // a consumer: wait until stage s of local tile j has landed
  __device__ void wait_full(int j) const {
    mbar_wait(full(j % kStages), (j / kStages) & 1);
  }

  // a consumer warp: done reading local tile j's slab
  __device__ void release(int j) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(j % kStages));
  }
};

// Host side.  The dynamic shared memory of a CTA (the callers' route rules
// keep it within the 227 KB a block can have), and the grid: one CTA per
// tile up to what the SMs hold at that size.
inline long long smem_for(long long slab_bytes, long long resident) {
  return kBarBytes + kStages * slab_bytes + resident;
}

template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long smem, long long tiles,
                     int device, unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, (int)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *grid = (unsigned)(tiles < most ? tiles : most);
  return cudaSuccess;
}

}  // namespace staged
