// Dense graph-mixing kernels for Hopper (sm_90a): the port of the three
// Pallas TPU kernels on Algorithm 1's single-host round path.
//
//   repro_aggregate      replaces repro/kernels/mixing/fused.py::aggregate_pallas
//                        (_agg_kernel):   agg = w @ X
//   repro_mix_aggregate  replaces fused.py::mix_aggregate_pallas (_fused_kernel):
//                        mixed = A @ X and agg = w @ X from one read of X,
//                        and, called with agg == NULL,
//                        repro/kernels/mixing/mixing.py::mix_pallas (_mix_kernel):
//                        mixed = A @ X
//
// Build (one shared library per source, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libmixing.so mixing.cu
//
// C ABI.  Every entry point takes device pointers and the CUDA stream as
// void* (ctypes.c_void_p), sizes as int / long long, a dtype code for X
// (0 = float32, 1 = bfloat16) and the device ordinal; it launches on the
// given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() as an int (0 = success; repro_error_string(code)
// names any other).  All arrays are row-major and contiguous.
//
//   int repro_aggregate_row_groups(int n, long long p, int dtype);
//       the number G of row groups the aggregate GEMV splits the n rows
//       into for (n, p, dtype) (csrc/row_groups.cuh); a launch needs a
//       (G, p) f32 scratch when G > 1.  -1 for an unknown dtype.
//
//   int repro_aggregate(const float* w,        // (n,) f32 combine row
//                       const void* X,         // (n, p) f32 | bf16
//                       float* agg,            // (p,) f32 out
//                       float* partial,        // (G, p) f32 scratch if G > 1
//                       int n, long long p, int dtype,
//                       int device, void* stream);
//
//   int repro_mix_aggregate(const float* B,    // (R, n) f32: rows [A; w]
//                           const void* X,     // (n, p) f32 | bf16
//                           void* mixed,       // (n, p) out, X's dtype
//                           float* agg,        // (p,) f32 out, or NULL
//                           int n, int R, long long p, int dtype,
//                           int device, void* stream,
//                           int* route);       // out: 1 staged, 0 generic
//
//   R = n + 1 with agg != NULL (row n of B is the combine row w), or R = n
//   with agg == NULL (the plain mix).  *route is set on success.
//
// Both kernels accumulate in fp32 with fmaf (no TF32, no tensor cores), and
// mask the ragged p and n edges themselves: the caller pads nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_groups.cuh"
#include "staged.cuh"

namespace {

// ---------------------------------------------------------------------------
// aggregate: agg[c] = sum_i w[i] * X[i, c]
//
// Bound: the bytes of X (n * p * itemsize, read once; the (p,) f32 row out
// is 1/n of that).  At the paper's shape (70 x 1,663,488 f32, 466 MB) the
// least time on an H100 is ~0.14 ms at 3.35 TB/s; at the scale round's
// (100,000 x 7,936 f32, 3.17 GB) ~0.95 ms; the 2 n p flops are far under
// the fp32 rate.  Design: csrc/row_groups.cuh's GEMV, which streams X
// exactly once with 16-byte loads (4 f32 or 8 bf16 a thread; 4- or 2-byte
// loads when p or the base pointer does not allow 16) and picks its layout
// and row groups G from (n, p) so that enough warps stream at once: the
// paper's payload takes the wide layout with G = 1 (1,625 CTAs, agg
// bitwise the first design's), the scale round's the tall one with G = 35
// (fp32) or 69 (bf16).  Columns >= p are masked there.
// ---------------------------------------------------------------------------

template <typename T, int VEC>
struct VecLoad;

template <>
struct VecLoad<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* v) {
    float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
};

template <>
struct VecLoad<float, 1> {
  __device__ __forceinline__ static void run(const float* p, float* v) {
    v[0] = __ldcs(p);
  }
};

template <>
struct VecLoad<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* v) {
    uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&words[j]);
      float2 f = __bfloat1622float2(h);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};

template <>
struct VecLoad<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* v) {
    unsigned short bits =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
    v[0] = __bfloat162float(__ushort_as_bfloat16(bits));
  }
};

// the GEMV's loader (csrc/row_groups.cuh): VEC values of row r
template <typename T, int VEC>
struct DenseLoad {
  static constexpr int kVals = VEC;
  static constexpr int kUnroll = 4;
  struct Args {
    const T* X;
  };
  const T* x;
  long long p;
  __device__ DenseLoad(Args a, long long p_, long long col)
      : x(a.X + col), p(p_) {}
  __device__ __forceinline__ void row(long long r, float* v) const {
    VecLoad<T, VEC>::run(x + r * p, v);
  }
};

// the plan of an (n, p) payload of T: by the 16-byte vector's width, so
// the narrow loads of an unaligned payload sum in the same order.  Tall
// CTAs keep 8 warps along the rows at any n, and the row groups aim at
// two waves of CTAs: both timed in turns on the H100 against the
// alternatives (fewer warps along the rows, one wave), as was the loader's
// 4 rows in flight against 8.
template <typename T>
rowsum::Plan aggregate_plan(int n, long long p) {
  return rowsum::plan(n, p, 16 / (int)sizeof(T), 1, 2 * rowsum::kWave);
}

template <typename T, int VEC>
cudaError_t launch_aggregate(const float* w, const void* X, float* agg,
                             float* partial, int n, long long p,
                             cudaStream_t stream) {
  return rowsum::launch_gemv<DenseLoad<T, VEC>>(
      w, {static_cast<const T*>(X)}, agg, partial, n, p,
      aggregate_plan<T>(n, p), stream);
}

// ---------------------------------------------------------------------------
// mix_aggregate / mix: Y = B @ X with B = [A; w] ((R, n), f32) and X (n, p).
// Rows r < n of Y are the mixed deltas (cast to X's dtype), row n (when
// agg != NULL) the f32 aggregate row.
//
// Bound: about balanced.  Bytes: X read once plus mixed written once
// (2 n p itemsize, 0.93 GB at the slice's shape: ~0.28 ms at 3.35 TB/s);
// operations: 2 R n p fp32 flops (16.5 GFLOP: ~0.25 ms at the 67 TFLOP/s
// non-tensor fp32 rate).  fp32 has no tensor-core path that keeps full
// precision, so this is a CUDA-core product, and it must keep the FMA pipe
// busy while X streams in.
//
// Two routes; the rule is static (no fallback between them: a launch that
// fails raises):
//
//   staged   when n <= kStagedRows (128), p % E == 0 (E = 4 f32, 8 bf16:
//            whole 16-byte vectors a row) and X, mixed and agg are 16-byte
//            aligned;
//   generic  otherwise (the 'pallas' path's odd leaves, misaligned views,
//            larger n).
//
// Staged route (mix_staged_kernel; the ring of csrc/staged.cuh):
//   * Persistent CTAs of 8 consumer warps and a producer warp walk column
//     tiles of kStagedCols = 128 columns.  B is loaded into shared memory
//     once per CTA (transposed, Bs[k][row], zero rows past R), not once a
//     tile; the producer keeps two slabs of X (all n rows of a tile: the
//     whole reduction, so a tile needs no K loop and no __syncthreads) in
//     flight by 1-D TMA bulk copies, bf16 staying bf16 in shared memory.
//     At n = 70 a CTA holds 99 KB, so two CTAs share an SM.
//   * Consumer warp q owns rows q RM .. q RM + RM - 1 (RM = ceil(R / 8)
//     <= 17, a template parameter) and lane l the 4 columns 4 l .. 4 l + 3:
//     per reduction step one 16-byte (f32) or 8-byte (bf16) X load, RM / 4
//     16-byte broadcast loads of B and 4 RM fmaf, in k order 0 .. n - 1 as
//     the generic route (no TF32, no tensor cores), unrolled by 4.  acc
//     is 4 RM <= 68 registers: nothing spills.
//   * A warp releases the slab before its stores, which are 16-byte (f32)
//     / 8-byte (bf16) streaming stores (__stcs) from registers; the next
//     tile's slab is already in the ring, so the stores overlap its FMAs
//     and the copies behind it.
//
// Generic route (mix_aggregate_kernel): a register-blocked tiled product.
//   * A block owns kColTile = 128 columns and TR = 16 RM output rows (RM a
//     template parameter chosen by the host so that one row tile covers
//     R <= 128: at n = 70, RM = 5 covers all 71 rows and X is read from
//     HBM exactly once; larger R takes more row tiles, each re-reading X).
//   * Thread (tx, ty) of the 16 x 16 block computes RM consecutive rows
//     times 8 columns (4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3):
//     per reduction step 8 RM FMAs against two 16-byte X reads and RM / 4
//     16-byte B reads (warp broadcasts) from shared memory, so shared
//     memory does not set the pace.
//   * The reduction over n walks kTK-row slabs of X (and the matching
//     columns of B) through two shared-memory buffers; the next slab's
//     global loads are issued into registers before the current slab is
//     computed, so the HBM traffic overlaps the FMAs.  Any n works (the
//     TPU kernel kept all of A resident, which 227 KB of shared memory
//     cannot do at large n).
//   * Global reads and writes of X, mixed and agg are 16-byte (stores:
//     4-element) vectors when p and the pointers allow it (the host passes
//     vec), else coalesced scalars; the ragged p and n edges are masked
//     here.
// ---------------------------------------------------------------------------

constexpr int kMixTX = 16;                       // threads along columns
constexpr int kMixTY = 16;                       // threads along rows
constexpr int kMixThreads = kMixTX * kMixTY;     // 256
constexpr int kColTile = 8 * kMixTX;             // 128 columns, 8 a thread
constexpr int kTK = 16;                          // reduction slab depth
constexpr int kRowsMax = 8;                      // RM <= 8: 128-row tiles
constexpr int kXPerThread = kTK * kColTile / kMixThreads;   // 8
// the slab loaders give each thread whole 16-byte X vectors (8 bf16) and
// one B element per tile row group
static_assert(kXPerThread % 8 == 0, "X slab: whole bf16 vectors a thread");
static_assert(kTK * kMixTY == kMixThreads, "B slab: one element a thread");

// X slab rows k0 .. k0 + kTK as fp32 registers: vector e = tid + j * 256
// of VEC columns sits at slab row e / (kColTile / VEC).
template <typename T, int VEC>
__device__ __forceinline__ void load_x_slab(const T* __restrict__ X, int n,
                                            long long p, int k0,
                                            long long col0, int tid,
                                            float (&xr)[kXPerThread]) {
  constexpr int kPerRow = kColTile / VEC;
#pragma unroll
  for (int j = 0; j < kXPerThread / VEC; ++j) {
    const int e = tid + j * kMixThreads;
    const int kk = k0 + e / kPerRow;
    const long long col = col0 + (e % kPerRow) * VEC;
    float* v = xr + j * VEC;
    if (kk < n && col < p) {      // VEC > 1 only when p % VEC == 0
      VecLoad<T, VEC>::run(X + (long long)kk * p + col, v);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = 0.f;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_x_slab(float (*Xs)[kColTile], int tid,
                                             const float (&xr)[kXPerThread]) {
  constexpr int kPerRow = kColTile / VEC;
#pragma unroll
  for (int j = 0; j < kXPerThread / VEC; ++j) {
    const int e = tid + j * kMixThreads;
    float* dst = &Xs[e / kPerRow][(e % kPerRow) * VEC];
    if constexpr (VEC >= 4) {
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(dst + q) =
            make_float4(xr[j * VEC + q], xr[j * VEC + q + 1],
                        xr[j * VEC + q + 2], xr[j * VEC + q + 3]);
    } else {
      dst[0] = xr[j];
    }
  }
}

// B slab: columns k0 .. k0 + kTK of the block's 16 RM rows.  Element
// e = tid + j * 256 is tile row e / kTK, column e % kTK (consecutive
// threads read along a row of B).  Shared layout: Bs[k][ty * RMP + r].
template <int RM>
__device__ __forceinline__ void load_b_slab(const float* __restrict__ B,
                                            int n, int R, int k0, int row0,
                                            int tid, float (&br)[RM]) {
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    const int e = tid + j * kMixThreads;
    const int row = row0 + e / kTK, kk = k0 + e % kTK;
    br[j] = (row < R && kk < n) ? B[(long long)row * n + kk] : 0.f;
  }
}

template <int RM, int RMP>
__device__ __forceinline__ void store_b_slab(float (*Bs)[kMixTY * RMP],
                                             int tid, const float (&br)[RM]) {
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    const int e = tid + j * kMixThreads;
    const int rr = e / kTK;
    Bs[e % kTK][(rr / RM) * RMP + rr % RM] = br[j];
  }
}

// Four neighbouring outputs of one row (`left` of them inside p): one
// vector store when allowed.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float* v, long long left,
                                       bool vec);
template <>
__device__ __forceinline__ void store4<float>(float* dst, const float* v,
                                              long long left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < left) dst[q] = v[q];
  }
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      const float* v,
                                                      long long left,
                                                      bool vec) {
  // round-to-nearest-even, like astype
  if (vec && left >= 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < left) dst[q] = __float2bfloat16(v[q]);
  }
}

template <typename T, int RM>
__global__ void __launch_bounds__(kMixThreads, 2)
mix_aggregate_kernel(const float* __restrict__ B, const T* __restrict__ X,
                     T* __restrict__ mixed, float* __restrict__ agg, int n,
                     int R, long long p, bool vec) {
  constexpr int RMP = (RM + 3) / 4 * 4;          // rows padded for float4
  constexpr int VX = 16 / sizeof(T);             // 4 f32 or 8 bf16
  __shared__ __align__(16) float Xs[2][kTK][kColTile];
  __shared__ __align__(16) float Bs[2][kTK][kMixTY * RMP];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kMixTX + tx;
  const int row0 = blockIdx.y * (kMixTY * RM);
  const long long col0 = (long long)blockIdx.x * kColTile;

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  float xr[kXPerThread], br[RM];
  auto fetch = [&](int k0) {
    if (vec) load_x_slab<T, VX>(X, n, p, k0, col0, tid, xr);
    else     load_x_slab<T, 1>(X, n, p, k0, col0, tid, xr);
    load_b_slab<RM>(B, n, R, k0, row0, tid, br);
  };
  auto stash = [&](int buf) {
    if (vec) store_x_slab<VX>(Xs[buf], tid, xr);
    else     store_x_slab<1>(Xs[buf], tid, xr);
    store_b_slab<RM, RMP>(Bs[buf], tid, br);
  };

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < n; k0 += kTK) {
    const bool more = k0 + kTK < n;
    if (more) fetch(k0 + kTK);     // in flight while this slab computes
    const int kn = min(kTK, n - k0);
#pragma unroll 1
    for (int k = 0; k < kn; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[buf][k][4 * tx]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&Xs[buf][k][64 + 4 * tx]);
      const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float b[RMP];
#pragma unroll
      for (int q = 0; q < RMP; q += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Bs[buf][k][ty * RMP + q]);
        b[q] = t.x; b[q + 1] = t.y; b[q + 2] = t.z; b[q + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(b[r], x[j], acc[r][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + ty * RM + r;
    if (row >= R) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = col0 + 64 * h + 4 * tx;
      if (col >= p) continue;
      if (row < n)
        store4<T>(mixed + (long long)row * p + col, acc[r] + 4 * h, p - col,
                  vec);
      else
        store4<float>(agg + col, acc[r] + 4 * h, p - col, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// mix_aggregate / mix, the staged route (see above).

constexpr int kStagedRows = 128;                      // n limit
constexpr int kStagedCols = 128;                      // columns a tile
constexpr int kStagedRM = (kStagedRows + 1 + staged::kConsumerWarps - 1) /
                          staged::kConsumerWarps;     // RM <= 17

template <typename T>
struct Staged;

template <>
struct Staged<float> {
  // 4 columns of a slab row
  __device__ __forceinline__ static void load4(const unsigned char* p,
                                               float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ __forceinline__ static void store4(float* dst, const float* v) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Staged<__nv_bfloat16> {
  __device__ __forceinline__ static void load4(const unsigned char* p,
                                               float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  // round-to-nearest-even, like astype
  __device__ __forceinline__ static void store4(__nv_bfloat16* dst,
                                                const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(dst),
           make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi)));
  }
};

template <typename T, int RM>
__global__ void __launch_bounds__(staged::kThreads, 1)
mix_staged_kernel(const float* __restrict__ B, const T* __restrict__ X,
                  T* __restrict__ mixed, float* __restrict__ agg, int n,
                  int R, long long p, long long tiles) {
  constexpr int W = staged::kConsumerWarps;
  constexpr int RMP = (RM + 3) / 4 * 4;          // rows padded for float4
  constexpr int kRow = kStagedCols * sizeof(T);  // bytes of a slab row
  extern __shared__ __align__(16) unsigned char smem[];
  const staged::Ring ring(smem, n, kRow);
  // Bs[k][q * RMP + r] = B[q * RM + r, k], zero for r >= RM or rows >= R
  float* Bs =
      reinterpret_cast<float*>(smem + ring.slab_offset(staged::kStages));

  if (threadIdx.x == 0) ring.init();
  for (int e = threadIdx.x; e < n * W * RMP; e += blockDim.x) {
    const int k = e / (W * RMP), q = (e / RMP) % W, r = e % RMP;
    const int row = q * RM + r;
    Bs[e] = (r < RM && row < R) ? B[(long long)row * n + k] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == W) {
    ring.produce(reinterpret_cast<const unsigned char*>(X),
                 p * (long long)sizeof(T), tiles);
    return;
  }
  const float* bw = Bs + warp * RMP;
  int j = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    ring.wait_full(j);
    const unsigned char* xs =
        smem + ring.slab_offset(j % staged::kStages) + lane * 4 * sizeof(T);
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      float x[4];
      Staged<T>::load4(xs + k * kRow, x);
      float b[RMP];
#pragma unroll
      for (int q = 0; q < RMP; q += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(bw + k * (W * RMP) + q);
        b[q] = t.x; b[q + 1] = t.y; b[q + 2] = t.z; b[q + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(b[r], x[c], acc[r][c]);
    }
    ring.release(j);
    const long long col = tile * kStagedCols + lane * 4;
    if (col >= p) continue;     // p % E == 0: all 4 columns or none
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = warp * RM + r;
      if (row < n)
        Staged<T>::store4(mixed + (long long)row * p + col, acc[r]);
      else if (row < R)
        Staged<float>::store4(agg + col, acc[r]);
    }
  }
}

template <typename T, int RM>
cudaError_t launch_staged_rm(const float* B, const void* X, void* mixed,
                             float* agg, int n, int R, long long p,
                             int device, cudaStream_t stream) {
  constexpr int RMP = (RM + 3) / 4 * 4;
  const long long tiles = (p + kStagedCols - 1) / kStagedCols;
  const long long slab = (long long)n * kStagedCols * sizeof(T);
  const long long resident =
      (long long)n * staged::kConsumerWarps * RMP * sizeof(float);
  const long long smem = staged::smem_for(slab, resident);
  auto kernel = mix_staged_kernel<T, RM>;
  unsigned grid = 0;
  cudaError_t err = staged::grid_for(kernel, smem, tiles, device, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, staged::kThreads, smem, stream>>>(
      B, static_cast<const T*>(X), static_cast<T*>(mixed), agg, n, R, p,
      tiles);
  return cudaGetLastError();
}

// RM = ceil(R / 8): the instance RM0, RM0 + 1, ... that matches
template <typename T, int RM0 = 1>
cudaError_t launch_staged(int rm, const float* B, const void* X,
                          void* mixed, float* agg, int n, int R, long long p,
                          int device, cudaStream_t stream) {
  if constexpr (RM0 > kStagedRM) {
    return cudaErrorInvalidValue;
  } else {
    if (rm == RM0)
      return launch_staged_rm<T, RM0>(B, X, mixed, agg, n, R, p, device,
                                      stream);
    return launch_staged<T, RM0 + 1>(rm, B, X, mixed, agg, n, R, p, device,
                                     stream);
  }
}

// ---------------------------------------------------------------------------
// mix_aggregate / mix, the generic route's launch.

template <typename T, int RM>
cudaError_t launch_mix_rm(const float* B, const void* X, void* mixed,
                          float* agg, int n, int R, long long p, bool vec,
                          cudaStream_t stream) {
  const int TR = kMixTY * RM;
  dim3 block(kMixTX, kMixTY);
  dim3 grid((unsigned)((p + kColTile - 1) / kColTile),
            (unsigned)((R + TR - 1) / TR));
  mix_aggregate_kernel<T, RM><<<grid, block, 0, stream>>>(
      B, static_cast<const T*>(X), static_cast<T*>(mixed), agg, n, R, p,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mix_aggregate(const float* B, const void* X, void* mixed,
                                 float* agg, int n, int R, long long p,
                                 bool vec, cudaStream_t stream) {
  // RM rows per thread: one row tile when R <= 128, else 128-row tiles
  int rm = (R + kMixTY - 1) / kMixTY;
  if (rm > kRowsMax) rm = kRowsMax;
  switch (rm) {
    case 1: return launch_mix_rm<T, 1>(B, X, mixed, agg, n, R, p, vec, stream);
    case 2: return launch_mix_rm<T, 2>(B, X, mixed, agg, n, R, p, vec, stream);
    case 3: return launch_mix_rm<T, 3>(B, X, mixed, agg, n, R, p, vec, stream);
    case 4: return launch_mix_rm<T, 4>(B, X, mixed, agg, n, R, p, vec, stream);
    case 5: return launch_mix_rm<T, 5>(B, X, mixed, agg, n, R, p, vec, stream);
    case 6: return launch_mix_rm<T, 6>(B, X, mixed, agg, n, R, p, vec, stream);
    case 7: return launch_mix_rm<T, 7>(B, X, mixed, agg, n, R, p, vec, stream);
    default:
      return launch_mix_rm<T, 8>(B, X, mixed, agg, n, R, p, vec, stream);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_aggregate_row_groups(int n, long long p, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return dtype == 0 ? aggregate_plan<float>(n, p).groups
                    : aggregate_plan<__nv_bfloat16>(n, p).groups;
}

int repro_aggregate(const float* w, const void* X, float* agg,
                    float* partial, int n, long long p, int dtype,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads need p to fill whole vectors and a 16-byte-aligned base
  const bool aligned = (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(agg) % 16 == 0);
  if (dtype == 0) {
    if (aligned && p % 4 == 0)
      return (int)launch_aggregate<float, 4>(w, X, agg, partial, n, p, s);
    return (int)launch_aggregate<float, 1>(w, X, agg, partial, n, p, s);
  }
  if (dtype == 1) {
    if (aligned && p % 8 == 0)
      return (int)launch_aggregate<__nv_bfloat16, 8>(w, X, agg, partial, n,
                                                     p, s);
    return (int)launch_aggregate<__nv_bfloat16, 1>(w, X, agg, partial, n, p,
                                                   s);
  }
  return (int)cudaErrorInvalidValue;
}

int repro_mix_aggregate(const float* B, const void* X, void* mixed,
                        float* agg, int n, int R, long long p, int dtype,
                        int device, void* stream, int* route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p <= 0 || R <= 0) return (int)cudaGetLastError();
  if (R != n + (agg != nullptr ? 1 : 0)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads and stores need whole vectors per row and 16-byte bases
  const bool aligned = (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(mixed) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(agg) % 16 == 0);
  const bool vec = aligned && p % (dtype == 0 ? 4 : 8) == 0;
  if (vec && n <= kStagedRows) {
    const int rm = (R + staged::kConsumerWarps - 1) / staged::kConsumerWarps;
    err = dtype == 0 ? launch_staged<float>(rm, B, X, mixed, agg, n, R, p,
                                            device, s)
                     : launch_staged<__nv_bfloat16>(rm, B, X, mixed, agg, n,
                                                    R, p, device, s);
    if (err == cudaSuccess) *route = 1;
    return (int)err;
  }
  err = dtype == 0 ? launch_mix_aggregate<float>(B, X, mixed, agg, n, R, p,
                                                 vec, s)
                   : launch_mix_aggregate<__nv_bfloat16>(B, X, mixed, agg, n,
                                                         R, p, vec, s);
  if (err == cudaSuccess) *route = 0;
  return (int)err;
}

}  // extern "C"
