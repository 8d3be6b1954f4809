// Sparse (ELL) graph-mixing kernels for Hopper (sm_90a): the port of the
// Pallas gather kernels of repro/kernels/mixing/sparse.py.
//
//   repro_sparse_mix_aggregate  replaces sparse.py::sparse_mix_aggregate_pallas
//                               (_sparse_fused_kernel): the ELL gather
//                               mixed[i] = sum_k w[i, k] * X[idx[i, k]]
//                               and the combine-row product agg = wrow @ X
//                               in one pass over X, and, called with
//                               wrow == agg == NULL,
//                               sparse.py::sparse_mix_pallas
//                               (_sparse_mix_kernel): the gather alone
//
// Build (one shared library per source, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libsparse_mixing.so sparse_mixing.cu
//
// C ABI.  Device pointers and the CUDA stream are void* (ctypes.c_void_p),
// sizes int / long long, a dtype code for X (0 = float32, 1 = bfloat16) and
// the device ordinal.  The launch goes on the given stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() as an
// int (0 = success; repro_error_string(code) names any other).  All arrays
// are row-major and contiguous.
//
//   int repro_sparse_row_groups(int n, long long p, int dtype);
//       the number G of row groups the kernel splits the n rows into for
//       (n, p, dtype); the aggregate leg needs a (G, p) f32 scratch when
//       G > 1.
//
//   int repro_sparse_mix_aggregate(
//       const int* idx,       // (n, d_max) int32 in-neighbours, in [0, n)
//       const float* w,       // (n, d_max) f32 weights (padding: index 0, 0.0)
//       const float* wrow,    // (n,) f32 combine row, or NULL
//       const void* X,        // (n, p) f32 | bf16 payload
//       void* mixed,          // (n, p) out, X's dtype
//       float* agg,           // (p,) f32 out, NULL iff wrow is NULL
//       float* partial,       // (G, p) f32 scratch when G > 1 and agg != NULL
//       int n, int d_max, long long p, int dtype, int device, void* stream);
//
// Arithmetic, as the reference's _gather_mix: for every slot k = 0 .. d_max-1
// in order, padding slots included, acc = acc + w[i, k] * X[idx[i, k]] with
// the product and the sum each rounded to fp32 (__fmul_rn / __fadd_rn: no
// contraction into an FMA), so the kernel gives bitwise its plain version
// (ref.py::sparse_mix_ref) and a non-finite payload propagates as there.
// mixed is rounded once to X's dtype (round-to-nearest-even).  agg is an
// fp32 FMA sum over the rows.
//
// Bound: bytes.  X is read once and mixed written once (2 n p itemsize),
// while the work is 2 nnz p flops, about d_max flops a byte: at the
// paper's shape (70 x 1,663,488 f32, d_max <= 10) 931.6 MB, 0.278 ms at
// 3.35 TB/s against ~0.03 ms of fp32 FMA.
//
// Design (simple first; shared-memory staging or TMA of the neighbour slab
// is later work):
//   * A block of 256 threads owns a column tile of 256 x 16 bytes (1,024
//     f32 or 2,048 bf16 columns; a thread 16 neighbouring bytes, loaded as
//     one vector when p and the pointers allow it, else as 4 or 8 strided
//     coalesced scalars) and walks a contiguous range of output rows.
//     Rows go on gridDim.x together with the tiles (never on y or z, which
//     stop at 65,535): block b takes tile b % tiles, row group b / tiles.
//   * Neighbour rows are gathered straight from global memory through the
//     read-only path (__ldg).  Within a cluster the same neighbour rows of
//     the tile are read again by the next rows of the block, so L1 and the
//     50 MB L2 serve the repeats and HBM sees X about once.  mixed goes out
//     with streaming stores (__stcs) so it does not push X out of L2.
//   * d_max is a runtime value.  The slot loop is unrolled up to a template
//     bound D in {2, 4, 8, 16} (slots >= d_max predicated off), so all of a
//     row's gathers are in flight at once; larger d_max (hub and
//     preferential-attachment clusters) takes a generic loop.
//   * Row offsets idx * p are 64-bit: 100,000 x 1.66 M overflows int32.
//   * The aggregate leg reads each row i of the block's range once more
//     (an L1/L2 hit when i is its own neighbour) and accumulates
//     wrow[i] * X[i].  The rows are split into G groups only when the
//     tiles alone give too few blocks (large n, small p); then each group
//     writes its partial row to scratch and a second kernel sums the G
//     partials in a fixed order, so agg is deterministic (no atomics).
//     G depends on (n, p, dtype) only, never on the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTargetBlocks = 1024;   // ~8 resident a SM on 132 SMs
constexpr int kMinRowsPerBlock = 64;

// E values of type T make up the 16 bytes a thread owns.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load_vec(const float* p, float* v) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ __forceinline__ static float load1(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void store_vec(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  __device__ __forceinline__ static void store1(float* p, float v) {
    __stcs(p, v);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load_vec(const __nv_bfloat16* p,
                                                  float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(&words[j]);
      const float2 f = __bfloat1622float2(h);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float load1(const __nv_bfloat16* p) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(bits));
  }
  __device__ __forceinline__ static void store_vec(__nv_bfloat16* p,
                                                   const float* v) {
    uint32_t words[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      words[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(words[0], words[1], words[2], words[3]));
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* p, float v) {
    const __nv_bfloat16 h = __float2bfloat16(v);   // round-to-nearest-even
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(h));
  }
};

// The E columns of one row that this thread owns.  VEC: E contiguous
// columns at col (p % E == 0, so all or none are inside p); scalar: columns
// col + j * kThreads, each masked against p.
template <typename T, bool VEC>
struct Row {
  static constexpr int E = Elt<T>::E;
  __device__ __forceinline__ static void load(const T* row, long long col,
                                              long long p, float* v) {
    if constexpr (VEC) {
      Elt<T>::load_vec(row + col, v);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const long long c = col + (long long)j * kThreads;
        v[j] = c < p ? Elt<T>::load1(row + c) : 0.f;
      }
    }
  }
  __device__ __forceinline__ static void store(T* row, long long col,
                                               long long p, const float* v) {
    if constexpr (VEC) {
      Elt<T>::store_vec(row + col, v);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const long long c = col + (long long)j * kThreads;
        if (c < p) Elt<T>::store1(row + c, v[j]);
      }
    }
  }
  // the same E columns of an f32 row (the aggregate leg)
  __device__ __forceinline__ static void store_f32(float* row, long long col,
                                                   long long p,
                                                   const float* v) {
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < E; q += 4)
        *reinterpret_cast<float4*>(row + col + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const long long c = col + (long long)j * kThreads;
        if (c < p) row[c] = v[j];
      }
    }
  }
};

// acc += w * X[j] over this thread's columns, product and sum rounded
// separately (the reference's `acc + w * take(x, j)`).
template <typename T, bool VEC>
__device__ __forceinline__ void gather_slot(const T* __restrict__ X, int j,
                                            float wk, long long col,
                                            long long p, float* acc) {
  constexpr int E = Elt<T>::E;
  float v[E];
  Row<T, VEC>::load(X + (long long)j * p, col, p, v);
#pragma unroll
  for (int q = 0; q < E; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(wk, v[q]));
}

// D > 0: slot loop unrolled to D with slots >= d_max predicated off
// (d_max <= D); D == 0: generic loop.
template <typename T, bool VEC, int D>
__global__ void __launch_bounds__(kThreads)
sparse_mix_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ wrow, const T* __restrict__ X,
                  T* __restrict__ mixed, float* __restrict__ agg_rows, int n,
                  int d_max, long long p, long long tiles,
                  int rows_per_block) {
  constexpr int E = Elt<T>::E;
  constexpr long long kTile = (long long)kThreads * E;
  const long long tile = blockIdx.x % tiles;
  const long long group = blockIdx.x / tiles;
  const long long col = tile * kTile + (VEC ? threadIdx.x * E : threadIdx.x);
  if (col >= p) return;          // VEC: p % E == 0, the whole vector is out
  const int r0 = (int)(group * rows_per_block);
  const int r1 = min(n, r0 + rows_per_block);

  float aacc[E];
#pragma unroll
  for (int q = 0; q < E; ++q) aacc[q] = 0.f;

  for (int i = r0; i < r1; ++i) {
    const int* ip = idx + (long long)i * d_max;
    const float* wp = w + (long long)i * d_max;
    float acc[E];
#pragma unroll
    for (int q = 0; q < E; ++q) acc[q] = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (k < d_max) gather_slot<T, VEC>(X, __ldg(ip + k), __ldg(wp + k),
                                           col, p, acc);
    } else {
#pragma unroll 4
      for (int k = 0; k < d_max; ++k)
        gather_slot<T, VEC>(X, __ldg(ip + k), __ldg(wp + k), col, p, acc);
    }
    Row<T, VEC>::store(mixed + (long long)i * p, col, p, acc);
    if (wrow != nullptr) {
      float v[E];
      Row<T, VEC>::load(X + (long long)i * p, col, p, v);
      const float wi = __ldg(wrow + i);
#pragma unroll
      for (int q = 0; q < E; ++q) aacc[q] = fmaf(wi, v[q], aacc[q]);
    }
  }
  if (wrow != nullptr)
    Row<T, VEC>::store_f32(agg_rows + group * p, col, p, aacc);
}

// agg[c] = sum_g partial[g, c], g in a fixed order: a 32 x 8 block takes 32
// columns, thread row y sums groups y, y + 8, ..., then row 0 adds the
// eight stripes in order.
__global__ void __launch_bounds__(kThreads)
sum_groups_kernel(const float* __restrict__ partial, float* __restrict__ agg,
                  int groups, long long p) {
  __shared__ float s[8][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < p)
    for (int g = threadIdx.y; g < groups; g += 8)
      acc += partial[(long long)g * p + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < p) {
    float t = s[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 8; ++y) t += s[y][threadIdx.x];
    agg[c] = t;
  }
}

template <typename T>
long long tiles_of(long long p) {
  const long long tile = (long long)kThreads * Elt<T>::E;
  return (p + tile - 1) / tile;
}

int rows_per_block_of(int n, long long tiles) {
  long long rows = (n * tiles + kTargetBlocks - 1) / kTargetBlocks;
  if (rows < kMinRowsPerBlock) rows = kMinRowsPerBlock;
  if (rows > n) rows = n;
  return rows < 1 ? 1 : (int)rows;
}

template <typename T, bool VEC, int D>
cudaError_t launch_d(const int* idx, const float* w, const float* wrow,
                     const void* X, void* mixed, float* agg_rows, int n,
                     int d_max, long long p, long long tiles, int rows,
                     int groups, cudaStream_t stream) {
  const long long blocks = tiles * groups;
  sparse_mix_kernel<T, VEC, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      idx, w, wrow, static_cast<const T*>(X), static_cast<T*>(mixed),
      agg_rows, n, d_max, p, tiles, rows);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(const int* idx, const float* w, const float* wrow,
                       const void* X, void* mixed, float* agg_rows, int n,
                       int d_max, long long p, cudaStream_t stream) {
  const long long tiles = tiles_of<T>(p);
  const int rows = rows_per_block_of(n, tiles);
  const int groups = (n + rows - 1) / rows;
  if (d_max <= 2)
    return launch_d<T, VEC, 2>(idx, w, wrow, X, mixed, agg_rows, n, d_max, p,
                               tiles, rows, groups, stream);
  if (d_max <= 4)
    return launch_d<T, VEC, 4>(idx, w, wrow, X, mixed, agg_rows, n, d_max, p,
                               tiles, rows, groups, stream);
  if (d_max <= 8)
    return launch_d<T, VEC, 8>(idx, w, wrow, X, mixed, agg_rows, n, d_max, p,
                               tiles, rows, groups, stream);
  if (d_max <= 16)
    return launch_d<T, VEC, 16>(idx, w, wrow, X, mixed, agg_rows, n, d_max,
                                p, tiles, rows, groups, stream);
  return launch_d<T, VEC, 0>(idx, w, wrow, X, mixed, agg_rows, n, d_max, p,
                             tiles, rows, groups, stream);
}

template <typename T>
int row_groups(int n, long long p) {
  const int rows = rows_per_block_of(n, tiles_of<T>(p));
  return (n + rows - 1) / rows;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_sparse_row_groups(int n, long long p, int dtype) {
  if (n <= 0 || p <= 0) return 1;
  return dtype == 1 ? row_groups<__nv_bfloat16>(n, p) : row_groups<float>(n, p);
}

int repro_sparse_mix_aggregate(const int* idx, const float* w,
                               const float* wrow, const void* X, void* mixed,
                               float* agg, float* partial, int n, int d_max,
                               long long p, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || p <= 0) return (int)cudaGetLastError();
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((wrow == nullptr) != (agg == nullptr) || d_max < 0)
    return (int)cudaErrorInvalidValue;
  const int groups = repro_sparse_row_groups(n, p, dtype);
  if (agg != nullptr && groups > 1 && partial == nullptr)
    return (int)cudaErrorInvalidValue;
  float* agg_rows = groups > 1 ? partial : agg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads and stores need whole vectors per row and 16-byte bases
  const int e = dtype == 0 ? 4 : 8;
  const bool vec = p % e == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mixed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(agg_rows) % 16 == 0;
  if (dtype == 0)
    err = vec ? launch_vec<float, true>(idx, w, wrow, X, mixed, agg_rows, n,
                                        d_max, p, s)
              : launch_vec<float, false>(idx, w, wrow, X, mixed, agg_rows, n,
                                         d_max, p, s);
  else
    err = vec ? launch_vec<__nv_bfloat16, true>(idx, w, wrow, X, mixed,
                                                agg_rows, n, d_max, p, s)
              : launch_vec<__nv_bfloat16, false>(idx, w, wrow, X, mixed,
                                                 agg_rows, n, d_max, p, s);
  if (err != cudaSuccess || agg == nullptr || groups == 1) return (int)err;
  sum_groups_kernel<<<(unsigned)((p + 31) / 32), dim3(32, 8), 0, s>>>(
      partial, agg, groups, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
