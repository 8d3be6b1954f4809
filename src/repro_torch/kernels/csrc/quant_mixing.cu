// Graph-mixing kernels over a quantized payload, for Hopper (sm_90a): the
// port of the three Pallas TPU kernels with a fused dequant epilogue.
//
//   repro_aggregate_dequant      replaces repro/kernels/mixing/fused.py::
//                                aggregate_dequant_pallas (_agg_dequant_kernel):
//                                agg = w @ deq(Xq, S)
//   repro_mix_aggregate_dequant  replaces fused.py::mix_aggregate_dequant_pallas
//                                (_fused_dequant_kernel):
//                                mixed = A @ deq(Xq, S), agg = w @ deq(Xq, S)
//   repro_sparse_mix_aggregate_dequant
//                                replaces repro/kernels/mixing/sparse.py::
//                                sparse_mix_aggregate_dequant_pallas
//                                (_sparse_fused_dequant_kernel): the ELL gather
//                                mixed[i] = sum_k w[i, k] * x[idx[i, k]] and
//                                agg = wrow @ x over x = deq(Xq, S)
//
// Build (one shared library per source, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py; the source includes csrc/staged.cuh, whose
// edits therefore rename this library too):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libquant_mixing.so quant_mixing.cu
//
// The wire format (repro_torch/fl/packing.py::QuantSpec).  Xq holds the
// stored containers of an (n, p) payload, row-major: 'int8' one int8 a
// value (p bytes a row), 'int4' two values a byte with the even column in
// the low nibble (p / 2 bytes a row), 'fp8' one float8_e4m3fn a value.
// S (n, p / block) holds one fp32 scale per row and block of `block`
// columns; block is a positive multiple of 128 (of 256 for int4), so p is
// too.  The dequantized value is
//
//   deq(Xq, S)[i, c] = float(v[i, c]) * S[i, c / block]
//
// with v the int8 value, the sign-extended nibble or the e4m3 value (all
// exact in fp32), and the product rounded once (__fmul_rn, which nvcc never
// contracts into the following FMA): bitwise packing.dequantize_group.  The
// dequantized payload exists only in registers and shared memory, never in
// device memory.  Outputs are fp32.
//
// C ABI.  Device pointers and the CUDA stream are void* (ctypes.c_void_p),
// sizes int / long long, `storage` 0 = int8, 1 = int4, 2 = fp8, and the
// device ordinal.  Each entry point launches on the given stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() as an int
// (0 = success; repro_error_string(code) names any other).  Xq must be
// 16-byte aligned; every array is contiguous.
//
//   int repro_aggregate_dequant_row_groups(int n, long long p, int storage);
//       the number G of row groups the aggregate_dequant GEMV splits the n
//       rows into (csrc/row_groups.cuh); a launch needs a (G, p) f32
//       scratch when G > 1.  -1 for an unknown storage.
//
//   int repro_aggregate_dequant(const float* w,   // (n,) f32 combine row
//                               const void* Xq, const float* S,
//                               float* agg,       // (p,) f32 out
//                               float* partial,   // (G, p) f32 if G > 1
//                               int n, long long p, int block, int storage,
//                               int device, void* stream);
//
//   int repro_mix_aggregate_dequant(const float* B,  // (n + 1, n): [A; w]
//                                   const void* Xq, const float* S,
//                                   float* mixed,    // (n, p) f32 out
//                                   float* agg,      // (p,) f32 out
//                                   int n, long long p, int block,
//                                   int storage, int device, void* stream,
//                                   int* route);  // out: 1 staged, 0 generic
//
//   int repro_sparse_dequant_row_groups(int n, long long p);
//       the number G of row groups the generic route of the sparse kernel
//       splits the n rows into; its aggregate leg needs a (G, p) f32
//       scratch when G > 1.  The staged route never splits (G = 1) and
//       leaves the scratch untouched.
//
//   int repro_sparse_mix_aggregate_dequant(
//       const int* idx,      // (n, d_max) int32 in-neighbours, in [0, n)
//       const float* w,      // (n, d_max) f32 weights (padding: index 0, 0.0)
//       const float* wrow,   // (n,) f32 combine row
//       const void* Xq, const float* S,
//       float* mixed,        // (n, p) f32 out
//       float* agg,          // (p,) f32 out
//       float* partial,      // (G, p) f32 scratch when G > 1
//       int n, int d_max, long long p, int block, int storage,
//       int device, void* stream,
//       int* route);         // out: 1 staged, 0 generic (set on success)
//
// Arithmetic.  mix_aggregate accumulates fmaf(w, deq, acc) over the rows
// in order (fp32, no tensor cores); aggregate does too within each of its
// row ranges and adds the ranges' partial rows in a fixed order
// (csrc/row_groups.cuh).  The sparse kernel does,
// for every slot k = 0 .. d_max-1 in order, padding slots included,
// acc = acc + w[i, k] * deq(X)[idx[i, k]] with the product and the sum
// rounded apart (__fmul_rn / __fadd_rn), as the reference's _gather_mix:
// its mixed output is bitwise its plain version's
// (ref.py::sparse_mix_aggregate_dequant_ref); its agg is an fp32 FMA sum.
//
// Routes of mix_aggregate_dequant and sparse_mix_aggregate_dequant; the
// rule is static (no fallback between them: a launch that fails raises):
//
//   staged   when n <= kStagedRows (128), for the ELL also d_max <=
//            kStagedSlots (64), and mixed and agg are 16-byte aligned
//            (Xq always is and p % 128 == 0, so every container row and
//            128-column tile meets TMA's 16-byte rules and no tile is
//            ragged);
//   generic  otherwise (n = 129 and up, the n = 100,000 ring, d_max > 64):
//            the first kernels, mix_aggregate_dequant_kernel and
//            sparse_mix_dequant_kernel below.
//
// Staged route (mix_dequant_staged_kernel, sparse_dequant_staged_kernel):
//   * csrc/staged.cuh's persistent CTAs (8 consumer warps + a producer
//     warp) walk 128-column tiles, and the producer keeps a two-stage ring
//     of container slabs (all n rows of a tile: 128 bytes a row for int8 /
//     fp8, 64 for int4) filled by 1-D TMA bulk copies, so HBM sees the
//     payload once.  A tile lies inside one scale block, so it needs n
//     scales.  TMA cannot move them (a row of S is p / block * 4 bytes,
//     not a multiple of 16 at the paper's shape), so consumer thread t < n
//     loads row t's scale of the next tile with __ldg while this tile
//     computes and stores it to a shared row before the barrier that
//     precedes the next decode, so the load's latency stays out of the
//     decode pass (a dependent __ldg in each decode iteration left the
//     dense kernel well behind its fp32 twin on the H100).
//   * Once a tile, the 256 consumer threads decode the landed container
//     slab into one fp32 slab (n x 512 bytes), each value once (Word::
//     decode, __fmul_rn by its row's scale: bitwise dequantize_group), and
//     release the container stage so the producer refills it early.  The
//     decode is the generic kernels' (I2FP / I2F.S8, F2FP + HADD2.F32 for
//     fp8); exact bit-trick decodes on the FP32 / INT pipes timed no
//     faster here, since a tile decodes each value once.  A
//     named barrier separates the decode from the compute; the dense kernel
//     takes a second one before the decode (every warp done reading the
//     previous tile's slab), the ELL kernel's agg barrier already is one.
//     One fp32 slab, not two, keeps the paper's shape at two CTAs an SM
//     (dense, ~81 KB) or three (ELL, ~63 KB); n = 128 fits one (~180 KB,
//     ~169 KB at d_max 64).
//   * The compute loops are the fp32 staged kernels' on the fp32 slab:
//     dense, B = [A; w] resident as Bs[k][q * RMP + r], warp q rows q * RM
//     .. q * RM + RM - 1, fmaf in k order; ELL, idx / w / wrow resident,
//     warp q rows q, q + 8, ..., slots in order with __fmul_rn /
//     __fadd_rn, padding slots included, the eight warps' agg partials
//     added in warp order.  So on the same dequantized values both outputs
//     of both kernels equal the fp32 staged kernels' bitwise
//     (csrc/mixing.cu, csrc/sparse_mixing.cu), and the ELL mixed output
//     its plain version's.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "row_groups.cuh"
#include "staged.cuh"

namespace {

constexpr int kInt8 = 0, kInt4 = 1, kFp8 = 2;

// ---------------------------------------------------------------------------
// Decoding.  One 32-bit container word holds 4 int8 / fp8 values (byte j =
// column j) or 8 int4 values (nibble j = column j: byte j / 2, low nibble
// for even j).  Every conversion is exact.
// ---------------------------------------------------------------------------

template <int ST>
struct Word {
  static constexpr int kVals = ST == kInt4 ? 8 : 4;   // values a word
  __device__ __forceinline__ static void decode(uint32_t u, float* v) {
    if constexpr (ST == kInt8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)      // shift the byte to the top, extend
        v[j] = (float)((int32_t)(u << (24 - 8 * j)) >> 24);
    } else if constexpr (ST == kInt4) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (float)((int32_t)(u << (28 - 4 * j)) >> 28);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __half_raw h = __nv_cvt_fp8_to_halfraw(
            (__nv_fp8_storage_t)((u >> (8 * j)) & 0xFFu), __NV_E4M3);
        v[j] = __half2float(__half(h));   // e4m3 -> f16 -> f32, exact
      }
    }
  }
};

// W container words -> W * kVals values, each times the row's block scale
// s, one rounded product each.
template <int ST, int W>
__device__ __forceinline__ void dequant_words(const uint32_t (&u)[W], float s,
                                              float* v) {
  constexpr int K = Word<ST>::kVals;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    float t[K];
    Word<ST>::decode(u[q], t);
#pragma unroll
    for (int j = 0; j < K; ++j) v[q * K + j] = __fmul_rn(t[j], s);
  }
}

// ---------------------------------------------------------------------------
// aggregate_dequant: agg[c] = sum_i w[i] * deq(Xq, S)[i, c]
//
// Bound: bytes.  The compressed payload is read once (n p bits / 8), the
// scales once (n p / block * 4) and the f32 row written once (4 p): at the
// paper's shape (70 x 1,663,488, block 512) 124.0 MB for int8 / fp8, so
// ~0.037 ms at 3.35 TB/s, and 65.8 MB (~0.020 ms) for int4; at the scale
// round's (100,000 x 8,192) 826 MB (~0.247 ms) and 416 MB (~0.124 ms).
// The 2 n p flops are far under the fp32 rate, but the decode is not: at
// 3.35 TB/s an int4 payload brings 6.7 T values a second, more than the
// H100's int -> fp32 conversion units turn out (16 a clock an SM, ~4.2 T
// a second), so the GEMV decodes on the FP32 and INT pipes where that is
// faster (GemvWord, below).  Design: csrc/row_groups.cuh's GEMV on the
// container.  A thread owns one 16-byte container vector of a row (16
// int8 / fp8 or 32 int4 values, inside one scale block since the block is
// a multiple of 128 or 256 columns) and reads its row's scale with it; the
// layout, the row groups G and, for int4, the vector's width follow (n, p,
// storage) (aggregate_dequant_plan, below): at both main-path shapes the
// tall layout, G = 1 at the paper's (813 CTAs of 2 warps a strip for int8
// / fp8, 1,625 of 4 warps a strip on 8-byte vectors for int4), G = 66
// (int8 / fp8) or 132 (int4) at the scale round's.
// ---------------------------------------------------------------------------

// The GEMV's decoders: one 32-bit word of containers to kVals fp32 values,
// each exact (so the product with the scale is packing.dequantize_group's
// bitwise).  Timed in turns on the H100 against Word::decode's hardware
// conversions, per storage the faster:
//   int8  Word::decode (I2F.S8 reads the byte in place: one instruction a
//         value; the 2^23 trick below, two, was slower);
//   int4  each nibble, sign bit flipped (n + 8), under the exponent of
//         2^23 (__byte_perm): 2^23 + n + 8, minus 8,388,616.0f -- no
//         conversion unit, ~2.4 FP32 / INT instructions a value;
//   fp8   two values a conversion (cvt.rn.f16x2.e4m3x2, NaN codes 0x7F /
//         0xFF to NaN), then f16 -> f32.
template <int ST>
struct GemvWord {
  static constexpr int kVals = Word<ST>::kVals;
  __device__ __forceinline__ static void decode(uint32_t u, float* v) {
    if constexpr (ST == kInt8) {
      Word<ST>::decode(u, v);
    } else if constexpr (ST == kInt4) {
      const uint32_t lo = (u & 0x0F0F0F0Fu) ^ 0x08080808u;   // even columns
      const uint32_t hi = ((u >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(__byte_perm(lo, 0x4B000000u,
                                               0x7540u + j)) - 8388616.0f;
        v[2 * j + 1] = __uint_as_float(__byte_perm(hi, 0x4B000000u,
                                                   0x7540u + j)) -
                       8388616.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)((u >> (16 * j)) & 0xFFFFu), __NV_E4M3);
        const float2 f = __half22float2(__half2(h));
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    }
  }
};

// the GEMV's loader (csrc/row_groups.cuh): W container words of row r and
// the row's block scale -> W * kVals dequantized values
struct QuantArgs {
  const uint8_t* Xq;
  const float* S;
  int block;
};

template <int ST, int W>
struct QuantLoad {
  static constexpr int kVals = W * GemvWord<ST>::kVals;
  static constexpr int kUnroll = 8;
  using Args = QuantArgs;
  const uint8_t* x;
  const float* s;
  long long qcols, nb;
  __device__ QuantLoad(Args a, long long p, long long col)
      : x(a.Xq + col / kVals * (4 * W)), s(a.S + col / a.block),
        qcols(p / kVals * (4 * W)), nb(p / a.block) {}
  __device__ __forceinline__ void row(long long r, float* v) const {
    uint32_t u[W];
    if constexpr (W == 4) {
      const uint4 q = __ldcs(reinterpret_cast<const uint4*>(x + r * qcols));
      u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
    } else {
      static_assert(W == 2, "4 or 2 words a thread");
      const uint2 q = __ldcs(reinterpret_cast<const uint2*>(x + r * qcols));
      u[0] = q.x; u[1] = q.y;
    }
    const float sc = __ldg(s + r * nb);
    constexpr int K = GemvWord<ST>::kVals;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      float t[K];
      GemvWord<ST>::decode(u[q], t);
#pragma unroll
      for (int j = 0; j < K; ++j) v[q * K + j] = __fmul_rn(t[j], sc);
    }
  }
};

// The plan (csrc/row_groups.cuh) and the words a thread, each the faster
// of the variants timed in turns on the H100 at both main-path shapes:
// row groups aiming at one wave of CTAs (two were slower at the scale
// round's shape); 16 bytes a thread, and for int8 / fp8 tall CTAs of 2
// warps along the rows at the paper's n = 70 (35 rows a warp: 8 warps of
// 9 rows were slower).  int4 takes 8 bytes a thread (16 values) and 4
// warps along the rows when 16 bytes would need no row groups (the
// paper's shape), 16 bytes otherwise (8 were slower at the scale round's).
struct AggPlan {
  int words;            // container words a thread: 4 or 2
  rowsum::Plan plan;
};

template <int ST>
AggPlan aggregate_dequant_plan(int n, long long p) {
  constexpr int K = GemvWord<ST>::kVals;
  constexpr long long target = rowsum::kWave;
  if constexpr (ST == kInt4) {
    const rowsum::Plan full = rowsum::plan(n, p, 4 * K, 1, target);
    if (full.groups > 1) return {4, full};
    return {2, rowsum::plan(n, p, 2 * K, 16, target)};
  } else {
    return {4, rowsum::plan(n, p, 4 * K, 32, target)};
  }
}

template <int ST>
cudaError_t launch_aggregate_dequant(const float* w, const void* Xq,
                                     const float* S, float* agg,
                                     float* partial, int n, long long p,
                                     int block, cudaStream_t stream) {
  const AggPlan ap = aggregate_dequant_plan<ST>(n, p);
  const QuantArgs args{static_cast<const uint8_t*>(Xq), S, block};
  if (ap.words == 4)
    return rowsum::launch_gemv<QuantLoad<ST, 4>>(w, args, agg, partial, n, p,
                                                 ap.plan, stream);
  return rowsum::launch_gemv<QuantLoad<ST, 2>>(w, args, agg, partial, n, p,
                                               ap.plan, stream);
}

// ---------------------------------------------------------------------------
// mix_aggregate_dequant: Y = B @ deq(Xq, S) with B = [A; w] ((n + 1, n),
// f32).  Rows r < n of Y are the mixed deltas, row n the aggregate row,
// both f32.
//
// Bound: operations at the paper's shape.  Bytes: the payload read once,
// the scales, B, and the f32 mixed output written once (589.8 MB for int8:
// ~0.176 ms at 3.35 TB/s); operations 2 (n + 1) n p fp32 flops (16.5 GFLOP:
// ~0.247 ms at the 67 TFLOP/s non-tensor fp32 rate).  Design: the
// register-blocked tiled product of csrc/mixing.cu::mix_aggregate_kernel,
// with the X slab dequantized as it is staged:
//   * A block owns kColTile = 128 columns (inside one scale block, since the
//     block is a multiple of 128) and 16 RM output rows; thread (tx, ty) of
//     the 16 x 16 block computes RM rows times 8 columns.
//   * The reduction over n walks kTK = 16-row slabs.  Each thread loads the
//     container bytes of 8 consecutive values of one slab row (8 bytes for
//     int8 / fp8, 4 for int4) and that row's scale into registers before
//     the current slab is computed; when it stages them into shared memory
//     it decodes and multiplies them by the scale, so shared memory holds
//     fp32 values and the FMA loop is mix_aggregate_kernel's.
//   * p is a multiple of 128, so no column is ragged; rows >= n load a zero
//     container and a zero scale.  Any n works.
// ---------------------------------------------------------------------------

constexpr int kMixTX = 16;                       // threads along columns
constexpr int kMixTY = 16;                       // threads along rows
constexpr int kMixThreads = kMixTX * kMixTY;     // 256
constexpr int kColTile = 8 * kMixTX;             // 128 columns, 8 a thread
constexpr int kTK = 16;                          // reduction slab depth
constexpr int kRowsMax = 8;                      // RM <= 8: 128-row tiles
// one thread stages 8 values of one slab row: 16 threads a row, 16 rows
static_assert(kTK * kColTile == 8 * kMixThreads, "X slab: 8 values a thread");
static_assert(kTK * kMixTY == kMixThreads, "B slab: one element a thread");

template <int ST>
struct SlabLoad {
  static constexpr int W = ST == kInt4 ? 1 : 2;   // 32-bit words for 8 values
  uint32_t u[W];
  float s;
};

template <int ST>
__device__ __forceinline__ void load_xq_slab(const uint8_t* __restrict__ Xq,
                                             const float* __restrict__ S,
                                             int n, long long qcols,
                                             long long nb, long long sb,
                                             int k0, long long col0, int tid,
                                             SlabLoad<ST>& r) {
  constexpr int W = SlabLoad<ST>::W;
  const int kk = k0 + tid / (kColTile / 8);
  const long long col = col0 + (tid % (kColTile / 8)) * 8;
  if (kk < n) {
    const uint8_t* src = Xq + (long long)kk * qcols + col * W / 2;
    if constexpr (W == 2) {
      const uint2 q = __ldcs(reinterpret_cast<const uint2*>(src));
      r.u[0] = q.x;
      r.u[W - 1] = q.y;
    } else {
      r.u[0] = __ldcs(reinterpret_cast<const unsigned int*>(src));
    }
    r.s = __ldg(S + (long long)kk * nb + sb);
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) r.u[q] = 0u;
    r.s = 0.f;
  }
}

template <int ST>
__device__ __forceinline__ void store_xq_slab(float (*Xs)[kColTile], int tid,
                                              const SlabLoad<ST>& r) {
  float v[8];
  dequant_words<ST, SlabLoad<ST>::W>(r.u, r.s, v);
  float* dst = &Xs[tid / (kColTile / 8)][(tid % (kColTile / 8)) * 8];
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// B slab: columns k0 .. k0 + kTK of the block's 16 RM rows (as in
// csrc/mixing.cu).
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

template <int ST, int RM>
__global__ void __launch_bounds__(kMixThreads, 2)
mix_aggregate_dequant_kernel(const float* __restrict__ B,
                             const uint8_t* __restrict__ Xq,
                             const float* __restrict__ S,
                             float* __restrict__ mixed,
                             float* __restrict__ agg, int n, long long p,
                             int block) {
  constexpr int RMP = (RM + 3) / 4 * 4;          // rows padded for float4
  __shared__ __align__(16) float Xs[2][kTK][kColTile];
  __shared__ __align__(16) float Bs[2][kTK][kMixTY * RMP];

  const int R = n + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kMixTX + tx;
  const int row0 = blockIdx.y * (kMixTY * RM);
  const long long col0 = (long long)blockIdx.x * kColTile;
  const long long qcols = p * (ST == kInt4 ? 4 : 8) / 8;
  const long long nb = p / block;
  const long long sb = col0 / block;             // the tile's scale column

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  SlabLoad<ST> xr;
  float br[RM];
  auto fetch = [&](int k0) {
    load_xq_slab<ST>(Xq, S, n, qcols, nb, sb, k0, col0, tid, xr);
    load_b_slab<RM>(B, n, R, k0, row0, tid, br);
  };
  auto stash = [&](int buf) {
    store_xq_slab<ST>(Xs[buf], tid, xr);
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
    float* out = row < n ? mixed + (long long)row * p : agg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* a = acc[r] + 4 * h;
      *reinterpret_cast<float4*>(out + col0 + 64 * h + 4 * tx) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

template <int ST, int RM>
cudaError_t launch_mix_rm(const float* B, const void* Xq, const float* S,
                          float* mixed, float* agg, int n, long long p,
                          int block, cudaStream_t stream) {
  const int TR = kMixTY * RM;
  dim3 threads(kMixTX, kMixTY);
  dim3 grid((unsigned)(p / kColTile), (unsigned)((n + 1 + TR - 1) / TR));
  mix_aggregate_dequant_kernel<ST, RM><<<grid, threads, 0, stream>>>(
      B, static_cast<const uint8_t*>(Xq), S, mixed, agg, n, p, block);
  return cudaGetLastError();
}

template <int ST>
cudaError_t launch_mix(const float* B, const void* Xq, const float* S,
                       float* mixed, float* agg, int n, long long p,
                       int block, cudaStream_t stream) {
  // RM rows per thread: one row tile when n + 1 <= 128, else 128-row tiles
  int rm = (n + 1 + kMixTY - 1) / kMixTY;
  if (rm > kRowsMax) rm = kRowsMax;
  switch (rm) {
    case 1: return launch_mix_rm<ST, 1>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 2: return launch_mix_rm<ST, 2>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 3: return launch_mix_rm<ST, 3>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 4: return launch_mix_rm<ST, 4>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 5: return launch_mix_rm<ST, 5>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 6: return launch_mix_rm<ST, 6>(B, Xq, S, mixed, agg, n, p, block, stream);
    case 7: return launch_mix_rm<ST, 7>(B, Xq, S, mixed, agg, n, p, block, stream);
    default:
      return launch_mix_rm<ST, 8>(B, Xq, S, mixed, agg, n, p, block, stream);
  }
}

// ---------------------------------------------------------------------------
// sparse_mix_aggregate_dequant: the ELL gather kernel of
// csrc/sparse_mixing.cu on the container.
//
// Bound: bytes.  The payload and scales read once, the f32 mixed output
// written once, the ELL and the rows of agg: 589.8 MB (int8, ~0.176 ms) at
// the paper's shape; at n = 100,000 x 2,048 int8 (ring, d_max = 2)
// 1,025.6 MB, ~0.306 ms.  The 2 nnz p flops are a few a byte.  Design:
//   * A block of 256 threads owns a column tile of 2,048 values (a thread 8
//     neighbouring values: 8 container bytes, or 4 for int4, in one scale
//     block) and walks a contiguous range of output rows; rows go on
//     gridDim.x with the tiles (block b: tile b % tiles, row group
//     b / tiles), never on y or z.  Row offsets are 64-bit.
//   * Every slot gathers the neighbour row's container bytes and its own
//     block scale straight from global memory (__ldg; L1 / L2 serve the
//     re-reads within a cluster), dequantizes (__fmul_rn) and accumulates
//     acc = __fadd_rn(acc, __fmul_rn(w, x)).  mixed goes out with
//     streaming stores.
//   * d_max is unrolled up to a template bound D in {2, 4, 8, 16} (slots
//     >= d_max predicated off); larger d_max takes a generic loop.
//   * The aggregate leg reads each own row once more and accumulates
//     wrow[i] * x[i] with fmaf.  When the tiles alone give too few blocks
//     (large n, small p) the rows split into G groups; each writes a
//     partial row to scratch and a second kernel sums them in a fixed
//     order: no float atomics, agg is deterministic.  G depends on (n, p)
//     only.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kVals = 8;                          // values a thread
constexpr long long kTile = (long long)kThreads * kVals;   // 2,048 columns
constexpr long long kTargetBlocks = 1024;         // ~8 resident a SM
constexpr int kMinRowsPerBlock = 64;

// The 8 dequantized values of row j at columns col .. col + 7.
template <int ST>
__device__ __forceinline__ void load_row8(const uint8_t* __restrict__ Xq,
                                          const float* __restrict__ S,
                                          long long j, long long qcols,
                                          long long nb, long long col,
                                          long long sb, float* v) {
  constexpr int W = SlabLoad<ST>::W;
  const uint8_t* src = Xq + j * qcols + col * W / 2;
  uint32_t u[W];
  if constexpr (W == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
    u[0] = q.x;
    u[W - 1] = q.y;
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
  }
  dequant_words<ST, W>(u, __ldg(S + j * nb + sb), v);
}

template <int ST>
__device__ __forceinline__ void gather_slot(const uint8_t* __restrict__ Xq,
                                            const float* __restrict__ S,
                                            int j, float wk, long long qcols,
                                            long long nb, long long col,
                                            long long sb, float* acc) {
  float v[kVals];
  load_row8<ST>(Xq, S, j, qcols, nb, col, sb, v);
#pragma unroll
  for (int q = 0; q < kVals; ++q)
    acc[q] = __fadd_rn(acc[q], __fmul_rn(wk, v[q]));
}

template <int ST, int D>
__global__ void __launch_bounds__(kThreads)
sparse_mix_dequant_kernel(const int* __restrict__ idx,
                          const float* __restrict__ w,
                          const float* __restrict__ wrow,
                          const uint8_t* __restrict__ Xq,
                          const float* __restrict__ S,
                          float* __restrict__ mixed,
                          float* __restrict__ agg_rows, int n, int d_max,
                          long long p, int block, long long tiles,
                          int rows_per_block) {
  const long long tile = blockIdx.x % tiles;
  const long long group = blockIdx.x / tiles;
  const long long col = tile * kTile + threadIdx.x * kVals;
  if (col >= p) return;          // p % 128 == 0: all 8 values or none
  const long long qcols = p * SlabLoad<ST>::W / 2;
  const long long nb = p / block;
  const long long sb = col / block;
  const int r0 = (int)(group * rows_per_block);
  const int r1 = min(n, r0 + rows_per_block);

  float aacc[kVals];
#pragma unroll
  for (int q = 0; q < kVals; ++q) aacc[q] = 0.f;

  for (int i = r0; i < r1; ++i) {
    const int* ip = idx + (long long)i * d_max;
    const float* wp = w + (long long)i * d_max;
    float acc[kVals];
#pragma unroll
    for (int q = 0; q < kVals; ++q) acc[q] = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (k < d_max) gather_slot<ST>(Xq, S, __ldg(ip + k), __ldg(wp + k),
                                       qcols, nb, col, sb, acc);
    } else {
#pragma unroll 4
      for (int k = 0; k < d_max; ++k)
        gather_slot<ST>(Xq, S, __ldg(ip + k), __ldg(wp + k), qcols, nb, col,
                        sb, acc);
    }
    float* out = mixed + (long long)i * p + col;
    __stcs(reinterpret_cast<float4*>(out),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
    __stcs(reinterpret_cast<float4*>(out + 4),
           make_float4(acc[4], acc[5], acc[6], acc[7]));
    float v[kVals];
    load_row8<ST>(Xq, S, i, qcols, nb, col, sb, v);
    const float wi = __ldg(wrow + i);
#pragma unroll
    for (int q = 0; q < kVals; ++q) aacc[q] = fmaf(wi, v[q], aacc[q]);
  }
  float* ar = agg_rows + group * p + col;
  *reinterpret_cast<float4*>(ar) =
      make_float4(aacc[0], aacc[1], aacc[2], aacc[3]);
  *reinterpret_cast<float4*>(ar + 4) =
      make_float4(aacc[4], aacc[5], aacc[6], aacc[7]);
}

long long tiles_of(long long p) { return (p + kTile - 1) / kTile; }

int rows_per_block_of(int n, long long tiles) {
  long long rows = (n * tiles + kTargetBlocks - 1) / kTargetBlocks;
  if (rows < kMinRowsPerBlock) rows = kMinRowsPerBlock;
  if (rows > n) rows = n;
  return rows < 1 ? 1 : (int)rows;
}

template <int ST, int D>
cudaError_t launch_sparse_d(const int* idx, const float* w,
                            const float* wrow, const void* Xq,
                            const float* S, float* mixed, float* agg_rows,
                            int n, int d_max, long long p, int block,
                            long long tiles, int rows, int groups,
                            cudaStream_t stream) {
  const long long blocks = tiles * groups;
  sparse_mix_dequant_kernel<ST, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      idx, w, wrow, static_cast<const uint8_t*>(Xq), S, mixed, agg_rows, n,
      d_max, p, block, tiles, rows);
  return cudaGetLastError();
}

template <int ST>
cudaError_t launch_sparse(const int* idx, const float* w, const float* wrow,
                          const void* Xq, const float* S, float* mixed,
                          float* agg_rows, int n, int d_max, long long p,
                          int block, cudaStream_t stream) {
  const long long tiles = tiles_of(p);
  const int rows = rows_per_block_of(n, tiles);
  const int groups = (n + rows - 1) / rows;
#define REPRO_SPARSE_D(D)                                                   \
  return launch_sparse_d<ST, D>(idx, w, wrow, Xq, S, mixed, agg_rows, n,    \
                                d_max, p, block, tiles, rows, groups, stream)
  if (d_max <= 2) REPRO_SPARSE_D(2);
  if (d_max <= 4) REPRO_SPARSE_D(4);
  if (d_max <= 8) REPRO_SPARSE_D(8);
  if (d_max <= 16) REPRO_SPARSE_D(16);
  REPRO_SPARSE_D(0);
#undef REPRO_SPARSE_D
}

// ---------------------------------------------------------------------------
// The staged route of mix_aggregate_dequant and
// sparse_mix_aggregate_dequant (see the header): csrc/staged.cuh's ring on
// the container bytes, one decode pass a tile into an fp32 slab, then the
// compute loops of csrc/mixing.cu::mix_staged_kernel and
// csrc/sparse_mixing.cu::sparse_mix_staged_kernel on that slab.

constexpr int kStagedRows = 128;      // n limit
constexpr int kStagedSlots = 64;      // d_max limit (the ELL)
constexpr int kStagedCols = 128;      // columns a tile: one scale block's
constexpr int kF32Row = kStagedCols * 4;   // bytes of a decoded slab row
constexpr int kStagedRM = (kStagedRows + 1 + staged::kConsumerWarps - 1) /
                          staged::kConsumerWarps;     // RM <= 17

// bytes of a container slab row: the tile's columns in the wire format
__host__ __device__ constexpr int container_row(int st) {
  return st == kInt4 ? kStagedCols / 2 : kStagedCols;
}

// The decode pass of a tile.  `scale` is consumer thread t's scale of
// tile `tile` (row t, t < n), which the kernels load one tile ahead into
// the shared row sc; `run` turns the landed container slab of local tile j
// into the fp32 slab xf (n rows of kStagedCols values), each value decoded
// once and multiplied by its row's scale from sc (dequant_words: bitwise
// packing.dequantize_group), then releases the container stage.  A
// consumers_sync() must separate `run` from any read of xf and from the
// writes of sc before it and after it.
template <int ST>
struct Decode {
  static constexpr int kWords = container_row(ST) / 4;   // words a row

  __device__ __forceinline__ static float scale(const float* __restrict__ S,
                                                int n, long long nb,
                                                int block, long long tile,
                                                long long tiles) {
    return (int)threadIdx.x < n && tile < tiles
               ? __ldg(S + threadIdx.x * nb + tile * kStagedCols / block)
               : 0.f;
  }

  __device__ __forceinline__ static void run(const staged::Ring& ring,
                                             const unsigned char* smem,
                                             int j, float* xf,
                                             const float* sc, int n) {
    constexpr int K = Word<ST>::kVals;                   // values a word
    const uint32_t* q = reinterpret_cast<const uint32_t*>(
        smem + ring.slab_offset(j % staged::kStages));
    for (int e = threadIdx.x; e < n * kWords; e += staged::kConsumers) {
      const int r = e / kWords;
      const uint32_t u[1] = {q[e]};
      float v[K];
      dequant_words<ST, 1>(u, sc[r], v);
      float* dst = xf + r * kStagedCols + (e % kWords) * K;
#pragma unroll
      for (int t = 0; t < K; t += 4)
        *reinterpret_cast<float4*>(dst + t) =
            make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
    }
    ring.release(j);
  }
};

// mix_aggregate_dequant, staged.  Dynamic shared memory: the ring of
// container slabs, the fp32 slab xf, Bs[k][q * RMP + r] = B[q * RM + r, k]
// (zero for r >= RM or rows > n), resident, and the scale row sc.  Warp q
// computes rows q * RM .. q * RM + RM - 1, a lane 4 columns, with fmaf in
// k order: the same sums as mix_staged_kernel on the dequantized payload.
template <int ST, int RM>
__global__ void __launch_bounds__(staged::kThreads, 1)
mix_dequant_staged_kernel(const float* __restrict__ B,
                          const uint8_t* __restrict__ Xq,
                          const float* __restrict__ S,
                          float* __restrict__ mixed, float* __restrict__ agg,
                          int n, long long p, int block, long long tiles) {
  constexpr int W = staged::kConsumerWarps;
  constexpr int RMP = (RM + 3) / 4 * 4;          // rows padded for float4
  extern __shared__ __align__(16) unsigned char smem[];
  const staged::Ring ring(smem, n, container_row(ST));
  float* xf = reinterpret_cast<float*>(smem + ring.slab_offset(staged::kStages));
  float* Bs = xf + n * kStagedCols;
  float* sc = Bs + n * W * RMP;
  const int R = n + 1;
  const long long nb = p / block;

  if (threadIdx.x == 0) ring.init();
  for (int e = threadIdx.x; e < n * W * RMP; e += blockDim.x) {
    const int k = e / (W * RMP), q = (e / RMP) % W, r = e % RMP;
    const int row = q * RM + r;
    Bs[e] = (r < RM && row < R) ? B[(long long)row * n + k] : 0.f;
  }
  if ((int)threadIdx.x < n)
    sc[threadIdx.x] = Decode<ST>::scale(S, n, nb, block, blockIdx.x, tiles);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == W) {
    ring.produce(Xq, p / kStagedCols * container_row(ST), tiles);
    return;
  }
  const float* bw = Bs + warp * RMP;
  const unsigned char* xs =
      reinterpret_cast<const unsigned char*>(xf) + lane * 16;
  int j = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    ring.wait_full(j);
    staged::consumers_sync();      // xf read and sc written by every warp
    Decode<ST>::run(ring, smem, j, xf, sc, n);
    staged::consumers_sync();
    // the next tile's scale, in flight while this tile computes
    const float s_next =
        Decode<ST>::scale(S, n, nb, block, tile + gridDim.x, tiles);
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 x4 = *reinterpret_cast<const float4*>(xs + k * kF32Row);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
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
    if ((int)threadIdx.x < n) sc[threadIdx.x] = s_next;
    const long long col = tile * kStagedCols + lane * 4;   // p % 128 == 0
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = warp * RM + r;
      if (row > n) break;
      float* out = row < n ? mixed + (long long)row * p + col : agg + col;
      __stcs(reinterpret_cast<float4*>(out),
             make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
}

// sparse_mix_aggregate_dequant, staged.  Dynamic shared memory: the ring
// of container slabs, the fp32 slab xf, idx / w (n rows of dp = d_max
// rounded up to 4 slots: a row's slots load 4 at a time as 16-byte
// broadcasts) and wrow (n), one row of the consumer warps' agg partials,
// and the scale row sc.  Warp q computes rows q, q + 8, ...; a lane owns 4
// columns, so each gather is one 16-byte load from xf.  The sums are
// sparse_mix_staged_kernel's.
__host__ __device__ inline int padded_slots(int d_max) {
  return (d_max + 3) / 4 * 4;
}

__host__ __device__ inline long long staged_lists_bytes(int n, int d_max) {
  return ((long long)n * (2 * padded_slots(d_max) + 1) * 4 + 15) / 16 * 16;
}

template <int ST, int D>
__global__ void __launch_bounds__(staged::kThreads, 1)
sparse_dequant_staged_kernel(const int* __restrict__ idx,
                             const float* __restrict__ w,
                             const float* __restrict__ wrow,
                             const uint8_t* __restrict__ Xq,
                             const float* __restrict__ S,
                             float* __restrict__ mixed,
                             float* __restrict__ agg, int n, int d_max,
                             long long p, int block, long long tiles) {
  constexpr int W = staged::kConsumerWarps;
  constexpr int TC = kStagedCols;
  extern __shared__ __align__(16) unsigned char smem[];
  const staged::Ring ring(smem, n, container_row(ST));
  float* xf = reinterpret_cast<float*>(smem + ring.slab_offset(staged::kStages));
  unsigned char* lists = reinterpret_cast<unsigned char*>(xf + n * TC);
  const int dp = padded_slots(d_max);
  int* idx_s = reinterpret_cast<int*>(lists);
  float* w_s = reinterpret_cast<float*>(idx_s + n * dp);
  float* wrow_s = w_s + n * dp;
  float* part = reinterpret_cast<float*>(lists + staged_lists_bytes(n, d_max));
  float* sc = part + W * TC;
  const long long nb = p / block;

  if (threadIdx.x == 0) ring.init();
  for (int e = threadIdx.x; e < n * dp; e += blockDim.x) {
    const int i = e / dp, k = e % dp;
    idx_s[e] = k < d_max ? idx[i * d_max + k] : 0;
    w_s[e] = k < d_max ? w[i * d_max + k] : 0.f;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) wrow_s[e] = wrow[e];
  if ((int)threadIdx.x < n)
    sc[threadIdx.x] = Decode<ST>::scale(S, n, nb, block, blockIdx.x, tiles);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == W) {
    ring.produce(Xq, p / kStagedCols * container_row(ST), tiles);
    return;
  }
  const unsigned char* slab =
      reinterpret_cast<const unsigned char*>(xf) + lane * 16;
  int j = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    ring.wait_full(j);
    // every warp read xf and part and wrote sc last before the previous
    // tile's agg barrier
    Decode<ST>::run(ring, smem, j, xf, sc, n);
    staged::consumers_sync();
    // the next tile's scale, in flight while this tile computes
    const float s_next =
        Decode<ST>::scale(S, n, nb, block, tile + gridDim.x, tiles);
    const long long col = tile * TC + lane * 4;            // p % 128 == 0
    float aacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = warp; i < n; i += W) {
      const int* ip = idx_s + i * dp;
      const float* wp = w_s + i * dp;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      auto slot = [&](int id, float wk) {
        const float4 v = *reinterpret_cast<const float4*>(slab + id * kF32Row);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wk, v.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(wk, v.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(wk, v.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(wk, v.w));
      };
      // slots k4 .. k4 + 3, in order, those < d_max
      auto slots4 = [&](int k4) {
        const int4 id = *reinterpret_cast<const int4*>(ip + k4);
        const float4 wk = *reinterpret_cast<const float4*>(wp + k4);
        slot(id.x, wk.x);
        if (k4 + 1 < d_max) slot(id.y, wk.y);
        if (k4 + 2 < d_max) slot(id.z, wk.z);
        if (k4 + 3 < d_max) slot(id.w, wk.w);
      };
      if constexpr (D > 0) {
#pragma unroll
        for (int k4 = 0; k4 < D; k4 += 4)
          if (k4 < d_max) slots4(k4);
      } else {
        for (int k4 = 0; k4 < d_max; k4 += 4) slots4(k4);
      }
      const float4 v = *reinterpret_cast<const float4*>(slab + i * kF32Row);
      const float wi = wrow_s[i];
      aacc[0] = fmaf(wi, v.x, aacc[0]);
      aacc[1] = fmaf(wi, v.y, aacc[1]);
      aacc[2] = fmaf(wi, v.z, aacc[2]);
      aacc[3] = fmaf(wi, v.w, aacc[3]);
      __stcs(reinterpret_cast<float4*>(mixed + (long long)i * p + col),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
    // the eight warps' partial rows, added in warp order
    *reinterpret_cast<float4*>(part + warp * TC + lane * 4) =
        make_float4(aacc[0], aacc[1], aacc[2], aacc[3]);
    if ((int)threadIdx.x < n) sc[threadIdx.x] = s_next;
    staged::consumers_sync();
    for (int c = threadIdx.x; c < TC; c += staged::kConsumers) {
      float t = part[c];
#pragma unroll
      for (int q = 1; q < W; ++q) t += part[q * TC + c];
      agg[tile * TC + c] = t;
    }
  }
}

template <int ST, int RM>
cudaError_t launch_mix_staged_rm(const float* B, const void* Xq,
                                 const float* S, float* mixed, float* agg,
                                 int n, long long p, int block, int device,
                                 cudaStream_t stream) {
  constexpr int RMP = (RM + 3) / 4 * 4;
  const long long tiles = p / kStagedCols;
  const long long slab = (long long)n * container_row(ST);
  const long long resident =
      (long long)n * kF32Row +
      (long long)n * staged::kConsumerWarps * RMP * sizeof(float) + n * 4;
  const long long smem = staged::smem_for(slab, resident);
  auto kernel = mix_dequant_staged_kernel<ST, RM>;
  unsigned grid = 0;
  cudaError_t err = staged::grid_for(kernel, smem, tiles, device, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, staged::kThreads, smem, stream>>>(
      B, static_cast<const uint8_t*>(Xq), S, mixed, agg, n, p, block, tiles);
  return cudaGetLastError();
}

// RM = ceil((n + 1) / 8): the instance RM0, RM0 + 1, ... that matches
template <int ST, int RM0 = 1>
cudaError_t launch_mix_staged(int rm, const float* B, const void* Xq,
                              const float* S, float* mixed, float* agg,
                              int n, long long p, int block, int device,
                              cudaStream_t stream) {
  if constexpr (RM0 > kStagedRM) {
    return cudaErrorInvalidValue;
  } else {
    if (rm == RM0)
      return launch_mix_staged_rm<ST, RM0>(B, Xq, S, mixed, agg, n, p, block,
                                           device, stream);
    return launch_mix_staged<ST, RM0 + 1>(rm, B, Xq, S, mixed, agg, n, p,
                                          block, device, stream);
  }
}

template <int ST, int D>
cudaError_t launch_sparse_staged_d(const int* idx, const float* w,
                                   const float* wrow, const void* Xq,
                                   const float* S, float* mixed, float* agg,
                                   int n, int d_max, long long p, int block,
                                   int device, cudaStream_t stream) {
  const long long tiles = p / kStagedCols;
  const long long slab = (long long)n * container_row(ST);
  const long long resident = (long long)n * kF32Row +
                             staged_lists_bytes(n, d_max) +
                             (long long)staged::kConsumerWarps * kF32Row +
                             n * 4;
  const long long smem = staged::smem_for(slab, resident);
  auto kernel = sparse_dequant_staged_kernel<ST, D>;
  unsigned grid = 0;
  cudaError_t err = staged::grid_for(kernel, smem, tiles, device, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, staged::kThreads, smem, stream>>>(
      idx, w, wrow, static_cast<const uint8_t*>(Xq), S, mixed, agg, n, d_max,
      p, block, tiles);
  return cudaGetLastError();
}

template <int ST>
cudaError_t launch_sparse_staged(const int* idx, const float* w,
                                 const float* wrow, const void* Xq,
                                 const float* S, float* mixed, float* agg,
                                 int n, int d_max, long long p, int block,
                                 int device, cudaStream_t stream) {
#define REPRO_STAGED_D(D)                                                    \
  return launch_sparse_staged_d<ST, D>(idx, w, wrow, Xq, S, mixed, agg, n,   \
                                       d_max, p, block, device, stream)
  // slots go 4 at a time, so D = 4 also serves d_max <= 2
  if (d_max <= 4) REPRO_STAGED_D(4);
  if (d_max <= 8) REPRO_STAGED_D(8);
  if (d_max <= 16) REPRO_STAGED_D(16);
  REPRO_STAGED_D(0);
#undef REPRO_STAGED_D
}

// The host-side checks every entry point shares: a valid storage code, a
// block the storage allows, p a multiple of it, a 16-byte aligned Xq.
bool valid_geometry(const void* Xq, long long p, int block, int storage) {
  if (storage < kInt8 || storage > kFp8) return false;
  const int unit = storage == kInt4 ? 256 : 128;
  if (block <= 0 || block % unit != 0 || p % block != 0) return false;
  return reinterpret_cast<uintptr_t>(Xq) % 16 == 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_aggregate_dequant_row_groups(int n, long long p, int storage) {
  if (storage == kInt8) return aggregate_dequant_plan<kInt8>(n, p).plan.groups;
  if (storage == kInt4) return aggregate_dequant_plan<kInt4>(n, p).plan.groups;
  if (storage == kFp8) return aggregate_dequant_plan<kFp8>(n, p).plan.groups;
  return -1;
}

int repro_aggregate_dequant(const float* w, const void* Xq, const float* S,
                            float* agg, float* partial, int n, long long p,
                            int block, int storage, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_geometry(Xq, p, block, storage) ||
      reinterpret_cast<uintptr_t>(agg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kInt8)
    return (int)launch_aggregate_dequant<kInt8>(w, Xq, S, agg, partial, n, p,
                                                block, s);
  if (storage == kInt4)
    return (int)launch_aggregate_dequant<kInt4>(w, Xq, S, agg, partial, n, p,
                                                block, s);
  return (int)launch_aggregate_dequant<kFp8>(w, Xq, S, agg, partial, n, p,
                                             block, s);
}

int repro_mix_aggregate_dequant(const float* B, const void* Xq,
                                const float* S, float* mixed, float* agg,
                                int n, long long p, int block, int storage,
                                int device, void* stream, int* route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_geometry(Xq, p, block, storage) ||
      reinterpret_cast<uintptr_t>(mixed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(agg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kStagedRows) {
    const int rm = (n + 1 + staged::kConsumerWarps - 1) /
                   staged::kConsumerWarps;
    if (storage == kInt8)
      err = launch_mix_staged<kInt8>(rm, B, Xq, S, mixed, agg, n, p, block,
                                     device, s);
    else if (storage == kInt4)
      err = launch_mix_staged<kInt4>(rm, B, Xq, S, mixed, agg, n, p, block,
                                     device, s);
    else
      err = launch_mix_staged<kFp8>(rm, B, Xq, S, mixed, agg, n, p, block,
                                    device, s);
    if (err == cudaSuccess) *route = 1;
    return (int)err;
  }
  if (storage == kInt8)
    err = launch_mix<kInt8>(B, Xq, S, mixed, agg, n, p, block, s);
  else if (storage == kInt4)
    err = launch_mix<kInt4>(B, Xq, S, mixed, agg, n, p, block, s);
  else
    err = launch_mix<kFp8>(B, Xq, S, mixed, agg, n, p, block, s);
  if (err == cudaSuccess) *route = 0;
  return (int)err;
}

int repro_sparse_dequant_row_groups(int n, long long p) {
  if (n <= 0 || p <= 0) return 1;
  const int rows = rows_per_block_of(n, tiles_of(p));
  return (n + rows - 1) / rows;
}

int repro_sparse_mix_aggregate_dequant(const int* idx, const float* w,
                                       const float* wrow, const void* Xq,
                                       const float* S, float* mixed,
                                       float* agg, float* partial, int n,
                                       int d_max, long long p, int block,
                                       int storage, int device,
                                       void* stream, int* route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_geometry(Xq, p, block, storage) || d_max < 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || p <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kStagedRows && d_max <= kStagedSlots &&
      reinterpret_cast<uintptr_t>(mixed) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(agg) % 16 == 0) {
    if (storage == kInt8)
      err = launch_sparse_staged<kInt8>(idx, w, wrow, Xq, S, mixed, agg, n,
                                        d_max, p, block, device, s);
    else if (storage == kInt4)
      err = launch_sparse_staged<kInt4>(idx, w, wrow, Xq, S, mixed, agg, n,
                                        d_max, p, block, device, s);
    else
      err = launch_sparse_staged<kFp8>(idx, w, wrow, Xq, S, mixed, agg, n,
                                       d_max, p, block, device, s);
    if (err == cudaSuccess) *route = 1;
    return (int)err;
  }
  const int groups = repro_sparse_dequant_row_groups(n, p);
  if (groups > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  float* agg_rows = groups > 1 ? partial : agg;
  if (reinterpret_cast<uintptr_t>(mixed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(agg_rows) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (storage == kInt8)
    err = launch_sparse<kInt8>(idx, w, wrow, Xq, S, mixed, agg_rows, n,
                               d_max, p, block, s);
  else if (storage == kInt4)
    err = launch_sparse<kInt4>(idx, w, wrow, Xq, S, mixed, agg_rows, n,
                               d_max, p, block, s);
  else
    err = launch_sparse<kFp8>(idx, w, wrow, Xq, S, mixed, agg_rows, n,
                              d_max, p, block, s);
  if (err == cudaSuccess && groups > 1) {
    err = rowsum::sum_groups(partial, agg, groups, p, s);
  }
  if (err == cudaSuccess) *route = 0;
  return (int)err;
}

}  // extern "C"
