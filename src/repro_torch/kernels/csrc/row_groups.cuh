// Row groups: a reduction over the n rows of an (n, p) payload split into
// G groups of consecutive rows, each group's partial row written to a
// (G, p) f32 scratch and the partials summed in a fixed order by a second
// kernel -- no float atomics, so the result depends on (n, p) alone and a
// rerun is bitwise.  Shared by csrc/sparse_mixing.cu and
// csrc/quant_mixing.cu (the generic ELL kernels' aggregate legs) and by the
// GEMV below, which csrc/mixing.cu (aggregate) and csrc/quant_mixing.cu
// (aggregate_dequant) instantiate.  Each source builds into its own
// library, so an edit here renames all three
// (repro_torch/kernels/_build.py).
//
// The GEMV: agg[c] = sum_i w[i] * x[i, c], x read once from device memory
// (fp32 / bf16 values, or int8 / int4 / fp8 containers decoded in
// registers).  Bound: the payload's bytes.  A thread owns V neighbouring
// columns (one 16-byte vector a row, 8 bytes for the int4 loader at small
// n) and a warp a strip of 32 V columns; the warp walks a range of rows
// with streaming loads (__ldcs: the payload is never reused), a few rows'
// loads in flight, and accumulates fmaf(w[i], x[i, c], acc) in row order.
// w comes 32 rows at a time, one coalesced load a warp, and goes to the
// lanes by __shfl_sync.  What fills the card is the number of warps
// streaming at once, so the layout follows the shape (plan(), below):
//
//   wide   (RW = 1) the 8 warps of a CTA take 8 neighbouring strips and
//          every row: the first design.  Taken when the strips alone give
//          a full wave of CTAs (kWave); the paper's fp32 payload (70 x
//          1,663,488: 1,625 CTAs) is one, and its agg is bitwise what the
//          first design gave.
//   tall   (RW = 8, 4 or 2) RW warps of a CTA share a strip and split its
//          rows into RW consecutive ranges (the CTA takes 8 / RW strips);
//          the CTA sums each strip's RW partials in warp order through
//          shared memory.  When the CTAs are still fewer than the caller's
//          target, they also split the rows into G > 1 groups
//          (blockIdx.y), each range at least kMinRows rows, and
//          sum_groups_kernel adds the G partial rows.
//
// Row r belongs to warp range q = r / R (R = ceil(n / (RW G)) rows, q =
// RW g + the warp's place along the rows in a CTA of group g), so agg =
// sum over g in sum_groups order of (sum over the strip's warps in order
// of (fmaf over the range's rows in order)).  The plan is a function of
// the shape and the caller's constants alone; a caller that loads fewer
// values a thread (an unaligned fp32 / bf16 payload) plans with the full
// vector's V and so sums in the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowsum {

// agg[c] = sum_g partial[g, c], g in a fixed order: a 32 x 8 block takes 32
// columns, thread row y sums groups y, y + 8, ..., then row 0 adds the
// eight stripes in order.
__global__ void __launch_bounds__(256)
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

inline cudaError_t sum_groups(const float* partial, float* agg, int groups,
                              long long p, cudaStream_t stream) {
  sum_groups_kernel<<<(unsigned)((p + 31) / 32), dim3(32, 8), 0, stream>>>(
      partial, agg, groups, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The GEMV.

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
// one wave of 256-thread CTAs on the H100's 132 SMs at 8 CTAs an SM (the
// most its 2,048 threads an SM hold); the wide layout from here up
constexpr long long kWave = 132LL * 8;
constexpr int kMinRows = 32;               // rows a warp range, when G > 1

struct Plan {
  int rw;                // warps along the rows of a CTA: 1, 2, 4 or 8
  int groups;            // G: CTAs along the rows (blockIdx.y)
  int rows;              // R: rows a warp range
};

// The layout and row groups of an (n, p) GEMV whose full-width loader
// owns V values a thread.  Tall CTAs take RW = 8 warps along the rows,
// fewer (4, 2) while a warp range would hold under min_tall_rows rows,
// and G row groups until there are target_ctas CTAs, each range keeping
// at least kMinRows rows.  The callers' constants were timed on the H100.
inline Plan plan(int n, long long p, int V, int min_tall_rows,
                 long long target_ctas) {
  const long long wide = (p + (long long)kThreads * V - 1) /
                         ((long long)kThreads * V);
  if (wide >= kWave || n <= 0) return Plan{1, 1, n};
  int rw = kWarps;
  while (rw > 2 && n / rw < min_tall_rows) rw /= 2;
  const long long cols = (long long)(kWarps / rw) * 32 * V;   // a CTA's
  const long long ctas = (p + cols - 1) / cols;
  long long g = (target_ctas + ctas - 1) / ctas;
  const long long most = (long long)n / ((long long)rw * kMinRows);
  if (g > most) g = most;
  if (g > 65535) g = 65535;
  if (g < 1) g = 1;
  const long long ranges = g * rw;
  return Plan{rw, (int)g, (int)((n + ranges - 1) / ranges)};
}

// L is the loader: L::kVals values a thread (V), L::kUnroll rows' loads in
// flight, L::Args its operands, and L(args, p, col).row(r, v) the V fp32
// values of row r at the thread's columns col .. col + V - 1.
template <class L, int RW>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const float* __restrict__ w, typename L::Args args,
            float* __restrict__ out, int n, long long p, int rows) {
  constexpr int V = L::kVals;
  constexpr int CW = kWarps / RW;          // strips a CTA
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long strip = (long long)blockIdx.x * CW + warp % CW;
  const long long col = (strip * 32 + lane) * V;
  const bool live = col < p;
  // a lane past p streams column 0's vector and stores nothing
  const L ld(args, p, live ? col : 0);
  const long long q = (long long)blockIdx.y * RW + warp / CW;
  const long long r_end = min((long long)n, (q + 1) * rows);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  for (long long r0 = q * rows; r0 < r_end; r0 += 32) {
    const int rn = (int)min(32LL, r_end - r0);
    const float wl = lane < rn ? __ldg(w + r0 + lane) : 0.f;
#pragma unroll (L::kUnroll)
    for (int i = 0; i < rn; ++i) {
      const float wr = __shfl_sync(0xffffffffu, wl, i);
      float v[V];
      ld.row(r0 + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wr, v[j], acc[j]);
    }
  }

  float* o = out + (long long)blockIdx.y * p;
  if constexpr (RW == 1) {
    if (live) {
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(o + col + j) =
              make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) o[col + j] = acc[j];
      }
    }
  } else {
    // red[k][j][l]: warp k's partial of value j of lane l's columns;
    // rows of 33 keep both the stores and the column-order reads below
    // clear of bank conflicts
    __shared__ float red[kWarps][V][33];
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp][j][lane] = acc[j];
    __syncthreads();
    const long long base = (long long)blockIdx.x * CW * 32 * V;
    for (int c = threadIdx.x; c < CW * 32 * V; c += kThreads) {
      const int cw = c / (32 * V), j = c % V, l = c % (32 * V) / V;
      float s = red[cw][j][l];
#pragma unroll
      for (int k = 1; k < RW; ++k) s += red[k * CW + cw][j][l];
      if (base + c < p) o[base + c] = s;
    }
  }
}

// agg = w @ x by plan pl (from plan(n, p, V of the full-width loader);
// L may own fewer values a thread).  partial: a (pl.groups, p) f32
// scratch, needed when pl.groups > 1.  The wide layout stores agg by
// 16-byte vectors when V % 4 == 0: agg must then be 16-byte aligned.
template <class L>
cudaError_t launch_gemv(const float* w, typename L::Args args, float* agg,
                        float* partial, int n, long long p, Plan pl,
                        cudaStream_t stream) {
  if (pl.groups > 1 && partial == nullptr) return cudaErrorInvalidValue;
  float* out = pl.groups > 1 ? partial : agg;
  const long long cols = (kWarps / pl.rw) * 32LL * L::kVals;   // a CTA's
  const dim3 grid((unsigned)((p + cols - 1) / cols), (unsigned)pl.groups);
  if (pl.rw == 1)
    gemv_kernel<L, 1><<<grid, kThreads, 0, stream>>>(w, args, out, n, p,
                                                     pl.rows);
  else if (pl.rw == 2)
    gemv_kernel<L, 2><<<grid, kThreads, 0, stream>>>(w, args, out, n, p,
                                                     pl.rows);
  else if (pl.rw == 4)
    gemv_kernel<L, 4><<<grid, kThreads, 0, stream>>>(w, args, out, n, p,
                                                     pl.rows);
  else
    gemv_kernel<L, 8><<<grid, kThreads, 0, stream>>>(w, args, out, n, p,
                                                     pl.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.groups == 1) return err;
  return sum_groups(partial, agg, pl.groups, p, stream);
}

}  // namespace rowsum
