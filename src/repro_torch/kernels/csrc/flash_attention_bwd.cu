// Backward flash attention for Hopper (sm_90a): the gradient of
// csrc/flash_attention.cu's bf16 forward.  It replaces no TPU kernel (the
// Pallas flash kernel, repro/kernels/flash_attention/flash_attention.py,
// is forward-only); it was added so that LM training attends through the
// kernels instead of the plain path's fp32 score passes
// (models/attention.py::_chunked_sdpa), and follows the split of a flash
// backward into a dQ pass and a dK/dV pass.
//
//   repro_flash_attention_bwd   dq, dk, dv of o = softmax(mask(q k^T *
//                               scale)) v, given q, k, v, o, the forward's
//                               row log-sum-exp lse and do = dL/do; GQA
//                               (dk, dv summed over a kv head's group of q
//                               heads), causal / sliding-window / kv-tail
//                               masks as in the forward.
//
// Per visible (query i, key j), with s = scale q_i . k_j:
//
//   p_ij  = exp(s_ij - lse_i)             the forward's weights, rebuilt
//   D_i   = sum_c do_ic o_ic              once, by the dQ kernel
//   dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = scale sum_j ds_ij k_j,  dk_j = scale sum_i ds_ij q_i,
//   dv_j  = sum_i p_ij do_i
//
// Build (one shared library, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libflash_attention_bwd.so \
//        flash_attention_bwd.cu
//
// C ABI.  As csrc/flash_attention.cu: device pointers and the stream as
// void*, sizes as int; it launches on the given stream, never
// synchronises, allocates nothing and returns cudaGetLastError() as an int
// (repro_error_string(code) names it).  All of q, k, v, o, do, dq, dk, dv
// are bf16 (B, H, S, hd) views with the last axis contiguous, a 16-byte
// aligned base and (batch, head, row) strides in elements whose byte sizes
// are multiples of 16, given as 24 int64s in that order; lse and delta are
// contiguous fp32 (B, Hq, Sq).
//
//   int repro_flash_attention_bwd(
//       const void* q, const void* k, const void* v, const void* o,
//       const void* dout, const float* lse,
//       float* delta,                 // (B, Hq, Sq) scratch: D
//       void* dq, void* dk, void* dv, // outputs
//       const long long* strides,     // 24, see above
//       int B, int Hq, int Hkv, int Sq, int Sk,
//       int hd,                       // 32, 64 or 128
//       int seq_k, int causal, int window, float scale,
//       int device, void* stream);
//
// Bound.  Five products of 2 hd flops per visible (query, key) pair (s, dp,
// dv, dq, dk), 2.5 times the forward's two: at the stablelm-2-1.6b
// training cell's shape (B 4, 32 heads, S 4,096, hd 64, causal) 0.69 TFLOP
// against ~0.3 GB of operands -- bound by operations at the bf16
// tensor-core peak (989 TFLOP/s: >= 0.69 ms).
//
// Design.  Two kernels of 4 warps (128 threads), run in order on one
// stream; neither uses atomics, so every output element is summed by one
// thread in a fixed order and two calls give the same bits.
//
//   flash_bwd_dq_kernel: one CTA per (64 query rows, q head, batch), the
//   heaviest (latest, under causal) row blocks first.  It stages its Q and
//   dO rows in shared memory, computes D for them from do and o in fp32
//   (and stores it for the other kernel), then walks the key tiles (64
//   keys) its rows can see -- the forward's cut at the causal diagonal and
//   the window's start -- with K and V double-buffered by cp.async.  A
//   warp owns 16 query rows: it recomputes s = Q K^T and dp = dO V^T (32 +
//   32 fp32 registers), forms p and ds in registers and accumulates
//   dq += ds K.
//
//   flash_bwd_dkv_kernel: one CTA per (64 keys, kv head, batch).  K and V
//   stay in shared memory; the CTA walks, for each q head of the group in
//   turn, the query tiles (64 rows, 32 at hd 128 to stay clear of spills)
//   that can see its keys, with Q, dO, lse and D double-buffered.  A warp
//   owns 16 keys: s^T = K Q^T and dp^T = V dO^T, then dv += p^T dO and
//   dk += ds^T Q.
//
//   Products.  mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores,
//   operands read from padded shared memory (rows of hd + 8 elements: the
//   8 rows of an ldmatrix fall in distinct banks) by ldmatrix, .trans where
//   the operand's contraction axis is its rows.  The fp32 accumulator
//   layout of an m16n8 tile pair is the A-fragment layout of the next
//   m16n8k16, so p and ds go from registers into the next product without
//   shared memory.
//
//   Precision.  s, p, lse, D, dp and ds stay fp32 in registers.  p and ds
//   enter the dv, dq and dk products as bf16 hi + lo pairs (x_hi =
//   bf16(x), x_lo = bf16(x - x_hi): ~16 mantissa bits).  For p that is the
//   forward's own split, so the backward differentiates the function the
//   forward computed: its rows of p sum to 1, and the v bias's gradient,
//   sum_i do_i sum_j p_ij, is sum_i do_i; with bf16(p) the rows would sum
//   to 1 + rounding that the forward never saw.  dp = dO V^T takes bf16
//   operands (do and v are bf16) with fp32 accumulation.
//   Masks are evaluated only on tiles that cross the causal diagonal, the
//   window's edge, the kv tail or the last query row; a warp skips a tile
//   that none of its rows (keys) can see.  The tensor-core work is 10
//   products a pair (s and dp in both kernels, the hi + lo dv, dq and
//   dk), twice the function's 5; the bound above is the function's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 64;          // query rows a dQ CTA (16 a warp)
constexpr int BK = 64;          // keys a tile / a dK-dV CTA (16 a warp)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                // in elements
  long long b, h, s;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16x2 hi and the bf16x2 of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xFFFF0000u));
}

// The accumulators of keys (or queries) 16 kk .. 16 kk + 15, two m16n8
// tiles, as the bf16 hi and lo A fragments of an m16n8k16 whose
// contraction runs over them
__device__ __forceinline__ void to_a_split(const float (&t0)[4],
                                           const float (&t1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(t0[0], t0[1], hi[0], lo[0]);
  split_bf16(t0[2], t0[3], hi[1], lo[1]);
  split_bf16(t1[0], t1[1], hi[2], lo[2]);
  split_bf16(t1[2], t1[3], hi[3], lo[3]);
}

template <int HD>
struct Tile {
  static constexpr int P = HD + 8;   // padded row, elements
  // ldmatrix.x4 row address of `lane` in a [rows][P] bf16 tile at `base`:
  // the four 8 x 8 matrices at (row0, col0) + (8 (mi % 2), 8 (mi / 2)),
  // mi = lane / 8.  That is an A fragment of rows row0.. and contraction
  // columns col0.. (rows = M), and with .trans a B fragment pair of
  // contraction rows row0.. and output columns col0.. (rows = K).
  static __device__ __forceinline__ uint32_t a_addr(uint32_t base, int row0,
                                                    int col0, int lane) {
    const int mi = lane / 8;
    return base + 2u * ((row0 + lane % 8 + 8 * (mi % 2)) * P + col0 +
                        8 * (mi / 2));
  }
  // ... at (row0, col0) + (8 (mi / 2), 8 (mi % 2)): without .trans a B
  // fragment pair of output rows row0.. and contraction columns col0..
  // (rows = N): r0, r1 the first n8 tile's b0, b1, r2, r3 the second's
  static __device__ __forceinline__ uint32_t b_addr(uint32_t base, int row0,
                                                    int col0, int lane) {
    const int mi = lane / 8;
    return base + 2u * ((row0 + lane % 8 + 8 * (mi / 2)) * P + col0 +
                        8 * (mi % 2));
  }
  // rows [row0, row0 + R) of a (S, HD) slab with row stride ld -> dst,
  // rows at or past S zero-filled
  template <int R>
  static __device__ __forceinline__ void load(uint32_t dst, const bf16* src,
                                              long long ld, int row0, int S) {
    constexpr int CPR = HD / 8;      // 16-byte chunks a row
    for (int e = threadIdx.x; e < R * CPR; e += kThreads) {
      const int r = e / CPR, c = e % CPR;
      const bool in = row0 + r < S;
      const bf16* g = in ? src + (row0 + r) * ld + c * 8 : src;
      cp_async16(dst + 2u * (r * P + c * 8), g, in ? 16 : 0);
    }
  }
};

__device__ __forceinline__ bool visible(int row, int col, int Sq, int seq_k,
                                        int causal, int window) {
  return row < Sq && col < seq_k && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

// ---------------------------------------------------------------------------
// dQ (and D)
// ---------------------------------------------------------------------------

template <int HD>
struct DqSmem {
  static constexpr int TILE = BQ * Tile<HD>::P * 2;   // bytes, BQ == BK
  // Q, dO, K[2], V[2], then lse and D of the CTA's rows
  static constexpr int bytes = 6 * TILE + 2 * BQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, int Hq, int Hkv,
                    int Sq, int seq_k, int Sk, int causal, int window,
                    float scale) {
  using T = Tile<HD>;
  static_assert(BQ == BK, "the dQ kernel's tiles share one size");
  constexpr int TILE = DqSmem<HD>::TILE;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t q_s = smem_u32(smem), do_s = q_s + TILE;
  const uint32_t k_s = do_s + TILE, v_s = k_s + 2 * TILE;
  float* Ls = reinterpret_cast<float*>(smem + 6 * TILE);
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const bf16* ob = o + b * so.b + h * so.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const long long rows = (static_cast<long long>(b) * Hq + h) * Sq;

  // the key tiles some row of this CTA can see (the forward's cut)
  int k_end = seq_k;
  if (causal) k_end = min(k_end, q0 + BQ);
  const int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = k_end > 0 ? max(0, (k_end + BK - 1) / BK - t_begin)
                                : 0;

  T::template load<BQ>(q_s, qb, sq.s, q0, Sq);
  T::template load<BQ>(do_s, dob, sdo.s, q0, Sq);
  if (n_tiles > 0) {
    T::template load<BK>(k_s, kb, sk.s, t_begin * BK, Sk);
    T::template load<BK>(v_s, vb, sv.s, t_begin * BK, Sk);
  }
  cp_async_commit();

  // D = rowsum(do * o) in fp32, two threads a row; lse into the log2 domain
  {
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const bf16* orow = ob + row * so.s + half * (HD / 2);
      const bf16* drow = dob + row * sdo.s + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc = fmaf(__uint_as_float(xs[j] << 16),
                     __uint_as_float(ys[j] << 16), acc);
          acc = fmaf(__uint_as_float(xs[j] & 0xFFFF0000u),
                     __uint_as_float(ys[j] & 0xFFFF0000u), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      Ls[r] = row < Sq ? lse[rows + row] * kLog2e : 0.f;
      if (row < Sq) delta[rows + row] = acc;
    }
  }

  const float scale_log2 = scale * kLog2e;
  const int w0 = q0 + 16 * warp;                 // the warp's first row
  const int ra = w0 + g, rb = ra + 8;            // this thread's rows
  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      const int c1 = (t_begin + i + 1) * BK;
      T::template load<BK>(k_s + (buf ^ 1) * TILE, kb, sk.s, c1, Sk);
      T::template load<BK>(v_s + (buf ^ 1) * TILE, vb, sv.s, c1, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = (t_begin + i) * BK;
    const bool skip = c0 >= seq_k || (causal && c0 > w0 + 15) ||
                      (window > 0 && w0 - (c0 + BK - 1) >= window);
    if (!skip) {
      const uint32_t kt = k_s + buf * TILE, vt = v_s + buf * TILE;
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // s = Q K^T, dp = dO V^T over hd
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, T::a_addr(q_s, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          ldsm_x4(bb, T::b_addr(kt, 16 * np, 16 * kk, lane));
          mma(s[2 * np], a, bb[0], bb[1]);
          mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
        ldsm_x4(a, T::a_addr(do_s, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          ldsm_x4(bb, T::b_addr(vt, 16 * np, 16 * kk, lane));
          mma(dp[2 * np], a, bb[0], bb[1]);
          mma(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // p = exp2(s scale log2e - lse log2e), ds = p (dp - D), into s
      const bool masked = c0 + BK > seq_k || (causal && c0 + BK - 1 > w0) ||
                          (window > 0 && w0 + 15 - c0 >= window) ||
                          w0 + 16 > Sq;
      const float la = Ls[16 * warp + g], lb = Ls[16 * warp + g + 8];
      const float da = Ds[16 * warp + g], db = Ds[16 * warp + g + 8];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[n][e], scale_log2, -(e < 2 ? la : lb)));
          if (masked)
            p = visible(e < 2 ? ra : rb, c0 + 8 * n + 2 * t4 + (e & 1), Sq,
                        seq_k, causal, window)
                    ? p
                    : 0.f;
          s[n][e] = p * (dp[n][e] - (e < 2 ? da : db));
        }
      // dq += ds K: ds as bf16 hi + lo A fragments over the tile's keys
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, T::a_addr(kt, 16 * kk, 16 * np, lane));
          mma(dqa[2 * np], hi, bb[0], bb[1]);
          mma(dqa[2 * np], lo, bb[0], bb[1]);
          mma(dqa[2 * np + 1], hi, bb[2], bb[3]);
          mma(dqa[2 * np + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                 // buffer buf is free for tile i + 2
  }
  cp_async_wait<0>();                // nothing left in flight (n_tiles 0)

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? ra : rb;
    if (row >= Sq) continue;
    bf16* drow = dqb + row * sdq.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

template <int HD>
struct DkvCfg {
  static constexpr int BM = HD <= 64 ? 64 : 32;     // query rows an item
  static constexpr int KT = BK * Tile<HD>::P * 2;   // bytes of K or V
  static constexpr int QT = BM * Tile<HD>::P * 2;   // bytes of Q or dO
  // K, V, Q[2], dO[2], then lse[2] and D[2] of BM rows
  static constexpr int bytes = 2 * KT + 4 * QT + 4 * BM * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int Hq, int Hkv, int Sq, int seq_k, int Sk, int causal,
                     int window, float scale) {
  using T = Tile<HD>;
  using C = DkvCfg<HD>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t k_s = smem_u32(smem), v_s = k_s + C::KT;
  const uint32_t q_s = v_s + C::KT, do_s = q_s + 2 * C::QT;
  float* Ls = reinterpret_cast<float*>(smem + 2 * C::KT + 4 * C::QT);
  float* Ds = Ls + 2 * BM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = blockIdx.x * BK;                // heavy (early) keys first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int w0 = c0 + 16 * warp;                 // the warp's first key
  const int ka = w0 + g, kb2 = ka + 8;           // this thread's keys

  // the query tiles some key of this CTA is visible from: rows at or past
  // c0 (causal), before the window's end of the last key
  const int q_begin = causal ? c0 : 0;
  int q_end = c0 < seq_k ? Sq : 0;
  if (window > 0) q_end = min(q_end, c0 + BK - 1 + window);
  const int qt_begin = q_begin / BM;
  const int nq = q_end > q_begin ? (q_end + BM - 1) / BM - qt_begin : 0;
  const int n_items = G * nq;                    // (q head, query tile)

  auto load_item = [&](int it, int buf) {
    const int h = kvh * G + it / nq, r0 = (qt_begin + it % nq) * BM;
    T::template load<BM>(q_s + buf * C::QT, q + b * sq.b + h * sq.h, sq.s,
                         r0, Sq);
    T::template load<BM>(do_s + buf * C::QT, dout + b * sdo.b + h * sdo.h,
                         sdo.s, r0, Sq);
    const long long rows = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int r = tid; r < BM; r += kThreads) {
      const bool in = r0 + r < Sq;
      cp_async4(smem_u32(Ls + buf * BM + r), lse + (in ? rows + r0 + r : 0),
                in ? 4 : 0);
      cp_async4(smem_u32(Ds + buf * BM + r),
                delta + (in ? rows + r0 + r : 0), in ? 4 : 0);
    }
  };

  T::template load<BK>(k_s, k + b * sk.b + kvh * sk.h, sk.s, c0, Sk);
  T::template load<BK>(v_s, v + b * sv.b + kvh * sv.h, sv.s, c0, Sk);
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_items) {
      load_item(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (qt_begin + it % nq) * BM;
    const bool skip = w0 >= seq_k || (causal && r0 + BM - 1 < w0) ||
                      (window > 0 && r0 - (w0 + 15) >= window);
    if (!skip) {
      const uint32_t qt = q_s + buf * C::QT, dt = do_s + buf * C::QT;
      const float* Lb = Ls + buf * BM;
      const float* Db = Ds + buf * BM;
      float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
      for (int n = 0; n < BM / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // s^T = K Q^T, dp^T = V dO^T over hd
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, T::a_addr(k_s, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          ldsm_x4(bb, T::b_addr(qt, 16 * np, 16 * kk, lane));
          mma(s[2 * np], a, bb[0], bb[1]);
          mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
        ldsm_x4(a, T::a_addr(v_s, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < BM / 16; ++np) {
          ldsm_x4(bb, T::b_addr(dt, 16 * np, 16 * kk, lane));
          mma(dp[2 * np], a, bb[0], bb[1]);
          mma(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // p^T into s, ds^T into dp
      const bool masked = w0 + 16 > seq_k || (causal && r0 < w0 + 15) ||
                          (window > 0 && r0 + BM - 1 - w0 >= window) ||
                          r0 + BM > Sq;
#pragma unroll
      for (int n = 0; n < BM / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t4 + c;    // query row in the item
          const float l2 = Lb[col] * kLog2e, d = Db[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            float p = ex2(fmaf(s[n][e], scale_log2, -l2));
            if (masked)
              p = visible(r0 + col, r == 0 ? ka : kb2, Sq, seq_k, causal,
                          window)
                      ? p
                      : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - d);
          }
        }
      // dv += p^T dO, dk += ds^T Q (p and ds as bf16 hi + lo), over the
      // item's query rows
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t p_hi[4], p_lo[4], hi[4], lo[4];
        to_a_split(s[2 * kk], s[2 * kk + 1], p_hi, p_lo);
        to_a_split(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, T::a_addr(dt, 16 * kk, 16 * np, lane));
          mma(dva[2 * np], p_hi, bb[0], bb[1]);
          mma(dva[2 * np], p_lo, bb[0], bb[1]);
          mma(dva[2 * np + 1], p_hi, bb[2], bb[3]);
          mma(dva[2 * np + 1], p_lo, bb[2], bb[3]);
          ldsm_x4_t(bb, T::a_addr(qt, 16 * kk, 16 * np, lane));
          mma(dka[2 * np], hi, bb[0], bb[1]);
          mma(dka[2 * np], lo, bb[0], bb[1]);
          mma(dka[2 * np + 1], hi, bb[2], bb[3]);
          mma(dka[2 * np + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                 // buffer buf is free for item it + 2
  }
  cp_async_wait<0>();                // K and V when there is no item

  bf16* dkb = dk + b * sdk.b + kvh * sdk.h;
  bf16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? ka : kb2;
    if (key >= Sk) continue;
    bf16* krow = dkb + key * sdk.s + 2 * t4;
    bf16* vrow = dvb + key * sdv.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n) =
          pack_bf16(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* const* ptr, const Strides* st, int B, int Hq,
                   int Hkv, int Sq, int Sk, int seq_k, int causal, int window,
                   float scale, cudaStream_t s) {
  const bf16* q = static_cast<const bf16*>(ptr[0]);
  const bf16* k = static_cast<const bf16*>(ptr[1]);
  const bf16* v = static_cast<const bf16*>(ptr[2]);
  const bf16* o = static_cast<const bf16*>(ptr[3]);
  const bf16* dout = static_cast<const bf16*>(ptr[4]);
  const float* lse = static_cast<const float*>(ptr[5]);
  float* delta = static_cast<float*>(const_cast<void*>(ptr[6]));
  bf16* dq = static_cast<bf16*>(const_cast<void*>(ptr[7]));
  bf16* dk = static_cast<bf16*>(const_cast<void*>(ptr[8]));
  bf16* dv = static_cast<bf16*>(const_cast<void*>(ptr[9]));

  auto dq_kernel = flash_bwd_dq_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<HD>::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Sq + BQ - 1) / BQ, Hq, B);
  dq_kernel<<<grid_q, kThreads, DqSmem<HD>::bytes, s>>>(
      q, k, v, o, dout, lse, delta, dq, st[0], st[1], st[2], st[3], st[4],
      st[5], Hq, Hkv, Sq, seq_k, Sk, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = flash_bwd_dkv_kernel<HD>;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvCfg<HD>::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_k((Sk + BK - 1) / BK, Hkv, B);
  dkv_kernel<<<grid_k, kThreads, DkvCfg<HD>::bytes, s>>>(
      q, k, v, dout, lse, delta, dk, dv, st[0], st[1], st[2], st[4], st[6],
      st[7], Hq, Hkv, Sq, seq_k, Sk, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, const long long* strides,
                              int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                              int seq_k, int causal, int window, float scale,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      seq_k < 0 || seq_k > Sk)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int a = 0; a < 8; ++a)
    st[a] = Strides{strides[3 * a], strides[3 * a + 1], strides[3 * a + 2]};
  const void* ptr[10] = {q, k, v, o, dout, lse, delta, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(ptr, st, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                             window, scale, s);
    case 64:
      return (int)launch<64>(ptr, st, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                             window, scale, s);
    case 128:
      return (int)launch<128>(ptr, st, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                              window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
