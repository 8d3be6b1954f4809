// Forward flash attention for Hopper (sm_90a): the port of the Pallas TPU
// kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel).
//
//   repro_flash_attention   o = softmax(mask(q k^T * hd^-0.5)) v per
//                           (batch, q head), GQA (kv head = q head / group,
//                           no KV copy), causal / sliding-window / kv-tail
//                           masks, online softmax in fp32, rows that see
//                           no key come out 0; on request (bf16 only) each
//                           row's log-sum-exp, for the backward
//                           (csrc/flash_attention_bwd.cu).
//
// Two routes, chosen by the dtype:
//
//   bfloat16  flash_fwd_wgmma_kernel: both products on the tensor cores
//             (wgmma), K/V tiles streamed by TMA.  The main path (the LM
//             forward in bf16).
//   float32   flash_fwd_fp32_kernel: both products as fp32 FMAs on the
//             CUDA cores (the first version of this kernel), so that the
//             reference's fp32 tolerance (2e-5) holds; TF32 would not.
//
// Build (one shared library per source, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py; no extra flags or libraries: libcuda's
// cuTensorMapEncodeTiled is found at run time through
// cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
// CUDA 12.5, so nothing links -lcuda):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libflash_attention.so \
//        flash_attention.cu
//
// C ABI.  As csrc/mixing.cu: device pointers and the stream as void*, sizes
// as int, a dtype code (0 = float32, 1 = bfloat16) for q, k, v and o alike,
// the device ordinal; it launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError() as an int (0 = success;
// repro_error_string(code) names any other).  Arrays are (B, H, S, hd)
// views with the last axis contiguous, a 16-byte aligned base and strides
// (in elements) whose byte sizes are multiples of 16, given as twelve
// int64s: (batch, head, row) strides of q, k, v and o in that order.
//
//   int repro_flash_attention(const void* q,   // (B, Hq, Sq, hd)
//                             const void* k,   // (B, Hkv, Sk, hd)
//                             const void* v,   // (B, Hkv, Sk, hd)
//                             void* o,         // (B, Hq, Sq, hd) out
//                             float* lse,      // (B, Hq, Sq) out, or null;
//                                              // bf16 only
//                             const long long* strides,   // 12, see above
//                             int B, int Hq, int Hkv, int Sq, int Sk,
//                             int hd,          // 32, 64 or 128
//                             int seq_k,       // keys at >= seq_k masked
//                             int causal,      // 1: key col <= query row
//                             int window,      // > 0: row - col < window
//                             float scale,     // hd ** -0.5
//                             int dtype, int device, void* stream,
//                             int* route);     // out: 1 tensor-core kernel,
//                                              // 0 the fp32 one
//
// Rows and columns are absolute positions (query row i, key column j), as
// in _flash_kernel: ok = j < seq_k && (!causal || j <= i) &&
// (window <= 0 || i - j < window).
//
// Bound.  Two products of 2 * hd flops per visible (query, key) pair: at
// qwen2-7b's prefill shape (B 2, 28 / 4 heads of 128, S 2048, hd 128,
// bf16, causal) 60.2 GFLOP against 67 MB of q, k, v and o -- bound by
// operations at the bf16 tensor-core peak (989 TFLOP/s: >= 0.061 ms).
//
// Design of the tensor-core route (flash_fwd_wgmma_kernel).
//
//   CTA.  384 threads: two consumer warpgroups, each owning 64 query rows
//   of one (batch, q head) (BM = 128 rows a CTA), and one producer
//   warpgroup, of which one thread issues every TMA copy.  The producer
//   gives up registers (setmaxnreg.dec to 24) and the consumers take them
//   (setmaxnreg.inc to 240) inside one if/else that never reconverges.
//   The grid is (B * Hq, row blocks): the q heads of a GQA group are
//   neighbours in launch order, so their shared K/V tiles come out of L2,
//   and the latest (heaviest causal) row blocks launch first.
//
//   Producer.  Q (BM x hd) once, then a ring of 2 stages of K and V tiles
//   (BK = 64 keys x hd) by TMA into shared memory with the 128-byte
//   swizzle (64-byte at hd 32, whose rows are 64 bytes); at hd 128 a tile
//   is two boxes of 64 columns.  K and V of a stage each have a full
//   barrier (TMA's byte count) and an empty one that the 8 consumer warps
//   release: K as soon as its scores are in, V after its product.  The
//   tensor maps are built on the host per call with S, H and B as
//   dimensions of their own, strided as the caller's view: rows past S
//   fill with zeros (TMA's out-of-bounds fill), never with the next
//   head's or batch's rows.  The tile range of a CTA is cut to the causal
//   diagonal of its last row and the window's start of its first row: the
//   Pallas kernel's skip of fully masked kv blocks.
//
//   S = Q K^T.  hd / 16 wgmma.m64n64k16.f32.bf16.bf16, A = Q and B = K
//   both K-major in shared memory (hd is the contiguous axis of each),
//   accumulated in fp32 registers (32 a thread).  bf16 products are exact
//   in fp32, so only the order of the sums differs from the plain version.
//
//   Online softmax in registers: a thread holds 2 rows x 16 keys of the
//   tile; a row's max is two __shfl_xor_sync steps over its 4 lanes, its
//   sum stays a per-lane partial until the epilogue.  One FFMA puts a
//   score into the log2 domain less the row max, one ex2 makes p.  Masks
//   are evaluated only on tiles that cross the causal diagonal, the
//   window's edge or the kv tail; masked scores are -inf and a row that
//   has seen no visible key uses 0 as its max, so p = 0 there: the
//   reference's guard p = where(ok, exp(s - m), 0).
//
//   O += P V with p kept to ~16 mantissa bits: p_hi = bf16(p),
//   p_lo = bf16(p - p_hi), two register-A wgmma.m64n{hd}k16 per 16 keys
//   against the same V tile (B = V is MN-major: the transpose bit).  The
//   fp32 accumulator layout of S is the A-fragment layout of the next
//   wgmma, so p never goes through shared memory.  This costs 1.5x the
//   tensor-core work of one PV product; the bound above is the
//   function's, not the split's.
//
//   Schedule.  A consumer issues tile i's Q K^T, rescales O, issues tile
//   i - 1's P V, then waits for the scores alone: tile i's softmax runs
//   while tile i - 1's product is still on the tensor cores, and the two
//   warpgroups interleave on top of that.  Holding S of tile i and p of
//   tile i - 1 at once is what sets BK = 64: at hd 128 a consumer holds O
//   (64 registers), S (32) and p_hi / p_lo (2 x 16) with no spills, where
//   BK = 128 spills.  Tried on the card and dropped: no overlap at
//   BK = 128 (slower), BK = 96 or three consumer warpgroups (both spill;
//   slower), the warpgroups taking turns on named barriers, or a third
//   stage (no gain), one persistent CTA an SM walking the row blocks in
//   a static order (slower than the hardware's launch order).
//
//   Epilogue.  O / l (l == 0 gives 0), stored as bf16 pairs straight from
//   registers into the strided output, rows past Sq skipped.  With an lse
//   pointer, lane 0 of each row's quad writes (m + log2 l) * ln 2, the
//   row's natural log-sum-exp of its scaled scores (-inf where l == 0);
//   a null pointer writes nothing, so the inference callers do the same
//   work as without it.
//
//   ptxas (sm_90a, CUDA 12.8): 168 registers at launch for each head dim
//   (the consumers then run at 240), no spills; the [build] lines of
//   chip_smoke.py print it.
//
// Design of the fp32 route (flash_fwd_fp32_kernel, the first version).  A
// block of 256 threads owns BQ = 64 query rows of one (batch, head) and
// walks the key tiles (BK = 64 keys) that its rows can see, cut as above.
// Per tile the block stages K^T and V in shared memory; each thread
// computes a 4 x 4 register tile of scores from float4 reads of the
// transposed Q and K tiles, applies the masks, and takes the row max and
// row sum over the 16 threads of a row with warp shuffles, so the online-
// softmax state (m, l) of its 4 rows stays in registers.  p goes to shared
// memory (over the K^T buffer, which is free by then) and the thread
// accumulates its 4 rows x hd/16 output columns in fp32 registers.  Heavy
// causal tiles (late query rows) are launched first.  Shared memory:
// 102,400 bytes at hd 128 (two blocks a SM), 51,200 at 64, 34,304 at 32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {                   // in elements
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// fp32 route: both products on the CUDA cores
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int kThreads = 256;
constexpr int BQ = 64;             // query rows a block
constexpr int BK = 64;             // keys a tile
constexpr int TM = 4;              // rows a thread
constexpr int TN = 4;              // keys a thread (scores)
constexpr int QP = BQ + 4;         // padded row of Q^T and P^T (floats)
constexpr int KP = BK + 4;         // padded row of K^T
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int q = HD * QP;                        // Q^T [HD][QP]
  static constexpr int kt = HD * KP;                       // K^T [HD][KP]
  static constexpr int p = BK * QP;                        // P^T [BK][QP]
  static constexpr int kp = kt > p ? kt : p;               // K^T, then P^T
  static constexpr int v = BK * HD;                        // V   [BK][HD]
  static constexpr int floats = q + kp + v;
  static constexpr int bytes = floats * 4;
};

__device__ __forceinline__ void load4(const float* p, float* x) {
  float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// rows [row0, row0 + BQ) of an (S, HD) slab with row stride `ld` ->
// dst[d * pitch + r]; rows at or past S read as 0
template <int HD>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src,
                                                 long long ld, int row0,
                                                 int S, float* dst,
                                                 int pitch) {
  for (int e = threadIdx.x * 4; e < BQ * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(src + (row0 + r) * ld + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(d + j) * pitch + r] = x[j];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_fp32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      Strides sq, Strides sk, Strides sv, Strides so, int Hq,
                      int Hkv, int Sq, int Sk, int seq_k, int causal,
                      int window, float scale) {
  static_assert(BQ == BK, "stage_transposed stages BQ rows for both");
  constexpr int TD = HD / 16;      // output columns a thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* KPt = Qt + Smem<HD>::q;   // K^T during the scores, then P^T
  float* Vs = KPt + Smem<HD>::kp;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  stage_transposed<HD>(qb, sq.s, q0, Sq, Qt, QP);

  // the key tiles some row of this block can see (the Pallas kernel's
  // skip of fully masked kv blocks): up to the causal diagonal of the
  // last row, from the window's start of the first row
  int k_end = seq_k;
  if (causal) k_end = min(k_end, q0 + BQ);
  const int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < TD; ++dd) acc[i][dd] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    __syncthreads();             // the last tile's P^T and V are consumed
    stage_transposed<HD>(kb, sk.s, c0, Sk, KPt, KP);
    for (int e = tid * 4; e < BK * HD; e += kThreads * 4) {
      const int r = e / HD, d = e % HD;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + r < Sk) load4(vb + (c0 + r) * sv.s + d, x);
      *reinterpret_cast<float4*>(Vs + e) = make_float4(x[0], x[1], x[2],
                                                       x[3]);
    }
    __syncthreads();

    // scores: s[i][j] = q[row i] . k[key j], rows 4ty+i, keys 4tx+j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
      load4(Qt + d * QP + ty * TM, qa);
      load4(KPt + d * KP + tx * TN, ka);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
    __syncthreads();             // K^T is read: its buffer takes P^T

    // masks and the online softmax of this thread's 4 rows; a row's 64
    // keys lie on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
      bool ok[TN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx * TN + j;
        ok[j] = col < seq_k && (!causal || col <= row) &&
                (window <= 0 || row - col < window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // without the guard a row that has seen only masked keys so far
        // would take exp(0) = 1 for each of them
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        KPt[(tx * TN + j) * QP + ty * TM + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

    // acc[rows][cols tx*TD..] += p[rows][keys] @ V[keys][cols], p in fp32
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
      load4(KPt + c * QP + ty * TM, pa);
      float va[TD];
#pragma unroll
      for (int dd = 0; dd < TD; dd += 2) {
        const float2 f = *reinterpret_cast<const float2*>(
            Vs + c * HD + tx * TD + dd);
        va[dd] = f.x;
        va[dd + 1] = f.y;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int dd = 0; dd < TD; ++dd)
          acc[i][dd] = fmaf(pa[i], va[dd], acc[i][dd]);
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];   // dead rows -> 0
#pragma unroll
    for (int dd = 0; dd < TD; ++dd)
      ob[row * so.s + tx * TD + dd] = acc[i][dd] / li;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides* st, int B, int Hq, int Hkv, int Sq, int Sk,
                   int seq_k, int causal, int window, float scale,
                   cudaStream_t s) {
  auto kernel = flash_fwd_fp32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, Smem<HD>::bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], Hq, Hkv, Sq, Sk, seq_k, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 route: wgmma from a TMA ring of K/V tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int BM = 64 * kConsumers;              // query rows a CTA
constexpr int BK = 64;                           // keys a tile
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  65536, "setmaxnreg budget");

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 64;   // swizzle span, bytes
  static constexpr int CW = SW / 2;                // columns a TMA box
  static constexpr int CHUNKS = HD / CW;           // boxes a tile row
  static constexpr int LAYOUT = SW == 128 ? 1 : 2; // wgmma swizzle code
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // Q, then K of each stage, then V of each stage (all 1024-aligned),
  // then the barriers; + 1024 to align the dynamic base by hand
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * kStages) + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

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
// that outlasts any real one (2^24 tries, seconds) traps, so a fault shows
// as a launch error instead of a hung card
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

// one box of a 4-d tensor map {hd, S, H, B} -> shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle code in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Strides so, int Hq,
                       int Hkv, int Sq, int seq_k, int causal, int window,
                       float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle atom
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t q_full = bar;
  // stage st: K full, V full, K empty, V empty barriers
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bar + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bar + 8u * (1 + 3 * kStages + st); };

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heavy rows first

  // the key tiles some row of this CTA can see
  int k_end = seq_k;
  if (causal) k_end = min(k_end, q0 + BM);
  const int k_begin = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = k_end > 0 ? max(0, (k_end + BK - 1) / BK - t_begin)
                                : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * kConsumers);        // one arrive a warp
      mbar_init(v_empty(st), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load(q_s + c * BM * C::SW, &tm_q, c * C::CW, q0, h, b, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int c0 = (t_begin + i) * BK;
        const uint32_t kd = k_s + st * C::KV_BYTES;
        const uint32_t vd = v_s + st * C::KV_BYTES;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load(kd + c * BK * C::SW, &tm_k, c * C::CW, c0, kvh, b,
                   k_full(st));
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load(vd + c * BK * C::SW, &tm_v, c * C::CW, c0, kvh, b,
                   v_full(st));
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int t = threadIdx.x % 128, wl = t / 32, lane = t % 32;
    const int r_first = q0 + 64 * wg;            // the warpgroup's rows
    const int row0 = r_first + 16 * wl + lane / 4;   // and row0 + 8
    const int col_l = 2 * (lane % 4);            // first column of a pair

    float acc[HD / 2];                           // O, m64n{HD} fragment
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};         // log2-domain row max
    float l[2] = {0.f, 0.f};                     // per-lane partial sums

    // K-major descriptors (Q, K): 8-row groups SW * 8 bytes apart; the
    // k-th 16 columns start 32 k bytes into the swizzled row, in chunk
    // 32 k / SW
    const uint32_t sbo = 8 * C::SW;
    auto q_desc = [&](int kk) {
      const int byte = 32 * kk;
      return smem_desc(q_s + (byte / C::SW) * BM * C::SW +
                           64 * wg * C::SW + byte % C::SW,
                       16, sbo, C::LAYOUT);
    };

    float s[BK / 2];                              // S, then p, fp32
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];  // p as A fragments
    float alpha[2];                               // O's rescale

    // issue S = Q K(i)^T once K(i) has landed
    auto issue_qk = [&](int i) {
      const int st = i % kStages;
      mbar_wait(k_full(st), (i / kStages) & 1);
      const uint32_t kt = k_s + st * C::KV_BYTES;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int byte = 32 * kk;
        const uint64_t kdesc = smem_desc(
            kt + (byte / C::SW) * BK * C::SW + byte % C::SW, 16, sbo,
            C::LAYOUT);
        wgmma_ss_n64(s, q_desc(kk), kdesc, kk > 0);
      }
      wgmma_commit();
    };
    // issue O += P V(i) once V(i) has landed: V (keys x hd, hd
    // contiguous) is the MN-major B operand; 8-key groups SW * 8 bytes
    // apart, the hd chunks BK * SW apart
    auto issue_pv = [&](int i) {
      const int st = i % kStages;
      mbar_wait(v_full(st), (i / kStages) & 1);
      const uint32_t vt = v_s + st * C::KV_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vdesc = smem_desc(vt + kk * 16 * C::SW, BK * C::SW,
                                         sbo, C::LAYOUT);
        wgmma_rs<HD>(acc, p_hi[kk], vdesc);
        wgmma_rs<HD>(acc, p_lo[kk], vdesc);
      }
      wgmma_commit();
    };
    auto release = [&](uint32_t empty_bar) {   // this warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar);
    };
    // tile i's scores -> p = exp2(s - m) in place; m, l and alpha
    // updated.  Scores go into the log2 domain; masks only where the
    // tile crosses the diagonal, the window's edge or the kv tail
    auto softmax = [&](int i) {
      const int c0 = (t_begin + i) * BK;
      const bool masked =
          c0 + BK > seq_k || (causal && c0 + BK - 1 > r_first) ||
          (window > 0 && r_first + 63 - c0 >= window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * r + c];
            if (masked) {
              const int row = row0 + 8 * r, col = c0 + 8 * j + col_l + c;
              const bool ok = col < seq_k && (!causal || col <= row) &&
                              (window <= 0 || row - col < window);
              x = ok ? x : -INFINITY;
            }
            s[4 * j + 2 * r + c] = x;
            mx[r] = fmaxf(mx[r], x);
          }
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with no visible key yet: p = exp2(-inf - 0) = 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(fmaf(s[4 * j + 2 * r + c], scale_log2,
                                     -m_use[r]));
            l[r] += p;
            s[4 * j + 2 * r + c] = p;
          }
    };
    // p -> bf16 hi + lo A fragments: the pair (4 j + 2 r, + 1) of S is
    // the pair (r + 2 (j % 2)) of the A fragment of keys 16 (j / 2) ..
    auto split = [&]() {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = s[4 * j + 2 * r], p1 = s[4 * j + 2 * r + 1];
          const uint32_t hi = pack_bf16(p0, p1);
          const float h0 = __uint_as_float(hi << 16);
          const float h1 = __uint_as_float(hi & 0xFFFF0000u);
          p_hi[j / 2][r + 2 * (j % 2)] = hi;
          p_lo[j / 2][r + 2 * (j % 2)] = pack_bf16(p0 - h0, p1 - h1);
        }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= alpha[r];
          acc[4 * j + 2 * r + 1] *= alpha[r];
        }
    };
    // Tile i's Q K^T is issued before tile i - 1's P V, and the scores
    // are waited for alone: tile i's softmax runs while tile i - 1's
    // product is still on the tensor cores.
    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty(0));
      softmax(0);
      split();
      for (int i = 1; i < n_tiles; ++i) {
        issue_qk(i);
        rescale();
        issue_pv(i - 1);
        wgmma_wait<1>();                         // S of tile i is ready
        fence_regs(s);
        release(k_empty(i % kStages));
        softmax(i);
        wgmma_wait<0>();                         // P V of tile i - 1 done
        fence_regs(acc);
        release(v_empty((i - 1) % kStages));
        split();
      }
      rescale();
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty((n_tiles - 1) % kStages));
    }

    // epilogue: O / l, a dead row (l == 0) -> 0
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = lr == 0.f ? 1.f : 1.f / lr;
      const int row = row0 + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && row < Sq)
        lse[(static_cast<long long>(b) * Hq + h) * Sq + row] =
            lr == 0.f ? -INFINITY : (m[r] + log2f(lr)) * kLn2;
    }
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = ob + row * so.s + col_l;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, found once through the runtime
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a 4-d map {hd, S, H, B} over a strided bf16 view, boxes of cols x rows
bool encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map,
            const void* ptr, int hd, int S, int H, int B, Strides st,
            int cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Strides* st, int B, int Hq, int Hkv,
                   int Sq, int Sk, int seq_k, int causal, int window,
                   float scale, cudaStream_t s) {
  using C = Cfg<HD>;
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  // no keys: the maps are never read, but must encode; point them at q
  Strides sk = st[1], sv = st[2];
  if (Sk == 0) {
    k = v = q;
    sk = sv = st[0];
    Sk = Sq;
    Hkv = Hq;
  }
  const CUtensorMapSwizzle sw = C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  if (!encode(fn, &mq, q, HD, Sq, Hq, B, st[0], C::CW, BM, sw) ||
      !encode(fn, &mk, k, HD, Sk, Hkv, B, sk, C::CW, BK, sw) ||
      !encode(fn, &mv, v, HD, Sk, Hkv, B, sv, C::CW, BK, sw))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + BM - 1) / BM);
  kernel<<<grid, kThreads, C::SMEM, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, st[3], Hq, Hkv, Sq,
      seq_k, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// the tensor-core kernel (TC) or the fp32 one at head dim hd; *route
// names the kernel launched (1 tensor cores, 0 fp32)
template <bool TC>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, float* lse, const Strides* st, int B, int Hq,
                      int Hkv, int Sq, int Sk, int seq_k, int causal,
                      int window, float scale, cudaStream_t s, int* route) {
  cudaError_t err;
#define REPRO_FLASH_CASE(HD)                                               \
  case HD:                                                                 \
    err = TC ? tc::launch<HD>(q, k, v, o, lse, st, B, Hq, Hkv, Sq, Sk,     \
                              seq_k, causal, window, scale, s)             \
             : fp32::launch<HD>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, seq_k, \
                                causal, window, scale, s);                 \
    break;
  switch (hd) {
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
  if (err == cudaSuccess) *route = TC ? 1 : 0;
  return err;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, float* lse, const long long* strides,
                          int B, int Hq,
                          int Hkv, int Sq, int Sk, int hd, int seq_k,
                          int causal, int window, float scale, int dtype,
                          int device, void* stream, int* route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || seq_k > Sk ||
      (lse != nullptr && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int a = 0; a < 4; ++a)
    st[a] = Strides{strides[3 * a], strides[3 * a + 1], strides[3 * a + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_hd<true>(hd, q, k, v, o, lse, st, B, Hq, Hkv, Sq, Sk,
                                seq_k, causal, window, scale, s, route);
  if (dtype == 0)
    return (int)launch_hd<false>(hd, q, k, v, o, nullptr, st, B, Hq, Hkv,
                                 Sq, Sk, seq_k, causal, window, scale, s,
                                 route);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
