// Forward flash attention for Hopper (sm_90a): the port of the Pallas TPU
// kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel).
//
//   repro_flash_attention   o = softmax(mask(q k^T * hd^-0.5)) v per
//                           (batch, q head), GQA (kv head = q head / group,
//                           no KV copy), causal / sliding-window / kv-tail
//                           masks, online softmax in fp32, rows that see
//                           no key come out 0.
//
// Build (one shared library per source, plain C ABI, loaded with ctypes by
// repro_torch/kernels/_build.py):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas -v -o libflash_attention.so \
//        flash_attention.cu
//
// C ABI.  As csrc/mixing.cu: device pointers and the stream as void*, sizes
// as int, a dtype code (0 = float32, 1 = bfloat16) for q, k, v and o alike,
// the device ordinal; it launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError() as an int (0 = success;
// repro_error_string(code) names any other).  Arrays are contiguous
// (B, H, S, hd), row-major, 16-byte aligned.
//
//   int repro_flash_attention(const void* q,   // (B, Hq, Sq, hd)
//                             const void* k,   // (B, Hkv, Sk, hd)
//                             const void* v,   // (B, Hkv, Sk, hd)
//                             void* o,         // (B, Hq, Sq, hd) out
//                             int B, int Hq, int Hkv, int Sq, int Sk,
//                             int hd,          // 32, 64 or 128
//                             int seq_k,       // keys at >= seq_k masked
//                             int causal,      // 1: key col <= query row
//                             int window,      // > 0: row - col < window
//                             float scale,     // hd ** -0.5
//                             int dtype, int device, void* stream);
//
// Rows and columns are absolute positions (query row i, key column j), as
// in _flash_kernel: ok = j < seq_k && (!causal || j <= i) &&
// (window <= 0 || i - j < window).
//
// Bound.  Two products of 2 * hd flops per visible (query, key) pair: at
// qwen2-7b's prefill shape (B 2, 28 / 4 heads, S 2048, hd 128, bf16,
// causal) 60.2 GFLOP against 67 MB of q, k, v and o -- compute-bound by a
// wide margin.  This first version runs both products as fp32 FMAs on the
// CUDA cores (67 TFLOP/s: >= 0.90 ms there), not on the tensor cores
// (989 TFLOP/s bf16: >= 0.061 ms), so that p stays fp32 through the PV
// product as the reference keeps it; wgmma QK/PV with a TMA K/V ring is a
// later redesign.
//
// Design.  A block of 256 threads owns BQ = 64 query rows of one (batch,
// head) and walks the key tiles (BK = 64 keys) that its rows can see: the
// tile range is cut to the causal diagonal and the window, which is the
// Pallas kernel's skip of fully masked kv blocks (O(S * window) work).
// Per tile the block stages K^T and V in shared memory as fp32 (the
// inputs are upcast once, on the way in); each thread computes a 4 x 4
// register tile of scores (rows 4*ty.., keys 4*tx..) from float4 reads of
// the transposed Q and K tiles, applies the masks, and takes the row max
// and row sum over the 16 threads of a row with warp shuffles, so the
// online-softmax state (m, l) of its 4 rows stays in registers.  p goes to
// shared memory (over the K^T buffer, which is free by then) and the thread
// accumulates its 4 rows x hd/16 output columns in fp32 registers.  Heavy
// causal tiles (late query rows) are launched first to shorten the tail.
// Shared memory: 102,400 bytes at hd 128 (two blocks a SM), 51,200 at 64,
// 34,304 at 32; above 48 KB it is opted into with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + BQ) of a (S, HD) slab -> dst[d * pitch + r], fp32;
// rows at or past S read as 0
template <typename T, int HD>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 int row0, int S, float* dst,
                                                 int pitch) {
  for (int e = threadIdx.x * 4; e < BQ * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(src + (size_t)(row0 + r) * HD + d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(d + j) * pitch + r] = x[j];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Sk, int seq_k, int causal, int window,
                 float scale) {
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
  const T* qb = q + (size_t)(b * Hq + h) * Sq * HD;
  const T* kb = k + (size_t)(b * Hkv + kvh) * Sk * HD;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Sk * HD;

  stage_transposed<T, HD>(qb, q0, Sq, Qt, QP);

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
    stage_transposed<T, HD>(kb, c0, Sk, KPt, KP);
    for (int e = tid * 4; e < BK * HD; e += kThreads * 4) {
      const int r = e / HD;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + r < Sk) load4(vb + (size_t)c0 * HD + e, x);
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

  T* ob = o + (size_t)(b * Hq + h) * Sq * HD;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];   // dead rows -> 0
#pragma unroll
    for (int dd = 0; dd < TD; ++dd)
      store_out(ob + (size_t)row * HD + tx * TD + dd, acc[i][dd] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int seq_k,
                   int causal, int window, float scale, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, Smem<HD>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, seq_k,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                      int seq_k, int causal, int window, float scale,
                      cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                           window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                           window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, seq_k, causal,
                            window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                          int hd, int seq_k, int causal, int window,
                          float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || seq_k > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, o, B, Hq, Hkv, Sq, Sk, seq_k,
                                 causal, window, scale, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                         seq_k, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
