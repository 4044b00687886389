// Flash attention for Hopper (sm_90a): softmax(q kᵀ · scale, masked) v for
// every query row, with an online softmax over key tiles, so the (S, T)
// score matrix never reaches device memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (a Pallas kernel whose grid (B·H, S/bq, T/bk) walks the
// key blocks in order on one core, with the running (m, l, acc) carried in
// VMEM scratch from one grid step to the next).  Hopper's blocks run in
// parallel and carry nothing between them, so here one thread block owns one
// (batch·head, query tile) and loops over the key tiles itself, the running
// (m, l, acc) in registers.  Query head h reads KV head h / G (GQA).  The
// causal and sliding-window masks come from the row and key indices; key
// tiles that lie wholly above the diagonal or wholly outside the window are
// skipped, and the ragged last tile is masked by index, not padded.  The
// inputs are read in their (B, S, H, D) / (B, T, KH, D) layouts through
// their strides (D contiguous): nothing is copied or padded to 128 lanes.
//
// Numerics, as the TPU kernel: scores, softmax and accumulator in fp32,
// masked scores set to -1e30 (a row's keys outside the masks weigh
// exp(-1e30 - m) = 0 once a valid key is seen), the denominator clamped at
// 1e-30, the output cast once to the input type.  Keys past T are excluded
// outright (-inf).  Unlike the TPU kernel the probabilities stay in fp32
// for the p·v product; the TPU kernel rounds them to v's type first.
//
// Bound: operations.  At the serving prefill (B 4, S 2000, H 16, KH 2,
// D 128, causal) the work is 4·D·S(S+1)/2 flops per head, 6.6e10 in all,
// against 37 MB of q, k, v and output: 1,800 flops a byte, far above the
// H100's ~295 for bf16 on the tensor cores.  This first kernel computes
// with scalar fp32 FMAs (67 TFLOP/s peak, not the 989 of bf16 wgmma):
// each thread owns a 4 x 4 tile of the 64 x 64 score block and a 4 x 8 tile
// of the 64 x 128 output, reading q, k and p as float4 from shared memory
// (transposed, padded rows), so each shared load feeds 8 to 10 FMAs.
// Tensor-core products (mma.sync / wgmma) and TMA loads are later work.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per tile
constexpr int kDimPad = 128;       // largest head dim; smaller D is zero-padded
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kLd = kBlockQ + 4;   // padded row of a transposed tile
constexpr float kMasked = -1e30f;  // the TPU kernel's masked score
constexpr int kSmemFloats = 2 * kDimPad * kLd + kBlockK * kLd;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kBlockK * kDimPad <= kDimPad * kLd, "V tile fits the K buffer");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// grid (ceil(S / kBlockQ), B * H); kThreads threads; kSmemBytes dynamic.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int seq_q,
             int seq_k, int heads, int group, int dim, Strides sq, Strides sk,
             Strides sv, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qt = smem;                   // [kDimPad][kLd] query tile, transposed
  float* kv = qt + kDimPad * kLd;     // K tile [kDimPad][kLd], then V [kBlockK][kDimPad]
  float* pt = kv + kDimPad * kLd;     // [kBlockK][kLd] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // key columns tx*4 .. tx*4+3
  const int ty = tid / 16;            // query rows ty*4 .. ty*4+3
  // Late query tiles have the most keys under a causal mask: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / group) * sk.h;
  const T* vb = v + b * sv.b + (h / group) * sv.h;

  for (int i = tid; i < kBlockQ * kDimPad; i += kThreads) {
    const int r = i / kDimPad, d = i % kDimPad;
    float x = 0.0f;
    if (q0 + r < seq_q && d < dim) x = to_float(qb[(q0 + r) * sq.s + d]);
    qt[d * kLd + r] = x;
  }

  // Key tiles that hold a key some row of this tile may see.
  const int n_tiles = (seq_k + kBlockK - 1) / kBlockK;
  const int last_row = min(q0 + kBlockQ, seq_q) - 1;
  const int tile_end = causal ? min(n_tiles, last_row / kBlockK + 1) : n_tiles;
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;

  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.0f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < kBlockK * kDimPad; i += kThreads) {
      const int j = i / kDimPad, d = i % kDimPad;
      float x = 0.0f;
      if (k0 + j < seq_k && d < dim) x = to_float(kb[(k0 + j) * sk.s + d]);
      kv[d * kLd + j] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dim; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&kv[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kvv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], kvv[c], s[i][c]);
    }

    // Mask, then the online-softmax update of each of the thread's 4 rows;
    // a row's 64 scores lie across the 16 threads of one half-warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx * 4 + c;
        float x = s[i][c] * scale;
        if (key >= seq_k) {
          x = -INFINITY;
        } else if ((causal && key > row) || (window > 0 && row - key >= window)) {
          x = kMasked;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Every visited tile holds a key < seq_k, so m_new is finite.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) pt[(tx * 4 + c) * kLd + ty * 4 + i] = s[i][c];
    }
    __syncthreads();  // every thread is done with the K tile

    for (int i = tid; i < kBlockK * kDimPad; i += kThreads) {
      const int j = i / kDimPad, d = i % kDimPad;
      float x = 0.0f;
      if (k0 + j < seq_k && d < dim) x = to_float(vb[(k0 + j) * sv.s + d]);
      kv[j * kDimPad + d] = x;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[j * kLd + ty * 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&kv[j * kDimPad + tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&kv[j * kDimPad + 64 + tx * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  // out is contiguous (B, S, H, D).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + ((static_cast<long long>(b) * seq_q + row) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = (c < 4 ? 0 : 64) + tx * 4 + (c % 4);
      if (d < dim) store(dst + d, o[i][c] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int batch,
                   int seq_q, int seq_k, int heads, int kv_heads, int dim,
                   Strides sq, Strides sk, Strides sv, float scale, int causal,
                   int window, cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, out, seq_q, seq_k, heads, heads / kv_heads, dim, sq, sk, sv,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, T, KH, D), each with the given element strides
// for batch, position and head (D contiguous); out contiguous (B, S, H, D).
// H % KH == 0, 1 <= D <= 128, B * H <= 65535.  dtype: 0 = float32,
// 1 = bfloat16 for all four.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, int batch,
    int seq_q, int seq_k, int heads, int kv_heads, int dim, long long sq_b,
    long long sq_s, long long sq_h, long long sk_b, long long sk_s,
    long long sk_h, long long sv_b, long long sv_s, long long sv_h,
    float scale, int causal, int window, int dtype, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (seq_k <= 0 || dim <= 0 || dim > kDimPad || kv_heads <= 0 ||
      heads % kv_heads != 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h}, sv{sv_b, sv_s, sv_h};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out),
                  batch, seq_q, seq_k, heads, kv_heads, dim, sq, sk, sv, scale,
                  causal, window, s);
  }
  if (dtype == 1) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v),
                  static_cast<__nv_bfloat16*>(out), batch, seq_q, seq_k, heads,
                  kv_heads, dim, sq, sk, sv, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
