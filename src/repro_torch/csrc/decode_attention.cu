// Decode attention for Hopper (sm_90a): one new token per sequence attends
// to its KV cache.  The G query heads that share a KV head are read once
// and scored together against each cached key; a slot counts iff its entry
// in the ring's position table is >= 0.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (a Pallas kernel whose grid (B·KH, T/512) walks the
// cache blocks in order on one core, carrying (m, l, acc) in VMEM scratch,
// with the combine as its last step).  At serving shapes B·KH is small
// (4 x 2 = 8 for qwen2.5-3b) against the H100's 132 SMs, so here the cache
// is split across blocks (flash-decoding): grid (splits, B·KH), each block
// streams its run of 64-key tiles once with an online softmax and writes a
// partial (m, l, acc); a second kernel weighs each partial by
// exp(m_split - m_max) and divides once.  A split whose slots are all empty
// has m = -1e30 and so weighs exp(-1e30 - m_max) = 0 whenever any slot is
// valid, as in the TPU kernel; with no valid slot at all every score is
// -1e30 and the result is the mean of v, as in the reference.  Every call
// writes partials and runs the combine, one split or many.  The cache is
// read in its (B, T, KH, D) layout through its strides: no copy, no
// 128-lane padding, no padding of T (slots past T are excluded).
//
// Numerics: scores, softmax and accumulator in fp32, empty slots -1e30, the
// denominator clamped at 1e-30, the output cast once to q's type.
//
// Bound: memory.  Each cache byte is used by G·2 flops (8 heads: 16 flops
// for 2 bf16 bytes), far below the H100's ~295 flops a byte, so the floor is
// the cache layer's bytes over 3.35 TB/s: 4.2 M elements, about 8.2 MB
// and 2.5 us, at B 4, T 2048 (2000 valid), KH 2, D 128 in bf16.  The design spreads the stream over ~2
// blocks per SM and reads each key and value row once, coalesced; K and V
// tiles are staged in shared memory as fp32 (the K tile on an odd pitch, so
// the per-key dot products are free of bank conflicts).
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // keys per tile
constexpr int kDimPad = 128;       // largest head dim; one thread per column
constexpr int kThreads = 128;
constexpr int kKPitch = kDimPad + 1;
constexpr float kMasked = -1e30f;  // the TPU kernel's masked score

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

constexpr size_t smem_bytes(int group) {
  return sizeof(float) * (group * kDimPad + kTile * kKPitch + kTile * kDimPad +
                          group * kTile + 3 * group);
}

// grid (n_splits, B * KH); kThreads threads; smem_bytes(group) dynamic.
// Block (split, b·kh) covers keys [split·span, min(T, (split+1)·span)).
template <typename T, int kMaxGroup>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ pos,
              float* __restrict__ partial, int seq_k,
              int kv_heads, int group, int dim, Strides sq, Strides sk,
              Strides sv, float scale, int span, int n_splits) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [group][kDimPad]
  float* ks = qs + group * kDimPad;        // [kTile][kKPitch]
  float* vs = ks + kTile * kKPitch;        // [kTile][kDimPad]
  float* ss = vs + kTile * kDimPad;        // [group][kTile] scores, then p
  float* m_s = ss + group * kTile;         // [group] running max
  float* l_s = m_s + group;                // [group] running sum
  float* a_s = l_s + group;                // [group] this tile's rescale

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bkh = blockIdx.y;
  const int b = bkh / kv_heads;
  const int kh = bkh % kv_heads;
  const T* qb = q + b * sq.b + (kh * group) * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  for (int i = tid; i < group * kDimPad; i += kThreads) {
    const int g = i / kDimPad, d = i % kDimPad;
    qs[i] = d < dim ? to_float(qb[g * sq.h + d]) : 0.0f;
  }
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;

  const int t_begin = split * span;
  const int t_end = min(seq_k, t_begin + span);
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kTile * kDimPad; i += kThreads) {
      const int j = i / kDimPad, d = i % kDimPad;
      const bool in = t0 + j < t_end && d < dim;
      ks[j * kKPitch + d] = in ? to_float(kb[(t0 + j) * sk.s + d]) : 0.0f;
      vs[j * kDimPad + d] = in ? to_float(vb[(t0 + j) * sv.s + d]) : 0.0f;
    }
    __syncthreads();

    for (int i = tid; i < group * kTile; i += kThreads) {
      const int g = i / kTile, j = i % kTile;
      float x = -INFINITY;  // past this block's keys: excluded
      if (t0 + j < t_end) {
        float dot = 0.0f;
        for (int d = 0; d < dim; ++d)
          dot = fmaf(qs[g * kDimPad + d], ks[j * kKPitch + d], dot);
        x = pos[t0 + j] >= 0 ? dot * scale : kMasked;
      }
      ss[i] = x;
    }
    __syncthreads();

    // One warp per query head: the tile's max, p = exp(s - m_new), the sum.
    // Each tile holds a key < t_end, so m_new is finite.
    for (int g = warp; g < group; g += kThreads / 32) {
      float* row = ss + g * kTile;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Thread tid owns output column tid of every query head.
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] *= a_s[g];
    for (int j = 0; j < kTile; ++j) {
      const float vj = vs[j * kDimPad + tid];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g] = fmaf(ss[g * kTile + j], vj, acc[g]);
    }
  }
  __syncthreads();

  // partial: [(bkh·n_splits + split)·group + g] rows of (m, l, acc[0:dim]).
  const long long base = (static_cast<long long>(bkh) * n_splits + split) * group;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) continue;
    float* rec = partial + (base + g) * (dim + 2);
    if (tid == 0) {
      rec[0] = m_s[g];
      rec[1] = l_s[g];
    }
    if (tid < dim) rec[2 + tid] = acc[g];
  }
}

// grid (B·KH·group); kThreads threads: row r = bkh·group + g of the output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
               int group, int dim, int n_splits) {
  const long long row = blockIdx.x;
  const long long bkh = row / group;
  const int g = row % group;
  const int d = threadIdx.x;
  auto rec = [&](int split) {
    return partial + ((bkh * n_splits + split) * group + g) * (dim + 2);
  };
  float m_max = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m_max = fmaxf(m_max, rec(s)[0]);
  float l = 0.0f, o = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float* r = rec(s);
    const float w = expf(r[0] - m_max);
    l = fmaf(r[1], w, l);
    if (d < dim) o = fmaf(r[2 + d], w, o);
  }
  if (d < dim) store(out + row * dim + d, o / fmaxf(l, 1e-30f));
}

template <typename T, int kMaxGroup>
cudaError_t launch_partial(const T* q, const T* k, const T* v,
                           const int32_t* pos, float* partial,
                           int batch, int seq_k, int kv_heads, int group,
                           int dim, Strides sq, Strides sk, Strides sv,
                           float scale, int span, int n_splits,
                           cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, kMaxGroup>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxGroup)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_splits, batch * kv_heads);
  decode_kernel<T, kMaxGroup><<<grid, kThreads, smem_bytes(group), stream>>>(
      q, k, v, pos, partial, seq_k, kv_heads, group, dim, sq, sk, sv,
      scale, span, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const int32_t* pos,
                   T* out, float* partial, int batch, int seq_k, int kv_heads,
                   int group, int dim, Strides sq, Strides sk, Strides sv,
                   float scale, int span, int n_splits, cudaStream_t stream) {
  const cudaError_t err =
      group <= 8
          ? launch_partial<T, 8>(q, k, v, pos, partial, batch, seq_k,
                                 kv_heads, group, dim, sq, sk, sv, scale, span,
                                 n_splits, stream)
          : launch_partial<T, 32>(q, k, v, pos, partial, batch, seq_k,
                                  kv_heads, group, dim, sq, sk, sv, scale,
                                  span, n_splits, stream);
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<batch * kv_heads * group, kThreads, 0, stream>>>(
      partial, out, group, dim, n_splits);
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D) with strides (b, -, h); k and v (B, T, KH, D) with strides
// (b, t, h); D contiguous everywhere; pos (T,) int32, contiguous; out
// contiguous (B, 1, H, D) with H = KH·group.  Keys are split into n_splits
// runs of `span` keys (a multiple of 64, n_splits = ceil(T / span));
// partial holds B·KH·n_splits·group·(D + 2) floats.  1 <= group <= 32, 1 <= D <= 128, B·KH <= 65535.
// dtype: 0 = float32, 1 = bfloat16 for q, k, v and out.  Returns the
// cudaError_t of the launches.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* partial, int batch, int seq_k, int kv_heads, int group, int dim,
    long long sq_b, long long sq_h, long long sk_b, long long sk_s,
    long long sk_h, long long sv_b, long long sv_s, long long sv_h,
    float scale, int span, int n_splits, int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (seq_k <= 0 || dim <= 0 || dim > kDimPad || group <= 0 || group > 32 ||
      span <= 0 || span % kTile != 0 || n_splits != (seq_k + span - 1) / span ||
      batch * kv_heads > 65535 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, 0, sq_h}, sk{sk_b, sk_s, sk_h}, sv{sv_b, sv_s, sv_h};
  const auto* p = static_cast<const int32_t*>(pos);
  auto* part = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), p, static_cast<float*>(out),
                  part, batch, seq_k, kv_heads, group, dim, sq, sk, sv, scale,
                  span, n_splits, s);
  }
  if (dtype == 1) {
    return launch(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), p,
                  static_cast<__nv_bfloat16*>(out), part, batch, seq_k,
                  kv_heads, group, dim, sq, sk, sv, scale, span, n_splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
