// Decode attention for Hopper (sm_90a): one new token per sequence attends
// to its KV cache.  The G query heads that share a KV head are read once
// and scored together against each cached key; a slot counts iff its entry
// in the ring's position table is >= 0.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (`_decode_kernel`, a Pallas kernel whose grid
// (B·KH, T/512) walks the cache blocks in order on one core, carrying
// (m, l, acc) in VMEM scratch, with the combine as its last step).  At
// serving shapes B·KH is small (4 x 2 = 8 for qwen2.5-3b) against the
// H100's 132 SMs, so here the cache is split across blocks
// (flash-decoding): grid (splits, B·KH[, G / 16]), each block streams its
// run of 64-slot tiles once with an online softmax.  A split whose slots
// are all empty has m = -1e30 and so weighs exp(-1e30 - m_max) = 0 whenever
// any slot is valid, as in the TPU kernel; with no valid slot at all every
// score is -1e30 and the result is the mean of v, as in the reference.  The
// cache is read in its (B, T, KH, D) layout through its strides: no copy,
// no 128-lane padding, no padding of T (slots past T are excluded).
//
// Two routes, chosen by the input type:
//
// * bf16, the serving type: `decode_bf16_kernel`, one launch a call.  Rows
//   of K and V (and the tile's pos entries) arrive as 16-byte cp.async
//   copies into a ring of 4 bf16 tiles in shared memory: the 8 warps use
//   two tiles a round (16 slots each) while the next two load.  Each warp
//   keeps its own online softmax over its slots; the warps are merged at
//   the end of the block.  For G >= 2 the scores and P·V are mma.sync.m16n8k16 products
//   (the G query heads padded to 16 rows; G > 16 takes a block per 16
//   heads); for G = 1 two lanes share each slot's dot product over 16-byte
//   vectors and a shuffle adds the halves, so every lane is busy.  With more
//   than one split, each block writes its partial (m, l, acc), then
//   __threadfence() and an atomicAdd on a per-(b, kh, head group) counter;
//   the last block to arrive weighs every split by exp(m_split - m_max),
//   writes the output and sets the counter back to 0.  The counters live in
//   a buffer the wrapper zeroes once per device, so the call stays
//   capturable in a CUDA graph; calls that share it must be ordered on one
//   stream.
// * fp32: `decode_kernel` writes the partials and `combine_kernel` merges
//   them (two launches), scores and P·V with fp32 FMAs.
//
// Numerics: scores, softmax and accumulator in fp32, empty slots -1e30, the
// denominator clamped at 1e-30, the output cast once to q's type.  In bf16
// the probabilities exp(s - m) are rounded to bf16 before P·V (relative to
// the running max of the warp's slots), as the TPU kernel's
// `p.astype(v.dtype)`; the sum l adds them unrounded, as there.  (The bf16
// kernel works in base 2: scores scaled by scale·log2(e), exp2.)
//
// Bound: memory.  Each cache byte is used by G·2 flops (8 heads: 16 flops
// for 2 bf16 bytes), far below the H100's ~295 flops a byte, so the floor is
// the cache layer's valid bytes over 3.35 TB/s: 8.23 MB and 2.46 us at
// qwen2.5-3b's step (B 4, T 2048 with 2000 valid, KH 2, D 128), 83.9 MB and
// 25.1 us at zamba2-2.7b's (B 4, T 2096 with 2048 valid, KH 32, D 80).  The
// design keeps that stream in flight: the split plan gives at most one
// wave of blocks, each streaming at least 4 tiles where T has them, with
// two 64-slot tiles (64 KB at D 128) loading while two are used.  What
// the kernel leaves on the table at qwen2.5-3b's shape is latency: a
// block's short chain of tiles, then the last block's combine.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kTile = 64;          // keys per tile
constexpr float kMasked = -1e30f;  // the TPU kernel's masked score

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// ------------------------------------------------------------------ fp32

constexpr int kDimPad = 128;       // largest head dim; one thread per column
constexpr int kThreads = 128;
constexpr int kKPitch = kDimPad + 1;

constexpr size_t smem_bytes(int group) {
  return sizeof(float) * (group * kDimPad + kTile * kKPitch + kTile * kDimPad +
                          group * kTile + 3 * group);
}

// grid (n_splits, B * KH); kThreads threads; smem_bytes(group) dynamic.
// Block (split, b·kh) covers keys [split·span, min(T, (split+1)·span)).
template <int kMaxGroup>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int32_t* __restrict__ pos,
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
  const float* qb = q + b * sq.b + (kh * group) * sq.h;
  const float* kb = k + b * sk.b + kh * sk.h;
  const float* vb = v + b * sv.b + kh * sv.h;

  for (int i = tid; i < group * kDimPad; i += kThreads) {
    const int g = i / kDimPad, d = i % kDimPad;
    qs[i] = d < dim ? qb[g * sq.h + d] : 0.0f;
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
      ks[j * kKPitch + d] = in ? kb[(t0 + j) * sk.s + d] : 0.0f;
      vs[j * kDimPad + d] = in ? vb[(t0 + j) * sv.s + d] : 0.0f;
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
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ partial, float* __restrict__ out,
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
  if (d < dim) out[row * dim + d] = o / fmaxf(l, 1e-30f);
}

template <int kMaxGroup>
cudaError_t launch_partial(const float* q, const float* k, const float* v,
                           const int32_t* pos, float* partial, int batch,
                           int seq_k, int kv_heads, int group, int dim,
                           Strides sq, Strides sk, Strides sv, float scale,
                           int span, int n_splits, cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kMaxGroup>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxGroup)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_splits, batch * kv_heads);
  decode_kernel<kMaxGroup><<<grid, kThreads, smem_bytes(group), stream>>>(
      q, k, v, pos, partial, seq_k, kv_heads, group, dim, sq, sk, sv,
      scale, span, n_splits);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int32_t* pos, float* out, float* partial,
                       int batch, int seq_k, int kv_heads, int group, int dim,
                       Strides sq, Strides sk, Strides sv, float scale,
                       int span, int n_splits, cudaStream_t stream) {
  const cudaError_t err =
      group <= 8
          ? launch_partial<8>(q, k, v, pos, partial, batch, seq_k, kv_heads,
                              group, dim, sq, sk, sv, scale, span, n_splits,
                              stream)
          : launch_partial<32>(q, k, v, pos, partial, batch, seq_k, kv_heads,
                               group, dim, sq, sk, sv, scale, span, n_splits,
                               stream);
  if (err != cudaSuccess) return err;
  combine_kernel<<<batch * kv_heads * group, kThreads, 0, stream>>>(
      partial, out, group, dim, n_splits);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kBfThreads = 32 * kWarps;
constexpr int kSlots = 16;              // slots of a tile per warp
constexpr int kPar = kWarps * kSlots / kTile;  // tiles used at once
constexpr int kStages = 2 * kPar;       // depth of the K/V ring (tiles)
constexpr int kColThreads = 128;        // threads per head in the epilogue
constexpr int kHeads = 16;              // query heads per block (one m16 tile)
constexpr int kMaxSplits = 128;         // the combine reads 4 splits a lane
constexpr float kLog2e = 1.4426950408889634f;

// A ring stage: the K tile, the V tile (each kTile rows at pitch DP + 8),
// then the tile's kTile entries of pos.
template <int DP>
__host__ __device__ constexpr int stage_elems() {
  return 2 * kTile * (DP + 8) + kTile * 2;
}
template <int DP>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(bf16) * kStages * stage_elems<DP>();
}
// The warps' final (m, l, acc) rows, in the ring's place after the loop.
template <int DP>
__host__ __device__ constexpr size_t scratch_bytes() {
  return sizeof(float) * kWarps * kHeads * (DP + 2);
}
template <int DP>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * kHeads * (DP + 8) +
         (ring_bytes<DP>() > scratch_bytes<DP>() ? ring_bytes<DP>()
                                                 : scratch_bytes<DP>());
}

// grid (n_splits, B * KH, ceil(G / 16) for G >= 2, else 1); kBfThreads
// threads; bf16_smem_bytes<DP>() dynamic.  Block (split, b·kh, z) covers
// keys [split·span, min(T, (split+1)·span)) for query heads
// [16 z, min(G, 16 z + 16)) of KV head kh.  kVec: G == 1.
template <int DP, bool kVec>
__global__ void __launch_bounds__(kBfThreads)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int32_t* __restrict__ pos,
                   bf16* __restrict__ out, float* __restrict__ partial,
                   int* __restrict__ counters, int seq_k, int kv_heads,
                   int group, int dim, Strides sq, Strides sk, Strides sv,
                   float scale_log2, int span, int n_splits) {
  using namespace bf16mma;
  constexpr int P = DP + 8;    // row pitch in shared memory
  constexpr int C = DP / 8;    // 16-byte chunks of a padded row
  constexpr int KS = DP / 16;  // k-steps of q·kᵀ
  constexpr int ND = DP / 8;   // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kHeads][P]
  bf16* ring = qs + kHeads * P;                  // [kStages] K, V, pos
  float* sm_m = reinterpret_cast<float*>(ring);  // [kWarps][kHeads], after
  float* sm_l = sm_m + kWarps * kHeads;          // [kWarps][kHeads]
  float* sm_acc = sm_l + kWarps * kHeads;        // [kWarps][kHeads][DP]
  __shared__ int last_block;
  __shared__ float blk_l[kHeads], blk_w[kWarps][kHeads];
  static_assert(bf16_smem_bytes<DP>() >=
                    sizeof(bf16) * kHeads * (DP + 8) +
                        sizeof(float) * (2 * kWarps * kHeads +
                                         2 * kHeads * kMaxSplits),
                "the combine's (m, l) of every split fit the scratch");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, bkh = blockIdx.y;
  const int b = bkh / kv_heads, kh = bkh % kv_heads;
  const int g0 = blockIdx.z * kHeads;
  const int n_heads = min(kHeads, group - g0);
  const bf16* qb = q + b * sq.b + (kh * group + g0) * sq.h;
  const bf16* kb = k + b * sk.b + kh * sk.h;
  const bf16* vb = v + b * sv.b + kh * sv.h;
  const int t_begin = split * span;
  const int t_end = min(seq_k, t_begin + span);
  const int n_t = (t_end - t_begin + kTile - 1) / kTile;

  auto load_kv = [&](int i) {
    const int t0 = t_begin + i * kTile;
    bf16* kt = ring + (i % kStages) * stage_elems<DP>();
    load_tile_async<kBfThreads>(kt, kb + t0 * sk.s, sk.s, kTile, t_end - t0,
                                C, dim, P);
    load_tile_async<kBfThreads>(kt + kTile * P, vb + t0 * sv.s, sv.s, kTile,
                                t_end - t0, C, dim, P);
    if (tid < kTile / 4) {  // pos, 4 slots a copy; past t_end zero-filled
      const int n = min(4, max(0, t_end - t0 - 4 * tid));
      cp_async_16_partial(kt + 2 * kTile * P + 8 * tid,
                          n > 0 ? pos + t0 + 4 * tid : pos, 4 * n);
    }
  };
#pragma unroll
  for (int j = 0; j < kPar; ++j)
    if (j < n_t) load_kv(j);
  cp_async_commit();

  // This warp's running state: rows g and g + 8 (mma) or the one head
  // (vec, where every lane holds the same m and l).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[kVec ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < (kVec ? 1 : ND); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  uint32_t qf[kVec ? 1 : KS][4];    // mma: the heads' A fragments
  float qv[kVec ? DP / 2 : 1];      // vec: this lane's half of q in fp32
  const int half = lane % 2;        // vec: this lane's half of the slot's D
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int d = (half * (DP / 16) + c) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (d < dim) raw = *reinterpret_cast<const uint4*>(qb + d);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p2[j]);
        qv[c * 8 + 2 * j] = f.x;
        qv[c * 8 + 2 * j + 1] = f.y;
      }
    }
  } else {
    for (int i = tid; i < kHeads * C; i += kBfThreads) {
      const int r = i / C, c = i % C;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < n_heads && c * 8 < dim)
        raw = *reinterpret_cast<const uint4*>(qb + r * sq.h + c * 8);
      *reinterpret_cast<uint4*>(qs + r * P + c * 8) = raw;
    }
    __syncthreads();
    const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], qs + a_row * P + kk * 16 + a_col);
  }

  // Round `it` uses tiles kPar·it .. kPar·it + kPar - 1 (warp w takes
  // tile kPar·it + w / 4, slots 16·(w % 4) .. + 15) while the next round's
  // tiles load.
  const int n_rounds = (n_t + kPar - 1) / kPar;
  for (int it = 0; it < n_rounds; ++it) {
#pragma unroll
    for (int j = 0; j < kPar; ++j)
      if ((it + 1) * kPar + j < n_t) load_kv((it + 1) * kPar + j);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i = it * kPar + warp / 4;  // this warp's tile
    const int slot0 = (warp % 4) * kSlots;
    const bf16* stage = ring + (i % kStages) * stage_elems<DP>();
    const bf16* kt = stage + slot0 * P;
    const bf16* vt = kt + kTile * P;
    // This warp's slots: t0 .. t0 + 15, their pos entries at ps.
    const int t0 = t_begin + i * kTile + slot0;
    const int32_t* ps =
        reinterpret_cast<const int32_t*>(stage + 2 * kTile * P) + slot0;
    if (i < n_t) {
      if constexpr (kVec) {
        // Lanes 2j and 2j + 1 score slot j, each over half of D.
        const int j = lane / 2;
        const bf16* krow = kt + j * P + half * (DP / 2);
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 8);
          const __nv_bfloat162* p2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p2[e]);
            dot = fmaf(qv[c * 8 + 2 * e], f.x, dot);
            dot = fmaf(qv[c * 8 + 2 * e + 1], f.y, dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int key = t0 + j;
        float x = -INFINITY;  // past this block's keys: excluded
        if (key < t_end) x = ps[j] >= 0 ? dot * scale_log2 : kMasked;
        float mx = x;
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[0], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m[0] - m_use);
        m[0] = m_new;
        const float p = exp2f(x - m_use);
        float sum = half ? 0.0f : p;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[0] = l[0] * alpha + sum;
        const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
        for (int e = 0; e < 4; ++e) o[0][e] *= alpha;
        // P·V: the lane owns columns 2·lane + {0, 1, 64, 65}.
#pragma unroll
        for (int jj = 0; jj < kSlots; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pb, 2 * jj);
          const bf16* vrow = vt + jj * P;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = c * 64 + 2 * lane;
            if (d < DP) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(vrow + d));
              o[0][2 * c] = fmaf(pj, f.x, o[0][2 * c]);
              o[0][2 * c + 1] = fmaf(pj, f.y, o[0][2 * c + 1]);
            }
          }
        }
      } else {
        const int b_row = lane % 8 + (lane / 16) * 8;
        const int b_col = ((lane / 8) % 2) * 8;
        float s[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t r[4];
          ldmatrix_x4(r, kt + b_row * P + kk * 16 + b_col);
          mma_bf16(s[0], qf[kk], r[0], r[1]);
          mma_bf16(s[1], qf[kk], r[2], r[3]);
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = n * 8 + (lane % 4) * 2 + c;
            const bool in = t0 + j < t_end, valid = ps[j] >= 0;
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2) {
              float& x = s[n][2 * i2 + c];
              x = !in ? -INFINITY : valid ? x * scale_log2 : kMasked;
              mx[i2] = fmaxf(mx[i2], x);
            }
          }
        }
        float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
          const float m_new = fmaxf(m[i2], mx[i2]);
          const float m_use = m_new == -INFINITY ? 0.0f : m_new;
          alpha[i2] = exp2f(m[i2] - m_use);
          m[i2] = m_new;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& x = s[n][2 * i2 + c];
              x = exp2f(x - m_use);
              rs[i2] += x;
            }
          }
          l[i2] = l[i2] * alpha[i2] + rs[i2];
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        const int a_row = lane % 8 + ((lane / 8) % 2) * 8;
        const int a_col = (lane / 16) * 8;
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt + a_row * P + dp * 16 + a_col);
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();
  __syncthreads();    // the ring becomes the scratch below

  // Each warp's (m, l, acc) rows into shared memory.
  if constexpr (kVec) {
    if (lane == 0) {
      sm_m[warp * kHeads] = m[0];
      sm_l[warp * kHeads] = l[0];
    }
    float* acc = sm_acc + warp * kHeads * DP;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = c * 64 + 2 * lane;
      if (d < DP) {
        acc[d] = o[0][2 * c];
        acc[d + 1] = o[0][2 * c + 1];
      }
    }
  } else {
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
      const int r = lane / 4 + i2 * 8;
      if (lane % 4 == 0) {
        sm_m[warp * kHeads + r] = m[i2];
        sm_l[warp * kHeads + r] = l[i2];
      }
      float* acc = sm_acc + (warp * kHeads + r) * DP + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n * 8] = o[n][2 * i2];
        acc[n * 8 + 1] = o[n][2 * i2 + 1];
      }
    }
  }
  __syncthreads();

  // Merge the warps: the block's (m, l) and each warp's weight per head,
  // then its acc, thread d taking column d of every head.  A warp that saw
  // no slot below t_end has m = -inf and weighs 0; the block saw one.
  const bool single = n_splits == 1;
  bf16* out_rows = out + (static_cast<long long>(bkh) * group + g0) * dim;
  float* rec0 = partial +
                (static_cast<long long>(bkh) * n_splits * group + g0) *
                    (dim + 2);
  const long long split_stride = static_cast<long long>(group) * (dim + 2);
  if (tid < n_heads) {
    const int r = tid;
    float mb = -INFINITY, lb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_m[w * kHeads + r]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * kHeads + r];
      const float wt = mw == -INFINITY ? 0.0f : exp2f(mw - mb);
      blk_w[w][r] = wt;
      lb = fmaf(sm_l[w * kHeads + r], wt, lb);
    }
    blk_l[r] = fmaxf(lb, 1e-30f);
    if (!single) {
      float* rec = rec0 + split * split_stride + r * (dim + 2);
      rec[0] = mb;
      rec[1] = lb;
    }
  }
  __syncthreads();
  // Thread tid takes column d of heads tid / 128, + 2, ...
  const int d = tid % kColThreads;
  const int r0 = tid / kColThreads;
  constexpr int kRowStep = kBfThreads / kColThreads;
  if (d < dim) {
    for (int r = r0; r < n_heads; r += kRowStep) {
      float ab = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        ab = fmaf(sm_acc[(w * kHeads + r) * DP + d], blk_w[w][r], ab);
      if (single)
        out_rows[r * dim + d] = __float2bfloat16_rn(ab / blk_l[r]);
      else
        rec0[split * split_stride + r * (dim + 2) + 2 + d] = ab;
    }
  }
  if (single) return;

  // The last block of this (b, kh, head group) to finish combines the splits.
  __threadfence();
  __syncthreads();
  int* counter = counters + bkh * gridDim.z + blockIdx.z;
  if (tid == 0) last_block = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // Split s of head r: rec0 + r·(D + 2) + s·split_stride holds
  // (m, l, acc[0:D]).  Every (m, l) at once into shared memory; then each
  // head's m_max, l and split weights (warp w takes heads w, w + 4, ...);
  // then thread d sums column d of every head, split by split, the loads of
  // one split independent of one another.
  float* m_s = sm_acc;                   // [kHeads][kMaxSplits]
  float* w_s = m_s + kHeads * kMaxSplits;  // [kHeads][kMaxSplits], l then w
  for (int i = tid; i < n_heads * n_splits; i += kBfThreads) {
    const int r = i / n_splits, sp = i % n_splits;
    const float* rec = rec0 + r * (dim + 2) + sp * split_stride;
    m_s[r * kMaxSplits + sp] = __ldcg(rec);
    w_s[r * kMaxSplits + sp] = __ldcg(rec + 1);
  }
  __syncthreads();
  for (int r = warp; r < n_heads; r += kWarps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < n_splits; sp += 32)
      mx = fmaxf(mx, m_s[r * kMaxSplits + sp]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float lt = 0.0f;
    for (int sp = lane; sp < n_splits; sp += 32) {
      const float wt = exp2f(m_s[r * kMaxSplits + sp] - mx);
      lt = fmaf(w_s[r * kMaxSplits + sp], wt, lt);
      w_s[r * kMaxSplits + sp] = wt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (lane == 0) blk_l[r] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  if (d < dim) {
    constexpr int kRows = kHeads / kRowStep;
    float at[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) at[e] = 0.0f;
    const float* col = rec0 + 2 + d;
#pragma unroll 2
    for (int sp = 0; sp < n_splits; ++sp) {
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        const int r = r0 + e * kRowStep;
        if (r < n_heads)
          at[e] = fmaf(__ldcg(col + r * (dim + 2) + sp * split_stride),
                       w_s[r * kMaxSplits + sp], at[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const int r = r0 + e * kRowStep;
      if (r < n_heads)
        out_rows[r * dim + d] = __float2bfloat16_rn(at[e] / blk_l[r]);
    }
  }
  if (tid == 0) *counter = 0;
}

template <int DP, bool kVec>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const int32_t* pos, bf16* out, float* partial,
                        int* counters, int batch, int seq_k, int kv_heads,
                        int group, int dim, Strides sq, Strides sk,
                        Strides sv, float scale, int span, int n_splits,
                        cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<DP>();
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_bf16_kernel<DP, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_splits, batch * kv_heads,
                  kVec ? 1 : (group + kHeads - 1) / kHeads);
  decode_bf16_kernel<DP, kVec><<<grid, kBfThreads, smem, stream>>>(
      q, k, v, pos, out, partial, counters, seq_k, kv_heads, group, dim, sq,
      sk, sv, scale * kLog2e, span, n_splits);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16_any_group(const bf16* q, const bf16* k,
                                  const bf16* v, const int32_t* pos,
                                  bf16* out, float* partial, int* counters,
                                  int batch, int seq_k, int kv_heads,
                                  int group, int dim, Strides sq, Strides sk,
                                  Strides sv, float scale, int span,
                                  int n_splits, cudaStream_t stream) {
  return group == 1
             ? launch_bf16<DP, true>(q, k, v, pos, out, partial, counters,
                                     batch, seq_k, kv_heads, group, dim, sq,
                                     sk, sv, scale, span, n_splits, stream)
             : launch_bf16<DP, false>(q, k, v, pos, out, partial, counters,
                                      batch, seq_k, kv_heads, group, dim, sq,
                                      sk, sv, scale, span, n_splits, stream);
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

}  // namespace

// q (B, 1, H, D) with strides (b, -, h); k and v (B, T, KH, D) with strides
// (b, t, h); D contiguous everywhere; pos (T,) int32, contiguous; out
// contiguous (B, 1, H, D) with H = KH·group.  Keys are split into n_splits
// runs of `span` keys (a multiple of 64, n_splits = ceil(T / span));
// partial holds B·KH·n_splits·group·(D + 2) floats.  1 <= group <= 32,
// 1 <= D <= 128, B·KH <= 65535.  Both entry points return the cudaError_t
// of their launches.
//
// float32: the split kernel, then the combine kernel.
extern "C" int decode_attention_f32(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* partial, int batch, int seq_k, int kv_heads, int group, int dim,
    long long sq_b, long long sq_h, long long sk_b, long long sk_s,
    long long sk_h, long long sv_b, long long sv_s, long long sv_h,
    float scale, int span, int n_splits, void* stream) {
  if (batch <= 0) return 0;
  if (seq_k <= 0 || dim <= 0 || dim > kDimPad || group <= 0 || group > 32 ||
      span <= 0 || span % kTile != 0 || n_splits != (seq_k + span - 1) / span ||
      batch * kv_heads > 65535 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(pos),
      static_cast<float*>(out), static_cast<float*>(partial), batch, seq_k,
      kv_heads, group, dim, Strides{sq_b, 0, sq_h}, Strides{sk_b, sk_s, sk_h},
      Strides{sv_b, sv_s, sv_h}, scale, span, n_splits,
      static_cast<cudaStream_t>(stream));
}

// bfloat16: the fused kernel, one launch.  Also needs D % 8 == 0, q, k and
// v based at 16-byte aligned addresses with strides that are multiples of 8
// elements, pos 16-byte aligned, n_splits <= 128 and, when n_splits > 1,
// `counters`: B·KH·ceil(group / 16) ints, all 0 (the kernel leaves them 0).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* partial, void* counters, int batch, int seq_k, int kv_heads,
    int group, int dim, long long sq_b, long long sq_h, long long sk_b,
    long long sk_s, long long sk_h, long long sv_b, long long sv_s,
    long long sv_h, float scale, int span, int n_splits, void* stream) {
  if (batch <= 0) return 0;
  const Strides sq{sq_b, 0, sq_h}, sk{sk_b, sk_s, sk_h}, sv{sv_b, sv_s, sv_h};
  if (seq_k <= 0 || dim <= 0 || dim > 128 || dim % 8 != 0 || group <= 0 ||
      group > 32 || span <= 0 || span % kTile != 0 ||
      n_splits != (seq_k + span - 1) / span || n_splits > kMaxSplits ||
      batch * kv_heads > 65535 ||
      (n_splits > 1 && (partial == nullptr || counters == nullptr)) ||
      !aligned16(q, sq) || !aligned16(k, sk) || !aligned16(v, sv) ||
      reinterpret_cast<uintptr_t>(pos) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<bf16*>(out);
  auto* part = static_cast<float*>(partial);
  auto* cnt = static_cast<int*>(counters);
  auto s = static_cast<cudaStream_t>(stream);
#define DECODE_BF16(DP)                                                      \
  case DP:                                                                   \
    return launch_bf16_any_group<DP>(qp, kp, vp, pp, op, part, cnt, batch,   \
                                     seq_k, kv_heads, group, dim, sq, sk, sv, \
                                     scale, span, n_splits, s)
  switch ((dim + 15) / 16 * 16) {
    DECODE_BF16(16);
    DECODE_BF16(32);
    DECODE_BF16(48);
    DECODE_BF16(64);
    DECODE_BF16(80);
    DECODE_BF16(96);
    DECODE_BF16(112);
    DECODE_BF16(128);
  }
#undef DECODE_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}
