// Flash attention for Hopper (sm_90a): softmax(q kᵀ · scale, masked) v for
// every query row, with an online softmax over key tiles, so the (S, T)
// score matrix never reaches device memory.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (`_fa_kernel`, a Pallas kernel whose grid (B·H, S/bq,
// T/bk) walks the key blocks in order on one core, with the running
// (m, l, acc) carried in VMEM scratch from one grid step to the next).
// Hopper's blocks run in parallel and carry nothing between them, so here
// one thread block owns one (batch·head, 64-row query tile) and loops over
// the 64-key tiles itself, the running (m, l, acc) in registers.  Query
// head h reads KV head h / G (GQA).  The causal and sliding-window masks
// come from the row and key indices; key tiles wholly above the diagonal or
// wholly outside the window are skipped, and the query tiles with the most
// keys start first.  The inputs are read in their (B, S, H, D) /
// (B, T, KH, D) layouts through their strides (D contiguous).
//
// Two kernels, chosen by the input type:
//
// * bf16, the serving type: `flash_mma_kernel`, on the tensor cores.  Each
//   of the 4 warps owns 16 query rows, held in registers as the A fragments
//   of mma.sync.m16n8k16 (bf16 in, fp32 accumulate) for the whole loop.  K
//   and V tiles arrive as bf16 by 16-byte cp.async into a 2-stage ring in
//   shared memory (the next tile loads while this one is used), at a row
//   pitch of an odd number of 16-byte chunks so ldmatrix.x4 (and .trans for
//   V as the B operand of P·V) is free of bank conflicts.  The score
//   fragment is scaled, masked, exponentiated and rounded to bf16 in
//   registers and used as the A fragment of P·V directly; row max and sum
//   are reduced across the quad of threads that holds a row.  Element masks
//   are applied only on tiles that straddle the diagonal, the window edge
//   or the end of T.  D is padded to a multiple of 16 only (80 stays 80:
//   5 k-steps, not 8).  It takes D % 8 == 0 and 16-byte aligned bases and
//   row strides (the wrapper refuses anything else).
// * fp32: `scalar_kernel`, fp32 FMAs out of shared memory (each thread a
//   4 x 4 tile of the 64 x 64 score block and a 4 x 8 tile of the output).
//   fp32 inputs are held within 1e-4 of the plain version on the card; the
//   tensor cores' TF32 keeps about three decimal digits and would not be.
//
// Numerics, as the TPU kernel: scores, softmax and accumulator in fp32,
// masked scores set to -1e30 (a row's keys outside the masks weigh
// exp(-1e30 - m) = 0 once a valid key is seen), the denominator clamped at
// 1e-30, the output cast once to the input type.  Keys past T are excluded
// outright (-inf).  In bf16 the probabilities exp(s - m) are rounded to
// bf16 before P·V, as the TPU kernel's `p.astype(v.dtype)`; the sum l adds
// them unrounded, as there.  (The bf16 kernel works in base 2: scores are
// scaled by scale·log2(e) and exponentiated with exp2.)  The fp32 kernel
// keeps p in fp32.
//
// Bound: operations.  At qwen2.5-3b's prefill (B 4, S 2000, H 16, KH 2,
// D 128, causal) the work is 4·D flops per unmasked (query, key) pair,
// 6.557e10 in all, 0.0663 ms at 989 TFLOP/s (bf16 dense), against 37 MB of
// q, k, v and output (0.011 ms at 3.35 TB/s).  The tensor-core kernel
// moves both products onto mma.sync; what it leaves on the table is the
// shared-memory traffic of ldmatrix (each x4 load feeds two products) and
// the exponentials, which wgmma with TMA and warp specialisation would
// overlap.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's masked score

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// ------------------------------------------------------------------ fp32

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per tile
constexpr int kDimPad = 128;       // largest head dim; smaller D is zero-padded
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int kLd = kBlockQ + 4;   // padded row of a transposed tile
constexpr int kSmemFloats = 2 * kDimPad * kLd + kBlockK * kLd;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kBlockK * kDimPad <= kDimPad * kLd, "V tile fits the K buffer");

// grid (ceil(S / kBlockQ), B * H); kThreads threads; kSmemBytes dynamic.
__global__ void __launch_bounds__(kThreads, 2)
scalar_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              int seq_q, int seq_k, int heads, int group, int dim,
              Strides sq, Strides sk, Strides sv, float scale, int causal,
              int window) {
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
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + (h / group) * sk.h;
  const float* vb = v + b * sv.b + (h / group) * sv.h;

  for (int i = tid; i < kBlockQ * kDimPad; i += kThreads) {
    const int r = i / kDimPad, d = i % kDimPad;
    float x = 0.0f;
    if (q0 + r < seq_q && d < dim) x = qb[(q0 + r) * sq.s + d];
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
      if (k0 + j < seq_k && d < dim) x = kb[(k0 + j) * sk.s + d];
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
      if (k0 + j < seq_k && d < dim) x = vb[(k0 + j) * sv.s + d];
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
    float* dst = out + ((static_cast<long long>(b) * seq_q + row) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = (c < 4 ? 0 : 64) + tx * 4 + (c % 4);
      if (d < dim) dst[d] = o[i][c] / denom;
    }
  }
}


cudaError_t launch_scalar(const float* q, const float* k, const float* v,
                          float* out, int batch, int seq_q, int seq_k,
                          int heads, int kv_heads, int dim, Strides sq,
                          Strides sk, Strides sv, float scale, int causal,
                          int window, cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        scalar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  scalar_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, out, seq_q, seq_k, heads, heads / kv_heads, dim, sq, sk, sv,
      scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kKeys = 64;      // keys per tile
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;     // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (DP + 8) * (kRows + 2 * kStages * kKeys);
}

// grid (ceil(S / kRows), B * H); kMmaThreads threads; mma_smem_bytes<DP>()
// dynamic.  DP is D rounded up to 16; scale_log2 = scale · log2(e).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 int seq_q, int seq_k, int heads, int group, int dim,
                 Strides sq, Strides sk, Strides sv, float scale_log2,
                 int causal, int window) {
  using namespace bf16mma;
  constexpr int P = DP + 8;    // row pitch in shared memory
  constexpr int C = DP / 8;    // 16-byte chunks of a padded row
  constexpr int KS = DP / 16;  // k-steps of q·kᵀ
  constexpr int ND = DP / 8;   // 8-wide n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][P]
  bf16* ks = qs + kRows * P;                     // [kStages][kKeys][P]
  bf16* vs = ks + kStages * kKeys * P;           // [kStages][kKeys][P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Late query tiles have the most keys under a causal mask: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const bf16* qb = q + b * sq.b + h * sq.h + q0 * sq.s;
  const bf16* kb = k + b * sk.b + (h / group) * sk.h;
  const bf16* vb = v + b * sv.b + (h / group) * sv.h;

  // Key tiles that hold a key some row of this tile may see.
  const int n_tiles = (seq_k + kKeys - 1) / kKeys;
  const int last_row = min(q0 + kRows, seq_q) - 1;
  const int tile_end = causal ? min(n_tiles, last_row / kKeys + 1) : n_tiles;
  const int tile_begin = window > 0 ? max(0, q0 - window + 1) / kKeys : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kKeys;
    load_tile_async<kMmaThreads>(ks + stage * kKeys * P, kb + k0 * sk.s,
                                 sk.s, kKeys, seq_k - k0, C, dim, P);
    load_tile_async<kMmaThreads>(vs + stage * kKeys * P, vb + k0 * sv.s,
                                 sv.s, kKeys, seq_k - k0, C, dim, P);
  };
  load_tile_async<kMmaThreads>(qs, qb, sq.s, kRows, seq_q - q0, C, dim, P);
  load_kv(tile_begin, 0);
  cp_async_commit();

  uint32_t qf[KS][4];          // this warp's 16 query rows, A fragments
  float o[ND][4];              // accumulator, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const int row0 = q0 + warp * 16 + lane / 4;  // and row0 + 8
  const int col = (lane % 4) * 2;              // this thread's column pair
  // ldmatrix row offsets: A (q) and trans-B (v) tiles take matrix l / 8 as
  // (rows +8 if odd, cols +8 if >= 2); B (k) as (rows +8 if >= 2, cols +8
  // if odd).
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int stage = (tile - tile_begin) % kStages;
    if (tile + 1 < tile_end)
      load_kv(tile + 1, (tile + 1 - tile_begin) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == tile_begin) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + a_row) * P + kk * 16 + a_col);
    }
    const bf16* kt = ks + stage * kKeys * P;
    const bf16* vt = vs + stage * kKeys * P;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (np * 16 + b_row) * P + kk * 16 + b_col);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // Scale, and mask where the tile straddles a mask's edge or T's end.
    const int k0 = tile * kKeys;
    const bool edge = k0 + kKeys > seq_k ||
                      (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && q0 + kRows - 1 - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int row = row0 + (e / 2) * 8;
          const int key = k0 + n * 8 + col + (e % 2);
          if (key >= seq_k) {
            x = -INFINITY;
          } else if ((causal && key > row) ||
                     (window > 0 && row - key >= window)) {
            x = kMasked;
          }
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    // Online softmax.  Every visited tile holds a key < seq_k, so the new
    // max is finite.
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);
        rs[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P (rounded to bf16) · V, P straight from the score fragments.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (j * 16 + a_row) * P + dp * 16 + a_col);
        mma_bf16(o[2 * dp], pa, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // out is contiguous (B, S, H, D).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + i * 8;
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* dst = out + ((static_cast<long long>(b) * seq_q + row) * heads + h) *
                          dim;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + col;
      if (d < dim)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
            o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int batch, int seq_q, int seq_k, int heads,
                       int kv_heads, int dim, Strides sq, Strides sk,
                       Strides sv, float scale, int causal, int window,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((seq_q + kRows - 1) / kRows, batch * heads);
  flash_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, out, seq_q, seq_k, heads, heads / kv_heads, dim, sq, sk, sv,
      scale * kLog2e, causal, window);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

}  // namespace

// q (B, S, H, D), k and v (B, T, KH, D), each with the given element strides
// for batch, position and head (D contiguous); out contiguous (B, S, H, D).
// H % KH == 0, 1 <= D <= 128, B * H <= 65535.  Both entry points return
// the cudaError_t of the launch.
//
// float32 inputs and output: the scalar fp32 kernel.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* out, int batch,
    int seq_q, int seq_k, int heads, int kv_heads, int dim, long long sq_b,
    long long sq_s, long long sq_h, long long sk_b, long long sk_s,
    long long sk_h, long long sv_b, long long sv_s, long long sv_h,
    float scale, int causal, int window, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (seq_k <= 0 || dim <= 0 || dim > kDimPad || kv_heads <= 0 ||
      heads % kv_heads != 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_scalar(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), batch, seq_q,
      seq_k, heads, kv_heads, dim, Strides{sq_b, sq_s, sq_h},
      Strides{sk_b, sk_s, sk_h}, Strides{sv_b, sv_s, sv_h}, scale, causal,
      window, static_cast<cudaStream_t>(stream));
}

// bfloat16 inputs and output: the tensor-core kernel.  Also needs D % 8 == 0
// and q, k, v based at 16-byte aligned addresses with strides that are
// multiples of 8 elements.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, int batch,
    int seq_q, int seq_k, int heads, int kv_heads, int dim, long long sq_b,
    long long sq_s, long long sq_h, long long sk_b, long long sk_s,
    long long sk_h, long long sv_b, long long sv_s, long long sv_h,
    float scale, int causal, int window, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h}, sv{sv_b, sv_s, sv_h};
  if (seq_k <= 0 || dim <= 0 || dim > 128 || dim % 8 != 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || batch * heads > 65535 || !aligned16(q, sq) ||
      !aligned16(k, sk) || !aligned16(v, sv) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define FLASH_MMA(DP)                                                        \
  case DP:                                                                   \
    return launch_mma<DP>(qp, kp, vp, op, batch, seq_q, seq_k, heads,        \
                          kv_heads, dim, sq, sk, sv, scale, causal, window, s)
  switch ((dim + 15) / 16 * 16) {
    FLASH_MMA(16);
    FLASH_MMA(32);
    FLASH_MMA(48);
    FLASH_MMA(64);
    FLASH_MMA(80);
    FLASH_MMA(96);
    FLASH_MMA(112);
    FLASH_MMA(128);
  }
#undef FLASH_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}
