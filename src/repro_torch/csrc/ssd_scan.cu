// Mamba-2 SSD chunked scan for Hopper (sm_90a): for every (batch, head),
//
//     state_t = exp(dt_t · A) · state_{t-1} + (dt_t x_t) ⊗ B_t      (P x N)
//     y_t     = state_t · C_t
//
// computed chunk by chunk, with A = -exp(a_log[h]) and the final state kept.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (a Pallas
// kernel whose grid (B, H, n_chunks) walks the chunks in order on one core,
// with the (N, P) state carried in VMEM scratch from one grid step to the
// next).  Hopper's blocks run in parallel and carry nothing between them, so
// here one thread block owns one (batch, head, tile of P) and loops over the
// chunks itself: the state never reaches device memory until the final
// state is written, directly in (B, H, P, N).  Each chunk computes what the
// TPU kernel's body computes:
//
//     cum     = cumsum(dt · A)                      (the chunk's log decays)
//     M[i,j]  = (C_i · B_j) · exp(cum_i - cum_j)    for j <= i, else 0
//     y_i     = Σ_j M[i,j] xdt_j + exp(cum_i) · (C_i · state)
//     state   = exp(cum_last) · state + Σ_i exp(cum_last - cum_i) B_i ⊗ xdt_i
//
// The chunk is the kernel's own 64 rows, not the model's ssm_chunk: the
// result is the same function, differing only in rounding.  Any L is taken:
// the ragged last chunk's rows are zero (dt · A = 0, B = C = xdt = 0), so
// they add nothing and decay nothing.
//
// Inputs are read in the model's layouts through their strides: x (B, L, H,
// P), B and C (B, L, G, N) with the last dim contiguous (views into the conv
// output), dt (B, L, H) fp32 after softplus, a_log (H,) fp32.  Head h reads
// group h / (H / G); nothing is repeated, transposed or pre-scaled.  The dt
// scaling and the discretisation happen here, with the TPU path's roundings:
// xdt = x · dt rounded to x's type (dt itself rounded to x's type first),
// dt · A in fp32, (C·Bᵀ ∘ L) rounded to x's type before the product with
// xdt, y_diag, y_off and the state in fp32, y cast once to x's type.  One
// place differs: the running sum cum is kept in fp64, and the in-chunk
// decays exp(cum_i - cum_j) and exp(cum_last - cum_i) come from fp64
// differences.  In fp32 (as the TPU kernel) |cum| reaches hundreds within a
// chunk and each difference loses that many ulps of its exponent: with fp32
// sums mamba2-130m's fp32 logits at full width (B 4, L 2048) lay 1.1e-4 of
// their maximum from the reference model's own scan after 4 decode steps,
// with fp64 sums at most 1.8e-5 over 48 steps (chip_smoke.py, H100).
//
// Bound: bytes.  At mamba2-130m's prefill (B 4, L 2048, H 24, P 64, N 128,
// bf16) the scan moves 58 MB (x and y 25 MB each) and needs 7.3 GFLOP at
// the kernel's chunk: 125 flops a byte, under the H100's ~295 for bf16 on
// the tensor cores.  Two kernels, chosen by the input type:
//
// * bf16, the serving type: `ssd_mma_kernel`, on the tensor cores.  One
//   block of 8 warps owns 64 columns of P of one (batch, head).  Warp w
//   keeps rows 16 (w % 4) .. +15 of stateᵀ (P x N, fp32) and half w / 4 of
//   its N columns in registers, as mma.sync.m16n8k16 accumulators, for the
//   whole sequence.  Chunks of x, B, C (bf16) and dt arrive by cp.async
//   into a 2-stage ring; chunk k+1's loads are issued in the middle of
//   chunk k.  Per chunk:
//     - C·Bᵀ once for the block (each warp 16 rows and 2 of the 4 column
//       pairs), masked, scaled by the fp64 decays and rounded to bf16 into
//       shared memory as M;
//     - yᵀ = stateᵀ·Cᵀ (scaled by exp(cum) per column) + xdtᵀ·Mᵀ, with M
//       from shared memory as the B operand: each warp forms stateᵀ·Cᵀ over
//       its half of N, and the two warps of a row tile add their halves
//       through shared memory, each keeping 32 of the chunk's columns;
//     - stateᵀ = exp(cum_last) · stateᵀ + (xdt · decay)ᵀ · B, each warp over
//       its half of N.
//   The two products with an fp32 operand, as in the TPU kernel (the state
//   in C·state, and B·decay in the update), split that operand into bf16
//   hi + lo parts and run two mma.sync, which keeps about 16 bits of its
//   mantissa (one bf16 pass put the state 7e-4 of its maximum off the plain
//   version's in a CPU model of these roundings, against a 2e-5 gate); the
//   update scales xdt by the decay instead of B (one row scale either way).
//   C·Bᵀ and M·xdt take bf16 operands exactly, as the TPU kernel does.
//   Each warp stages its y in shared memory and writes it in 16-byte rows.
//   The kernel is bound by latency, not by the tensor cores: with one block
//   of 8 warps per SM each phase waits on shared memory and mma results, so
//   the code loads every operand of a phase before its first store (the
//   compiler cannot tell the shared arrays apart) and avoids branches
//   around unrolled products.  Takes P and N multiples of 8 and 16-byte
//   aligned x, B, C (the wrapper refuses anything else); N is zero-filled up
//   to 32, 64, 128 or 256 and the P edge masked.
// * fp32: `scalar_kernel`, fp32 FMAs from shared memory (one block per
//   (batch, head, 32-column tile of P); each thread a 4 x 4 tile of C·Bᵀ,
//   8 rows of y, N/8 entries of the state tile).  fp32 inputs are held
//   within 2e-5 of the plain version on the card; bf16 splits would not be.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kChunk = 64;      // rows of a chunk (the kernel's own)
constexpr int kMaxState = 256;  // largest N either kernel takes

struct Strides {
  long long b, l, h;  // elements; the last dim is contiguous
};

// ------------------------------------------------------------------ fp32

constexpr int kTileP = 32;      // columns of P per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = kThreads / kTileP;   // 8 row groups in the y/state phases

__host__ __device__ constexpr size_t smem_floats(int n) {
  return static_cast<size_t>(n) * kTileP          // state tile [N][kTileP]
         + 2 * static_cast<size_t>(kChunk) * (n + 1)  // C, B [kChunk][N + 1]
         + kChunk * kTileP                        // xdt [kChunk][kTileP]
         + kChunk * (kChunk + 1)                  // M [kChunk][kChunk + 1]
         + 2 * kChunk                             // cum (fp64)
         + 2 * kChunk;                            // decay to end, dt
}

// grid (ceil(P / kTileP), H, B); kThreads threads; smem_floats(N) dynamic.
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_log, const float* __restrict__ bmat,
              const float* __restrict__ cmat, float* __restrict__ y,
              float* __restrict__ state_out, int seq, int heads, int head_dim,
              int groups, int n_state, Strides sx, Strides sdt, Strides sb,
              Strides sc) {
  extern __shared__ __align__(16) float smem[];
  const int ns = n_state + 1;                  // padded row of C and B
  double* cum = reinterpret_cast<double*>(smem);  // [kChunk] running sum
  float* st = smem + 2 * kChunk;               // [N][kTileP] state tile
  float* cs = st + n_state * kTileP;           // [kChunk][ns] C
  float* bs = cs + kChunk * ns;                // [kChunk][ns] B, then B·decay
  float* xs = bs + kChunk * ns;                // [kChunk][kTileP] xdt
  float* ms = xs + kChunk * kTileP;            // [kChunk][kChunk + 1] M
  float* dec = ms + kChunk * (kChunk + 1);     // [kChunk] exp(cum_last - cum)
  float* dtr = dec + kChunk;                   // [kChunk] dt

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / (heads / groups);
  const int np = min(kTileP, head_dim - p0);
  const float a = -expf(a_log[h]);
  const float* xb = x + bb * sx.b + h * sx.h + p0;
  const float* dtb = dt + bb * sdt.b + h * sdt.h;
  const float* bbase = bmat + bb * sb.b + g * sb.h;
  const float* cbase = cmat + bb * sc.b + g * sc.h;
  float* yb = y + (static_cast<long long>(bb) * seq * heads + h) * head_dim + p0;
  const long long sy = static_cast<long long>(heads) * head_dim;

  for (int i = tid; i < n_state * kTileP; i += kThreads) st[i] = 0.f;

  const int pc = tid % kTileP;   // this thread's column in the y/state phases
  const int rg = tid / kTileP;   // its row group (one per warp)
  const int tx = tid % 16, ty = tid / 16;   // its 4 x 4 tile of C·Bᵀ

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int q = min(kChunk, seq - t0);
    // 1. Load the chunk: dt · A and dt per row, C and B.
    if (tid < kChunk) {
      float da = 0.f, d = 0.f;
      if (tid < q) {
        d = dtb[(t0 + tid) * sdt.l];
        da = d * a;
      }
      cum[tid] = da;
      dtr[tid] = d;
    }
    for (int e = tid; e < kChunk * n_state; e += kThreads) {
      const int i = e / n_state, n = e % n_state;
      float bv = 0.f, cv = 0.f;
      if (i < q) {
        bv = bbase[(t0 + i) * sb.l + n];
        cv = cbase[(t0 + i) * sc.l + n];
      }
      bs[i * ns + n] = bv;
      cs[i * ns + n] = cv;
    }
    __syncthreads();
    // 2. The running sum of dt · A over the chunk in fp64 (warp 0, two rows
    //    a lane), and xdt = x · dt.
    if (tid < 32) {
      const double d0 = cum[2 * tid], d1 = cum[2 * tid + 1];
      double incl = d0 + d1;
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
      cum[2 * tid] = excl + d0;
      cum[2 * tid + 1] = excl + d0 + d1;
    }
    for (int e = tid; e < kChunk * kTileP; e += kThreads) {
      const int i = e / kTileP, p = e % kTileP;
      float v = 0.f;
      if (i < q && p < np) v = xb[(t0 + i) * sx.l + p] * dtr[i];
      xs[e] = v;
    }
    __syncthreads();
    const double cum_last = cum[kChunk - 1];
    if (tid < kChunk) dec[tid] = expf(static_cast<float>(cum_last - cum[tid]));
    // 3. M = C·Bᵀ ∘ L: rows ty + 16a, columns tx + 16c.
    {
      float acc[4][4] = {};
      for (int n = 0; n < n_state; ++n) {
        float cr[4], br[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) br[c] = bs[(tx + 16 * c) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const float m = j <= i
              ? acc[r][c] * expf(static_cast<float>(cum[i] - cum[j]))
              : 0.f;
          ms[i * (kChunk + 1) + j] = m;
        }
      }
    }
    __syncthreads();
    // 4. y for rows rg + 8a of column pc: the in-chunk term and the carried
    //    state's term (the state before this chunk's update).  Meanwhile B's
    //    rows are weighted by their decay to the chunk's end, for step 5.
    {
      float yd[kChunk / kRows] = {}, yo[kChunk / kRows] = {};
      for (int j = 0; j < kChunk; ++j) {
        const float xv = xs[j * kTileP + pc];
#pragma unroll
        for (int r = 0; r < kChunk / kRows; ++r)
          yd[r] = fmaf(ms[(rg + kRows * r) * (kChunk + 1) + j], xv, yd[r]);
      }
      for (int n = 0; n < n_state; ++n) {
        const float sv = st[n * kTileP + pc];
#pragma unroll
        for (int r = 0; r < kChunk / kRows; ++r)
          yo[r] = fmaf(cs[(rg + kRows * r) * ns + n], sv, yo[r]);
      }
#pragma unroll
      for (int r = 0; r < kChunk / kRows; ++r) {
        const int i = rg + kRows * r;
        if (i < q && pc < np)
          yb[(t0 + i) * sy + pc] =
              yd[r] + yo[r] * expf(static_cast<float>(cum[i]));
      }
      for (int e = tid; e < kChunk * n_state; e += kThreads) {
        const int i = e / n_state, n = e % n_state;
        bs[i * ns + n] *= dec[i];
      }
    }
    __syncthreads();
    // 5. state = exp(cum_last) · state + Σ_i (B_i · decay_i) ⊗ xdt_i for the
    //    entries (rg + 8k, pc).
    {
      const float keep = expf(static_cast<float>(cum_last));
      for (int n0 = rg; n0 < n_state; n0 += kRows * 4) {
        float acc[4] = {};
        for (int i = 0; i < kChunk; ++i) {
          const float xv = xs[i * kTileP + pc];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = n0 + kRows * k;
            if (n < n_state) acc[k] = fmaf(bs[i * ns + n], xv, acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = n0 + kRows * k;
          if (n < n_state) st[n * kTileP + pc] = st[n * kTileP + pc] * keep + acc[k];
        }
      }
    }
    __syncthreads();
  }
  // The final state, (B, H, P, N) fp32, N fastest.
  float* so = state_out + ((static_cast<long long>(bb) * heads + h) * head_dim
                           + p0) * n_state;
  for (int e = tid; e < np * n_state; e += kThreads) {
    const int p = e / n_state, n = e % n_state;
    so[e] = st[n * kTileP + p];
  }
}

cudaError_t launch_scalar(const float* x, const float* dt, const float* a_log,
                          const float* b, const float* c, float* y,
                          float* state_out, int batch, int seq, int heads,
                          int head_dim, int groups, int n_state, Strides sx,
                          Strides sdt, Strides sb, Strides sc,
                          cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        scalar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxState) * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((head_dim + kTileP - 1) / kTileP, heads, batch);
  const size_t smem = smem_floats(n_state) * sizeof(float);
  scalar_kernel<<<grid, kThreads, smem, stream>>>(
      x, dt, a_log, b, c, y, state_out, seq, heads, head_dim, groups, n_state,
      sx, sdt, sb, sc);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;
constexpr int kMmaTileP = 64;             // columns of P per block
constexpr int kWarps = 8;                 // 4 row tiles of P x 2 halves of N
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;                // depth of the chunk ring
constexpr int kPitchP = kMmaTileP + 8;    // row pitch of x, xdt·decay, y
constexpr int kPitchQ = kChunk + 8;       // row pitch of M

// Shared memory of ssd_mma_kernel<NP>: the ring of x, B, C (bf16) and dt,
// then M, xdt·decay hi and lo, the y tile, cum (fp64), exp(cum), the
// decays to the chunk's end, and the warps' exchange of partial y tiles.
template <int NP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kStages * kChunk * kPitchP
                         + 2 * kStages * kChunk * (NP + 8)
                         + kChunk * kPitchQ + 3 * kChunk * kPitchP)
         + sizeof(double) * kChunk + sizeof(float) * (kStages + 2) * kChunk
         + sizeof(float) * kWarps * 16 * 32;
}

// 4 bytes from global to shared memory, asynchronously; zeroed when not
// `valid`.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf16mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v0, v1 as bf16 hi + lo (hi = v rounded, lo = the rest rounded), each
// packed as a fragment register (v0 in the low half).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// grid (ceil(P / kMmaTileP), H, B); kMmaThreads threads;
// mma_smem_bytes<NP>() dynamic.  NP is N rounded up to 32, 64, 128 or 256.
// Up to N 64 two blocks fit an SM's shared memory, and the registers are
// capped so that two fit there too (zamba2-2.7b's 320 blocks: 0.3725 ms
// against 0.3999 uncapped, a few bytes of spill; H100, probe_ssd_scan.py).
// Warp w owns rows 16 (w % 4) .. +15 of the tile's stateᵀ and the half
// w / 4 of its N columns; the two warps of a row tile add their partial
// C·state over the halves through shared memory, each keeping half of the
// chunk's y columns.
template <int NP>
__global__ void __launch_bounds__(kMmaThreads, NP <= 64 ? 2 : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ bmat,
               const bf16* __restrict__ cmat, bf16* __restrict__ y,
               float* __restrict__ state_out, int seq, int heads,
               int head_dim, int groups, int n_state, Strides sx,
               Strides sdt, Strides sb, Strides sc) {
  using namespace bf16mma;
  constexpr int PN = NP + 8;   // row pitch of B and C
  constexpr int KN = NP / 16;  // k-steps over N
  constexpr int KH = NP / 32;  // k-steps over half of N
  constexpr int TH = NP / 16;  // 8-wide tiles of half of N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kChunk][kPitchP]
  bf16* bs = xs + kStages * kChunk * kPitchP;    // [kStages][kChunk][PN]
  bf16* cs = bs + kStages * kChunk * PN;         // [kStages][kChunk][PN]
  bf16* ms = cs + kStages * kChunk * PN;         // [kChunk][kPitchQ] M
  bf16* wx = ms + kChunk * kPitchQ;              // [2][kChunk][kPitchP]
  bf16* ys = wx + 2 * kChunk * kPitchP;          // [kChunk][kPitchP] y tile
  double* cum = reinterpret_cast<double*>(ys + kChunk * kPitchP);  // [kChunk]
  float* dts = reinterpret_cast<float*>(cum + kChunk);  // [kStages][kChunk]
  float* ecum = dts + kStages * kChunk;          // [kChunk] exp(cum)
  float* dec = ecum + kChunk;                    // [kChunk] exp(cum_last - cum)
  float* xch = dec + kChunk;                     // [kWarps][16][32] partial y

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pt = warp % 4, nh = warp / 4;
  const int p0 = blockIdx.x * kMmaTileP;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / (heads / groups);
  const int np = min(kMmaTileP, head_dim - p0);
  const float a = -expf(a_log[h]);
  const bf16* xb = x + bb * sx.b + h * sx.h + p0;
  const float* dtb = dt + bb * sdt.b + h * sdt.h;
  const bf16* bbase = bmat + bb * sb.b + g * sb.h;
  const bf16* cbase = cmat + bb * sc.b + g * sc.h;
  bf16* yb = y + (static_cast<long long>(bb) * seq * heads + h) * head_dim + p0;
  const long long sy = static_cast<long long>(heads) * head_dim;

  // Chunk rows [t0, t0 + kChunk) into a stage; rows past L and columns past
  // P (of x) or N (of B and C) are zero-filled.
  auto load_chunk = [&](int t0, int stage) {
    const int rows = seq - t0;
    load_tile_async<kMmaThreads>(xs + stage * kChunk * kPitchP,
                                 xb + t0 * sx.l, sx.l, kChunk, rows,
                                 kMmaTileP / 8, np, kPitchP);
    load_tile_async<kMmaThreads>(bs + stage * kChunk * PN, bbase + t0 * sb.l,
                                 sb.l, kChunk, rows, NP / 8, n_state, PN);
    load_tile_async<kMmaThreads>(cs + stage * kChunk * PN, cbase + t0 * sc.l,
                                 sc.l, kChunk, rows, NP / 8, n_state, PN);
    for (int i = tid; i < kChunk; i += kMmaThreads) {
      const bool ok = i < rows;
      cp_async_4(dts + stage * kChunk + i, ok ? dtb + (t0 + i) * sdt.l : dtb,
                 ok);
    }
  };

  // This warp's part of stateᵀ: P rows pw + gq and pw + gq + 8 of the tile,
  // N columns n0 + 8t + cq and n0 + 8t + cq + 1 of st[t].
  const int pw = pt * 16, n0 = nh * (NP / 2);
  const int gq = lane / 4, cq = (lane % 4) * 2;
  float st[TH][4];
#pragma unroll
  for (int t = 0; t < TH; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[t][e] = 0.0f;
  // ldmatrix row offsets: a row-major A tile and a trans-B tile take matrix
  // l / 8 as (rows +8 if odd, cols +8 if >= 2); a "col" B tile and a trans-A
  // tile as (rows +8 if >= 2, cols +8 if odd).
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  load_chunk(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int stage = k % kStages;
    const int t0 = k * kChunk;
    const int q = min(kChunk, seq - t0);
    cp_async_wait<0>();
    __syncthreads();
    bf16* xk = xs + stage * kChunk * kPitchP;
    const bf16* bk = bs + stage * kChunk * PN;
    const bf16* ck = cs + stage * kChunk * PN;
    const float* dk = dts + stage * kChunk;

    // 1. The running sum of dt · A over the chunk in fp64 (warp 0, two rows
    //    a lane), exp(cum) and the decays to the chunk's end.
    if (warp == 0) {
      const double d0 = dk[2 * lane] * a, d1 = dk[2 * lane + 1] * a;
      double incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      const double c0 = excl + d0, c1 = excl + d0 + d1;
      const double last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf(static_cast<float>(c0));
      ecum[2 * lane + 1] = expf(static_cast<float>(c1));
      dec[2 * lane] = expf(static_cast<float>(last - c0));
      dec[2 * lane + 1] = expf(static_cast<float>(last - c1));
    }
    // 2. S = C·Bᵀ for rows 16 pt .. +15 of the chunk and the column pairs
    //    jp = nh and nh + 2 (16 columns each; pairs above the diagonal are
    //    masked to 0 below, which costs less than branching around them).
    float s[4][4];
    const int rm = pt * 16;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, ck + (rm + a_row) * PN + kk * 16 + a_col);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t r[4];
        ldmatrix_x4(r, bk + ((nh + 2 * u) * 16 + b_row) * PN + kk * 16 +
                           b_col);
        mma_bf16(s[2 * u], af, r[0], r[1]);
        mma_bf16(s[2 * u + 1], af, r[2], r[3]);
      }
    }
    __syncthreads();  // cum, ecum, dec are ready
    // 3. M = S ∘ L rounded to bf16, into shared memory; xdt = x · dt rounded
    //    to bf16 in place, and xdt · decay as bf16 hi + lo.
    {
      // Every load before any store: the compiler cannot tell the shared
      // arrays apart, and would otherwise wait on each store.
      const double ci[2] = {cum[rm + gq], cum[rm + gq + 8]};
      double cj[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 8 * (2 * nh + 4 * (t / 2) + t % 2) + cq;
        cj[t][0] = cum[j];
        cj[t][1] = cum[j + 1];
      }
      uint32_t mv[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 8 * (2 * nh + 4 * (t / 2) + t % 2) + cq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = rm + gq + 8 * r;
          float m[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            m[c] = j + c <= i
                ? s[t][2 * r + c] * expf(static_cast<float>(ci[r] - cj[t][c]))
                : 0.0f;
          mv[t][r] = pack_bf16(m[0], m[1]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 8 * (2 * nh + 4 * (t / 2) + t % 2) + cq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(ms + (rm + gq + 8 * r) * kPitchQ + j) =
              mv[t][r];
      }
    }
    {
      constexpr int kIt = kChunk * kMmaTileP / 2 / kMmaThreads;
      __nv_bfloat162 xv[kIt];
      float dv[kIt], cv[kIt];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int e = tid + it * kMmaThreads, i = e / (kMmaTileP / 2);
        xv[it] = *reinterpret_cast<const __nv_bfloat162*>(
            xk + i * kPitchP + (e % (kMmaTileP / 2)) * 2);
        dv[it] = dk[i];
        cv[it] = dec[i];
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int e = tid + it * kMmaThreads;
        const int i = e / (kMmaTileP / 2), p = (e % (kMmaTileP / 2)) * 2;
        const float2 v = __bfloat1622float2(xv[it]);
        const float d = round_bf16(dv[it]);
        const float x0 = round_bf16(v.x * d), x1 = round_bf16(v.y * d);
        uint32_t hi, lo;
        split_bf16(x0 * cv[it], x1 * cv[it], hi, lo);
        *reinterpret_cast<__nv_bfloat162*>(xk + i * kPitchP + p) =
            __floats2bfloat162_rn(x0, x1);
        *reinterpret_cast<uint32_t*>(wx + i * kPitchP + p) = hi;
        *reinterpret_cast<uint32_t*>(wx + (kChunk + i) * kPitchP + p) = lo;
      }
    }
    // 4. This warp's part of stateᵀ·Cᵀ (its half of N, all 64 columns of
    //    the chunk), with the state split hi + lo (the state before this
    //    chunk's update).
    float yacc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(st[2 * kk][0], st[2 * kk][1], hi[0], lo[0]);
      split_bf16(st[2 * kk][2], st[2 * kk][3], hi[1], lo[1]);
      split_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int qp = 0; qp < 4; ++qp) {
        uint32_t r[4];
        ldmatrix_x4(r, ck + (qp * 16 + b_row) * PN + n0 + kk * 16 + b_col);
        mma_bf16(yacc[2 * qp], hi, r[0], r[1]);
        mma_bf16(yacc[2 * qp + 1], hi, r[2], r[3]);
        mma_bf16(yacc[2 * qp], lo, r[0], r[1]);
        mma_bf16(yacc[2 * qp + 1], lo, r[2], r[3]);
      }
    }
    // The partner warp (same rows, other half of N) keeps the other half
    // of the columns: hand it this warp's partial sums there.
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (t / 4 != nh)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xch[(warp * 16 + (t % 4) * 4 + e) * 32 + lane] = yacc[t][e];
    // The next chunk's loads, issued while this chunk's products run.
    if (k + 1 < n_chunks) load_chunk(t0 + kChunk, (k + 1) % kStages);
    cp_async_commit();
    __syncthreads();  // M, xdt, xdt · decay and the partial sums are ready
    // 5. yᵀ for this warp's 16 rows of P and its half of the columns:
    //    exp(cum_q) · (stateᵀ·Cᵀ) + xdtᵀ·Mᵀ.
    const int partner = warp ^ 4;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t / 4 == nh) {
        const float e0 = ecum[8 * t + cq], e1 = ecum[8 * t + cq + 1];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = yacc[t][e] + xch[(partner * 16 + (t % 4) * 4 + e) * 32 + lane];
        yacc[t][0] = v[0] * e0;
        yacc[t][1] = v[1] * e1;
        yacc[t][2] = v[2] * e0;
        yacc[t][3] = v[3] * e1;
      }
    }
    {
      uint32_t xa[4][4];  // xdtᵀ, rows of P, the 4 k-steps of the chunk
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk <= 2 * nh + 1)
          ldmatrix_x4_trans(xa[kk], xk + (kk * 16 + b_row) * kPitchP + pw +
                                        b_col);
#pragma unroll
      for (int qp = 0; qp < 4; ++qp) {
        if (qp / 2 == nh) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk <= qp) {  // M[q, j] = 0 for j > q
              uint32_t r[4];
              ldmatrix_x4(r, ms + (qp * 16 + b_row) * kPitchQ + kk * 16 +
                                 b_col);
              mma_bf16(yacc[2 * qp], xa[kk], r[0], r[1]);
              mma_bf16(yacc[2 * qp + 1], xa[kk], r[2], r[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t / 4 == nh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 8 * t + cq + (e % 2), p = pw + gq + 8 * (e / 2);
          ys[qq * kPitchP + p] = __float2bfloat16_rn(yacc[t][e]);
        }
      }
    }
    __syncwarp();
    // This warp's y: rows 32 nh .. +31 of the chunk, its 16 columns of P.
    {
      const int qq = 32 * nh + lane;
      if (qq < q) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (pw + 8 * c < np)
            *reinterpret_cast<uint4*>(yb + (t0 + qq) * sy + pw + 8 * c) =
                *reinterpret_cast<const uint4*>(ys + qq * kPitchP + pw +
                                                8 * c);
      }
    }
    // 6. stateᵀ = exp(cum_last) · stateᵀ + (xdt · decay)ᵀ · B over this
    //    warp's half of N, the first operand as hi + lo.
    const float keep = expf(static_cast<float>(cum[kChunk - 1]));
#pragma unroll
    for (int t = 0; t < TH; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= keep;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      ldmatrix_x4_trans(ah, wx + (kk * 16 + b_row) * kPitchP + pw + b_col);
      ldmatrix_x4_trans(al, wx + (kChunk + kk * 16 + b_row) * kPitchP + pw +
                                b_col);
#pragma unroll
      for (int np2 = 0; np2 < KH; ++np2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bk + (kk * 16 + a_row) * PN + n0 + np2 * 16 +
                                 a_col);
        mma_bf16(st[2 * np2], ah, r[0], r[1]);
        mma_bf16(st[2 * np2 + 1], ah, r[2], r[3]);
        mma_bf16(st[2 * np2], al, r[0], r[1]);
        mma_bf16(st[2 * np2 + 1], al, r[2], r[3]);
      }
    }
    __syncthreads();  // the y tile is complete; this stage is consumed
  }
  // The final state, (B, H, P, N) fp32, N fastest.
  float* so = state_out + (static_cast<long long>(bb) * heads + h) * head_dim *
                              n_state;
#pragma unroll
  for (int t = 0; t < TH; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pw + gq + 8 * (e / 2), n = n0 + 8 * t + cq + (e % 2);
      if (p < head_dim && n < n_state)
        so[static_cast<long long>(p) * n_state + n] = st[t][e];
    }
  }
}

template <int NP>
cudaError_t launch_mma(const bf16* x, const float* dt, const float* a_log,
                       const bf16* b, const bf16* c, bf16* y,
                       float* state_out, int batch, int seq, int heads,
                       int head_dim, int groups, int n_state, Strides sx,
                       Strides sdt, Strides sb, Strides sc,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<NP>();
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((head_dim + kMmaTileP - 1) / kMmaTileP, heads, batch);
  ssd_mma_kernel<NP><<<grid, kMmaThreads, smem, stream>>>(
      x, dt, a_log, b, c, y, state_out, seq, heads, head_dim, groups, n_state,
      sx, sdt, sb, sc);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.l % 8 == 0 && s.h % 8 == 0;
}

bool valid_shape(int batch, int heads, int groups, int n_state) {
  return groups > 0 && heads % groups == 0 && n_state > 0 &&
         n_state <= kMaxState && batch <= 65535 && heads <= 65535;
}

}  // namespace

// x (B, L, H, P) and b, c (B, L, G, N) with the given element strides for
// batch, position and head/group (the last dim contiguous); dt (B, L, H)
// fp32 with the given strides; a_log (H,) fp32 contiguous.  Writes y,
// contiguous (B, L, H, P) in x's type, and state_out, contiguous (B, H, P, N)
// fp32.  H % G == 0, 1 <= N <= 256, B <= 65535, H <= 65535.  Both entry
// points return the cudaError_t of the launch.
//
// float32 x, b, c and y: the scalar fp32 kernel.
extern "C" int ssd_scan_f32(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, void* y, void* state_out, int batch, int seq, int heads,
    int head_dim, int groups, int n_state, long long sx_b, long long sx_l,
    long long sx_h, long long sdt_b, long long sdt_l, long long sdt_h,
    long long sb_b, long long sb_l, long long sb_g, long long sc_b,
    long long sc_l, long long sc_g, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0) return 0;
  if (!valid_shape(batch, heads, groups, n_state))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_scalar(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(state_out), batch, seq, heads, head_dim, groups,
      n_state, Strides{sx_b, sx_l, sx_h}, Strides{sdt_b, sdt_l, sdt_h},
      Strides{sb_b, sb_l, sb_g}, Strides{sc_b, sc_l, sc_g},
      static_cast<cudaStream_t>(stream));
}

// bfloat16 x, b, c and y: the tensor-core kernel.  Also needs P and N
// multiples of 8 and x, b, c based at 16-byte aligned addresses with strides
// that are multiples of 8 elements.
extern "C" int ssd_scan_bf16(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, void* y, void* state_out, int batch, int seq, int heads,
    int head_dim, int groups, int n_state, long long sx_b, long long sx_l,
    long long sx_h, long long sdt_b, long long sdt_l, long long sdt_h,
    long long sb_b, long long sb_l, long long sb_g, long long sc_b,
    long long sc_l, long long sc_g, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0) return 0;
  const Strides sx{sx_b, sx_l, sx_h}, sdt{sdt_b, sdt_l, sdt_h},
      sb{sb_b, sb_l, sb_g}, sc{sc_b, sc_l, sc_g};
  if (!valid_shape(batch, heads, groups, n_state) || head_dim % 8 != 0 ||
      n_state % 8 != 0 || !aligned16(x, sx) || !aligned16(b, sb) ||
      !aligned16(c, sc) || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(a_log);
  const auto* bp = static_cast<const bf16*>(b);
  const auto* cp = static_cast<const bf16*>(c);
  auto* yp = static_cast<bf16*>(y);
  auto* so = static_cast<float*>(state_out);
  auto s = static_cast<cudaStream_t>(stream);
#define SSD_MMA(NP)                                                          \
  return launch_mma<NP>(xp, dtp, ap, bp, cp, yp, so, batch, seq, heads,      \
                        head_dim, groups, n_state, sx, sdt, sb, sc, s)
  if (n_state <= 32) SSD_MMA(32);
  if (n_state <= 64) SSD_MMA(64);
  if (n_state <= 128) SSD_MMA(128);
  SSD_MMA(256);
#undef SSD_MMA
}

