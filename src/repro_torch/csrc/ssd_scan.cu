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
// here one thread block owns one (batch, head, 32-column tile of P) and loops
// over the chunks itself, the fp32 state tile in shared memory: the state
// never reaches device memory until the final state is written, directly in
// (B, H, P, N).  Each chunk computes what the TPU kernel's body computes:
//
//     cum     = cumsum(dt · A)                      (the chunk's log decays)
//     M[i,j]  = (C_i · B_j) · exp(cum_i - cum_j)    for j <= i, else 0
//     y_i     = Σ_j M[i,j] xdt_j + exp(cum_i) · (C_i · state)
//     state   = exp(cum_last) · state + Σ_i exp(cum_last - cum_i) B_i ⊗ xdt_i
//
// The columns of P are independent (y[:, p] needs state[:, p] only), so the
// P tiles of one head run in separate blocks that each recompute C·Bᵀ: that
// gives B·H·P/32 blocks (192 for mamba2-130m at batch 4) for 132 SMs.  The
// chunk is the kernel's own 64 rows, not the model's ssm_chunk: the result
// is the same function, differing only in rounding, and a 64 x 64 score tile
// fits beside the state.  Any L is taken: the ragged last chunk's rows are
// zero (dt · A = 0, B = C = xdt = 0), so they add nothing and decay nothing.
//
// Inputs are read in the model's layouts through their strides: x (B, L, H,
// P), B and C (B, L, G, N) with the last dim contiguous (views into the conv
// output), dt (B, L, H) fp32 after softplus, a_log (H,) fp32.  Head h reads
// group h / (H / G); nothing is repeated, transposed or pre-scaled.  The
// dt scaling and the discretisation happen here, with the TPU path's
// roundings: xdt = x · dt rounded to x's type (dt itself rounded to x's type
// first), dt · A in fp32, (C·Bᵀ ∘ L) rounded to x's type before the product
// with xdt, y_diag, y_off and the state in fp32, y cast once to x's type.
// One place differs: the running sum cum is kept in fp64, and the in-chunk
// decays exp(cum_i - cum_j) and exp(cum_last - cum_i) come from fp64
// differences.  In fp32 (as the TPU kernel) |cum| reaches hundreds within a
// chunk and each difference loses that many ulps of its exponent: with fp32
// sums mamba2-130m's fp32 logits at full width (B 4, L 2048) lay 1.1e-4 of
// their maximum from the reference model's own scan after 4 decode steps,
// with fp64 sums at most 1.8e-5 over 48 steps (chip_smoke.py, H100).
//
// Bound: bytes.  At mamba2-130m's prefill (B 4, L 2048, H 24, P 64, N 128,
// bf16) the scan moves 58 MB (x and y 25 MB each) and needs 9 GFLOP at the
// kernel's chunk: 150 flops a byte, under the H100's ~295 for bf16 on the
// tensor cores.  This first kernel computes with scalar fp32 FMAs from
// shared memory (each thread a 4 x 4 tile of C·Bᵀ, 8 rows of y, N/8 entries
// of the state tile), so it runs far from that bound; tensor-core products
// (mma.sync / wgmma) and TMA loads are later work.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;      // rows of a chunk (the kernel's own)
constexpr int kTileP = 32;      // columns of P per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = kThreads / kTileP;   // 8 row groups in the y/state phases
constexpr int kMaxState = 256;  // largest N the shared memory takes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to T's precision, as a float.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Strides {
  long long b, l, h;  // elements; the last dim is contiguous
};

__host__ __device__ constexpr size_t smem_floats(int n) {
  return static_cast<size_t>(n) * kTileP          // state tile [N][kTileP]
         + 2 * static_cast<size_t>(kChunk) * (n + 1)  // C, B [kChunk][N + 1]
         + kChunk * kTileP                        // xdt [kChunk][kTileP]
         + kChunk * (kChunk + 1)                  // M [kChunk][kChunk + 1]
         + 2 * kChunk                             // cum (fp64)
         + 2 * kChunk;                            // decay to end, dt
}

// grid (ceil(P / kTileP), H, B); kThreads threads; smem_floats(N) dynamic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bmat,
           const T* __restrict__ cmat, T* __restrict__ y,
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
  float* dtr = dec + kChunk;                   // [kChunk] dt rounded to T

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = h / (heads / groups);
  const int np = min(kTileP, head_dim - p0);
  const float a = -expf(a_log[h]);
  const T* xb = x + bb * sx.b + h * sx.h + p0;
  const float* dtb = dt + bb * sdt.b + h * sdt.h;
  const T* bbase = bmat + bb * sb.b + g * sb.h;
  const T* cbase = cmat + bb * sc.b + g * sc.h;
  T* yb = y + (static_cast<long long>(bb) * seq * heads + h) * head_dim + p0;
  const long long sy = static_cast<long long>(heads) * head_dim;

  for (int i = tid; i < n_state * kTileP; i += kThreads) st[i] = 0.f;

  const int pc = tid % kTileP;   // this thread's column in the y/state phases
  const int rg = tid / kTileP;   // its row group (one per warp)
  const int tx = tid % 16, ty = tid / 16;   // its 4 x 4 tile of C·Bᵀ

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int q = min(kChunk, seq - t0);
    // 1. Load the chunk: dt · A and rounded dt per row, C and B as fp32.
    if (tid < kChunk) {
      float da = 0.f, d = 0.f;
      if (tid < q) {
        const float raw = dtb[(t0 + tid) * sdt.l];
        d = round_to(raw, T{});
        da = raw * a;
      }
      cum[tid] = da;
      dtr[tid] = d;
    }
    for (int e = tid; e < kChunk * n_state; e += kThreads) {
      const int i = e / n_state, n = e % n_state;
      float bv = 0.f, cv = 0.f;
      if (i < q) {
        bv = to_float(bbase[(t0 + i) * sb.l + n]);
        cv = to_float(cbase[(t0 + i) * sc.l + n]);
      }
      bs[i * ns + n] = bv;
      cs[i * ns + n] = cv;
    }
    __syncthreads();
    // 2. The running sum of dt · A over the chunk in fp64 (warp 0, two rows
    //    a lane), and xdt = x · dt rounded to T.
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
      if (i < q && p < np)
        v = round_to(to_float(xb[(t0 + i) * sx.l + p]) * dtr[i], T{});
      xs[e] = v;
    }
    __syncthreads();
    const double cum_last = cum[kChunk - 1];
    if (tid < kChunk) dec[tid] = expf(static_cast<float>(cum_last - cum[tid]));
    // 3. M = (C·Bᵀ ∘ L) rounded to T: rows ty + 16a, columns tx + 16c.
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
              ? round_to(acc[r][c] * expf(static_cast<float>(cum[i] - cum[j])),
                         T{})
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
          store(yb + (t0 + i) * sy + pc,
                yd[r] + yo[r] * expf(static_cast<float>(cum[i])));
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

template <typename T>
cudaError_t launch(const T* x, const float* dt, const float* a_log,
                   const T* b, const T* c, T* y, float* state_out, int batch,
                   int seq, int heads, int head_dim, int groups, int n_state,
                   Strides sx, Strides sdt, Strides sb, Strides sc,
                   cudaStream_t stream) {
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxState) * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((head_dim + kTileP - 1) / kTileP, heads, batch);
  const size_t smem = smem_floats(n_state) * sizeof(float);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, dt, a_log, b, c, y, state_out, seq, heads, head_dim, groups, n_state,
      sx, sdt, sb, sc);
  return cudaGetLastError();
}

}  // namespace

// x (B, L, H, P) and b, c (B, L, G, N) with the given element strides for
// batch, position and head/group (the last dim contiguous); dt (B, L, H)
// fp32 with the given strides; a_log (H,) fp32 contiguous.  Writes y,
// contiguous (B, L, H, P) in x's type, and state_out, contiguous (B, H, P, N)
// fp32.  H % G == 0, 1 <= N <= 256, B <= 65535, H <= 65535.  dtype: 0 =
// float32, 1 = bfloat16 for x, b, c and y.  Returns the cudaError_t of the
// launch.
extern "C" int ssd_scan_forward(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, void* y, void* state_out, int batch, int seq, int heads,
    int head_dim, int groups, int n_state, long long sx_b, long long sx_l,
    long long sx_h, long long sdt_b, long long sdt_l, long long sdt_h,
    long long sb_b, long long sb_l, long long sb_g, long long sc_b,
    long long sc_l, long long sc_g, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0) return 0;
  if (groups <= 0 || heads % groups != 0 || n_state <= 0 ||
      n_state > kMaxState || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{sx_b, sx_l, sx_h}, sdt{sdt_b, sdt_l, sdt_h},
      sb{sb_b, sb_l, sb_g}, sc{sc_b, sc_l, sc_g};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(a_log);
  auto* so = static_cast<float*>(state_out);
  if (dtype == 0) {
    return launch(static_cast<const float*>(x), dtp, ap,
                  static_cast<const float*>(b), static_cast<const float*>(c),
                  static_cast<float*>(y), so, batch, seq, heads, head_dim,
                  groups, n_state, sx, sdt, sb, sc, s);
  }
  if (dtype == 1) {
    return launch(static_cast<const __nv_bfloat16*>(x), dtp, ap,
                  static_cast<const __nv_bfloat16*>(b),
                  static_cast<const __nv_bfloat16*>(c),
                  static_cast<__nv_bfloat16*>(y), so, batch, seq, heads,
                  head_dim, groups, n_state, sx, sdt, sb, sc, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
