// Embedding bag for Hopper (sm_90a): for each bag of each table, the sum of
// the table rows named by its indices, with optional per-lookup fp32
// weights.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag.py::embedding_bag
// (a Pallas kernel whose grid walks (bag, lookup) in order, fetching one row
// per step through scalar-prefetched indices and accumulating in the output
// block).  Here there is no sequential grid: one thread block per (bag,
// table), each thread owning a VEC-wide column slice of D, walking the bag's
// lookups in order j = 0 .. bag-1 with the running sum in fp32 registers,
// and writing the result once in the table's type.  The block stages its
// own indices (and weights) in shared memory, which takes the place of the
// TPU's scalar prefetch.  Duplicate indices count again.
//
// One launch serves every table of a model: tables (T, V, D), indices and
// weights (n_bags, T, bag) in the model's own layout (MT-WND's categorical
// input), output (n_bags, T·D), the slab its forward concatenates after the
// dense features.  The reference's single-table call is the T = 1 case.
//
// Bound: memory.  The work is one row gather per lookup plus one output row
// per bag (index bytes + row bytes + output bytes), with one add (two ops
// weighted) per loaded element.  At the live serving path's shapes (n_bags
// <= 32, T 8, bag 8, D 64) the bytes are a few hundred KB and the launch
// cost dominates: hence one launch for all tables, not one per table.
//
// Arithmetic: products and sums are rounded separately (__fmul_rn,
// __fadd_rn, no fused multiply-add), so the kernel matches the plain PyTorch
// version in repro_torch/kernels/ref.py bit for bit in fp32 and bf16.
//
// Indices outside [0, V) are taken as the reference takes them: a negative
// one wraps once (i + V), then each is clamped to [0, V - 1] as it is
// staged, one integer min and max a lookup.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kIdxChunk = 256;  // lookups staged in shared memory at a time

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

__device__ __forceinline__ float accumulate(float acc, float x, float w,
                                            bool weighted) {
  return weighted ? __fadd_rn(acc, __fmul_rn(x, w)) : __fadd_rn(acc, x);
}

// grid (n_bags, T, ceil(d / (VEC * blockDim.x))); block <= kMaxThreads
// threads.  Block (b, t) pools bag b of table t: indices and weights at
// (b · T + t) · bag, output at (b · T + t) · d.
template <typename T, int VEC, bool WEIGHTED>
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_kernel(const int32_t* __restrict__ indices,
                     const T* __restrict__ tables,
                     const float* __restrict__ weights, T* __restrict__ out,
                     int bag, int vocab, int d) {
  __shared__ int32_t s_idx[kIdxChunk];
  __shared__ float s_w[kIdxChunk];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * gridDim.y + blockIdx.y;
  const T* table = tables + static_cast<int64_t>(blockIdx.y) * vocab * d;
  const int col = (blockIdx.z * blockDim.x + threadIdx.x) * VEC;
  const bool active = col < d;
  const int32_t* bag_idx = indices + b * bag;
  float acc0 = 0.0f, acc1 = 0.0f;

  for (int j0 = 0; j0 < bag; j0 += kIdxChunk) {
    const int n = min(kIdxChunk, bag - j0);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int32_t i = bag_idx[j0 + t];
      s_idx[t] = min(max(i < 0 ? i + vocab : i, 0), vocab - 1);
      if constexpr (WEIGHTED) s_w[t] = weights[b * bag + j0 + t];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const T* row = table + static_cast<int64_t>(s_idx[j]) * d + col;
        const float w = WEIGHTED ? s_w[j] : 1.0f;
        if constexpr (VEC == 2) {
          const float2 x = load2(row);
          acc0 = accumulate(acc0, x.x, w, WEIGHTED);
          acc1 = accumulate(acc1, x.y, w, WEIGHTED);
        } else {
          acc0 = accumulate(acc0, load1(row), w, WEIGHTED);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    T* dst = out + b * d + col;
    if constexpr (VEC == 2) {
      store2(dst, acc0, acc1);
    } else {
      store1(dst, acc0);
    }
  }
}

template <typename T>
cudaError_t launch(const int32_t* indices, const T* tables,
                   const float* weights, T* out, int n_bags, int n_tables,
                   int bag, int vocab, int d, cudaStream_t stream) {
  // Two columns a thread when every row start is aligned for it.
  const bool vec2 = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(tables) % (2 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const int vec = vec2 ? 2 : 1;
  const int lanes = (d + vec - 1) / vec;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(n_bags, n_tables, (lanes + threads - 1) / threads);
  const bool weighted = weights != nullptr;
  if (vec2 && weighted) {
    embedding_bag_kernel<T, 2, true><<<grid, threads, 0, stream>>>(
        indices, tables, weights, out, bag, vocab, d);
  } else if (vec2) {
    embedding_bag_kernel<T, 2, false><<<grid, threads, 0, stream>>>(
        indices, tables, weights, out, bag, vocab, d);
  } else if (weighted) {
    embedding_bag_kernel<T, 1, true><<<grid, threads, 0, stream>>>(
        indices, tables, weights, out, bag, vocab, d);
  } else {
    embedding_bag_kernel<T, 1, false><<<grid, threads, 0, stream>>>(
        indices, tables, weights, out, bag, vocab, d);
  }
  return cudaGetLastError();
}

}  // namespace

// indices (n_bags, T, bag) int32, tables (T, V, D), weights (n_bags, T, bag)
// fp32 or null, out (n_bags, T, D), all contiguous.  n_bags <= 2^31 - 1,
// 1 <= T <= 65535.  dtype: 0 = float32 tables and output, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int embedding_bag_forward(const void* indices, const void* tables,
                                     const void* weights, void* out,
                                     int n_bags, int n_tables, int bag,
                                     int vocab, int d, int dtype,
                                     void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  if (n_tables <= 0 || n_tables > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* w = static_cast<const float*>(weights);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(idx, static_cast<const float*>(tables), w,
                  static_cast<float*>(out), n_bags, n_tables, bag, vocab, d,
                  s);
  }
  if (dtype == 1) {
    return launch(idx, static_cast<const __nv_bfloat16*>(tables), w,
                  static_cast<__nv_bfloat16*>(out), n_bags, n_tables, bag,
                  vocab, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
