// FCFS dispatch scan for Hopper (sm_90a): RIBBON's pool simulator.
//
// Replaces no TPU kernel: in the reference this loop is XLA's lax.scan,
// src/repro/serving/simulator.py::_simulate_scan (batch, grid and
// stacked-table vmaps) and its fused QoS counter _grid_lane_qos_counts.
// Each lane (workload row w, slot layout b) serves the query stream in
// arrival order; query q goes to the first idle slot in priority order, or
// else to the slot that frees first:
//
//   key[s] = free[s] <= a ? priority[s] - big : free[s]
//   s*     = first index of min(key)
//   start  = max(a, free[s*]);  finish = start + service[type[s*], q]
//   free[s*] = finish;  latency = finish - a;  count += latency <= qos_t
//
// Design: one warp per lane.  Lane thread l keeps slots l, l + 32, ... of
// the carry (next-free times, idle keys, slot types) in registers.  Each
// step takes a thread-local first minimum, then a 5-round butterfly of
// shuffles on (key, slot index) ordered lexicographically, which is the
// first-index tie rule of jnp.argmin; the thread that owns the winning slot
// updates its register, counts the query and writes its latency and start
// time when asked.  The warps of a block serve configs of one workload row
// and share its arrivals and its (n_types, chunk) service tile, staged in
// shared memory by coalesced loads chunk by chunk.  Each thread reads the
// service time of its local candidate before the shuffles, so the owner's
// update waits on no memory.
//
// Bound: the serial chain.  The bytes are a few hundred KB at the search
// path's shapes (arrivals, service table, latencies when asked), under a
// microsecond at the card's memory rate; the steps of a lane are
// dependent, nq of them, each a shuffle reduction of 5 dependent rounds.
// The lanes run in parallel, one warp each.
//
// Arithmetic: every step is one IEEE compare, max, add or subtract in
// float32 (__fadd_rn, __fsub_rn: nothing to contract), so the kernel
// matches the plain version in repro_torch/kernels/ref.py, and the
// reference, bit for bit.  Type indices are clamped to [0, n_types), as
// jnp's gather clamps.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // lanes (slot layouts) per block
constexpr int kChunk = 256;   // queries staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float k1, int i1, float k2, int i2) {
  return k1 < k2 || (k1 == k2 && i1 < i2);
}

// grid (ceil(n_b / kWarps), n_w); block kWarps * 32 threads; dynamic shared
// memory (1 + n_types) * kChunk floats.  K = slots per thread, the least
// power of two >= ceil(n_s / 32).
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
fcfs_scan_kernel(const float* __restrict__ arrivals,
                 const float* __restrict__ service, int service_rows,
                 const int32_t* __restrict__ type_of_slot,
                 const float* __restrict__ priority,
                 const float* __restrict__ free0, int n_b, int n_s,
                 int n_types, int nq, float big, float qos_t,
                 int32_t* __restrict__ counts, float* __restrict__ lat,
                 float* __restrict__ start_out, float* __restrict__ free_out) {
  extern __shared__ float smem[];
  float* s_arr = smem;
  float* s_svc = smem + kChunk;
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = b < n_b;

  float fr[K], key_idle[K];
  int ty[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (live && s < n_s) {
      fr[k] = free0[static_cast<int64_t>(b) * n_s + s];
      key_idle[k] = priority[s] - big;
      ty[k] = min(max(type_of_slot[static_cast<int64_t>(b) * n_s + s], 0),
                  n_types - 1);
    } else {  // padding: never idle, keyed +inf, never owns the minimum
      fr[k] = INFINITY;
      key_idle[k] = INFINITY;
      ty[k] = 0;
    }
  }

  const float* arr_row = arrivals + static_cast<int64_t>(w) * nq;
  const float* svc_row =
      service + (service_rows == 1 ? 0 : static_cast<int64_t>(w)) * n_types * nq;
  const int64_t out_row = (static_cast<int64_t>(w) * n_b + b) * nq;
  int count = 0;

  for (int q0 = 0; q0 < nq; q0 += kChunk) {
    const int n = min(kChunk, nq - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_arr[i] = arr_row[q0 + i];
    for (int t = 0; t < n_types; ++t) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_svc[t * kChunk + i] = svc_row[static_cast<int64_t>(t) * nq + q0 + i];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int qq = 0; qq < n; ++qq) {
      const float a = s_arr[qq];
      // Thread-local first minimum, slots in increasing index order.
      float best = INFINITY, best_free = INFINITY;
      int best_slot = INT32_MAX, best_type = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float key = fr[k] <= a ? key_idle[k] : fr[k];
        const int s = k * 32 + lane;
        if (before(key, s, best, best_slot)) {
          best = key;
          best_slot = s;
          best_free = fr[k];
          best_type = ty[k];
        }
      }
      const float svc = s_svc[best_type * kChunk + qq];
      // Warp-wide first minimum: every lane ends with the same winner.
      float win = best;
      int win_slot = best_slot;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float other = __shfl_xor_sync(kFull, win, off);
        const int other_slot = __shfl_xor_sync(kFull, win_slot, off);
        if (before(other, other_slot, win, win_slot)) {
          win = other;
          win_slot = other_slot;
        }
      }
      if (win_slot == best_slot) {  // this thread owns the winning slot
        const float start = fmaxf(a, best_free);
        const float finish = __fadd_rn(start, svc);
        const int kk = win_slot >> 5;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == kk) fr[k] = finish;
        }
        const float l = __fsub_rn(finish, a);
        count += l <= qos_t;
        if (lat != nullptr) lat[out_row + q0 + qq] = l;
        if (start_out != nullptr) start_out[out_row + q0 + qq] = start;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  if (lane == 0) counts[static_cast<int64_t>(w) * n_b + b] = count;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (s < n_s) free_out[(static_cast<int64_t>(w) * n_b + b) * n_s + s] = fr[k];
  }
}

template <int K>
cudaError_t launch(const float* arrivals, const float* service,
                   int service_rows, const int32_t* type_of_slot,
                   const float* priority, const float* free0, int n_w,
                   int n_b, int n_s, int n_types, int nq, float big,
                   float qos_t, int32_t* counts, float* lat, float* start,
                   float* free_out, cudaStream_t stream) {
  const dim3 grid((n_b + kWarps - 1) / kWarps, n_w);
  const size_t smem = sizeof(float) * (1 + n_types) * kChunk;
  fcfs_scan_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      arrivals, service, service_rows, type_of_slot, priority, free0, n_b,
      n_s, n_types, nq, big, qos_t, counts, lat, start, free_out);
  return cudaGetLastError();
}

}  // namespace

// arrivals (n_w, nq) f32; service (service_rows, n_types, nq) f32 with
// service_rows 1 (shared) or n_w; type_of_slot (n_b, n_s) i32; priority
// (n_s,) f32; free0 (n_b, n_s) f32; outputs counts (n_w, n_b) i32, lat and
// start (n_w, n_b, nq) f32 or null, free_out (n_w, n_b, n_s) f32; all
// contiguous.  1 <= n_s <= 1024, 1 <= n_types <= 32, n_w <= 65535.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fcfs_scan_forward(const void* arrivals, const void* service,
                                 int service_rows, const void* type_of_slot,
                                 const void* priority, const void* free0,
                                 int n_w, int n_b, int n_s, int n_types,
                                 int nq, float big, float qos_t, void* counts,
                                 void* lat, void* start, void* free_out,
                                 void* stream) {
  if (n_w <= 0 || n_b <= 0) return 0;
  if (n_s < 1 || n_s > 1024 || n_types < 1 || n_types > 32 || n_w > 65535 ||
      nq < 0 || (service_rows != 1 && service_rows != n_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* arr = static_cast<const float*>(arrivals);
  const auto* svc = static_cast<const float*>(service);
  const auto* tos = static_cast<const int32_t*>(type_of_slot);
  const auto* prio = static_cast<const float*>(priority);
  const auto* fr0 = static_cast<const float*>(free0);
  auto* cnt = static_cast<int32_t*>(counts);
  auto* l = static_cast<float*>(lat);
  auto* st = static_cast<float*>(start);
  auto* fo = static_cast<float*>(free_out);
  auto s = static_cast<cudaStream_t>(stream);
  const int per_thread = (n_s + 31) / 32;
#define FCFS_LAUNCH(K)                                                       \
  return static_cast<int>(launch<K>(arr, svc, service_rows, tos, prio, fr0, \
                                    n_w, n_b, n_s, n_types, nq, big, qos_t, \
                                    cnt, l, st, fo, s))
  if (per_thread <= 1) FCFS_LAUNCH(1);
  if (per_thread <= 2) FCFS_LAUNCH(2);
  if (per_thread <= 4) FCFS_LAUNCH(4);
  if (per_thread <= 8) FCFS_LAUNCH(8);
  if (per_thread <= 16) FCFS_LAUNCH(16);
  FCFS_LAUNCH(32);
#undef FCFS_LAUNCH
}
