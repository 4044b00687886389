// FCFS dispatch scan for Hopper (sm_90a): RIBBON's pool simulator.
//
// Replaces no TPU kernel: in the reference this loop is XLA's lax.scan,
// src/repro/serving/simulator.py::_simulate_scan (batch, grid and
// stacked-table vmaps), its fused QoS counter _grid_lane_qos_counts, the
// routed scans _simulate_scan_policy / _grid_lane_qos_counts_policy and the
// in-carry telemetry counters _grid_lane_qos_counts_tel / ..._policy_tel.
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
// Flavours, each a template flag, so the cold scan (all off) compiles to
// the code it had before they existed:
//
// POLICY (routing): every thread reads the query's service time on each
//   of its K slots from the shared tile; an idle slot is keyed
//   fma(affinity, svc, pref) * TIE + priority, a busy one
//   fma(hedge, svc, free).  The reference takes the first minimum of the
//   idle keys if any slot is idle, else of the busy keys; the butterfly
//   runs on (busy, key, slot) in lexicographic order, which is the same
//   pick while idle keys stay below the reference's 1e30.  The busy flag
//   rides above the slot index in one int, so a round still shuffles two
//   words.
// TEL (telemetry counters): each step counts the idle slots (one
//   __reduce_add_sync), the owner's start, service time and type are
//   broadcast, and every thread derives the latency and the wait; the two
//   histogram buckets are a __popc of a __ballot_sync of lane l's test
//   against edge l; lane t keeps type t's counters and lane k bucket k's,
//   in registers, so nothing is shared and nothing is atomic.
// TRACE: the owner writes the winning slot of each query.
//
// Arithmetic: every step is one IEEE compare, max, add, subtract or (the
// routed keys, as XLA fuses them) fused multiply-add in float32
// (__fadd_rn, __fsub_rn, __fmul_rn, __fmaf_rn: nothing left to contract),
// so the kernel matches the plain version in repro_torch/kernels/ref.py,
// and the reference, bit for bit.  Busy milliseconds round half to even
// (__float2int_rn), as jnp.round.  Type indices are clamped to
// [0, n_types), as jnp's gather clamps.
//
// Plain C interface, loaded from Python with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // lanes (slot layouts) per block
constexpr int kChunk = 256;   // queries staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTie = 65536.0f;   // the reference's _TIE
constexpr int kBuckets = 32;       // telemetry histogram buckets
constexpr int kEdge0Bits = 0x38d1b717;  // float32 bits of 1e-4, edge 0
constexpr int kBusyBit = 1 << 16;  // routed order: the busy flag above the slot

struct ScanArgs {
  const float* arrivals;      // (n_w, nq)
  const float* service;       // (service_rows, n_types, nq)
  int service_rows;
  const int32_t* type_of_slot;  // (n_b, n_s)
  const float* priority;      // (n_s,)
  const float* free0;         // (free0_rows, n_b, n_s)
  int free0_rows;
  int n_b, n_s, n_types, nq;
  float big, qos_t;
  const float* pref_slot;     // POLICY: (n_b, n_s)
  const float* affinity;      // POLICY: (n_b,)
  const float* hedge;         // POLICY: (n_b,)
  const int32_t* n_active;    // TEL: (n_b,)
  int32_t* counts;            // (n_w, n_b)
  float* lat;                 // (n_w, n_b, nq) or null
  float* start;               // (n_w, n_b, nq) or null
  float* free_out;            // (n_w, n_b, n_s)
  int32_t* slot_out;          // TRACE: (n_w, n_b, nq)
  int32_t* tel;               // TEL: (n_w, n_b, 3 n_types + 2 kBuckets + 2)
};

__device__ __forceinline__ bool before(float k1, int i1, float k2, int i2) {
  return k1 < k2 || (k1 == k2 && i1 < i2);
}

// Routed order on (busy, key, slot): tags hold busy * kBusyBit + slot.
__device__ __forceinline__ bool before_tagged(float k1, int t1, float k2,
                                              int t2) {
  const int b1 = t1 >> 16, b2 = t2 >> 16;
  return b1 < b2 || (b1 == b2 && before(k1, t1, k2, t2));
}

// grid (ceil(n_b / kWarps), n_w); block kWarps * 32 threads; dynamic shared
// memory (1 + n_types) * kChunk floats.  K = slots per thread, the least
// power of two >= ceil(n_s / 32).
template <int K, bool POLICY, bool TEL, bool TRACE>
__global__ void __launch_bounds__(kWarps * 32)
fcfs_scan_kernel(const ScanArgs p) {
  extern __shared__ float smem[];
  float* s_arr = smem;
  float* s_svc = smem + kChunk;
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_b = p.n_b, n_s = p.n_s, n_types = p.n_types, nq = p.nq;
  const bool live = b < n_b;

  // key_idle: priority - big (cold), or priority (POLICY, where the idle
  // key is built per query).
  float fr[K], key_idle[K], pref[K];
  int ty[K];
  const int64_t carry_row =
      (p.free0_rows == 1 ? 0 : static_cast<int64_t>(w) * n_b) + b;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (live && s < n_s) {
      fr[k] = p.free0[carry_row * n_s + s];
      key_idle[k] = POLICY ? p.priority[s] : p.priority[s] - p.big;
      ty[k] = min(max(p.type_of_slot[static_cast<int64_t>(b) * n_s + s], 0),
                  n_types - 1);
      pref[k] = POLICY ? p.pref_slot[static_cast<int64_t>(b) * n_s + s] : 0.f;
    } else {  // padding: never idle, keyed +inf, never owns the minimum
      fr[k] = INFINITY;
      key_idle[k] = INFINITY;
      ty[k] = 0;
      pref[k] = 0.f;
    }
  }
  float aff = 0.f, hed = 0.f;
  if (POLICY && live) {
    aff = p.affinity[b];
    hed = p.hedge[b];
  }
  // TEL: lane t keeps type t's counters, lane k bucket k's and edge k.
  const int n_act = TEL && live ? p.n_active[b] : 0;
  const float edge = __int_as_float(kEdge0Bits + (min(lane, 30) << 23));
  int c_served = 0, c_miss = 0, c_busy = 0, c_lat = 0, c_wait = 0;
  int d_sum = 0, d_peak = 0;

  const float* arr_row = p.arrivals + static_cast<int64_t>(w) * nq;
  const float* svc_row =
      p.service +
      (p.service_rows == 1 ? 0 : static_cast<int64_t>(w)) * n_types * nq;
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
      float best = INFINITY, best_free = INFINITY, best_svc = 0.f;
      int best_slot = INT32_MAX, best_type = 0;
      int n_idle = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = k * 32 + lane;
        const bool idle = fr[k] <= a;
        if (TEL) n_idle += idle;
        if constexpr (POLICY) {
          const float sv = s_svc[ty[k] * kChunk + qq];
          const float key =
              idle ? __fadd_rn(__fmul_rn(__fmaf_rn(aff, sv, pref[k]), kTie),
                               key_idle[k])
                   : __fmaf_rn(hed, sv, fr[k]);
          const int tag = (idle ? 0 : kBusyBit) | s;
          if (before_tagged(key, tag, best, best_slot)) {
            best = key;
            best_slot = tag;
            best_free = fr[k];
            best_type = ty[k];
            best_svc = sv;
          }
        } else {
          const float key = idle ? key_idle[k] : fr[k];
          if (before(key, s, best, best_slot)) {
            best = key;
            best_slot = s;
            best_free = fr[k];
            best_type = ty[k];
          }
        }
      }
      const float svc = POLICY ? best_svc : s_svc[best_type * kChunk + qq];
      // Warp-wide first minimum: every lane ends with the same winner.
      float win = best;
      int win_slot = best_slot;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float other = __shfl_xor_sync(kFull, win, off);
        const int other_slot = __shfl_xor_sync(kFull, win_slot, off);
        if (POLICY ? before_tagged(other, other_slot, win, win_slot)
                   : before(other, other_slot, win, win_slot)) {
          win = other;
          win_slot = other_slot;
        }
      }
      if constexpr (TEL) {
        const int depth = n_act - __reduce_add_sync(kFull, n_idle);
        d_sum += depth;
        d_peak = max(d_peak, depth);
        const int owner = win_slot & 31;
        const float st = __shfl_sync(kFull, fmaxf(a, best_free), owner);
        const float sv = __shfl_sync(kFull, svc, owner);
        const int t = __shfl_sync(kFull, best_type, owner);
        const float l = __fsub_rn(__fadd_rn(st, sv), a);
        const float wait = fmaxf(__fsub_rn(st, a), 0.f);
        const int lb = __popc(__ballot_sync(kFull, lane < 31 && l >= edge));
        const int wb = __popc(__ballot_sync(kFull, lane < 31 && wait >= edge));
        c_lat += lane == lb;
        c_wait += lane == wb;
        if (lane == t) {
          ++c_served;
          c_miss += l > p.qos_t;
          c_busy += __float2int_rn(__fmul_rn(sv, 1000.f));
        }
      }
      if (win_slot == best_slot) {  // this thread owns the winning slot
        const float start = fmaxf(a, best_free);
        const float finish = __fadd_rn(start, svc);
        const int slot = POLICY ? (win_slot & (kBusyBit - 1)) : win_slot;
        const int kk = slot >> 5;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == kk) fr[k] = finish;
        }
        const float l = __fsub_rn(finish, a);
        count += l <= p.qos_t;
        if (p.lat != nullptr) p.lat[out_row + q0 + qq] = l;
        if (p.start != nullptr) p.start[out_row + q0 + qq] = start;
        if (TRACE) p.slot_out[out_row + q0 + qq] = slot;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFull, count, off);
  const int64_t lane_row = static_cast<int64_t>(w) * n_b + b;
  if (lane == 0) p.counts[lane_row] = count;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (s < n_s) p.free_out[lane_row * n_s + s] = fr[k];
  }
  if constexpr (TEL) {
    int32_t* row = p.tel + lane_row * (3 * n_types + 2 * kBuckets + 2);
    if (lane < n_types) {
      row[lane] = c_served;
      row[n_types + lane] = c_miss;
      row[2 * n_types + lane] = c_busy;
    }
    row[3 * n_types + lane] = c_lat;
    row[3 * n_types + kBuckets + lane] = c_wait;
    if (lane == 0) {
      row[3 * n_types + 2 * kBuckets] = d_sum;
      row[3 * n_types + 2 * kBuckets + 1] = d_peak;
    }
  }
}

template <int K, bool POLICY, bool TEL, bool TRACE>
cudaError_t launch(const ScanArgs& args, int n_w, cudaStream_t stream) {
  const dim3 grid((args.n_b + kWarps - 1) / kWarps, n_w);
  const size_t smem = sizeof(float) * (1 + args.n_types) * kChunk;
  fcfs_scan_kernel<K, POLICY, TEL, TRACE>
      <<<grid, kWarps * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_flavour(const ScanArgs& a, int n_w, cudaStream_t s) {
  const bool pol = a.pref_slot != nullptr, tel = a.tel != nullptr,
             tr = a.slot_out != nullptr;
  if (pol) {
    if (tel) return tr ? launch<K, true, true, true>(a, n_w, s)
                       : launch<K, true, true, false>(a, n_w, s);
    return tr ? launch<K, true, false, true>(a, n_w, s)
              : launch<K, true, false, false>(a, n_w, s);
  }
  if (tel) return tr ? launch<K, false, true, true>(a, n_w, s)
                     : launch<K, false, true, false>(a, n_w, s);
  return tr ? launch<K, false, false, true>(a, n_w, s)
            : launch<K, false, false, false>(a, n_w, s);
}

}  // namespace

// arrivals (n_w, nq) f32; service (service_rows, n_types, nq) f32 with
// service_rows 1 (shared) or n_w; type_of_slot (n_b, n_s) i32; priority
// (n_s,) f32; free0 (free0_rows, n_b, n_s) f32 with free0_rows 1 (shared)
// or n_w; a routing policy when pref_slot (n_b, n_s), affinity and hedge
// (n_b,) f32 are given (all three or none); the telemetry counters when
// n_active (n_b,) i32 and tel (n_w, n_b, 3 n_types + 66) i32 are given
// (both or none); outputs counts (n_w, n_b) i32, lat and start
// (n_w, n_b, nq) f32 or null, free_out (n_w, n_b, n_s) f32, slot_out
// (n_w, n_b, nq) i32 or null; all contiguous.  1 <= n_s <= 1024,
// 1 <= n_types <= 32, n_w <= 65535.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int fcfs_scan_forward(
    const void* arrivals, const void* service, int service_rows,
    const void* type_of_slot, const void* priority, const void* free0,
    int free0_rows, int n_w, int n_b, int n_s, int n_types, int nq,
    float big, float qos_t, const void* pref_slot, const void* affinity,
    const void* hedge, const void* n_active, void* counts, void* lat,
    void* start, void* free_out, void* slot_out, void* tel, void* stream) {
  if (n_w <= 0 || n_b <= 0) return 0;
  const bool pol = pref_slot != nullptr;
  if (n_s < 1 || n_s > 1024 || n_types < 1 || n_types > 32 || n_w > 65535 ||
      nq < 0 || (service_rows != 1 && service_rows != n_w) ||
      (free0_rows != 1 && free0_rows != n_w) ||
      pol != (affinity != nullptr) || pol != (hedge != nullptr) ||
      (n_active != nullptr) != (tel != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.arrivals = static_cast<const float*>(arrivals);
  a.service = static_cast<const float*>(service);
  a.service_rows = service_rows;
  a.type_of_slot = static_cast<const int32_t*>(type_of_slot);
  a.priority = static_cast<const float*>(priority);
  a.free0 = static_cast<const float*>(free0);
  a.free0_rows = free0_rows;
  a.n_b = n_b;
  a.n_s = n_s;
  a.n_types = n_types;
  a.nq = nq;
  a.big = big;
  a.qos_t = qos_t;
  a.pref_slot = static_cast<const float*>(pref_slot);
  a.affinity = static_cast<const float*>(affinity);
  a.hedge = static_cast<const float*>(hedge);
  a.n_active = static_cast<const int32_t*>(n_active);
  a.counts = static_cast<int32_t*>(counts);
  a.lat = static_cast<float*>(lat);
  a.start = static_cast<float*>(start);
  a.free_out = static_cast<float*>(free_out);
  a.slot_out = static_cast<int32_t*>(slot_out);
  a.tel = static_cast<int32_t*>(tel);
  auto s = static_cast<cudaStream_t>(stream);
  const int per_thread = (n_s + 31) / 32;
  if (per_thread <= 1) return static_cast<int>(launch_flavour<1>(a, n_w, s));
  if (per_thread <= 2) return static_cast<int>(launch_flavour<2>(a, n_w, s));
  if (per_thread <= 4) return static_cast<int>(launch_flavour<4>(a, n_w, s));
  if (per_thread <= 8) return static_cast<int>(launch_flavour<8>(a, n_w, s));
  if (per_thread <= 16) return static_cast<int>(launch_flavour<16>(a, n_w, s));
  return static_cast<int>(launch_flavour<32>(a, n_w, s));
}
