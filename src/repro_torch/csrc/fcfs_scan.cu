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
// Design: one warp per lane.  Thread l keeps slots s = k * 32 + l, k < K
// (K the least power of two >= ceil(n_s / 32)), of the carry (next-free
// times and slot types) in registers.  A step is the serial chain, and
// only what the carry feeds is on it:
//
//  * each held slot's key as an order-preserving unsigned image (x < y iff
//    image(x) < image(y); -0 and +0 one image, as under IEEE <): an idle
//    slot's image is precomputed (cold: of priority - big; routed: built a
//    step ahead, since the carry does not feed it), a busy one's is built
//    from its next-free time;
//  * one __reduce_min_sync over the warp, then K equality ballots: the
//    winner is the lowest set bit of the first nonzero one.  As s = k * 32
//    + l, that is the first index of the minimum, jnp.argmin's tie rule;
//  * the owner updates its register and records the query's finish (and
//    start and slot when asked) in shared memory, each one predicated
//    store, so no branch and no reconvergence is on the chain.
//
// Everything else runs once a chunk of up to 256 queries, the warp's 32
// threads taking the chunk's records 32 at a time: latencies, QoS counts,
// the outputs asked for (coalesced), and the telemetry counters.  The next
// query's arrival and, for K <= 4 or a routed scan, each held slot's
// service time are read from shared memory a step ahead (for K >= 8 the
// cold flavours read the winner's after the pick: K reads a step would
// cost more than one on the chain).  Each warp stages its own arrivals and
// service rows, chunk by chunk, into a double buffer of shared memory with
// cp.async, so no warp waits on another.  The cold step loop is unrolled
// 4 times for K <= 4, where that spills nothing.
//
// The cold flavour's busy image: when every arrival of the chunk is >= 0,
// every busy key is a positive next-free time (> a), whose bits with the
// top bit set are its image (one instruction).  Else the general image.
// The choice is made once a chunk, not once a step: a branch a step (to a
// pick from the idle ballots alone, say) costs more on this card than the
// reduction it would save.
//
// Bound: the serial chain.  The bytes are a few hundred KB at the search
// path's shapes (arrivals, service table, latencies when asked), under a
// microsecond at the card's memory rate; the nq steps of a lane are
// dependent, each a compare, a select, a redux.min, K ballots, a first set
// bit and the owner's max, add and select.  The lanes run in parallel, one
// warp each.
//
// Flavours, each a template flag:
//
// POLICY (routing): the reference takes the first minimum of the idle keys
//   fma(affinity, svc, pref) * TIE + priority if any slot is idle (one
//   __any_sync), else of the busy keys fma(hedge, svc, free); the other
//   side is keyed 1e30 (the reference's _INF), padding above everything.
// TEL (telemetry counters): the idle count is the __popc of the idle
//   ballots, the queue depth's sum and peak are kept a step; the latency
//   and wait histograms and the per-type served, misses and busy
//   milliseconds are counted in the chunk's pass from the records, as
//   integer shared-memory atomics (so in any order, to the same sums).
// TRACE: the winning slot of each query is recorded and written.
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

constexpr int kWarps = 4;          // lanes (slot layouts) per block
constexpr int kWarpFloats = 1024;  // a warp's buffer: (1 + n_types) * chunk
constexpr int kMaxChunk = 256;     // queries staged in a buffer at most
constexpr int kAheadK = 4;         // cold: service times a step ahead up to K 4
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTie = 65536.0f;     // the reference's _TIE
constexpr float kExcluded = 1e30f;   // the reference's _INF
constexpr int kBuckets = 32;         // telemetry histogram buckets
constexpr int kEdge0Bits = 0x38d1b717;  // float32 bits of 1e-4, edge 0

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
  int chunk;                  // queries staged in a buffer
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

// Order-preserving unsigned image of a float32: x < y iff image(x) <
// image(y), and -0 and +0 map to one value.
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));  // -0 -> +0
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// Index of the first nonzero vote of K (a tree of depth log2 K); ``bits``
// gets that vote, or 0 when all are 0.
template <int K>
__device__ __forceinline__ int first_set(const unsigned (&m)[K],
                                         unsigned& bits) {
  unsigned v[K];
  int idx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = m[k];
    idx[k] = k;
  }
#pragma unroll
  for (int lvl = 0; (1 << lvl) < K; ++lvl) {
    const int s = 1 << lvl;
#pragma unroll
    for (int i = 0; i + s < K; i += 2 * s) {
      const bool lo = v[i] != 0u;
      idx[i] = lo ? idx[i] : idx[i + s];
      v[i] = lo ? v[i] : v[i + s];
    }
  }
  bits = v[0];
  return idx[0];
}

// x[k] for a warp-uniform k, as a tree of selects of depth log2 K.
template <int K, typename T>
__device__ __forceinline__ T select_k(const T (&x)[K], int k) {
  T v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = x[i];
#pragma unroll
  for (int lvl = 0; (1 << lvl) < K; ++lvl) {
    const int s = 1 << lvl;
#pragma unroll
    for (int i = 0; i + s < K; i += 2 * s) v[i] = (k & s) ? v[i + s] : v[i];
  }
  return v[0];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A 32-bit store to shared memory by the threads where ``pred`` holds, as
// one predicated instruction: no branch, so no reconvergence, around it.
__device__ __forceinline__ void st_shared_if(bool pred, void* addr,
                                             unsigned v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(addr));
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t"
      "@q st.shared.b32 [%1], %2;\n\t}\n" ::"r"(static_cast<unsigned>(pred)),
      "r"(a), "r"(v)
      : "memory");
}

// Telemetry counters a warp keeps in shared memory: the latency and wait
// histograms, then served, QoS misses and busy milliseconds per type.
constexpr int kTelWords = 2 * kBuckets + 3 * 32;

// Shared memory of one warp, in 4-byte words: the double buffer of the
// chunk's arrivals and service rows, then the chunk's per-query records
// (finish, start, slot) and, with TEL, the counters.
__host__ __device__ constexpr int warp_words(int n_types, int chunk,
                                             bool tel) {
  return 2 * (1 + n_types) * chunk + 3 * chunk + (tel ? kTelWords : 0);
}

// Number of histogram edges 1e-4 * 2^k, k < 31, at or below x: for x >= 1e-4
// the float's bits order as integers and each edge adds one to the exponent.
__device__ __forceinline__ int bucket(float x) {
  const int d = (__float_as_int(x) - kEdge0Bits) >> 23;
  return x >= __int_as_float(kEdge0Bits) ? min(d + 1, kBuckets - 1) : 0;
}

// grid (ceil(n_b / kWarps), n_w); block kWarps * 32 threads; dynamic shared
// memory kWarps * warp_words(n_types, chunk, TEL) words, at most
// 4 * (2 * 1024 + 3 * 256 + 160) * 4 = 47,616 bytes: under the 48 KB a
// launch gets without opting in.
template <int K, bool POLICY, bool TEL, bool TRACE>
__global__ void __launch_bounds__(kWarps * 32)
fcfs_scan_kernel(const ScanArgs p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  const int w = blockIdx.y;
  if (b >= p.n_b) return;  // warps share nothing: no block barrier below
  const int n_s = p.n_s, n_types = p.n_types, nq = p.nq, ch = p.chunk;
  const int span = (1 + n_types) * ch;  // a buffer: arrivals, a row a type
  float* const bufs = smem + warp * warp_words(n_types, ch, TEL);
  float* const s_fin = bufs + 2 * span;  // the chunk's records
  float* const s_st = s_fin + ch;
  int* const s_slot = reinterpret_cast<int*>(s_st + ch);
  int* const s_tel = s_slot + ch;
  // Service times a step ahead (else the winner's, read after the pick),
  // and read early in the step (else after the pick, keeping one array).
  constexpr bool kAhead = POLICY || K <= kAheadK;
  constexpr bool kEarly = K <= kAheadK;

  // ukid: image of the cold idle key priority - big; prio, pref: the
  // routed idle key's terms; padding is never idle and keyed +inf.
  float fr[K], prio[K], pref[K];
  unsigned ukid[K];
  int ty[K];
  const int64_t carry_row =
      (p.free0_rows == 1 ? 0 : static_cast<int64_t>(w) * p.n_b) + b;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    fr[k] = INFINITY;
    ty[k] = 0;
    ukid[k] = ~0u;
    prio[k] = pref[k] = 0.f;
    if (s < n_s) {
      fr[k] = p.free0[carry_row * n_s + s];
      ty[k] = min(max(p.type_of_slot[static_cast<int64_t>(b) * n_s + s], 0),
                  n_types - 1);
      if (POLICY) {
        prio[k] = p.priority[s];
        pref[k] = p.pref_slot[static_cast<int64_t>(b) * n_s + s];
      } else {
        ukid[k] = order_bits(__fsub_rn(p.priority[s], p.big));
      }
    }
  }
  const float aff = POLICY ? p.affinity[b] : 0.f;
  const float hed = POLICY ? p.hedge[b] : 0.f;
  const unsigned u_excl = order_bits(kExcluded);
  const int n_live = n_s - lane;  // slot k * 32 + lane is live iff k * 32 < n_live
  const int n_act = TEL ? p.n_active[b] : 0;
  int d_sum = 0, d_peak = 0;
  if (TEL) {
    for (int i = lane; i < kTelWords; i += 32) s_tel[i] = 0;
  }

  const float* arr_row = p.arrivals + static_cast<int64_t>(w) * nq;
  const float* svc_row =
      p.service +
      (p.service_rows == 1 ? 0 : static_cast<int64_t>(w)) * n_types * nq;
  const int64_t out_row = (static_cast<int64_t>(w) * p.n_b + b) * nq;
  const int32_t* tos_row = p.type_of_slot + static_cast<int64_t>(b) * n_s;
  const int n_chunks = (nq + ch - 1) / ch;
  const bool w_lat = p.lat != nullptr, w_start = p.start != nullptr;
  const float qos_t = p.qos_t;

  auto stage = [&](int c) {  // chunk c into buffer c & 1
    float* dst = bufs + (c & 1) * span;
    const int q0 = c * ch, n = min(ch, nq - q0);
    for (int t = 0; t <= n_types; ++t) {
      const float* src =
          t == 0 ? arr_row + q0 : svc_row + static_cast<int64_t>(t - 1) * nq + q0;
      for (int i = lane; i < n; i += 32) cp_async4(dst + t * ch + i, src + i);
    }
    cp_async_commit();
  };
  if (n_chunks > 0) stage(0);
  if (n_chunks > 1) stage(1);
  cp_async_wait_all();
  __syncwarp();

  float a_nx = 0.f, sv_nx[K];
  unsigned uik[K];  // POLICY: images of the routed idle keys, a step ahead
#pragma unroll
  for (int k = 0; k < K; ++k) sv_nx[k] = 0.f;
  auto fetch = [&](const float* buf, int i) {
    a_nx = buf[i];
    if (kAhead) {
#pragma unroll
      for (int k = 0; k < K; ++k) sv_nx[k] = buf[(1 + ty[k]) * ch + i];
    }
  };
  auto idle_keys = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k)
      uik[k] = order_bits(__fadd_rn(
          __fmul_rn(__fmaf_rn(aff, sv_nx[k], pref[k]), kTie), prio[k]));
  };
  if (n_chunks > 0) {
    fetch(bufs, 0);
    if (POLICY) idle_keys();
  }

  // One query, the serial chain: pick the slot, update the owner's
  // register, record finish (and start, slot) for the chunk's pass; the
  // next query's operands come from nbuf at ni.
  auto step = [&](bool fast, int qq, const float* cur, const float* nbuf,
                  int ni) {
    const float a = a_nx;
    float sv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sv[k] = sv_nx[k];
    if (kEarly) fetch(nbuf, ni);
    bool idle[K];
#pragma unroll
    for (int k = 0; k < K; ++k) idle[k] = fr[k] <= a;
    unsigned u[K];
    if constexpr (POLICY) {
      bool mine = false;
#pragma unroll
      for (int k = 0; k < K; ++k) mine = mine || idle[k];
      const bool any = __any_sync(kFull, mine);
#pragma unroll
      for (int k = 0; k < K; ++k)
        u[k] = any ? (idle[k] ? uik[k] : (k * 32 < n_live ? u_excl : ~0u))
                   : order_bits(__fmaf_rn(hed, sv[k], fr[k]));
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        u[k] = idle[k] ? ukid[k]
                       : (fast ? __float_as_uint(fr[k]) | 0x80000000u
                               : order_bits(fr[k]));
    }
    unsigned v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = u[k];
#pragma unroll
    for (int lvl = 0; (1 << lvl) < K; ++lvl) {
      const int s = 1 << lvl;
#pragma unroll
      for (int i = 0; i + s < K; i += 2 * s) v[i] = min(v[i], v[i + s]);
    }
    const unsigned lo = __reduce_min_sync(kFull, v[0]);
    unsigned e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = __ballot_sync(kFull, u[k] == lo);
    unsigned bits;
    const int kw = first_set(e, bits);
    const int lw = __ffs(bits) - 1;
    const bool own = lane == lw;
    const float st = fmaxf(a, select_k(fr, kw));
    const float svw =
        kAhead ? select_k(sv, kw) : cur[(1 + select_k(ty, kw)) * ch + qq];
    const float finish = __fadd_rn(st, svw);
#pragma unroll
    for (int k = 0; k < K; ++k) fr[k] = own && k == kw ? finish : fr[k];
    st_shared_if(own, s_fin + qq, __float_as_uint(finish));
    if (TEL) {
      st_shared_if(own, s_st + qq, __float_as_uint(st));
    } else {
      st_shared_if(own && w_start, s_st + qq, __float_as_uint(st));
    }
    if (TEL || TRACE) st_shared_if(own, s_slot + qq, kw * 32 + lw);
    if constexpr (TEL) {
      int n_idle = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) n_idle += __popc(__ballot_sync(kFull, idle[k]));
      const int depth = n_act - n_idle;
      d_sum += depth;
      d_peak = max(d_peak, depth);
    }
    if (!kEarly) fetch(nbuf, ni);
    if (POLICY) idle_keys();
  };

  // The chunk's pass, 32 queries at a time: latencies, QoS counts, the
  // outputs asked for (coalesced), and with TEL the counters.
  int count = 0;
  auto chunk_pass = [&](const float* cur, int q0, int n) {
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const float a = cur[i];
      const float l = __fsub_rn(s_fin[i], a);
      count += l <= qos_t;
      const int64_t o = out_row + q0 + i;
      if (w_lat) p.lat[o] = l;
      if (w_start) p.start[o] = s_st[i];
      if (TRACE) p.slot_out[o] = s_slot[i];
      if (TEL) {
        const int t = min(max(tos_row[s_slot[i]], 0), n_types - 1);
        const float sv = cur[(1 + t) * ch + i];
        atomicAdd(&s_tel[bucket(l)], 1);
        atomicAdd(&s_tel[kBuckets + bucket(fmaxf(__fsub_rn(s_st[i], a), 0.f))],
                  1);
        atomicAdd(&s_tel[2 * kBuckets + t], 1);
        if (l > qos_t) atomicAdd(&s_tel[2 * kBuckets + 32 + t], 1);
        atomicAdd(&s_tel[2 * kBuckets + 64 + t],
                  __float2int_rn(__fmul_rn(sv, 1000.f)));
      }
    }
  };

  for (int c = 0; c < n_chunks; ++c) {
    const float* cur = bufs + (c & 1) * span;
    const float* nxt = bufs + ((c + 1) & 1) * span;
    const int q0 = c * ch, n = min(ch, nq - q0);
    bool fast = false;  // cold: every arrival of the chunk >= 0
    if (!POLICY) {
      bool ok = true;
      for (int i = lane; i < n; i += 32) ok = ok && cur[i] >= 0.f;
      fast = __all_sync(kFull, ok);
    }
    auto run = [&](bool f) {
      if constexpr (!POLICY && K <= kAheadK) {
#pragma unroll 4
        for (int qq = 0; qq < n - 1; ++qq) step(f, qq, cur, cur, qq + 1);
      } else {
        for (int qq = 0; qq < n - 1; ++qq) step(f, qq, cur, cur, qq + 1);
      }
      if (c + 1 < n_chunks) {  // the next chunk, staged a chunk ago
        cp_async_wait_all();
        __syncwarp();
      }
      step(f, n - 1, cur, nxt, 0);
    };
    if (fast)
      run(true);
    else
      run(false);
    chunk_pass(cur, q0, n);
    __syncwarp();  // every read of buffer c & 1 and of the records done
    if (c + 2 < n_chunks) stage(c + 2);
  }
  count = __reduce_add_sync(kFull, count);
  const int64_t lane_row = static_cast<int64_t>(w) * p.n_b + b;
  if (lane == 0) p.counts[lane_row] = count;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (s < n_s) p.free_out[lane_row * n_s + s] = fr[k];
  }
  if constexpr (TEL) {
    __syncwarp();
    int32_t* row = p.tel + lane_row * (3 * n_types + 2 * kBuckets + 2);
    if (lane < n_types) {
      row[lane] = s_tel[2 * kBuckets + lane];
      row[n_types + lane] = s_tel[2 * kBuckets + 32 + lane];
      row[2 * n_types + lane] = s_tel[2 * kBuckets + 64 + lane];
    }
    row[3 * n_types + lane] = s_tel[lane];
    row[3 * n_types + kBuckets + lane] = s_tel[kBuckets + lane];
    if (lane == 0) {
      row[3 * n_types + 2 * kBuckets] = d_sum;
      row[3 * n_types + 2 * kBuckets + 1] = d_peak;
    }
  }
}

template <int K, bool POLICY, bool TEL, bool TRACE>
cudaError_t launch(const ScanArgs& args, int n_w, cudaStream_t stream) {
  const dim3 grid((args.n_b + kWarps - 1) / kWarps, n_w);
  const size_t smem =
      sizeof(float) * kWarps * warp_words(args.n_types, args.chunk, TEL);
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
  a.chunk = kMaxChunk;
  while ((1 + n_types) * a.chunk > kWarpFloats) a.chunk /= 2;
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
