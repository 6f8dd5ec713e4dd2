// The paper's comparison baselines on Hopper: one thread per datum id.
//
// Replaces three TPU kernels of the reference's kernels/baselines.py:
//   * baseline_ch_place  <- ch_place_pallas (body ch_lookup): consistent
//       hashing -- fmix32(id), the first ring point >= the hash
//       (searchsorted side="left", so the first of equal points), index n
//       wraps to 0, owner gather;
//   * baseline_rs_place  <- rs_place_pallas (body rs_lookup): random
//       slicing -- fmix32(id), the last interval start <= the hash
//       (searchsorted side="right" minus 1), owner gather;
//   * baseline_wrh_place <- wrh_place_pallas (body wrh_lookup): weighted
//       rendezvous -- running argmin over the node table of
//       float(neg_log2_q16(fmix32(fmix32(id + salt)))) * inv_w, strict <
//       (the first minimum wins), entries with inv_w <= 0 never win, the
//       winner's node id recovered from its salt by GOLDEN's inverse.
// and adds the R-way fan-out the reference runs as a jnp while_loop
// around those lookups on every backend (baseline_replicas_lookup):
//   * baseline_replicas  -- per lane, slot 0 is the lookup of the id; try
//       k = 1 .. max_tries while the set is short, look up
//       draw_u32(id, REPLICA_FANOUT_LEVEL, k) and accept it if it equals
//       none of the R slots (unfilled ones hold -1, so a -1 candidate is
//       never accepted); stats [reprobes] = the tries lanes made while
//       short, one u32 atomic per block.
//
// The tables arrive lane-padded exactly as the reference's table prep
// makes them (ring padded with 0xFFFFFFFF and owners[0]; starts with
// 0xFFFFFFFF and the last owner; salts with 0 and inv_w with 0.0), and
// the searches run over the padded length, so every lane computes what
// the reference computes.
//
// What bounds them on an H100.  CH and RS move 8 bytes per id (a u32 in,
// an i32 out) and do one fmix32 and a binary search of log2(table)
// dependent loads each: 19 steps on the 409,600-point ring of a
// 4096-node cluster at 100 virtual nodes (3.3 MB with its owners), 14 on
// a 12,287-interval RS table.  The tables do not fit the 227 KB of shared
// memory a block may have, unlike the TPU's VMEM, so the search runs in
// global memory, where the table stays in the 50 MB L2; the latency of
// the dependent loads, not bytes or ALU, is what they wait on, and many
// resident warps hide it.  WRH is O(N) per id: per (id, node) pair two
// fmix32, the 16-step Q16 log and one f32 multiply (~100 int32
// operations), so it is operation-bound by three orders of magnitude
// over its 8 bytes per id.  Its node table is staged through shared
// memory in tiles of kWrhTile entries (32 KB): every thread of a block
// reads the same entry at once, a broadcast.  The Q16 log squares its
// 24-bit mantissa with one 32x32->64 multiply, where the TPU (no 64-bit
// product) assembles it from 16-bit limbs: m * m < 2**48, so both keep
// the same bits 23..47.  The key is one IEEE f32 multiply (__fmul_rn:
// never fused, never fast-math), as on the host and in the twin.
//
// The fan-out runs each lane's rejection loop on its own and stops at its
// own R-th distinct node; the reference's batch-wide early exit only
// skips iterations that change nothing, so the results and the reprobe
// sum are the same.  R <= 8 keeps the slots in registers; larger R keeps
// them in the lane's own row of the output.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

using port_hash::draw_u32;
using port_hash::fmix32;
using port_hash::kGolden;

constexpr int kThreads = 256;
constexpr int kWrhTile = 4096;  // salts + inv_w: 32 KB of shared memory
constexpr uint32_t kGoldenInv = 0x144CBC89u;  // GOLDEN * kGoldenInv == 1 mod 2**32
constexpr uint32_t kFanoutLevel = 0x52455031u;  // "REP1", REPLICA_FANOUT_LEVEL
constexpr int kQ16 = 16;
static_assert(kGolden * kGoldenInv == 1u, "GOLDEN's inverse mod 2**32");

// First index with keys[idx] >= h (side="left") or > h (side="right").
template <bool kSideLeft>
__device__ __forceinline__ int search_u32(const uint32_t* __restrict__ keys,
                                          int n, uint32_t h) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint32_t k = __ldg(keys + mid);
    if (kSideLeft ? (k < h) : (k <= h)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct ChLookup {
  const uint32_t* ring;
  const int32_t* owners;
  int n;
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    int idx = search_u32<true>(ring, n, fmix32(id));
    if (idx == n) idx = 0;  // past the last point: wrap to the first
    return __ldg(owners + idx);
  }
};

struct RsLookup {
  const uint32_t* starts;
  const int32_t* owners;
  int n;
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    int idx = search_u32<false>(starts, n, fmix32(id)) - 1;
    if (idx < 0) idx = n - 1;  // only if starts[0] != 0: NumPy's owners[-1]
    return __ldg(owners + idx);
  }
};

// -log2(u) in Q16 for u = (2 * (h >> 9) + 1) / 2**24 (core/wrh.py).
__device__ __forceinline__ int32_t neg_log2_q16(uint32_t h) {
  const uint32_t v = ((h >> 9) << 1) | 1u;
  const int e = 31 - __clz(v);  // floor(log2 v); v is odd, so >= 1
  uint32_t m = v << (23 - e);   // [2**23, 2**24)
  uint32_t frac = 0u;
#pragma unroll
  for (int i = 1; i <= kQ16; ++i) {
    m = static_cast<uint32_t>((static_cast<uint64_t>(m) * m) >> 23);
    if (m >= (1u << 24)) {
      frac |= 1u << (kQ16 - i);
      m >>= 1;
    }
  }
  return ((24 - e) << kQ16) - static_cast<int32_t>(frac);
}

// Running argmin over ``count`` entries of a salt / reciprocal table.
__device__ __forceinline__ void wrh_scan(uint32_t id, const uint32_t* salts,
                                         const float* inv_w, int count,
                                         float& best_key, uint32_t& best_salt) {
  for (int j = 0; j < count; ++j) {
    const uint32_t salt = salts[j];
    const float iw = inv_w[j];
    const uint32_t h = fmix32(fmix32(id + salt));
    const float key = __fmul_rn(__int2float_rn(neg_log2_q16(h)), iw);
    if (iw > 0.0f && key < best_key) {
      best_key = key;
      best_salt = salt;
    }
  }
}

__device__ __forceinline__ int32_t salt_to_node(uint32_t best_salt) {
  return static_cast<int32_t>(best_salt * kGoldenInv - 1u);  // salt 0 -> -1
}

struct WrhLookup {
  const uint32_t* salts;
  const float* inv_w;
  int n;
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    float best_key = __int_as_float(0x7F800000);  // +inf
    uint32_t best_salt = 0u;
    wrh_scan(id, salts, inv_w, n, best_key, best_salt);
    return salt_to_node(best_salt);
  }
};

template <class Lookup>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(Lookup look, const uint32_t* __restrict__ ids,
              int32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = look(ids[i]);
}

// B7: the node table passes through shared memory one tile at a time;
// every thread of the block takes part in the staging, lanes past n too.
__global__ void __launch_bounds__(kThreads)
wrh_place_kernel(const uint32_t* __restrict__ ids,
                 const uint32_t* __restrict__ salts,
                 const float* __restrict__ inv_w, int32_t* __restrict__ out,
                 int64_t n, int n_nodes) {
  __shared__ uint32_t s_salt[kWrhTile];
  __shared__ float s_inv[kWrhTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const uint32_t id = live ? ids[i] : 0u;
  float best_key = __int_as_float(0x7F800000);
  uint32_t best_salt = 0u;
  for (int base = 0; base < n_nodes; base += kWrhTile) {
    const int count = min(kWrhTile, n_nodes - base);
    __syncthreads();  // the previous tile is read by every thread
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      s_salt[j] = __ldg(salts + base + j);
      s_inv[j] = __ldg(inv_w + base + j);
    }
    __syncthreads();
    if (live) wrh_scan(id, s_salt, s_inv, count, best_key, best_salt);
  }
  if (live) out[i] = salt_to_node(best_salt);
}

// The R-way fan-out; out is (n, R) int32, row-major.
// RMAX > 0: slots in registers (R <= RMAX); RMAX == 0: in the output row.
template <class Lookup, int RMAX>
__global__ void __launch_bounds__(kThreads)
replicas_kernel(Lookup look, const uint32_t* __restrict__ ids,
                int32_t* __restrict__ out, uint32_t* __restrict__ stats,
                int64_t n, int R, int max_tries) {
  __shared__ uint32_t block_probes;
  if (stats != nullptr) {
    if (threadIdx.x == 0) block_probes = 0u;
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint32_t id = ids[i];
    int32_t* row = out + i * R;
    int32_t slots[RMAX > 0 ? RMAX : 1];
    const int32_t prim = look(id);
    if constexpr (RMAX > 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) slots[r] = r == 0 ? prim : -1;
    } else {
      row[0] = prim;
      for (int r = 1; r < R; ++r) row[r] = -1;
    }
    int found = 1;  // slot 0 counts even when the lookup gave -1
    uint32_t probes = 0u;
    for (int k = 1; k <= max_tries && found < R; ++k) {
      ++probes;
      const int32_t cand =
          look(draw_u32(id, kFanoutLevel, static_cast<uint32_t>(k)));
      bool dup = false;
      if constexpr (RMAX > 0) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r) dup |= (r < R) && (slots[r] == cand);
        if (!dup) {
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r == found) slots[r] = cand;
          }
        }
      } else {
        for (int r = 0; r < R && !dup; ++r) dup = row[r] == cand;
        if (!dup) row[found] = cand;
      }
      if (!dup) ++found;
    }
    if constexpr (RMAX > 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) row[r] = slots[r];
      }
    }
    if (stats != nullptr && probes) atomicAdd(&block_probes, probes);
  }
  if (stats != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && block_probes) atomicAdd(stats, block_probes);
  }
}

dim3 grid_for(int64_t n) {
  return dim3(static_cast<unsigned int>((n + kThreads - 1) / kThreads));
}

template <class Lookup>
void launch_replicas(Lookup look, cudaStream_t s, const uint32_t* ids,
                     int32_t* out, uint32_t* stats, int64_t n, int R,
                     int max_tries) {
  const dim3 grid = grid_for(n);
  if (R <= 1) {
    replicas_kernel<Lookup, 1><<<grid, kThreads, 0, s>>>(look, ids, out, stats, n, R, max_tries);
  } else if (R <= 2) {
    replicas_kernel<Lookup, 2><<<grid, kThreads, 0, s>>>(look, ids, out, stats, n, R, max_tries);
  } else if (R <= 4) {
    replicas_kernel<Lookup, 4><<<grid, kThreads, 0, s>>>(look, ids, out, stats, n, R, max_tries);
  } else if (R <= 8) {
    replicas_kernel<Lookup, 8><<<grid, kThreads, 0, s>>>(look, ids, out, stats, n, R, max_tries);
  } else {
    replicas_kernel<Lookup, 0><<<grid, kThreads, 0, s>>>(look, ids, out, stats, n, R, max_tries);
  }
}

}  // namespace

extern "C" int baseline_ch_place(const void* ids, const void* ring,
                                 const void* owners, void* out, int64_t n,
                                 int n_ring, void* stream) {
  const ChLookup look{static_cast<const uint32_t*>(ring),
                      static_cast<const int32_t*>(owners), n_ring};
  lookup_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      look, static_cast<const uint32_t*>(ids), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int baseline_rs_place(const void* ids, const void* starts,
                                 const void* owners, void* out, int64_t n,
                                 int n_starts, void* stream) {
  const RsLookup look{static_cast<const uint32_t*>(starts),
                      static_cast<const int32_t*>(owners), n_starts};
  lookup_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      look, static_cast<const uint32_t*>(ids), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int baseline_wrh_place(const void* ids, const void* salts,
                                  const void* inv_w, void* out, int64_t n,
                                  int n_nodes, void* stream) {
  wrh_place_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(salts),
      static_cast<const float*>(inv_w), static_cast<int32_t*>(out), n, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

// algorithm: 0 = ch (keys ring, vals owners), 1 = rs (starts, owners),
// 2 = wrh (salts, inv_w).  stats: a zeroed (1,) u32 accumulator, or null.
extern "C" int baseline_replicas(int algorithm, const void* ids,
                                 const void* keys, const void* vals,
                                 void* out, void* stats, int64_t n, int n_keys,
                                 int R, int max_tries, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const uint32_t*>(ids);
  auto* k = static_cast<const uint32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  auto* st = static_cast<uint32_t*>(stats);
  if (algorithm == 0) {
    launch_replicas(ChLookup{k, static_cast<const int32_t*>(vals), n_keys}, s, i, o, st, n, R, max_tries);
  } else if (algorithm == 1) {
    launch_replicas(RsLookup{k, static_cast<const int32_t*>(vals), n_keys}, s, i, o, st, n, R, max_tries);
  } else if (algorithm == 2) {
    launch_replicas(WrhLookup{k, static_cast<const float*>(vals), n_keys}, s, i, o, st, n, R, max_tries);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
