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
// an i32 out) and do one fmix32 and a search of log2(table) steps each: 19
// on the 409,600-point ring of a 4096-node cluster at 100 virtual nodes
// (3.3 MB with its owners), 14 on a 12,287-interval RS table.  A plain
// binary search over the ring in global memory makes ~19 dependent loads
// per lookup, ~9 of them L2 sectors of 32 bytes that each serve one 4-byte
// key; on the card the time follows the L2 sectors a lookup reads, not
// its ALU work.  So the search runs in two levels:
//   * each block stages a sampled index of the table into dynamic shared
//     memory, every S-th key (S = 2**shift, the least power of two whose
//     index fits kIndexBudget bytes: S = 16 for the 409,600-point ring,
//     S = 1 -- the whole table -- up to 28,672 keys, every RS table here),
//     and binary-searches it there with a branchless, fixed-trip lower
//     bound;
//   * the lane then counts, with independent loads (16-byte vectors where
//     the table is aligned), the keys of its one S-key bucket that pass
//     (key < h for side="left", key <= h for side="right"), and gathers
//     the owner: three L2 sectors at S = 16 where the plain search read
//     ~10.  A larger index with smaller buckets leaves fewer resident
//     warps; a smaller one reads more sectors per bucket.
// The index entry that ends the count passes and the next one does not,
// so the table being sorted makes the count the searchsorted index
// exactly: duplicates across a bucket boundary, the 0xFFFFFFFF padding
// and the wrap at idx == n land where NumPy's search lands.  The staging
// is paid once per block: the CH / RS kernels are persistent (SMs x
// resident blocks, from the occupancy calculator) and walk the ids
// grid-stride.  WRH is O(N) per id: per (id, node) pair two
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

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

using port_hash::draw_u32;
using port_hash::fmix32;
using port_hash::kGolden;

constexpr int kThreads = 256;        // WRH and the one-thread-per-id launches
constexpr int kSearchThreads = 512;  // the persistent CH / RS blocks
// Shared memory for one block's sampled index: two blocks of
// kSearchThreads fit an SM's 228 KB with room for their static shared
// memory and the 1 KB each block leaves to the system.
constexpr int kIndexBudget = 112 * 1024;
constexpr int kWrhTile = 4096;  // salts + inv_w: 32 KB of shared memory
constexpr uint32_t kGoldenInv = 0x144CBC89u;  // GOLDEN * kGoldenInv == 1 mod 2**32
constexpr uint32_t kFanoutLevel = 0x52455031u;  // "REP1", REPLICA_FANOUT_LEVEL
constexpr int kQ16 = 16;
static_assert(kGolden * kGoldenInv == 1u, "GOLDEN's inverse mod 2**32");

// log2 of the index stride: the least S = 2**shift with ceil(n / S) keys
// in kIndexBudget bytes.
int index_shift(int n) {
  int shift = 0;
  while ((static_cast<int64_t>(n) + (1 << shift) - 1) >> shift >
         kIndexBudget / static_cast<int>(sizeof(uint32_t))) {
    ++shift;
  }
  return shift;
}

// searchsorted over a sorted u32 table through a sampled index in shared
// memory: the number of keys < h (kSideLeft) or <= h.
template <bool kSideLeft>
struct IndexedSearch {
  const uint32_t* keys;  // the table, global memory
  const uint32_t* idx;   // keys[j << shift] for j < m, shared (set by stage)
  int n;
  int m;
  int shift;
  bool vec;  // keys is 16-byte aligned: full buckets load as uint4 (shift >= 2)

  __device__ __forceinline__ static uint32_t pass(uint32_t k, uint32_t h) {
    return kSideLeft ? (k < h) : (k <= h);
  }

  // Every thread of the block: copy the index, then wait for all of it.
  __device__ __forceinline__ void stage(uint32_t* smem) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      smem[j] = __ldg(keys + (static_cast<int64_t>(j) << shift));
    }
    idx = smem;
    __syncthreads();
  }

  __device__ __forceinline__ int operator()(uint32_t h) const {
    // branchless lower bound over the index: b = index keys that pass
    const uint32_t* p = idx;
    for (int len = m; len > 1;) {
      const int half = len >> 1;
      p += pass(p[half - 1], h) ? half : 0;
      len -= half;
    }
    const int b = static_cast<int>(p - idx) + static_cast<int>(pass(*p, h));
    return shift == 0 ? b : in_bucket(b, h);
  }

  // keys[base] passes and keys[base + S] (when < n) does not: the answer
  // is base plus the keys of the bucket that pass.
  __device__ __forceinline__ int in_bucket(int b, uint32_t h) const {
    if (b == 0) return 0;
    const int base = (b - 1) << shift;
    const int len_b = min(1 << shift, n - base);
    const uint32_t* bucket = keys + base;
    int c = 0;
    if (vec && len_b == (1 << shift)) {
      const uint4* v = reinterpret_cast<const uint4*>(bucket);
      for (int q = 0; q < (len_b >> 2); ++q) {
        const uint4 k = __ldg(v + q);
        c += pass(k.x, h) + pass(k.y, h) + pass(k.z, h) + pass(k.w, h);
      }
    } else {
      for (int j = 0; j < len_b; ++j) c += pass(__ldg(bucket + j), h);
    }
    return base + c;
  }
};

struct ChLookup {
  IndexedSearch<true> search;
  const int32_t* owners;
  __device__ __forceinline__ void stage(uint32_t* smem) { search.stage(smem); }
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    int idx = search(fmix32(id));
    if (idx == search.n) idx = 0;  // past the last point: wrap to the first
    return __ldg(owners + idx);
  }
};

struct RsLookup {
  IndexedSearch<false> search;
  const int32_t* owners;
  __device__ __forceinline__ void stage(uint32_t* smem) { search.stage(smem); }
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    int idx = search(fmix32(id)) - 1;
    if (idx < 0) idx = search.n - 1;  // only if starts[0] != 0: NumPy's owners[-1]
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
  __device__ __forceinline__ void stage(uint32_t*) {}
  __device__ __forceinline__ int32_t operator()(uint32_t id) const {
    float best_key = __int_as_float(0x7F800000);  // +inf
    uint32_t best_salt = 0u;
    wrh_scan(id, salts, inv_w, n, best_key, best_salt);
    return salt_to_node(best_salt);
  }
};

// Block size of each lookup's launches: persistent blocks for the indexed
// searches, one thread per id for WRH.
template <class Lookup> struct Shape { static constexpr int kBlock = kSearchThreads; };
template <> struct Shape<WrhLookup> { static constexpr int kBlock = kThreads; };

__device__ __forceinline__ int64_t first_id() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int64_t id_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

template <class Lookup>
__global__ void __launch_bounds__(Shape<Lookup>::kBlock)
lookup_kernel(Lookup look, const uint32_t* __restrict__ ids,
              int32_t* __restrict__ out, int64_t n) {
  extern __shared__ uint32_t smem[];
  look.stage(smem);
  for (int64_t i = first_id(); i < n; i += id_stride()) out[i] = look(ids[i]);
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
__global__ void __launch_bounds__(Shape<Lookup>::kBlock)
replicas_kernel(Lookup look, const uint32_t* __restrict__ ids,
                int32_t* __restrict__ out, uint32_t* __restrict__ stats,
                int64_t n, int R, int max_tries) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t block_probes;
  if (threadIdx.x == 0) block_probes = 0u;
  look.stage(smem);  // ends in a barrier where it stages anything
  if (stats != nullptr) __syncthreads();
  uint32_t probes = 0u;
  for (int64_t i = first_id(); i < n; i += id_stride()) {
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
  }
  if (stats != nullptr) {
    if (probes) atomicAdd(&block_probes, probes);
    __syncthreads();
    if (threadIdx.x == 0 && block_probes) atomicAdd(stats, block_probes);
  }
}

// Launch plan of one lookup kernel: the index stride and its shared
// memory, and the grid -- n / block for WRH, else the persistent grid.
struct Plan {
  int shift;
  int smem;
  int block;
  int blocks_per_sm;
  int sms;
  int grid;
};

int64_t blocks_for(int64_t n, int block) { return (n + block - 1) / block; }

template <class Lookup, class Kernel>
cudaError_t plan_for(Kernel kernel, const Lookup& look, int64_t n, Plan& p) {
  constexpr int block = Shape<Lookup>::kBlock;
  p = Plan{0, 0, block, 0, 0, static_cast<int>(blocks_for(n, block))};
  if constexpr (!std::is_same<Lookup, WrhLookup>::value) {
    p.shift = look.search.shift;
    p.smem = look.search.m * static_cast<int>(sizeof(uint32_t));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm, kernel,
                                                          block, p.smem);
    }
    if (err != cudaSuccess) return err;
    if (p.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    p.grid = static_cast<int>(
        std::min<int64_t>(blocks_for(n, block),
                          static_cast<int64_t>(p.sms) * p.blocks_per_sm));
  }
  return cudaSuccess;
}

template <bool kSideLeft>
IndexedSearch<kSideLeft> make_search(const void* keys, int n) {
  const int shift = index_shift(n);
  return IndexedSearch<kSideLeft>{
      static_cast<const uint32_t*>(keys), nullptr, n,
      static_cast<int>((static_cast<int64_t>(n) + (1 << shift) - 1) >> shift), shift,
      shift >= 2 && reinterpret_cast<uintptr_t>(keys) % 16 == 0};
}

template <class Lookup>
cudaError_t launch_lookup(const Lookup& look, cudaStream_t s, const uint32_t* ids,
                          int32_t* out, int64_t n, Plan* plan_only) {
  Plan p;
  cudaError_t err = plan_for(lookup_kernel<Lookup>, look, n, p);
  if (err != cudaSuccess) return err;
  if (plan_only != nullptr) {
    *plan_only = p;
    return cudaSuccess;
  }
  lookup_kernel<Lookup><<<p.grid, p.block, p.smem, s>>>(look, ids, out, n);
  return cudaGetLastError();
}

template <class Lookup, int RMAX>
cudaError_t launch_replicas_at(const Lookup& look, cudaStream_t s, const uint32_t* ids,
                               int32_t* out, uint32_t* stats, int64_t n, int R,
                               int max_tries, Plan* plan_only) {
  Plan p;
  cudaError_t err = plan_for(replicas_kernel<Lookup, RMAX>, look, n, p);
  if (err != cudaSuccess) return err;
  if (plan_only != nullptr) {
    *plan_only = p;
    return cudaSuccess;
  }
  replicas_kernel<Lookup, RMAX><<<p.grid, p.block, p.smem, s>>>(
      look, ids, out, stats, n, R, max_tries);
  return cudaGetLastError();
}

template <class Lookup>
cudaError_t launch_replicas(const Lookup& look, cudaStream_t s, const uint32_t* ids,
                            int32_t* out, uint32_t* stats, int64_t n, int R,
                            int max_tries, Plan* plan_only) {
#define FANOUT(RM) \
  launch_replicas_at<Lookup, RM>(look, s, ids, out, stats, n, R, max_tries, plan_only)
  if (R <= 1) return FANOUT(1);
  if (R <= 2) return FANOUT(2);
  if (R <= 4) return FANOUT(4);
  if (R <= 8) return FANOUT(8);
  return FANOUT(0);
#undef FANOUT
}

// algorithm: 0 = ch (keys ring, vals owners), 1 = rs (starts, owners),
// 2 = wrh (salts, inv_w); R < 1 plans the one-lookup kernel (B5-B7's
// lookup_kernel), R >= 1 the fan-out.
cudaError_t dispatch(int algorithm, const void* ids, const void* keys,
                     const void* vals, void* out, void* stats, int64_t n,
                     int n_keys, int R, int max_tries, cudaStream_t s,
                     Plan* plan_only) {
  auto* i = static_cast<const uint32_t*>(ids);
  auto* o = static_cast<int32_t*>(out);
  auto* st = static_cast<uint32_t*>(stats);
  auto* owners = static_cast<const int32_t*>(vals);
  if (algorithm == 0) {
    const ChLookup look{make_search<true>(keys, n_keys), owners};
    return R < 1 ? launch_lookup(look, s, i, o, n, plan_only)
                 : launch_replicas(look, s, i, o, st, n, R, max_tries, plan_only);
  }
  if (algorithm == 1) {
    const RsLookup look{make_search<false>(keys, n_keys), owners};
    return R < 1 ? launch_lookup(look, s, i, o, n, plan_only)
                 : launch_replicas(look, s, i, o, st, n, R, max_tries, plan_only);
  }
  if (algorithm == 2 && R >= 1) {
    const WrhLookup look{static_cast<const uint32_t*>(keys),
                         static_cast<const float*>(vals), n_keys};
    return launch_replicas(look, s, i, o, st, n, R, max_tries, plan_only);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int baseline_ch_place(const void* ids, const void* ring,
                                 const void* owners, void* out, int64_t n,
                                 int n_ring, void* stream) {
  return static_cast<int>(dispatch(0, ids, ring, owners, out, nullptr, n, n_ring, 0,
                                   0, static_cast<cudaStream_t>(stream), nullptr));
}

extern "C" int baseline_rs_place(const void* ids, const void* starts,
                                 const void* owners, void* out, int64_t n,
                                 int n_starts, void* stream) {
  return static_cast<int>(dispatch(1, ids, starts, owners, out, nullptr, n, n_starts,
                                   0, 0, static_cast<cudaStream_t>(stream), nullptr));
}

extern "C" int baseline_wrh_place(const void* ids, const void* salts,
                                  const void* inv_w, void* out, int64_t n,
                                  int n_nodes, void* stream) {
  const dim3 grid(static_cast<unsigned int>(blocks_for(n, kThreads)));
  wrh_place_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(salts),
      static_cast<const float*>(inv_w), static_cast<int32_t*>(out), n, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

// stats: a zeroed (1,) u32 accumulator, or null.
extern "C" int baseline_replicas(int algorithm, const void* ids,
                                 const void* keys, const void* vals,
                                 void* out, void* stats, int64_t n, int n_keys,
                                 int R, int max_tries, void* stream) {
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(algorithm, ids, keys, vals, out, stats, n, n_keys,
                                   R, max_tries, static_cast<cudaStream_t>(stream),
                                   nullptr));
}

// The launch plan the two calls above would use, without launching:
// plan = [shift, shared bytes, block, blocks per SM, SMs, grid].  keys
// matters only through its alignment; R < 1 plans the one-lookup kernel.
extern "C" int baseline_launch_plan(int algorithm, const void* keys, int64_t n,
                                    int n_keys, int R, int* plan) {
  Plan p;
  const cudaError_t err = dispatch(algorithm, nullptr, keys, nullptr, nullptr, nullptr,
                                   n, n_keys, R, 0, nullptr, &p);
  if (err == cudaSuccess) {
    const int v[] = {p.shift, p.smem, p.block, p.blocks_per_sm, p.sms, p.grid};
    for (int j = 0; j < 6; ++j) plan[j] = v[j];
  }
  return static_cast<int>(err);
}
