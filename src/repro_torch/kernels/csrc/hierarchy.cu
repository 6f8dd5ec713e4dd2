// Two-level (failure-domain-aware) ASURA replication on Hopper: one thread
// per datum id.
//
// Replaces the reference's kernels/hierarchy.py hier_place_replicas_pallas
// (body _hier_replicas_kernel / _hier_replicas_tile, with
// _place_vartop, next_asura_vartop and resolve_tail_vartop):
//   * level 1 -- section 5.A over the DOMAIN table: B2's lane body
//       (place_replicas_lane_with) with the dense domain SLOT as the
//       "node", so R distinct slots are R distinct domains (-1 for a slot
//       the max_draws * R draws did not fill);
//   * level 2 -- for each filled slot, one total placement of the salted
//       id fmix32(id ^ did * GOLDEN) in that domain's own table: B1's lane
//       body (place_lane_with<true>) at the domain's own top level, on the
//       domain's row of the stacked (D * s_pad,) tables, then the row's
//       seg->node gather;
//   * out is (2, R, n) int32: plane 0 the domain ids, plane 1 the node
//       ids, both -1 for a slot level 1 left unfilled.
//
// The stacked rows are zero-length padded up to s_pad (node map -1, the
// u64 cumsum carried at the domain's total), so a padded slot never hits
// (f < 0 is false) and the tail's side="right" search over the padded row
// lands where it would on the domain's unpadded row: u < total.
//
// What the TPU kernel had to do and this one does not.  The TPU runs a
// (rows, 128) tile in lockstep at ONE scalar ladder level, so lanes of
// domains with different top levels share a "vartop" ladder that descends
// from the largest top and lets each lane join at its own.  Here every
// thread runs its own ladder from its own domain's top: a lane's draws are
// a function of (id, level, counter[level]) alone, so the results are the
// same, and no lane pays for another domain's depth.  The per-lane counter
// array holds max_top + 1 <= 31 levels; B1's body zeroes the levels it
// uses for every replica slot, so each (id, domain) stream starts fresh as
// the reference's does.
//
// What bounds it on an H100.  Per id it reads 4 bytes and writes 8 * R.
// The work is one B2 pass over the domain table plus R B1 passes, ~20
// int32 operations per consulted ladder level, so the kernel is
// operation-bound, like B1 and B2; its dependent hash chains need many
// resident warps.  The tables of a 64 x 64-node hierarchy (a
// ~5,100-segment domain table, top level ~12, and 64 rows of 128 stacked
// entries, ~150 KB over the six arrays the draws read) stay in L1 / L2
// and are read through __ldg.  A per-lane counter array indexed by a
// run-time level lives in local memory (a 128-byte stack frame) and is
// read and written on every consulted level; here the counters of the top
// kTopCounters levels sit in registers (port_lane::TopLadder), which serve
// all but ~2**-kTopCounters of the consults, and only the deeper levels
// stay in the local array.  Keeping all of them in registers (16 or 32)
// or staging the tables in shared memory per persistent block both cost
// more resident warps than they save, on every hierarchy measured
// (PERF.md).  R <= 8 keeps the level-1 slots in registers; larger R keeps
// them in the lane's scratch rows, as B2 does.

#include <cstdint>
#include <cuda_runtime.h>

#include "asura_lane.cuh"

namespace {

using port_hash::fmix32;
using port_hash::kGolden;
using port_lane::kMaxLevels;
using port_lane::place_lane_with;
using port_lane::place_replicas_lane_with;
using port_lane::TopLadder;

constexpr int kThreads = 256;
constexpr int kTopCounters = 6;  // ladder counters kept in registers
using Ladder = TopLadder<kTopCounters>;

// The eight tables, in the operand order of the reference kernel (read
// only; level 1 and level 2 read them through __ldg).
struct HierTables {
  const uint32_t* top_len32;
  const int32_t* top_slot_of;
  const uint32_t* dom_len32;
  const int32_t* dom_node;
  const uint32_t* dom_cum_hi;
  const uint32_t* dom_cum_lo;
  const int32_t* dom_top;
  const int32_t* dom_ids;
};

// Level 2 of one replica slot: (domain id, node id), or (-1, -1) for an
// unfilled slot.
__device__ __forceinline__ void place_in_domain(uint32_t id, int32_t slot,
                                                const HierTables& t, Ladder& ladder,
                                                int s_pad, int s_log2, int max_draws,
                                                int32_t& did, int32_t& node) {
  if (slot < 0) {
    did = -1;
    node = -1;
    return;
  }
  did = __ldg(t.dom_ids + slot);
  const int top = __ldg(t.dom_top + slot);
  const uint32_t salted = fmix32(id ^ (static_cast<uint32_t>(did) * kGolden));
  const int64_t base = static_cast<int64_t>(slot) * s_pad;
  node = place_lane_with<true>(salted, ladder, t.dom_len32 + base,
                                    t.dom_cum_hi + base, t.dom_cum_lo + base,
                                    t.dom_node + base, s_pad, top, s_log2, max_draws, 1);
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
hier_replicas_kernel(const uint32_t* __restrict__ ids, HierTables t,
                     int32_t* __restrict__ out, int32_t* __restrict__ segs_buf,
                     int32_t* __restrict__ slots_buf, int64_t n, int n_segs_top,
                     int top_level, int s_pad, int s_log2, int max_draws, int R) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t id = ids[i];
  uint32_t deep[kMaxLevels];  // the counters below the top kTopCounters levels
  Ladder ladder;
  ladder.deep = deep;
  int32_t* dom_out = out;
  int32_t* node_out = out + static_cast<int64_t>(R) * n;
  if constexpr (RMAX > 0) {
    int32_t slots[RMAX];
    place_replicas_lane_with<RMAX>(id, ladder, t.top_len32, t.top_slot_of,
                                        n_segs_top, top_level, s_log2, max_draws, R, 1,
                                        slots, nullptr, nullptr);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        int32_t did, node;
        place_in_domain(id, slots[r], t, ladder, s_pad, s_log2, max_draws, did, node);
        dom_out[r * n + i] = did;
        node_out[r * n + i] = node;
      }
    }
  } else {
    int32_t* slots = slots_buf + i * R;  // the lane's scratch rows
    place_replicas_lane_with<0>(id, ladder, t.top_len32, t.top_slot_of, n_segs_top,
                                     top_level, s_log2, max_draws, R, 1, slots,
                                     segs_buf + i * R, slots);
    for (int r = 0; r < R; ++r) {
      int32_t did, node;
      place_in_domain(id, slots[r], t, ladder, s_pad, s_log2, max_draws, did, node);
      dom_out[r * n + i] = did;
      node_out[r * n + i] = node;
    }
  }
}

}  // namespace

// out: (2, R, n) int32.  segs_buf / slots_buf: (n, R) int32 scratch, used
// (and required) only when R > 8.
extern "C" int hier_place_replicas(const void* ids, const void* top_len32,
                                   const void* top_slot_of, const void* dom_len32,
                                   const void* dom_node, const void* dom_cum_hi,
                                   const void* dom_cum_lo, const void* dom_top,
                                   const void* dom_ids, void* out, void* segs_buf,
                                   void* slots_buf, int64_t n, int n_segs_top,
                                   int top_level, int s_pad, int s_log2,
                                   int max_draws, int R, void* stream) {
  const HierTables t{
      static_cast<const uint32_t*>(top_len32), static_cast<const int32_t*>(top_slot_of),
      static_cast<const uint32_t*>(dom_len32), static_cast<const int32_t*>(dom_node),
      static_cast<const uint32_t*>(dom_cum_hi), static_cast<const uint32_t*>(dom_cum_lo),
      static_cast<const int32_t*>(dom_top), static_cast<const int32_t*>(dom_ids)};
  const dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const uint32_t*>(ids);
  auto* o = static_cast<int32_t*>(out);
  auto* sb = static_cast<int32_t*>(segs_buf);
  auto* lb = static_cast<int32_t*>(slots_buf);
#define HIER_REPLICAS(RM)                                                    \
  hier_replicas_kernel<RM><<<grid, kThreads, 0, s>>>(                        \
      i, t, o, sb, lb, n, n_segs_top, top_level, s_pad, s_log2, max_draws, R)
  if (R <= 1) {
    HIER_REPLICAS(1);
  } else if (R <= 2) {
    HIER_REPLICAS(2);
  } else if (R <= 4) {
    HIER_REPLICAS(4);
  } else if (R <= 8) {
    HIER_REPLICAS(8);
  } else {
    HIER_REPLICAS(0);
  }
#undef HIER_REPLICAS
  return static_cast<int>(cudaGetLastError());
}
