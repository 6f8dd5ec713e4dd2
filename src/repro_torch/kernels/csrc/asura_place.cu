// ASURA STEP 2 on Hopper: one thread per datum id.
//
// Replaces five TPU kernels of the reference's kernels/asura_place.py:
//   * asura_place          <- place_pallas (body _place_kernel): the
//       bounded draw loop alone -- segments, -1 for a lane that did not
//       converge within max_draws draws (no tail, no gather; B1's body
//       with both compiled out);
//   * asura_place_fused    <- place_fused_pallas (body _place_total_tile):
//       total single placement -- bounded lazy-ladder draw loop, the
//       section 3.2 tail on chip (a level top+1 draw, the 95-bit product,
//       a side="right" search over the u64 length cumsum), optional
//       seg->node gather;
//   * asura_place_replicas <- place_replicas_pallas (body
//       _place_replicas_tile): section 5.A, the first R hits on distinct
//       nodes within max_draws * max(1, R) draws, -1 for unfilled slots,
//       optional node output and the [depth_hist..., nonconverged] stats
//       vector the serving path folds into its metrics slab;
//   * asura_diff_nodes     <- diff_nodes_pallas (body _diff_kernel): B1's
//       total placement against table A (version v) and table B (v+1) ->
//       (2, n) nodes, the migration planner's (src, dst);
//   * asura_diff_replicas  <- diff_replicas_pallas (body
//       _diff_replicas_kernel): B2's replica placement the same way ->
//       (2, n, R) replica-node sets;
//   * asura_diff_replicas_aligned <- the same, with the reference's
//       per-slot alignment of the two sets (_align_replica_sets, jnp
//       outside its kernels) as the launch's epilogue -> (moved, src,
//       dst, src_slot), each (n, R): the sets never reach memory.
//
// And one kernel with no TPU counterpart:
//   * asura_addition_numbers: the section 2.D ADDITION NUMBER of each id,
//       the minimum unused anterior ASURA number of its R-replica trace
//       (the twin of the reference's jnp addition_numbers_ref,
//       kernels/ref.py, which has no Pallas kernel).  The migration
//       planner's add-node prefilter runs it over every tracked id, so
//       only ids whose number is at or below the new segments pay the
//       two-version diff; as plain torch it read its count of lanes still
//       tracing on every draw, a host sync per draw.  It is B2's draw
//       loop with the min-key compare of every unused draw added, on the
//       table's ladder extended by up to four levels (the top may reach
//       30), one int32 out per id (AdditionNumberTrace in asura_lane.cuh).
//
// The two tables of a diff differ in length (an add appends segments, a
// removal leaves length-0 holes) and may differ in top level.  The
// reference places each id twice, with fresh counters per table; here
// one walk of the deeper ladder serves both tables (diff_nodes_lane_with,
// diff_replicas_lane_with in asura_lane.cuh: the numbers of the shallower
// table are the deeper walk's numbers that reach its top), so a diff
// hashes one walk of the deeper ladder, until both tables are done.  Its
// counters keep the top few levels in registers.
//
// What bounds it on an H100.  Per id the kernel moves 8 bytes (a u32 id
// in, an i32 out; 4 * R out for replicas) plus table gathers that hit
// L1/L2 (a 4096-node table is ~28 KB per array), and does about two
// consulted ladder levels per draw, at ~1.5 draws per placement on a
// half-full table: each consult one fmix32 and the counter mixing (~11
// int32 ALU ops) once the lane holds that level's seed, and each distinct
// level's seed one more fmix32 (~9; ~2.4 distinct levels per id at R = 1).
// That is ~50 int32 ops against 8 bytes: at 16.7 T int32 ops/s against
// 3.35 TB/s the ALU bound is ~2x the memory bound, so the kernel is
// operation-bound and the ids stream through once.  B4 with its alignment
// epilogue is too: ~207 int32 ops of walk per id at R = 3 on the
// 10,000-node tables, plus the epilogue's ~2R^2 compares, against 4 B in
// and 13R B out per id (moved 1 B, src, dst and src_slot 4 B each).
//
// The lane bodies live in asura_lane.cuh, shared with hierarchy.cu (B8).
//
// What the design does about it.  The TPU kernels run a (rows, 128)
// tile in lockstep: every lane pays every draw until the slowest lane of
// the tile hits, and every ladder level until the deepest lane exits.
// Here each thread runs its own lane's loop and stops at its own hit, so
// the work is the data's own (lanes' draws depend only on
// (id, level, counter[level]), so the results are unchanged).  Every
// kernel keeps the counters of the top few ladder levels in registers
// (TopLadder; the deeper levels' in a small local array), B1, B2 and B9
// also those levels' generator seeds, so a consult of them hashes once;
// tables are read through the read-only data cache.  R <= 8 keeps the
// picks in registers (three slots for R = 3, the deployments'
// replication); larger R keeps them in the lane's own rows of scratch
// buffers (B2) or of the output (B4), so R has no cap.
// B2's stats are read from its ladder after the loop (the draws of each
// depth: register differences for the top K depths, the deep array's
// for the rare deeper ones), the top K depths and the unfilled slots
// summed per warp (__reduce_add_sync) and added to a per-block shared
// histogram by one lane, the deeper depths by each lane; the block's
// histogram is flushed with one u32 atomicAdd per bin.
// The ADDITION-NUMBER trace draws ~16x B2's numbers per id (77 at R = 3),
// 15 of 16 stopping in the levels above the table, where a walk that
// hashes as it descends runs ~6 levels' hashes per warp for the ~2 each
// lane needs.  It runs those levels level-major in rounds of 32 numbers
// (each level's draws for all its consulting numbers at once, the stops
// a bit mask) and walks B2's ladder only for the ~1 in 16 numbers that
// reach the table; its warps are persistent, and a lane whose id is done
// takes the warp's next one.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "asura_lane.cuh"

namespace {

using port_lane::DiffTable;
using port_lane::kMaxLevels;
using port_lane::place_lane_with;
using port_lane::place_replicas_lane_with;

constexpr int kDepthBins = 34;
constexpr int kThreads = 256;
// Ladder levels whose counters B3 / B4 keep in registers, each the
// fastest of K = 3 .. 8 on the card (PERF.md section 6)
constexpr int kDiffNodesTopCounters = 4;
constexpr int kDiffReplicasTopCounters = 6;
// B1 / B9's and B2's ladders: TopLadder<K, S>, K register levels'
// counters and the top S levels' seeds, each the fastest of the K and S
// swept on the card (PERF.md section 6)
using PlaceLadder = port_lane::TopLadder<6, 3>;
using ReplicasLadder = port_lane::TopLadder<6, 5>;
// The ADDITION-NUMBER trace (AdditionNumberTrace): numbers per round and
// the high levels it runs level-major at most, each the fastest of those
// swept on the card (PERF.md section 6); below the high levels it walks
// B2's ladder
constexpr int kAdditionRound = 32;
constexpr int kAdditionHigh = 3;

// B9: the bounded loop alone, -1 for a non-converged lane.
__global__ void __launch_bounds__(kThreads)
place_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ len32,
             int32_t* __restrict__ out, int64_t n, int n_segs, int top_level,
             int s_log2, int max_draws) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t deep[PlaceLadder::kDeep];
  PlaceLadder ladder;
  ladder.deep = deep;
  out[i] = place_lane_with<false>(ids[i], ladder, len32, nullptr, nullptr, nullptr,
                                  n_segs, top_level, s_log2, max_draws, 0);
}

__global__ void __launch_bounds__(kThreads)
place_fused_kernel(const uint32_t* __restrict__ ids,
                   const uint32_t* __restrict__ len32,
                   const uint32_t* __restrict__ cum_hi,
                   const uint32_t* __restrict__ cum_lo,
                   const int32_t* __restrict__ node_of,
                   int32_t* __restrict__ out, int64_t n, int n_segs,
                   int top_level, int s_log2, int max_draws, int emit_nodes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t deep[PlaceLadder::kDeep];
  PlaceLadder ladder;
  ladder.deep = deep;
  out[i] = place_lane_with<true>(ids[i], ladder, len32, cum_hi, cum_lo, node_of, n_segs,
                                 top_level, s_log2, max_draws, emit_nodes);
}

// B3: each id's node under table ``hi`` (the higher top) and ``lo`` in
// one walk; out_hi / out_lo are the rows of the (2, n) int32 output.
__global__ void __launch_bounds__(kThreads)
diff_nodes_kernel(const uint32_t* __restrict__ ids, DiffTable hi, DiffTable lo,
                  int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo,
                  int64_t n, int s_log2, int max_draws) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t deep[kMaxLevels];  // the counters below the register ones
  port_lane::TopLadder<kDiffNodesTopCounters> ladder;
  ladder.deep = deep;
  port_lane::diff_nodes_lane_with(ids[i], ladder, hi, lo, s_log2, max_draws,
                                  out_hi[i], out_lo[i]);
}

// B2.  With ``stats``, every lane takes part in the warp sums, also the
// lanes past n of the last block (with zeros): none returns early.
template <int RMAX>
__global__ void __launch_bounds__(kThreads)
place_replicas_kernel(const uint32_t* __restrict__ ids,
                      const uint32_t* __restrict__ len32,
                      const int32_t* __restrict__ node_of,
                      int32_t* __restrict__ out, int32_t* __restrict__ segs_buf,
                      int32_t* __restrict__ nodes_buf,
                      uint32_t* __restrict__ stats, int64_t n, int n_segs,
                      int top_level, int s_log2, int max_draws, int R,
                      int emit_nodes) {
  constexpr int K = ReplicasLadder::kTop;
  __shared__ uint32_t block_hist[kDepthBins + 1];
  if (stats != nullptr) {
    for (int b = threadIdx.x; b <= kDepthBins; b += blockDim.x) block_hist[b] = 0u;
    __syncthreads();
  }
  // the lane's draws of depth 1 .. K, then its unfilled slots
  uint32_t hot[K + 1] = {};
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t deep[ReplicasLadder::kDeep];
    ReplicasLadder ladder;
    ladder.deep = deep;
    const int found = place_replicas_lane_with<RMAX, int32_t>(
        ids[i], ladder, len32, node_of, n_segs, top_level, s_log2, max_draws, R,
        emit_nodes, out + i * R, RMAX == 0 ? segs_buf + i * R : nullptr,
        RMAX == 0 ? nodes_buf + i * R : nullptr);
    if (stats != nullptr) {
      ladder.depth_hist(top_level, hot, [&](int depth, uint32_t count) {
        atomicAdd(&block_hist[depth], count);
      });
      hot[K] = static_cast<uint32_t>(R - found);
    }
  }
  if (stats != nullptr) {
    // u32 sums wrap and commute: the vector is exact mod 2**32
#pragma unroll
    for (int b = 0; b <= K; ++b) {
      const uint32_t sum = __reduce_add_sync(0xFFFFFFFFu, hot[b]);
      if ((threadIdx.x & 31) == 0 && sum != 0u) {
        atomicAdd(&block_hist[b < K ? b + 1 : kDepthBins], sum);
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b <= kDepthBins; b += blockDim.x) {
      if (block_hist[b]) atomicAdd(stats + b, block_hist[b]);
    }
  }
}

// B4's alignment epilogue (ALIGN): the four (n, R) outputs of
// ops.align_replica_sets, each at row i * R, and where the sets live.
struct AlignedRows {
  uint8_t* moved;     // 0 / 1, read as torch.bool
  int32_t* src;
  int32_t* dst;       // the after set; R > 8 keeps it here during the walk
  int32_t* src_slot;
  int32_t* before;    // R > 8: the before sets' (n, R) scratch, else null
  bool hi_before;     // the table with the higher top is A (version v)
};

// One id's per-slot alignment, exactly as ops.align_replica_sets computes
// it on its before set b and after set a (R entries each, -1 for unfilled
// slots): slot r is new (moved) where a[r] is not in b; the k-th new slot,
// in slot order, takes the k-th lost before-slot (b[j] not in a) as its
// source and source slot, or 0 and 0 where there is none (the plain
// version's sum over no match); a slot not new is its own source.  Sets in
// registers (R <= RMAX <= 8): the lost slots as a bit mask, ~2R^2 compares.
template <int RMAX>
__device__ __forceinline__ void align_registers(const int32_t (&b)[RMAX],
                                                const int32_t (&a)[RMAX], int R,
                                                const AlignedRows& al, int64_t row) {
  uint32_t lost = 0u;
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    bool held = false;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) held |= r < R && a[r] == b[j];
    if (j < R && !held) lost |= 1u << j;
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {
      bool held = false;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) held |= j < R && b[j] == a[r];
      int32_t src = a[r], slot = r;
      if (!held) {
        src = 0;
        slot = 0;
        if (lost != 0u) {
          slot = __ffs(lost) - 1;
          lost &= lost - 1u;
#pragma unroll
          for (int j = 0; j < RMAX; ++j) {
            if (j == slot) src = b[j];
          }
        }
      }
      al.moved[row + r] = held ? 0 : 1;
      al.src[row + r] = src;
      al.dst[row + r] = a[r];
      al.src_slot[row + r] = slot;
    }
  }
}

// The same for sets in rows (R > 8): ``a`` is dst's row, which holds it
// already; the lost slots are found in order as the new slots need them.
__device__ __forceinline__ void align_rows(const int32_t* b, const int32_t* a, int R,
                                           const AlignedRows& al, int64_t row) {
  int next = 0;  // the first before-slot not yet tested for lost
  for (int r = 0; r < R; ++r) {
    bool held = false;
    for (int j = 0; j < R && !held; ++j) held = b[j] == a[r];
    int32_t src = a[r], slot = r;
    if (!held) {
      src = 0;
      slot = 0;
      for (; next < R; ++next) {
        bool kept = false;
        for (int k = 0; k < R && !kept; ++k) kept = a[k] == b[next];
        if (!kept) {
          src = b[next];
          slot = next++;
          break;
        }
      }
    }
    al.moved[row + r] = held ? 0 : 1;
    al.src[row + r] = src;
    al.src_slot[row + r] = slot;
  }
}

// B4: each id's R-replica node set under ``hi`` and ``lo`` in one walk.
// Without ALIGN out_hi / out_lo are the (n, R) halves of the (2, n, R)
// int32 output; RMAX > 0 keeps both sets in registers, RMAX == 0 (R > 8)
// in the lane's own output rows.  With ALIGN the sets go to no memory of
// their own: the epilogue writes their per-slot alignment (``al``) from
// the registers, or for R > 8 from the rows of dst (after) and the
// scratch (before).
template <int RMAX, bool ALIGN>
__global__ void __launch_bounds__(kThreads)
diff_replicas_kernel(const uint32_t* __restrict__ ids, DiffTable hi, DiffTable lo,
                     int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo,
                     AlignedRows al, int64_t n, int s_log2, int max_draws, int R) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t deep[kMaxLevels];
  port_lane::TopLadder<kDiffReplicasTopCounters> ladder;
  ladder.deep = deep;
  if constexpr (!ALIGN) {
    port_lane::diff_replicas_lane_with<RMAX>(ids[i], ladder, hi, lo, s_log2, max_draws,
                                             R, out_hi + i * R, out_lo + i * R);
  } else {
    const int64_t row = i * R;
    int32_t* const b_row = RMAX == 0 ? al.before + row : nullptr;
    int32_t* const a_row = RMAX == 0 ? al.dst + row : nullptr;
    port_lane::NodeSet<RMAX> set_hi(al.hi_before ? b_row : a_row);
    port_lane::NodeSet<RMAX> set_lo(al.hi_before ? a_row : b_row);
    port_lane::diff_replicas_walk<RMAX>(ids[i], ladder, hi, lo, s_log2, max_draws, R,
                                        set_hi, set_lo);
    if constexpr (RMAX == 0) {
      set_hi.write(nullptr, R);  // -1 in the unfilled slots of both rows
      set_lo.write(nullptr, R);
      align_rows(b_row, a_row, R, al, row);
    } else {
      int32_t b[RMAX], a[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const int32_t h = r < set_hi.found ? set_hi.node[r] : -1;
        const int32_t l = r < set_lo.found ? set_lo.node[r] : -1;
        b[r] = al.hi_before ? h : l;
        a[r] = al.hi_before ? l : h;
      }
      align_registers<RMAX>(b, a, R, al, row);
    }
  }
}

// The ADDITION-NUMBER trace: each id's number, or -1.  Persistent warps:
// each warp owns ``per_warp`` ids from warp * per_warp on, and a lane
// whose trace is done writes its number and takes the warp's next id not
// yet taken, so no lane idles while another of its warp runs a long
// trace; the warp leaves when all its ids are done.  ``high``: the levels
// from top_level down that run level-major (the launcher's).
// RMAX > 0 keeps the picked nodes in registers; RMAX == 0 (R > 8) in the
// id's own row of the (n, R) scratch ``nodes_buf``.
template <int RMAX>
__global__ void __launch_bounds__(kThreads)
addition_numbers_kernel(const uint32_t* __restrict__ ids,
                        const uint32_t* __restrict__ len32,
                        const int32_t* __restrict__ node_of,
                        int32_t* __restrict__ out, int32_t* __restrict__ nodes_buf,
                        int64_t n, int64_t per_warp, int n_segs, int top_level, int high,
                        int s_log2, int max_draws, int R) {
  const int lane = threadIdx.x & 31;
  // the warp's ids: ids[first + a] for 0 <= a < count (per_warp < 2**31)
  const int64_t first = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
                        per_warp;
  const int count = first >= n ? 0 : static_cast<int>(n - first < per_warp ? n - first : per_warp);
  ids += first;
  out += first;
  int a = lane;
  bool live = a < count;
  uint32_t deep[ReplicasLadder::kDeep];
  port_lane::AdditionNumberTrace<RMAX, kAdditionRound, kAdditionHigh, ReplicasLadder> trace;
  trace.ladder.deep = deep;
  uint32_t id = 0u;
  auto take = [&] {
    id = ids[a];
    trace.reset(id, top_level, high, max_draws, R,
                RMAX == 0 ? nodes_buf + (first + a) * static_cast<int64_t>(R) : nullptr);
  };
  if (live) take();
  int next = 32;  // the warp's first id not yet taken
  const uint32_t below = (1u << lane) - 1u;
  while (__any_sync(0xFFFFFFFFu, live)) {
    if (live) {
      if (trace.tracing(R)) trace.round(id, len32, node_of, n_segs, top_level, high, s_log2, R);
      if (!trace.tracing(R)) {
        out[a] = trace.result(R, top_level, s_log2);
        live = false;
      }
    }
    const uint32_t free = __ballot_sync(0xFFFFFFFFu, !live);
    if (next < count && free != 0u) {  // the same on every lane of the warp
      if (!live) {
        a = next + __popc(free & below);
        live = a < count;
        if (live) take();
      }
      next += __popc(free);
    }
  }
}

template <int RMAX>
void launch_replicas(dim3 grid, cudaStream_t stream, const uint32_t* ids,
                     const uint32_t* len32, const int32_t* node_of, int32_t* out,
                     int32_t* segs_buf, int32_t* nodes_buf, uint32_t* stats,
                     int64_t n, int n_segs, int top_level, int s_log2,
                     int max_draws, int R, int emit_nodes) {
  place_replicas_kernel<RMAX><<<grid, kThreads, 0, stream>>>(
      ids, len32, node_of, out, segs_buf, nodes_buf, stats, n, n_segs,
      top_level, s_log2, max_draws, R, emit_nodes);
}

dim3 grid_for(int64_t n) {
  return dim3(static_cast<unsigned int>((n + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" int asura_place(const void* ids, const void* len32, void* out,
                           int64_t n, int n_segs, int top_level, int s_log2,
                           int max_draws, void* stream) {
  place_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(len32),
      static_cast<int32_t*>(out), n, n_segs, top_level, s_log2, max_draws);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int asura_place_fused(const void* ids, const void* len32,
                                 const void* cum_hi, const void* cum_lo,
                                 const void* node_of, void* out, int64_t n,
                                 int n_segs, int top_level, int s_log2,
                                 int max_draws, int emit_nodes, void* stream) {
  place_fused_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(len32),
      static_cast<const uint32_t*>(cum_hi), static_cast<const uint32_t*>(cum_lo),
      static_cast<const int32_t*>(node_of), static_cast<int32_t*>(out), n,
      n_segs, top_level, s_log2, max_draws, emit_nodes);
  return static_cast<int>(cudaGetLastError());
}

// segs_buf / nodes_buf: (n, R) int32 scratch, used (and required) only
// when R > 8.  stats: (DEPTH_BINS + 1,) zeroed u32 accumulator, or null.
extern "C" int asura_place_replicas(const void* ids, const void* len32,
                                    const void* node_of, void* out,
                                    void* segs_buf, void* nodes_buf, void* stats,
                                    int64_t n, int n_segs, int top_level,
                                    int s_log2, int max_draws, int R,
                                    int emit_nodes, void* stream) {
  const dim3 grid = grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const uint32_t*>(ids);
  auto* l = static_cast<const uint32_t*>(len32);
  auto* no = static_cast<const int32_t*>(node_of);
  auto* o = static_cast<int32_t*>(out);
  auto* sb = static_cast<int32_t*>(segs_buf);
  auto* nb = static_cast<int32_t*>(nodes_buf);
  auto* st = static_cast<uint32_t*>(stats);
  if (R <= 1) {
    launch_replicas<1>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  } else if (R <= 2) {
    launch_replicas<2>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  } else if (R <= 3) {  // the deployments' replication: sets of its own size
    launch_replicas<3>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  } else if (R <= 4) {
    launch_replicas<4>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  } else if (R <= 8) {
    launch_replicas<8>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  } else {
    launch_replicas<0>(grid, s, i, l, no, o, sb, nb, st, n, n_segs, top_level, s_log2, max_draws, R, emit_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The diff's two tables, the one with the higher top (A on a tie) first,
// and whether that is A.
static bool order_tables(const DiffTable& a, const DiffTable& b, DiffTable& hi,
                  DiffTable& lo) {
  const bool a_hi = a.top_level >= b.top_level;
  hi = a_hi ? a : b;
  lo = a_hi ? b : a;
  return a_hi;
}

extern "C" int asura_diff_nodes(const void* ids, const void* len32_a,
                                const void* cum_hi_a, const void* cum_lo_a,
                                const void* node_a, const void* len32_b,
                                const void* cum_hi_b, const void* cum_lo_b,
                                const void* node_b, void* out, int64_t n,
                                int n_segs_a, int n_segs_b, int top_a, int top_b,
                                int s_log2, int max_draws, void* stream) {
  const DiffTable a{static_cast<const uint32_t*>(len32_a),
                    static_cast<const uint32_t*>(cum_hi_a),
                    static_cast<const uint32_t*>(cum_lo_a),
                    static_cast<const int32_t*>(node_a), n_segs_a, top_a};
  const DiffTable b{static_cast<const uint32_t*>(len32_b),
                    static_cast<const uint32_t*>(cum_hi_b),
                    static_cast<const uint32_t*>(cum_lo_b),
                    static_cast<const int32_t*>(node_b), n_segs_b, top_b};
  DiffTable hi, lo;
  auto* row_a = static_cast<int32_t*>(out);
  auto* row_b = row_a + n;
  const bool a_hi = order_tables(a, b, hi, lo);
  diff_nodes_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), hi, lo, a_hi ? row_a : row_b,
      a_hi ? row_b : row_a, n, s_log2, max_draws);
  return static_cast<int>(cudaGetLastError());
}

// B4 on tables A and B, the higher top's walk leading: the sets to
// row_a / row_b (without ALIGN), or their alignment to ``al``.
template <bool ALIGN>
static int diff_replicas(const void* ids, const void* len32_a, const void* node_a,
                  const void* len32_b, const void* node_b, int32_t* row_a,
                  int32_t* row_b, AlignedRows al, int64_t n, int n_segs_a,
                  int n_segs_b, int top_a, int top_b, int s_log2, int max_draws,
                  int R, void* stream) {
  const dim3 grid = grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const uint32_t*>(ids);
  const DiffTable a{static_cast<const uint32_t*>(len32_a), nullptr, nullptr,
                    static_cast<const int32_t*>(node_a), n_segs_a, top_a};
  const DiffTable b{static_cast<const uint32_t*>(len32_b), nullptr, nullptr,
                    static_cast<const int32_t*>(node_b), n_segs_b, top_b};
  DiffTable hi, lo;
  const bool a_hi = order_tables(a, b, hi, lo);
  int32_t* o_hi = a_hi ? row_a : row_b;
  int32_t* o_lo = a_hi ? row_b : row_a;
  al.hi_before = a_hi;
#define ASURA_DIFF_REPLICAS(RM)                                                   \
  diff_replicas_kernel<RM, ALIGN><<<grid, kThreads, 0, s>>>(i, hi, lo, o_hi, o_lo, \
                                                            al, n, s_log2,        \
                                                            max_draws, R)
  // R = 3, the deployments' replication, gets sets of its own size: 7 %
  // faster than RMAX = 4 on the card (PERF.md section 6)
  if (R <= 1) {
    ASURA_DIFF_REPLICAS(1);
  } else if (R <= 2) {
    ASURA_DIFF_REPLICAS(2);
  } else if (R <= 3) {
    ASURA_DIFF_REPLICAS(3);
  } else if (R <= 4) {
    ASURA_DIFF_REPLICAS(4);
  } else if (R <= 8) {
    ASURA_DIFF_REPLICAS(8);
  } else {
    ASURA_DIFF_REPLICAS(0);
  }
#undef ASURA_DIFF_REPLICAS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int asura_diff_replicas(const void* ids, const void* len32_a,
                                   const void* node_a, const void* len32_b,
                                   const void* node_b, void* out, int64_t n,
                                   int n_segs_a, int n_segs_b, int top_a,
                                   int top_b, int s_log2, int max_draws, int R,
                                   void* stream) {
  auto* row_a = static_cast<int32_t*>(out);
  return diff_replicas<false>(ids, len32_a, node_a, len32_b, node_b, row_a, row_a + n * R,
                              AlignedRows{}, n, n_segs_a, n_segs_b, top_a, top_b, s_log2,
                              max_draws, R, stream);
}

// moved (n, R) uint8, src / dst / src_slot (n, R) int32; before_buf: (n, R)
// int32 scratch, used (and required) only when R > 8.
extern "C" int asura_diff_replicas_aligned(const void* ids, const void* len32_a,
                                           const void* node_a, const void* len32_b,
                                           const void* node_b, void* moved, void* src,
                                           void* dst, void* src_slot, void* before_buf,
                                           int64_t n, int n_segs_a, int n_segs_b,
                                           int top_a, int top_b, int s_log2,
                                           int max_draws, int R, void* stream) {
  const AlignedRows al{static_cast<uint8_t*>(moved), static_cast<int32_t*>(src),
                       static_cast<int32_t*>(dst), static_cast<int32_t*>(src_slot),
                       static_cast<int32_t*>(before_buf), false};
  return diff_replicas<true>(ids, len32_a, node_a, len32_b, node_b, nullptr, nullptr, al, n,
                             n_segs_a, n_segs_b, top_a, top_b, s_log2, max_draws, R, stream);
}

// The warps of addition_numbers_kernel<RMAX> the current device holds at
// once (SMs x resident blocks per SM x warps per block).  The queries
// behind it are host calls that cannot change between launches, so each
// (device, RMAX) asks them once; the plan's prefilter launches 16 times.
template <int RMAX>
cudaError_t addition_numbers_resident(int64_t& warps) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int64_t> cached[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (warps = cached[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, addition_numbers_kernel<RMAX>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  warps = static_cast<int64_t>(sms) * per_sm * (kThreads / 32);
  if (keep) cached[dev].store(warps, std::memory_order_relaxed);
  return cudaSuccess;
}

// nodes_buf: (n, R) int32 scratch, used (and required) only when R > 8.
extern "C" int asura_addition_numbers(const void* ids, const void* len32,
                                      const void* node_of, void* out,
                                      void* nodes_buf, int64_t n, int n_segs,
                                      int top_level, int s_log2, int max_draws,
                                      int R, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const uint32_t*>(ids);
  auto* l = static_cast<const uint32_t*>(len32);
  auto* no = static_cast<const int32_t*>(node_of);
  auto* o = static_cast<int32_t*>(out);
  auto* nb = static_cast<int32_t*>(nodes_buf);
  constexpr int kWarps = kThreads / 32;
  // the high levels: those whose numbers are misses past the table, as a
  // number stopping at level L >= 1 has k >= 2**(s_log2 + L - 1) >= n_segs
  int bits = 0;  // ceil(log2(n_segs))
  while ((int64_t{1} << bits) < n_segs) ++bits;
  const int low = bits - s_log2 + 1 > 1 ? bits - s_log2 + 1 : 1;  // the lowest high level
  int high = top_level - low + 1;
  high = high < 0 ? 0 : high > kAdditionHigh ? kAdditionHigh : high;
  auto launch = [&](auto rmax) -> cudaError_t {
    constexpr int RMAX = decltype(rmax)::value;
    // one id per lane, but no more warps than the card holds at once
    int64_t resident = 0;
    const cudaError_t err = addition_numbers_resident<RMAX>(resident);
    if (err != cudaSuccess) return err;
    const int64_t warps = (n + 31) / 32 < resident ? (n + 31) / 32 : resident;
    const int64_t per_warp = (n + warps - 1) / warps;
    if (per_warp > INT32_MAX - 64) return cudaErrorInvalidValue;  // a warp counts its ids in int
    const dim3 grid(static_cast<unsigned int>((warps + kWarps - 1) / kWarps));
    addition_numbers_kernel<RMAX><<<grid, kThreads, 0, s>>>(
        i, l, no, o, nb, n, per_warp, n_segs, top_level, high, s_log2, max_draws, R);
    return cudaGetLastError();
  };
  if (R <= 1) return static_cast<int>(launch(std::integral_constant<int, 1>{}));
  if (R <= 2) return static_cast<int>(launch(std::integral_constant<int, 2>{}));
  if (R <= 3) return static_cast<int>(launch(std::integral_constant<int, 3>{}));
  if (R <= 4) return static_cast<int>(launch(std::integral_constant<int, 4>{}));
  if (R <= 8) return static_cast<int>(launch(std::integral_constant<int, 8>{}));
  return static_cast<int>(launch(std::integral_constant<int, 0>{}));
}
