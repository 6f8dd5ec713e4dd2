// ASURA STEP 2's per-lane device functions, shared by every kernel that
// places one id per thread against a segment table: asura_place.cu (B1-B4,
// B9 and the ADDITION-NUMBER trace) and hierarchy.cu (B8, whose level 1 is
// B2's body and whose level 2 is B1's).  kernels/build.py hashes this
// header with every source that includes it.
//
// The bodies take the ladder's counters as a policy, TopLadder<K, S>: the
// top K levels' counters in registers, the deeper ones in the caller's
// local array.  B1, B2 and B9 also keep the top S levels' generator seeds
// (S > 0); B3, B4 and B8 hash every consult's seed anew (S = 0).  The
// ADDITION-NUMBER trace runs the levels above the table level-major and
// walks B2's ladder below them, in rounds, so that its lanes can take a
// new id when theirs is done.

#pragma once

#include <cstdint>

#include "hash.cuh"

namespace port_lane {

using port_hash::draw_seeded;
using port_hash::draw_u32;
using port_hash::level_seed;

// Ladder levels a lane may use: top_level + 1 <= 31 (the wrappers check
// s_log2 + top_level <= 31 with s_log2 >= 1).
constexpr int kMaxLevels = 32;

// k = floor, f = fraction * 2**32 of the ASURA number drawn at ``level``.
__device__ __forceinline__ void split(uint32_t h, int level, int s_log2,
                                      uint32_t& k, uint32_t& f) {
  k = h >> (32 - s_log2 - level);
  f = h << (s_log2 + level);
}

// The counters of the top K levels in registers, c[j] for level
// top_level - j, and those of the deeper levels in the caller's array
// ``deep`` (indexed by level), zeroed lazily: the descent reaches level
// top_level - j with probability 2**-j per draw, so the registers serve
// all but ~2**-K of the consults, and a ladder no deeper than K never
// touches ``deep``.  The descent visits top, top - 1, ... in order, so a
// fully unrolled loop reaches each register counter by a compile-time
// index.
//
// S > 0 also keeps the top S levels' seeds (level_seed(id, top_level - j),
// a function of the id and the level alone) in registers, hashed at the
// reset, so that a consult of one of them hashes once, not twice: a lane
// consults few distinct levels many times (~9.6 consults of ~3.7 levels
// per id at R = 3 on the 4096-node table).  Hashing each seed at its
// first consult instead costs a divergent test per consult and lost on
// the card (PERF.md section 6).
template <int K, int S = 0>
struct TopLadder {
  static_assert(0 <= S && S <= K, "seeds are kept for register levels only");
  static constexpr int kTop = K;
  // entries of ``deep`` a caller provides: levels <= top_level - K <= 30 - K
  static constexpr int kDeep = kMaxLevels - K;

  uint32_t c[K];
  uint32_t seed[S > 0 ? S : 1];
  uint32_t* deep;
  int fresh;  // deep levels >= fresh were zeroed since the reset

  __device__ __forceinline__ void reset(uint32_t id, int top_level) {
#pragma unroll
    for (int j = 0; j < K; ++j) c[j] = 0u;
#pragma unroll
    for (int j = 0; j < S; ++j) seed[j] = level_seed(id, top_level - j);
    fresh = top_level - K + 1;
  }

  // The draw of register level j (``level`` = top_level - j; j is a
  // compile-time index once the walk is unrolled).
  __device__ __forceinline__ uint32_t draw_top(uint32_t id, int j, int level) {
    if constexpr (S > 0) {
      if (j < S) return draw_seeded(seed[j], c[j]);
    }
    return draw_u32(id, level, c[j]);
  }

  // One ASURA number: descend from top_level while the draw's MSB is
  // clear -> the level it stopped at, its draw in ``h``.
  __device__ __forceinline__ int walk(uint32_t id, int top_level, uint32_t& h) {
    int level = top_level;
    bool done = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      level = top_level - j;
      h = draw_top(id, j, level);
      c[j] += 1u;
      if (level == 0 || h >= 0x80000000u) {
        done = true;
        break;
      }
    }
    if (!done) {  // level = top_level - K + 1 > 0 and h's MSB is clear
      do {
        --level;
        if (level < fresh) {
          deep[level] = 0u;
          fresh = level;
        }
        h = draw_u32(id, level, deep[level]);
        deep[level] += 1u;
      } while (level > 0 && h < 0x80000000u);
    }
    return level;
  }

  __device__ __forceinline__ void next(uint32_t id, int top_level, int s_log2,
                                       uint32_t& k, uint32_t& f) {
    uint32_t h;
    const int level = walk(id, top_level, h);
    split(h, level, s_log2, k, f);
  }

  // The lane's draws since the reset by depth d = top_level - level + 1
  // (a draw of depth d consulted levels top_level .. top_level - d + 1,
  // so c[j] counts the draws of depth > j): depths 1 .. K into
  // hot[0 .. K-1] from the register counters at compile-time indices, and
  // each deeper depth with a nonzero count passed to deep_bin(d, count).
  // Levels below ``fresh`` were never consulted since the reset.
  template <class DeepBin>
  __device__ __forceinline__ void depth_hist(int top_level, uint32_t* hot,
                                             DeepBin&& deep_bin) const {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) hot[j] = c[j] - c[j + 1];
    int level = top_level - K;  // the highest deep level
    hot[K - 1] = c[K - 1] - (level >= fresh ? deep[level] : 0u);
    for (; level >= fresh; --level) {
      const uint32_t here = deep[level] - (level > fresh ? deep[level - 1] : 0u);
      if (here) deep_bin(top_level - level + 1, here);
    }
  }
};

__device__ __forceinline__ bool hits(uint32_t k, uint32_t f, int n_segs,
                                     const uint32_t* __restrict__ len32) {
  return k < static_cast<uint32_t>(n_segs) && f < __ldg(len32 + k);
}

// searchsorted(cum, u, side="right") over the u64 cumsum halves.
static __device__ int resolve_tail(uint32_t id, int top_level, int n_segs,
                                   const uint32_t* __restrict__ cum_hi,
                                   const uint32_t* __restrict__ cum_lo) {
  const uint64_t h = draw_u32(id, top_level + 1, 0u);
  const uint64_t total = (static_cast<uint64_t>(__ldg(cum_hi + n_segs - 1)) << 32) |
                         __ldg(cum_lo + n_segs - 1);
  const uint64_t u = h * (total >> 32) + ((h * (total & 0xFFFFFFFFull)) >> 32);
  int lo = 0, hi = n_segs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint64_t c = (static_cast<uint64_t>(__ldg(cum_hi + mid)) << 32) |
                       __ldg(cum_lo + mid);
    if (c <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The bounded draw loop against one table.  kTotal (B1's body): a lane
// that did not hit within max_draws draws is resolved on chip by the tail,
// and with ``emit_nodes`` the segment goes through the seg->node gather.
// !kTotal (B9's body): no tail and no gather -- the segment, or -1 for a
// lane that did not converge.  The ladder's counters are zeroed here, so
// a second call restarts the stream.
template <bool kTotal, class Ladder>
__device__ __forceinline__ int32_t place_lane_with(
    uint32_t id, Ladder& ladder, const uint32_t* __restrict__ len32,
    const uint32_t* __restrict__ cum_hi, const uint32_t* __restrict__ cum_lo,
    const int32_t* __restrict__ node_of, int n_segs, int top_level, int s_log2,
    int max_draws, int emit_nodes) {
  ladder.reset(id, top_level);
  int seg = -1;
  for (int d = 0; d < max_draws; ++d) {
    uint32_t k, f;
    ladder.next(id, top_level, s_log2, k, f);
    if (hits(k, f, n_segs, len32)) {
      seg = static_cast<int>(k);
      break;
    }
  }
  if constexpr (!kTotal) {
    return seg;
  } else {
    if (seg < 0) seg = resolve_tail(id, top_level, n_segs, cum_hi, cum_lo);
    return emit_nodes ? __ldg(node_of + seg) : seg;
  }
}

// B2's per-lane body: the first R hits on distinct nodes within
// max_draws * max(1, R) draws, written to ``row`` (R entries, -1 for
// unfilled slots; segments, or nodes with ``emit_nodes``).  Returns the
// number of slots filled; the ladder's counters are zeroed here and left
// holding the lane's per-level draw counts.
// RMAX > 0: picked (segment, node) pairs in registers (R <= RMAX).
// RMAX == 0: kept in the lane's scratch rows ``gseg`` / ``gnode`` (any R);
// ``row`` may be ``gnode`` itself when nodes are emitted.
// Count: the draw loop's counter type; int32_t (B2) needs the wrapper's
// check max_draws * R < 2**31, int64_t (B8) counts any cap.
template <int RMAX, class Count = int64_t, class Ladder>
__device__ __forceinline__ int place_replicas_lane_with(
    uint32_t id, Ladder& ladder, const uint32_t* __restrict__ len32,
    const int32_t* __restrict__ node_of, int n_segs, int top_level, int s_log2,
    int max_draws, int R, int emit_nodes, int32_t* row, int32_t* gseg,
    int32_t* gnode) {
  ladder.reset(id, top_level);
  int32_t rseg[RMAX > 0 ? RMAX : 1];
  int32_t rnode[RMAX > 0 ? RMAX : 1];
#pragma unroll
  for (int r = 0; r < (RMAX > 0 ? RMAX : 1); ++r) rseg[r] = rnode[r] = -1;
  int found = 0;
  const Count cap = static_cast<Count>(max_draws) * (R > 1 ? R : 1);
  for (Count d = 0; d < cap && found < R; ++d) {
    uint32_t k, f;
    ladder.next(id, top_level, s_log2, k, f);
    if (!hits(k, f, n_segs, len32)) continue;
    const int32_t node = __ldg(node_of + k);
    bool dup = false;
    if constexpr (RMAX > 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dup |= (r < found) && (rnode[r] == node);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (!dup && r == found) {
          rseg[r] = static_cast<int32_t>(k);
          rnode[r] = node;
        }
      }
    } else {
      for (int r = 0; r < found && !dup; ++r) dup = gnode[r] == node;
      if (!dup) {
        gseg[found] = static_cast<int32_t>(k);
        gnode[found] = node;
      }
    }
    if (!dup) ++found;
  }
  if constexpr (RMAX > 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) row[r] = r < found ? (emit_nodes ? rnode[r] : rseg[r]) : -1;
    }
  } else {
    const int32_t* src = emit_nodes ? gnode : gseg;
    for (int r = 0; r < R; ++r) row[r] = r < found ? src[r] : -1;
  }
  return found;
}

// One table of a two-version diff: its length table, u64 length-cumsum
// halves (B3's tail; null for B4), seg->node map, length and top level.
struct DiffTable {
  const uint32_t* len32;
  const uint32_t* cum_hi;
  const uint32_t* cum_lo;
  const int32_t* node_of;
  int n_segs;
  int top_level;
};

// B3's per-lane body: B1's total placement, nodes out, against both
// tables of a diff in ONE walk of the deeper ladder.  A draw depends only
// on (id, level, counter[level]) and both tables' walks start from zeroed
// counters, so of the numbers drawn from the higher top (table ``hi``),
// those that reach a level <= the lower top (table ``lo``) are lo's own
// numbers, in order, and those that stop above it are hi's alone.  Each
// table tests and counts only its own numbers against max_draws and keeps
// its own hit, tail and gather, so both nodes are bit for bit what two
// walks give.  Equal tops (a deployment's add or removal) make it one walk
// with two hit tests.  Every number starts at hi's top, also once hi is
// done: resuming at lo's top then is exact too (the counters at and below
// it are lo's own), but the start it has to select per number cost more
// than the draws it saves (PERF.md section 6).
template <class Ladder>
__device__ __forceinline__ void diff_nodes_lane_with(
    uint32_t id, Ladder& ladder, const DiffTable& hi, const DiffTable& lo,
    int s_log2, int max_draws, int32_t& node_hi, int32_t& node_lo) {
  ladder.reset(id, hi.top_level);
  int seg_hi = -1, seg_lo = -1;
  int left_hi = max_draws, left_lo = max_draws;  // numbers each may still test
  while (left_hi > 0 || left_lo > 0) {
    uint32_t h, k, f;
    const int level = ladder.walk(id, hi.top_level, h);
    split(h, level, s_log2, k, f);
    if (left_hi > 0) {
      --left_hi;
      if (hits(k, f, hi.n_segs, hi.len32)) {
        seg_hi = static_cast<int>(k);
        left_hi = 0;
      }
    }
    if (left_lo > 0 && level <= lo.top_level) {
      --left_lo;
      if (hits(k, f, lo.n_segs, lo.len32)) {
        seg_lo = static_cast<int>(k);
        left_lo = 0;
      }
    }
  }
  if (seg_hi < 0) seg_hi = resolve_tail(id, hi.top_level, hi.n_segs, hi.cum_hi, hi.cum_lo);
  if (seg_lo < 0) seg_lo = resolve_tail(id, lo.top_level, lo.n_segs, lo.cum_hi, lo.cum_lo);
  node_hi = __ldg(hi.node_of + seg_hi);
  node_lo = __ldg(lo.node_of + seg_lo);
}

// The distinct nodes a lane has picked, in pick order, for its R-entry
// output row.  RMAX > 0: in registers (R <= RMAX), written to the row at
// the end (the row is not kept in the set: holding it cost B4 2 % on the
// card, PERF.md section 6).
template <int RMAX>
struct NodeSet {
  int32_t node[RMAX];
  int found;

  __device__ __forceinline__ explicit NodeSet(int32_t*) : found(0) {}

  // Adds ``n`` unless it is held already -> the number held.
  __device__ __forceinline__ int add(int32_t n) {
    bool dup = false;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) dup |= (r < found) && (node[r] == n);
    if (!dup) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r == found) node[r] = n;
      }
      ++found;
    }
    return found;
  }

  // The row's R entries, -1 for unfilled slots.
  __device__ __forceinline__ void write(int32_t* row, int R) const {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) row[r] = r < found ? node[r] : -1;
    }
  }
};

// Any R: the picks live in the output row itself, which the dedup scans.
template <>
struct NodeSet<0> {
  int32_t* row;
  int found;

  __device__ __forceinline__ explicit NodeSet(int32_t* out_row) : row(out_row), found(0) {}

  __device__ __forceinline__ int add(int32_t n) {
    for (int r = 0; r < found; ++r) {
      if (row[r] == n) return found;
    }
    row[found] = n;
    return ++found;
  }

  __device__ __forceinline__ void write(int32_t*, int R) const {
    for (int r = found; r < R; ++r) row[r] = -1;
  }
};

// The ADDITION-NUMBER trace of one id (section 2.D), in rounds of up to
// kRound numbers, so that a lane whose id is done can take the next id
// while its warp goes on: B2's draw loop for the first R hits on distinct
// nodes within max_draws * max(1, R) draws, keeping the lexicographic
// minimum (k, f), f unsigned, of the lane's UNUSED draws -- a miss past
// the table, a miss inside a segment, or a hit on a node already picked.
// The cap counts every draw, hits or not, and the trace ends once it holds
// R nodes (the reference's lanes freeze there).  result() is that
// minimum's k, or -1 where the trace did not fill R slots or had no unused
// draw.  The sentinel (0x7FFFFFFF, 0) is the reference's: k < 2**31
// always, so only k = 0x7FFFFFFF is never kept.
//
// The trace's ladder starts up to four levels above the table's top, so
// ~15 of 16 numbers stop in those levels, where every number is a miss
// past the table: a number that stops at level L has k >= 2**(s + L - 1),
// and the launcher takes as such "high" levels (at most kHigh) those with
// 2**(s + L - 1) >= n_segs.  A walk that hashes as it descends pays each
// level's hash for the whole warp whenever one lane needs it, ~6 levels
// where a lane needs ~2.  Here the high levels run level-major: a round
// hashes the top level's next draws for all its numbers at once, and each
// level below the draws of the numbers that did not stop above it (the
// j-th draw of a level goes to its j-th consulting number, as in the walk),
// keeping each level's stops as a bit mask.  Only the numbers that pass
// every high level walk the ladder below (``ladder``, B2's, from the
// first level under them) and are tested against the table, in order.
// The counters are the walk's, so every draw is unchanged.  A high-level
// number is never used and its key exceeds every key of a lower level, so
// the high numbers only decide the minimum where no unused number reached
// the walk, and there by the lowest high level with a stop (within one
// level the draws' order is the keys').  A trace that ends inside a round
// keeps only the stops before the number that ended it, counted through
// the masks.  RMAX > 0: the picked nodes in registers (R <= RMAX); RMAX ==
// 0: in the id's R-entry scratch row ``gnode``.
template <int RMAX, int kRound, int kHigh, class Ladder>
struct AdditionNumberTrace {
  static_assert(1 <= kRound && kRound <= 32, "a round's stops are a 32-bit mask");
  static constexpr uint32_t kNoK = 0x7FFFFFFFu;

  uint32_t seed[kHigh > 0 ? kHigh : 1];  // high level top_level - i
  uint32_t c[kHigh > 0 ? kHigh : 1];     // its counter
  Ladder ladder;                         // the walk from top_level - high
  NodeSet<RMAX> set;
  uint32_t min_k, min_f;  // the minimum unused number that reached the walk
  int high_i;             // the lowest high level with a stop (index i), or -1
  uint32_t high_h;        // the least draw of a stop there
  int left;               // draws left under the cap

  __device__ __forceinline__ AdditionNumberTrace() : set(nullptr) {}

  __device__ __forceinline__ void reset(uint32_t id, int top_level, int high, int max_draws,
                                        int R, int32_t* gnode) {
#pragma unroll
    for (int i = 0; i < kHigh; ++i) {
      if (i < high) seed[i] = level_seed(id, top_level - i);
      c[i] = 0u;
    }
    ladder.reset(id, top_level - high);
    set = NodeSet<RMAX>(gnode);
    min_k = kNoK;
    min_f = 0u;
    high_i = -1;
    high_h = 0u;
    left = max_draws * (R > 1 ? R : 1);  // < 2**31: the wrapper checks
  }

  __device__ __forceinline__ bool tracing(int R) const { return left > 0 && set.found < R; }

  // A stop at high level i with draw h, if it is below the minimum's.
  __device__ __forceinline__ void keep_high(int i, uint32_t h) {
    if (i > high_i || (i == high_i && h < high_h)) {
      high_i = i;
      high_h = h;
    }
  }

  __device__ __forceinline__ void round(uint32_t id, const uint32_t* __restrict__ len32,
                                        const int32_t* __restrict__ node_of, int n_segs,
                                        int top_level, int high, int s_log2, int R) {
    const int n = left < kRound ? left : kRound;
    uint32_t stops[kHigh > 0 ? kHigh : 1];  // bit j: level i's j-th draw stopped its number
    uint32_t least[kHigh > 0 ? kHigh : 1];  // the least of those draws
    int consults[kHigh > 0 ? kHigh : 1];    // numbers consulting level i
    int reach = n;                          // numbers passing the levels so far
#pragma unroll
    for (int i = 0; i < kHigh; ++i) {
      stops[i] = 0u;
      least[i] = ~0u;
      consults[i] = 0;
      if (i < high) {
        consults[i] = reach;
        for (int j = 0; j < reach; ++j) {
          const uint32_t h = draw_seeded(seed[i], c[i] + static_cast<uint32_t>(j));
          if (h >= 0x80000000u) {
            stops[i] |= 1u << j;
            least[i] = h < least[i] ? h : least[i];
          }
        }
        c[i] += static_cast<uint32_t>(reach);
        reach -= __popc(stops[i]);
      }
    }
    // the numbers that passed every high level, in order
    const int walk_top = top_level - high;
    int t = 0;
    for (; t < reach; ++t) {
      uint32_t k, f;
      ladder.next(id, walk_top, s_log2, k, f);
      bool used = false;
      if (hits(k, f, n_segs, len32)) {
        const int held = set.found;
        used = set.add(__ldg(node_of + k)) > held;
      }
      if (!used && (k < min_k || (k == min_k && f < min_f))) {
        min_k = k;
        min_f = f;
      }
      if (set.found >= R) break;
    }
    if (t == reach) {  // every number of the round was drawn
      left -= n;
#pragma unroll
      for (int i = 0; i < kHigh; ++i) {
        if (stops[i] != 0u) keep_high(i, least[i]);
      }
      return;
    }
    // The trace ended at walking number t: only the numbers before it were
    // drawn, and their high stops matter only where no unused number
    // reached the walk.
    if (min_k != kNoK) return;
    int pos = t;  // its index among the numbers passing level i, then consulting it
#pragma unroll
    for (int i = kHigh - 1; i >= 0; --i) {
      if (i < high) pos = static_cast<int>(__fns(~stops[i], 0u, pos + 1));
    }
    int before = pos;  // the numbers before it that consulted level i
    int lowest = -1, drawn = 0;
#pragma unroll
    for (int i = 0; i < kHigh; ++i) {
      if (i < high) {
        const int here = __popc(stops[i] & ((1u << before) - 1u));
        if (here > 0) {
          lowest = i;
          drawn = before;
        }
        before -= here;
      }
    }
#pragma unroll
    for (int i = 0; i < kHigh; ++i) {
      if (i == lowest) {  // its stops before the end, hashed again
        const uint32_t base = c[i] - static_cast<uint32_t>(consults[i]);
        uint32_t h_min = ~0u;
        for (int j = 0; j < drawn; ++j) {
          if ((stops[i] >> j) & 1u) {
            const uint32_t h = draw_seeded(seed[i], base + static_cast<uint32_t>(j));
            h_min = h < h_min ? h : h_min;
          }
        }
        keep_high(i, h_min);
      }
    }
  }

  __device__ __forceinline__ int32_t result(int R, int top_level, int s_log2) const {
    if (set.found < R) return -1;
    if (min_k != kNoK) return static_cast<int32_t>(min_k);
    if (high_i < 0) return -1;
    const uint32_t k = high_h >> (32 - s_log2 - (top_level - high_i));
    return k != kNoK ? static_cast<int32_t>(k) : -1;
  }
};

// B4's per-lane body: B2's first R hits on distinct nodes, nodes out,
// against both tables in one walk of the deeper ladder, as B3's body
// above: each table tests and counts only its own numbers, against
// max_draws * max(1, R), and keeps its own node set; the lane stops when
// each table holds R nodes or reached its cap.  ``set_hi`` / ``set_lo``
// take the tables' picks in pick order (RMAX == 0: in their rows).
template <int RMAX, class Ladder>
__device__ __forceinline__ void diff_replicas_walk(
    uint32_t id, Ladder& ladder, const DiffTable& hi, const DiffTable& lo,
    int s_log2, int max_draws, int R, NodeSet<RMAX>& set_hi, NodeSet<RMAX>& set_lo) {
  ladder.reset(id, hi.top_level);
  const int cap = max_draws * (R > 1 ? R : 1);  // < 2**31: the wrapper checks
  int left_hi = cap, left_lo = cap;
  while (left_hi > 0 || left_lo > 0) {
    uint32_t h, k, f;
    const int level = ladder.walk(id, hi.top_level, h);
    split(h, level, s_log2, k, f);
    if (left_hi > 0) {
      --left_hi;
      if (hits(k, f, hi.n_segs, hi.len32) && set_hi.add(__ldg(hi.node_of + k)) == R) {
        left_hi = 0;
      }
    }
    if (left_lo > 0 && level <= lo.top_level) {
      --left_lo;
      if (hits(k, f, lo.n_segs, lo.len32) && set_lo.add(__ldg(lo.node_of + k)) == R) {
        left_lo = 0;
      }
    }
  }
}

// B4's walk with both sets written out: ``row_hi`` / ``row_lo`` are the
// tables' R-entry output rows, -1 for unfilled slots.
template <int RMAX, class Ladder>
__device__ __forceinline__ void diff_replicas_lane_with(
    uint32_t id, Ladder& ladder, const DiffTable& hi, const DiffTable& lo,
    int s_log2, int max_draws, int R, int32_t* row_hi, int32_t* row_lo) {
  NodeSet<RMAX> set_hi(row_hi), set_lo(row_lo);
  diff_replicas_walk<RMAX>(id, ladder, hi, lo, s_log2, max_draws, R, set_hi, set_lo);
  set_hi.write(row_hi, R);
  set_lo.write(row_lo, R);
}

}  // namespace port_lane
