// The serving driver's select and count on Hopper: one pass over the
// batch's lanes with a block-private histogram in shared memory (SC), and
// a small pass over the bins that folds the histogram into the load state.
//
// Replaces no TPU kernel.  The reference serves a batch's select and count
// as one jit of jnp ops (serve/stream.py _route_batch_fn: select_replica,
// then a scatter-add histogram, the counts, the queue recurrence and its
// history ring).  The port's plain-torch twin (serve/stream.py
// select_count_twin, count_update_twin) is some thirty launches a batch:
// the slot arithmetic on int64 words, two gathers of the owners, two
// gathers of the counts, the selects, the scatter-add and the state
// update, each through device memory.
//
// select_count_kernel<kShared> computes, for each lane i of the batch,
//   primary / R == 1:  chosen = max(owners[i, 0], 0)
//   random:            s = w % R; chosen = owners[i, s], or the clamped
//                      primary where that slot is -1
//   pow2:              a = owners[i, w % R],
//                      b = owners[i, (w % R + 1 + (w >> 16) % (R - 1)) % R];
//                      load(x) = counts[x], 2**31 - 1 for x = -1;
//                      chosen = load(b) < load(a) ? b : a (ties to the
//                      first slot), the clamped primary where that is -1
// with w the lane's u32 selection word (int64 at any stride: a generated
// batch passes a column of its (n, 2) words), and adds 1 to bin chosen for
// each lane below n_valid (pad lanes of a host-fed batch weigh 0).  The
// owners are (n, R) int32 at any strides (the hierarchical kernel's node
// plane arrives transposed).  A node id at or past n_bins is the caller's
// error (the driver checks every table version against its bins on the
// host): the kernel neither reads nor counts such a bin, so it stays inside
// its buffers.
//
// count_update_kernel then writes, per bin b, with torch's int32 wrap,
//   counts_out[b] = counts[b] + hist[b]
//   queue_out[b]  = max(queue[b] + hist[b] - service[b], 0) = qrow[b]
// and hands the histogram back zeroed, so the next batch's SC adds into it
// without a launch to clear it.  The outputs are fresh buffers: callers
// keep earlier batches' counts and queues.
//
// What bounds it on an H100.  At a serving batch's 2**22 lanes and R = 3
// SC reads the (n, 3) int32 owners (50 MB) and the int64 words (34 MB at
// stride 1) and writes the int32 chosen nodes (17 MB): ~100 MB, 0.030 ms at
// 3.35 TB/s.  Its gathers of the 40 KB counts plane and its histogram stay
// on chip.  So SC reads each lane's operands once, coalesced across the
// warp, and keeps the histogram out of device memory: a block zeroes a
// plane of n_bins int32 in dynamic shared memory, counts its lanes there
// and adds its non-zero bins to the global histogram once at its end, with
// consecutive threads on consecutive bins.  Under a skewed key law whole
// warps choose one node, so equal bins are merged within the warp first
// (__match_any_sync): one shared atomic per distinct node a warp chose.
// The grid is persistent (SMs x resident blocks, from the occupancy
// calculator at the plane's size: two blocks of 1024 threads an SM at
// 10,001 bins), so the zeroing and the flush are paid once per resident
// block.  Blocks of 1024 threads time 5 % under blocks of 512 there, and
// half of blocks of 256, which leave the SM fewer resident threads.  A
// plane that does not fit a block's shared memory (n_bins above 58,112 on
// an H100) is counted straight into the global histogram, warp-merged the
// same way.  count_update_kernel moves 6 * 4 bytes a bin: 0.24 MB at
// 10,001 bins.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kUpdateThreads = 256;
constexpr int32_t kBig = 0x7fffffff;  // an invalid candidate's load: always loses
constexpr int kPrimary = 0;  // the policy codes; 1 is random
constexpr int kPow2 = 2;

struct Batch {
  const int32_t* owners;
  int64_t row;  // owners' strides, in elements
  int64_t col;
  const int64_t* sel;
  int64_t sel_stride;
  const int32_t* counts;
  int32_t* chosen;
  int32_t* hist;
  int64_t n;
  int64_t n_valid;
  int R;
  int policy;
  int n_bins;
};

// The start-of-batch load of candidate x: 2**31 - 1 for an unfilled slot.
__device__ __forceinline__ int32_t load_of(const Batch& b, int32_t x) {
  return (x >= 0 && x < b.n_bins) ? __ldg(b.counts + x) : kBig;
}

__device__ __forceinline__ int32_t pick(const Batch& b, int64_t i) {
  const int32_t* row = b.owners + i * b.row;
  int32_t chosen;
  if (b.policy == kPrimary || b.R == 1) {
    chosen = -1;
  } else {
    const uint32_t w = static_cast<uint32_t>(
        __ldg(reinterpret_cast<const long long*>(b.sel + i * b.sel_stride)));
    const uint32_t R = static_cast<uint32_t>(b.R);
    const uint32_t s = w % R;
    chosen = __ldg(row + s * b.col);
    if (b.policy == kPow2) {
      const uint32_t t = (s + 1u + (w >> 16) % (R - 1u)) % R;
      const int32_t other = __ldg(row + t * b.col);
      if (load_of(b, other) < load_of(b, chosen)) chosen = other;
    }
  }
  return chosen >= 0 ? chosen : max(__ldg(row), 0);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) select_count_kernel(Batch b) {
  extern __shared__ int32_t plane[];
  int32_t* bins = kShared ? plane : b.hist;
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < b.n_bins; k += kThreads) plane[k] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the warp's 32 lanes step together, so every lane takes part in the
  // ballot and the match
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < b.n; base += stride) {
    const int64_t i = base + lane;
    int32_t node = -1;
    if (i < b.n) {
      node = pick(b, i);
      b.chosen[i] = node;
    }
    const bool counted = i < b.n_valid && static_cast<uint32_t>(node) <
                                              static_cast<uint32_t>(b.n_bins);
    const unsigned mask = __ballot_sync(0xffffffffu, counted);
    if (counted) {
      const unsigned peers = __match_any_sync(mask, node);
      if (lane == __ffs(peers) - 1) atomicAdd(bins + node, __popc(peers));
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < b.n_bins; k += kThreads) {
      const int32_t v = plane[k];
      if (v != 0) atomicAdd(b.hist + k, v);
    }
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
    count_update_kernel(int32_t* __restrict__ hist, const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ queue, const int32_t* __restrict__ service,
                        int32_t* __restrict__ counts_out, int32_t* __restrict__ queue_out,
                        int32_t* __restrict__ qrow, int n_bins) {
  const int k = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (k >= n_bins) return;
  const uint32_t h = static_cast<uint32_t>(hist[k]);
  hist[k] = 0;
  counts_out[k] = static_cast<int32_t>(static_cast<uint32_t>(counts[k]) + h);
  const int32_t q = max(static_cast<int32_t>(static_cast<uint32_t>(queue[k]) + h -
                                             static_cast<uint32_t>(service[k])),
                        0);
  queue_out[k] = q;
  qrow[k] = q;
}

// The persistent grid of one SC variant at one plane size: SMs x resident
// blocks.  The queries are host calls that do not change between launches,
// so each (device, variant) asks them again only when the plane's size
// changes (a driver keeps one n_bins).
struct Grid {
  int dev = -1;
  int smem = -1;
  int blocks = 0;
};

template <bool kShared>
cudaError_t resident_blocks(int dev, int smem, int& blocks) {
  static std::mutex lock;
  static Grid cached[64];
  const bool keep = dev >= 0 && dev < 64;
  std::lock_guard<std::mutex> guard(lock);
  if (keep && cached[dev].smem == smem) {
    blocks = cached[dev].blocks;
    return cudaSuccess;
  }
  cudaError_t err = cudaSuccess;
  if (kShared) {
    err = cudaFuncSetAttribute(select_count_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_count_kernel<kShared>,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  if (keep) cached[dev] = Grid{dev, smem, blocks};
  return cudaSuccess;
}

}  // namespace

// owners: (n, R) int32 at element strides (row, col); sel: (n,) int64 at
// element stride sel_stride (read only for random and pow2 at R > 1);
// counts, hist: (n_bins,) int32, hist added into; chosen: (n,) int32.
// policy: 0 primary, 1 random, 2 pow2.  0 <= n_valid <= n.
extern "C" int serve_select_count(const void* owners, int64_t row, int64_t col, const void* sel,
                                  int64_t sel_stride, const void* counts, void* chosen,
                                  void* hist, int64_t n, int64_t n_valid, int R, int policy,
                                  int n_bins, void* stream) {
  if (n <= 0) return 0;
  if (R < 1 || policy < kPrimary || policy > kPow2 || n_bins < 1 || n_valid < 0 ||
      n_valid > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(n_bins) * sizeof(int32_t);
  const bool shared = plane <= optin;
  const int smem = shared ? static_cast<int>(plane) : 0;
  int resident = 0;
  err = shared ? resident_blocks<true>(dev, smem, resident)
               : resident_blocks<false>(dev, smem, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(std::min<int64_t>(needed, resident)));
  const Batch b{static_cast<const int32_t*>(owners),
                row,
                col,
                static_cast<const int64_t*>(sel),
                sel_stride,
                static_cast<const int32_t*>(counts),
                static_cast<int32_t*>(chosen),
                static_cast<int32_t*>(hist),
                n,
                n_valid,
                R,
                policy,
                n_bins};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    select_count_kernel<true><<<grid, kThreads, smem, s>>>(b);
  } else {
    select_count_kernel<false><<<grid, kThreads, 0, s>>>(b);
  }
  return static_cast<int>(cudaGetLastError());
}

// hist (zeroed on return), counts, queue, service, counts_out, queue_out,
// qrow: (n_bins,) int32; qrow is the queue-history ring's row.
extern "C" int serve_count_update(void* hist, const void* counts, const void* queue,
                                  const void* service, void* counts_out, void* queue_out,
                                  void* qrow, int n_bins, void* stream) {
  if (n_bins <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>((n_bins + kUpdateThreads - 1) / kUpdateThreads));
  count_update_kernel<<<grid, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(hist), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(queue), static_cast<const int32_t*>(service),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(queue_out),
      static_cast<int32_t*>(qrow), n_bins);
  return static_cast<int>(cudaGetLastError());
}
