// The serving driver's selection words on Hopper: Threefry-2x32 in
// registers, one thread per lane.
//
// Replaces no TPU kernel.  The reference draws these words with
// jax.random in jnp (serve/traffic.py TrafficModel.lane_words:
// bits(fold_in(fold_in(root, step), lane), (n_words,), uint32) in jax's
// partitionable threefry mode).  The port's plain-torch twin
// (serve/traffic.py) writes the same arithmetic on int64 tensors of u32
// values: one launch for every add, shift, mask, or and xor of every
// round, about 340 launches over the 2**22 lanes of a serving batch,
// each through device memory.
//
// lane_words_kernel<NW> computes, for each lane,
//   (k0, k1) = threefry2x32(batch_key, (0, lane mod 2**32))   (fold_in)
//   word j   = y0 ^ y1 of threefry2x32((k0, k1), (0, j)),  j < NW,
// with the batch key fold_in(root, step) computed on the host (one value
// per launch).  Threefry-2x32 is 20 rounds (rotations 13 15 26 6 /
// 17 29 16 24), a key injection after every four, the third key word
// k0 ^ k1 ^ 0x1BD11BDA.  The words are u32 values written as int64, the
// twin's layout: (n, NW) row-major.
//
// What bounds it on an H100.  Per lane it reads 8 bytes (the int64 lane)
// and writes 8 * NW; it does 1 + NW Threefry evaluations of ~73 int32
// operations (per round an add, a funnel shift and an xor; per injection
// two adds, the round constant folded into a three-input add) and NW
// xors.  At 2**22 lanes and NW = 1 that is ~6.2e8 operations, 0.037 ms at
// 16.7 T int32 ops/s, against 67 MB, 0.020 ms at 3.35 TB/s: the kernel is
// operation-bound.  So every value stays in registers (no shared memory,
// no local array: the loops unroll, so the key schedule's indexes are
// constants), rotations are single funnel shifts, the lanes are read and
// the words written once and coalesced (NW = 2 as one 16-byte longlong2
// store a lane), and one thread per lane gives the rounds' dependent adds
// enough resident warps to hide their latency.  The ragged edge is masked
// here; the wrapper pads nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, on (x0, x1) in place under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      four_rounds<13, 15, 26, 6>(x0, x1);
    } else {
      four_rounds<17, 29, 16, 24>(x0, x1);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
    lane_words_kernel(uint32_t b0, uint32_t b1, const int64_t* __restrict__ lanes,
                      int64_t* __restrict__ out, int64_t n) {
  static_assert(NW == 1 || NW == 2, "one or two words a lane");
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  // the lane key: fold_in(batch key, lane), the lane's low 32 bits
  uint32_t k0 = 0u;
  uint32_t k1 = static_cast<uint32_t>(lanes[i]);
  threefry2x32(b0, b1, k0, k1);
  uint32_t w[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t y0 = 0u;
    uint32_t y1 = static_cast<uint32_t>(j);
    threefry2x32(k0, k1, y0, y1);
    w[j] = y0 ^ y1;
  }
  if constexpr (NW == 2) {
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2(w[0], w[1]);
  } else {
    out[i] = w[0];
  }
}

}  // namespace

// lanes: (n,) int64; out: (n, n_words) int64, 16-byte aligned.  (k0, k1)
// is the batch key; n_words is 1 or 2.
extern "C" int traffic_lane_words(uint32_t k0, uint32_t k1, const void* lanes, void* out,
                                  int64_t n, int n_words, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const int64_t*>(lanes);
  auto* o = static_cast<int64_t*>(out);
  if (n_words == 1) {
    lane_words_kernel<1><<<grid, kThreads, 0, s>>>(k0, k1, l, o, n);
  } else if (n_words == 2) {
    lane_words_kernel<2><<<grid, kThreads, 0, s>>>(k0, k1, l, o, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
