// 5^3 median filter of a float32 volume (S, H, W), scipy 'reflect' borders.
//
// Replaces `unsupervised_anomaly_detection_brain_mri_tpu/ops/pallas_median.py
// ::median_filter_3d_pallas` (the TPU's Pallas kernel) on Hopper (sm_90a).
//
// What bounds it on an H100: not HBM.  Each voxel is read once from device
// memory and written once (14.4 MB at (110, 128, 128): 4.3 us at 3.35 TB/s),
// while selecting the 63rd of 125 keys costs thousands of integer
// instructions per output.  The limit, inferred from the SASS instruction
// count and the wall-clock time (no profiler reading of pipe utilisation
// backs it), is the integer pipe: an SM sub-partition runs 16 lanes of
// 32-bit integer min/max, shift-add and compare per clock, half a warp
// instruction; divergence (a warp runs its slowest window's rounds) is the
// other candidate, and the two are not separated.  TMA or cp.async staging would
// speed up only the 3.4 global reads per output, and a median has no
// products, so wgmma and the tensor cores have no work here.
//
// The selection rule: element-snapping bisection over order-preserving
// uint32 keys.  The bracket starts at the window's [min, max] (a constant
// window, most of a served map's zero background, takes no round).  Each
// round takes mid = lo + (hi - lo) / 2 and, in one pass over the 125 keys,
// c = #(key <= mid), below = max{key <= mid} and above = min{key > mid}.
// With c >= 63 the median m (the smallest key with #(<= m) >= 63) is at
// most below, so hi = below, and m == below when c == 63; otherwise
// m >= above, so lo = above, and m == above when c == 62.  Both ends snap to
// keys present in the window, so every round at least halves the key range
// and the distinct keys left in it: at most 32 rounds.  Counted by
// ops/median.py::median_select_reference on a uniform (110, 128, 128)
// volume: 6.6 rounds on average and 9.4 for the slowest thread of a warp.
// Plain key-space bisection (the rule of the first version of this kernel,
// which also re-read all 125 keys from shared memory in every round and
// took 0.94 ms on an H100) needs about one round per bit of the bracket.
//
// Layout and resources:
//   * one block of 32 x 4 threads (W x H; a warp is one row of 32
//     neighbouring outputs) owns a 32 x 4 tile over CS = 8 output slices;
//     it stages a (8+4) x (4+4) x (32+4) slab of keys in shared memory once
//     (13.8 KB): 3.4 global reads per output instead of 125;
//   * the 125 keys of a window are loaded from shared memory into registers
//     once per output (a warp reads 32 consecutive words, no bank
//     conflicts) and every round runs on registers.  Per key and round:
//     d = key + ~mid (= key - mid - 1 mod 2^32: small for key > mid, wrapped
//     to the top for key <= mid) on the FMA pipe; d into three-input min and
//     max (above and below follow); d >> 8 into a sum, from which the count
//     follows exactly (see the round).  That is 2 integer-pipe instructions
//     per key (VIMNMX3, LEA.HI) and 1 on the FMA pipe, ~400 per round;
//     counting carries instead (an add with carry out per key, then two
//     carries per add) takes 2.5 on the integer pipe and was slower;
//   * ptxas (sm_90a, CUDA 12.8): 159 registers, 0 spills, 13,824 B of shared
//     memory; __launch_bounds__(128, 3) gives 3 blocks, 12 warps, per SM.
//   Tried on the H100 and slower (a one-off comparison, not kept): the
//   keys left in the bracket moved to per-thread lists in shared memory
//   after 1-3 rounds (dynamic loops); part of the count on the FMA pipe
//   with multiply-adds (IMAD.HI, IMAD.WIDE); blocks of 32 x 1, 32 x 2 or
//   32 x 8 threads; 4, 12 or 16 slices a block (equal or slower).
//
// The border is numpy 'symmetric' (== scipy 'reflect'), done by mirroring
// indices in the kernel, so S, H or W smaller than 3 also works and the
// volume is never padded in memory.
//
// Interface: a plain C function, bound from Python with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 2;               // window radius (5^3 window)
constexpr int K = 2 * R + 1;       // window side
constexpr int N = K * K * K;       // keys per window
constexpr int TW = 32;             // tile width  (threads in x)
constexpr int TH = 4;              // tile height (threads in y)
constexpr int CS = 8;              // output slices per block
constexpr int SW = TW + 2 * R;     // slab width
constexpr int SH = TH + 2 * R;     // slab height
constexpr int SS = CS + 2 * R;     // slab depth
constexpr int NEED = N / 2 + 1;    // the median is the 63rd of 125

// numpy 'symmetric' index: ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...
__device__ __forceinline__ int mirror(int i, int n) {
  while (i < 0 || i >= n) {
    i = (i < 0) ? -i - 1 : 2 * n - 1 - i;
  }
  return i;
}

// float -> uint32 with the same order (negative floats flip all bits)
__device__ __forceinline__ uint32_t to_key(float v) {
  uint32_t b = __float_as_uint(v);
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t b = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(b);
}

__global__ void __launch_bounds__(TW * TH, 3)
median5_kernel(const float* __restrict__ in, float* __restrict__ out,
               int S, int H, int W) {
  __shared__ uint32_t slab[SS][SH][SW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int z0 = blockIdx.z * CS;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const size_t plane = (size_t)H * (size_t)W;

  for (int i = tid; i < SS * SH * SW; i += TW * TH) {
    const int s = i / (SH * SW);
    const int h = (i / SW) % SH;
    const int w = i % SW;
    const int gz = mirror(z0 + s - R, S);
    const int gy = mirror(y0 + h - R, H);
    const int gx = mirror(x0 + w - R, W);
    slab[s][h][w] = to_key(in[gz * plane + (size_t)gy * W + gx]);
  }
  __syncthreads();

  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= W || y >= H) return;

#pragma unroll 1
  for (int z = 0; z < CS && z0 + z < S; ++z) {
    uint32_t key[N];
    uint32_t lo = 0xFFFFFFFFu;
    uint32_t hi = 0u;
    uint64_t ksum = 0u;
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = 0; b < K; ++b) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const uint32_t k = slab[z + a][ty + b][tx + c];
          key[(a * K + b) * K + c] = k;
          ksum += k;
          lo = min(lo, k);
          hi = max(hi, k);
        }
      }
    }
    // invariant: the median m lies in [lo, hi], and both are window keys
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      const uint32_t nm = ~mid;  // key + nm == key - (mid + 1) mod 2^32
      // d = key + nm = key - (mid + 1) mod 2^32 is small for key > mid
      // (the add carries out of 32 bits) and wraps to the top for
      // key <= mid, so min(d) is the smallest key > mid and max(d) the
      // largest key <= mid.  Several accumulators keep the dependency
      // chains short.
      uint32_t t[4] = {0u, 0u, 0u, 0u};
      uint32_t dmin[2] = {0xFFFFFFFFu, 0xFFFFFFFFu};
      uint32_t dmax[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i + 1 < N; i += 2) {
        const uint32_t da = key[i] + nm;
        const uint32_t db = key[i + 1] + nm;
        t[(i >> 1) & 3] += da >> 8;
        t[((i >> 1) + 2) & 3] += db >> 8;
        dmin[(i >> 1) & 1] = min(dmin[(i >> 1) & 1], min(da, db));
        dmax[(i >> 1) & 1] = max(dmax[(i >> 1) & 1], max(da, db));
      }
      const uint32_t dl = key[N - 1] + nm;
      // the carries: sum(d) = sum(key) + N * nm - 2^32 * #(key > mid), and
      // sum(d) = 2^8 * sum(d >> 8) + r with 0 <= r < 2^15, so
      // #(key > mid) = (sum(key) + N * nm - 2^8 * sum(d >> 8)) >> 32
      const uint64_t tsum = t[0] + t[1] + t[2] + t[3] + (dl >> 8);
      const int cnt =  // #(key <= mid)
          N - (int)((ksum + (uint64_t)N * nm - (tsum << 8)) >> 32);
      const uint32_t below = max(max(dmax[0], dmax[1]), dl) + mid + 1u;
      const uint32_t above = min(min(dmin[0], dmin[1]), dl) + mid + 1u;
      if (cnt >= NEED) {
        hi = below;
        if (cnt == NEED) lo = below;
      } else {
        lo = above;
        if (cnt == NEED - 1) hi = above;
      }
    }
    out[(size_t)(z0 + z) * plane + (size_t)y * W + x] = from_key(hi);
  }
}

}  // namespace

extern "C" int uad_median5_f32(const float* in, float* out, int S, int H,
                               int W, void* stream) {
  if (S <= 0 || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(TW, TH, 1);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (S + CS - 1) / CS);
  median5_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, S, H, W);
  return (int)cudaGetLastError();
}
