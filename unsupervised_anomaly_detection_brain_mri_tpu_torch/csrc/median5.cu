// 5^3 median filter of a float32 volume (S, H, W), scipy 'reflect' borders.
//
// Replaces `unsupervised_anomaly_detection_brain_mri_tpu/ops/pallas_median.py
// ::median_filter_3d_pallas` (the TPU's Pallas kernel) on Hopper (sm_90a).
//
// What bounds it on an H100: not HBM.  Each voxel is read once from device
// memory into a shared-memory slab and written once (4 B in, 4 B out), while
// the selection does ~125 shared-memory loads and integer compares per
// bisection round, for up to 32 rounds.  Shared-memory load issue and integer
// compare throughput are the limit.
//
// How the design answers that:
//   * one block of 32 x 8 threads (W x H) owns a 32 x 8 tile over CS output
//     slices; it stages a (CS+4) x (8+4) x (32+4) slab once (13.8 KB) and
//     every window read after that comes from shared memory: 3456 slab
//     loads for 1024 outputs, 3.4 global reads per output instead of 125;
//   * the slab holds order-preserving uint32 keys, converted once at load
//     time, so the inner loop is one load + one unsigned compare + one add;
//   * a warp reads 32 consecutive keys per load: no bank conflicts;
//   * bisection starts from the window's [min, max] key bracket, so a
//     constant neighbourhood (the zero background outside the brain, most of
//     a served volume) costs no rounds at all.
//
// Selection is exact: bisection over the 2^32 key space converges on the
// smallest key k with #(key <= k) >= 63, which is the 63rd of 125 values.
// The border is numpy 'symmetric' (== scipy 'reflect'), done by mirroring
// indices in the kernel, so S, H or W smaller than 3 also works and the
// volume is never padded in memory.
//
// Interface: a plain C function, bound from Python with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 2;               // window radius (5^3 window)
constexpr int TW = 32;             // tile width  (threads in x)
constexpr int TH = 8;              // tile height (threads in y)
constexpr int CS = 4;              // output slices per block
constexpr int SW = TW + 2 * R;     // slab width
constexpr int SH = TH + 2 * R;     // slab height
constexpr int SS = CS + 2 * R;     // slab depth
constexpr int NEED = 63;           // 125 / 2 + 1

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

__global__ void __launch_bounds__(TW * TH)
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

  for (int z = 0; z < CS && z0 + z < S; ++z) {
    uint32_t lo = 0xFFFFFFFFu;
    uint32_t hi = 0u;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
#pragma unroll
      for (int b = 0; b < 5; ++b) {
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const uint32_t k = slab[z + a][ty + b][tx + c];
          lo = min(lo, k);
          hi = max(hi, k);
        }
      }
    }
    // invariant: #(key <= hi) >= NEED and #(key <= lo - 1) < NEED
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int cnt = 0;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
#pragma unroll
        for (int b = 0; b < 5; ++b) {
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            cnt += (slab[z + a][ty + b][tx + c] <= mid) ? 1 : 0;
          }
        }
      }
      if (cnt >= NEED) {
        hi = mid;
      } else {
        lo = mid + 1;
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
