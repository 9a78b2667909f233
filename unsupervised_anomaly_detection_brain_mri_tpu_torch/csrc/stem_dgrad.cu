// Input gradient of the encoder's 1-channel stem: a SAME 5x5 stride-2
// convolution from one channel to C, differentiated with respect to its
// (B, H, W) input only.
//
// Replaces no TPU kernel: on the TPU, XLA differentiated the convolution
// inside the compiled restoration step.  The port's restoration
// (`train/restoration.py`, 150 input-gradient steps a served VAE_You scan)
// left it to the library, whose input gradient for a 1-channel input
// (cuDNN's dgrad2d_grouped_direct_kernel) took ~3.5 ms a call at the
// serving shape, a quarter of all device time of a served request.  The
// wrapper (`ops/stem_dgrad.py`) launches it from the backward of the stem's
// autograd Function, which the encoder takes only when nothing but the
// input's gradient can be asked for.
//
// SAME pads a k5 s2 input by 1 or 2 rows (columns) before it, so that
//   y[b, c, oy, ox] = sum_{ky, kx} xp[b, 2 oy + ky, 2 ox + kx] w[c, ky, kx],
// and the gradient of the unpadded input at (y, x), padded row
// py = y + pad_top, is
//   dx[b, y, x] = sum_c sum_{ky = py - 2 oy, kx = px - 2 ox in [0, 5)}
//                 g[b, c, oy, ox] w[c, ky, kx].
// Only the taps of py's and px's parity reach a pixel: 3 or 2 of the 5 in
// each direction, 6.25 on average of the 25.  The kernel computes pixels
// in 2x2 groups (y = 2m, 2m + 1; x = 2n, 2n + 1): one of each parity, so
// a group takes exactly the 25 taps of every channel, from the 3x3 window
// of g at rows m - 1 .. m + 1 and columns n - 1 .. n + 1 (with a pad of 1
// or 2 before, ceil(pad / 2) - 2 = -1).  The pixel at row offset p takes
// window row t with ky = 4 + p - (pad_top & 1) - 2t when that lies in
// [0, 5), likewise kx; the pads' parities are template arguments, so every
// tap is a compile-time register index.  The padded rows and columns are
// never computed, and the gradient is written as float32 straight into
// the (B, H, W) input's gradient: the pad's backward (a crop) and the
// cast's backward are this kernel's store.
//
// Sums are fp32 over every channel and tap, rounded once to the compute
// dtype (bf16: round to nearest even), as the library rounds its bf16
// gradient before the cast back to float32.
//
// What bounds it on an H100: at the serving shape, g (181, 32, 64, 64) in
// bf16 is 47.4 MB and dx 11.9 MB, 17.7 us at 3.35 TB/s; the 0.59 G FMAs
// take as long on the fp32 cores (67 TFLOP/s), so neither the copies nor
// the sums may wait for the other.  A block of 32 x TY threads owns 64
// columns and 2 R TY rows of dx of one image, a lane a column pair and R
// groups in registers a thread.  It walks the channels in chunks of CCH,
// each chunk's tile of g (its rows with a halo of one above and one below,
// 48 columns from 8 before the block's first pair) staged in shared memory
// as one plane a channel, with the chunk's weights, in two buffers: the
// next chunk's copies are in flight while the block sums this one.  g is
// NCHW-contiguous (the encoder's backward hands the stem NCHW bf16; the
// wrapper makes any other layout contiguous).  Rows of a multiple of 16
// bytes, as served, are copied by cp.async, 16 bytes a thread straight
// into the planes, zero-filled outside g, so the copy costs the threads
// nothing; other rows element by element, by the threads before they sum.
// A thread reads its (R + 2) x 3 window of each plane (lanes on neighbouring
// 2-byte words: no bank conflict) and the channel's 25 weights (a
// broadcast, 16 bytes a read) for 25 R FMAs.  Measured at the serving
// shape (NVIDIA H100 80GB HBM3, 700 W): 54 us a call back to back (0.33 of
// the bound), against 3.5 ms for the library's input gradient.
//
// One launch on the caller's stream, no synchronisation, no allocation;
// returns cudaGetLastError() (or the attribute call's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block's shape: 32 x TY threads, R pairs of rows a thread, and at
// least MIN_BLOCKS blocks an SM (which caps a thread at 65536 /
// (MIN_BLOCKS x 32 x TY) registers).  Tuned at the serving shape on an
// H100 over 10 shapes: R 2 and R 1 read 61-65 and 82-87 us, this 54 us.
constexpr int TX = 32;             // pairs of columns a block (lanes)
constexpr int TY = 4;              // rows of threads a block
constexpr int R = 4;               // pairs of rows a thread
constexpr int MIN_BLOCKS = 3;
constexpr int PAIR_ROWS = TY * R;  // pairs of rows a block
constexpr int TR = PAIR_ROWS + 2;  // rows of g a block stages
constexpr int SW = 48;             // columns of g a block stages
constexpr int LEFT = 8;            // of them before the block's first pair
constexpr int CCH = 8;             // channels a chunk
constexpr int WSTRIDE = 28;        // floats of one channel's weights

enum Layout { NCHW_VEC = 0, NCHW = 1 };

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)CCH * WSTRIDE * 4 + (size_t)CCH * TR * SW * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Stage channels c0 .. c0 + CCH - 1 of the block's tile (g rows from gy0,
// columns from gx0) and their weights into one buffer.
template <typename T, int LAYOUT>
__device__ __forceinline__ void stage(const T* __restrict__ g,
                                      const T* __restrict__ w, float* s_w,
                                      T* s_g, int b, int c0, int C, int OH,
                                      int OW, int gy0, int gx0, int tid) {
  constexpr int NT = TX * TY;
  for (int i = tid; i < CCH * 25; i += NT) {
    const int c = i / 25, k = i - c * 25;
    s_w[c * WSTRIDE + k] =
        c0 + c < C ? Elem<T>::f(w[(size_t)(c0 + c) * 25 + k]) : 0.f;
  }
  if (LAYOUT == NCHW_VEC) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int NV = SW / VEC;  // vectors a row
    for (int i = tid; i < CCH * TR * NV; i += NT) {
      const int v = i % NV, rc = i / NV;
      const int r = rc % TR, c = rc / TR;
      const int oy = gy0 + r, ox = gx0 + v * VEC;
      // OW is a multiple of VEC and gx0 of 8: a vector is wholly in or out
      const bool ok = c0 + c < C && oy >= 0 && oy < OH && ox >= 0 && ox < OW;
      const T* src =
          ok ? g + (((size_t)b * C + c0 + c) * OH + oy) * OW + ox : g;
      cp_async16(s_g + (c * TR + r) * SW + v * VEC, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = tid; i < CCH * TR * SW; i += NT) {
      const int col = i % SW, rc = i / SW;
      const int r = rc % TR, c = rc / TR;
      const int oy = gy0 + r, ox = gx0 + col;
      const bool ok = c0 + c < C && oy >= 0 && oy < OH && ox >= 0 && ox < OW;
      s_g[(c * TR + r) * SW + col] =
          ok ? g[(((size_t)b * C + c0 + c) * OH + oy) * OW + ox] : T(0.f);
    }
  }
}

// PY, PX: the parities of pad_top and pad_left (each 1 or 2).
template <typename T, int LAYOUT, int PY, int PX>
__global__ void __launch_bounds__(TX * TY, MIN_BLOCKS)
stem_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ w,
                  float* __restrict__ out, int C, int H, int W, int OH,
                  int OW, int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t STAGE = stage_bytes<T>();
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int tile_x = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int tile_y = rest % tiles_y;
  const int b = rest / tiles_y;
  const int m0 = tile_y * PAIR_ROWS;  // first pair of rows
  const int n0 = tile_x * TX;         // first pair of columns
  const int gy0 = m0 - 1;             // first g row staged
  const int gx0 = n0 - LEFT;          // first g column staged

  float acc[R][2][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) acc[r][p][q] = 0.f;

  auto s_w = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * STAGE);
  };
  auto s_g = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * STAGE + CCH * WSTRIDE * 4);
  };
  const int chunks = (C + CCH - 1) / CCH;
  stage<T, LAYOUT>(g, w, s_w(0), s_g(0), b, 0, C, OH, OW, gy0, gx0, tid);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    if (k + 1 < chunks) {
      stage<T, LAYOUT>(g, w, s_w(buf ^ 1), s_g(buf ^ 1), b, (k + 1) * CCH, C,
                       OH, OW, gy0, gx0, tid);
    }
    if (LAYOUT == NCHW_VEC) {
      if (k + 1 < chunks) {
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    }
    __syncthreads();
    // the thread's window: g rows m - 1 .. from its first pair m, columns
    // n - 1 .. of its pair n, n - 1 being staged column LEFT - 1 + lane
    const T* win = s_g(buf) + threadIdx.y * R * SW + threadIdx.x + LEFT - 1;
    const float* wts = s_w(buf);
#pragma unroll 2
    for (int c = 0; c < CCH; ++c) {
      float wv[WSTRIDE];
      const float4* wp = reinterpret_cast<const float4*>(wts + c * WSTRIDE);
#pragma unroll
      for (int j = 0; j < WSTRIDE / 4; ++j) {
        const float4 t = wp[j];
        wv[4 * j] = t.x;
        wv[4 * j + 1] = t.y;
        wv[4 * j + 2] = t.z;
        wv[4 * j + 3] = t.w;
      }
      const T* plane = win + c * TR * SW;
#pragma unroll
      for (int a = 0; a < R + 2; ++a) {
        float gv[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) gv[s] = Elem<T>::f(plane[a * SW + s]);
        // window row a is row t = a - r of pair r
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = a - r;
          if (t < 0 || t > 2) continue;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int ky = 4 + p - PY - 2 * t;
            if (ky < 0 || ky > 4) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int s = 0; s < 3; ++s) {
                const int kx = 4 + q - PX - 2 * s;
                if (kx < 0 || kx > 4) continue;
                acc[r][p][q] = fmaf(wv[ky * 5 + kx], gv[s], acc[r][p][q]);
              }
          }
        }
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }

  const int x0 = 2 * (n0 + threadIdx.x);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int y = 2 * (m0 + threadIdx.y * R + r) + p;
      if (y >= H) continue;
      float* row = out + ((size_t)b * H + y) * W;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (x0 + q < W) row[x0 + q] = Elem<T>::round(acc[r][p][q]);
    }
}

template <typename T, int LAYOUT, int PY, int PX>
cudaError_t launch(const void* g, const void* w, float* out, int B, int C,
                   int H, int W, int OH, int OW, cudaStream_t st) {
  auto kernel = stem_dgrad_kernel<T, LAYOUT, PY, PX>;
  constexpr size_t smem = 2 * stage_bytes<T>();
  if (smem > 48 * 1024) {  // float32's buffers; bf16's fit the default
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = ((W + 1) / 2 + TX - 1) / TX;
  const int tiles_y = ((H + 1) / 2 + PAIR_ROWS - 1) / PAIR_ROWS;
  const long long blocks = (long long)B * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, dim3(TX, TY), smem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), out, C, H, W, OH, OW,
      tiles_x, tiles_y);
  return cudaGetLastError();
}

template <typename T, int LAYOUT>
cudaError_t by_parity(const void* g, const void* w, float* out, int B, int C,
                      int H, int W, int OH, int OW, int pad_top, int pad_left,
                      cudaStream_t st) {
  switch ((pad_top & 1) * 2 + (pad_left & 1)) {
    case 0:
      return launch<T, LAYOUT, 0, 0>(g, w, out, B, C, H, W, OH, OW, st);
    case 1:
      return launch<T, LAYOUT, 0, 1>(g, w, out, B, C, H, W, OH, OW, st);
    case 2:
      return launch<T, LAYOUT, 1, 0>(g, w, out, B, C, H, W, OH, OW, st);
    default:
      return launch<T, LAYOUT, 1, 1>(g, w, out, B, C, H, W, OH, OW, st);
  }
}

template <typename T>
cudaError_t by_layout(const void* g, const void* w, float* out, int B, int C,
                      int H, int W, int OH, int OW, int pad_top, int pad_left,
                      int layout, cudaStream_t st) {
  return layout == NCHW_VEC
             ? by_parity<T, NCHW_VEC>(g, w, out, B, C, H, W, OH, OW, pad_top,
                                      pad_left, st)
             : by_parity<T, NCHW>(g, w, out, B, C, H, W, OH, OW, pad_top,
                                  pad_left, st);
}

}  // namespace

// grad_out: (B, C, OH, OW) NCHW-contiguous in the compute dtype (bf16 when
// `bf16`, else float32); weight: (C, 1, 5, 5) contiguous in the same
// dtype; grad_in: (B, H, W) float32; pad_top, pad_left: the forward's SAME
// pads before the input (1 or 2).  layout 0: OW a multiple of 16 bytes
// and grad_out 16-byte aligned; 1: any other.
extern "C" int uad_stem_dgrad(const void* grad_out, const void* weight,
                              float* grad_in, int B, int C, int H, int W,
                              int OH, int OW, int pad_top, int pad_left,
                              int bf16, int layout, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? by_layout<__nv_bfloat16>(grad_out, weight, grad_in, B,
                                                C, H, W, OH, OW, pad_top,
                                                pad_left, layout, st)
                    : by_layout<float>(grad_out, weight, grad_in, B, C, H, W,
                                       OH, OW, pad_top, pad_left, layout, st));
}
