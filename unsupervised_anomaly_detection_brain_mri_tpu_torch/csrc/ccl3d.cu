// 26-connected components of a stack of binary volumes (n, S, H, W) and
// the size filter, by lock-free union-find in a fixed chain of launches.
//
// Replaces no TPU kernel: the JAX package labels by min-label propagation
// in plain jnp (`unsupervised_anomaly_detection_brain_mri_tpu/ops/
// postprocess.py::connected_components_3d`, one lax.while_loop on the
// device).  The port's plain version runs the same propagation from the
// host, one convergence test (a host sync) a round and ~58 small launches
// a round; on the card this chain replaces it with four kernels and no
// read-back, whatever the lesion load.
//
// The labels are the propagation's fixpoint: 0 for background, else
// 1 + the flat index (within its volume) of the component's minimal
// voxel.  One int32 array `lab` holds 1 + each voxel's parent, so a root r
// has lab[r] == r + 1 and a background voxel 0.  A link always hangs the
// larger root under the smaller (atomicMin), so every parent is smaller
// than its child and each set's root is its minimal index; after the
// compression every foreground entry is 1 + its root, which is the label.
//
//   1. init: lab[i] = mask[i] ? i + 1 : 0;
//   2. merge: each foreground voxel unites with its 13 foreground
//      neighbours that precede it in raster order (the other 13 of the 26
//      unite with it from their side), inside its own volume.  A union
//      finds both roots (reads only, as in Playne & Hawick, IEEE TPDS 2018,
//      and Allegretti et al.'s block-based union-find, 2019) and links the
//      larger under the smaller with atomicMin; where atomicMin finds that
//      root already linked, the union goes on from the value it read, so
//      each retry starts from a strictly smaller index and ends;
//   3. compress: each foreground voxel writes 1 + its root (plain stores:
//      no link changes any more, and a root is a valid parent for every
//      voxel of its set), and, for the size filter, adds one to
//      sizes[root], one atomicAdd per group of lanes of a warp that share
//      a root (__match_any_sync);
//   4. filter: out = (lab > 0 && sizes[lab - 1] > min_size) ? 1 : 0, as
//      float32.
//
// A grid row (blockIdx.y) is one volume, so no index, parent or size
// crosses from one volume into the next; within a volume every index is
// an int32 (the wrapper checks S * H * W < 2^31 - 1).
//
// What bounds it on an H100: bytes and the launches themselves.  At the
// serving shape (181, 128, 128) the mask is 2.97 MB, `lab` and `sizes`
// 11.9 MB each (both stay in the 50 MB L2, so the roots' scattered reads
// hit it) and the float32 output 11.9 MB: the chain moves ~60 MB in all,
// while the least traffic (the mask read once, the output written once) is
// 14.8 MB, 4.4 us at 3.35 TB/s.  A served mask is mostly background, so
// the merge's per-voxel union work touches few voxels; a dense random
// mask (density 0.5, above 26-connectivity's percolation point) makes one
// component snake through the volume and serialises its count on one
// address, which the warp aggregation divides by up to 32.
//
// Measured on an H100 (700 W, CUDA 12.8; chip_smoke.py phase 2b) at
// (181, 128, 128) on lesion blobs (1.4 % foreground, 1,238 components):
// 0.117 ms of device time in 5 launches (merge 0.083, init 0.011,
// compress 0.010, filter 0.009, the zeroing of `sizes` 0.004), 0.126 ms a
// call back to back; 0.83 ms on a density-0.5 mask.  The plain
// propagation takes 7.75 ms (7 rounds, 455 launches).  The merge leads,
// its finds bound by L2 latency; uniting each block's tile in shared
// memory first (Playne & Hawick's and Allegretti et al.'s block variants)
// could shorten it, but the whole chain is ~0.4 % of a served request, so
// the plain global-memory merge is kept.  ptxas: 32 registers (merge),
// 10-14 (the others), no spills, no shared memory.
//
// Interface: one plain C function, bound from Python with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// the root of n: follow 1 + parent until an entry names itself
__device__ __forceinline__ int find_root(const int* lab, int n) {
  int p = lab[n] - 1;
  while (p != n) {
    n = p;
    p = lab[n] - 1;
  }
  return n;
}

__device__ __forceinline__ void unite(int* lab, int a, int b) {
  bool done;
  do {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a < b) {
      const int old = atomicMin(lab + b, a + 1);
      done = (old == b + 1);
      b = old - 1;
    } else if (b < a) {
      const int old = atomicMin(lab + a, b + 1);
      done = (old == a + 1);
      a = old - 1;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(BLOCK)
ccl_init(const uint8_t* __restrict__ mask, int* __restrict__ lab, int per) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= per) return;
  const size_t at = (size_t)blockIdx.y * per + i;
  lab[at] = mask[at] ? i + 1 : 0;
}

__global__ void __launch_bounds__(BLOCK)
ccl_merge(const uint8_t* __restrict__ mask, int* lab, int S, int H, int W) {
  const int HW = H * W;
  const int per = S * HW;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= per) return;
  const size_t base = (size_t)blockIdx.y * per;
  const uint8_t* m = mask + base;
  if (!m[i]) return;
  int* L = lab + base;
  const int z = i / HW;
  const int r = i - z * HW;
  const int y = r / W;
  const int x = r - y * W;
  // the 13 neighbours before (z, y, x) in raster order: the 9 of slice
  // z - 1, the 3 of row y - 1, then (z, y, x - 1)
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    const int dz = k < 9 ? -1 : 0;
    const int dy = k < 9 ? k / 3 - 1 : (k < 12 ? -1 : 0);
    const int dx = k < 9 ? k % 3 - 1 : (k < 12 ? k - 10 : -1);
    if (z + dz < 0 || y + dy < 0 || y + dy >= H || x + dx < 0
        || x + dx >= W) {
      continue;
    }
    const int j = i + dz * HW + dy * W + dx;
    if (m[j]) unite(L, i, j);
  }
}

__global__ void __launch_bounds__(BLOCK)
ccl_compress(int* lab, int* __restrict__ sizes, int per) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const size_t base = (size_t)blockIdx.y * per;
  int root = -1;
  if (i < per && lab[base + i] != 0) {
    root = find_root(lab + base, i);
    lab[base + i] = root + 1;
  }
  if (sizes == nullptr) return;
  // every lane of the warp takes part (a block is whole warps and one
  // volume); lanes that share a root add their count once
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, root);
  if (root >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(sizes + base + root, __popc(peers));
  }
}

__global__ void __launch_bounds__(BLOCK)
ccl_filter(const int* __restrict__ lab, const int* __restrict__ sizes,
           float* __restrict__ out, int per, int min_size) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= per) return;
  const size_t base = (size_t)blockIdx.y * per;
  const int l = lab[base + i];
  out[base + i] = (l > 0 && sizes[base + l - 1] > min_size) ? 1.0f : 0.0f;
}

}  // namespace

// Labels `n_vol` volumes of S x H x W into `lab` (int32).  With `sizes`
// (int32, zeroed, as many entries as voxels) also counts each component's
// voxels at its root; with `out` (float32) as well, writes the mask of the
// components of more than `min_size` voxels.  The shapes' limits (at
// least one voxel, at most 65,535 volumes, S * H * W < 2^31 - 1) are
// checked by the one caller, ops/ccl.py.  Returns cudaGetLastError()
// after the first launch that fails, or after the last.
extern "C" int uad_ccl3d(const uint8_t* mask, int* lab, int* sizes,
                         float* out, int n_vol, int S, int H, int W,
                         int min_size, void* stream) {
  const int per = S * H * W;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((per + BLOCK - 1) / BLOCK, n_vol, 1);
  cudaError_t err;
  ccl_init<<<grid, BLOCK, 0, st>>>(mask, lab, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ccl_merge<<<grid, BLOCK, 0, st>>>(mask, lab, S, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ccl_compress<<<grid, BLOCK, 0, st>>>(lab, sizes, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (out) {
    ccl_filter<<<grid, BLOCK, 0, st>>>(lab, sizes, out, per, min_size);
  }
  return (int)cudaGetLastError();
}
