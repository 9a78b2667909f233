// Native host-side data-path kernels for the TPU-native brain-MRI
// anomaly-detection framework.
//
// The reference delegated its host preprocessing to OpenCV / scipy wheels
// (cv2.resize in `dataloaders/BRAINWEB.py:141-142`, percentile
// normalization in `utils/NII.py:53-75`); this library provides the same
// operations as a dependency-free C++ shared object driven through ctypes
// (see `data/native.py`), plus a binary slice-cache writer whose payload is
// readable with numpy memmap.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libuadmri_native.so
//        uadmri_native.cpp
//
// All functions are exported with C linkage and operate on caller-owned
// buffers (row-major float32 unless stated otherwise).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// numpy-compatible percentile (linear interpolation) of a copied buffer.
static float percentile(const float* data, int64_t n, float pct) {
  if (n <= 0) return 0.0f;
  std::vector<float> tmp(data, data + n);
  const double rank = (pct / 100.0) * (double)(n - 1);
  const int64_t lo = (int64_t)rank;
  const int64_t hi = std::min(lo + 1, n - 1);
  const double frac = rank - (double)lo;
  std::nth_element(tmp.begin(), tmp.begin() + lo, tmp.end());
  const float vlo = tmp[lo];
  std::nth_element(tmp.begin() + lo, tmp.begin() + hi, tmp.end());
  const float vhi = tmp[hi];
  return (float)((1.0 - frac) * vlo + frac * vhi);
}

// Percentile clamp + 'scaling' (0) or 'standardization' (1) — parity with
// utils/NII.py:53-75.  In-place.  Negative percentile arguments disable
// the corresponding clamp.
void uad_percentile_normalize(float* data, int64_t n, float lower_pct,
                              float upper_pct, int method) {
  if (n <= 0) return;
  if (lower_pct >= 0.0f) {
    const float qlow = percentile(data, n, lower_pct);
    for (int64_t i = 0; i < n; ++i) data[i] = std::max(data[i], qlow);
  }
  if (upper_pct >= 0.0f) {
    const float qup = percentile(data, n, upper_pct);
    for (int64_t i = 0; i < n; ++i) data[i] = std::min(data[i], qup);
  }
  if (method == 0) {
    float mx = data[0];
    for (int64_t i = 1; i < n; ++i) mx = std::max(mx, data[i]);
    if (mx > 0.0f) {
      const float inv = 1.0f / mx;
      for (int64_t i = 0; i < n; ++i) data[i] *= inv;
    }
  } else {
    double mean = 0.0;
    for (int64_t i = 0; i < n; ++i) mean += data[i];
    mean /= (double)n;
    double var = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double d = data[i] - mean;
      var += d * d;
    }
    const double stddev = std::max(std::sqrt(var / (double)n), 1e-8);
    for (int64_t i = 0; i < n; ++i)
      data[i] = (float)((data[i] - mean) / stddev);
  }
}

// Bilinear resize with cv2.INTER_LINEAR center-aligned sampling:
// src = (dst + 0.5) * scale - 0.5, edges clamped.
void uad_resize_bilinear(const float* src, int sh, int sw, float* dst,
                         int dh, int dw) {
  const double sy = (double)sh / (double)dh;
  const double sx = (double)sw / (double)dw;
  for (int y = 0; y < dh; ++y) {
    double fy = ((double)y + 0.5) * sy - 0.5;
    fy = std::max(0.0, std::min(fy, (double)(sh - 1)));
    const int y0 = (int)fy;
    const int y1 = std::min(y0 + 1, sh - 1);
    const double wy = fy - (double)y0;
    for (int x = 0; x < dw; ++x) {
      double fx = ((double)x + 0.5) * sx - 0.5;
      fx = std::max(0.0, std::min(fx, (double)(sw - 1)));
      const int x0 = (int)fx;
      const int x1 = std::min(x0 + 1, sw - 1);
      const double wx = fx - (double)x0;
      const double top =
          (1.0 - wx) * src[y0 * sw + x0] + wx * src[y0 * sw + x1];
      const double bot =
          (1.0 - wx) * src[y1 * sw + x0] + wx * src[y1 * sw + x1];
      dst[y * dw + x] = (float)((1.0 - wy) * top + wy * bot);
    }
  }
}

// Nearest-neighbour resize with cv2.INTER_NEAREST semantics
// (floor(dst * scale)).
void uad_resize_nearest(const float* src, int sh, int sw, float* dst,
                        int dh, int dw) {
  const double sy = (double)sh / (double)dh;
  const double sx = (double)sw / (double)dw;
  for (int y = 0; y < dh; ++y) {
    int yy = std::min((int)(y * sy), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xx = std::min((int)(x * sx), sw - 1);
      dst[y * dw + x] = src[yy * sw + xx];
    }
  }
}

// ---------------------------------------------------------------------------
// binary slice cache: magic | int64 n | int32 h | int32 w |
//   images f32[n*h*w] | labels f32[n*h*w] | sets i32[n]
// The payload is laid out for zero-copy numpy memmap on the Python side.

static const char kMagic[8] = {'U', 'A', 'D', 'C', '0', '0', '0', '1'};

int uad_write_cache(const char* path, const float* images,
                    const float* labels, const int32_t* sets, int64_t n,
                    int32_t h, int32_t w) {
  // Write to a temp sibling and rename into place: a process killed
  // mid-write must not leave a truncated file whose valid magic/header
  // passes uad_read_cache_header and then permanently crashes the
  // memmap-based loader until the user deletes it by hand.
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  int ok = 1;
  ok &= std::fwrite(kMagic, 1, 8, f) == 8;
  ok &= std::fwrite(&n, sizeof(n), 1, f) == 1;
  ok &= std::fwrite(&h, sizeof(h), 1, f) == 1;
  ok &= std::fwrite(&w, sizeof(w), 1, f) == 1;
  const size_t hw = (size_t)h * (size_t)w;
  ok &= std::fwrite(images, sizeof(float), (size_t)n * hw, f) ==
        (size_t)n * hw;
  ok &= std::fwrite(labels, sizeof(float), (size_t)n * hw, f) ==
        (size_t)n * hw;
  ok &= std::fwrite(sets, sizeof(int32_t), (size_t)n, f) == (size_t)n;
  ok &= std::fclose(f) == 0;
  if (!ok) {
    std::remove(tmp.c_str());
    return -2;
  }
  if (std::rename(tmp.c_str(), path) != 0) {
    std::remove(tmp.c_str());
    return -3;
  }
  return 0;
}

// CRC32C (Castagnoli, reflected poly 0x82F63B78) — the checksum of the
// TFRecord framing (`utils/tfrecord_utils.py` wrote TFRecord slice caches;
// `data/tfrecord.py` reads/writes them without TensorFlow and verifies
// payloads through this slice-by-8 table implementation).
static uint32_t kCrcTab[8][256];
static bool crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
    kCrcTab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      kCrcTab[t][i] =
          (kCrcTab[t - 1][i] >> 8) ^ kCrcTab[0][kCrcTab[t - 1][i] & 0xFF];
  return true;
}
static const bool kCrcReady = crc_init();

uint32_t uad_crc32c(const uint8_t* data, int64_t n, uint32_t seed) {
  (void)kCrcReady;
  uint32_t crc = ~seed;
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrcTab[7][lo & 0xFF] ^ kCrcTab[6][(lo >> 8) & 0xFF] ^
          kCrcTab[5][(lo >> 16) & 0xFF] ^ kCrcTab[4][lo >> 24] ^
          kCrcTab[3][hi & 0xFF] ^ kCrcTab[2][(hi >> 8) & 0xFF] ^
          kCrcTab[1][(hi >> 16) & 0xFF] ^ kCrcTab[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ kCrcTab[0][(crc ^ *data++) & 0xFF];
  return ~crc;
}

int uad_read_cache_header(const char* path, int64_t* n, int32_t* h,
                          int32_t* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[8];
  int ok = 1;
  ok &= std::fread(magic, 1, 8, f) == 8;
  ok &= std::memcmp(magic, kMagic, 8) == 0;
  ok &= std::fread(n, sizeof(*n), 1, f) == 1;
  ok &= std::fread(h, sizeof(*h), 1, f) == 1;
  ok &= std::fread(w, sizeof(*w), 1, f) == 1;
  std::fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"
