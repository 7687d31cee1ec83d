// Native tile loader for large microscopy mosaics.
//
// The batch pipelines (the displacement extractor's stack form and
// pygpa_tpu_torch.parallel) consume stacks of tiles cropped from
// multi-gigabyte stitched mosaics (8k^2+ LEEM scans). The reference
// stack leaves IO to dask's lazy chunking on the Python side; here tile
// extraction is a native, threaded, memory-mapped reader so host-side
// data preparation never stalls the device:
//  - the mosaic file is mmap'ed once (no read-ahead copies),
//  - N worker threads crop + convert tiles (u8/u16/f32/f64 -> f32)
//    directly into the caller's output buffer,
//  - optional per-tile mean subtraction (the pipelines' first step)
//    happens in the same pass over the data.
//
// File format ("GPAM"): 32-byte header
//   char[4] magic "GPAM"; u32 dtype (0=u8,1=u16,2=f32,3=f64);
//   u64 height; u64 width; u64 reserved
// followed by row-major pixel data.
//
// Exposed as a plain C ABI for ctypes (pygpa_tpu_torch/data.py builds it
// with g++ at first use). The same source as the JAX package's
// native/tileloader.cpp, so both read and write one format.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mosaic {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  uint32_t dtype = 0;
  uint64_t height = 0;
  uint64_t width = 0;
};

size_t dtype_size(uint32_t dt) {
  switch (dt) {
    case 0: return 1;
    case 1: return 2;
    case 2: return 4;
    case 3: return 8;
  }
  return 0;
}

template <typename T>
void crop_convert(const Mosaic* m, int64_t y0, int64_t x0, int64_t th,
                  int64_t tw, float* out, int normalize) {
  const T* data = reinterpret_cast<const T*>(m->base + 32);
  const int64_t H = static_cast<int64_t>(m->height);
  const int64_t W = static_cast<int64_t>(m->width);
  double sum = 0.0;
  for (int64_t r = 0; r < th; ++r) {
    // clamp rows/cols to the mosaic (edge tiles replicate the border)
    int64_t sr = y0 + r;
    sr = sr < 0 ? 0 : (sr >= H ? H - 1 : sr);
    const T* src = data + sr * W;
    float* dst = out + r * tw;
    for (int64_t c = 0; c < tw; ++c) {
      int64_t sc = x0 + c;
      sc = sc < 0 ? 0 : (sc >= W ? W - 1 : sc);
      float v = static_cast<float>(src[sc]);
      dst[c] = v;
      sum += v;
    }
  }
  if (normalize) {
    const float mean = static_cast<float>(sum / (th * tw));
    for (int64_t i = 0; i < th * tw; ++i) out[i] -= mean;
  }
}

void crop_dispatch(const Mosaic* m, int64_t y0, int64_t x0, int64_t th,
                   int64_t tw, float* out, int normalize) {
  switch (m->dtype) {
    case 0: crop_convert<uint8_t>(m, y0, x0, th, tw, out, normalize); break;
    case 1: crop_convert<uint16_t>(m, y0, x0, th, tw, out, normalize); break;
    case 2: crop_convert<float>(m, y0, x0, th, tw, out, normalize); break;
    case 3: crop_convert<double>(m, y0, x0, th, tw, out, normalize); break;
  }
}

}  // namespace

extern "C" {

void* tl_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* b = static_cast<const uint8_t*>(base);
  if (memcmp(b, "GPAM", 4) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Mosaic* m = new Mosaic();
  m->fd = fd;
  m->base = b;
  m->map_len = st.st_size;
  memcpy(&m->dtype, b + 4, 4);
  memcpy(&m->height, b + 8, 8);
  memcpy(&m->width, b + 16, 8);
  const size_t need = 32 + dtype_size(m->dtype) * m->height * m->width;
  if (dtype_size(m->dtype) == 0 || st.st_size < static_cast<off_t>(need)) {
    munmap(base, st.st_size);
    ::close(fd);
    delete m;
    return nullptr;
  }
  return m;
}

int tl_info(void* handle, uint32_t* dtype, uint64_t* height,
            uint64_t* width) {
  if (!handle) return -1;
  Mosaic* m = static_cast<Mosaic*>(handle);
  *dtype = m->dtype;
  *height = m->height;
  *width = m->width;
  return 0;
}

// Extract `ntiles` tiles of (th, tw) at offsets (ys[i], xs[i]) into
// `out` (ntiles * th * tw floats), using `nthreads` workers.
int tl_read_tiles(void* handle, const int64_t* ys, const int64_t* xs,
                  int64_t ntiles, int64_t th, int64_t tw, float* out,
                  int nthreads, int normalize) {
  if (!handle || ntiles < 0 || th <= 0 || tw <= 0) return -1;
  Mosaic* m = static_cast<Mosaic*>(handle);
  if (nthreads < 1) nthreads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= ntiles) break;
      crop_dispatch(m, ys[i], xs[i], th, tw, out + i * th * tw,
                    normalize);
    }
  };
  std::vector<std::thread> pool;
  int n = static_cast<int>(nthreads < ntiles ? nthreads : ntiles);
  for (int t = 1; t < n; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return 0;
}

void tl_close(void* handle) {
  if (!handle) return;
  Mosaic* m = static_cast<Mosaic*>(handle);
  munmap(const_cast<uint8_t*>(m->base), m->map_len);
  ::close(m->fd);
  delete m;
}

}  // extern "C"
