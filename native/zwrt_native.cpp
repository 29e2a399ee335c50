// Native runtime pieces for zig_weekend_raytracer_tpu.
//
// Equivalents of the reference's native components:
//  * zwrt_write_ppm: parallel mmap'd PPM (P3) text writer — the analog of
//    the reference's WriterPPM (src/writer/writer.zig:16-51): the output
//    file is created at its exact final size, mmap'd shared, and pixel
//    chunks are formatted into disjoint byte ranges by a thread pool
//    (no locks; ranges are precomputed, so writes never overlap).
//  * zwrt_decode_image: JPG/PNG decode via the vendored public-domain
//    stb_image (the same library the reference wraps through zstbi).
//
// Exposed with a plain C ABI for ctypes binding (no pybind11 available).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#define STB_IMAGE_IMPLEMENTATION
#define STBI_NO_FAILURE_STRINGS
#include "third_party/stb/stb_image.h"

namespace {

// Byte length of the decimal representation of a u8 (1..3).
inline int digit_len(uint8_t v) { return v >= 100 ? 3 : (v >= 10 ? 2 : 1); }

// Length of one "r g b\n" pixel line.
inline int line_len(const uint8_t* px) {
  return digit_len(px[0]) + digit_len(px[1]) + digit_len(px[2]) + 3;
}

inline char* write_u8(char* p, uint8_t v) {
  if (v >= 100) {
    *p++ = static_cast<char>('0' + v / 100);
    v = static_cast<uint8_t>(v % 100);
    *p++ = static_cast<char>('0' + v / 10);
    *p++ = static_cast<char>('0' + v % 10);
  } else if (v >= 10) {
    *p++ = static_cast<char>('0' + v / 10);
    *p++ = static_cast<char>('0' + v % 10);
  } else {
    *p++ = static_cast<char>('0' + v);
  }
  return p;
}

}  // namespace

extern "C" {

// pixels: (h, w, 3) u8, row-major. Returns 0 on success, negative errno-ish
// codes on failure.
int zwrt_write_ppm(const char* path, const uint8_t* pixels, int64_t w,
                   int64_t h, int n_threads) {
  const int64_t n_px = w * h;
  char header[64];
  const int header_len =
      std::snprintf(header, sizeof(header), "P3\n%lld %lld\n255\n",
                    static_cast<long long>(w), static_cast<long long>(h));

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 8;
  }

  // Pass 1 (parallel): per-chunk byte sizes -> exact file size + offsets.
  const int64_t chunk = 1 << 16;
  const int64_t n_chunks = (n_px + chunk - 1) / chunk;
  std::vector<int64_t> chunk_bytes(n_chunks, 0);
  {
    std::vector<std::thread> ts;
    std::int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t c0 = t * per, c1 = std::min(n_chunks, c0 + per);
      if (c0 >= c1) break;
      ts.emplace_back([&, c0, c1] {
        for (int64_t c = c0; c < c1; ++c) {
          const int64_t p0 = c * chunk, p1 = std::min(n_px, p0 + chunk);
          int64_t bytes = 0;
          for (int64_t p = p0; p < p1; ++p) bytes += line_len(pixels + 3 * p);
          chunk_bytes[c] = bytes;
        }
      });
    }
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> offsets(n_chunks + 1);
  offsets[0] = header_len;
  for (int64_t c = 0; c < n_chunks; ++c)
    offsets[c + 1] = offsets[c] + chunk_bytes[c];
  const int64_t total = offsets[n_chunks];

  // Create the file at its final size and mmap it shared
  // (analog of src/writer/mmap.zig:10-29).
  const int fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (::ftruncate(fd, total) != 0) {
    ::close(fd);
    return -2;
  }
  char* map = static_cast<char*>(
      ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (map == MAP_FAILED) {
    ::close(fd);
    return -3;
  }

  std::memcpy(map, header, header_len);

  // Pass 2 (parallel): format pixel lines into disjoint mmap ranges.
  {
    std::vector<std::thread> ts;
    std::int64_t per = (n_chunks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t c0 = t * per, c1 = std::min(n_chunks, c0 + per);
      if (c0 >= c1) break;
      ts.emplace_back([&, c0, c1] {
        for (int64_t c = c0; c < c1; ++c) {
          const int64_t p0 = c * chunk, p1 = std::min(n_px, p0 + chunk);
          char* out = map + offsets[c];
          for (int64_t p = p0; p < p1; ++p) {
            const uint8_t* px = pixels + 3 * p;
            out = write_u8(out, px[0]);
            *out++ = ' ';
            out = write_u8(out, px[1]);
            *out++ = ' ';
            out = write_u8(out, px[2]);
            *out++ = '\n';
          }
        }
      });
    }
    for (auto& t : ts) t.join();
  }

  ::munmap(map, total);
  ::close(fd);
  return 0;
}

// Decode an in-memory JPG/PNG to tightly packed RGB8. Caller frees with
// zwrt_free. Returns nullptr on failure.
uint8_t* zwrt_decode_image(const uint8_t* data, int64_t len, int* out_w,
                           int* out_h, int* out_c) {
  int w = 0, h = 0, comp = 0;
  unsigned char* px =
      stbi_load_from_memory(data, static_cast<int>(len), &w, &h, &comp, 3);
  if (!px) return nullptr;
  *out_w = w;
  *out_h = h;
  *out_c = 3;
  return px;
}

void zwrt_free(void* ptr) { stbi_image_free(ptr); }

}  // extern "C"
