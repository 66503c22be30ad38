// Native sample-stream IO layer: mmap'd raw capture files -> framed f32
// blocks for the analyzer pipelines.
//
// The reference's verification flow hands samples between tools as raw
// files (hls/windows/window_test.cpp:54-56 writes dout.dat/golden_dat.dat;
// cpp/cordic_sincos.cpp:131 writes math/coe.dat for Octave).  Production
// SDR captures arrive the same way: raw int8/int16/interleaved-IQ streams.
// This is the framework's host-side ingest runtime, in C++ because the
// host does the format conversion while the device computes: mmap (zero-copy
// until touched) + tight conversion loops, random block access for the
// resumable streaming cursor (utils/streaming.py: state == block index).
//
// Exposed via ctypes (blackman_harris_win/utils/io.py).  All offsets
// and counts are in SAMPLES of the file's native format.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Source {
  int fd;
  const uint8_t* base;
  int64_t bytes;
};

}  // namespace

extern "C" {

// Returns a handle (heap pointer) or nullptr on failure.
void* sio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  Source* s = new Source{fd, (const uint8_t*)p, (int64_t)st.st_size};
  return s;
}

int64_t sio_size_bytes(void* h) { return ((Source*)h)->bytes; }

void sio_close(void* h) {
  Source* s = (Source*)h;
  munmap((void*)s->base, (size_t)s->bytes);
  ::close(s->fd);
  delete s;
}

// Each converter returns the number of samples actually produced
// (clamped at end-of-file); missing tail is NOT zero-filled.

int64_t sio_read_i8_f32(void* h, int64_t off, int64_t count, float scale,
                        float* out) {
  Source* s = (Source*)h;
  const int64_t total = s->bytes;
  if (off < 0 || off >= total) return 0;
  int64_t n = count < total - off ? count : total - off;
  const int8_t* p = (const int8_t*)(s->base + off);
  for (int64_t i = 0; i < n; ++i) out[i] = scale * (float)p[i];
  return n;
}

int64_t sio_read_i16_f32(void* h, int64_t off, int64_t count, float scale,
                         float* out) {
  Source* s = (Source*)h;
  const int64_t total = s->bytes / 2;
  if (off < 0 || off >= total) return 0;
  int64_t n = count < total - off ? count : total - off;
  const int16_t* p = (const int16_t*)s->base + off;
  for (int64_t i = 0; i < n; ++i) out[i] = scale * (float)p[i];
  return n;
}

int64_t sio_read_f32(void* h, int64_t off, int64_t count, float scale,
                     float* out) {
  Source* s = (Source*)h;
  const int64_t total = s->bytes / 4;
  if (off < 0 || off >= total) return 0;
  int64_t n = count < total - off ? count : total - off;
  const float* p = (const float*)s->base + off;
  if (scale == 1.0f) {
    memcpy(out, p, (size_t)n * 4);
  } else {
    for (int64_t i = 0; i < n; ++i) out[i] = scale * p[i];
  }
  return n;
}

// Interleaved complex int16 IQ -> split I/Q f32 (offsets in IQ PAIRS).
int64_t sio_read_ci16_f32(void* h, int64_t off, int64_t count, float scale,
                          float* out_i, float* out_q) {
  Source* s = (Source*)h;
  const int64_t total = s->bytes / 4;  // 4 bytes per IQ pair
  if (off < 0 || off >= total) return 0;
  int64_t n = count < total - off ? count : total - off;
  const int16_t* p = (const int16_t*)s->base + 2 * off;
  for (int64_t i = 0; i < n; ++i) {
    out_i[i] = scale * (float)p[2 * i];
    out_q[i] = scale * (float)p[2 * i + 1];
  }
  return n;
}

// Block checksum over the raw bytes (for resume-integrity checks).
uint64_t sio_checksum(void* h, int64_t byte_off, int64_t nbytes) {
  Source* s = (Source*)h;
  if (byte_off < 0 || byte_off >= s->bytes) return 0;
  int64_t n = nbytes < s->bytes - byte_off ? nbytes : s->bytes - byte_off;
  const uint8_t* p = s->base + byte_off;
  uint64_t acc = 1469598103934665603ull;  // FNV-1a
  for (int64_t i = 0; i < n; ++i) {
    acc ^= p[i];
    acc *= 1099511628211ull;
  }
  return acc;
}

// Writer: raw little-endian int32 (the quantized window format used by the
// CLI's gen --out and the reference's .dat handoffs).
int64_t sio_write_i32(const char* path, const int32_t* data, int64_t count) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  int64_t left = count * 4;
  const uint8_t* p = (const uint8_t*)data;
  while (left > 0) {
    ssize_t k = ::write(fd, p, (size_t)left);
    if (k <= 0) {
      ::close(fd);
      return -1;
    }
    left -= k;
    p += k;
  }
  ::close(fd);
  return count;
}

}  // extern "C"
