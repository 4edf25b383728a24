// Native streaming field I/O for large checkpoints.
//
// The reference's checkpoint path is native C end-to-end (parallel
// CGNS/HDF5 via pcgnslib + MPI-IO, fluca/src/viewer/impl/flucacgns/
// flucacgns.c); this is the framework's native-runtime
// counterpart for the high-volume path: raw chunked pwrite/pread of
// field buffers with CRC32 integrity, bypassing Python-level copies
// and zip containers (numpy savez) that dominate at 512^3-scale
// fields. Exposed via a minimal C ABI loaded with ctypes
// (fluca_tpu/native/__init__.py).
//
// File layout: [magic u64][nbytes u64][crc32 u64][payload bytes]

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x464c5543414e4154ull;  // "FLUCANAT"
constexpr size_t kChunk = 8u << 20;                 // 8 MiB chunks

uint32_t crc32_update(uint32_t crc, const unsigned char* buf, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < len; i++)
    crc = table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // namespace

extern "C" {

// Returns 0 on success, negative errno-style codes on failure.
int fluca_fastio_write(const char* path, const void* data,
                       uint64_t nbytes) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  uint32_t crc = crc32_update(0, static_cast<const unsigned char*>(data),
                              nbytes);
  uint64_t header[3] = {kMagic, nbytes, crc};
  if (pwrite(fd, header, sizeof(header), 0) !=
      static_cast<ssize_t>(sizeof(header))) {
    close(fd);
    return -2;
  }
  const char* p = static_cast<const char*>(data);
  uint64_t off = sizeof(header);
  uint64_t left = nbytes;
  while (left > 0) {
    size_t n = left < kChunk ? left : kChunk;
    ssize_t w = pwrite(fd, p, n, off);
    if (w <= 0) {
      close(fd);
      return -3;
    }
    p += w;
    off += w;
    left -= w;
  }
  if (fsync(fd) != 0) {
    close(fd);
    return -4;
  }
  close(fd);
  return 0;
}

// Reads payload into `data` (caller allocates `nbytes`); verifies
// magic, size and CRC. Returns 0 on success.
int fluca_fastio_read(const char* path, void* data, uint64_t nbytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  uint64_t header[3];
  if (pread(fd, header, sizeof(header), 0) !=
      static_cast<ssize_t>(sizeof(header))) {
    close(fd);
    return -2;
  }
  if (header[0] != kMagic || header[1] != nbytes) {
    close(fd);
    return -5;
  }
  char* p = static_cast<char*>(data);
  uint64_t off = sizeof(header);
  uint64_t left = nbytes;
  while (left > 0) {
    size_t n = left < kChunk ? left : kChunk;
    ssize_t r = pread(fd, p, n, off);
    if (r <= 0) {
      close(fd);
      return -3;
    }
    p += r;
    off += r;
    left -= r;
  }
  close(fd);
  uint32_t crc = crc32_update(0, static_cast<const unsigned char*>(data),
                              nbytes);
  if (crc != static_cast<uint32_t>(header[2])) return -6;
  return 0;
}

// Size query: returns payload size or negative error.
int64_t fluca_fastio_size(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  uint64_t header[3];
  ssize_t r = pread(fd, header, sizeof(header), 0);
  close(fd);
  if (r != static_cast<ssize_t>(sizeof(header)) || header[0] != kMagic)
    return -2;
  return static_cast<int64_t>(header[1]);
}

}  // extern "C"
