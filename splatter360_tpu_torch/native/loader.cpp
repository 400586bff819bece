// splat360 native scene-shard loader (the PyTorch port's copy of
// splatter360_tpu/native/loader.cpp; the same format and C API).
//
// A shard (.s3z) holds a whole scene trajectory as per-frame zstd blocks,
// decoded by a pthread worker pool straight into caller-provided numpy
// buffers: no Python in the decode loop. Cube faces are resampled on the
// device, so the host pipeline only decodes and gathers frames.
//
// Format (little-endian):
//   magic "S3Z1" | u32 n_frames | u32 h | u32 w
//   f32 poses[n_frames*16]
//   u64 rgb_off[n_frames] | u64 rgb_size[n_frames]
//   u64 dep_off[n_frames] | u64 dep_size[n_frames]
//   blob data (zstd frames; rgb: u8 h*w*3, depth: u16 h*w, offsets into blob)
//
// C API (ctypes): see __init__.py beside this file.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// The few zstd functions used here, declared as zstd.h declares them, so that
// the loader builds against the runtime library alone (libzstd.so.1, no
// headers); __init__.py links it by path or soname.
extern "C" {
size_t ZSTD_compress(void* dst, size_t dst_cap, const void* src, size_t src_size, int level);
size_t ZSTD_decompress(void* dst, size_t dst_cap, const void* src, size_t src_size);
size_t ZSTD_compressBound(size_t src_size);
unsigned ZSTD_isError(size_t code);
}

namespace {

struct Shard {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  uint32_t n_frames = 0, h = 0, w = 0;
  const float* poses = nullptr;
  const uint64_t* rgb_off = nullptr;
  const uint64_t* rgb_size = nullptr;
  const uint64_t* dep_off = nullptr;
  const uint64_t* dep_size = nullptr;
  const uint8_t* blob = nullptr;
};

}  // namespace

extern "C" {

void* s3_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { ::close(fd); return nullptr; }
  auto* s = new Shard();
  s->fd = fd;
  s->map = static_cast<const uint8_t*>(map);
  s->map_size = st.st_size;
  const uint8_t* p = s->map;
  if (memcmp(p, "S3Z1", 4) != 0) { ::close(fd); delete s; return nullptr; }
  p += 4;
  memcpy(&s->n_frames, p, 4); p += 4;
  memcpy(&s->h, p, 4); p += 4;
  memcpy(&s->w, p, 4); p += 4;
  s->poses = reinterpret_cast<const float*>(p);
  p += sizeof(float) * 16 * s->n_frames;
  s->rgb_off = reinterpret_cast<const uint64_t*>(p);
  p += 8 * s->n_frames;
  s->rgb_size = reinterpret_cast<const uint64_t*>(p);
  p += 8 * s->n_frames;
  s->dep_off = reinterpret_cast<const uint64_t*>(p);
  p += 8 * s->n_frames;
  s->dep_size = reinterpret_cast<const uint64_t*>(p);
  p += 8 * s->n_frames;
  s->blob = p;
  return s;
}

void s3_close(void* handle) {
  auto* s = static_cast<Shard*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->map), s->map_size);
  ::close(s->fd);
  delete s;
}

int s3_info(void* handle, uint32_t* n_frames, uint32_t* h, uint32_t* w) {
  auto* s = static_cast<Shard*>(handle);
  if (!s) return -1;
  *n_frames = s->n_frames; *h = s->h; *w = s->w;
  return 0;
}

void s3_poses(void* handle, float* out) {
  auto* s = static_cast<Shard*>(handle);
  memcpy(out, s->poses, sizeof(float) * 16 * s->n_frames);
}

// Decode the given frames' RGB (u8 [n, h, w, 3]) and depth (u16 [n, h, w]) into the
// caller's buffers using `n_threads` workers. Returns 0 on success.
int s3_decode_frames(void* handle, const int32_t* indices, int32_t n,
                     uint8_t* out_rgb, uint16_t* out_depth, int32_t n_threads) {
  auto* s = static_cast<Shard*>(handle);
  if (!s) return -1;
  const size_t rgb_bytes = size_t(s->h) * s->w * 3;
  const size_t dep_bytes = size_t(s->h) * s->w * 2;
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t f = indices[i];
      if (f < 0 || uint32_t(f) >= s->n_frames) { err.store(1); return; }
      size_t got = ZSTD_decompress(out_rgb + size_t(i) * rgb_bytes, rgb_bytes,
                                   s->blob + s->rgb_off[f], s->rgb_size[f]);
      if (ZSTD_isError(got) || got != rgb_bytes) { err.store(2); return; }
      if (out_depth) {
        got = ZSTD_decompress(out_depth + size_t(i) * s->h * s->w, dep_bytes,
                              s->blob + s->dep_off[f], s->dep_size[f]);
        if (ZSTD_isError(got) || got != dep_bytes) { err.store(3); return; }
      }
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return err.load();
}

// zstd helpers so the Python writer needs no separate binding.
int64_t s3_zstd_compress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                         int64_t dst_cap, int level) {
  size_t got = ZSTD_compress(dst, dst_cap, src, src_len, level);
  if (ZSTD_isError(got)) return -1;
  return int64_t(got);
}

int64_t s3_zstd_bound(int64_t src_len) {
  return int64_t(ZSTD_compressBound(src_len));
}

}  // extern "C"
