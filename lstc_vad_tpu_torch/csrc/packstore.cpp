// Native reader of the .lstcpack feature store: mmap + zero-copy clip gather.
//
// The package's own copy of the JAX package's csrc/packstore.cpp, with the
// same C interface and the same validation; it is host C++, built with g++
// at first use (ops/_build.py) and bound with ctypes (data/packed.py).
//
// The reference reads HDF5 through h5py per item (utils/load_dataset.py:
// 285-286, 409-415): decompression, allocation and GIL-bound copies in the
// training hot loop.  This store memory-maps a flat binary pack (written once
// by data/packed.py::write_pack or pack_h5) and serves:
//   - ps_get:    whole-video copy into a caller buffer
//   - ps_gather: selected clips (the sampler's window indices), sliced to
//                n_patch patches, copied straight from the mapped pages
//   - ps_gather_pair_batch: one call per training batch — every (video,
//                window-indices) pair of the batch gathered back-to-back,
//                fanned out over worker threads.
//
// Layout (little-endian):
//   [0..7]   magic "LSTCPK01"
//   [8..11]  u32 n_videos
//   [12..19] u64 index_offset
//   payload: per-video float32 [n_clips, n_patch, d_model], 64-byte aligned
//   index at index_offset, per video:
//     u32 key_len | key bytes | u64 offset | u32 n_clips | u32 n_patch |
//     u32 d_model
//
// The format is fully validated at open: the index walk is bounds-checked
// against the mapped size and every entry's payload extent
// (offset + n_clips*n_patch*d_model*4, overflow-checked) must lie inside the
// file — a truncated, bit-flipped or hostile pack fails ps_open_checked with
// a distinct error code instead of reading past the mapping in ps_get /
// ps_gather.  The numpy reader (data/packed.py::_NumpyPack) applies the same
// checks.
//
// What bounds it: host memory bandwidth on the copies out of the page cache
// (a sht_ltn batch is 80 x 48 clips x 16 x 2048 x 4 B = 503 MB); the batch
// gather splits its items over the host's cores.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct VideoEntry {
  uint64_t offset;
  uint32_t n_clips;
  uint32_t n_patch;
  uint32_t d_model;
};

struct PackStore {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::unordered_map<std::string, VideoEntry> index;
};

template <typename T>
T read_le(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

extern "C" {

// ps_open_checked error codes (written to *err when the return is null):
enum {
  PS_OK = 0,
  PS_ERR_IO = 1,        // open/fstat/mmap failed
  PS_ERR_HEADER = 2,    // too small for a header, or bad magic
  PS_ERR_INDEX = 3,     // index walk runs past the end of the file
  PS_ERR_EXTENT = 4,    // a payload extent overflows or exceeds the file
  PS_ERR_DUPKEY = 5,    // the same key indexed twice (readers would disagree
                        // on which entry wins -> caller buffer overflow)
};

void* ps_open_checked(const char* path, int32_t* err) {
  int32_t scratch;
  if (!err) err = &scratch;
  *err = PS_ERR_IO;
  auto* ps = new PackStore();
  ps->fd = ::open(path, O_RDONLY);
  if (ps->fd < 0) { delete ps; return nullptr; }
  struct stat st;
  if (fstat(ps->fd, &st) != 0) { ::close(ps->fd); delete ps; return nullptr; }
  ps->size = static_cast<size_t>(st.st_size);
  void* m = ps->size ? mmap(nullptr, ps->size, PROT_READ, MAP_SHARED,
                            ps->fd, 0)
                     : MAP_FAILED;
  if (m == MAP_FAILED) { ::close(ps->fd); delete ps; return nullptr; }
  ps->base = static_cast<const uint8_t*>(m);
  auto fail = [&](int32_t code) -> void* {
    *err = code;
    munmap(m, ps->size); ::close(ps->fd); delete ps;
    return nullptr;
  };
  if (ps->size < 20 || std::memcmp(ps->base, "LSTCPK01", 8) != 0)
    return fail(PS_ERR_HEADER);
  const uint8_t* p = ps->base + 8;
  uint32_t n_videos = read_le<uint32_t>(p);
  uint64_t index_offset = read_le<uint64_t>(p);
  if (index_offset > ps->size) return fail(PS_ERR_INDEX);
  p = ps->base + index_offset;
  const uint8_t* end = ps->base + ps->size;
  // remaining bytes from p — the walk below re-checks before every advance
  auto have = [&](size_t n) {
    return static_cast<size_t>(end - p) >= n;
  };
  for (uint32_t i = 0; i < n_videos; ++i) {
    if (!have(4)) return fail(PS_ERR_INDEX);
    uint32_t key_len = read_le<uint32_t>(p);
    if (!have(static_cast<size_t>(key_len) + 20)) return fail(PS_ERR_INDEX);
    std::string key(reinterpret_cast<const char*>(p), key_len);
    p += key_len;
    VideoEntry e;
    e.offset = read_le<uint64_t>(p);
    e.n_clips = read_le<uint32_t>(p);
    e.n_patch = read_le<uint32_t>(p);
    e.d_model = read_le<uint32_t>(p);
    // payload extent must fit in the file; the byte count is computed with
    // explicit overflow checks (u32*u32 fits u64; the *4 and the compare
    // are guarded by division)
    uint64_t rows = static_cast<uint64_t>(e.n_clips) * e.n_patch;
    if (e.d_model != 0 && rows > UINT64_MAX / 4 / e.d_model)
      return fail(PS_ERR_EXTENT);
    uint64_t bytes = rows * e.d_model * 4;
    if (e.offset > ps->size || bytes > ps->size - e.offset)
      return fail(PS_ERR_EXTENT);
    if (!ps->index.emplace(std::move(key), e).second)
      return fail(PS_ERR_DUPKEY);
  }
  *err = PS_OK;
  return ps;
}

void* ps_open(const char* path) {  // error code dropped
  return ps_open_checked(path, nullptr);
}

void ps_close(void* handle) {
  auto* ps = static_cast<PackStore*>(handle);
  if (!ps) return;
  if (ps->base) munmap(const_cast<uint8_t*>(ps->base), ps->size);
  if (ps->fd >= 0) ::close(ps->fd);
  delete ps;
}

// Returns n_clips, or -1 if the key is unknown. n_patch/d_model out-params.
int64_t ps_shape(void* handle, const char* key, int32_t* n_patch,
                 int32_t* d_model) {
  auto* ps = static_cast<PackStore*>(handle);
  auto it = ps->index.find(key);
  if (it == ps->index.end()) return -1;
  *n_patch = static_cast<int32_t>(it->second.n_patch);
  *d_model = static_cast<int32_t>(it->second.d_model);
  return static_cast<int64_t>(it->second.n_clips);
}

int ps_get(void* handle, const char* key, float* out) {
  auto* ps = static_cast<PackStore*>(handle);
  auto it = ps->index.find(key);
  if (it == ps->index.end()) return -1;
  const VideoEntry& e = it->second;
  size_t bytes = static_cast<size_t>(e.n_clips) * e.n_patch * e.d_model *
                 sizeof(float);
  // extents are proven at open; re-check before the copy anyway (a corrupt
  // entry must never become an out-of-bounds read): rc -5
  if (e.offset > ps->size || bytes > ps->size - e.offset) return -5;
  std::memcpy(out, ps->base + e.offset, bytes);
  return 0;
}

// Gather `n_idx` clips by index; slice to the first `n_patch_out` patches.
// out: [n_idx, n_patch_out, d_model] float32.
int ps_gather(void* handle, const char* key, const int64_t* indices,
              int32_t n_idx, int32_t n_patch_out, float* out) {
  auto* ps = static_cast<PackStore*>(handle);
  auto it = ps->index.find(key);
  if (it == ps->index.end()) return -1;
  const VideoEntry& e = it->second;
  if (n_patch_out > static_cast<int32_t>(e.n_patch) || n_patch_out < 0)
    return -2;
  const size_t whole = static_cast<size_t>(e.n_clips) * e.n_patch *
                       e.d_model * sizeof(float);
  if (e.offset > ps->size || whole > ps->size - e.offset) return -5;
  const size_t clip_stride = static_cast<size_t>(e.n_patch) * e.d_model;
  const size_t out_stride = static_cast<size_t>(n_patch_out) * e.d_model;
  const float* src =
      reinterpret_cast<const float*>(ps->base + e.offset);
  for (int32_t i = 0; i < n_idx; ++i) {
    int64_t c = indices[i];
    if (c < 0 || c >= static_cast<int64_t>(e.n_clips)) return -3;
    std::memcpy(out + i * out_stride, src + c * clip_stride,
                out_stride * sizeof(float));
  }
  return 0;
}

// Whole training batch in one call: `n_items` (key, index-window) pairs,
// each gathering `idx_per_item` clips into out[item].  `n_threads` <= 0
// picks the hardware concurrency.  Every video's d_model must equal the
// caller's `d_model` (output slots are sized by it) — mismatches return -4
// instead of overrunning the buffer.
int ps_gather_pair_batch(void* handle, const char** keys, int32_t n_items,
                         const int64_t* indices, int32_t idx_per_item,
                         int32_t n_patch_out, int32_t d_model, float* out,
                         int32_t n_threads) {
  auto* ps = static_cast<PackStore*>(handle);
  for (int32_t i = 0; i < n_items; ++i) {
    auto it = ps->index.find(keys[i]);
    if (it == ps->index.end()) return -1;
    if (static_cast<int32_t>(it->second.d_model) != d_model) return -4;
  }
  const size_t item_stride =
      static_cast<size_t>(idx_per_item) * n_patch_out * d_model;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  if (n_threads > n_items) n_threads = n_items;
  std::vector<int> rcs(static_cast<size_t>(n_items), 0);
  auto work = [&](int32_t t) {
    for (int32_t i = t; i < n_items; i += n_threads) {
      rcs[i] = ps_gather(handle, keys[i], indices + i * idx_per_item,
                         idx_per_item, n_patch_out, out + i * item_stride);
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (int rc : rcs) if (rc != 0) return rc;
  return 0;
}

}  // extern "C"
