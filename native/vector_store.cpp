// Native paged vector store: the host-DRAM/disk tier of larger-than-memory
// indexes.
//
// Role in the framework (SURVEY.md §5 "long-context" analog): DiskANN keeps
// PQ codes in fast memory and full-precision vectors on disk, paging rows on
// demand (reference claims README.md:30,36; its I/O rides Lucene IndexInput
// slices). Here device memory holds the graph + PQ codes while fp32
// rows live in an mmap'd file managed by this library; the rerank phase
// gathers only the candidate rows and uploads a [Q, R, d] block.
//
// Pure C ABI for ctypes binding (no pybind11 in the image).
//
// Build: make -C native   (produces libvector_store.so)

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

struct Store {
  int fd = -1;
  const char* base = nullptr;   // mmap base
  int64_t file_bytes = 0;
  int64_t row_bytes = 0;
  int64_t header_bytes = 0;
  int64_t num_rows = 0;
};

inline const char* row_ptr(const Store* s, int64_t id) {
  return s->base + s->header_bytes + id * s->row_bytes;
}

}  // namespace

extern "C" {

// Opens a row-major binary file. header_bytes are skipped; row_bytes is the
// stride. Returns nullptr on failure.
void* vs_open(const char* path, int64_t row_bytes, int64_t header_bytes) {
  if (row_bytes <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  // Rows are gathered randomly; tell the kernel not to read ahead wildly.
  ::madvise(base, st.st_size, MADV_RANDOM);
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const char*>(base);
  s->file_bytes = st.st_size;
  s->row_bytes = row_bytes;
  s->header_bytes = header_bytes;
  s->num_rows = (st.st_size - header_bytes) / row_bytes;
  return s;
}

int64_t vs_num_rows(void* h) {
  return h ? static_cast<Store*>(h)->num_rows : -1;
}

// Gathers n rows (by id) into out (n * row_bytes). Out-of-range ids are
// zero-filled. Parallel memcpy across `threads` workers — this is the
// bandwidth-bound hot path of the host tier. Returns 0 on success.
int vs_gather(void* h, const int64_t* ids, int64_t n, char* out,
              int threads) {
  if (!h || n < 0) return -1;
  const Store* s = static_cast<Store*>(h);
  if (threads < 1) threads = 1;
  if (threads > 64) threads = 64;
  if (n < 1024) threads = 1;  // spawn cost dominates small gathers

  auto work = [s, ids, n, out](int64_t lo, int64_t hi) {
    const int64_t rb = s->row_bytes;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t id = ids[i];
      if (id < 0 || id >= s->num_rows) {
        std::memset(out + i * rb, 0, rb);
      } else {
        std::memcpy(out + i * rb, row_ptr(s, id), rb);
      }
    }
  };
  if (threads == 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// Hints the kernel to page in the rows' pages (overlap IO with compute).
int vs_prefetch(void* h, const int64_t* ids, int64_t n) {
  if (!h) return -1;
  const Store* s = static_cast<Store*>(h);
  const int64_t page = 4096;
  for (int64_t i = 0; i < n; ++i) {
    int64_t id = ids[i];
    if (id < 0 || id >= s->num_rows) continue;
    const char* p = row_ptr(s, id);
    uintptr_t start = reinterpret_cast<uintptr_t>(p) & ~(page - 1);
    uintptr_t end = reinterpret_cast<uintptr_t>(p + s->row_bytes);
    ::madvise(reinterpret_cast<void*>(start), end - start, MADV_WILLNEED);
  }
  return 0;
}

void vs_close(void* h) {
  if (!h) return;
  Store* s = static_cast<Store*>(h);
  if (s->base) ::munmap(const_cast<char*>(s->base), s->file_bytes);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
