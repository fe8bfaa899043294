// Native host runtime for rootba_tpu_torch: fast dataset parsing (a
// copy of the JAX package's native/src/host_runtime.cpp).
//
// The reference parses BAL text files with fscanf per token
// (bal_problem.cpp:190-283); for the largest BAL problems (~29M
// observations, >120M numeric tokens) a Python-side tokenizer is far
// too slow, so this library provides an mmap-based parallel-friendly
// tokenizer exposed through a C ABI (loaded via ctypes, see
// rootba_tpu_torch/native/runtime.py).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = nullptr;
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      return false;
    }
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

inline bool is_space(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\f' ||
         c == '\v';
}

}  // namespace

extern "C" {

// Count whitespace-separated tokens in the file; -1 on IO error.
long long rootba_count_tokens(const char* path) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  long long count = 0;
  bool in_token = false;
  for (size_t i = 0; i < f.size; ++i) {
    const bool sp = is_space(f.data[i]);
    if (!sp && !in_token) {
      ++count;
      in_token = true;
    } else if (sp) {
      in_token = false;
    }
  }
  return count;
}

// Parse up to max_out whitespace-separated numeric tokens into out.
// Returns the number written, or -1 on error.
long long rootba_tokenize_file(const char* path, double* out,
                               long long max_out) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  long long n = 0;
  while (p < end && n < max_out) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;
    char* next = nullptr;
    // strtod needs NUL-terminated input in the worst case; the mmap'd
    // region is not NUL-terminated, but numeric tokens are always
    // followed by whitespace except possibly the very last token. Copy
    // the tail token into a small buffer to stay safe.
    if (end - p < 64) {
      char buf[80];
      size_t len = static_cast<size_t>(end - p);
      memcpy(buf, p, len);
      buf[len] = '\0';
      char* nb = nullptr;
      out[n] = strtod(buf, &nb);
      if (nb == buf) return -1;
      p += (nb - buf);
    } else {
      out[n] = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    ++n;
  }
  return n;
}

}  // extern "C"
