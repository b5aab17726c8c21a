// Native host runtime of perception_tpu_torch: PCD parsing, threaded
// frame read-ahead and the PNG row unfilter.
//
// A copy of perception_tpu/runtime/fastio.cpp (the JAX package's host
// runtime) with one addition. The device keeps the compute; this library
// owns what stays on the host: file decode and read-ahead staging, so
// the card never waits on Python-speed parsing.
//
//   * pcd_read_xyz: v0.7 ascii/binary PCD -> packed float32 xyz.
//   * prefetcher: N worker threads + bounded ring of file buffers,
//     delivering files in submission order while the consumer computes.
//   * png_unfilter: reverses the five PNG row filters (None, Sub, Up,
//     Average, Paeth). Average and Paeth are sequential along a row,
//     which numpy cannot vectorise within a row.
//
// Exposed as a plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PcdHeader {
  std::vector<std::string> fields;
  std::vector<int> sizes;
  std::vector<char> types;
  std::vector<int> counts;
  long points = -1;
  bool binary = false;
  size_t data_offset = 0;
};

bool parse_header(const std::string& buf, PcdHeader* h) {
  size_t pos = 0;
  while (pos < buf.size()) {
    size_t eol = buf.find('\n', pos);
    if (eol == std::string::npos) return false;
    std::string line = buf.substr(pos, eol - pos);
    pos = eol + 1;
    if (line.empty() || line[0] == '#') continue;
    size_t sp = line.find(' ');
    std::string key = line.substr(0, sp);
    std::string val = sp == std::string::npos ? "" : line.substr(sp + 1);
    if (key == "FIELDS") {
      size_t p = 0;
      while (p < val.size()) {
        size_t q = val.find(' ', p);
        h->fields.push_back(val.substr(p, q - p));
        if (q == std::string::npos) break;
        p = q + 1;
      }
    } else if (key == "SIZE" || key == "COUNT") {
      std::vector<int>* dst = key == "SIZE" ? &h->sizes : &h->counts;
      const char* c = val.c_str();
      char* end;
      while (*c) {
        long v = strtol(c, &end, 10);
        if (end == c) break;
        dst->push_back((int)v);
        c = end;
      }
    } else if (key == "TYPE") {
      for (char ch : val)
        if (ch != ' ') h->types.push_back(ch);
    } else if (key == "POINTS") {
      h->points = strtol(val.c_str(), nullptr, 10);
    } else if (key == "DATA") {
      h->binary = val.rfind("binary", 0) == 0;
      h->data_offset = pos;
      if (h->counts.empty()) h->counts.assign(h->fields.size(), 1);
      return true;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Returns the number of points, or -1 on error. If out != null, writes
// up to capacity xyz triples (float32) and returns the number written.
long pcd_read_xyz(const char* path, float* out, long capacity) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  std::string buf((std::istreambuf_iterator<char>(f)),
                  std::istreambuf_iterator<char>());
  PcdHeader h;
  if (!parse_header(buf, &h)) return -1;

  int xi = -1, yi = -1, zi = -1;
  int ncols = 0;
  std::vector<int> col_of(h.fields.size());
  for (size_t i = 0; i < h.fields.size(); i++) {
    col_of[i] = ncols;
    if (h.fields[i] == "x") xi = ncols;
    if (h.fields[i] == "y") yi = ncols;
    if (h.fields[i] == "z") zi = ncols;
    ncols += h.counts[i];
  }
  if (xi < 0 || yi < 0 || zi < 0) return -1;

  long n = 0;
  if (!h.binary) {
    const char* c = buf.c_str() + h.data_offset;
    const char* end_all = buf.c_str() + buf.size();
    std::vector<float> row(ncols);
    while (c < end_all) {
      int col = 0;
      char* e;
      while (col < ncols && c < end_all) {
        float v = strtof(c, &e);
        if (e == c) {  // skip junk/whitespace
          if (*c == '\0') break;
          ++c;
          continue;
        }
        row[col++] = v;
        c = e;
      }
      if (col < ncols) break;
      float x = row[xi], y = row[yi], z = row[zi];
      if (x == x && y == y && z == z) {  // NaN-row drop (PCL padding)
        if (out) {
          if (n >= capacity) break;
          out[3 * n] = x;
          out[3 * n + 1] = y;
          out[3 * n + 2] = z;
        }
        n++;
      }
    }
  } else {
    // Binary: compute the row stride and per-field offsets.
    int stride = 0;
    std::vector<int> offs(h.fields.size());
    for (size_t i = 0; i < h.fields.size(); i++) {
      offs[i] = stride;
      stride += h.sizes[i] * h.counts[i];
    }
    int ox = -1, oy = -1, oz = -1;
    for (size_t i = 0; i < h.fields.size(); i++) {
      if (h.fields[i] == "x") ox = offs[i];
      if (h.fields[i] == "y") oy = offs[i];
      if (h.fields[i] == "z") oz = offs[i];
    }
    const char* base = buf.c_str() + h.data_offset;
    long avail = (long)((buf.size() - h.data_offset) / stride);
    long total = h.points >= 0 && h.points < avail ? h.points : avail;
    for (long i = 0; i < total; i++) {
      float x, y, z;
      memcpy(&x, base + i * stride + ox, 4);
      memcpy(&y, base + i * stride + oy, 4);
      memcpy(&z, base + i * stride + oz, 4);
      if (x == x && y == y && z == z) {
        if (out) {
          if (n >= capacity) break;
          out[3 * n] = x;
          out[3 * n + 1] = y;
          out[3 * n + 2] = z;
        }
        n++;
      }
    }
  }
  return n;
}

// ---------------- threaded prefetcher ------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  size_t ring = 4;
  std::map<long, std::vector<char>> ready;  // ordered by index
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<long> next_submit{0};
  long next_consume = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      long idx = next_submit.fetch_add(1);
      if (idx >= (long)paths.size()) return;
      std::ifstream f(paths[idx], std::ios::binary);
      std::vector<char> data;
      if (f) {
        data.assign(std::istreambuf_iterator<char>(f),
                    std::istreambuf_iterator<char>());
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || ready.size() < ring ||
               idx < next_consume + (long)ring;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(data));
      cv_ready.notify_all();
    }
  }
};

void* prefetcher_create(const char** paths, long n_paths, int n_threads,
                        int ring) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->ring = ring > 0 ? ring : 4;
  for (int i = 0; i < (n_threads > 0 ? n_threads : 2); i++)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until frame `index` (in submission order) is ready; returns its
// size and copies up to capacity bytes into out. Returns -1 past the end.
long prefetcher_next(void* handle, char* out, long capacity) {
  auto* p = (Prefetcher*)handle;
  long idx = p->next_consume;
  if (idx >= (long)p->paths.size()) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return p->ready.count(idx) > 0; });
  auto& data = p->ready[idx];
  long n = (long)data.size();
  if (out && capacity >= n) memcpy(out, data.data(), n);
  p->ready.erase(idx);
  p->next_consume = idx + 1;
  p->cv_space.notify_all();
  return n;
}

// Peek the size of the next ready frame without consuming (for buffer
// allocation). Blocks until ready.
long prefetcher_peek_size(void* handle) {
  auto* p = (Prefetcher*)handle;
  long idx = p->next_consume;
  if (idx >= (long)p->paths.size()) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return p->ready.count(idx) > 0; });
  return (long)p->ready[idx].size();
}

void prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------- PNG row unfilter ---------------------------------------

// raw holds `height` rows of 1 + stride bytes: the row's filter type, then
// its filtered bytes; out receives the height * stride unfiltered bytes.
// bpp is the bytes per complete pixel (at least 1). Returns 0, or -1 when
// a row names a filter type other than 0-4.
int png_unfilter(const uint8_t* raw, uint8_t* out, long height, long stride,
                 int bpp) {
  std::vector<uint8_t> zeros(stride, 0);  // the row above the first
  const uint8_t* prior = zeros.data();
  for (long r = 0; r < height; r++) {
    const uint8_t* src = raw + r * (stride + 1) + 1;
    uint8_t* row = out + r * stride;
    const long head = bpp < stride ? bpp : stride;  // bytes with no left pixel
    switch (raw[r * (stride + 1)]) {
      case 0:
        memcpy(row, src, stride);
        break;
      case 1:
        memcpy(row, src, head);
        for (long i = head; i < stride; i++) row[i] = (uint8_t)(src[i] + row[i - bpp]);
        break;
      case 2:
        for (long i = 0; i < stride; i++) row[i] = (uint8_t)(src[i] + prior[i]);
        break;
      case 3:
        for (long i = 0; i < head; i++) row[i] = (uint8_t)(src[i] + (prior[i] >> 1));
        for (long i = head; i < stride; i++)
          row[i] = (uint8_t)(src[i] + ((row[i - bpp] + prior[i]) >> 1));
        break;
      case 4:
        // Left and upper-left are 0 on the first pixel: Paeth picks b.
        for (long i = 0; i < head; i++) row[i] = (uint8_t)(src[i] + prior[i]);
        for (long i = head; i < stride; i++) {
          const int a = row[i - bpp], b = prior[i], c = prior[i - bpp];
          const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          // Branch-free selects: on noisy rows the branches mispredict.
          const int bc = pb <= pc ? b : c;
          const int pred = ((pa <= pb) & (pa <= pc)) ? a : bc;
          row[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -1;
    }
    prior = row;
  }
  return 0;
}

}  // extern "C"
