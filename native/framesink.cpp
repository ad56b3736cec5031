// Async frame sink: a native worker pool that encodes RGB8 frames to PNG
// and writes them to disk off the Python render loop.
//
// This is the rebuild of the reference's display/output tail
// (SURVEY.md §4.2: window.draw(sprite of shared texture) at the end of every
// frame — host-side presentation work overlapped with the next frame's GPU
// dispatch). A headless accelerator host has no window; the equivalent runtime
// component is frame ENCODE+IO, and doing it on Python's thread would
// serialize disk latency into the frame loop. Here: a bounded job queue +
// std::thread workers; submission copies the frame and returns immediately,
// flush() joins outstanding work (the vsync analog).
//
// Dependency-free PNG: stored-deflate zlib stream (RFC 1950/1951) + CRC32 —
// ~60 lines, deterministic, decodable by any PNG reader (PIL round-trip is
// asserted in tests/test_framesink.py). pybind11 is not in this image, so
// the ABI is plain extern "C" + ctypes (vxtpu/native/framesink.py).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
    crc_table[n] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* buf, size_t len, uint32_t crc = 0xFFFFFFFFu) {
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(uint8_t(x >> 24));
  v.push_back(uint8_t(x >> 16));
  v.push_back(uint8_t(x >> 8));
  v.push_back(uint8_t(x));
}

void chunk(std::vector<uint8_t>& out, const char type[4],
           const std::vector<uint8_t>& data) {
  put_be32(out, uint32_t(data.size()));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data.begin(), data.end());
  uint32_t c = crc32(out.data() + start, out.size() - start) ^ 0xFFFFFFFFu;
  put_be32(out, c);
}

// zlib stream with stored (uncompressed) deflate blocks + adler32.
std::vector<uint8_t> zlib_store(const std::vector<uint8_t>& raw) {
  std::vector<uint8_t> z;
  z.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
  z.push_back(0x78);  // CMF: deflate, 32K window
  z.push_back(0x01);  // FLG: check bits, no dict
  size_t pos = 0;
  while (pos < raw.size() || raw.empty()) {
    size_t n = raw.size() - pos;
    if (n > 65535) n = 65535;
    uint8_t final = (pos + n == raw.size()) ? 1 : 0;
    z.push_back(final);  // BFINAL + BTYPE=00 (stored)
    z.push_back(uint8_t(n & 0xFF));
    z.push_back(uint8_t(n >> 8));
    z.push_back(uint8_t(~n & 0xFF));
    z.push_back(uint8_t((~n >> 8) & 0xFF));
    z.insert(z.end(), raw.begin() + pos, raw.begin() + pos + n);
    pos += n;
    if (final) break;
  }
  uint32_t a = 1, b = 0;
  for (uint8_t byte : raw) {
    a = (a + byte) % 65521;
    b = (b + a) % 65521;
  }
  put_be32(z, (b << 16) | a);
  return z;
}

bool write_png(const std::string& path, int w, int h, const uint8_t* rgb) {
  crc_init();
  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);

  std::vector<uint8_t> ihdr;
  put_be32(ihdr, uint32_t(w));
  put_be32(ihdr, uint32_t(h));
  ihdr.push_back(8);   // bit depth
  ihdr.push_back(2);   // color type: truecolor RGB
  ihdr.push_back(0);   // compression
  ihdr.push_back(0);   // filter
  ihdr.push_back(0);   // interlace
  chunk(out, "IHDR", ihdr);

  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (1 + size_t(w) * 3));
  for (int y = 0; y < h; y++) {
    raw.push_back(0);  // filter: none
    raw.insert(raw.end(), rgb + size_t(y) * w * 3,
               rgb + (size_t(y) + 1) * w * 3);
  }
  chunk(out, "IDAT", zlib_store(raw));
  chunk(out, "IEND", {});

  FILE* f = std::fopen((path + ".tmp").c_str(), "wb");
  if (!f) return false;
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wrote != out.size()) return false;
  return std::rename((path + ".tmp").c_str(), path.c_str()) == 0;
}

struct Job {
  std::string path;
  int w, h;
  std::vector<uint8_t> rgb;
};

struct Sink {
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_done;
  std::vector<std::thread> workers;
  size_t max_queue;
  int in_flight = 0;
  long errors = 0;
  bool stopping = false;

  Sink(int n_workers, size_t max_q) : max_queue(max_q) {
    for (int i = 0; i < n_workers; i++)
      workers.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [this] { return stopping || !queue.empty(); });
        if (queue.empty()) return;  // stopping
        job = std::move(queue.front());
        queue.pop_front();
        in_flight++;
        cv_done.notify_all();  // queue shrank: unblock submitters
      }
      bool ok = write_png(job.path, job.w, job.h, job.rgb.data());
      {
        std::lock_guard<std::mutex> lk(mu);
        in_flight--;
        if (!ok) errors++;
        cv_done.notify_all();
      }
    }
  }

  void submit(const char* path, int w, int h, const uint8_t* rgb) {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return queue.size() < max_queue; });
    Job j;
    j.path = path;
    j.w = w;
    j.h = h;
    j.rgb.assign(rgb, rgb + size_t(w) * h * 3);
    queue.push_back(std::move(j));
    cv_push.notify_one();
  }

  long flush() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return queue.empty() && in_flight == 0; });
    return errors;
  }

  ~Sink() {
    flush();
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
      cv_push.notify_all();
    }
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* fs_create(int n_workers, int max_queue) {
  if (n_workers < 1) n_workers = 1;
  if (max_queue < 1) max_queue = 4;
  return new Sink(n_workers, size_t(max_queue));
}

void fs_submit(void* h, const char* path, int w, int hgt,
               const uint8_t* rgb) {
  static_cast<Sink*>(h)->submit(path, w, hgt, rgb);
}

// Blocks until all submitted frames are on disk; returns the number of
// frames that FAILED to write (0 = clean).
long fs_flush(void* h) { return static_cast<Sink*>(h)->flush(); }

void fs_destroy(void* h) { delete static_cast<Sink*>(h); }

// Synchronous single-frame write (no pool) — used by tests and as a simple
// fallback; returns 1 on success.
int fs_write_png(const char* path, int w, int h, const uint8_t* rgb) {
  crc_init();
  return write_png(path, w, h, rgb) ? 1 : 0;
}

}  // extern "C"
