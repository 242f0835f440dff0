// Batch assembler of the native input pipeline, on the card's host: an
// epoch permutation (Fisher-Yates) and, per batch, a gather from a resident
// uint8 [n, h, w, c] array with a random left-right flip and, into float32,
// the uniform dequantization and the [0, 1] -> [-1, 1] scaling, threaded
// over the batch's items.
//
// The port's own copy of soft_truncation_tpu/data/native/batcher.cpp, with
// its C ABI (st_assemble_batch, st_shuffle_indices) and its numbers to the
// bit: xorshift128+ seeded by splitmix64, one generator per item seeded
// `seed ^ (0xD1B54A32D192ED03 * (index + 1))`, the flip its first draw's
// low bit. st_gather_batch_u8 is the same gather and flip into uint8 (the
// trainer's transport), so a batch is written straight into a pinned
// buffer; its bytes are those of st_assemble_batch's float32 batch
// quantized back, round(x * 255).
//
// Host code with a C interface for ctypes; data/native.py builds it with
// g++ at first use. Threads: std::thread, joined before each call returns.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xorshift128+: deterministic, seeded per item
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    uint64_t z = (seed + 0x9E3779B97F4A7C15ULL);
    auto mix = [](uint64_t z) {
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    s0 = mix(z);
    s1 = mix(z + 0x9E3779B97F4A7C15ULL);
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  inline float uniform() {  // [0, 1)
    return (next() >> 40) * (1.0f / 16777216.0f);
  }
};

constexpr int kFlagRandomFlip = 1;
constexpr int kFlagUniformDequant = 2;
constexpr int kFlagCentered = 4;

inline Rng item_rng(int64_t src_idx, uint64_t seed) {
  return Rng(seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(src_idx + 1)));
}

void assemble_item(const uint8_t* data, int64_t h, int64_t w, int64_t c,
                   int64_t src_idx, int flags, uint64_t seed, float* out) {
  const uint8_t* src = data + src_idx * h * w * c;
  Rng rng = item_rng(src_idx, seed);
  const bool flip = (flags & kFlagRandomFlip) && (rng.next() & 1);
  const bool dequant = flags & kFlagUniformDequant;
  const bool centered = flags & kFlagCentered;

  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int64_t sx = flip ? (w - 1 - x) : x;
      const uint8_t* px = src + (y * w + sx) * c;
      float* dst = out + (y * w + x) * c;
      for (int64_t k = 0; k < c; ++k) {
        float v = (float)px[k] / 255.0f;  // convert_image_dtype semantics
        if (dequant) v = (255.0f * v + rng.uniform()) / 256.0f;
        if (centered) v = v * 2.0f - 1.0f;
        dst[k] = v;
      }
    }
  }
}

void gather_item(const uint8_t* data, int64_t h, int64_t w, int64_t c,
                 int64_t src_idx, int flags, uint64_t seed, uint8_t* out) {
  const uint8_t* src = data + src_idx * h * w * c;
  Rng rng = item_rng(src_idx, seed);
  const bool flip = (flags & kFlagRandomFlip) && (rng.next() & 1);
  if (!flip) {
    std::memcpy(out, src, (size_t)(h * w * c));
    return;
  }
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      std::memcpy(out + (y * w + x) * c, src + (y * w + (w - 1 - x)) * c,
                  (size_t)c);
}

// item(i) for i in [0, batch), over at most num_threads threads
template <typename Item>
void over_items(int64_t batch, int num_threads, Item item) {
  if (num_threads <= 1 || batch == 1) {
    for (int64_t i = 0; i < batch; ++i) item(i);
    return;
  }
  std::atomic<int64_t> counter{0};
  auto worker = [&]() {
    while (true) {
      int64_t i = counter.fetch_add(1);
      if (i >= batch) return;
      item(i);
    }
  };
  std::vector<std::thread> threads;
  int nt = num_threads < (int)batch ? num_threads : (int)batch;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Gather `batch` items by `indices` from a [n, h, w, c] uint8 array into a
// float32 [batch, h, w, c] buffer with the flip, dequantization and
// scaling that `flags` ask for; item i is seeded from `seed + i`.
void st_assemble_batch(const uint8_t* data, int64_t n, int64_t h, int64_t w,
                       int64_t c, const int64_t* indices, int64_t batch,
                       int flags, uint64_t seed, float* out,
                       int num_threads) {
  (void)n;
  over_items(batch, num_threads, [&](int64_t i) {
    assemble_item(data, h, w, c, indices[i], flags, seed + i,
                  out + i * h * w * c);
  });
}

// The same gather and flip into a uint8 [batch, h, w, c] buffer (`flags`
// may hold only the flip).
void st_gather_batch_u8(const uint8_t* data, int64_t n, int64_t h, int64_t w,
                        int64_t c, const int64_t* indices, int64_t batch,
                        int flags, uint64_t seed, uint8_t* out,
                        int num_threads) {
  (void)n;
  over_items(batch, num_threads, [&](int64_t i) {
    gather_item(data, h, w, c, indices[i], flags, seed + i,
                out + i * h * w * c);
  });
}

// Fisher-Yates shuffle of an index buffer (epoch permutation).
void st_shuffle_indices(int64_t* indices, int64_t n, uint64_t seed) {
  Rng rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(rng.next() % (uint64_t)(i + 1));
    int64_t tmp = indices[i];
    indices[i] = indices[j];
    indices[j] = tmp;
  }
}

}  // extern "C"
