// 2x FIR up- or down-sampling of an NHWC bfloat16 tensor for Hopper
// (sm_90a): row bands staged by TMA, the zero padding from the tensor map's
// out-of-bounds fill, separable f32 sums and 16-byte stores.
//
// Replaces, in bfloat16, the TPU kernel soft_truncation_tpu/ops/pallas/
// fir.py::_resample_pallas (:137), reached through fir_upsample2_pallas and
// fir_downsample2_pallas, and, launched in the other mode with the taps
// reversed, its custom VJP _fir2_bwd (:212): a bf16 model's resamples, their
// adjoints and their tangents. Per axis, with K the taps of ops/fir.py::
// fir2_taps (host float64, cast to f32) and the pads of _fir2_op:
//   up2:   out[2i+p] = sum_s coef[p][s] * x[i + lo + s]   (p = 0, 1)
//   down2: out[o]    = sum_t kf[t] * x[2*o + t - pad0]     (kf = K flipped)
// with the phase table coef of ops/fir.py::_up2_phase_table. Taps outside
// the image read zero. The sums run in f32 over the bf16 input, first along
// H, then along W, in the plain version's order of taps and with its
// rounding (each product rounded, then each sum; an FMA where the product is
// exact, see axpy): the f32 sums are the plain version's bit for bit, and
// so is the output, rounded to bf16 once at the store (to nearest even, as
// PyTorch rounds). The earlier form took an FMA a tap, which near zero can
// land many bf16 steps from the plain version. The TPU kernel computes in
// x.dtype and rounds after every product and sum (soft_truncation_tpu/ops/
// pallas/fir.py:123-126): the two differ by a few bf16 ulps. The f32 modes
// stay in fir2.cu.
//
// What bounds it on an H100: bytes. Per output element it does (T/2)^2 (up)
// or T^2 (down) multiply-adds against 2 bytes written and 0.5 or 8 bytes
// read, far below the FP32 pipe's rate per byte of HBM at 3.35 TB/s.
//
// What held back the earlier bf16 form (an entry of fir2.cu, 48-50 % of the
// bound at the training step's shapes; PERF.md), and what this one does:
//   1. each 4-channel vector was one 8-byte access, issued per tap with the
//      f32 path's instruction count for half the bytes: here a thread reads
//      and writes 16-byte vectors of 8 channels, and the input reaches shared
//      memory as whole bands by TMA, one instruction per band;
//   2. every tap carried its own bounds test: here the band's box starts at
//      the first input row and column it needs, negative ones included, and
//      may run past the image; TMA fills what lies outside with zeros
//      (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), which is the resample's zero
//      padding, so the sums read the box with no test;
//   3. down-mode read each input pixel four times through L1, 16 loads per
//      output: here each staged element comes from shared memory, and a
//      thread's two neighbouring outputs share their columns' H sums.
//
// Design (the TMA route, ops/fir.py::band_plan):
//   * a band: NB images x R unit rows x BW unit columns x 64 channels (one
//     128-byte pixel row), a unit being an output pixel (down) or a 2x2
//     output quad (up). Its box, one 4-D tensor load of the map over
//     [N, H, W, C]: NB x (2R + T - 2) x (2BW + T - 2) (down, from row 2*oy0
//     - pad0) or NB x (R + S - 1) x (BW + S - 1) (up, from row i0 + lo)
//     pixels of 64 channels, 128-byte swizzled (a pixel's 8 16-byte pieces
//     XORed with the pixel index, so 8 threads reading one piece of 8
//     pixels, or 8 pieces of one, hit 8 bank groups);
//   * 256 threads, a thread per (image, unit row, pair of unit columns,
//     8-channel piece) of the band: down sums each of its T + 2 input
//     columns over the T rows (H), then the columns into its 2 outputs (W);
//     up sums each of its S + 1 columns into both row phases, then the
//     columns into both column phases of its 2 quads, skipping the phase
//     table's structural zeros (known from T at compile time);
//   * a persistent grid of at most two blocks an SM; each block walks the
//     bands (image groups, row bands, column tiles, slabs: slabs fastest)
//     through a ring of 2-4 stages, one mbarrier each, so the next bands'
//     loads are in flight while this one is summed; thread 0 refills a
//     stage once every thread has read it;
//   * the outputs leave as 16-byte vectors of 8 channels, coalesced across
//     the slab, marked evict-first;
//   * rows wider than a box holds (256 elements a dimension) are cut into
//     column tiles, each with its own halo; C % 64 != 0 leaves the last
//     slab's channels past C filled with zeros and unstored.
// The direct route, for shapes where TMA buys nothing (a launch under
// ops/fir.py::TMA_MIN_BYTES) and for what TMA cannot take (C % 8 != 0, or x
// not 16-byte aligned): one thread per output pixel (down) or quad (up) and
// vector of 8, 4 or 1 channels, each tap read from global memory with its
// bounds test; the 4- and 1-wide forms are the earlier kernels with the
// rounding above.
// What holds it back now (PERF.md): a floor of ~4 us a launch at the small
// shapes, and at the largest the loads in flight (two stages of a 44 KB
// box for each of two blocks an SM, down-mode) beside ~130 instructions
// an output pixel.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxTaps = 8;
constexpr int kMaxSlots = 5;  // S of up2 at T = 8
constexpr int kThreads = 128;  // the direct route
constexpr int kBandThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kSlab = 64;       // channels per band: a 128-byte pixel row
constexpr int kPixelBytes = kSlab * 2;
constexpr int kAlign = 1024;    // the 128-byte swizzle's period
constexpr int kMaxBandSmem = 114688;  // two blocks an SM (ops/fir.py)
constexpr int kMaxBox = 256;    // TMA's limit per box dimension

struct Table {
  // up2: coef[p * S + s]; down2: kf[t] = K[T-1-t]
  float k[2 * kMaxSlots];
};

// The per-axis geometry of a T-tap resample, as ops/fir.py computes it:
// fir2_pads' leading pad, up2's first input offset lo and span S, and
// whether up2's phase p has a tap at offset lo + s.
__host__ __device__ constexpr int down_pad0(int T) { return (T - 1) / 2; }
__host__ __device__ constexpr int up_pad0(int T) { return (T - 1) / 2 + 1; }
__host__ __device__ constexpr int up_lo(int T) {
  int lo = 1 << 20;
  for (int p = 0; p < 2; ++p)
    for (int t = 0; t < T; ++t) {
      const int d = p + t - up_pad0(T);
      if (d % 2 == 0 && d / 2 < lo) lo = d / 2;
    }
  return lo;
}
__host__ __device__ constexpr int up_span(int T) {
  int hi = -(1 << 20);
  for (int p = 0; p < 2; ++p)
    for (int t = 0; t < T; ++t) {
      const int d = p + t - up_pad0(T);
      if (d % 2 == 0 && d / 2 > hi) hi = d / 2;
    }
  return hi - up_lo(T) + 1;
}
__host__ __device__ constexpr bool up_tap(int T, int p, int s) {
  const int t = 2 * (up_lo(T) + s) + up_pad0(T) - p;
  return t >= 0 && t < T;
}

// kVec consecutive bf16 channels to and from f32 registers: one 16-, 8- or
// 2-byte access
template <int kVec>
struct Io;

template <>
struct Io<8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Io<4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned int*>(&lo);
    q.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

template <>
struct Io<1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// acc += a * v as the plain version computes it: the product rounded, then
// the sum (never contracted). With kFma one FMA instead, which rounds the
// same wherever a * v is exact in f32: the H pass's products of bf16 inputs
// and taps of at most 16 significant bits (ops/fir.py::_exact_products),
// the [1, 3, 3, 1] of every config among them. The W pass multiplies f32
// sums, whose products are not exact, so it never takes kFma.
template <bool kFma, int kVec>
__device__ __forceinline__ void axpy(float a, const float (&v)[kVec],
                                     float (&acc)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    acc[i] = kFma ? fmaf(a, v[i], acc[i])
                  : __fadd_rn(acc[i], __fmul_rn(a, v[i]));
}

// ---------------------------------------------------------------- direct

template <int kS, int kVec, bool kFma>
__global__ void __launch_bounds__(kThreads)
fir2_up_kernel(const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ out, int H, int W, int C, int OH,
               int OW, int lo, Table tab) {
  const int cv = C / kVec;
  const int qw = (OW + 1) >> 1;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= qw * cv) return;
  const int j = idx / cv;
  const int c = (idx - j * cv) * kVec;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* xn = x + n * H * W * C + c;

  float acc[2][2][kVec];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[p][q][v] = 0.f;

#pragma unroll
  for (int sx = 0; sx < kS; ++sx) {
    const int ix = j + lo + sx;
    if (ix < 0 || ix >= W) continue;
    float col[2][kVec];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int v = 0; v < kVec; ++v) col[p][v] = 0.f;
#pragma unroll
    for (int sy = 0; sy < kS; ++sy) {
      const int iy = i + lo + sy;
      if (iy < 0 || iy >= H) continue;
      float val[kVec];
      Io<kVec>::load(xn + (iy * W + ix) * C, val);
      axpy<kFma>(tab.k[sy], val, col[0]);
      axpy<kFma>(tab.k[kS + sy], val, col[1]);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        axpy<false>(tab.k[q * kS + sx], col[p], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int oy = 2 * i + p;
    if (oy >= OH) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ox = 2 * j + q;
      if (ox < OW)
        Io<kVec>::store(out + ((n * OH + oy) * OW + ox) * C + c, acc[p][q]);
    }
  }
}

template <int kT, int kVec, bool kFma>
__global__ void __launch_bounds__(kThreads)
fir2_down_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out, int H, int W, int C, int OH,
                 int OW, int pad0, Table tab) {
  const int cv = C / kVec;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= OW * cv) return;
  const int ox = idx / cv;
  const int c = (idx - ox * cv) * kVec;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  const __nv_bfloat16* xn = x + n * H * W * C + c;

  float acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
#pragma unroll
  for (int tx = 0; tx < kT; ++tx) {
    const int ix = 2 * ox + tx - pad0;
    if (ix < 0 || ix >= W) continue;
    float col[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) col[v] = 0.f;
#pragma unroll
    for (int ty = 0; ty < kT; ++ty) {
      const int iy = 2 * oy + ty - pad0;
      if (iy < 0 || iy >= H) continue;
      float val[kVec];
      Io<kVec>::load(xn + (iy * W + ix) * C, val);
      axpy<kFma>(tab.k[ty], val, col);
    }
    axpy<false>(tab.k[tx], col, acc);
  }
  Io<kVec>::store(out + ((n * OH + oy) * OW + ox) * C + c, acc);
}

template <int kVec, bool kFma>
void launch_up(int S, dim3 grid, cudaStream_t s, const __nv_bfloat16* x,
               __nv_bfloat16* out, int H, int W, int C, int OH, int OW,
               int lo, const Table& t) {
  switch (S) {
#define FIR2_UP(S_)                                                      \
  case S_:                                                               \
    fir2_up_kernel<S_, kVec, kFma><<<grid, kThreads, 0, s>>>(            \
        x, out, H, W, C, OH, OW, lo, t);                                 \
    break;
    FIR2_UP(1) FIR2_UP(2) FIR2_UP(3) FIR2_UP(4) FIR2_UP(5)
#undef FIR2_UP
  }
}

template <int kVec, bool kFma>
void launch_down(int taps, dim3 grid, cudaStream_t s, const __nv_bfloat16* x,
                 __nv_bfloat16* out, int H, int W, int C, int OH, int OW,
                 int pad0, const Table& t) {
  switch (taps) {
#define FIR2_DOWN(T_)                                                       \
  case T_:                                                                  \
    fir2_down_kernel<T_, kVec, kFma><<<grid, kThreads, 0, s>>>(             \
        x, out, H, W, C, OH, OW, pad0, t);                                  \
    break;
    FIR2_DOWN(1) FIR2_DOWN(2) FIR2_DOWN(3) FIR2_DOWN(4) FIR2_DOWN(5)
    FIR2_DOWN(6) FIR2_DOWN(7) FIR2_DOWN(8)
#undef FIR2_DOWN
  }
}

}  // namespace

// One resample's launch arguments besides the pointers, the route and the
// stream: built once per (taps, gain, mode, shape, out_hw) by ops/fir.py
// (``_Bf16Args``), the band plan (ops/fir.py::band_plan) included.
struct Fir2Bf16Args {
  int N, H, W, C, OH, OW;
  int up;    // up2 (1) or down2 (0)
  int T;     // taps
  int len;   // the phase table's S (up2) or the tap count T (down2)
  int base;  // the first input offset lo (up2) or pad0 (down2)
  // the band plan, read on the TMA route only: units are output pixels
  // (down2) or 2x2 output quads (up2)
  int unit_rows, unit_cols;   // units of the output
  int images, rows, cols;     // a band's images, unit rows, unit columns
  int box_rows, box_cols;     // its box's input rows and columns
  int row0, col0;             // unit 0's first input row / column
  int tiles_n, tiles_r, tiles_c, slabs, tiles;  // bands per axis, in all
  int stages, stage_bytes, smem, grid;  // the ring, the block's bytes
  int fma_h;    // the H pass by FMA: its products are exact (axpy)
  Table table;  // 2*S (up2) or T (down2) f32 values
};

namespace {

// The 8 channels of piece g of staged pixel ``pix`` (128-byte swizzle: the
// piece's 16 bytes sit at piece g ^ (pix % 8) of the pixel's row)
__device__ __forceinline__ void load_piece(const unsigned char* stage,
                                           int pix, int g, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(
      stage + pix * kPixelBytes + ((g ^ (pix & 7)) << 4));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 channels' f32 sums rounded to bf16, stored as one 16-byte vector marked
// evict-first: the band's output is read by another kernel later, and the
// bands still to come read their inputs (and neighbours' halos) through L2
__device__ __forceinline__ void store_piece(__nv_bfloat16* p,
                                            const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

struct Band {
  int n0, u0, v0, c0;  // first image, unit row, unit column, channel
};

__device__ __forceinline__ Band band_of(const Fir2Bf16Args& a, int tile) {
  Band b;
  const int slab = tile % a.slabs;
  tile /= a.slabs;
  const int cb = tile % a.tiles_c;
  tile /= a.tiles_c;
  const int rb = tile % a.tiles_r;
  b.n0 = (tile / a.tiles_r) * a.images;
  b.u0 = rb * a.rows;
  b.v0 = cb * a.cols;
  b.c0 = slab * kSlab;
  return b;
}

template <bool kUp>
__device__ __forceinline__ void issue(const CUtensorMap* map,
                                      const Fir2Bf16Args& a, uint32_t dst,
                                      uint32_t bar, int tile) {
  constexpr int kScale = kUp ? 1 : 2;
  const Band b = band_of(a, tile);
  mbar_expect_tx(bar, a.images * a.box_rows * a.box_cols * kPixelBytes);
  tma_load_4d(dst, map, bar, b.c0, b.v0 * kScale + a.col0,
              b.u0 * kScale + a.row0, b.n0);
}

// One band from its staged box: a thread per (image, unit row, pair of unit
// columns, 8-channel piece)
template <bool kUp, int kT, bool kFma>
__device__ __forceinline__ void sum_band(const Fir2Bf16Args& a,
                                         const unsigned char* stage,
                                         __nv_bfloat16* __restrict__ out,
                                         int tile) {
  constexpr int kS = kUp ? up_span(kT) : kT;
  const Band b = band_of(a, tile);
  const int runs = a.cols >> 1;
  const int items = a.images * a.rows * runs * 8;
  for (int item = threadIdx.x; item < items; item += kBandThreads) {
    const int g = item & 7;
    int rest = item >> 3;
    const int run = rest % runs;
    rest /= runs;
    const int r = rest % a.rows;
    const int img = rest / a.rows;
    const int c = b.c0 + g * 8;
    const int n = b.n0 + img;
    const int u = b.u0 + r;
    const int v = b.v0 + 2 * run;
    if (c >= a.C || n >= a.N || u >= a.unit_rows || v >= a.unit_cols)
      continue;
    if constexpr (!kUp) {
      // input rows 2r .. 2r + T - 1, columns 4 run .. 4 run + T + 1
      const int pix0 = (img * a.box_rows + 2 * r) * a.box_cols + 4 * run;
      float acc[2][8];
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[o][e] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kT + 2; ++cc) {
        float h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = 0.f;
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          float val[8];
          load_piece(stage, pix0 + t * a.box_cols + cc, g, val);
          axpy<kFma>(a.table.k[t], val, h);
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int tx = cc - 2 * o;
          if (tx >= 0 && tx < kT) axpy<false>(a.table.k[tx], h, acc[o]);
        }
      }
#pragma unroll
      for (int o = 0; o < 2; ++o)
        if (v + o < a.OW)
          store_piece(out + ((n * a.OH + u) * a.OW + v + o) * a.C + c,
                      acc[o]);
    } else {
      // input rows r .. r + S - 1, columns 2 run .. 2 run + S
      const int pix0 = (img * a.box_rows + r) * a.box_cols + 2 * run;
      float acc[2][2][2][8];  // [row phase][column phase][quad][channel]
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int o = 0; o < 2; ++o)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[p][q][o][e] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kS + 1; ++cc) {
        float col[2][8];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 8; ++e) col[p][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          if (!up_tap(kT, 0, s) && !up_tap(kT, 1, s)) continue;
          float val[8];
          load_piece(stage, pix0 + s * a.box_cols + cc, g, val);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (up_tap(kT, p, s))
              axpy<kFma>(a.table.k[p * kS + s], val, col[p]);
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int sx = cc - o;
          if (sx < 0 || sx >= kS) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (!up_tap(kT, q, sx)) continue;
#pragma unroll
            for (int p = 0; p < 2; ++p)
              axpy<false>(a.table.k[q * kS + sx], col[p], acc[p][q][o]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int oy = 2 * u + p;
        if (oy >= a.OH) continue;
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ox = 2 * (v + o) + q;
            if (ox < a.OW)
              store_piece(out + ((n * a.OH + oy) * a.OW + ox) * a.C + c,
                          acc[p][q][o]);
          }
      }
    }
  }
}

template <bool kUp, int kT, bool kFma>
__global__ void __launch_bounds__(kBandThreads, 2)
fir2_band_kernel(const __grid_constant__ CUtensorMap map,
                 __nv_bfloat16* __restrict__ out, const Fir2Bf16Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const unsigned char* ring = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < a.stages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < a.tiles)
        issue<kUp>(&map, a, base + s * a.stage_bytes, smem_u32(&full[s]),
                   tile);
    }
  int k = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++k) {
    const int s = k % a.stages;
    mbar_wait(smem_u32(&full[s]), (k / a.stages) & 1);
    sum_band<kUp, kT, kFma>(a, ring + s * a.stage_bytes, out, tile);
    __syncthreads();  // every thread has read stage s: refill it
    const int next = tile + a.stages * gridDim.x;
    if (tid == 0 && next < a.tiles)
      issue<kUp>(&map, a, base + s * a.stage_bytes, smem_u32(&full[s]), next);
  }
}

template <bool kUp, int kT, bool kFma>
int launch_band(const CUtensorMap& map, __nv_bfloat16* out,
                const Fir2Bf16Args& a, cudaStream_t stream) {
  auto kernel = fir2_band_kernel<kUp, kT, kFma>;
  static bool configured[kMaxDevices] = {};  // per instantiation
  const cudaError_t err = allow_smem(kernel, kMaxBandSmem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.grid, kBandThreads, a.smem, stream>>>(map, out, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kUp, bool kFma>
int launch_band_taps(const CUtensorMap& map, __nv_bfloat16* out,
                     const Fir2Bf16Args& a, cudaStream_t s) {
  switch (a.T) {
#define FIR2_BAND(T_) \
  case T_:            \
    return launch_band<kUp, T_, kFma>(map, out, a, s);
    FIR2_BAND(1) FIR2_BAND(2) FIR2_BAND(3) FIR2_BAND(4) FIR2_BAND(5)
    FIR2_BAND(6) FIR2_BAND(7) FIR2_BAND(8)
#undef FIR2_BAND
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Whether the band plan is one the kernel takes: the geometry ops/fir.py::
// band_plan computes, within TMA's and shared memory's limits
bool plan_ok(const Fir2Bf16Args& a) {
  const int T = a.T;
  if (T < 1 || T > kMaxTaps) return false;
  const int S = a.up ? up_span(T) : T;
  const int lo_or_pad = a.up ? up_lo(T) : -down_pad0(T);
  const int scale = a.up ? 1 : 2;
  const int halo = a.up ? S - 1 : T - 2;
  const int ur = a.up ? (a.OH + 1) / 2 : a.OH;
  const int uc = a.up ? (a.OW + 1) / 2 : a.OW;
  const long long box = 1LL * a.images * a.box_rows * a.box_cols * kPixelBytes;
  const long long tiles = 1LL * a.tiles_n * a.tiles_r * a.tiles_c * a.slabs;
  return a.len == S && a.base == (a.up ? lo_or_pad : -lo_or_pad) &&
         a.C % 8 == 0 && a.unit_rows == ur && a.unit_cols == uc &&
         a.rows >= 1 && a.cols >= 2 && a.cols % 2 == 0 && a.images >= 1 &&
         a.box_rows == scale * a.rows + halo &&
         a.box_cols == scale * a.cols + halo && a.box_rows <= kMaxBox &&
         a.box_cols <= kMaxBox && a.images <= kMaxBox &&
         a.row0 == lo_or_pad && a.col0 == lo_or_pad &&
         a.tiles_n == ceil_div(a.N, a.images) &&
         a.tiles_r == ceil_div(ur, a.rows) &&
         a.tiles_c == ceil_div(uc, a.cols) &&
         a.slabs == ceil_div(a.C, kSlab) && tiles == a.tiles &&
         a.stages >= 2 && a.stages <= kMaxStages &&
         a.stage_bytes % kAlign == 0 && a.stage_bytes >= box &&
         a.smem >= kAlign + a.stages * a.stage_bytes &&
         a.smem <= kMaxBandSmem && a.grid >= 1 && a.grid <= a.tiles;
}

int fir2_band(const __nv_bfloat16* x, __nv_bfloat16* out,
              const Fir2Bf16Args& a, cudaStream_t stream) {
  if (!plan_ok(a) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W,
                              (cuuint64_t)a.H, (cuuint64_t)a.N};
  const cuuint64_t strides[3] = {(cuuint64_t)a.C * 2,
                                 (cuuint64_t)a.W * a.C * 2,
                                 (cuuint64_t)a.H * a.W * a.C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, (cuuint32_t)a.box_cols,
                             (cuuint32_t)a.box_rows, (cuuint32_t)a.images};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  // hopper.cuh binds the device's primary context where this thread has
  // none (a server's handler thread)
  const int r = encode_in_context([&](EncodeTiled encode) {
    return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<__nv_bfloat16*>(x), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
  if (r != 0) return r;
  if (a.fma_h)
    return a.up ? launch_band_taps<true, true>(map, out, a, stream)
                : launch_band_taps<false, true>(map, out, a, stream);
  return a.up ? launch_band_taps<true, false>(map, out, a, stream)
              : launch_band_taps<false, false>(map, out, a, stream);
}

template <bool kFma>
void direct(int up, int vec, int len, dim3 grid, cudaStream_t s,
            const __nv_bfloat16* x, __nv_bfloat16* out, int H, int W, int C,
            int OH, int OW, int base, const Table& t) {
  if (up) {
    if (vec == 8)
      launch_up<8, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else if (vec == 4)
      launch_up<4, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else
      launch_up<1, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
  } else {
    if (vec == 8)
      launch_down<8, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else if (vec == 4)
      launch_down<4, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else
      launch_down<1, kFma>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
  }
}

int fir2_direct(const __nv_bfloat16* x, __nv_bfloat16* out,
                const Fir2Bf16Args& a, int vec, cudaStream_t s) {
  const int N = a.N, H = a.H, W = a.W, C = a.C, OH = a.OH, OW = a.OW;
  const int up = a.up, len = a.len, base = a.base;
  const int max_len = up ? kMaxSlots : kMaxTaps;
  if (len < 1 || len > max_len || (vec != 1 && vec != 4 && vec != 8) ||
      C % vec != 0 || reinterpret_cast<uintptr_t>(x) % (2 * vec) != 0 ||
      N < 1 || N > 65535 || (up ? (OH + 1) / 2 : OH) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Table& t = a.table;
  const int cols = up ? (OW + 1) / 2 : OW;
  const dim3 grid((cols * (C / vec) + kThreads - 1) / kThreads,
                  up ? (OH + 1) / 2 : OH, N);
  if (a.fma_h) {
    direct<true>(up, vec, len, grid, s, x, out, H, W, C, OH, OW, base, t);
  } else {
    direct<false>(up, vec, len, grid, s, x, out, H, W, C, OH, OW, base, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). x [N,H,W,C] and out [N,OH,OW,C]
// are contiguous bf16 on the current device, both under 2^31 elements;
// ``a`` is a host Fir2Bf16Args, copied into the launch's parameters (and
// its tensor map encoded here, every call: it holds x's address).
// ``route`` 0 takes the TMA route (C % 8 == 0, x 16-byte aligned, the band
// plan of ``a``); 8, 4 or 1 the direct route with vectors of that many
// channels (C a multiple, x aligned to them). Returns cudaGetLastError()
// after the launch, a CUresult of the map's encoding, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int fir2_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                         const Fir2Bf16Args* a, int route, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (a->N < 1 || a->C < 1 || a->OH < 1 || a->OW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) return fir2_band(x, out, *a, s);
  return fir2_direct(x, out, *a, route, s);
}
