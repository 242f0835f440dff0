// 2x FIR up- or down-sampling of an NHWC float32 tensor, forward, in one
// pass over both spatial axes.
//
// Replaces the TPU kernel soft_truncation_tpu/ops/pallas/fir.py::
// _resample_pallas (:137), reached through fir_upsample2_pallas and
// fir_downsample2_pallas, and, launched in the other mode with the taps
// reversed, its custom VJP _fir2_bwd (:212). Per axis, with K the taps of
// ops/fir.py::fir2_taps (host float64, cast to f32) and the pads of _fir2_op:
//   up2:   out[2i+p] = sum_s coef[p][s] * x[i + lo + s]   (p = 0, 1)
//   down2: out[o]    = sum_t kf[t] * x[2*o + t - pad0]     (kf = K flipped)
// where the phase table coef[p][s] (ops/fir.py::_up2_phase_table, from
// _phase_taps_up2) holds the taps of phase p at input offset lo + s and 0
// elsewhere. Taps outside the image read zero (the reference's padding); the
// 2-D sum is taken in registers over both axes at once.
//
// What bounds it on an H100: bytes. Per output it does (T/2)^2 (up) or T^2
// (down) multiply-adds, 4 or 16 at T = 4, against 4 bytes written and 1 or
// 16 bytes read: far below the ~20 FLOP per byte where the FP32 pipe, not
// HBM at 3.35 TB/s, would be the limit.
//
// Design:
//   * up-mode: one thread per 2x2 output quad (2i+p, 2j+q) and 4-channel
//     vector. It reads the S x S input pixels the four phases share once (S =
//     T/2 + 1: 9 float4 at T = 4), sums each column for both row phases,
//     then each column into both column phases, and writes 4 float4. The
//     phase table is a launch parameter (constant space), S a template
//     argument, so there is no per-tap parity test and no inserted zero is
//     read;
//   * down-mode keeps one thread per output pixel and vector: its 16 taps at
//     T = 4 are distinct input pixels that neighbouring outputs share through
//     L1, and it already ran at 54-62 % of its bound (an H100 80GB HBM3 at
//     700 W, batch 128; PERF.md), so a shared-memory stage would add
//     a barrier for little;
//   * both: 32-bit indices; blockIdx.z = image, blockIdx.y = output row (or
//     quad row), x over (column, channel vector), so the only division left
//     is one 32-bit split of x into column and vector;
//   * a scalar path (vec = 1) when C % 4 != 0 (the C = 3 pyramid inputs) or
//     x is not aligned to 4 elements; OH and OW are the caller's (2H + 1
//     where up2 is the adjoint of a down2 of an odd size);
//   * bfloat16 has a source of its own, fir2_bf16.cu (TMA-staged bands).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kMaxSlots = 5;  // S of up2 at T = 8
constexpr int kThreads = 128;

struct Table {
  // up2: coef[p * S + s]; down2: kf[t] = K[T-1-t]
  float k[2 * kMaxSlots];
};

// kVec consecutive float channels to and from registers: one 16-byte
// access for kVec = 4
template <typename T, int kVec>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

template <int kVec>
__device__ __forceinline__ void axpy(float a, const float (&v)[kVec],
                                     float (&acc)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = fmaf(a, v[i], acc[i]);
}

template <int kS, int kVec, typename T>
__global__ void __launch_bounds__(kThreads)
fir2_up_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W,
               int C, int OH, int OW, int lo, Table tab) {
  const int cv = C / kVec;
  const int qw = (OW + 1) >> 1;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= qw * cv) return;
  const int j = idx / cv;
  const int c = (idx - j * cv) * kVec;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  const T* xn = x + n * H * W * C + c;

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
      Io<T, kVec>::load(xn + (iy * W + ix) * C, val);
      axpy(tab.k[sy], val, col[0]);
      axpy(tab.k[kS + sy], val, col[1]);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          acc[p][q][v] = fmaf(tab.k[q * kS + sx], col[p][v], acc[p][q][v]);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int oy = 2 * i + p;
    if (oy >= OH) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ox = 2 * j + q;
      if (ox < OW)
        Io<T, kVec>::store(out + ((n * OH + oy) * OW + ox) * C + c,
                           acc[p][q]);
    }
  }
}

template <int kT, int kVec, typename T>
__global__ void __launch_bounds__(kThreads)
fir2_down_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W,
                 int C, int OH, int OW, int pad0, Table tab) {
  const int cv = C / kVec;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= OW * cv) return;
  const int ox = idx / cv;
  const int c = (idx - ox * cv) * kVec;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  const T* xn = x + n * H * W * C + c;

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
      Io<T, kVec>::load(xn + (iy * W + ix) * C, val);
      axpy(tab.k[ty], val, col);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = fmaf(tab.k[tx], col[v], acc[v]);
  }
  Io<T, kVec>::store(out + ((n * OH + oy) * OW + ox) * C + c, acc);
}

template <int kVec, typename T>
void launch_up(int S, dim3 grid, cudaStream_t s, const T* x, T* out, int H,
               int W, int C, int OH, int OW, int lo, const Table& t) {
  switch (S) {
#define FIR2_UP(S_)                                                      \
  case S_:                                                               \
    fir2_up_kernel<S_, kVec, T><<<grid, kThreads, 0, s>>>(x, out, H, W, C, \
                                                          OH, OW, lo, t); \
    break;
    FIR2_UP(1) FIR2_UP(2) FIR2_UP(3) FIR2_UP(4) FIR2_UP(5)
#undef FIR2_UP
  }
}

template <int kVec, typename T>
void launch_down(int taps, dim3 grid, cudaStream_t s, const T* x, T* out,
                 int H, int W, int C, int OH, int OW, int pad0,
                 const Table& t) {
  switch (taps) {
#define FIR2_DOWN(T_)                                                      \
  case T_:                                                                 \
    fir2_down_kernel<T_, kVec, T><<<grid, kThreads, 0, s>>>(x, out, H, W, C, \
                                                            OH, OW, pad0, t); \
    break;
    FIR2_DOWN(1) FIR2_DOWN(2) FIR2_DOWN(3) FIR2_DOWN(4) FIR2_DOWN(5)
    FIR2_DOWN(6) FIR2_DOWN(7) FIR2_DOWN(8)
#undef FIR2_DOWN
  }
}

}  // namespace

// One resample's launch arguments besides the pointers, the vector width
// and the stream: built once per (taps, gain, mode, shape) by ops/fir.py
// (``_Args``), so a call passes one pointer where it passed ten values.
struct Fir2Args {
  int N, H, W, C, OH, OW;
  int up;    // up2 (1) or down2 (0)
  int len;   // the phase table's S (up2) or the tap count T (down2)
  int base;  // the first input offset lo (up2) or pad0 (down2)
  Table table;  // 2*S (up2) or T (down2) f32 values
};

namespace {

template <typename T>
int fir2(const T* x, T* out, const Fir2Args* a, int vec, void* stream) {
  const int N = a->N, H = a->H, W = a->W, C = a->C, OH = a->OH, OW = a->OW;
  const int up = a->up, len = a->len, base = a->base;
  const int max_len = up ? kMaxSlots : kMaxTaps;
  if (len < 1 || len > max_len || (vec != 1 && vec != 4) || C % vec != 0 ||
      N < 1 || N > 65535 || (up ? (OH + 1) / 2 : OH) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Table& t = a->table;
  const auto s = static_cast<cudaStream_t>(stream);
  const int cols = up ? (OW + 1) / 2 : OW;
  const dim3 grid((cols * (C / vec) + kThreads - 1) / kThreads,
                  up ? (OH + 1) / 2 : OH, N);
  if (up) {
    if (vec == 4) launch_up<4>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else launch_up<1>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
  } else {
    if (vec == 4) launch_down<4>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
    else launch_down<1>(len, grid, s, x, out, H, W, C, OH, OW, base, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). x [N,H,W,C] and out
// [N,OH,OW,C] are contiguous float32 on the
// current device, both under 2^31 elements; ``a`` is a host Fir2Args,
// copied into the launch's parameters; ``vec`` is 4 (C % 4 == 0 and x
// aligned to 4 elements) or 1. It returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int fir2_f32(const float* x, float* out, const Fir2Args* a,
                        int vec, void* stream) {
  return fir2(x, out, a, vec, stream);
}
